"""The port's MoE models over a model group of more than one rank, against
the JAX package's mesh program (``build_model(cfg, mesh)``, ``moe_apply``
under shard_map).

A world of M x S gloo processes stands for JAX's (data=M, model=S) mesh:
``run_world(4, 2, ...)`` for ``mesh8``, ``run_world(1, 2, ...)`` for a
(1, 2) mesh. Reduced Mixtral-8x7B with 4 experts (expert-parallel: each
model rank owns 2) and with 3 (tensor-parallel experts: each rank a d_ff
slice of all 3), at capacity factor 1.25 so that token-choices drop, in
f32, with JAX's global weights carried across (each rank keeps its slice).
On mesh8, prefill with ``use_flash`` off and on (JAX's flash runs the
Pallas kernel in interpret mode under shard_map), teacher-forced decode at
batch 8 (split over the 4 machines) and 2 (replicated over them, as JAX
replicates a batch that does not split); on (1, 2), the chunked prefill
and decode at batch 2. Logits within 2e-5 x max(1, max|logit|), the same
expert choices and the same dropped token-choices. One world of each shape
runs every case (module fixtures); the rank body is
``tests/_torch_dist_bodies.py::lm_world_cases``.

The same worlds take ``build_train_step`` steps (A10.5b) against JAX's
``build_train_step(build_model(cfg, mesh))`` from JAX's weights on the
same global batches, in f32: on mesh8 JAX's ``test_train_step_on_mesh``
Qwen (4 stacked layers, remat, 2 microbatches) and
``test_train_step_fsdp_moe``'s Mixtral at E = 4 and E = 3 (capacity
factor 4: no drops) with AdamW, the Mixtral again with SGD at lr 0.5 (a
gradient scaled by S would show in every parameter), reduced DBRX with
Adafactor at E = 4 and E = 3 (its statistics reduced over the model
group), and a ``parallel="dp"`` Qwen (the batch over all 8 ranks); on
(1, 2) the Mixtral and the DBRX at E = 3. Each step's
loss within 2e-5 x max(1, |loss|); the parameters under the flip rule
(``tests/test_torch_lm_train.py``) with AdamW, else within 2e-4 of the
largest move JAX's steps made (at least lr a step; with SGD that is 2e-4
x max(1, max|g|) x lr a step) plus 1e-6 x max(1, max|p|); every rank that
holds a parameter holds the same bits. SGD and Adafactor take two steps, AdamW
one: once a first step has flipped entries (2 lr apart), the stacked
Qwen's gradients of ``bk``, pure cancellation noise (a key bias shifts
every score of a query alike), part by more than the rule's tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.common.compat import set_mesh
from repro.common.config import FFNKind as JFFNKind
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import attention as JA
from repro.models.layers import rmsnorm as jrmsnorm
from repro.common.config import InputShape as JInputShape
from repro.models import steps as JS
from repro.models.transformer import build_model as jax_build
from repro_torch.common.config import InputShape
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import ProcessGrid, run_world
from repro_torch.models import moe as M
from repro_torch.models.transformer import (
    build_model, machine_rows, params_from_arrays,
)

import _torch_dist_bodies as B
from test_torch_lm_train import GRAD_TOL, LOSS_TOL, PARAM_TOL, flip_rule

torch.set_num_threads(2)

ARCH = "mixtral-8x7b"
CF = 1.25
PREFILL = (8, 16)  # 2 rows a machine of mesh8
STEPS = 4
FLASH = (False, True)


def _cfgs(E, **kw):
    kw = dict(n_experts=E, moe_top_k=2, capacity_factor=CF, dtype="float32", **kw)
    return (dataclasses.replace(JAX_ARCHS[ARCH].reduced(), **kw),
            dataclasses.replace(ARCHS[ARCH].reduced(), **kw))


def _mesh(M_, S_):
    return Mesh(np.array(jax.devices()[:M_ * S_]).reshape(M_, S_), ("data", "model"))


def _grid(M_, S_, rank):
    return ProcessGrid(M=M_, S=S_, rank=rank, machine_group=None, model_group=None,
                       device=torch.device("cpu"))


def _jax_routes(jm, params, tokens, use_flash):
    """Each MoE layer's expert choices (B*T, k) in JAX's mesh program: the
    layers walked as ``Model._apply_layer`` walks them (reduced configs:
    no stacking), the router read on the input the MoE layer gets."""
    cfg = jm.cfg

    def f(p, t):
        x = jm.embed(p, t, {})
        sets = []
        for j in range(jm.period):
            pl, kind = p["layers"][f"l{j}"], jm.pattern[j]
            if kind[1] == JFFNKind.MOE:
                h = JA.attention_train(pl["attn"], jrmsnorm(x, pl["ln1"], cfg.norm_eps),
                                       cfg, causal=True, mesh=jm.mesh,
                                       batch_axes=jm.batch_axes, use_flash=use_flash)
                h = jrmsnorm(x + h, pl["ln2"], cfg.norm_eps).reshape(-1, cfg.d_model)
                gates = jax.nn.softmax((h @ pl["moe"]["router"]).astype(jnp.float32), -1)
                sets.append(jax.lax.top_k(gates, cfg.moe_top_k)[1])
            x = jm._apply_layer(x, pl, kind=kind, use_flash=use_flash)
        return sets

    return [np.asarray(s) for s in jax.jit(f)(params, tokens)]


def _jax_program(jcfg, mesh, tokens, decodes, flash):
    """JAX's mesh program from seed 0: (its weights as numpy arrays,
    [(logits, expert choices) for each of ``flash``], [teacher-forced
    decode logits (B, steps, V) for each decode batch])."""
    jm = jax_build(jcfg, mesh=mesh)
    with set_mesh(mesh):
        jp = jm.init(jax.random.key(0))
        t = jnp.asarray(tokens, jnp.int32)
        prefill = []
        for use_flash in flash:
            fwd = jax.jit(lambda p, tt, uf=use_flash: jm.forward(p, {"tokens": tt},
                                                                 use_flash=uf))
            prefill.append((np.asarray(fwd(jp, t)), _jax_routes(jm, jp, t, use_flash)))
        dec = jax.jit(jm.decode_step)
        decoded = []
        for tok in decodes:
            caches = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype),
                                  jm.cache_defs(tok.shape[0], tok.shape[1]),
                                  is_leaf=lambda x: hasattr(x, "materialize"))
            out = []
            for i in range(tok.shape[1]):
                lg, caches = dec(jp, caches, jnp.asarray(tok[:, i:i + 1], jnp.int32),
                                 jnp.asarray(i, jnp.int32))
                out.append(np.asarray(lg[:, 0]))
            decoded.append(np.stack(out, axis=1))
    return jax.tree.map(np.asarray, jp), prefill, decoded


# train cases: (arch, config changes, lr, (seq_len, global batch)); AdamW
# one step, the others two (module docstring)
TRAIN = {
    "qwen_adamw": ("qwen1.5-0.5b", dict(microbatches=2, scan_layers=True, n_layers=4,
                                        remat=True), 1e-3, (32, 16)),
    "mixtral_e4_adamw": (ARCH, dict(n_experts=4, microbatches=2, fsdp=True,
                                    capacity_factor=4.0), 1e-3, (8, 32)),
    "mixtral_e3_adamw": (ARCH, dict(n_experts=3, microbatches=2, fsdp=True,
                                    capacity_factor=4.0), 1e-3, (8, 32)),
    "mixtral_e4_sgd": (ARCH, dict(n_experts=4, microbatches=2, fsdp=True,
                                  capacity_factor=4.0, optimizer="sgd"), 0.5, (8, 32)),
    "dbrx_e4_adafactor": ("dbrx-132b", dict(n_experts=4, microbatches=2,
                                            capacity_factor=4.0), 1e-3, (8, 32)),
    "dbrx_e3_adafactor": ("dbrx-132b", dict(n_experts=3, microbatches=2,
                                            capacity_factor=4.0), 1e-3, (8, 32)),
    "qwen_dp_adamw": ("qwen1.5-0.5b", dict(microbatches=2, n_layers=2, parallel="dp"),
                      1e-3, (16, 16)),
}
TRAIN_42 = sorted(TRAIN)
TRAIN_12 = ["dbrx_e3_adafactor", "mixtral_e3_adamw"]


def _steps(case):
    return 1 if _train_cfgs(case)[1].optimizer == "adamw" else 2


def _train_cfgs(case):
    arch, kw, lr, (seq, batch) = TRAIN[case]
    kw = dict(kw, dtype="float32", param_dtype="float32")
    return (dataclasses.replace(JAX_ARCHS[arch].reduced(), **kw),
            dataclasses.replace(ARCHS[arch].reduced(), **kw), lr,
            JInputShape("t", seq, batch, "train"), InputShape("t", seq, batch, "train"))


def _jax_train(case, mesh, seed):
    """JAX's train program on ``mesh`` from seed 0: (its weights as numpy
    arrays, the global batches, each step's loss, the parameters after the
    last step, with AdamW each step's gradient of the whole batch, which
    the flip rule reads)."""
    jcfg, cfg, lr, jshape, _ = _train_cfgs(case)
    jm = jax_build(jcfg, mesh=mesh)
    step, opt = JS.build_train_step(jm, lr=lr, shape=jshape)
    rng = np.random.default_rng(seed)
    defs = JS.input_defs(jcfg, jshape, jm)
    batches = [{k: rng.integers(0, cfg.vocab_size, d.shape).astype(np.int32)
                for k, d in defs.items()} for _ in range(_steps(case))]
    losses, grads = [], []
    with set_mesh(mesh):
        jp = jm.init(jax.random.key(0))
        arrays = jax.tree.map(np.asarray, jp)
        js = opt.init(jp)
        jstep, vg = jax.jit(step), jax.jit(jax.value_and_grad(jm.loss))
        for b in batches:
            if jcfg.optimizer == "adamw":
                flat = {k: jnp.asarray(v.reshape((-1,) + v.shape[2:]))
                        for k, v in b.items()}
                grads.append(jax.tree.map(np.asarray, vg(jp, flat)[1]))
            jp, js, met = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(met["loss"]))
        final = jax.tree.map(np.asarray, jp)
    return arrays, batches, losses, final, grads


def _world(M_, S_, experts, decode_batches, flash=FLASH, train=()):
    """One M_ x S_ gloo world for every case; returns {E: (cfg, JAX's
    results, the port's)} and, under "train", {case: (JAX's train program,
    the port's)}."""
    rng = np.random.default_rng(0)
    cases, want = [], {}
    for E in experts:
        jcfg, cfg = _cfgs(E)
        tokens = rng.integers(0, cfg.vocab_size, PREFILL)
        decodes = [rng.integers(0, cfg.vocab_size, (b, STEPS)) for b in decode_batches]
        arrays, prefill, decoded = _jax_program(jcfg, _mesh(M_, S_), tokens, decodes,
                                                flash)
        cases.append((cfg, arrays, tokens, flash, decodes))
        want[E] = (cfg, prefill, decoded)
    tcases, twant = [], {}
    for i, case in enumerate(train):
        _, cfg, lr, _, shape = _train_cfgs(case)
        twant[case] = _jax_train(case, _mesh(M_, S_), seed=10 + i)
        tcases.append((cfg, twant[case][0], lr, shape, twant[case][1]))
    got, tgot = run_world(M_, S_, B.lm_world_cases, (cases, tcases), timeout_s=120)
    out = {E: (*want[E], g) for E, g in zip(experts, got)}
    out["train"] = {c: (twant[c], g) for c, g in zip(train, tgot)}
    return out


@pytest.fixture(scope="module")
def world42(mesh8):
    return _world(4, 2, (4, 3), (8, 2), train=TRAIN_42)


@pytest.fixture(scope="module")
def world12():
    return _world(1, 2, (4, 3), (2,), flash=(False,), train=TRAIN_12)


def _close(got, want):
    got = got.float().numpy()
    assert got.shape == want.shape
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _drops(sets, cfg, M_):
    """Each layer's dropped token-choices (B*T, k): the capacity per data
    shard of M_, JAX's ``_moe_local`` order within it."""
    out = []
    for topi in sets:
        topi = torch.as_tensor(np.array(topi))
        n = topi.shape[0] // M_
        cap = M.capacity(cfg, n)
        mask = torch.zeros(topi.shape, dtype=torch.bool)
        for m in range(M_):
            part = topi[m * n:(m + 1) * n]
            for e in range(cfg.n_experts):
                sel, slot = M.slots(part, e, cap)
                mask[m * n:(m + 1) * n] |= (part == e) & (slot == cap)[:, None]
        out.append(mask)
    return out


# --------------------------------------------------------------- 4 x 2 (mesh8)
@pytest.mark.parametrize("use_flash", FLASH)
@pytest.mark.parametrize("E", [4, 3], ids=["expert_parallel", "tensor_parallel"])
def test_prefill_matches_jax_mesh8(world42, E, use_flash):
    cfg, prefill, _, got = world42[E]
    assert M.expert_parallel(cfg, 2) == (E == 4)
    _close(got["prefill"][FLASH.index(use_flash)][0], prefill[FLASH.index(use_flash)][0])


@pytest.mark.parametrize("use_flash", FLASH)
@pytest.mark.parametrize("E", [4, 3], ids=["expert_parallel", "tensor_parallel"])
def test_prefill_drops_as_jax_mesh8(world42, E, use_flash):
    """The same expert choices in every MoE layer, so the same dropped
    token-choices at the per-shard capacity; some drop."""
    cfg, prefill, _, got = world42[E]
    want_sets = prefill[FLASH.index(use_flash)][1]
    got_sets = got["prefill"][FLASH.index(use_flash)][1]
    assert len(got_sets) == len(want_sets) == cfg.n_layers
    for g, w in zip(got_sets, want_sets):
        assert np.array_equal(g.numpy(), w)
    drops = _drops(want_sets, cfg, 4)
    assert any(bool(d.any()) for d in drops)
    for g, w in zip(_drops([s.numpy() for s in got_sets], cfg, 4), drops):
        assert torch.equal(g, w)


@pytest.mark.parametrize("batch", [8, 2], ids=["split", "replicated"])
@pytest.mark.parametrize("E", [4, 3], ids=["expert_parallel", "tensor_parallel"])
def test_decode_matches_jax_mesh8(world42, E, batch):
    """Teacher-forced decode: batch 8 splits over the machines (2 tokens a
    shard, capacity 2); batch 2 does not, so every machine decodes both
    rows with the capacity over both."""
    cfg, _, decoded, got = world42[E]
    i = [8, 2].index(batch)
    assert got["decode"][i].shape[0] == batch
    _close(got["decode"][i], decoded[i])


# ------------------------------------------------------------------- 1 x 2
@pytest.mark.parametrize("E", [4, 3], ids=["expert_parallel", "tensor_parallel"])
def test_prefill_and_decode_match_jax_1x2(world12, E):
    cfg, prefill, decoded, got = world12[E]
    _close(got["prefill"][0][0], prefill[0][0])
    for g, w in zip(got["prefill"][0][1], prefill[0][1]):
        assert np.array_equal(g.numpy(), w)
    _close(got["decode"][0], decoded[0])


# ------------------------------------------------------------ train steps
def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}/{k}")
    else:
        yield pre, tree


def _train_matches(world, case, tag):
    (arrays, _, losses, final, grads), got = world["train"][case]
    _, cfg, lr, _, _ = _train_cfgs(case)
    assert len(got["losses"]) == len(losses) == _steps(case)
    for g, w in zip(got["losses"], losses):
        assert abs(g - w) <= LOSS_TOL * max(1.0, abs(w)), (case, g, w)
    assert got["spread"] == 0.0
    want = dict(_paths(final))
    mine = dict(_paths(got["params"]))
    assert set(mine) == set(want)
    if cfg.optimizer == "adamw":
        flip_rule(f"{tag} {case}", mine, want, [dict(_paths(g)) for g in grads], lr)
        return
    start, steps = dict(_paths(arrays)), _steps(case)
    for k, w in want.items():
        move = max(lr * steps, float(np.abs(w - start[k]).max()))
        tol = GRAD_TOL * move + PARAM_TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(mine[k], w, rtol=0, atol=tol, err_msg=f"{case} {k}")
    # the step moved the parameters by more than the tolerance
    assert max(float(np.abs(want[k] - start[k]).max()) for k in want) > 1e-4


@pytest.mark.parametrize("case", TRAIN_42)
def test_train_step_matches_jax_mesh8(world42, case):
    _train_matches(world42, case, "4x2")


@pytest.mark.parametrize("case", TRAIN_12)
def test_train_step_matches_jax_1x2(world12, case):
    _train_matches(world12, case, "1x2")


def test_train_rows_and_groups():
    """A machine's rows of a global batch, and the ranks the gradients are
    averaged over: the machine group in tp mode, every rank in dp."""
    from repro_torch.models.steps import data_parallel, n_machines_of

    _, cfg = _cfgs(4)
    for r in range(8):
        g = _grid(4, 2, r)
        assert data_parallel(build_model(cfg, grid=g))[1:] == (r // 2, 4)
    _, qcfg, _, _, _ = _train_cfgs("qwen_dp_adamw")
    m = build_model(qcfg, grid=_grid(4, 2, 5))
    assert data_parallel(m)[1:] == (5, 8) and n_machines_of(m) == 8
    with pytest.raises(ValueError, match="dp mode takes no MoE"):
        build_model(dataclasses.replace(cfg, parallel="dp"))


# --------------------------------------------------------- rows and weights
def test_machine_rows_rule():
    """Split when the batch divides over the machines, else replicated."""
    rows = [machine_rows(_grid(4, 2, r), 8) for r in range(8)]
    assert rows[::2] == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert rows[1] == rows[0]  # the model group shares its machine's rows
    assert all(machine_rows(_grid(4, 2, r), 2) == slice(0, 2) for r in range(8))
    assert machine_rows(None, 3) == slice(0, 3)


@pytest.mark.parametrize("vocab", [1000, 1024])
def test_padded_vocab_matches_jax_mesh8(mesh8, vocab):
    """128 x S under a model group of S > 1 (1024 at vocab 1000 on mesh8),
    else 8, as JAX's; at vocab 1024 the rules agree."""
    jcfg, cfg = _cfgs(4, vocab_size=vocab)
    want = jax_build(jcfg, mesh=mesh8).padded_vocab
    assert build_model(cfg, grid=_grid(4, 2, 0)).padded_vocab == want
    assert build_model(cfg).padded_vocab == jax_build(jcfg).padded_vocab
    assert (want == 1024) and (build_model(cfg).padded_vocab == vocab)


@pytest.mark.parametrize("E", [4, 3], ids=["expert_parallel", "tensor_parallel"])
@pytest.mark.parametrize("scan_layers", [False, True])
def test_rank_weights_are_slices(E, scan_layers):
    """``Model(cfg, grid).defs`` give the rank's local shapes (JAX's
    ``moe_defs(model_par=2)`` specs); ``init`` draws each rank the slice of
    what the model with no grid draws from the same seed, and
    ``params_from_arrays`` keeps the same slice of the global arrays."""
    from repro.models import moe as JM

    _, cfg = _cfgs(E, scan_layers=scan_layers, n_layers=2)
    whole = build_model(cfg).init(torch.Generator().manual_seed(3))
    jspec = JM.moe_defs(_cfgs(E)[0], model_par=2)
    for s in range(2):
        m = build_model(cfg, grid=_grid(1, 2, s))
        p = m.init(torch.Generator().manual_seed(3))
        carried = params_from_arrays(m, jax.tree.map(lambda t: t.numpy(), whole))
        for key in ("w_up", "w_down", "w_gate"):
            got, full = p["layers"]["l0"]["moe"][key], whole["layers"]["l0"]["moe"][key]
            axis = [i for i, a in enumerate(jspec[key].spec) if a == "model"][0]
            axis -= 3  # from the end: the stack's leading axis keeps it
            n = full.shape[axis] // 2
            want = full.narrow(axis, s * n, n)
            assert torch.equal(got, want) and torch.equal(carried["layers"]["l0"]["moe"][key],
                                                          want)
        assert torch.equal(p["tok_emb"], whole["tok_emb"])
        assert torch.equal(p["layers"]["l0"]["moe"]["router"],
                           whole["layers"]["l0"]["moe"]["router"])
