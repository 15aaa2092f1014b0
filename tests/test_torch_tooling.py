"""The tooling's small modules and the dry run's inputs against the JAX
package: common/{tree,shard,config}.py, the abstract arguments of
models/{transformer,steps}.py (leaf for leaf, shapes and dtypes), and
the kernels' seam on the meta device (kernels/*/ops.py, common/cost.py).

Trees are made from a seed with numpy and go through both packages; the
abstract arguments are compared with JAX's ``abstract_params``,
``jax.eval_shape(opt.init, ...)``, ``cache_defs`` and ``input_defs``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.common import config as JC
from repro.common import shard as JSH
from repro.common import tree as JT
from repro.configs import ARCHS as JAX_ARCHS
from repro.launch.mesh import make_mesh
from repro.models import steps as JS
from repro.models.layers import is_def
from repro.models.transformer import build_model as jax_build
from repro.optim.api import make_optimizer as jax_optimizer
from repro_torch.common import compat, cost, shard, tree
from repro_torch.common.config import INPUT_SHAPES, InputShape, human, pretty
from repro_torch.configs import ARCHS, FB15K
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.kge_score import ops as kge_ops
from repro_torch.kernels.kge_score.cost import l1_bwd_cost, pairwise_cost
from repro_torch.kernels.rescal_proj import ops as rp_ops
from repro_torch.kernels.rescal_proj.cost import rescal_proj_cost
from repro_torch.kernels.sparse_adagrad import ops as sa_ops
from repro_torch.kernels.sparse_adagrad.cost import dedup_cost, update_cost
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.cost import ssd_cost
from repro_torch.kernels.flash_attention.cost import flash_cost, flash_pairs
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.hlo_analysis import CostMode, trace
from repro_torch.launch.mesh import make_production_grid
from repro_torch.models import steps as S
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.transformer import Model

torch.set_num_threads(2)
TOL = 2e-5


# ----------------------------------------------------------------- tree.py
def _trees(seed=0):
    rng = np.random.default_rng(seed)
    a = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "sub": {"b": rng.standard_normal(5).astype(np.float32),
                 "i": rng.integers(0, 9, (2, 2)).astype(np.int32)}}
    b = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "sub": {"b": rng.standard_normal(5).astype(np.float32),
                 "i": rng.integers(0, 9, (2, 2)).astype(np.int32)}}
    return a, b


def _torch(t):
    return tree_map(torch.from_numpy, t)


def _leaves(tree_):
    """{path: leaf} of a nested dict (JAX sorts a dict's keys, the port
    keeps their order: compared by path)."""
    if isinstance(tree_, dict):
        return {k2: v2 for k, v in tree_.items() for k2, v2 in
                ((f"{k}/{p}" if p else k, x) for p, x in _leaves(v).items())}
    return {"": tree_}


def _leaves_close(got, want):
    gl, wl = _leaves(got), _leaves(want)
    assert set(gl) == set(wl)
    for k in gl:
        np.testing.assert_allclose(gl[k].numpy(), np.asarray(wl[k]), rtol=TOL, atol=TOL)


def test_tree_matches_jax():
    a, b = _trees()
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    ta, tb = _torch(a), _torch(b)
    assert tree.tree_size(ta) == JT.tree_size(ja) == 21
    assert tree.tree_bytes(ta) == JT.tree_bytes(ja)
    _leaves_close(tree.tree_add(ta, tb), JT.tree_add(ja, jb))
    _leaves_close(tree.tree_scale(ta, 0.5), JT.tree_scale(ja, 0.5))
    _leaves_close(tree.tree_zeros_like(ta), JT.tree_zeros_like(ja))
    np.testing.assert_allclose(float(tree.global_norm(ta)), float(JT.global_norm(ja)),
                               rtol=TOL)
    assert bool(tree.tree_any_nan(ta)) is bool(JT.tree_any_nan(ja)) is False
    a["sub"]["b"][2] = np.nan
    assert bool(tree.tree_any_nan(_torch(a))) is bool(
        JT.tree_any_nan(jax.tree.map(jnp.asarray, a))) is True
    only_ints = {"i": a["sub"]["i"]}
    assert bool(tree.tree_any_nan(_torch(only_ints))) is bool(
        JT.tree_any_nan(jax.tree.map(jnp.asarray, only_ints))) is False


# ----------------------------------------------------------------- shard.py
@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (8, 1)])
def test_shard_arithmetic_matches_jax(mesh_shape):
    mesh = make_mesh(mesh_shape, ("data", "model"))
    assert shard.batch_axes(mesh_shape) == JSH.batch_axes(mesh)
    for names in [("data",), ("model",), ("data", "model"), ("pipe",)]:
        assert shard.axis_size(mesh_shape, *names) == JSH.axis_size(mesh, *names)
    for gb in (8, 16, 64):
        assert shard.local_batch(gb, mesh_shape) == JSH.local_batch(gb, mesh)
        assert shard.local_batch(gb, None) == JSH.local_batch(gb, None)
    for n, k in [(0, 8), (1, 8), (400, 16), (401, 16), (14951, 8)]:
        assert shard.divisible(n, k) == JSH.divisible(n, k)


def test_production_grid_is_the_product_of_the_batch_axes():
    """(16, 16), or (32, 16) for the reference's (2, 16, 16): the machines
    are its pod x data (common/shard.py batch_axes), its devices the grid's
    ranks."""
    for multi_pod, jshape in ((False, (16, 16)), (True, (2, 16, 16))):
        M, S_ = make_production_grid(multi_pod)
        assert M * S_ == int(np.prod(jshape)) and S_ == jshape[-1]
        assert M == int(np.prod(jshape[:-1]))


def test_pretty_and_human_match_jax():
    assert pretty(ARCHS["qwen1.5-0.5b"]) == JC.pretty(JAX_ARCHS["qwen1.5-0.5b"])
    assert pretty(FB15K) == JC.pretty(__import__("repro.configs", fromlist=["FB15K"]).FB15K)
    for n in (0, 7, 999, 1000, 1234.5, 6.2e9, -3.3e12, 4e15, 9.9e20):
        assert human(n) == JC.human(n)


# ------------------------------------------------------- abstract arguments
def _same(port_tree, jax_tree):
    got, want = _leaves(port_tree), _leaves(jax_tree)
    assert set(got) == set(want)
    for k in got:
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(jnp.dtype(want[k].dtype)), k


@pytest.mark.parametrize("name", list(ARCHS))
def test_abstract_params_match_jax(name):
    jm, m = jax_build(JAX_ARCHS[name].reduced()), Model(ARCHS[name].reduced())
    _same(m.abstract_params(), jm.abstract_params())
    assert all(s is None for s in tree_leaves(m.param_specs()))


def test_abstract_params_full_size_and_on_a_grid():
    """A full config (stacked layers, bf16 matrices) leaf for leaf; on a
    (1, 2) grid each expert leaf is this rank's half of JAX's global leaf
    (``param_specs``), every other leaf whole."""
    _same(Model(ARCHS["dbrx-132b"]).abstract_params(),
          jax_build(JAX_ARCHS["dbrx-132b"]).abstract_params())
    cfg = ARCHS["mixtral-8x7b"].reduced()
    want = _leaves(jax_build(JAX_ARCHS["mixtral-8x7b"].reduced()).abstract_params())
    with fake_world(1, 2) as grid:
        m = Model(cfg, grid)
        got, specs = _leaves(m.abstract_params()), _leaves(m.param_specs())
    assert not dist.is_initialized()
    sliced = 0
    for k, a in got.items():
        spec = specs[k]
        shape = list(a.shape)
        if spec is not None:
            axis, parts, part = spec
            assert (parts, part) == (2, 0)
            shape[axis] *= parts
            sliced += 1
        assert tuple(shape) == tuple(want[k].shape), k
    assert sliced == 3 * cfg.n_moe_layers  # the experts' three matrices


@pytest.mark.parametrize("opt", ["sgd", "adamw", "adafactor"])
def test_optimizer_state_matches_eval_shape(opt):
    name = "dbrx-132b"  # matrices stored in bf16: the state is f32 all the same
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), optimizer=opt,
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(ARCHS[name].reduced(), optimizer=opt, param_dtype="bfloat16")
    shape = InputShape("x", 16, 4, "train")
    jm = jax_build(jcfg)
    want = jax.eval_shape(jax_optimizer(opt, 1e-4).init, jm.abstract_params())
    aps, aos, batch = S.train_abstract_args(Model(cfg), shape)
    _same(aos, want)
    _same(aps, jm.abstract_params())
    jbatch = JS.abstract_inputs(JS.input_defs(jcfg, JC.InputShape("x", 16, 4, "train"),
                                              jm), None)
    _same(batch, jbatch)
    specs = S.opt_state_specs(opt, Model(cfg).param_specs(), aps)
    assert set(specs) == set(aos)


def test_opt_state_specs_follow_stat_axis():
    """On a (1, 2) grid, Adafactor's stats of an expert leaf sliced along
    its last axis: ``vr`` (the last axis dropped) whole, ``vc`` sliced
    along the same axis; AdamW's moments lie as their parameters."""
    cfg = ARCHS["mixtral-8x7b"].reduced()
    with fake_world(1, 2) as grid:
        m = Model(cfg, grid)
        aps, specs = m.abstract_params(), m.param_specs()
    ada = S.opt_state_specs("adafactor", specs, aps)
    adamw = S.opt_state_specs("adamw", specs, aps)
    assert adamw["m"] is specs and adamw["step"] is None
    w1 = _leaves(specs)
    stats = _leaves(ada["stats"])
    for k, spec in w1.items():
        if spec is None:
            continue
        axis = spec[0]
        assert stats[f"{k}/vr"] == (None if axis == -1 else (axis + 1, 2, 0))
        assert stats[f"{k}/vc"] == (None if axis == -2 else
                                    ((axis if axis == -1 else axis + 1), 2, 0))


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "mamba2-2.7b", "whisper-large-v3",
                                  "minicpm3-4b", "jamba-1.5-large-398b"])
def test_serve_abstract_args_match_cache_defs(name):
    jcfg, cfg = JAX_ARCHS[name].reduced(), ARCHS[name].reduced()
    shape = InputShape("x", 32, 3, "decode")
    jm, m = jax_build(jcfg), Model(cfg)
    aps, caches, token, index = S.serve_abstract_args(m, shape)
    want = jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape, d.dtype),
                        jm.cache_defs(3, 32), is_leaf=is_def)
    _same(caches, want)
    _same(aps, jm.abstract_params())
    jtok = JS.abstract_inputs(JS.input_defs(jcfg, JC.InputShape("x", 32, 3, "decode"), jm),
                              None)["token"]
    assert tuple(token.shape) == tuple(jtok.shape) and token.dtype == torch.int32
    assert index == 31


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "llava-next-mistral-7b",
                                  "whisper-large-v3"])
def test_input_defs_match_jax(name, kind):
    jcfg, cfg = JAX_ARCHS[name].reduced(), ARCHS[name].reduced()
    for T, B in ((16, 8), (24, 4)):
        jm = jax_build(jcfg)
        want = JS.abstract_inputs(JS.input_defs(jcfg, JC.InputShape("x", T, B, kind), jm),
                                  None)
        got = S.abstract_inputs(S.input_defs(cfg, InputShape("x", T, B, kind), Model(cfg)))
        _same(got, want)


def test_abstract_inputs_take_this_machines_rows():
    cfg = ARCHS["qwen1.5-0.5b"]
    shape = INPUT_SHAPES["prefill_32k"]
    with fake_world(16, 16) as grid:
        m = Model(cfg, grid)
        batch = S.abstract_inputs(S.input_defs(cfg, shape, m), grid)
        _, caches, token, _ = S.serve_abstract_args(m, INPUT_SHAPES["long_500k"])
    assert tuple(batch["tokens"].shape) == (32 // 16, 32768)
    assert tuple(token.shape) == (1, 1)  # a batch of 1 does not split: replicated


# --------------------------------------------------------- the kernels' seam
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _no_plain(monkeypatch):
    """Every plain version raises: a meta tensor must not take it."""
    def boom(*a, **k):
        raise AssertionError("a meta tensor took the plain route")

    monkeypatch.setattr(flash_ops, "mha_ref", boom)
    monkeypatch.setattr(ssd_ops, "ssd_chunked_batched", boom)
    monkeypatch.setattr(kge_ops, "pairwise_ref", boom)
    monkeypatch.setattr(kge_ops, "l1_grads_ref", boom)
    monkeypatch.setattr(sa_ops, "dedup_aggregate_ref", boom)
    monkeypatch.setattr(sa_ops, "fused_update_ref", boom)
    monkeypatch.setattr(rp_ops, "rescal_proj_ref", boom)
    monkeypatch.setattr(rp_ops, "rescal_proj_grads_ref", boom)


def _calls():
    """Each wrapper once on meta tensors: (what it returns, the kernel's
    output shapes, the cost it must report)."""
    G, B, K, D = 2, 64, 48, 32
    o = _meta(G, B, D, dtype=torch.float32).requires_grad_(True)
    n = _meta(G, K, D).requires_grad_(True)

    def l1():
        s = kge_ops.pairwise_scores("l1", o, n)
        s.sum().backward()
        return s

    def rescal():
        m, h, t = (_meta(*shape).requires_grad_(True)
                   for shape in ((B, D * 24), (B, D), (B, 24)))
        ph, pt = rp_ops.rescal_proj(m, h, t)
        (ph.sum() + pt.sum()).backward()
        return ph, pt, m.grad, h.grad, t.grad

    return [
        (lambda: kge_ops.pairwise_scores("l2sq", o.detach(), n.detach()), [(G, B, K)],
         [pairwise_cost("l2sq", G, B, K, D)]),
        (l1, [(G, B, K)], [pairwise_cost("l1", G, B, K, D), l1_bwd_cost(G, B, K, D)]),
        (lambda: kge_ops.l1_bwd_kernel(o.detach(), n.detach(), _meta(G, B, K),
                                       need_dn=False)[0], [(G, B, D)],
         [l1_bwd_cost(G, B, K, D, need_dn=False)]),
        (lambda: sa_ops.dedup_aggregate(_meta(100, dtype=torch.int64), _meta(100, 16)),
         [(100,), (100, 16)], [dedup_cost(100, 16)]),
        (lambda: sa_ops.fused_sparse_adagrad(_meta(50, 16), _meta(50, 16),
                                             _meta(30, dtype=torch.int32),
                                             _meta(30, 16), 0.1),
         [(50, 16), (50, 16)], [update_cost(30, 16)]),
        (lambda: flash_ops.flash_attention(_meta(2, 4, 40, 64, dtype=torch.bfloat16),
                                           _meta(2, 2, 40, 64, dtype=torch.bfloat16),
                                           _meta(2, 2, 40, 64, dtype=torch.bfloat16),
                                           True, 16, 0),
         [(2, 4, 40, 64)], [flash_cost(2, 4, 2, 40, 40, 64, True, 16, 0, 2)]),
        (lambda: ssd_ops.ssd_scan(_meta(2, 100, 4, 32), _meta(2, 100, 4), _meta(4),
                                  _meta(2, 100, 16), _meta(2, 100, 16)),
         [(2, 100, 4, 32)], [ssd_cost(2, 100, 4, 32, 16)]),
        (rescal, [(B, 24), (B, D), (B, D * 24), (B, D), (B, 24)],
         [rescal_proj_cost(B, D, 24), rescal_proj_cost(B, D, 24, backward=True)]),
    ]


def _shapes(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [tuple(t.shape) for t in outs]


@pytest.mark.parametrize("i", range(8))
def test_wrappers_on_meta_give_kernel_shapes_and_record_cost(i, monkeypatch):
    _no_plain(monkeypatch)
    fn, shapes, costs = _calls()[i]
    mode = CostMode()
    with mode:
        out = fn()
    assert _shapes(out) == shapes
    assert all(t.is_meta for t in (out if isinstance(out, (tuple, list)) else (out,)))
    want = {}
    for c in costs:
        r = want.setdefault(c.name, [0, 0.0, 0.0])
        r[0] += 1
        r[1] += c.total_flops
        r[2] += c.bytes
    assert {k: [r.launches, r.flops, r.bytes] for k, r in mode.kernels.items()} == want
    assert cost.ACTIVE is None
    # without an analysis the same call records nothing and still works
    fn2, _, _ = _calls()[i]
    assert _shapes(fn2()) == shapes


def test_cpu_runs_the_plain_version_and_records_no_kernel():
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    n = torch.from_numpy(rng.standard_normal((12, 8)).astype(np.float32))
    t = trace(lambda: kge_ops.pairwise_scores("l2sq", o, n))
    assert t.mode.kernels == {}
    assert t.cost.flops > 0  # the plain version's ops, counted as ops
    from repro_torch.kernels.kge_score.ref import pairwise_ref
    torch.testing.assert_close(t.result, pairwise_ref("l2sq", o, n))
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 32)).astype(np.float32))
    with CostMode() as mode:
        flash_ops.flash_attention(q, q, q)
    assert mode.kernels == {}


def test_flash_pairs_count_the_mask():
    from repro_torch.kernels.flash_attention.ref import _mask
    for T, S_, causal, window, off in [(7, 7, True, 0, 0), (5, 9, True, 3, 4),
                                       (1, 512, True, 0, 511), (6, 4, False, 0, 0),
                                       (10, 10, True, 4, 0), (3, 20, False, 5, 10)]:
        assert flash_pairs(T, S_, causal, window, off) == int(
            _mask(T, S_, causal, window, off, "cpu").sum())


def test_a_missing_fake_backend_raises(monkeypatch):
    monkeypatch.setattr(dist.Backend, "backend_list",
                        [b for b in dist.Backend.backend_list if b != "fake"])
    with pytest.raises(RuntimeError, match="fake"):
        compat.init_fake_world(4)
    assert not dist.is_initialized()
