"""LM training in the port (A10.5) against the JAX package: the next-token
losses (models/layers.py), ``Model.loss`` and its gradients for every
config of the zoo reduced, the chunked-CE branch, remat, the Mamba2 NaN
rule, the step's input specs and ``build_train_step`` (models/steps.py).

Everything runs in f32 with JAX's weights carried across
(``params_from_arrays``) and inputs from numpy seeds. Losses within
2e-5 x max(1, |loss|); each gradient leaf within 2e-4 x max(1, max|g|).
Parameters after a train step are held to JAX's under the flip rule:
Adam's first step is lr x sign(g), so an entry whose gradient lies within
the gradient tolerance of 0 may move the other way; such entries are
counted and printed, every other one within 1e-6 x max(1, max|p|) plus
1% of the largest move the steps allow (lr a step): a second Adam step
whose m nearly cancels (g1 and g2 of opposite signs) passes the
gradients' f32 differences on at a few hundred times their relative size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import InputShape as JInputShape
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import layers as JL
from repro.models import steps as JS
from repro.models.transformer import build_model as jax_build
from repro_torch.common.config import InputShape
from repro_torch.configs import ARCHS
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import steps as S
from repro_torch.models.transformer import build_model, params_from_arrays
from repro_torch.optim import dense as D

torch.set_num_threads(2)

B, T = 2, 16
LOSS_TOL = 2e-5
GRAD_TOL = 2e-4
PARAM_TOL = 1e-6


def _cfgs(name, **kw):
    kw = {"dtype": "float32", "param_dtype": "float32", **kw}
    return (dataclasses.replace(JAX_ARCHS[name].reduced(), **kw),
            dataclasses.replace(ARCHS[name].reduced(), **kw))


def _carried(jcfg, cfg, seed=0, edit=None):
    jm, m = jax_build(jcfg), build_model(cfg)
    arrays = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    if edit:
        edit(arrays)
    return jm, jax.tree.map(jnp.asarray, arrays), m, params_from_arrays(m, arrays)


def _inputs(cfg, rows=B, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, lead + (rows, T)).astype(np.int32)
    out = {"tokens": tok, "labels": rng.integers(0, cfg.vocab_size, tok.shape).astype(np.int32)}
    if cfg.frontend.value == "vision":
        nf = min(cfg.n_frontend_tokens, T)
        out["patch_embeds"] = rng.standard_normal(lead + (rows, nf, cfg.d_model)).astype(
            np.float32)
    if cfg.enc_dec:
        out["enc_frames"] = rng.standard_normal(
            lead + (rows, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
    return out


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}/{k}")
    else:
        yield pre, tree


def _port_grads(m, params, inputs):
    leaves = [p for _, p in _paths(params)]
    for p in leaves:
        p.requires_grad_(True)
    loss = m.loss(params, {k: torch.from_numpy(v) for k, v in inputs.items()})
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in _paths(params)}
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return float(loss.detach()), grads


def _jax_grads(jm, jp, inputs):
    loss, g = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in inputs.items()})
    return float(loss), dict(_paths(jax.tree.map(np.asarray, g)))


def _refuse_flash(monkeypatch):
    """The train route must not reach the flash wrapper (JAX's loss passes
    ``use_flash=False``); ``ops.ssd_scan`` raises under grad by itself."""
    def refuse(*a, **k):
        raise AssertionError("the train route reached flash_attention")

    monkeypatch.setattr(A, "flash_attention", refuse)


def _close_loss(got, want):
    assert abs(got - want) <= LOSS_TOL * max(1.0, abs(want)), (got, want)


def _close_grads(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        tol = GRAD_TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol, err_msg=k)


# ------------------------------------------------------------- cross entropy
def _ce_case(seed=0, vocab=50, Vp=64):
    """Logits over a padded vocab whose pad columns carry values (the
    model draws them), labels below ``vocab``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    w = (rng.standard_normal((32, Vp)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 6)).astype(np.int32)
    return x, w, labels


def test_cross_entropy_logits_matches_jax_over_padded_columns():
    x, w, labels = _ce_case()
    logits = x @ w
    want, jg = jax.value_and_grad(lambda lg: JL.cross_entropy_logits(lg, labels, 50))(
        jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    got = L.cross_entropy_logits(t, torch.from_numpy(labels), 50)
    got.backward()
    _close_loss(float(got.detach()), float(want))
    _close_grads({"g": t.grad.numpy()}, {"g": np.asarray(jg)})
    # the pad columns count: the CE over the first 50 columns differs
    sliced = float(L.cross_entropy_logits(torch.tensor(logits[..., :50]),
                                          torch.from_numpy(labels), 50))
    assert abs(sliced - float(got.detach())) > 1e-2


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunked_cross_entropy_matches_jax(chunk):
    """Values and gradients (x and the unembedding) at every tile width
    that divides the padded vocab; the full-logit CE agrees too."""
    x, w, labels = _ce_case(seed=1)
    f = jax.value_and_grad(lambda a, b: JL.chunked_cross_entropy(a, b, labels, chunk),
                           argnums=(0, 1))
    want, (jgx, jgw) = f(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = L.chunked_cross_entropy(tx, tw, torch.from_numpy(labels), chunk)
    got.backward()
    _close_loss(float(got.detach()), float(want))
    _close_grads({"x": tx.grad.numpy(), "w": tw.grad.numpy()},
                 {"x": np.asarray(jgx), "w": np.asarray(jgw)})
    full = L.cross_entropy_logits(torch.tensor(x @ w), torch.from_numpy(labels), 50)
    _close_loss(float(got.detach()), float(full))


def test_chunked_cross_entropy_refuses_a_ragged_tile():
    x, w, labels = _ce_case()
    with pytest.raises(AssertionError):
        L.chunked_cross_entropy(torch.tensor(x), torch.tensor(w), torch.from_numpy(labels), 48)


# ------------------------------------------------------------------ Model.loss
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_and_grads_match_jax(name, monkeypatch):
    """``Model.loss`` and every gradient leaf against
    ``jax.value_and_grad(model.loss)``, reduced, f32: patches (LLaVA) and
    frames (Whisper) included; the route reaches no kernel wrapper."""
    _refuse_flash(monkeypatch)
    jcfg, cfg = _cfgs(name)
    jm, jp, m, p = _carried(jcfg, cfg)
    inputs = _inputs(cfg)
    got, g = _port_grads(m, p, inputs)
    want, jg = _jax_grads(jm, jp, inputs)
    _close_loss(got, want)
    _close_grads(g, jg)


def test_chunked_ce_branch_matches_jax():
    """``cfg.ce_chunk = 256`` (JAX's ``test_dp_mode_loss_equals_tp``
    config: 2 layers, vocab 1024, f32): the hidden states and the chunked
    CE, and the same loss as the full-logit branch."""
    kw = dict(n_layers=2, vocab_size=1024, ce_chunk=256)
    jcfg, cfg = _cfgs("qwen1.5-0.5b", **kw)
    jm, jp, m, p = _carried(jcfg, cfg)
    inputs = _inputs(cfg)
    got, g = _port_grads(m, p, inputs)
    want, jg = _jax_grads(jm, jp, inputs)
    _close_loss(got, want)
    _close_grads(g, jg)
    full = build_model(dataclasses.replace(cfg, ce_chunk=0))
    _close_loss(_port_grads(full, p, inputs)[0], got)


@pytest.mark.parametrize("name,kw", [
    ("qwen1.5-0.5b", dict(scan_layers=True, n_layers=4)),
    ("jamba-1.5-large-398b", dict(n_layers=4, scan_layers=True)),
    ("whisper-large-v3", dict(scan_layers=True, n_layers=2, n_encoder_layers=2)),
])
def test_remat_changes_no_bit(name, kw):
    """``cfg.remat`` (each layer group and each stacked encoder layer under
    ``torch.utils.checkpoint``) gives the loss and every gradient bit for
    bit; the stacked configs have several layer groups."""
    _, cfg = _cfgs(name, **kw)
    m = build_model(cfg)
    assert m.n_groups > 1
    p = m.init(torch.Generator().manual_seed(0))
    inputs = _inputs(cfg)
    on = _port_grads(build_model(dataclasses.replace(cfg, remat=True)), p, inputs)
    off = _port_grads(build_model(dataclasses.replace(cfg, remat=False)), p, inputs)
    assert on[0] == off[0]
    for k in on[1]:
        assert np.array_equal(on[1][k], off[1][k]), k


def _overflowing(arrays):
    """Every Mamba2 layer's A = -exp(5) and dt at its clip (dt_bias 4): the
    masked decay exp(cs_t - cs_s), t < s, overflows f32 in every chunk."""
    for layer in arrays["layers"].values():
        if "mamba" in layer:
            layer["mamba"]["A_log"] = np.full_like(layer["mamba"]["A_log"], 5.0)
            layer["mamba"]["dt_bias"] = np.full_like(layer["mamba"]["dt_bias"], 4.0)


def test_mamba_nan_rule_matches_jax():
    """Where the SSD scan's masked exponent overflows, the loss is finite
    (the select drops the inf) and both packages give NaN gradients: the
    select's backward multiplies a zero cotangent by inf
    (kernels/ssd_scan/ref.py, JAX's ref.py:70), and the dt clip passes the
    NaN on (its gradient multiplies by a mask in both). The same leaves
    are NaN in the same entries; the finite rest agrees."""
    jcfg, cfg = _cfgs("mamba2-2.7b")
    jm, jp, m, p = _carried(jcfg, cfg, edit=_overflowing)
    inputs = _inputs(cfg)
    got, g = _port_grads(m, p, inputs)
    want, jg = _jax_grads(jm, jp, inputs)
    assert np.isfinite(got)
    _close_loss(got, want)
    nan = {k: np.isnan(v) for k, v in jg.items()}
    assert nan["/layers/l0/mamba/A_log"].all() and nan["/layers/l1/mamba/dt_bias"].all()
    for k in jg:
        assert np.array_equal(np.isnan(g[k]), nan[k]), k
        fin = ~nan[k]
        if fin.any():
            tol = GRAD_TOL * max(1.0, float(np.abs(jg[k][fin]).max()))
            np.testing.assert_allclose(g[k][fin], jg[k][fin], rtol=0, atol=tol, err_msg=k)


# ------------------------------------------------------------------ the step
class _NoMesh:
    mesh = None
    batch_axes = None


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "llava-next-mistral-7b",
                                  "whisper-large-v3", "dbrx-132b"])
@pytest.mark.parametrize("shape", [(32, 16, "train"), (32, 12, "train"), (32, 8, "prefill"),
                                   (64, 4, "decode")])
def test_input_defs_match_jax(name, shape):
    """Shapes and dtypes of every input, and the microbatches, with no grid;
    ``n_machines_of`` is 1."""
    jcfg, cfg = JAX_ARCHS[name], ARCHS[name]
    jshape, tshape = JInputShape("s", *shape), InputShape("s", *shape)
    m = build_model(cfg.reduced())
    assert S.n_machines_of(m) == 1
    mb = S.effective_microbatches(cfg, tshape, m)
    assert mb == JS.effective_microbatches(jcfg, jshape, _NoMesh())
    got = S.input_defs(cfg, tshape, m)
    want = JS.input_defs(jcfg, jshape, _NoMesh())
    assert list(got) == list(want)
    for k, d in got.items():
        assert d.shape == want[k].shape, k
        assert str(d.dtype).split(".")[-1] == np.dtype(want[k].dtype).name, k


def flip_rule(label, got, want, grads, lr):
    """Parameters after ``len(grads)`` Adam steps (``grads``: JAX's
    gradient of each step): an entry whose gradient at some step lies
    within the gradient tolerance of 0 may move the other way that step,
    so it may differ by up to 2 lr a step (counted, printed); every other
    entry within PARAM_TOL x max(1, max|p|) + 1% of lr a step."""
    flips = 0
    for k, w in want.items():
        g = got[k]
        near0 = np.zeros(w.shape, dtype=bool)
        for gs in grads:
            near0 |= np.abs(gs[k]) <= GRAD_TOL * max(1.0, float(np.abs(gs[k]).max()))
        bad = np.abs(g - w) > (PARAM_TOL * max(1.0, float(np.abs(w).max()))
                               + 1e-2 * lr * len(grads))
        assert not (bad & ~near0).any(), (label, k)
        assert (np.abs(g - w)[near0] <= 2 * lr * len(grads) + 1e-7).all(), (label, k)
        flips += int((bad & near0).sum())
    print(f"{label}: {flips} entries flipped")
    return flips


STEP_CASES = {
    "qwen_adamw_mb1": ("qwen1.5-0.5b", 1),
    "qwen_adamw_mb2": ("qwen1.5-0.5b", 2),
    "dbrx_adafactor_mb1": ("dbrx-132b", 1),
    "dbrx_adafactor_mb2": ("dbrx-132b", 2),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    """Two ``build_train_step`` steps from JAX's weights on the same global
    batches (mb 1: (4, 16); mb 2: (2, 2, 16)), against JAX's jitted step:
    each step's loss, the parameters under the flip rule, the optimizer
    state (AdamW's m within the gradient tolerance, v and Adafactor's stats
    within 1e-5 relative)."""
    name, mb = STEP_CASES[case]
    lr = 1e-3
    jcfg, cfg = _cfgs(name, microbatches=mb)
    assert cfg.optimizer == ("adafactor" if name == "dbrx-132b" else "adamw")
    jm, jp, m, p = _carried(jcfg, cfg)
    jstep, jopt = JS.build_train_step(jm, lr=lr)
    step, opt = S.build_train_step(m, lr=lr)
    js, ts = jopt.init(jp), opt.init(p)
    lead = () if mb == 1 else (mb,)
    batches = [_inputs(cfg, rows=4 // mb, seed=s, lead=lead) for s in range(2)]
    jf, grads = jax.jit(jstep), []
    for b in batches:
        # the step's gradient: the mean over equal microbatches, the whole batch's
        grads.append(_jax_grads(jm, jp, {k: v.reshape((4,) + v.shape[len(lead) + 1:])
                                         for k, v in b.items()})[1])
        jp, js, jmet = jf(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        p, ts, met = step(p, ts, {k: torch.from_numpy(v) for k, v in b.items()})
        _close_loss(float(met["loss"]), float(jmet["loss"]))
    want = dict(_paths(jax.tree.map(np.asarray, jp)))
    got = {k: v.numpy() for k, v in _paths(p)}
    flip_rule(case, got, want, grads, lr)
    jstate = jax.tree.map(np.asarray, js)
    assert int(ts["step"]) == int(jstate["step"]) == 2
    for k, w in _paths({key: jstate[key] for key in jstate if key != "step"}):
        g = dict(_paths(D.state_to_arrays({key: ts[key] for key in ts if key != "step"})))[k]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=GRAD_TOL * max(
            1.0, float(np.abs(w).max())), err_msg=k)


def test_train_step_runs_no_kernel_and_leaves_no_graph(monkeypatch):
    """A reduced Jamba step (Mamba2 on the plain chunked scan, attention on
    the chunked route) reaches no kernel wrapper, moves every leaf, and
    hands the parameters back without grad."""
    _refuse_flash(monkeypatch)
    _, cfg = _cfgs("jamba-1.5-large-398b", microbatches=2)
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    p0 = {k: v.clone() for k, v in _paths(p)}
    step, opt = S.build_train_step(m, lr=1e-3)
    p, st, met = step(p, opt.init(p), {k: torch.from_numpy(v) for k, v in
                                       _inputs(cfg, rows=2, lead=(2,)).items()})
    assert np.isfinite(float(met["loss"]))
    for k, v in _paths(p):
        assert not v.requires_grad and v.grad is None
        assert not torch.equal(v, p0[k]), k
