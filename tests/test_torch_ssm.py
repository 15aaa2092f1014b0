"""The port's Mamba2 mixer (models/ssm.py) against the JAX package's, on the
reduced Mamba2-2.7B in f32, with JAX's parameters carried across as numpy
arrays and inputs from numpy seeds. A_log, dt_bias and D_skip are drawn at
random (their inits are constants) so that the decay, the dt clip and the
skip all take part. Single ops are held to 2e-5, the mixer (projections,
conv, scan, gate) to 2e-4; the last test runs the mixer in bf16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.configs import ARCHS
from repro_torch.models import ssm as S
from repro_torch.models.layers import materialize

torch.set_num_threads(2)
ARCH = "mamba2-2.7b"


def _cfgs():
    return (dataclasses.replace(JAX_ARCHS[ARCH].reduced(), dtype="float32"),
            dataclasses.replace(ARCHS[ARCH].reduced(), dtype="float32"))


def _params(jcfg, seed=0):
    """JAX's mamba parameters with random A_log, dt_bias, D_skip: as numpy,
    jax and torch arrays."""
    p = {k: np.asarray(v) for k, v in
         JL.materialize(JS.mamba_defs(jcfg), jax.random.key(seed)).items()}
    rng = np.random.default_rng(seed)
    H = jcfg.n_mamba_heads
    p["A_log"] = rng.uniform(-1.0, 1.5, H).astype(np.float32)
    p["dt_bias"] = rng.uniform(-2.0, 1.0, H).astype(np.float32)
    p["D_skip"] = rng.standard_normal(H).astype(np.float32)
    return (p, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.tensor(v) for k, v in p.items()})


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_mamba_defs_match_jax():
    jcfg, cfg = _cfgs()
    jd, d = JS.mamba_defs(jcfg), S.mamba_defs(cfg)
    assert {k: tuple(v.shape) for k, v in jd.items()} == {k: v.shape for k, v in d.items()}
    assert {k: v.init for k, v in jd.items()} == {k: v.init for k, v in d.items()}
    jsd, sd = JS.mamba_state_defs(jcfg, 3), S.mamba_state_defs(cfg, 3)
    assert {k: (tuple(v.shape), str(np.dtype(v.dtype))) for k, v in jsd.items()} == \
        {k: (v.shape, str(v.dtype).split(".")[-1]) for k, v in sd.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    """0 + t0 + t1 + ... in the inputs' type; bf16 is held to its rounding."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 19, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.5).astype(np.float32)
    want = JS._causal_conv(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    got = S._causal_conv(torch.tensor(x).to(getattr(torch, dtype)),
                         torch.tensor(w).to(getattr(torch, dtype)))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got, want, 2e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("T", [48, 37])
def test_mamba_train_matches_jax(T):
    """48 runs JAX's chunk 16, 37 (ragged) its chunk 1."""
    jcfg, cfg = _cfgs()
    _, jp, p = _params(jcfg)
    x = np.random.default_rng(2).standard_normal((2, T, cfg.d_model)).astype(np.float32)
    want = JS.mamba_train(jp, jnp.asarray(x), jcfg)
    got = S.mamba_train(p, torch.tensor(x), cfg)
    assert got.shape == (2, T, cfg.d_model)
    _close(got, want, 2e-4)


def test_mamba_decode_matches_jax():
    """Ten tokens through the recurrence in both packages: each step's
    output and the whole state (conv windows, SSM state) after it. The
    port writes its state in place."""
    jcfg, cfg = _cfgs()
    _, jp, p = _params(jcfg, seed=3)
    B = 2
    jst = {k: jnp.zeros(d.shape, d.dtype) for k, d in JS.mamba_state_defs(jcfg, B).items()}
    st = materialize(S.mamba_state_defs(cfg, B), None)
    ssm = st["ssm"]
    xs = np.random.default_rng(4).standard_normal((10, B, 1, cfg.d_model)).astype(np.float32)
    for x1 in xs:
        want, jst = JS.mamba_decode(jp, jnp.asarray(x1), jst, jcfg)
        got, st2 = S.mamba_decode(p, torch.tensor(x1), st, cfg)
        assert st2 is st and st["ssm"] is ssm  # in place
        _close(got, want, 2e-4)
        for k in jst:
            _close(st[k], jst[k], 2e-4)


def test_mamba_decode_matches_train():
    """The port's own recurrence, token by token, equals its chunked prefill
    of the same sequence (JAX's decode-vs-forward bound, 2e-3)."""
    jcfg, cfg = _cfgs()
    _, _, p = _params(jcfg, seed=5)
    x = torch.tensor(np.random.default_rng(6).standard_normal((2, 20, cfg.d_model)),
                     dtype=torch.float32)
    full = S.mamba_train(p, x, cfg)
    st = materialize(S.mamba_state_defs(cfg, 2), None)
    steps = [S.mamba_decode(p, x[:, t:t + 1], st, cfg)[0] for t in range(20)]
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("stacked", [False, True])
def test_mamba_bf16_matches_jax(stacked):
    """The mixer in bf16, the serve CLI's dtype, with the weights cast as
    the model casts them: the matrices to bf16, and the 1-D A_log, dt_bias,
    D_skip and norm_z kept f32 (a config whose layers are apart) or cast
    too (``stacked``: under ``scan_layers`` they are 2-D). The types of the output and of every state entry are JAX's, and the f32
    SSM state after ten decode steps is within 1e-4 of JAX's (measured
    1.4e-6 and 1.9e-6; computing softplus(dt) in bf16, the conv window in bf16 or
    rounding x to bf16 before the state update each move it by 1.6e-2 or
    more). The bf16 outputs, where the two packages round their matmuls in
    another order, are held to 2^-7 |want| + 6e-2 (measured: at most 2.0e-2
    beyond 2^-7 |want|, for |want| up to 3.9); that bound does not see an
    order slip inside one bf16 rounding, such as the D skip added after the
    cast to bf16 instead of before it."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs())
    _, jp, p = _params(jcfg, seed=3)
    jp = {k: v.astype(jnp.bfloat16) if stacked or v.ndim >= 2 else v
          for k, v in jp.items()}
    p = {k: v.to(torch.bfloat16) if stacked or v.dim() >= 2 else v for k, v in p.items()}

    def close(got, want):
        want = np.asarray(want, np.float32)
        diff = np.abs(got.float().numpy() - want)
        assert (diff <= 2.0 ** -7 * np.abs(want) + 6e-2).all(), diff.max()

    x = np.random.default_rng(2).standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    want = JS.mamba_train(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    got = S.mamba_train(p, torch.tensor(x).to(torch.bfloat16), cfg)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    close(got, want)

    B = 2
    jst = {k: jnp.zeros(d.shape, d.dtype) for k, d in JS.mamba_state_defs(jcfg, B).items()}
    st = materialize(S.mamba_state_defs(cfg, B), None)
    for x1 in np.random.default_rng(4).standard_normal((10, B, 1, cfg.d_model)):
        want, jst = JS.mamba_decode(jp, jnp.asarray(x1, jnp.bfloat16), jst, jcfg)
        got, st = S.mamba_decode(p, torch.tensor(x1).to(torch.bfloat16), st, cfg)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        close(got, want)
    for k in jst:
        assert str(st[k].dtype).split(".")[-1] == str(jst[k].dtype), k
    assert st["ssm"].dtype == torch.float32
    d = float(np.abs(st["ssm"].numpy() - np.asarray(jst["ssm"])).max())
    assert d <= 1e-4, d
