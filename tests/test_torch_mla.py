"""The port's Multi-head Latent Attention (models/attention.py, MiniCPM3)
against the JAX package's: the parameter defs, ``_mla_split``,
``_mla_train`` (the chunked route, whatever ``use_flash`` says) and the
absorbed ``_mla_decode`` step by step with its latent cache, at the
reduced MiniCPM3-4B, with JAX's weights and numpy inputs. f32 within 2e-5;
bf16 within 5e-2 x max(1, max|JAX|), the bf16 bound of
tests/test_torch_flash_attention.py, with the output types JAX's
promotion gives."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build
from repro_torch.configs import ARCHS
from repro_torch.kernels import build
from repro_torch.models import attention as A
from repro_torch.models.steps import build_prefill_step
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)

ARCH = "minicpm3-4b"
DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(JAX_ARCHS[ARCH].reduced(), dtype=dtype, **kw),
            dataclasses.replace(ARCHS[ARCH].reduced(), dtype=dtype, **kw))


def _weights(jcfg, dtype, seed=0):
    """One MLA layer's weights, matrices in ``dtype`` and the 1-D norms in
    f32, as the reduced model's cast leaves them."""
    jp = JL.materialize(JA.attn_defs(jcfg), jax.random.key(seed))
    jp = {k: v.astype(jnp.dtype(dtype)) if v.ndim >= 2 else v for k, v in jp.items()}
    p = {k: torch.tensor(np.asarray(v, np.float32)).to(getattr(torch, str(v.dtype)))
         for k, v in jp.items()}
    return jp, p


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.tensor(x).to(getattr(torch, dtype))


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=5e-2,
                                   atol=5e-2 * max(1.0, float(np.abs(want).max())))


def _same_type(got, want):
    assert str(got.dtype).split(".")[-1] == str(want.dtype)


# ---------------------------------------------------------------------- defs
@pytest.mark.parametrize("reduced", [True, False])
def test_attn_defs_match_jax(reduced):
    """wq_a, q_norm, wq_b, wkv_a, kv_norm, wkv_b, wo: JAX's keys, shapes and
    init rules (the full config: q_lora 768, kv_lora 256, rope dim 32)."""
    jcfg, cfg = JAX_ARCHS[ARCH], ARCHS[ARCH]
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want, got = JA.attn_defs(jcfg), A.attn_defs(cfg)
    assert list(got) == list(want) == ["wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm",
                                       "wkv_b", "wo"]
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape) and got[k].init == want[k].init
    if not reduced:
        assert tuple(got["wq_b"].shape) == (768, 40 * (64 + 32))
        assert tuple(got["wkv_b"].shape) == (256, 40 * 2 * 64)


@pytest.mark.parametrize("reduced", [True, False])
def test_cache_defs_match_jax(reduced):
    """The latent cache: ``c_kv`` (B, seq, kv_lora) and ``k_rope`` (B, seq,
    rope dim) in the config's dtype, no ring; the model's per-layer tree
    (stacked over the 62 layers of the full config) as JAX's."""
    jcfg, cfg = JAX_ARCHS[ARCH], ARCHS[ARCH]
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want, got = JA.cache_defs(jcfg, 3, 40), A.cache_defs(cfg, 3, 40)
    assert list(got) == list(want) == ["c_kv", "k_rope"]
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    jm, m = jax_build(jcfg), build_model(cfg)
    wtree, gtree = jm.cache_defs(3, 40), m.cache_defs(3, 40)
    assert list(gtree) == list(wtree)
    for j in wtree:
        for k in wtree[j]:
            assert tuple(gtree[j][k].shape) == tuple(wtree[j][k].shape)


# ------------------------------------------------------------- prefill path
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_split_matches_jax(dtype):
    jcfg, cfg = _cfgs(dtype)
    jp, p = _weights(jcfg, dtype)
    xj, xt = _x((2, 24, cfg.d_model), dtype)
    for g, w in zip(A._mla_split(p, xt, cfg), JA._mla_split(jp, xj, jcfg)):
        _same_type(g, w)
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_mla_train_matches_jax(dtype, causal):
    """Through ``attention_train`` at T 1,024: two query chunks of 512;
    ``use_flash`` changes nothing."""
    jcfg, cfg = _cfgs(dtype)
    jp, p = _weights(jcfg, dtype, seed=2)
    xj, xt = _x((1, 1024, cfg.d_model), dtype, seed=2)
    want = JA.attention_train(jp, xj, jcfg, causal=causal)
    got = A.attention_train(p, xt, cfg, causal=causal)
    _same_type(got, want)
    _close(got, want, dtype)
    flash = A.attention_train(p, xt, cfg, causal=causal, use_flash=True)
    assert torch.equal(flash, got)


def test_mla_prefill_never_takes_flash(monkeypatch):
    """``build_prefill_step(model, use_flash=True)`` on MiniCPM3 calls no
    flash route at all (JAX returns through ``_mla_train`` before it)."""
    def refuse(*a, **k):
        raise AssertionError("flash_attention called on an MLA layer")

    monkeypatch.setattr(A, "flash_attention", refuse)
    _, cfg = _cfgs()
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    before = dict(build.LAUNCHES)
    tok = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    out = build_prefill_step(m, use_flash=True)(p, {"tokens": tok})
    assert bool(torch.isfinite(out).all()) and build.LAUNCHES == before


# -------------------------------------------------------------- decode path
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_matches_jax_step_by_step(dtype):
    """The absorbed decode, 10 teacher-forced steps into a cache of 12: each
    step's output and the whole cache (written in place in the port)
    against JAX's returned ones."""
    jcfg, cfg = _cfgs(dtype)
    jp, p = _weights(jcfg, dtype, seed=3)
    B, steps, seq = 2, 10, 12
    xs = np.random.default_rng(3).standard_normal((steps, B, 1, cfg.d_model)).astype(
        np.float32)
    jc = {k: jnp.zeros(d.shape, d.dtype) for k, d in JA.cache_defs(jcfg, B, seq).items()}
    tc = {k: torch.zeros(d.shape, dtype=d.dtype) for k, d in A.cache_defs(cfg, B, seq).items()}
    for i in range(steps):
        xj = jnp.asarray(xs[i], jnp.dtype(dtype))
        xt = torch.tensor(xs[i]).to(getattr(torch, dtype))
        want, jc = JA.attention_decode(jp, xj, jc, jnp.asarray(i, jnp.int32), jcfg)
        got, out = A.attention_decode(p, xt, tc, i, cfg)
        assert out is tc
        _same_type(got, want)
        _close(got, want, dtype)
        for k in jc:
            _close(tc[k], jc[k], dtype)
    assert float(tc["c_kv"][:, steps:].abs().max()) == 0.0


def test_mla_decode_matches_train():
    """The port's own absorbed decode (no attention code shared with the
    prefill route) against its ``_mla_train`` of the same inputs, f32."""
    _, cfg = _cfgs()
    p = {k: d.materialize(torch.Generator().manual_seed(4))
         for k, d in A.attn_defs(cfg).items()}
    x = torch.tensor(np.random.default_rng(4).standard_normal((2, 9, cfg.d_model)),
                     dtype=torch.float32)
    full = A.attention_train(p, x, cfg)
    cache = {k: torch.zeros(d.shape) for k, d in A.cache_defs(cfg, 2, 9).items()}
    dec = torch.cat([A.attention_decode(p, x[:, i:i + 1], cache, i, cfg)[0]
                     for i in range(9)], dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-5, atol=2e-5)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("dtype", DTYPES)
def test_model_forward_and_decode_match_jax(dtype):
    """The reduced MiniCPM3 with JAX's weights: the prefill logits (flash
    asked for, chunked taken) and 12 teacher-forced decode steps against
    JAX's forward and decode_step, with JAX's logit types."""
    from repro_torch.models.steps import build_serve_step
    from repro_torch.models.transformer import params_from_arrays

    jcfg, cfg = _cfgs(dtype)
    jm, m = jax_build(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(5))
    p = params_from_arrays(m, jax.tree.map(np.asarray, jp))
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12))
    want = jm.forward(jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    got = build_prefill_step(m, use_flash=True)(p, {"tokens": torch.tensor(tok)})
    _same_type(got, want)
    _close(got, want, dtype)
    caches = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype), jm.cache_defs(2, 12),
                          is_leaf=lambda x: hasattr(x, "materialize"))
    tc, serve = m.init_caches(2, 12), build_serve_step(m)
    for i in range(12):
        w, caches = jm.decode_step(jp, caches, jnp.asarray(tok[:, i:i + 1], jnp.int32),
                                   jnp.asarray(i, jnp.int32))
        g, tc = serve(p, tc, torch.tensor(tok[:, i:i + 1]), i)
        _same_type(g, w)
        _close(g, w, dtype)
