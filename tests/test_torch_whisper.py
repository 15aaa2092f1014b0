"""The port's Whisper encoder-decoder (models/attention.py cross-attention,
models/transformer.py encoder, cross blocks and cross caches) against the
JAX package's, on the reduced Whisper-large-v3 (2 + 2 layers, d 256, 4
heads of 64, 32 encoder frames), with JAX's weights carried across by
``params_from_arrays`` and numpy inputs. f32: 2e-5 for a layer, 2e-5 x
max(1, max|logit|) for the forward, 2e-3 for decode logits; bf16 within 5e-2
x max(1, max|JAX|), the bf16 bound of tests/test_torch_mla.py."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models.layers import tree_map
from repro_torch.models.steps import build_prefill_step, build_serve_step
from repro_torch.models.transformer import build_model, params_from_arrays

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-large-v3"
DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(JAX_ARCHS[ARCH].reduced(), dtype=dtype, **kw),
            dataclasses.replace(ARCHS[ARCH].reduced(), dtype=dtype, **kw))


def _tdt(dtype):
    return getattr(torch, dtype)


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.tensor(x).to(_tdt(dtype))


def _weights(jcfg, dtype, seed):
    """One cross-attention's weights, in ``dtype``."""
    jp = JL.materialize(JA.attn_defs(jcfg, cross=True), jax.random.key(seed))
    jp = {k: v.astype(jnp.dtype(dtype)) for k, v in jp.items()}
    p = {k: torch.tensor(np.asarray(v, np.float32)).to(_tdt(dtype)) for k, v in jp.items()}
    return jp, p


def _close(got, want, dtype, tol=2e-5):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * max(1.0, float(np.abs(want).max())))
    else:
        np.testing.assert_allclose(got, want, rtol=5e-2,
                                   atol=5e-2 * max(1.0, float(np.abs(want).max())))


def _same_type(got, want):
    assert str(got.dtype).split(".")[-1] == str(jnp.dtype(want.dtype))


def _carried(dtype, seed=0):
    jcfg, cfg = _cfgs(dtype)
    jm, m = jax_build(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(seed))
    return jm, jp, m, params_from_arrays(m, jax.tree.map(np.asarray, jp))


def _inputs(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, T))
    frames = rng.standard_normal((B, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(tok, jnp.int32), "enc_frames": jnp.asarray(frames)},
            {"tokens": torch.tensor(tok), "enc_frames": torch.tensor(frames)})


def _paths(tree):
    """(path, leaf) of a nested dict of defs, JAX's or the port's."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, leaf) for k, v in tree.items()
                for p, leaf in _paths(v)]
    return [("", tree)]


def _jax_cross_caches(jm, jp, caches, frames):
    """The cross caches as JAX's tests/test_models.py ``_prefill_cross``
    fills them: ``enc_out @ xattn.wk`` and ``@ xattn.wv``, in the cache
    dtype."""
    cfg = jm.cfg
    cast = jax.tree.map(lambda a: a.astype(jnp.dtype(cfg.dtype))
                        if a.dtype == jnp.float32 and a.ndim >= 2 else a, jp)
    enc = jm._encode(cast, frames)
    B = frames.shape[0]
    out = {}
    for j, c in caches.items():
        xa = jp["layers"][j]["xattn"]
        out[j] = {**c,
                  "xk": (enc @ xa["wk"]).reshape(B, -1, cfg.n_kv_heads, cfg.head_dim
                                                 ).astype(c["xk"].dtype),
                  "xv": (enc @ xa["wv"]).reshape(B, -1, cfg.n_kv_heads, cfg.head_dim
                                                 ).astype(c["xv"].dtype)}
    return out


def _fill_cross(m, params, caches, frames):
    """The same fill in the port: the encoder's output through each decoder
    layer's ``xattn`` wk and wv, written into ``xk``/``xv``."""
    cfg = m.cfg
    cast = m.cast(params)
    enc = m._encode(cast, frames)
    B = frames.shape[0]
    for p, c in zip(m._layers(cast["layers"]), m._layers(caches)):
        xa = p["xattn"]
        c["xk"].copy_((enc @ xa["wk"]).reshape(B, -1, cfg.n_kv_heads, cfg.head_dim))
        c["xv"].copy_((enc @ xa["wv"]).reshape(B, -1, cfg.n_kv_heads, cfg.head_dim))
    return caches


# ---------------------------------------------------------------------- defs
@pytest.mark.parametrize("reduced", [True, False])
def test_attn_and_cache_defs_match_jax(reduced):
    """``attn_defs(cross=True)`` and ``cache_defs(..., cross_len)`` (``xk``,
    ``xv`` of (B, cross_len, Hkv, hd) in the config's dtype) as JAX's."""
    jcfg, cfg = JAX_ARCHS[ARCH], ARCHS[ARCH]
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for cross in (False, True):
        want, got = JA.attn_defs(jcfg, cross=cross), A.attn_defs(cfg, cross=cross)
        assert list(got) == list(want) == ["wq", "wk", "wv", "wo"]
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert got[k].init == want[k].init
    want = JA.cache_defs(jcfg, 3, 40, cross_len=jcfg.encoder_ctx)
    got = A.cache_defs(cfg, 3, 40, cross_len=cfg.encoder_ctx)
    assert list(got) == list(want) == ["k", "v", "xk", "xv"]
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        _same_type(got[k], want[k])
    assert tuple(got["xk"].shape) == (3, cfg.encoder_ctx, cfg.n_kv_heads, cfg.head_dim)
    assert list(A.cache_defs(cfg, 3, 40)) == ["k", "v"]


@pytest.mark.parametrize("reduced", [True, False])
def test_param_and_cache_trees_match_jax(reduced):
    """The model's parameter tree (``ln_x`` and ``xattn`` in every decoder
    layer; the encoder as ``encoder/e{i}`` when reduced, stacked over its
    32 layers in the full config; ``enc_final_ln``) and its cache tree, key
    by key, with JAX's shapes, init rules and dtypes."""
    jcfg, cfg = JAX_ARCHS[ARCH], ARCHS[ARCH]
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jm, m = jax_build(jcfg), build_model(cfg)
    want, got = sorted(_paths(jm.defs)), sorted(_paths(m.defs))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.init == w.init
        _same_type(g, w)
    keys = [p for p, _ in got]
    assert "layers/l0/xattn/wq" in keys and "layers/l0/ln_x" in keys
    assert ("encoder/e1/attn/wq" in keys) == reduced
    assert ("encoder/attn/wq" in keys) == (not reduced)
    assert m.enc_scan == (not reduced) == jm.enc_scan
    wc, gc = sorted(_paths(jm.cache_defs(2, 10))), sorted(_paths(m.cache_defs(2, 10)))
    assert [p for p, _ in gc] == [p for p, _ in wc]
    for (_, g), (_, w) in zip(gc, wc):
        assert tuple(g.shape) == tuple(w.shape)


# ------------------------------------------------------------- prefill path
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_train_matches_jax(dtype, monkeypatch):
    """``attention_train`` with ``kv_src`` (T 12 queries against S 40
    encoder positions, two lengths that rope would tell apart): JAX's
    output and type. ``use_flash=True`` and ``causal=True`` change nothing:
    the chunked route, never the kernel (monkeypatched to raise)."""
    def refuse(*a, **k):
        raise AssertionError("flash_attention called on cross-attention")

    monkeypatch.setattr(A, "flash_attention", refuse)
    jcfg, cfg = _cfgs(dtype)
    jp, p = _weights(jcfg, dtype, seed=1)
    xj, xt = _x((2, 12, cfg.d_model), dtype, seed=1)
    sj, st = _x((2, 40, cfg.d_model), dtype, seed=2)
    want = JA.attention_train(jp, xj, jcfg, kv_src=sj)
    got = A.attention_train(p, xt, cfg, kv_src=st)
    _same_type(got, want)
    _close(got, want, dtype)
    flash = A.attention_train(p, xt, cfg, causal=True, kv_src=st, use_flash=True)
    assert torch.equal(flash, got)


def test_cross_attention_has_no_rope_and_no_mask():
    """Cross-attention sees the encoder positions as a set: permuting them
    leaves the output as it is (rope or a causal mask would move it)."""
    _, cfg = _cfgs()
    p = {k: d.materialize(torch.Generator().manual_seed(3))
         for k, d in A.attn_defs(cfg, cross=True).items()}
    x = torch.randn(2, 7, cfg.d_model, generator=torch.Generator().manual_seed(4))
    src = torch.randn(2, 30, cfg.d_model, generator=torch.Generator().manual_seed(5))
    perm = torch.randperm(30, generator=torch.Generator().manual_seed(6))
    got = A.attention_train(p, x, cfg, kv_src=src, use_flash=True)
    torch.testing.assert_close(A.attention_train(p, x, cfg, kv_src=src[:, perm]), got,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_self_attention_matches_jax(dtype, monkeypatch):
    """The encoder's self-attention: non-causal, with rope; JAX's output,
    and the chunked route with ``use_flash`` (a non-causal call never
    reaches the kernel)."""
    def refuse(*a, **k):
        raise AssertionError("flash_attention called on non-causal attention")

    monkeypatch.setattr(A, "flash_attention", refuse)
    jcfg, cfg = _cfgs(dtype)
    jp, p = _weights(jcfg, dtype, seed=7)
    xj, xt = _x((2, 32, cfg.d_model), dtype, seed=7)
    want = JA.attention_train(jp, xj, jcfg, causal=False)
    got = A.attention_train(p, xt, cfg, causal=False, use_flash=True)
    _same_type(got, want)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_jax(dtype):
    """``_encode`` of (2, 32, 256) frames: JAX's output and type."""
    jm, jp, m, p = _carried(dtype, seed=8)
    ji, ti = _inputs(m.cfg, 2, 8, seed=8)
    cast = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype))
                        if a.dtype == jnp.float32 and a.ndim >= 2 else a, jp)
    want = jm._encode(cast, ji["enc_frames"])
    got = m._encode(m.cast(p), ti["enc_frames"])
    _same_type(got, want)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(dtype, monkeypatch):
    """The whole model with ``enc_frames``: JAX's logits and type, f32
    within 2e-5 x max(1, max|logit|); ``build_prefill_step(use_flash=True)``
    gives the same logits, with one flash call a decoder layer (the plain
    version here) and none for the encoder or cross-attention."""
    jm, jp, m, p = _carried(dtype, seed=9)
    ji, ti = _inputs(m.cfg, 2, 12, seed=9)
    want = jm.forward(jp, ji)
    got = m.forward(p, ti)
    _same_type(got, want)
    _close(got, want, dtype)
    calls = []
    real = A.flash_attention

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(A, "flash_attention", counted)
    before = dict(build.LAUNCHES)
    flash = build_prefill_step(m, use_flash=True)(p, ti)
    assert build.LAUNCHES == before  # the CPU launches no kernel
    H, hd = m.cfg.n_heads, m.cfg.head_dim
    assert calls == [((2, H, 12, hd), (2, H, 12, hd), True)] * m.cfg.n_layers
    _close(flash, want, dtype, tol=2e-3)


def test_full_config_on_meta_matches_jax():
    """The full Whisper-large-v3 (32 + 32 layers stacked, d 1,280, bf16):
    the parameter count is JAX's ``param_count()`` plus the padded vocab's
    rows and the norms it leaves out (``ln_x`` a decoder layer,
    ``final_ln``, ``enc_final_ln``); the forward on the meta device gives JAX's
    ``eval_shape`` logits, bf16 of the padded vocab 51,872."""
    jcfg, cfg = JAX_ARCHS[ARCH], ARCHS[ARCH]
    jm, m = jax_build(jcfg), build_model(cfg)
    n = sum(int(np.prod(d.shape)) for _, d in _paths(m.defs))
    want_n = sum(int(np.prod(d.shape)) for _, d in _paths(jm.defs))
    d = cfg.d_model
    assert n == want_n == (cfg.param_count() + 2 * (m.padded_vocab - cfg.vocab_size) * d
                           + cfg.n_layers * d + 2 * d)
    assert m.padded_vocab == 51_872 and round(cfg.param_count() / 1e9, 3) == 1.601
    shape = (2, 16)
    want = jax.eval_shape(
        lambda q, t, f: jm.forward(q, {"tokens": t, "enc_frames": f}),
        jm.abstract_params(), jax.ShapeDtypeStruct(shape, jnp.int32),
        jax.ShapeDtypeStruct((2, cfg.encoder_ctx, d), jnp.float32))
    p = tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), m.defs)
    got = build_prefill_step(m)(p, {
        "tokens": torch.zeros(shape, dtype=torch.long, device="meta"),
        "enc_frames": torch.empty(2, cfg.encoder_ctx, d, device="meta")})
    assert tuple(got.shape) == want.shape == (*shape, 51_872)
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == "bfloat16"


# -------------------------------------------------------------- decode path
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_decode_matches_jax(dtype):
    """``cross_attention_decode`` of one token against a filled cross cache
    of 40 positions: JAX's output and type; the cache is not written."""
    jcfg, cfg = _cfgs(dtype)
    jp, p = _weights(jcfg, dtype, seed=10)
    xj, xt = _x((2, 1, cfg.d_model), dtype, seed=10)
    shape = (2, 40, cfg.n_kv_heads, cfg.head_dim)
    kj, kt = _x(shape, dtype, seed=11)
    vj, vt = _x(shape, dtype, seed=12)
    want = JA.cross_attention_decode(jp, xj, {"xk": kj, "xv": vj}, jcfg)
    cache = {"xk": kt, "xv": vt}
    got = A.cross_attention_decode(p, xt, cache, cfg)
    _same_type(got, want)
    _close(got, want, dtype)
    assert cache["xk"] is kt and torch.equal(kt, torch.tensor(
        np.asarray(kj, np.float32)).to(_tdt(dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_matches_jax_step_by_step(dtype):
    """12 teacher-forced ``decode_step`` calls on cross caches filled as
    JAX's ``_prefill_cross`` fills them: each step's logits against JAX's
    (f32 within 2e-3, JAX's decode bound), and the self-attention caches
    written in place as JAX returns them."""
    jm, jp, m, p = _carried(dtype, seed=13)
    B, T = 2, 12
    ji, ti = _inputs(m.cfg, B, T, seed=13)
    jc = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype), jm.cache_defs(B, T),
                      is_leaf=lambda x: hasattr(x, "materialize"))
    jc = _jax_cross_caches(jm, jp, jc, ji["enc_frames"])
    tc = _fill_cross(m, p, m.init_caches(B, T), ti["enc_frames"])
    for j in jc:
        for k in ("xk", "xv"):
            _close(tc[j][k], jc[j][k], dtype)
    tok = np.asarray(ji["tokens"])
    step, jdec = build_serve_step(m), jax.jit(jm.decode_step)
    for i in range(T):
        want, jc = jdec(jp, jc, jnp.asarray(tok[:, i:i + 1]),
                                  jnp.asarray(i, jnp.int32))
        got, out = step(p, tc, torch.tensor(tok[:, i:i + 1]), i)
        assert out is tc
        _same_type(got, want)
        _close(got, want, dtype, tol=2e-3)
    for j in jc:
        for k in jc[j]:
            _close(tc[j][k], jc[j][k], dtype, tol=2e-3)


def test_decode_matches_forward():
    """The port's decode against its own forward, as JAX's
    ``test_decode_matches_forward_whisper``: cross caches filled from the
    encoder, every teacher-forced step within 2e-3 of the prefill's logits
    at its position (f32)."""
    _, cfg = _cfgs()
    m = build_model(cfg)
    p = m.init(torch.Generator().manual_seed(14))
    B, T = 2, 10
    _, ti = _inputs(cfg, B, T, seed=14)
    full = m.forward(p, ti)
    caches = _fill_cross(m, p, m.init_caches(B, T), ti["enc_frames"])
    step = build_serve_step(m)
    dec = torch.cat([step(p, caches, ti["tokens"][:, i:i + 1], i)[0] for i in range(T)],
                    dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_loop_matches_jax(dtype):
    """``serve.generate`` against the loop of JAX's launch/serve.py main()
    (zero cross caches, as JAX's serve decodes): teacher-forced logits within
    2e-3 in f32 (5e-2 x max(1, max|logit|) in bf16) and the greedy tokens
    equal up to the first near-tie; no kernel launch."""
    jm, jp, m, p = _carried(dtype, seed=15)
    B, T, gen = 2, 8, 6
    tokens = np.random.default_rng(15).integers(0, m.cfg.vocab_size, (B, T))
    caches = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype), jm.cache_defs(B, T + gen),
                          is_leaf=lambda x: hasattr(x, "materialize"))
    dec = jax.jit(jm.decode_step)
    want, want_logits, logits = [], [], None
    for i in range(T + gen):
        if i < T:
            tok = jnp.asarray(tokens[:, i:i + 1], jnp.int32)
        else:
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
            want.append(np.asarray(tok))
        logits, caches = dec(jp, caches, tok, jnp.asarray(i, jnp.int32))
        want_logits.append(np.asarray(logits[:, 0], np.float32))
    want = np.concatenate(want, axis=1)
    before = dict(build.LAUNCHES)
    got, got_logits = serve.generate(m, m.cast(p), tokens, gen)
    assert build.LAUNCHES == before
    assert got.shape == (B, gen) and len(got_logits) == T + gen
    tol = 2e-3 if dtype == "float32" else 5e-2
    for i in range(T):
        _close(got_logits[i][:, 0], want_logits[i], dtype, tol=tol)
    for b in range(B):
        for t in range(gen):
            top2 = np.sort(want_logits[T - 1 + t][b])[-2:]
            if top2[1] - top2[0] <= tol * max(1.0, float(np.abs(top2).max())):
                break  # a near-tie: the two may pick either, and then diverge
            assert got[b, t] == want[b, t], (b, t)


def test_serve_cli_on_cpu():
    """``python -m repro_torch.launch.serve --arch whisper-large-v3 --device
    cpu`` as README gives it: the reduced Whisper in bf16."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--batch", "2", "--prompt-len", "8", "--gen", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("12 steps in ") and lines[0].endswith(" tok/s")
    assert lines[1] == f"arch={ARCH} reduced=True batch=2"
    rows = [ln.strip(" []").split() for ln in lines[3:5]]
    assert [len(r) for r in rows] == [4, 4]
