"""The port's LLaVA-NeXT frontend (``Model.embed`` with ``patch_embeds``
over the leading positions) against the JAX package's, on the reduced
LLaVA-NeXT-Mistral-7B (2 layers, d 256, 4/4 heads of 64, 16 patch
positions), with JAX's weights carried across by ``params_from_arrays``
and numpy inputs. f32 within 2e-5 x max(1, max|logit|) for the forward and
2e-3 for decode logits; bf16 within 5e-2 x max(1, max|JAX|), the bf16 bound
of tests/test_torch_mla.py."""

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
from repro.models.transformer import build_model as jax_build
from repro_torch.configs import ARCHS
from repro_torch.kernels import build
from repro_torch.launch import serve
from repro_torch.models.layers import tree_map
from repro_torch.models.steps import build_prefill_step, build_serve_step
from repro_torch.models.transformer import build_model, params_from_arrays

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llava-next-mistral-7b"
DTYPES = ["float32", "bfloat16"]


def _carried(dtype, seed=0):
    jcfg = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), dtype=dtype)
    cfg = dataclasses.replace(ARCHS[ARCH].reduced(), dtype=dtype)
    jm, m = jax_build(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(seed))
    return jm, jp, m, params_from_arrays(m, jax.tree.map(np.asarray, jp))


def _inputs(cfg, B, T, seed, nf=None):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, T))
    nf = cfg.n_frontend_tokens if nf is None else nf
    pe = rng.standard_normal((B, nf, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(tok, jnp.int32), "patch_embeds": jnp.asarray(pe)},
            {"tokens": torch.tensor(tok), "patch_embeds": torch.tensor(pe)})


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


def _paths(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, leaf) for k, v in tree.items()
                for p, leaf in _paths(v)]
    return [("", tree)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_matches_jax(dtype):
    """``embed(params, tokens, inputs)``: the first 16 of 24 positions are
    the patches (cast to the activations' type), the rest the token rows,
    as JAX's ``dynamic_update_slice`` writes them; without ``inputs`` the
    token rows alone."""
    jm, jp, m, p = _carried(dtype, seed=1)
    ji, ti = _inputs(m.cfg, 2, 24, seed=1)
    cast = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype))
                        if a.dtype == jnp.float32 and a.ndim >= 2 else a, jp)
    want = jm.embed(cast, ji["tokens"], ji)
    got = m.embed(m.cast(p), ti["tokens"], ti)
    _same_type(got, want)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    nf = m.cfg.n_frontend_tokens
    np.testing.assert_array_equal(got[:, :nf].float().numpy(), np.asarray(
        ji["patch_embeds"].astype(jnp.dtype(dtype)), np.float32))
    plain = m.embed(m.cast(p), ti["tokens"])
    assert torch.equal(plain[:, nf:], got[:, nf:])
    assert not torch.equal(plain[:, :nf], got[:, :nf])


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(dtype):
    """The whole model with ``patch_embeds`` (16 of 24 positions): JAX's
    logits and type, f32 within 2e-5 x max(1, max|logit|); the flash route
    (the plain version here: no launch) within 2e-3, one call a layer."""
    jm, jp, m, p = _carried(dtype, seed=2)
    ji, ti = _inputs(m.cfg, 2, 24, seed=2)
    want = jm.forward(jp, ji)
    got = m.forward(p, ti)
    _same_type(got, want)
    _close(got, want, dtype)
    before = dict(build.LAUNCHES)
    flash = build_prefill_step(m, use_flash=True)(p, ti)
    assert build.LAUNCHES == before
    _close(flash, want, dtype, tol=2e-3)


def test_patches_change_the_logits():
    """Changing the patches changes the logits (JAX's
    ``test_vlm_patch_embedding_injection``), at every position from the
    first on, and a prompt as long as the patches is all patches."""
    _, _, m, p = _carried("float32", seed=3)
    _, ti = _inputs(m.cfg, 2, 20, seed=3)
    l1 = m.forward(p, ti)
    l2 = m.forward(p, {**ti, "patch_embeds": ti["patch_embeds"] + 1.0})
    assert float((l1 - l2).abs().max()) > 1e-3
    assert bool(((l1 - l2).abs().amax(-1) > 0).all())
    nf = m.cfg.n_frontend_tokens
    tok = ti["tokens"][:, :nf]
    only = m.forward(p, {"tokens": tok, "patch_embeds": ti["patch_embeds"]})
    other = m.forward(p, {"tokens": (tok + 1) % m.cfg.vocab_size,
                          "patch_embeds": ti["patch_embeds"]})
    assert torch.equal(only, other)


def test_more_patches_than_positions_raise():
    """nf > T raises, as JAX's ``dynamic_update_slice`` refuses it."""
    jm, jp, m, p = _carried("float32", seed=4)
    ji, ti = _inputs(m.cfg, 2, 8, seed=4)
    with pytest.raises(ValueError, match="patch_embeds"):
        m.forward(p, ti)
    with pytest.raises(TypeError):
        jm.forward(jp, ji)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_jax(dtype):
    """10 teacher-forced ``decode_step`` calls (tokens only: decode feeds no
    patches, in JAX as here): each step's logits against JAX's, f32 within
    2e-3, with JAX's types."""
    jm, jp, m, p = _carried(dtype, seed=5)
    B, T = 2, 10
    tok = np.random.default_rng(5).integers(0, m.cfg.vocab_size, (B, T))
    jc = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype), jm.cache_defs(B, T),
                      is_leaf=lambda x: hasattr(x, "materialize"))
    tc, step, jdec = m.init_caches(B, T), build_serve_step(m), jax.jit(jm.decode_step)
    for i in range(T):
        want, jc = jdec(jp, jc, jnp.asarray(tok[:, i:i + 1], jnp.int32),
                        jnp.asarray(i, jnp.int32))
        got, _ = step(p, tc, torch.tensor(tok[:, i:i + 1]), i)
        _same_type(got, want)
        _close(got, want, dtype, tol=2e-3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_loop_matches_jax(dtype):
    """``serve.generate`` against the loop of JAX's launch/serve.py main():
    teacher-forced logits within 2e-3 in f32 (5e-2 x max(1, max|logit|) in
    bf16) and the greedy tokens equal up to the first near-tie; no kernel
    launch."""
    jm, jp, m, p = _carried(dtype, seed=6)
    B, T, gen = 2, 8, 6
    tokens = np.random.default_rng(6).integers(0, m.cfg.vocab_size, (B, T))
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


def test_full_config_on_meta_matches_jax():
    """The full LLaVA-NeXT-Mistral-7B (32 stacked layers, d 4,096, GQA 32/8
    of 128, bf16): JAX's parameter tree and count (``param_count()`` plus
    the norms it leaves out: ``final_ln``), and the forward on the meta
    device with 2,880 patch positions of 3,000 against JAX's
    ``eval_shape``: bf16 logits of the vocab 32,000."""
    jcfg, cfg = JAX_ARCHS[ARCH], ARCHS[ARCH]
    jm, m = jax_build(jcfg), build_model(cfg)
    want, got = sorted(_paths(jm.defs)), sorted(_paths(m.defs))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.init == w.init
    n = sum(int(np.prod(d.shape)) for _, d in got)
    assert n == cfg.param_count() + cfg.d_model and m.padded_vocab == 32_000
    assert round(cfg.param_count() / 1e9, 3) == 7.242
    B, T, nf, d = 1, 3000, cfg.n_frontend_tokens, cfg.d_model
    want = jax.eval_shape(
        lambda q, t, f: jm.forward(q, {"tokens": t, "patch_embeds": f}),
        jm.abstract_params(), jax.ShapeDtypeStruct((B, T), jnp.int32),
        jax.ShapeDtypeStruct((B, nf, d), jnp.float32))
    p = tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), m.defs)
    out = build_prefill_step(m)(p, {
        "tokens": torch.zeros((B, T), dtype=torch.long, device="meta"),
        "patch_embeds": torch.empty(B, nf, d, device="meta")})
    assert tuple(out.shape) == want.shape == (B, T, 32_000)
    assert str(out.dtype).split(".")[-1] == str(want.dtype) == "bfloat16"


def test_serve_cli_on_cpu():
    """``python -m repro_torch.launch.serve --arch llava-next-mistral-7b
    --device cpu`` as README gives it: the reduced LLaVA in bf16."""
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
