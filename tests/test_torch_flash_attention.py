"""The port's flash_attention on CPU tensors (its plain version, mha_ref)
against the JAX package's flash_attention, whose Pallas kernel runs in
interpret mode here, as tests/test_kernels.py runs it. Inputs from numpy
seeds; tolerances 2e-5 in f32 and 5e-2 in bf16, as there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ops import flash_attention

torch.set_num_threads(2)


def _qkv(seed, B, H, Hkv, T, S, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, T, dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, dh)).astype(np.float32))


def _both(q, k, v, dtype, **kw):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), bq=64, bkv=64, **kw)
    before = dict(build.LAUNCHES)
    got = flash_attention(*(torch.tensor(a).to(dtype) for a in (q, k, v)), **kw)
    assert build.LAUNCHES == before  # the CPU path launches nothing
    assert got.dtype == dtype
    return got.float().numpy(), np.asarray(want, np.float32)


# tests/test_kernels.py's sweep: GQA, window, q_offset, ragged T, T = 1
@pytest.mark.parametrize(
    "B,H,Hkv,T,S,dh,win,qoff",
    [
        (2, 4, 2, 128, 128, 64, 0, 0),
        (1, 8, 8, 64, 256, 32, 0, 192),
        (2, 4, 1, 256, 256, 64, 64, 0),
        (1, 2, 2, 100, 100, 64, 0, 0),
        (1, 4, 2, 1, 512, 64, 0, 511),
        (1, 2, 2, 128, 128, 128, 96, 0),
    ],
)
def test_flash_matches_jax(B, H, Hkv, T, S, dh, win, qoff):
    q, k, v = _qkv(0, B, H, Hkv, T, S, dh)
    got, want = _both(q, k, v, torch.float32, causal=True, window=win, q_offset=qoff)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_bf16_matches_jax():
    q, k, v = _qkv(1, 1, 2, 2, 128, 128, 64)
    got, want = _both(q, k, v, torch.bfloat16, causal=True)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_flash_not_causal_matches_jax():
    """causal=False where S is a block multiple, the case the reference
    defines (it pads S otherwise and lets zero keys into the softmax)."""
    q, k, v = _qkv(2, 2, 4, 2, 96, 128, 64)
    got, want = _both(q, k, v, torch.float32, causal=False)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_row_without_keys_is_zero():
    """Query positions past every key of their window see none: 0, as the
    Pallas kernel gives, not the NaN of a -inf softmax."""
    q, k, v = _qkv(3, 1, 2, 1, 40, 8, 64)
    got, want = _both(q, k, v, torch.float32, causal=True, window=4, q_offset=20)
    assert np.all(got == 0) and np.all(want == 0)


def test_flash_ragged_keys_masked_when_not_causal():
    """With S not a block multiple and causal=False the port masks the keys
    past S (the reference pads them into the softmax): it equals attention
    over the S real keys."""
    q, k, v = _qkv(4, 1, 2, 2, 30, 50, 32)
    got = flash_attention(*(torch.tensor(a) for a in (q, k, v)), causal=False)
    s = np.einsum("bhtd,bhsd->bhts", q.astype(np.float64), k) * 32 ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhts,bhsd->bhtd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
