"""The port's SSD scan (kernels/ssd_scan: ``ssd_ref``, ``ssd_chunked``, the
batched ``ssd_chunked_batched`` and the CPU path of ``ssd_scan``) against
the JAX package's ``ssd_ref``, ``ssd_chunked_jnp`` and its Pallas kernel
``ssd_scan`` in interpret mode, on numpy-made inputs of JAX's sweep
(tests/test_kernels.py:81-112). The same algorithm in both packages is held
to 2e-5 (f32 sums in another order); a different algorithm (chunked
against step by step, or against the Pallas kernel) to JAX's own bound,
1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_chunked_jnp, ssd_ref as jax_ssd_ref
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (
    chunk_for, ssd_chunked, ssd_chunked_batched, ssd_ref,
)

torch.set_num_threads(2)
SAME = 2e-5
OTHER = 1e-4


def _inputs(T, H, P, N, seed=0, batch=None):
    """x, dt, A, B, C as JAX's sweep draws them (a leading batch if given)."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return (rng.standard_normal(lead + (T, H, P)).astype(np.float32),
            ((0.5 + rng.random(lead + (T, H))) * 0.1).astype(np.float32),
            (-1.0 - rng.random(H)).astype(np.float32),
            (rng.standard_normal(lead + (T, N)) * 0.5).astype(np.float32),
            (rng.standard_normal(lead + (T, N)) * 0.5).astype(np.float32))


def _t(arrs):
    return [torch.tensor(a) for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


SWEEP = [(128, 4, 32, 16, 32), (256, 2, 64, 32, 64), (64, 8, 16, 128, 64),
         (32, 1, 8, 8, 8)]


@pytest.mark.parametrize("T,H,P,N,chunk", SWEEP)
def test_ssd_ref_and_chunked_match_jax(T, H, P, N, chunk):
    arrs = _inputs(T, H, P, N)
    yr, sr = jax_ssd_ref(*arrs)
    yc, sc = ssd_chunked_jnp(*arrs, chunk=chunk)
    pr, ps = ssd_ref(*_t(arrs))
    pc, pcs = ssd_chunked(*_t(arrs), chunk=chunk)
    _close(pr, yr, SAME)
    _close(ps, sr, SAME)
    _close(pc, yc, SAME)
    _close(pcs, sc, SAME)
    _close(pc, yr, OTHER)  # chunked against step by step, as JAX checks its own


@pytest.mark.parametrize("T,H,P,N,chunk", SWEEP)
def test_cpu_path_matches_jax_pallas_kernel(T, H, P, N, chunk):
    """``ssd_scan`` on CPU tensors (the plain chunked form at JAX's chunk)
    against JAX's Pallas kernel, run in interpret mode at the sweep's
    chunk."""
    arrs = _inputs(T, H, P, N, seed=1)
    want = jax_ssd_scan(*map(jnp.asarray, arrs), chunk=chunk)
    x, dt, A, B, C = _t(arrs)
    got = ssd_scan(x[None], dt[None], A, B[None], C[None])[0]
    _close(got, want, OTHER)


def test_chunked_with_initial_state_matches_jax():
    arrs = _inputs(64, 2, 16, 8, seed=2)
    s0 = np.random.default_rng(3).standard_normal((2, 16, 8)).astype(np.float32)
    yr, sr = jax_ssd_ref(*arrs, init_state=jnp.asarray(s0))
    yc, sc = ssd_chunked_jnp(*arrs, chunk=16, init_state=jnp.asarray(s0))
    pr, ps = ssd_ref(*_t(arrs), init_state=torch.tensor(s0))
    pc, pcs = ssd_chunked(*_t(arrs), chunk=16, init_state=torch.tensor(s0))
    _close(pr, yr, SAME)
    _close(ps, sr, SAME)
    _close(pc, yc, SAME)
    _close(pcs, sc, SAME)


def test_batched_matches_per_sequence_loop():
    """The batched entry point is the per-sequence chunked scan, sequence by
    sequence (what jax.vmap does at the JAX model's models/ssm.py:73-76)."""
    x, dt, A, B, C = _t(_inputs(96, 4, 16, 8, seed=4, batch=3))
    got = ssd_chunked_batched(x, dt, A, B, C)
    for b in range(3):
        want, _ = ssd_chunked(x[b], dt[b], A, B[b], C[b], chunk=chunk_for(96))
        torch.testing.assert_close(got[b], want, rtol=SAME, atol=SAME)


@pytest.mark.parametrize("T", [100, 37, 1])
def test_ragged_T_matches_step_by_step(T):
    """T that 64 does not divide: JAX's chunk rule halves to a divisor (4 for
    100, 1 for 37 and 1)."""
    x, dt, A, B, C = _t(_inputs(T, 4, 32, 16, seed=5, batch=2))
    got = ssd_scan(x, dt, A, B, C)
    for b in range(2):
        want, _ = ssd_ref(x[b], dt[b], A, B[b], C[b])
        torch.testing.assert_close(got[b], want, rtol=OTHER, atol=OTHER)


def test_chunk_rule_is_jax_s():
    assert [chunk_for(T) for T in (2048, 8192, 96, 100, 37, 1)] == [64, 64, 32, 4, 1, 1]
    with pytest.raises(ValueError, match="does not divide"):
        ssd_chunked(*_t(_inputs(100, 1, 8, 8)), chunk=64)


def test_cpu_path_launches_nothing_and_refuses_grad():
    x, dt, A, B, C = _t(_inputs(64, 2, 16, 8, seed=6, batch=1))
    before = dict(build.LAUNCHES)
    y = ssd_scan(x, dt, A, B, C)
    assert build.LAUNCHES == before and y.shape == x.shape
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x.requires_grad_(), dt, A, B, C)
    with torch.no_grad():
        torch.testing.assert_close(ssd_scan(x, dt, A, B, C), y, rtol=0, atol=0)
