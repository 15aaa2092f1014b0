"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device
(a CUDA kernel has no CPU mode). The module imports torch and the port
only, so it runs on the card's machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.kge_score.ops import pairwise_kernel, pairwise_scores
from repro_torch.kernels.kge_score.ref import pairwise_ref
from repro_torch.kernels.sparse_adagrad.ops import dedup_aggregate, fused_sparse_adagrad
from repro_torch.kernels.sparse_adagrad.ref import dedup_aggregate_ref, fused_update_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    return torch.device("cuda")


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("mode", ["dot", "l2sq", "l1"])
@pytest.mark.parametrize("shape", [(1, 1024, 256, 400), (2, 1000, 250, 300),
                                   (3, 65, 129, 33), (1, 1, 1, 1)])
def test_pairwise_kernel_matches_plain(cuda, mode, shape):
    G, B, K, D = shape
    rng = _rng(0)
    o = torch.tensor(rng.standard_normal((G, B, D)), dtype=torch.float32, device=cuda)
    n = torch.tensor(rng.standard_normal((G, K, D)), dtype=torch.float32, device=cuda)
    before = build.LAUNCHES[f"pairwise_{mode}"]
    out = pairwise_kernel(mode, o, n)
    ref = pairwise_ref(mode, o, n)
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"pairwise_{mode}"] == before + 1
    # fp32 sums of D terms in another order: 2e-5 of the largest value
    tol = 2e-5 * max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol


@pytest.mark.parametrize("mode", ["dot", "l2sq"])
def test_pairwise_grads_on_card_match_plain(cuda, mode):
    rng = _rng(1)
    o = torch.tensor(rng.standard_normal((2, 64, 40)), dtype=torch.float32,
                     device=cuda, requires_grad=True)
    n = torch.tensor(rng.standard_normal((2, 48, 40)), dtype=torch.float32,
                     device=cuda, requires_grad=True)
    g = torch.tensor(rng.standard_normal((2, 64, 48)), dtype=torch.float32, device=cuda)
    do, dn = torch.autograd.grad((pairwise_scores(mode, o, n) * g).sum(), (o, n))
    ro, rn = torch.autograd.grad((pairwise_ref(mode, o, n) * g).sum(), (o, n))
    torch.testing.assert_close(do, ro, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(dn, rn, rtol=2e-4, atol=2e-4)


def test_l1_backward_on_card_is_not_ported(cuda):
    o = torch.ones(4, 3, device=cuda, requires_grad=True)
    out = pairwise_scores("l1", o, torch.zeros(5, 3, device=cuda))
    with pytest.raises(NotImplementedError, match="next slice"):
        out.sum().backward()


def _dups(rng, n, n_rows):
    ids = rng.integers(0, min(n_rows, max(1, n // 2)), size=n)
    ids[rng.random(n) < 0.15] = -1
    return ids.astype(np.int32)


@pytest.mark.parametrize("n,D", [(2560, 400), (1024, 400), (5000, 40), (7, 3)])
def test_dedup_kernel_matches_plain(cuda, n, D):
    rng = _rng(n)
    ids = torch.tensor(_dups(rng, n, 14951), device=cuda)
    g = torch.tensor(rng.standard_normal((n, D)), dtype=torch.float32, device=cuda)
    uid, agg = dedup_aggregate(ids, g)
    ru, ra = dedup_aggregate_ref(ids, g)
    torch.cuda.synchronize()
    assert torch.equal(uid, ru)
    torch.testing.assert_close(agg, ra, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [400, 1000])
def test_dedup_kernel_heavy_duplicates(cuda, D):
    """One id repeated in most slots (a popular relation): longer than the
    kernel's match list, and at D = 1000 wider than one pass of its lanes."""
    ids = torch.full((1024,), 7, dtype=torch.int32, device=cuda)
    ids[::3] = torch.arange(0, 1024, 3, dtype=torch.int32, device=cuda) + 100
    g = torch.randn(1024, D, device=cuda)
    uid, agg = dedup_aggregate(ids, g)
    ru, ra = dedup_aggregate_ref(ids, g)
    torch.cuda.synchronize()
    assert torch.equal(uid, ru)
    torch.testing.assert_close(agg, ra, rtol=1e-5, atol=1e-4)


def test_fused_update_kernel_matches_plain(cuda):
    rng = _rng(9)
    N, D, n = 14951, 400, 2560
    table = torch.tensor(rng.standard_normal((N, D)), dtype=torch.float32, device=cuda)
    gsq = torch.tensor(np.abs(rng.standard_normal((N, D))), dtype=torch.float32,
                       device=cuda)
    ids = rng.permutation(N)[:n]
    ids = torch.tensor(np.where(rng.random(n) < 0.2, -1, ids), dtype=torch.int32,
                       device=cuda)
    g = torch.tensor(rng.standard_normal((n, D)), dtype=torch.float32, device=cuda)
    kt, kq, pt, pq = table.clone(), gsq.clone(), table.clone(), gsq.clone()
    fused_sparse_adagrad(kt, kq, ids, g, 0.25)
    fused_update_ref(pt, pq, ids, g, 0.25)
    torch.cuda.synchronize()
    torch.testing.assert_close(kt, pt, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(kq, pq, rtol=1e-6, atol=1e-6)
    untouched = torch.ones(N, dtype=torch.bool, device=cuda)
    untouched[ids[ids >= 0].long()] = False
    assert torch.equal(kt[untouched], table[untouched])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    o = torch.zeros(4, 8, device=cuda)
    with pytest.raises(TypeError):
        pairwise_kernel("dot", o.double(), o.double())
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_kernel("dot", torch.zeros(8, 4, device=cuda).t(), o)
    with pytest.raises(ValueError, match="one CUDA device"):
        dedup_aggregate(torch.zeros(4, dtype=torch.int32, device=cuda), torch.zeros(4, 8))
