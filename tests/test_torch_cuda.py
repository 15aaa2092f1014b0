"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device
(a CUDA kernel has no CPU mode). The module imports torch and the port
only, so it runs on the card's machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.kge_score.ops import (
    l1_bwd_kernel, l1_bwd_pair_plan, l1_bwd_plan, pairwise_kernel, pairwise_l1_plan,
    pairwise_scores,
)
from repro_torch.kernels.kge_score.ref import l1_grads_ref, pairwise_ref
from repro_torch.kernels.rescal_proj.ops import rescal_proj_grads_kernel, rescal_proj_kernel
from repro_torch.kernels.rescal_proj.ref import rescal_proj_grads_ref, rescal_proj_ref
from repro_torch.kernels.sparse_adagrad.ops import dedup_aggregate, fused_sparse_adagrad
from repro_torch.kernels.sparse_adagrad.ref import dedup_aggregate_ref, fused_update_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_batched, ssd_ref

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


@pytest.mark.parametrize("mode", ["dot", "l2sq", "l1"])
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


@pytest.mark.parametrize("shape", [(1, 1024, 256, 400), (2, 1000, 250, 300),
                                   (3, 65, 129, 33), (1, 256, 1024, 400),
                                   (1, 1, 1, 1)])
def test_l1_bwd_kernel_matches_plain(cuda, shape):
    """Both products, at the training path's shape, ragged ones and one with
    B and K swapped (so both tile shapes run with w read both ways)."""
    G, B, K, D = shape
    rng = _rng(2)
    o = torch.tensor(rng.standard_normal((G, B, D)), dtype=torch.float32, device=cuda)
    n = torch.tensor(rng.standard_normal((G, K, D)), dtype=torch.float32, device=cuda)
    g = torch.tensor(rng.standard_normal((G, B, K)), dtype=torch.float32, device=cuda)
    before = dict(build.LAUNCHES)
    do, dn = l1_bwd_kernel(o, n, g)
    ro, rn = l1_grads_ref(o, n, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES["l1_bwd_do"] == before["l1_bwd_do"] + 1
    assert build.LAUNCHES["l1_bwd_dn"] == before["l1_bwd_dn"] + 1
    for got, want in ((do, ro), (dn, rn)):
        assert got.shape == want.shape
        # fp32 sums of B or K terms in another order: 2e-5 of the largest value
        tol = 2e-5 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol


def test_l1_bwd_kernel_ties_and_requested_grads(cuda):
    """Exact ties give sign 0; only the asked-for product is launched; an
    expanded (stride-0) cotangent from a sum goes through."""
    rng = _rng(3)
    o = torch.tensor(rng.integers(-2, 3, (2, 40, 24)), dtype=torch.float32, device=cuda)
    n = torch.tensor(rng.integers(-2, 3, (2, 30, 24)), dtype=torch.float32, device=cuda)
    n[:, :10] = o[:, :10]
    g = torch.tensor(rng.standard_normal((2, 40, 30)), dtype=torch.float32, device=cuda)
    ro, rn = l1_grads_ref(o, n, g)
    before = dict(build.LAUNCHES)
    do, dn = l1_bwd_kernel(o, n, g, need_dn=False)
    assert dn is None and build.LAUNCHES["l1_bwd_dn"] == before["l1_bwd_dn"]
    torch.testing.assert_close(do, ro, rtol=1e-5, atol=1e-5)
    o.requires_grad_()
    pairwise_scores("l1", o, n).sum().backward()  # g = ones, expanded
    want, _ = l1_grads_ref(o.detach(), n, torch.ones_like(g))
    torch.testing.assert_close(o.grad, want, rtol=1e-5, atol=1e-5)


# reduction lengths around the kernel's slices: a chunk is 32 long and a
# split at most 8 chunks, so 256 is where the widest split's slices reach a
# whole chunk each
L1_SPLIT_LENGTHS = [1, 7, 255, 256, 257, 1023, 1025, 4096]


@pytest.mark.parametrize("scale", [1, 8])
@pytest.mark.parametrize("D", [33, 401])
@pytest.mark.parametrize("product", ["d_o", "d_n"])
@pytest.mark.parametrize("C", L1_SPLIT_LENGTHS)
def test_l1_bwd_kernel_split_edges_and_determinism(cuda, C, product, D, scale):
    """Both products, from the pair launch and each alone, with the
    reduction of one of them ``C`` long (K for d_o, B for d_n; the other
    100), ragged D, three groups, ties (half of n's rows copies of rows of
    o, and +-0 entries on both sides), against the plain version at the
    gate; two calls give the same bits. At D 33 the output is six tiles, so
    the lengths about 8 chunks long run at the widest split (8 blocks, a
    slice of one chunk or two each), alone and in the pair's split of K."""
    G, other = 3, 100
    B, K = (other, C) if product == "d_o" else (C, other)
    if D == 33 and C in (255, 256, 257):
        R = B if product == "d_o" else K  # the rows of the C-long product
        assert l1_bwd_plan(G, R, C, D, product == "d_n")[1] == 8
        if product == "d_o":
            assert l1_bwd_pair_plan(G, B, K, D) == 8
    rng = _rng(24)
    o = scale * rng.standard_normal((G, B, D))
    n = scale * rng.standard_normal((G, K, D))
    n[:, : (K + 1) // 2] = o[:, rng.integers(0, B, (K + 1) // 2)]
    for a in (o, n):
        a[rng.random(a.shape) < 0.05] = 0.0
        a[rng.random(a.shape) < 0.05] = -0.0
    o, n = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in (o, n))
    g = torch.tensor(scale * rng.standard_normal((G, B, K)), dtype=torch.float32,
                     device=cuda)
    want = l1_grads_ref(o, n, g)
    for need in ({}, dict(need_dn=False), dict(need_do=False)):
        got = l1_bwd_kernel(o, n, g, **need)
        again = l1_bwd_kernel(o, n, g, **need)
        torch.cuda.synchronize()
        for a, a2, b in zip(got, again, want):
            if a is None:
                continue
            assert a.shape == b.shape
            assert torch.equal(a, a2)
            # fp32 sums of B or K terms in another order: 2e-5 of the largest value
            tol = 2e-5 * max(1.0, float(b.abs().max()))
            assert float((a - b).abs().max()) <= tol


# (name, G, B, K, D, scale): the l1 forward around its chunks of 32 (64 x
# 64 tiles) and 64 columns (32 x 32 tiles) (D 1, 3, 33, 65, 400, 401), B and
# K on both sides of each tile edge the plan can pick, protocol 2's grouped
# form, and large inputs
L1_FWD_CASES = [
    *[(f"d{D}", 2, 65, 129, D, 1) for D in (1, 3, 33, 65, 400, 401)],
    *[(f"b{v}", 2, v, 65, 40, 1) for v in (1, 31, 33, 63, 65, 129)],
    *[(f"k{v}", 2, 65, v, 40, 1) for v in (1, 31, 33, 63, 65, 129)],
    ("grouped_64x1x2000", 64, 1, 2000, 400, 1),
    ("x8", 1, 100, 300, 400, 8),
    ("x1e3", 1, 100, 300, 400, 1e3),
]


def _l1_fwd_inputs(cuda, G, B, K, D, scale, seed):
    """o and negs with ties: the first half of the negatives are copies of
    rows of o, and 5% of the entries of each are +0 or -0 (before the copy,
    so a copied row is identical). Returns (o, n, rows of o copied)."""
    rng = _rng(seed)
    o = scale * rng.standard_normal((G, B, D))
    n = scale * rng.standard_normal((G, K, D))
    for a in (o, n):
        a[rng.random(a.shape) < 0.05] = 0.0
        a[rng.random(a.shape) < 0.05] = -0.0
    copied = rng.integers(0, B, (K + 1) // 2)
    n[:, : (K + 1) // 2] = o[:, copied]
    o, n = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in (o, n))
    return o, n, copied


@pytest.mark.parametrize("case", L1_FWD_CASES, ids=lambda c: c[0])
def test_pairwise_l1_kernel_edges_and_determinism(cuda, case):
    """The l1 forward against the plain version at the gate; a negative
    equal to a row of o scores exactly 0; two calls give the same bits."""
    _, G, B, K, D, scale = case
    o, n, copied = _l1_fwd_inputs(cuda, G, B, K, D, scale, 26)
    before = build.LAUNCHES["pairwise_l1"]
    out = pairwise_kernel("l1", o, n)
    again = pairwise_kernel("l1", o, n)
    ref = pairwise_ref("l1", o, n)
    torch.cuda.synchronize()
    assert build.LAUNCHES["pairwise_l1"] == before + 2
    assert out.shape == ref.shape
    assert torch.equal(out, again)
    ties = out[:, torch.as_tensor(copied, device=cuda), torch.arange(len(copied), device=cuda)]
    assert torch.equal(ties, torch.zeros_like(ties))
    # fp32 sums of D terms in another order: 2e-5 of the largest value
    tol = 2e-5 * max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol


def test_pairwise_l1_kernel_unaligned_and_non_finite(cuda):
    """Operands 4 bytes off a 16-byte boundary (the kernel's 4-byte copies
    at D = 400), and rows holding a NaN, +inf and -inf: NaN and inf land
    where the plain version puts them (inf - inf is NaN), the rest within
    the gate."""
    G, B, K, D = 1, 70, 90, 400
    rng = _rng(27)
    bo = torch.tensor(rng.standard_normal(B * D + 1), dtype=torch.float32, device=cuda)
    bn = torch.tensor(rng.standard_normal(K * D + 1), dtype=torch.float32, device=cuda)
    o, n = bo[1:].view(B, D), bn[1:].view(K, D)
    assert o.data_ptr() % 16 == 4 and n.data_ptr() % 16 == 4
    o[3, 5] = float("nan")
    o[4, 0] = float("-inf")
    o[6, 0] = float("inf")
    n[2, 0] = float("inf")
    out = pairwise_kernel("l1", o, n)
    ref = pairwise_ref("l1", o, n)
    torch.cuda.synchronize()
    assert torch.equal(out.isnan(), ref.isnan()) and bool(ref.isnan().any())
    assert torch.equal(out.isinf(), ref.isinf()) and bool(ref.isinf().any())
    assert torch.equal(out[ref.isinf()], ref[ref.isinf()])
    fin = ref.isfinite()
    tol = 2e-5 * max(1.0, float(ref[fin].abs().max()))
    assert float((out[fin] - ref[fin]).abs().max()) <= tol


def _launch_shape(cuda, tmp_path, fn, name):
    """(template arguments, grid) of the launch of kernel ``name`` that
    ``fn`` makes, from a torch.profiler trace (a trace now and then holds no
    device event: taken again, up to three times)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        trace = tmp_path / f"trace{attempt}.json"
        prof.export_chrome_trace(str(trace))
        kern = [e for e in json.loads(trace.read_text())["traceEvents"]
                if e.get("cat") == "kernel" and name in e.get("name", "")]
        if kern:
            assert len(kern) == 1
            targs = tuple(int(x) for x in re.search(name + r"<([^>]*)>", kern[0]["name"])
                          .group(1).split(","))
            return targs, tuple(kern[0]["args"]["grid"])
    raise AssertionError(f"no {name} launch in three traces")


@pytest.mark.parametrize("shape", [(1, 1024, 256, 400), (2, 1000, 250, 300),
                                   (1, 512, 14951, 400)],
                         ids=["path", "ragged", "eval"])
def test_pairwise_l1_launch_takes_its_plan(cuda, tmp_path, shape):
    """At the training path's, a ragged and eval's shapes the launch runs
    the tile that pairwise_l1_plan reports: the kernel's micro-tile (MR x MC
    sums a thread, 8 x 16 threads, so 8 MR rows of o and 16 MC negatives a
    tile, as many as rows) and its grid, one block a tile."""
    G, B, K, D = shape
    o = torch.randn(G, B, D, device=cuda)
    n = torch.randn(G, K, D, device=cuda)
    rows = pairwise_l1_plan(G, B, K, D)
    (mr, mc, _, vec), grid = _launch_shape(cuda, tmp_path,
                                           lambda: pairwise_kernel("l1", o, n),
                                           "pairwise_l1_kernel")
    assert (8 * mr, 16 * mc, vec) == (rows, rows, 4)
    assert grid == (-(-K // rows), -(-B // rows), G)


def test_eval_ranks_on_card_match_cpu(cuda):
    """Filtered protocol-1 ranks through the pairwise kernel on the card and
    through the plain version on the CPU, from the same tables."""
    from repro_torch.common.config import KGEConfig
    from repro_torch.core import eval as E
    from repro_torch.core import kge_model as K
    from repro_torch.data.kg_synth import make_synthetic_kg

    kg = make_synthetic_kg(n_entities=500, n_relations=10, n_edges=5000,
                           n_clusters=4, seed=0)
    cfg = KGEConfig(model="transe_l1", n_entities=500, n_relations=10, dim=64)
    cpu = K.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = K.state_from_arrays(cfg, K.state_to_arrays(cpu), device=cuda)
    fm = E.build_filter_map(kg.triplets)
    before = build.LAUNCHES["pairwise_l1"]
    got = E.ranks_against_all(cfg, card, kg.test[:100], filter_map=fm)
    want = E.ranks_against_all(cfg, cpu, kg.test[:100], filter_map=fm, chunk=32)
    assert build.LAUNCHES["pairwise_l1"] == before + 2
    assert (got == want).mean() >= 0.99


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


def _group(rng, n, size, other=None):
    """n slots, `size` of them (at random places) holding one id, the rest
    `other` or unique ids."""
    ids = rng.permutation(n) + 1000 if other is None else other.copy()
    ids[rng.permutation(n)[:size]] = 7
    return ids


def _dedup_cases():
    """(name, ids) for the kernel's routes and edges: groups on each side of
    the sizes where the slice shape changes (4, 12, 36, 72) and of the 144
    slots a warp lists, and far past it; one id everywhere, ids near
    2^31 - 1, ids equal in their low 12 bits, pads of any sign."""
    rng = _rng(21)
    near_max = 2**31 - 1 - rng.permutation(300)
    return [
        ("relation_skew_140", _group(rng, 1024, 140)),
        ("zipf_2560", _group(rng, 2560, 50, rng.zipf(1.5, 2560) % 14951)),
        ("group_12", _group(rng, 1024, 12)),
        ("group_288", _group(rng, 1024, 288)),
        ("group_289", _group(rng, 1024, 289)),
        ("one_id_2560", np.full(2560, 3)),
        ("all_unique", rng.permutation(14951)[:2560]),
        ("all_pads", np.full(2560, -1)),
        ("near_max", rng.permutation(np.concatenate([np.repeat(near_max, 3),
                                                     np.full(124, 2**31 - 1)]))),
        ("negative_pads", np.where(rng.random(777) < 0.5, -7, rng.integers(0, 50, 777))),
        # one low-bit pattern: ids that collide in any hash by id mod 2^k,
        # k <= 12 (a table of the workspace's size), some of them repeated
        ("same_low_bits", 7 + 4096 * rng.integers(0, 2**18, 2560)[rng.integers(0, 1200, 2560)]),
        ("group_4", _group(rng, 1024, 4)),
        ("group_5", _group(rng, 1024, 5)),
        ("group_13", _group(rng, 1024, 13)),
        ("group_36", _group(rng, 1024, 36)),
        ("group_37", _group(rng, 1024, 37)),
        ("group_72", _group(rng, 1024, 72)),
        ("group_73", _group(rng, 1024, 73)),
        ("group_144", _group(rng, 2560, 144)),
        ("group_145", _group(rng, 2560, 145)),
    ]


@pytest.mark.parametrize("D", [400, 500])
@pytest.mark.parametrize("case", _dedup_cases(), ids=lambda c: c[0])
def test_dedup_kernel_edges_and_determinism(cuda, case, D):
    """Skewed, degenerate and extreme ids, at the path's D and at one past
    the 416 columns of the widest slice; two calls give the same bits."""
    name, ids = case
    n = len(ids)
    rng = _rng(22)
    ids = torch.tensor(ids.astype(np.int32), device=cuda)
    g = torch.tensor(rng.standard_normal((n, D)), dtype=torch.float32, device=cuda)
    before = build.LAUNCHES["dedup_aggregate"]
    uid, agg = dedup_aggregate(ids, g)
    uid2, agg2 = dedup_aggregate(ids, g)
    ru, ra = dedup_aggregate_ref(ids, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES["dedup_aggregate"] == before + 2
    assert torch.equal(uid, ru)
    assert torch.equal(uid, uid2) and torch.equal(agg, agg2)
    # fp32 sums of the same rows in another order: 2e-5 of the largest value
    tol = 2e-5 * max(1.0, float(ra.abs().max()))
    assert float((agg - ra).abs().max()) <= tol


def test_dedup_kernel_past_the_warp_route(cuda):
    """A workspace past the ids one block stages (the naive sampler's) goes
    through the scan route, with the same layout."""
    rng = _rng(23)
    n = 13000
    ids = torch.tensor(_dups(rng, n, 14951), device=cuda)
    g = torch.tensor(rng.standard_normal((n, 16)), dtype=torch.float32, device=cuda)
    uid, agg = dedup_aggregate(ids, g)
    ru, ra = dedup_aggregate_ref(ids, g)
    torch.cuda.synchronize()
    assert torch.equal(uid, ru)
    torch.testing.assert_close(agg, ra, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["dot", "l2sq"])
@pytest.mark.parametrize("shape", [(1, 100, 70, 37), (2, 33, 65, 36), (4, 64, 96, 400),
                                   (3, 31, 33, 12), (1, 1024, 256, 5)])
def test_pairwise_mma_kernel_shapes(cuda, mode, shape):
    """The tensor-core core at D not a multiple of 8 (4-byte copies when D is
    not a multiple of 4), G > 1, and B and K off the 32 x 32 tile."""
    G, B, K, D = shape
    rng = _rng(24)
    o = torch.tensor(rng.standard_normal((G, B, D)), dtype=torch.float32, device=cuda)
    n = torch.tensor(rng.standard_normal((G, K, D)), dtype=torch.float32, device=cuda)
    out = pairwise_kernel(mode, o, n)
    ref = pairwise_ref(mode, o, n)
    torch.cuda.synchronize()
    tol = 2e-5 * max(1.0, float(ref.abs().max()))
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= tol


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest), as float64."""
    b = x.astype(np.float32).view(np.int32).astype(np.int64)
    return ((b + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32).astype(np.float64)


@pytest.mark.parametrize("mode", ["dot", "l2sq"])
def test_pairwise_mma_kernel_keeps_fp32_at_large_magnitude(cuda, mode):
    """Operands of ~1e3: one TF32 product a pair would miss the 2e-5 gate
    (shown here on the same inputs), so the kernel passes only with the lo
    terms of its 3xTF32 split."""
    rng = _rng(25)
    o = 1e3 * rng.standard_normal((1, 256, 400))
    n = 1e3 * rng.standard_normal((1, 128, 400))
    to = torch.tensor(o, dtype=torch.float32, device=cuda)
    tn = torch.tensor(n, dtype=torch.float32, device=cuda)
    out = pairwise_kernel(mode, to, tn)
    ref = pairwise_ref(mode, to, tn)
    torch.cuda.synchronize()
    want = ref.double().cpu().numpy()
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    o32, n32 = o.astype(np.float32).astype(np.float64), n.astype(np.float32).astype(np.float64)
    one = _tf32(o32) @ _tf32(n32).transpose(0, 2, 1)
    if mode == "l2sq":
        one = (o32 ** 2).sum(-1)[..., None] - 2 * one + (n32 ** 2).sum(-1)[:, None, :]
    assert np.abs(one - want).max() > tol  # the gate sees a dropped lo term
    assert float((out - ref).abs().max()) <= tol


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


# (case, n_rows, D, n): the vector path at D = 400 and at RESCAL/TransR's
# 160,000-wide projection rows (79 column tiles a row); the scalar path at
# an odd D (401; 3, under one float4) and at a table one float past a
# 16-byte boundary; all pads; ids past the table beside valid ones
UPDATE_CASES = [
    ("d400", 2000, 400, 512),
    ("d401", 2000, 401, 512),
    ("d3", 2000, 3, 512),
    ("d160000", 64, 160000, 48),
    ("off_16_bytes", 2000, 400, 512),
    ("all_pads", 2000, 400, 512),
    ("past_the_table", 2000, 400, 512),
]


@pytest.mark.parametrize("case,n_rows,D,n", UPDATE_CASES)
def test_fused_update_kernel_paths_bit_equal(cuda, case, n_rows, D, n):
    """Every path of the kernel gives the plain version's bits (the same
    ``_rn`` operations in the same order) and leaves other rows alone."""
    rng = _rng(10)
    table = torch.tensor(rng.standard_normal((n_rows, D)), dtype=torch.float32,
                         device=cuda)
    gsq = torch.tensor(np.abs(rng.standard_normal((n_rows, D))), dtype=torch.float32,
                       device=cuda)
    ids = np.where(rng.random(n) < 0.2, -1, rng.permutation(n_rows)[:n])
    if case == "all_pads":
        ids[:] = -1
    if case == "past_the_table":  # dropped, like JAX's mode="drop" scatter
        ids[rng.random(n) < 0.3] = n_rows + rng.integers(0, 1000)
    ids = torch.tensor(ids, dtype=torch.int32, device=cuda)
    g = torch.tensor(rng.standard_normal((n, D)), dtype=torch.float32, device=cuda)
    kt, kq, pt, pq = table.clone(), gsq.clone(), table.clone(), gsq.clone()
    if case == "off_16_bytes":
        kt = torch.empty(n_rows * D + 1, device=cuda)[1:].view(n_rows, D).copy_(table)
        assert kt.data_ptr() % 16 and kt.is_contiguous()
    fused_sparse_adagrad(kt, kq, ids, g, 0.25)
    fused_update_ref(pt, pq, ids, g, 0.25)
    torch.cuda.synchronize()
    assert torch.equal(kt, pt) and torch.equal(kq, pq)
    untouched = torch.ones(n_rows, dtype=torch.bool, device=cuda)
    untouched[ids[(ids >= 0) & (ids < n_rows)].long()] = False
    assert torch.equal(kt[untouched], table[untouched])
    assert torch.equal(kq[untouched], gsq[untouched])
    if case == "all_pads":
        assert torch.equal(kt, table) and torch.equal(kq, gsq)


# (b, d, rel_dim): RESCAL's FB15k cell; float4 rows with d % 4 != 0; one
# float a lane (rel_dim % 4 != 0) with more column tiles than warps; float4
# rows of more tiles than warps; fewer rows than a cluster has blocks
RESCAL_PROJ_CASES = [(1024, 500, 500), (64, 203, 300), (33, 130, 257),
                     (3, 7, 1100), (4, 5, 12)]


@pytest.mark.parametrize("shape", RESCAL_PROJ_CASES, ids=lambda c: "x".join(map(str, c)))
def test_rescal_proj_kernels_match_plain(cuda, shape):
    """Both launches against the plain einsums: the sums of d or rel_dim
    terms within 2e-5 of the largest value, dm bit for bit (the same _rn
    products and sum), two calls the same bits, one launch each."""
    b, d, r = shape
    rng = _rng(11)

    def draw(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=cuda)

    m, h, t, dph, dpt = draw(b, d * r), draw(b, d), draw(b, r), draw(b, r), draw(b, d)
    before = dict(build.LAUNCHES)
    got = rescal_proj_kernel(m, h, t) + rescal_proj_grads_kernel(m, h, t, dph, dpt)
    again = rescal_proj_kernel(m, h, t) + rescal_proj_grads_kernel(m, h, t, dph, dpt)
    want = rescal_proj_ref(m, h, t) + rescal_proj_grads_ref(m, h, t, dph, dpt)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rescal_proj_fwd"] == before["rescal_proj_fwd"] + 2
    assert build.LAUNCHES["rescal_proj_bwd"] == before["rescal_proj_bwd"] + 2
    for name, g, a, w in zip(("ph", "pt", "dh", "dt", "dm"), got, again, want):
        assert torch.equal(g, a), name
        tol = 2e-5 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol, name
    assert torch.equal(got[4], want[4])


def test_rescal_proj_refuses_what_the_kernels_do_not_take(cuda):
    m, h, t = torch.zeros(4, 30, device=cuda), torch.zeros(4, 5, device=cuda), \
        torch.zeros(4, 6, device=cuda)
    with pytest.raises(ValueError, match="takes m"):
        rescal_proj_kernel(m, h, torch.zeros(4, 7, device=cuda))
    with pytest.raises(ValueError, match="one CUDA device"):
        rescal_proj_kernel(m, h, t.cpu())
    with pytest.raises(TypeError):
        rescal_proj_kernel(m.double(), h.double(), t.double())
    with pytest.raises(ValueError, match="contiguous"):
        rescal_proj_grads_kernel(m, h, t, torch.zeros(6, 4, device=cuda).t(), h)


def test_rescal_train_step_on_card_matches_cpu(cuda):
    """Three RESCAL train steps on the card and on the CPU from the same
    tables and batches: one forward and one backward launch a step, the
    losses within 1e-5 and the tables under the Adagrad-flip rule."""
    from repro_torch.core import kge_model as K
    from repro_torch.core.sampling import JointSampler

    cfg, kg = _hogwild_setup("rescal")
    # chip_smoke.py phase 4's lr: at higher ones two CPU runs that differ only
    # in the rounding of the dedup sums already part past the rule
    cfg = dataclasses.replace(cfg, lr=0.05)
    sampler = JointSampler(kg.train, cfg.n_entities, cfg, np.random.default_rng(0))
    batches = [sampler.sample() for _ in range(3)]
    card = K.init_state(cfg, torch.Generator().manual_seed(0), overlap=True, device=cuda)
    cpu = K.init_state(cfg, torch.Generator().manual_seed(0), overlap=True, device="cpu")
    build.reset_launches()
    lc, lp = [], []
    for batch in batches:
        card, mc = K.train_step(cfg, card, K.batch_to_device(batch, cuda))
        cpu, mp = K.train_step(cfg, cpu, K.batch_to_device(batch, "cpu"))
        lc.append(float(mc["loss"]))
        lp.append(float(mp["loss"]))
    torch.cuda.synchronize()
    assert build.LAUNCHES["rescal_proj_fwd"] == build.LAUNCHES["rescal_proj_bwd"] == 3
    np.testing.assert_allclose(lc, lp, rtol=1e-5, atol=1e-5)
    K.flush_state(cfg, card)
    K.flush_state(cfg, cpu)
    for name in ("entity", "ent_gsq", "r_proj", "proj_gsq"):
        got, want = getattr(card, name).cpu().numpy(), getattr(cpu, name).numpy()
        diff = np.abs(got - want)
        assert (diff > 1e-5 + 1e-5 * np.abs(want)).mean() <= 1e-3, name
        assert diff.max() <= 2 * cfg.lr * len(batches), name


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    o = torch.zeros(4, 8, device=cuda)
    with pytest.raises(TypeError):
        pairwise_kernel("dot", o.double(), o.double())
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_kernel("dot", torch.zeros(8, 4, device=cuda).t(), o)
    g = torch.zeros(4, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        l1_bwd_kernel(o, o, torch.zeros(4, 1, device=cuda).expand(4, 4))
    with pytest.raises(ValueError, match="does not match"):
        l1_bwd_kernel(o, o, torch.zeros(4, 3, device=cuda))
    with pytest.raises(ValueError, match="one CUDA device"):
        l1_bwd_kernel(o, o, g.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        dedup_aggregate(torch.zeros(4, dtype=torch.int32, device=cuda), torch.zeros(4, 8))


# (B, H, Hkv, T, S, dh, window, q_offset, causal): phase 3's small shapes
# (ragged; decode-like T = 1 with q_offset), every head dim the kernel
# instantiates, GQA with a window, keys not causal, and rows with no valid
# key (q_offset past S with a window)
FLASH_CASES = [
    (2, 4, 2, 100, 100, 64, 0, 0, True),
    (1, 4, 2, 1, 512, 64, 0, 511, True),
    (2, 4, 1, 256, 256, 32, 64, 0, True),
    (1, 8, 2, 200, 200, 80, 96, 0, True),
    (1, 2, 2, 130, 130, 128, 0, 0, True),
    (1, 8, 8, 64, 256, 32, 0, 192, True),
    (2, 4, 2, 70, 150, 64, 0, 0, False),
    (1, 2, 1, 40, 8, 64, 4, 20, True),
]


# The bf16 tensor-core kernel's edges, (..., causal, scale): T and S one
# below, at and above its 64-row and 64-key tiles (63, 64, 65, 127, 129);
# every head dim; GQA groups 1, 4 and 8; windows whose edge crosses a key
# tile; q_offset past every key (the output is 0) and past some; inputs
# scaled by 8, so that later keys raise the running max and rescale
FLASH_EDGE_CASES = [
    (1, 4, 4, 63, 63, 64, 0, 0, True, 1),
    (1, 4, 4, 64, 64, 64, 0, 0, True, 1),
    (1, 4, 4, 65, 65, 64, 0, 0, True, 1),
    (1, 4, 4, 127, 127, 64, 0, 0, True, 1),
    (1, 4, 4, 129, 129, 64, 0, 0, True, 1),
    (1, 4, 1, 63, 129, 64, 0, 0, False, 1),
    (1, 8, 1, 129, 65, 64, 0, 0, False, 1),
    (2, 4, 1, 129, 129, 32, 0, 0, True, 1),
    (1, 4, 1, 65, 127, 80, 0, 0, False, 1),
    (1, 8, 1, 127, 127, 80, 0, 0, True, 1),
    (1, 2, 2, 127, 129, 128, 0, 2, True, 1),
    (1, 4, 2, 200, 200, 64, 70, 0, True, 1),
    (1, 8, 2, 129, 193, 80, 100, 64, True, 1),
    (1, 4, 2, 65, 64, 64, 16, 200, True, 1),
    (1, 4, 2, 129, 64, 32, 8, 60, True, 1),
    (2, 4, 2, 129, 129, 64, 0, 0, True, 8),
    (1, 4, 1, 127, 129, 128, 0, 0, False, 8),
]


def _check_flash(cuda, B, H, Hkv, T, S, dh, win, qoff, causal, dtype, scale=1):
    rng = _rng(11)
    q, k, v = (torch.tensor(scale * rng.standard_normal(s), dtype=dtype, device=cuda)
               for s in ((B, H, T, dh), (B, Hkv, S, dh), (B, Hkv, S, dh)))
    before = build.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, causal=causal, window=win, q_offset=qoff)
    ref = mha_ref(q, k, v, causal=causal, window=win, q_offset=qoff)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    got, want = out.float(), ref.float()
    # f32: sums in another order; bf16: the two f32 results may round to
    # neighbouring bf16 values (one rounding, 2^-7 of the value)
    tol = 2e-5 * max(1.0, float(want.abs().max()))
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.abs()
    assert bool(((got - want).abs() <= tol).all())
    assert bool(torch.isfinite(got).all())
    if qoff >= S + win and win:  # no row sees a key
        assert bool((got == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    _check_flash(cuda, *case, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_EDGE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_kernel_edges(cuda, case, dtype):
    *shape, scale = case
    _check_flash(cuda, *shape, dtype, scale=scale)


def _mha_f64(q, k, v, causal, window, q_offset):
    """mha_ref's function evaluated in float64 (mha_ref computes in f32)."""
    B, H, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    kk, vv = (t.double().repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    qpos = torch.arange(T, device=q.device)[:, None] + q_offset
    kpos = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones(T, S, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    s = torch.where(ok, q.double() @ kk.transpose(-1, -2) * dh ** -0.5, -1e300)
    p = torch.where(ok, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    return (p @ vv) / p.sum(-1, keepdim=True).clamp_min(1e-300)


# f32 inputs that stress the 3xTF32 split of flash_kernel_f32, (B, H, Hkv,
# T, S, dh, window, q_offset, kind), every head dim: "big", q, k and v of
# magnitude 8 (scores up to ~250 at the kernel's scale dh^-0.5); "cancel",
# v's rows +-(1 + 1e-3 noise), one sign a row, so |o| is far below |v|;
# "edge", windows whose edge falls inside a 64-key tile
FLASH_SPLIT_CASES = [
    (1, 4, 2, 200, 200, 32, 0, 0, "big"),
    (1, 4, 2, 200, 200, 64, 0, 0, "big"),
    (1, 4, 2, 200, 200, 80, 0, 0, "big"),
    (1, 4, 2, 200, 200, 128, 0, 0, "big"),
    (1, 4, 2, 257, 257, 32, 0, 0, "cancel"),
    (1, 4, 2, 257, 257, 64, 0, 0, "cancel"),
    (1, 4, 2, 257, 257, 80, 0, 0, "cancel"),
    (1, 4, 2, 257, 257, 128, 0, 0, "cancel"),
    (1, 4, 1, 300, 300, 64, 37, 0, "edge"),
    (2, 4, 2, 130, 200, 80, 45, 70, "edge"),
    (1, 2, 2, 100, 100, 128, 90, 0, "edge"),
]


@pytest.mark.parametrize("case", FLASH_SPLIT_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_f32_split(cuda, case):
    """The f32 kernel within 2e-5 x max(1, max|plain|) of the plain version,
    and no farther from the float64 value of the function than the plain
    version is plus that gate."""
    *shape, kind = case
    B, H, Hkv, T, S, dh, win, qoff = shape
    rng = _rng(18)
    q, k, v = (rng.standard_normal(s) for s in ((B, H, T, dh), (B, Hkv, S, dh),
                                                 (B, Hkv, S, dh)))
    if kind == "big":
        q, k, v = 8 * q, 8 * k, 8 * v
    elif kind == "cancel":
        v = np.where(rng.random((B, Hkv, S, 1)) < 0.5, -1.0, 1.0) * (1 + 1e-3 * v)
    q, k, v = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in (q, k, v))
    out = flash_attention(q, k, v, causal=True, window=win, q_offset=qoff)
    plain = mha_ref(q, k, v, causal=True, window=win, q_offset=qoff)
    exact = _mha_f64(q, k, v, True, win, qoff)
    torch.cuda.synchronize()
    gate = 2e-5 * max(1.0, float(plain.abs().max()))
    err = float((out - plain).abs().max())
    err_exact = float((out.double() - exact).abs().max())
    plain_exact = float((plain.double() - exact).abs().max())
    print(f"{case}: kernel vs plain {err / gate:.3f} of the gate; vs float64 "
          f"{err_exact / gate:.3f}, plain vs float64 {plain_exact / gate:.3f}")
    assert bool(torch.isfinite(out).all())
    assert err <= gate
    assert err_exact <= plain_exact + gate


def test_flash_attention_takes_a_view_off_16_bytes(cuda):
    """A contiguous bf16 view that starts 2 bytes into its storage is copied
    to an aligned one before the launch."""
    base = torch.randn(1 + 2 * 4 * 70 * 64, device=cuda).to(torch.bfloat16)
    q = base[1:].view(2, 4, 70, 64)
    out = flash_attention(q, q, q)
    ref = mha_ref(q, q, q)
    tol = 2e-5 * max(1.0, float(ref.float().abs().max())) + 2.0 ** -7 * ref.float().abs()
    assert bool(((out.float() - ref.float()).abs() <= tol).all())


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 4, 8, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, q.cpu(), q)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "h2o-danube-1.8b"])
def test_flash_prefill_on_card_matches_cpu(cuda, arch):
    """A reduced model's flash prefill through the kernel on the card and
    through the plain version on the CPU, from the same weights, in f32
    (the 2e-3 bound of tests/test_flash_serving.py); one launch a layer."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models.layers import tree_map
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="float32", window=48)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.tensor(_rng(12).integers(0, cfg.vocab_size, (2, 96)))
    prefill = build_prefill_step(model, use_flash=True)
    before = build.LAUNCHES["flash_attention"]
    got = prefill(tree_map(lambda t: t.to(cuda), params), {"tokens": tok.to(cuda)})
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), prefill(params, {"tokens": tok}),
                               rtol=2e-3, atol=2e-3)


def test_mla_prefill_and_decode_on_card_match_cpu(cuda):
    """The reduced MiniCPM3 (MLA) in f32: its prefill (``use_flash=True``,
    which MLA ignores, as JAX's does) and five teacher-forced absorbed
    decode steps on the card against the CPU from the same weights, within
    2e-5 x max(1, max|logit|); no kernel launches."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models.layers import tree_map
    from repro_torch.models.steps import build_prefill_step, build_serve_step
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(ARCHS["minicpm3-4b"].reduced(), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), params)
    tok = torch.tensor(_rng(14).integers(0, cfg.vocab_size, (2, 96)))
    prefill, serve = build_prefill_step(model, use_flash=True), build_serve_step(model)
    build.reset_launches()
    got = [prefill(card, {"tokens": tok.to(cuda)})]
    caches = model.init_caches(2, 5, device=cuda)
    for i in range(5):
        got.append(serve(card, caches, tok[:, i:i + 1].to(cuda), i)[0])
    torch.cuda.synchronize()
    assert sum(build.LAUNCHES.values()) == 0
    want = [prefill(params, {"tokens": tok})]
    caches = model.init_caches(2, 5)
    for i in range(5):
        want.append(serve(params, caches, tok[:, i:i + 1], i)[0])
    for g, w in zip(got, want):
        tol = 2e-5 * max(1.0, float(w.abs().max()))
        assert float((g.cpu() - w).abs().max()) <= tol


def _fill_cross(model, params, caches, frames):
    """Whisper's cross caches from the encoder's output (``enc_out @
    xattn.wk`` and ``@ xattn.wv``, as JAX's tests fill them)."""
    cfg = model.cfg
    cast = model.cast(params)
    enc = model._encode(cast, frames)
    B = frames.shape[0]
    for p, c in zip(model._layers(cast["layers"]), model._layers(caches)):
        c["xk"].copy_((enc @ p["xattn"]["wk"]).reshape(B, -1, cfg.n_kv_heads, cfg.head_dim))
        c["xv"].copy_((enc @ p["xattn"]["wv"]).reshape(B, -1, cfg.n_kv_heads, cfg.head_dim))
    return caches


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-mistral-7b"])
def test_enc_dec_and_vision_prefill_and_decode_on_card_match_cpu(cuda, arch):
    """The reduced Whisper (with encoder frames; cross caches filled from
    the encoder) and LLaVA (patch embeddings over the first 16 positions)
    in f32: the flash prefill (one launch a decoder layer; the encoder and
    cross-attention launch none) within 2e-3 and five teacher-forced decode
    steps (no launch) within 2e-5 x max(1, max|logit|), card against CPU
    from the same weights."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models.layers import tree_map
    from repro_torch.models.steps import build_prefill_step, build_serve_step
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), params)
    rng = _rng(15)
    B, T = 2, 96
    inputs = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)))}
    if cfg.enc_dec:
        inputs["enc_frames"] = torch.tensor(
            rng.standard_normal((B, cfg.encoder_ctx, cfg.d_model)), dtype=torch.float32)
    else:
        inputs["patch_embeds"] = torch.tensor(
            rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)),
            dtype=torch.float32)
    prefill, serve = build_prefill_step(model, use_flash=True), build_serve_step(model)

    def run(p, dev):
        got = [prefill(p, {k: v.to(dev) for k, v in inputs.items()})]
        caches = model.init_caches(B, 5, device=dev)
        if cfg.enc_dec:
            caches = _fill_cross(model, p, caches, inputs["enc_frames"].to(dev))
        tok = inputs["tokens"].to(dev)
        for i in range(5):
            got.append(serve(p, caches, tok[:, i:i + 1], i)[0])
        return got

    build.reset_launches()
    got = run(card, cuda)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == cfg.n_layers
    assert sum(build.LAUNCHES.values()) == cfg.n_layers
    want = run(params, "cpu")
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=2e-3, atol=2e-3)
    for g, w in zip(got[1:], want[1:]):
        tol = 2e-5 * max(1.0, float(w.abs().max()))
        assert float((g.cpu() - w).abs().max()) <= tol


MOE_ARCHS = ["mixtral-8x7b", "dbrx-132b", "jamba-1.5-large-398b"]


def _moe_prefill(arch):
    """A reduced MoE config in f32 (Mixtral's window cut to 48 so that it
    masks at T 96), its weights and tokens."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models.transformer import build_model

    cfg = ARCHS[arch].reduced()
    cfg = dataclasses.replace(cfg, dtype="float32", window=48 if cfg.window else 0)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    tok = torch.tensor(_rng(13).integers(0, cfg.vocab_size, (2, 96)))
    return cfg, params, tok


def _routes_body(grid, cfg, params, tok):
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import build_model, forward_routes

    dev = grid.device
    return forward_routes(build_model(cfg, grid=grid), tree_map(lambda t: t.to(dev), params),
                          {"tokens": tok.to(dev)}, use_flash=True)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_on_card_matches_cpu(cuda, arch):
    """A reduced MoE model's flash prefill on the card (flash and, for Jamba,
    ssd_scan launches) against the CPU's plain versions from the same
    weights, in f32, under the routing rule: at most 0.1% of the tokens may
    choose other experts, the others' logits within 2e-3."""
    from repro_torch.common.config import MixerKind
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import build_model, forward_routes, routing_rule

    cfg, params, tok = _moe_prefill(arch)
    model = build_model(cfg)
    n_attn = sum(k[0] == MixerKind.ATTN for k in model.kinds)
    build.reset_launches()
    got, got_sets = forward_routes(model, tree_map(lambda t: t.to(cuda), params),
                                   {"tokens": tok.to(cuda)}, use_flash=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == n_attn
    assert build.LAUNCHES["ssd_scan"] == cfg.n_layers - n_attn
    want, want_sets = forward_routes(model, params, {"tokens": tok}, use_flash=True)
    a = routing_rule(got, want, got_sets, want_sets)
    assert a["flipped"] <= 1e-3 and a["max_other"] <= 2e-3


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routed_prefill_in_nccl_world_matches_cpu(cuda, arch):
    """The capacity-bounded route (factor 0.5, so that token-choices drop)
    in a 1x1 NCCL world on the card against a 1x1 gloo world on the CPU,
    under the routing rule, within 2e-3."""
    import dataclasses

    from repro_torch.launch.mesh import run_world
    from repro_torch.models.moe import dropped_share
    from repro_torch.models.transformer import routing_rule

    cfg, params, tok = _moe_prefill(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    got, got_sets = run_world(1, 1, _routes_body, (cfg, params, tok), device="cuda",
                              timeout_s=120)
    want, want_sets = run_world(1, 1, _routes_body, (cfg, params, tok), timeout_s=120)
    assert min(dropped_share(s, cfg) for s in want_sets) > 0
    a = routing_rule(got, want, got_sets, want_sets)
    assert a["flipped"] <= 1e-3 and a["max_other"] <= 2e-3


def _ssd_inputs(shape, cuda, seed, dt_max=0.15, a_max=2.0):
    """x, dt, A, B, C of JAX's sweep (tests/test_kernels.py:86-92): dt in
    [0.05, dt_max], A in [-a_max, -1]."""
    Bsz, T, H, P, N = shape
    rng = _rng(seed)
    arrs = (rng.standard_normal((Bsz, T, H, P)),
            0.05 + rng.random((Bsz, T, H)) * (dt_max - 0.05),
            -1.0 - rng.random(H) * (a_max - 1.0),
            rng.standard_normal((Bsz, T, N)) * 0.5,
            rng.standard_normal((Bsz, T, N)) * 0.5)
    return [torch.tensor(a, dtype=torch.float32, device=cuda) for a in arrs]


# (B, T, H, P, N): the Mamba2-2.7B prefill's shape, a long sequence, a ragged
# T, T = 1, JAX's sweep shapes, and the reduced Mamba2's heads
SSD_CASES = [
    (4, 2048, 80, 64, 128),
    (1, 8192, 80, 64, 128),
    (1, 100, 4, 32, 16),
    (4, 1, 80, 64, 128),
    (1, 128, 4, 32, 16),
    (1, 256, 2, 64, 32),
    (2, 64, 8, 16, 128),
    (1, 32, 1, 8, 8),
    (2, 77, 16, 32, 16),
]


def test_ssd_scan_kernel_takes_views(cuda):
    """Non-contiguous and 16-byte-misaligned views (B and C as slices of
    one (B, T, 2N) tensor, as the model makes them, and x one float past a
    boundary) give what contiguous copies give."""
    x, dt, A, B, C = _ssd_inputs((2, 130, 8, 32, 16), cuda, 17)
    bc = torch.cat([B, C], dim=-1)
    flat = torch.empty(x.numel() + 1, device=cuda)
    xs = flat[1:].view(x.shape)
    xs.copy_(x)
    y = ssd_scan(xs, dt, A, bc[..., :16], bc[..., 16:])
    torch.testing.assert_close(y, ssd_scan(x, dt, A, B, C), rtol=0, atol=0)


@pytest.mark.parametrize("shape", SSD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssd_scan_kernel_matches_plain(cuda, shape):
    """Against the plain chunked version (f32 sums in another order: 2e-5 of
    the largest value) and the step-by-step ``ssd_ref`` (JAX's own bound,
    1e-4, tests/test_kernels.py:94-99)."""
    x, dt, A, B, C = _ssd_inputs(shape, cuda, 13)
    before = build.LAUNCHES["ssd_scan"]
    y = ssd_scan(x, dt, A, B, C)
    plain = ssd_chunked_batched(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ssd_scan"] == before + 1
    assert y.shape == x.shape and y.dtype == torch.float32
    assert float((y - plain).abs().max()) <= 2e-5 * max(1.0, float(plain.abs().max()))
    if shape[1] <= 2048:
        ref = torch.stack([ssd_ref(x[b], dt[b], A, B[b], C[b])[0] for b in range(shape[0])])
        assert float((y - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


# (B, T, H, P, N) where the kernel's grid and its shared Gram matrices could
# go wrong: H of 3, 5 and 81 (no head group divides them); P of 4 and 60
# (one and two column slices, both ragged); N of 4 and 124; T of 63, 65
# and 129 (a ragged last chunk, a chunk of one row); B = 3, each sequence
# with data of its own
SSD_GRID_CASES = [
    (1, 130, 3, 64, 128),
    (2, 65, 5, 32, 64),
    (1, 200, 81, 64, 128),
    (2, 129, 4, 4, 16),
    (1, 129, 6, 60, 128),
    (2, 100, 4, 64, 4),
    (1, 96, 3, 64, 124),
    (3, 63, 2, 64, 128),
    (3, 65, 3, 60, 124),
    (3, 129, 5, 8, 16),
]


@pytest.mark.parametrize("shape", SSD_GRID_CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssd_scan_kernel_grid_edges(cuda, shape):
    """Against the plain chunked version (2e-5) and ``ssd_ref`` (1e-4); each
    sequence of a batch gives, bit for bit, what it gives alone, so no
    sequence reads another's Gram matrices."""
    x, dt, A, B, C = _ssd_inputs(shape, cuda, 19)
    y = ssd_scan(x, dt, A, B, C)
    plain = ssd_chunked_batched(x, dt, A, B, C)
    ref = torch.stack([ssd_ref(x[b], dt[b], A, B[b], C[b])[0] for b in range(shape[0])])
    torch.cuda.synchronize()
    assert float((y - plain).abs().max()) <= 2e-5 * max(1.0, float(plain.abs().max()))
    assert float((y - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
    for b in range(shape[0]):
        alone = ssd_scan(x[b:b + 1], dt[b:b + 1], A, B[b:b + 1], C[b:b + 1])
        torch.testing.assert_close(y[b:b + 1], alone, rtol=0, atol=0)


def test_ssd_scan_kernel_steep_decay(cuda):
    """dt up to 1 and A down to -12: cs falls by hundreds within a chunk, so
    exp(-cs) would overflow f32 and exp(cs_t - cs_s) for t < s is inf; the
    kernel must stay finite and agree."""
    x, dt, A, B, C = _ssd_inputs((2, 300, 8, 64, 128), cuda, 14, dt_max=1.0, a_max=12.0)
    y = ssd_scan(x, dt, A, B, C)
    plain = ssd_chunked_batched(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert float((y - plain).abs().max()) <= 2e-5 * max(1.0, float(plain.abs().max()))


def test_ssd_scan_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C = _ssd_inputs((1, 16, 2, 8, 8), cuda, 15)
    with pytest.raises(TypeError):
        ssd_scan(x.double(), dt, A, B, C)
    with pytest.raises(TypeError):
        ssd_scan(x, dt, A, B.bfloat16(), C)
    with pytest.raises(ValueError, match="takes x"):
        ssd_scan(x[0], dt, A, B, C)
    with pytest.raises(ValueError, match="shape mismatch"):
        ssd_scan(x, dt, A[:1], B, C)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan(x, dt, A.cpu(), B, C)
    with pytest.raises(ValueError, match="P <= 64"):
        ssd_scan(torch.zeros(1, 16, 2, 80, device=cuda), dt, A, B, C)
    with pytest.raises(ValueError, match="multiples of 4"):
        ssd_scan(x[..., :6], dt, A, B, C)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x.requires_grad_(), dt, A, B, C)
    with torch.no_grad():
        assert ssd_scan(x, dt, A, B, C).shape == x.shape


def test_mamba2_prefill_on_card_matches_cpu(cuda):
    """Mamba2-2.7B at full width cut to 2 layers, kept apart, in f32: the
    prefill through the kernel on the card and through the plain chunked
    version on the CPU, from the same weights (2e-3); one launch a layer."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models.layers import tree_map
    from repro_torch.models.steps import build_prefill_step
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(ARCHS["mamba2-2.7b"], n_layers=2, dtype="float32",
                              scan_layers=False)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.tensor(_rng(16).integers(0, cfg.vocab_size, (1, 100)))
    prefill = build_prefill_step(model)
    before = build.LAUNCHES["ssd_scan"]
    got = prefill(tree_map(lambda t: t.to(cuda), params), {"tokens": tok.to(cuda)})
    torch.cuda.synchronize()
    assert build.LAUNCHES["ssd_scan"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), prefill(params, {"tokens": tok}),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# Hogwild on the card: the two-phase step and the launch counts
# ---------------------------------------------------------------------------
def _hogwild_setup(model):
    from repro_torch.common.config import KGEConfig
    from repro_torch.data.kg_synth import make_synthetic_kg

    kg = make_synthetic_kg(n_entities=2000, n_relations=40, n_edges=20_000,
                           n_clusters=8, seed=0)
    cfg = KGEConfig(model=model, n_entities=2000, n_relations=40, dim=400,
                    batch_size=256, neg_sample_size=64, lr=0.1)
    return cfg, kg


@pytest.mark.parametrize("model", ["transe_l2", "transe_l1"])
def test_two_phase_step_equals_train_step_bit_for_bit(cuda, model):
    """grad_step then apply_step runs the same launches on the same inputs
    as train_step with T5 off, so the tables come out with the same bits."""
    from repro_torch.core import kge_model as K
    from repro_torch.core.sampling import JointSampler

    cfg, kg = _hogwild_setup(model)
    sampler = JointSampler(kg.train, cfg.n_entities, cfg, np.random.default_rng(0))
    one = K.init_state(cfg, torch.Generator().manual_seed(0), device=cuda)
    two = K.state_from_arrays(cfg, K.state_to_arrays(one), device=cuda)
    grad_fn, apply_fn = K.make_hogwild_step(cfg)
    for _ in range(3):
        batch = K.batch_to_device(sampler.sample(), cuda)
        one, m1 = K.train_step(cfg, one, batch)
        grads, m2 = grad_fn(two, batch)
        two = apply_fn(two, batch, grads)
        assert torch.equal(m1["loss"], m2["loss"])
    assert one.step == two.step == 3
    for name in ("entity", "ent_gsq", "r_emb", "rel_gsq"):
        assert torch.equal(getattr(one, name), getattr(two, name)), name


@pytest.mark.parametrize("model,kernels", [
    ("transe_l2", ("pairwise_l2sq", "dedup_aggregate", "fused_update")),
    ("transe_l1", ("pairwise_l1", "l1_bwd_pair", "dedup_aggregate", "fused_update")),
])
def test_hogwild_launches_each_kernel_twice_a_step(cuda, model, kernels):
    """Three trainers and two samplers on the card, T5 off: exactly two
    launches of each kernel of the path a step, none lost across threads."""
    from repro_torch.core import kge_model as K
    from repro_torch.core.sampling import JointSampler
    from repro_torch.data.pipeline import worker_rngs
    from repro_torch.launch.engine import MetricsHook, train_loop

    cfg, kg = _hogwild_setup(model)
    samplers = [JointSampler(kg.train, cfg.n_entities, cfg, r)
                for r in worker_rngs(0, 2)]

    def factory(wid):
        return lambda: (K.batch_to_device(samplers[wid].sample(), cuda), None)

    state = K.init_state(cfg, torch.Generator().manual_seed(0), device=cuda)
    mh = MetricsHook()
    build.reset_launches()
    state = train_loop(lambda s, b: K.train_step(cfg, s, b), state, factory(0), 40,
                       hooks=[mh], n_trainers=3, n_samplers=2, sampler_factory=factory,
                       split_step=K.make_hogwild_step(cfg))
    torch.cuda.synchronize()
    assert state.step == 40 and len(mh.history["loss"]) == 40
    assert all(np.isfinite(mh.history["loss"]))
    for name in kernels:
        assert build.LAUNCHES[name] == 80, (name, build.LAUNCHES[name])


# ---------------------------------------------------------------------------
# the distributed path: a 1x1 NCCL world on the card against a 1x1 gloo
# world on the CPU
# ---------------------------------------------------------------------------
def _dist_setup(model, steps=3):
    from repro_torch.common.config import KGEConfig
    from repro_torch.core import distributed as D
    from repro_torch.core.graph_part import partition
    from repro_torch.core.rel_part import relation_partition
    from repro_torch.core.sampling import DistSampler
    from repro_torch.data.kg_synth import make_synthetic_kg

    kg = make_synthetic_kg(n_entities=600, n_relations=24, n_edges=9000,
                           n_clusters=6, seed=0)
    cfg = KGEConfig(model=model, n_entities=kg.n_entities, n_relations=kg.n_relations,
                    dim=64, batch_size=64, neg_sample_size=32, lr=0.05, n_parts=1,
                    remote_capacity=64)
    book = partition(kg.train, cfg.n_entities, 1)
    rp = relation_partition(kg.rel_counts(), 1)
    prog = D.make_program(cfg, book.rows_per_part, rp.slots_per_part, rp.n_shared)
    sampler = DistSampler(kg.train, book, rp, cfg, np.random.default_rng(0))
    return prog, D.init_dist_arrays(prog, 0), [sampler.sample() for _ in range(steps)]


@pytest.mark.parametrize("model,kernels", [
    ("transe_l2", ("pairwise_l2sq", "dedup_aggregate", "fused_update")),
    ("transe_l1", ("pairwise_l1", "l1_bwd_pair", "dedup_aggregate", "fused_update")),
    ("distmult", ("pairwise_dot", "dedup_aggregate", "fused_update")),
])
def test_dist_world_of_one_matches_cpu(cuda, model, kernels):
    """Three steps through ``run_batches`` in a 1x1 NCCL world (kernels) and
    a 1x1 gloo world (plain versions), from one state and batch list: the
    losses within 1e-5, the tables under the Adagrad-flip rule (every entry
    within 1e-5 but for 0.1% of them, those within 2 lr a step), and each
    kernel of the path launched at least twice a step."""
    from repro_torch.core.distributed import run_batches
    from repro_torch.launch.mesh import run_world

    prog, init, batches = _dist_setup(model)
    build.reset_launches()
    h_dev, got = run_world(1, 1, run_batches, (prog, init, batches), device=cuda)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    h_cpu, want = run_world(1, 1, run_batches, (prog, init, batches), device="cpu")
    np.testing.assert_allclose([m["loss"] for m in h_dev], [m["loss"] for m in h_cpu],
                               rtol=1e-5, atol=1e-5)
    for name in kernels:
        assert launches[name] >= 2 * len(batches), (name, launches[name])
    np.testing.assert_array_equal(got["pend_ids"], want["pend_ids"])
    assert got["step"] == want["step"] == len(batches)
    for name in ("entity", "ent_gsq", "r_emb", "rel_gsq", "shared_rel", "pend_grads"):
        diff = np.abs(got[name] - want[name])
        assert (diff > 1e-5 + 1e-5 * np.abs(want[name])).mean() <= 1e-3, name
        assert diff.max() <= 2 * prog.cfg.lr * len(batches), name


def test_dist_world_of_one_with_two_trainers_matches_cpu(cuda):
    """``--distributed --mesh 1x1 --trainers 2 --samplers 2`` through the CLI
    on the card (one NCCL rank; trainer and sampler threads on its stream)
    and on the CPU (gloo), six TransE_l2 steps on one batch order: exactly
    two pairwise_l2sq launches a step, the losses within 1e-5 and the tables
    under the Adagrad-flip rule."""
    from repro_torch.launch import engine, train

    def cli(device):
        hook = engine.MetricsHook(("loss",))
        cfg, final = train.main(
            ["--device", device, "--distributed", "--mesh", "1x1", "--trainers", "2",
             "--samplers", "2", "--steps", "6", "--scale", "0.05", "--dim", "64",
             "--batch-size", "64", "--neg", "32", "--log-every", "3"], hooks=[hook])
        return cfg, final, hook.history["loss"]

    build.reset_launches()
    cfg, got, l_dev = cli("cuda")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    _, want, l_cpu = cli("cpu")
    assert launches["pairwise_l2sq"] == 12 and launches["fused_update"] >= 12
    np.testing.assert_allclose(l_dev, l_cpu, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["pend_ids"], want["pend_ids"])
    assert got["step"] == want["step"] == 6
    for name in ("entity", "ent_gsq", "r_emb", "rel_gsq", "pend_grads"):
        diff = np.abs(got[name] - want[name])
        assert (diff > 1e-5 + 1e-5 * np.abs(want[name])).mean() <= 1e-3, name
        assert diff.max() <= 2 * cfg.lr * 6, name


def _cpu_step_grads(model, params, batch, mb):
    """The CPU step's gradient (the microbatches' mean), by path."""
    from repro_torch.models.layers import tree_leaves, tree_map

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    for i in range(mb):
        model.loss(params, {k: v[i] for k, v in batch.items()}).backward()
    grads = tree_map(lambda p: p.grad.clone() / mb, params)
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return grads


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-2.7b", "jamba-1.5-large-398b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One ``build_train_step`` step of the reduced ``arch`` in f32 (2
    microbatches of (2, 32); AdamW for Qwen and Mamba2, Adafactor for
    Jamba) on the card and on the CPU from the same weights and batch: the
    loss within 2e-5 x max(1, |loss|), the parameters within 1e-6 x
    max(1, max|p|) + 1% of lr but where the CPU gradient lies within 2e-4 x
    max(1, max|g|) of 0 (AdamW's lr x sign(g) may flip there, by 2 lr at
    most); no kernel launch (the train route is JAX's)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.layers import tree_map
    from repro_torch.models.steps import build_train_step
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                              param_dtype="float32", microbatches=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), params)
    rng = _rng(3)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (2, 2, 32)), dtype=torch.int32)
             for k in ("tokens", "labels")}
    lr = 1e-3
    grads = _cpu_step_grads(model, params, batch, 2)
    step, opt = build_train_step(model, lr=lr)
    build.reset_launches()
    card, _, got = step(card, opt.init(card), {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert sum(build.LAUNCHES.values()) == 0
    params, _, want = step(params, opt.init(params), batch)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 2e-5 * max(
        1.0, abs(float(want["loss"])))

    def close(c, w, g):
        d = (c.cpu() - w).abs()
        near0 = g.abs() <= 2e-4 * max(1.0, float(g.abs().max()))
        bad = d > 1e-6 * max(1.0, float(w.abs().max())) + 1e-2 * lr
        assert not bool((bad & ~near0).any()) and bool((d <= 2 * lr + 1e-7).all())

    tree_map(close, card, params, grads)
