"""The port's sparse-Adagrad path against the JAX package.

On the CPU the port's wrappers run the plain versions (kernels/
sparse_adagrad/ref.py); they are held to JAX's Pallas kernels in interpret
mode and to the JAX oracles. The fused update's Pallas kernel needs the
scalar-prefetch grid spec, so that comparison carries the same skip as
tests/test_sparse_adagrad_kernel.py. The CUDA kernels are held to the
plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import compat
from repro.kernels.sparse_adagrad import dedup_aggregate as jax_dedup
from repro.kernels.sparse_adagrad import fused_sparse_adagrad as jax_fused
from repro.kernels.sparse_adagrad.ref import dedup_aggregate_ref as jax_dedup_ref
from repro.kernels.sparse_adagrad.ref import fused_update_ref as jax_fused_ref
from repro.optim import sparse_adagrad as JO
from repro_torch.embeddings.store import DenseStore
from repro_torch.kernels.sparse_adagrad import ops
from repro_torch.optim import sparse_adagrad as TO

torch.set_num_threads(2)

needs_prefetch = pytest.mark.skipif(
    not compat.has_scalar_prefetch(),
    reason="no Pallas scalar-prefetch grid spec in this JAX")

TOL = dict(rtol=2e-5, atol=2e-6)


def _dups(rng, n, n_rows, frac_pad=0.15):
    """ids with duplicates (drawn from n // 2 rows) and pads."""
    ids = rng.integers(0, min(n_rows, max(1, n // 2)), size=n)
    ids[rng.random(n) < frac_pad] = -1
    return ids.astype(np.int32)


def _unique(rng, n, n_rows, frac_pad=0.2):
    ids = rng.permutation(n_rows)[:n]
    return np.where(rng.random(n) < frac_pad, -1, ids).astype(np.int32)


def _table(rng, N, D):
    return (rng.standard_normal((N, D)).astype(np.float32),
            np.abs(rng.standard_normal((N, D))).astype(np.float32))


@pytest.mark.parametrize("n,D", [(40, 24), (130, 33), (1, 4)])
def test_dedup_matches_jax_kernel_and_ref(n, D):
    rng = np.random.default_rng(n)
    ids = _dups(rng, n, 1000)
    g = rng.standard_normal((n, D)).astype(np.float32)
    uid, agg = ops.dedup_aggregate(torch.tensor(ids), torch.tensor(g))
    for ju, ja in (jax_dedup(jnp.asarray(ids), jnp.asarray(g)),
                   jax_dedup_ref(jnp.asarray(ids), jnp.asarray(g))):
        np.testing.assert_array_equal(uid.numpy(), np.asarray(ju))
        np.testing.assert_allclose(agg.numpy(), np.asarray(ja), **TOL)
    assert uid.dtype == torch.int32
    # the layout: first occurrences keep their slot and id
    valid = ids[ids >= 0]
    assert sorted(uid[uid >= 0].tolist()) == sorted(set(valid.tolist()))


@pytest.mark.parametrize("ids_np", [
    [-1, -1, 3, -1, 7, -1, -1, 5],   # leading + interleaved + trailing pads
    [-1, -1, -1, -1],                # all pads: bitwise no-op
    [2],                             # single row
    [0, 9, 4, 15, 1],                # no pads
])
def test_fused_update_matches_ref_and_leaves_untouched_rows(ids_np):
    rng = np.random.default_rng(1)
    N, D = 16, 24
    table, gsq = _table(rng, N, D)
    ids = np.asarray(ids_np, np.int32)
    g = rng.standard_normal((len(ids_np), D)).astype(np.float32)
    tt, tq = torch.tensor(table), torch.tensor(gsq)
    out_t, out_q = ops.fused_sparse_adagrad(tt, tq, torch.tensor(ids),
                                            torch.tensor(g), 0.2)
    assert out_t is tt and out_q is tq  # in place
    jt, jq = jax_fused_ref(jnp.asarray(table), jnp.asarray(gsq), jnp.asarray(ids),
                           jnp.asarray(g), 0.2)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    untouched = sorted(set(range(N)) - {i for i in ids_np if i >= 0})
    np.testing.assert_array_equal(tt.numpy()[untouched], table[untouched])
    np.testing.assert_array_equal(tq.numpy()[untouched], gsq[untouched])


@needs_prefetch
@pytest.mark.parametrize("D", [32, 256, 401, 4096])
def test_fused_update_matches_jax_pallas_interpret(D):
    """JAX tiles a row into column blocks of 512/256/128 where one divides D
    (4096: eight of 512) and takes the whole row otherwise (401, the port's
    scalar path); pads at both ends and in the middle."""
    rng = np.random.default_rng(2)
    table, gsq = _table(rng, 64, D)
    ids = _unique(rng, 20, 64)
    ids[[0, -1]] = -1
    assert (ids[1:-1] < 0).any() and (ids >= 0).any()
    g = rng.standard_normal((20, D)).astype(np.float32)
    tt, tq = torch.tensor(table), torch.tensor(gsq)
    ops.fused_sparse_adagrad(tt, tq, torch.tensor(ids), torch.tensor(g), 0.05)
    jt, jq = jax_fused(jnp.asarray(table), jnp.asarray(gsq), jnp.asarray(ids),
                       jnp.asarray(g), 0.05)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)


def test_sparse_adagrad_apply_matches_jax():
    """Raw workspace ids (duplicates + pads): dedup then the row update."""
    rng = np.random.default_rng(3)
    table, gsq = _table(rng, 50, 16)
    ids = _dups(rng, 60, 50)
    g = rng.standard_normal((60, 16)).astype(np.float32)
    tt, tq = torch.tensor(table), torch.tensor(gsq)
    TO.sparse_adagrad_apply(tt, tq, torch.tensor(ids), torch.tensor(g), 0.1)
    jt, jq = JO.sparse_adagrad_apply(jnp.asarray(table), jnp.asarray(gsq),
                                     jnp.asarray(ids), jnp.asarray(g), 0.1)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)


@pytest.mark.parametrize("capacity", [64, 20, 5, 1])
def test_dedup_compact_rows_overflow_counts(capacity):
    """Compaction keeps first-occurrence order (JAX's kernel dedup layout);
    the drop count is exact."""
    rng = np.random.default_rng(4)
    ids = _dups(rng, 48, 200)
    g = rng.standard_normal((48, 8)).astype(np.float32)
    ti, tg, tn = TO.dedup_compact_rows(torch.tensor(ids), torch.tensor(g), capacity)
    ji, jg, jn = JO.dedup_compact_rows(jnp.asarray(ids), jnp.asarray(g), capacity,
                                       use_kernel=True)
    n_unique = len(set(ids[ids >= 0].tolist()))
    assert int(tn) == int(jn) == max(0, n_unique - capacity)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


def test_segment_aggregate_rows_matches_jax():
    rng = np.random.default_rng(5)
    ids = _dups(rng, 30, 100)
    g = rng.standard_normal((30, 6)).astype(np.float32)
    tu, ta = TO.segment_aggregate_rows(torch.tensor(ids), torch.tensor(g))
    ju, ja = JO.segment_aggregate_rows(jnp.asarray(ids), jnp.asarray(g))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)


def test_update_rows_and_dense_update_match_jax():
    rng = np.random.default_rng(6)
    table, gsq = _table(rng, 30, 8)
    ids = _unique(rng, 12, 30)
    g = rng.standard_normal((12, 8)).astype(np.float32)
    tt, tq = torch.tensor(table), torch.tensor(gsq)
    TO.sparse_adagrad_update_rows(tt, tq, torch.tensor(ids), torch.tensor(g), 0.3)
    jt, js = JO.sparse_adagrad_update_rows(jnp.asarray(table), JO.AdagradState(
        jnp.asarray(gsq)), jnp.asarray(ids), jnp.asarray(g), 0.3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(js.gsq), **TOL)
    dg = rng.standard_normal(table.shape).astype(np.float32)
    tt, tq = torch.tensor(table), torch.tensor(gsq)
    TO.dense_adagrad_update(tt, tq, torch.tensor(dg), 0.3)
    jt, js = JO.dense_adagrad_update(jnp.asarray(table), JO.AdagradState(
        jnp.asarray(gsq)), jnp.asarray(dg), 0.3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(js.gsq), **TOL)


def test_dense_store_defer_flush_equals_immediate_and_snapshot():
    rng = np.random.default_rng(7)
    table, _ = _table(rng, 40, 8)
    now = DenseStore.create(torch.tensor(table), lr=0.1)
    later = DenseStore.create(torch.tensor(table), lr=0.1, defer=True, pend_slots=24)
    for _ in range(3):
        ids = torch.tensor(_dups(rng, 24, 40))
        g = torch.tensor(rng.standard_normal((24, 8)).astype(np.float32))
        now.apply_sparse_grads(ids, g)
        later.flush().apply_sparse_grads(ids, g)
    later.flush()
    torch.testing.assert_close(later.table, now.table, rtol=0, atol=0)
    assert int((later.pend_ids >= 0).sum()) == 0
    snap = {k: v.clone() for k, v in now.snapshot().items()}
    now.apply_sparse_grads(ids, g)
    now.restore(snap)
    torch.testing.assert_close(now.table, snap["table"], rtol=0, atol=0)


def test_dense_store_small_pend_buffer_counts_drops():
    store = DenseStore.create(torch.zeros(100, 4), lr=0.1, defer=True, pend_slots=5)
    ids = torch.arange(12)
    store.apply_sparse_grads(ids, torch.ones(12, 4))
    assert int(store.pend_dropped) == 7
    assert store.pend_ids.tolist() == [0, 1, 2, 3, 4]
