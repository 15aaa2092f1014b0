"""Partitioning (T3, T4) and the distributed sampler, port vs JAX package.

``core/graph_part.py``, ``core/rel_part.py`` and ``DistSampler`` are numpy
only in both packages (the port keeps copies), so parity is exact: every
field is compared with ``==`` on the same seeds. The twins of
tests/test_partition.py run each invariant on the port's output after
holding it to JAX's; the sampler's twins do the same for
tests/test_sampling.py's distributed cases.
"""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st

from repro.common.config import KGEConfig as JaxCfg
from repro.core import graph_part as JG
from repro.core import rel_part as JR
from repro.core.sampling import DistSampler as JaxDistSampler
from repro_torch.common.config import KGEConfig as TorchCfg
from repro_torch.core import graph_part as TG
from repro_torch.core import rel_part as TR
from repro_torch.core.sampling import DistSampler

BOOK_FIELDS = ("n_parts", "rows_per_part", "part_of", "local_row", "part_sizes")
REL_FIELDS = ("n_parts", "slots_per_part", "owner", "slot", "n_shared",
              "triplet_load")
BATCH_FIELDS = ("ent_local_ids", "ent_remote_req", "h_slot", "t_slot", "neg_slot",
                "rel_local_ids", "rel_remote_req", "rel_slot", "rel_shared",
                "n_groups", "remote_rows_used", "dropped_triplets")


def _same(got, want, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def _books(trip, n, p, method="metis", seed=0):
    book = TG.partition(trip, n, p, method=method, seed=seed)
    _same(book, JG.partition(trip, n, p, method=method, seed=seed), BOOK_FIELDS)
    return book


def _rel_parts(counts, p, seed=0):
    rp = TR.relation_partition(counts, p, seed=seed)
    _same(rp, JR.relation_partition(counts, p, seed=seed), REL_FIELDS)
    assert TR.load_imbalance(rp) == JR.load_imbalance(rp)
    return rp


def test_metis_beats_random_on_clustered(small_kg):
    m = TG.metis_like_partition(small_kg.train, small_kg.n_entities, 4, seed=0)
    r = TG.random_partition(small_kg.n_entities, 4, seed=0)
    np.testing.assert_array_equal(
        m, JG.metis_like_partition(small_kg.train, small_kg.n_entities, 4, seed=0))
    np.testing.assert_array_equal(r, JG.random_partition(small_kg.n_entities, 4, seed=0))
    cm, cr = TG.cut_fraction(small_kg.train, m), TG.cut_fraction(small_kg.train, r)
    assert cm == JG.cut_fraction(small_kg.train, m)
    assert cm < 0.75 * cr


def test_partition_balance(small_kg):
    part = TG.metis_like_partition(small_kg.train, small_kg.n_entities, 4, seed=0)
    np.testing.assert_array_equal(
        part, JG.metis_like_partition(small_kg.train, small_kg.n_entities, 4, seed=0))
    sizes = np.bincount(part, minlength=4)
    assert sizes.max() <= 1.1 * sizes.mean() + 2


def test_partition_book_bijective(small_kg):
    book = _books(small_kg.train, small_kg.n_entities, 4)
    ents = np.arange(small_kg.n_entities)
    rows = book.global_row(ents)
    np.testing.assert_array_equal(
        rows, JG.partition(small_kg.train, small_kg.n_entities, 4).global_row(ents))
    assert len(np.unique(rows)) == small_kg.n_entities
    assert rows.max() < book.n_rows
    assert (rows // book.rows_per_part == book.part_of).all()


@settings(max_examples=20, deadline=None)
@given(n=st.integers(10, 300), p=st.integers(1, 8), seed=st.integers(0, 5))
def test_partition_book_property(n, p, seed):
    rng = np.random.default_rng(seed)
    trip = rng.integers(0, n, size=(max(20, n), 3))
    trip[:, 1] = rng.integers(0, 5, size=trip.shape[0])
    book = _books(trip, n, p, seed=seed)
    assert book.part_sizes.sum() == n
    assert (book.local_row < book.rows_per_part).all()
    assert len(np.unique(book.global_row(np.arange(n)))) == n


def test_relation_partition_assignment():
    counts = np.array([1000, 500, 400, 50, 40, 30, 20, 10, 5, 5])
    rp = _rel_parts(counts, 4)
    assert ((rp.owner >= 0) | (rp.slot >= 0)).all()
    owned = rp.owner >= 0
    keys = rp.owner[owned] * rp.slots_per_part + rp.slot[owned]
    assert len(np.unique(keys)) == owned.sum()
    assert TR.load_imbalance(rp) < 1.6


def test_split_frequent_relations():
    rp = _rel_parts(np.array([10_000] + [10] * 50), 4)
    assert rp.owner[0] == -1 and rp.n_shared >= 1
    assert (rp.owner[1:] >= 0).all()


@settings(max_examples=20, deadline=None)
@given(n_rel=st.integers(1, 100), p=st.integers(1, 8), seed=st.integers(0, 3))
def test_relation_partition_property(n_rel, p, seed):
    counts = np.random.default_rng(seed).integers(1, 1000, size=n_rel)
    rp = _rel_parts(counts, p, seed=seed)
    owned = rp.owner >= 0
    assert (rp.slot[owned] < rp.slots_per_part).all()
    assert (rp.owner[owned] < p).all()
    sh = ~owned
    if sh.any():
        assert len(np.unique(rp.slot[sh])) == sh.sum()


def test_epoch_randomization_differs():
    counts = np.ones(64, dtype=np.int64) * 10
    a, b = _rel_parts(counts, 4, seed=0), _rel_parts(counts, 4, seed=1)
    assert (a.owner != b.owner).any()


# ---------------------------------------------------------------- DistSampler
def _samplers(kg, P_, method, **kw):
    over = dict(n_entities=kg.n_entities, n_relations=kg.n_relations, dim=16,
                n_parts=P_, batch_size=64, neg_sample_size=32, remote_capacity=64)
    over.update(kw)
    book = _books(kg.train, kg.n_entities, P_, method=method)
    rp = _rel_parts(kg.rel_counts(), P_)
    port = DistSampler(kg.train, book, rp, TorchCfg(**over), np.random.default_rng(0))
    ref = JaxDistSampler(kg.train, JG.partition(kg.train, kg.n_entities, P_,
                                                method=method),
                         JR.relation_partition(kg.rel_counts(), P_), JaxCfg(**over),
                         np.random.default_rng(0))
    return port, ref, book


@pytest.mark.parametrize("partitioner", ["metis", "random"])
def test_dist_sampler_matches_jax(small_kg, partitioner):
    """Every DistBatch field over 3 batches, capacity tight enough to drop."""
    port, ref, _ = _samplers(small_kg, 4, partitioner, remote_capacity=16)
    assert (port.L, port.Rp, port.Lr, port.Rrp) == (ref.L, ref.Rp, ref.Lr, ref.Rrp)
    drops = 0
    for _ in range(3):
        got, want = port.sample(), ref.sample()
        _same(got, want, BATCH_FIELDS)
        assert got.stats == want.stats
        drops += got.dropped_triplets
    assert drops > 0


@pytest.mark.parametrize("partitioner", ["metis", "random"])
def test_dist_sampler_invariants(small_kg, partitioner):
    P_ = 4
    s, ref, book = _samplers(small_kg, P_, partitioner)
    db = s.sample()
    _same(db, ref.sample(), BATCH_FIELDS)
    L = s.L
    for p in range(P_):
        ids = db.ent_local_ids[p]
        valid = ids[ids >= 0]
        assert (valid < book.rows_per_part).all()
        assert len(np.unique(valid)) == valid.size
        assert (db.h_slot[p] >= 0).all() and (db.h_slot[p] < L).all()
        assert (db.t_slot[p] < L + P_ * s.Rp).all()
        assert (db.neg_slot[p] < L).all()  # T3: negatives strictly local
        req = db.ent_remote_req[p]
        assert (req[req >= 0] < book.rows_per_part).all()
        assert (db.rel_slot[p] < s.Lr + P_ * s.Rrp).all()


def test_metis_fewer_remote_pulls(small_kg):
    """T3: METIS partitioning needs fewer remote rows than random."""
    used = {}
    for method in ("metis", "random"):
        s, ref, _ = _samplers(small_kg, 4, method, batch_size=128,
                              remote_capacity=512)
        tot = 0
        for _ in range(5):
            got = s.sample()
            assert got.remote_rows_used == ref.sample().remote_rows_used
            tot += got.remote_rows_used
        used[method] = tot
    assert used["metis"] < used["random"]
