"""The port's host pipeline against the JAX package's (tests/test_pipeline.py):
ordering, backpressure, stats, shutdown; plus the cross-package stream check
(``worker_rngs`` gives the same JointSampler batches in both packages) and
the port's divergence: a dying sampler re-raises in the consumer.

Every queue wait and join is bounded by a timeout."""

import queue
import threading
import time
import warnings

import numpy as np
import pytest

from repro.common.config import KGEConfig as JaxCfg
from repro.core.sampling import JointSampler as JaxJointSampler
from repro.data.kg_synth import make_synthetic_kg
from repro.data.pipeline import worker_rngs as jax_worker_rngs
from repro_torch.common import telemetry
from repro_torch.common.config import KGEConfig
from repro_torch.core.sampling import JointSampler
from repro_torch.data.pipeline import Prefetcher, WorkerPool, worker_rngs

WAIT_S = 2.0


def test_prefetch_yields_batches_in_order():
    counter = iter(range(1000))
    pf = Prefetcher(lambda: next(counter))
    got = [pf.get(timeout=WAIT_S) for _ in range(10)]
    pf.close()
    assert got == sorted(got)  # producer is single-threaded: strictly ordered


def test_close_joins_producer_promptly():
    """The producer can sit in q.put with one more batch after a single
    drain; close() must keep draining until the thread actually exits."""
    pf = Prefetcher(lambda: 0, depth=1)
    time.sleep(0.2)  # let the producer fill the queue and block in put()
    t0 = time.monotonic()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a shutdown-timeout warning = failure
        pf.close()
    assert not pf.thread.is_alive()
    assert time.monotonic() - t0 < 2.0


def test_close_warns_on_hung_producer():
    release = threading.Event()

    def slow_sample():
        release.wait(10.0)
        return 0

    pf = Prefetcher(slow_sample)
    time.sleep(0.05)  # producer is now inside slow_sample
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pf.close(timeout=0.3)
    assert any("Prefetcher" in str(w.message) for w in caught)
    release.set()
    pf.thread.join(timeout=WAIT_S)
    assert not pf.thread.is_alive()


# ---------------------------------------------------------------------------
# WorkerPool (multi-producer) — paper §3.3 sampler workers
# ---------------------------------------------------------------------------
def test_worker_pool_never_drops_a_batch_under_full_queue():
    """Slow consumer + tiny queue: every worker's sequence must arrive
    contiguous — a producer that resamples on queue.Full would skip values."""
    counters = {}

    def factory(wid):
        counters[wid] = iter(range(10_000))

        def sample(c=counters[wid], w=wid):
            return (w, next(c))
        return sample

    pool = WorkerPool(factory, n_workers=3, depth=1)
    seen = {}
    for _ in range(60):
        wid, seq = pool.get(timeout=WAIT_S)
        seen.setdefault(wid, []).append(seq)
        time.sleep(0.002)  # keep the queue full so producers hit backpressure
    pool.close()
    for wid, seqs in seen.items():
        assert seqs == list(range(seqs[0], seqs[0] + len(seqs))), \
            f"worker {wid} dropped a batch: {seqs}"


def test_worker_rngs_deterministic_and_independent():
    a = [r.integers(0, 2**63, 100).tolist() for r in worker_rngs(0, 4)]
    b = [r.integers(0, 2**63, 100).tolist() for r in worker_rngs(0, 4)]
    assert a == b  # deterministic given (seed, n, worker index)
    assert len({tuple(s) for s in a}) == 4  # streams are distinct
    c = [r.integers(0, 2**63, 100).tolist() for r in worker_rngs(1, 4)]
    assert all(x != y for x, y in zip(a, c))
    # the same streams as the JAX package's
    j = [r.integers(0, 2**63, 100).tolist() for r in jax_worker_rngs(0, 4)]
    assert a == j


def test_worker_pool_sampler_streams_do_not_interleave_shared_rng():
    """Each worker owns its Generator; pooled output is a permutation of the
    union of the per-worker streams computed offline."""
    n, per = 3, 12

    def factory(wid, rngs=worker_rngs(7, n)):
        r = rngs[wid]
        return lambda: (wid, int(r.integers(0, 2**31)))

    pool = WorkerPool(factory, n_workers=n, depth=2)
    got = {}
    for _ in range(n * per):
        wid, v = pool.get(timeout=WAIT_S)
        got.setdefault(wid, []).append(v)
    pool.close()
    expect = {wid: [int(r.integers(0, 2**31)) for _ in range(10_000)]
              for wid, r in enumerate(worker_rngs(7, n))}
    for wid, vals in got.items():
        assert vals == expect[wid][:len(vals)]


def test_worker_pool_close_joins_all_workers_cleanly():
    pool = WorkerPool(lambda wid: (lambda: 0), n_workers=4, depth=1)
    time.sleep(0.2)  # all four producers have filled the queue / block in put
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any shutdown warning = failure
        pool.close()
    assert not any(t.is_alive() for t in pool.threads)


def test_worker_pool_stats_track_backpressure():
    pool = WorkerPool(lambda wid: (lambda: 0), n_workers=2, depth=1)
    time.sleep(0.5)  # nobody consumes: producers block, wait accumulates
    s = pool.stats()
    assert s["queue_depth"] == 1
    assert s["produced"] >= 1
    assert s["producer_wait_s"] > 0.1
    pool.close()

    # slow producer: the consumer side accumulates wait instead
    pool = WorkerPool(lambda wid: (lambda: time.sleep(0.05) or 0), depth=2)
    for _ in range(3):
        pool.get(timeout=WAIT_S)
    assert pool.stats()["consumer_wait_s"] > 0.0
    pool.close()


def test_worker_pool_stats_consistent_under_contention():
    """stats() hammered from a second thread while producers and a consumer
    race: every snapshot is complete, ``produced`` is monotone, and waits
    never decrease."""
    pool = WorkerPool(lambda wid: (lambda: 0), n_workers=4, depth=2)
    snaps, errors = [], []

    def hammer():
        try:
            for _ in range(300):
                snaps.append(pool.stats())
        except Exception as e:  # pragma: no cover - the failure being tested
            errors.append(e)

    th = threading.Thread(target=hammer)
    th.start()
    for _ in range(100):
        pool.get(timeout=WAIT_S)
    th.join(timeout=30.0)
    assert not th.is_alive()
    snaps.append(pool.stats())
    pool.close()
    assert not errors
    for s in snaps:
        assert set(s) == {"queue_depth", "produced", "producer_wait_s",
                          "consumer_wait_s"}
    for a, b in zip(snaps, snaps[1:]):
        assert b["produced"] >= a["produced"]
        assert b["producer_wait_s"] >= a["producer_wait_s"] - 1e-12
        assert b["consumer_wait_s"] >= a["consumer_wait_s"] - 1e-12
    # each producer may still be between its put and its counter increment
    assert snaps[-1]["produced"] >= 100 - 4


def test_worker_pool_mirrors_stats_into_telemetry():
    """With the registry enabled, pipeline counters track stats() after a
    quiescent point."""
    with telemetry.active() as reg:
        pool = WorkerPool(lambda wid: (lambda: 0), n_workers=2, depth=2)
        for _ in range(40):
            pool.get(timeout=WAIT_S)
        pool.close()  # joins producers: both surfaces are final
        s = pool.stats()
        assert reg.counters["pipeline/produced"] == s["produced"]
        assert abs(reg.counters.get("pipeline/producer_wait_s", 0.0)
                   - s["producer_wait_s"]) < 1e-6
        assert abs(reg.counters.get("pipeline/consumer_wait_s", 0.0)
                   - s["consumer_wait_s"]) < 1e-6


def test_worker_pool_rejects_zero_workers():
    with pytest.raises(ValueError, match="n_workers"):
        WorkerPool(lambda wid: (lambda: 0), n_workers=0)


def test_peek_is_nonconsuming_lookahead():
    """peek() returns batch t+1 without consuming it; get() returns it next."""
    counter = iter(range(1000))
    pf = Prefetcher(lambda: next(counter))
    assert pf.get(timeout=WAIT_S) == 0
    peeked = pf.peek(timeout=WAIT_S)
    assert peeked == 1
    assert pf.peek(timeout=WAIT_S) is pf.peek(timeout=WAIT_S)  # idempotent
    assert pf.get(timeout=WAIT_S) == peeked
    assert pf.peek(timeout=WAIT_S) == 2
    got = [pf.get(timeout=WAIT_S) for _ in range(5)]
    pf.close()
    assert got == [2, 3, 4, 5, 6]  # nothing lost, nothing duplicated


def test_peek_does_not_corrupt_stats_or_close():
    pool = WorkerPool(lambda wid: (lambda: 0), n_workers=2, depth=2)
    pool.peek(timeout=WAIT_S)
    assert pool.stats()["produced"] >= 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a shutdown warning = failure
        pool.close()
    assert not any(t.is_alive() for t in pool.threads)


def test_worker_pool_distinct_rngs_give_distinct_batches():
    data = np.arange(1000)

    def factory(wid, rngs=worker_rngs(0, 2)):
        r = rngs[wid]
        return lambda: data[r.integers(0, len(data), 8)].tolist()

    pool = WorkerPool(factory, n_workers=2, depth=4)
    batches = [tuple(pool.get(timeout=WAIT_S)) for _ in range(20)]
    pool.close()
    assert len(set(batches)) > 1


# ---------------------------------------------------------------------------
# across packages, and the port's divergence
# ---------------------------------------------------------------------------
def test_worker_rngs_give_jax_joint_sampler_batches():
    """Worker w of either package, sampling from the same graph, yields the
    same JointSampler batches."""
    kg = make_synthetic_kg(n_entities=300, n_relations=12, n_edges=3000,
                           n_clusters=4, seed=0)
    kw = dict(model="transe_l2", n_entities=300, n_relations=12, dim=8,
              batch_size=32, neg_sample_size=8, neg_group_size=16, lr=0.1)
    jc, tc = JaxCfg(**kw), KGEConfig(**kw)
    for wid, (rj, rt) in enumerate(zip(jax_worker_rngs(3, 3), worker_rngs(3, 3))):
        sj = JaxJointSampler(kg.train, 300, jc, rj)
        st = JointSampler(kg.train, 300, tc, rt)
        for _ in range(3):
            bj, bt = sj.sample(), st.sample()
            for name in ("h", "r", "t", "neg"):
                np.testing.assert_array_equal(getattr(bt, name), getattr(bj, name),
                                              err_msg=f"worker {wid} {name}")


def test_dying_sampler_reraises_in_the_consumer():
    """Where the reference's consumer would wait forever, the port's get()
    raises the sampler's exception, after the batches made before it, and
    every later get() raises too."""
    produced = iter(range(2))

    def sample():
        return next(produced)  # StopIteration on the third call

    pf = Prefetcher(sample)
    assert [pf.get(timeout=WAIT_S), pf.get(timeout=WAIT_S)] == [0, 1]
    with pytest.raises(RuntimeError, match="sampler thread failed") as err:
        pf.get(timeout=WAIT_S)
    assert isinstance(err.value.__cause__, StopIteration)
    with pytest.raises(RuntimeError, match="sampler thread failed"):
        pf.get(timeout=WAIT_S)
    pf.thread.join(timeout=WAIT_S)
    assert not pf.thread.is_alive()  # the worker exited after handing it over
    pf.close()


# ---------------------------------------------------------------------------
# the ordered mode (the distributed path's several samplers)
# ---------------------------------------------------------------------------
def _counting_factory(delays=None):
    """Worker w yields (w, 0), (w, 1), ...; ``delays[w]`` s before each."""
    def factory(wid):
        counter = iter(range(10_000))

        def sample():
            if delays:
                time.sleep(delays[wid])
            return wid, next(counter)
        return sample
    return factory


def test_ordered_pool_hands_out_round_robin():
    """Batch t is worker t mod N's next one, numbered t, whichever worker
    is faster."""
    pool = WorkerPool(_counting_factory([0.0, 0.02, 0.0]), n_workers=3, depth=3,
                      ordered=True)
    got = [pool.get_numbered(timeout=WAIT_S) for _ in range(12)]
    more = [pool.get(timeout=WAIT_S) for _ in range(3)]
    pool.close()
    assert got == [(t, (t % 3, t // 3)) for t in range(12)]
    assert more == [(0, 4), (1, 4), (2, 4)]
    assert not any(t.is_alive() for t in pool.threads)


def test_ordered_pool_one_full_queue_does_not_deadlock():
    """Worker 0 is fast and fills its own queue while the consumer waits
    on slow worker 1: the round-robin goes on, nothing is dropped or
    reordered, and the fast worker waits for room (producer wait)."""
    pool = WorkerPool(_counting_factory([0.0, 0.05]), n_workers=2, depth=2,
                      ordered=True)
    time.sleep(0.2)  # worker 0's queue (one batch) is full, it blocks in put
    assert pool.queues[0].full()
    got = [pool.get(timeout=WAIT_S) for _ in range(8)]
    stats = pool.stats()
    pool.close()
    assert got == [(t % 2, t // 2) for t in range(8)]
    assert stats["producer_wait_s"] > 0.05 and stats["consumer_wait_s"] > 0.0


def test_ordered_pool_timeout_hands_out_nothing():
    """A get that times out on the worker whose turn it is consumes no
    sequence number: the next get returns that worker's batch, numbered
    as the one that timed out would have been."""
    release = threading.Event()

    def factory(wid):
        def sample():
            if wid == 1:
                release.wait(WAIT_S)
            return wid
        return sample

    pool = WorkerPool(factory, n_workers=2, depth=2, ordered=True)
    assert pool.get_numbered(timeout=WAIT_S) == (0, 0)
    with pytest.raises(queue.Empty):
        pool.get_numbered(timeout=0.05)
    release.set()
    assert pool.get_numbered(timeout=WAIT_S) == (1, 1)
    assert pool.get_numbered(timeout=WAIT_S) == (2, 0)
    pool.close()


def test_ordered_pool_close_joins_blocked_workers():
    """Every worker blocked in put on its full queue exits on close()."""
    pool = WorkerPool(lambda wid: (lambda: wid), n_workers=4, depth=4, ordered=True)
    time.sleep(0.2)
    assert all(q.full() for q in pool.queues) and pool.qsize() == 4
    t0 = time.monotonic()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a shutdown warning = failure
        pool.close()
    assert time.monotonic() - t0 < 2.0
    assert not any(t.is_alive() for t in pool.threads)


def test_ordered_pool_reraises_a_sampler_failure_in_turn():
    """Worker 1 fails at its second batch: the consumer gets batches 0-2
    in order, then the failure at batch 3 (worker 1's turn), and every
    later get raises too."""
    def factory(wid):
        counter = iter(range(1 if wid == 1 else 10_000))
        return lambda: (wid, next(counter))

    pool = WorkerPool(factory, n_workers=2, depth=4, ordered=True)
    got = [pool.get(timeout=WAIT_S) for _ in range(3)]
    assert got == [(0, 0), (1, 0), (0, 1)]
    with pytest.raises(RuntimeError, match="sampler thread failed") as err:
        pool.get(timeout=WAIT_S)
    assert isinstance(err.value.__cause__, StopIteration)
    with pytest.raises(RuntimeError, match="sampler thread failed"):
        pool.get(timeout=WAIT_S)
    pool.close()
    assert not any(t.is_alive() for t in pool.threads)


def test_free_pool_numbers_batches_in_arrival_order():
    """The default pool keeps one shared queue; get_numbered counts the
    batches handed out, peeked ones included once."""
    pool = WorkerPool(_counting_factory(), n_workers=2, depth=2)
    assert len(pool.queues) == 1
    assert pool.get_numbered(timeout=WAIT_S)[0] == 0
    peeked = pool.peek(timeout=WAIT_S)
    assert pool.get_numbered(timeout=WAIT_S) == (1, peeked)
    assert pool.get_numbered(timeout=WAIT_S)[0] == 2
    pool.close()
