"""Host data pipeline: N sampler workers feeding bounded batch queues.

DGL-KE offloads sampling to CPU workers while accelerators compute (paper
§3.3) and runs several sampler/trainer processes per machine (§3.1). A port
of the JAX package's data/pipeline.py: ``WorkerPool`` runs N producer
threads over the numpy samplers; PyTorch launches CUDA work
asynchronously, so the card computes step t while the host builds (and
copies) batches t+1, t+2, ...

Backpressure contract, as in the reference: the queue is bounded
(``depth``). A sampled batch is never discarded — when the queue is full
the producer holds the batch and retries the put, so a slow consumer costs
producer waiting, not wasted sampling work. ``stats()`` exposes the three
backpressure signals (queue depth, cumulative producer wait, cumulative
consumer wait), mirrored into the telemetry registry (``pipeline/*``) when
it is enabled; each ``sample_fn`` call is a ``pipeline/sample`` span on its
worker's own trace track, and each ``get`` that finds the queue empty a
``pipeline/wait`` span on the consumer's. Both carry the batch's sequence
number (``args.batch``) where it is known when the span opens: always for
the wait; for a sample, in the ordered mode and with one worker, where
batch t is worker ``t mod N``'s; the free mode's several workers race
for the queue, so their sample spans carry ``args.worker`` instead.

Divergence from the reference: a ``sample_fn`` exception is not lost. The
worker hands it to the consumers and exits; the ``get()`` that reaches it,
and every ``get()`` after it, raises ``RuntimeError`` from it. In the JAX
package the worker thread dies and its consumer waits for a batch that
never comes.

The ordered mode (``ordered=True``) is the port's own, for the distributed
path's several trainers: every rank of a world must step the same batch
sequence, and threads reach a shared queue in an order no rank can
repeat. Each worker then fills a bounded queue of its own, and batch t is
worker ``t mod N``'s next one: with the same sample callables, built from
the same ``worker_rngs``, every process hands out one sequence. One
shared queue would deadlock there: it could fill with worker 1's batches
while batch t waits for worker 0's. The free mode keeps the reference's
single queue and arrival order.

``Prefetcher`` is the ``n_workers=1`` case.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Callable, Iterator, List, Optional

import numpy as np

from repro_torch.common import telemetry

_NOTHING = object()  # "no batch held" sentinel for the producer retry loop

# telemetry counter names keyed by the internal wait attribute
_WAIT_METRIC = {"_producer_wait": "pipeline/producer_wait_s",
                "_consumer_wait": "pipeline/consumer_wait_s"}


class _Failure:
    """A ``sample_fn`` exception, handed to the consumers to re-raise."""

    def __init__(self, exc: Exception):
        self.exc = exc


def worker_rngs(seed: int, n: int) -> List[np.random.Generator]:
    """``n`` independent, non-overlapping numpy Generators for ``n`` workers:
    ``SeedSequence(seed).spawn(n)``, the same streams as the JAX package's."""
    return [np.random.default_rng(s) for s in np.random.SeedSequence(seed).spawn(n)]


class WorkerPool:
    """N producer workers -> bounded queues with backpressure stats.

    ``factory(worker_id)`` builds each worker's zero-arg sample callable.
    Give every worker its own RNG (see ``worker_rngs``): workers run
    concurrently and must not share a numpy Generator.

    Free mode (the default): one queue of ``depth`` batches, in arrival
    order. Ordered mode: one queue of ``ceil(depth / n_workers)`` batches a
    worker, read round-robin (module docstring).

    Consume with ``get()`` / ``get_numbered()`` / iteration; several
    consumer (trainer) threads may take batches concurrently: one at a time
    holds the take lock, so sequence numbers and batches pair up.
    ``close()`` drains until every worker thread has exited.
    """

    def __init__(self, factory: Callable[[int], Callable[[], object]],
                 n_workers: int = 1, depth: int = 2, ordered: bool = False):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.ordered = ordered
        if ordered:
            per_worker = max(1, -(-depth // n_workers))
            self.queues = [queue.Queue(maxsize=per_worker) for _ in range(n_workers)]
        else:
            self.queues = [queue.Queue(maxsize=depth)]
        self._taken = 0  # batches handed out: the next one's sequence number
        self._take_lock = threading.Lock()
        self._peeked = _NOTHING  # (seq, batch) lookahead cell (see peek())
        self._failure: Optional[_Failure] = None  # the first one a get() met
        self._stop = threading.Event()
        self._stat_lock = threading.Lock()
        self._produced = 0
        self._producer_wait = 0.0
        self._consumer_wait = 0.0
        self.threads: List[threading.Thread] = []
        for wid in range(n_workers):
            q = self.queues[wid % len(self.queues)]
            th = threading.Thread(target=self._run, args=(wid, factory(wid), q),
                                  daemon=True, name=f"sampler-{wid}")
            self.threads.append(th)
        for th in self.threads:
            th.start()

    # ---- producer side -----------------------------------------------------
    def _run(self, wid: int, sample_fn: Callable[[], object], q: queue.Queue):
        n = len(self.threads)
        # the span's args: batch k of this worker is batch wid + k n where
        # the queue order is fixed (module docstring)
        args = {"batch": wid} if self.ordered or n == 1 else {"worker": wid}
        held = _NOTHING
        while not self._stop.is_set():
            if held is _NOTHING:
                try:
                    with telemetry.span("pipeline/sample", **args):
                        held = sample_fn()
                except Exception as exc:  # reported by get(), not lost here
                    held = _Failure(exc)
            try:
                # fast path: space available, no wait accounted
                q.put_nowait(held)
            except queue.Full:
                # backpressure: hold the batch and retry — re-running
                # sample_fn here would silently discard sampled work
                t0 = time.perf_counter()
                try:
                    q.put(held, timeout=0.2)
                except queue.Full:
                    self._add_wait("_producer_wait", t0)
                    continue  # still holding `held`; check stop, retry
                self._add_wait("_producer_wait", t0)
            if isinstance(held, _Failure):
                return
            held = _NOTHING
            if "batch" in args:
                args["batch"] += n
            with self._stat_lock:
                self._produced += 1
            telemetry.inc("pipeline/produced")
            telemetry.gauge("pipeline/queue_depth", self.qsize())

    def _add_wait(self, attr: str, t0: float):
        dt = time.perf_counter() - t0
        with self._stat_lock:
            setattr(self, attr, getattr(self, attr) + dt)
        telemetry.inc(_WAIT_METRIC[attr], dt)

    # ---- consumer side -----------------------------------------------------
    def get(self, timeout: Optional[float] = None):
        """Next batch; blocks (``queue.Empty`` on timeout). Re-raises a
        worker's ``sample_fn`` exception. Thread-safe unless ``peek()`` is in
        use (see there)."""
        return self.get_numbered(timeout)[1]

    def get_numbered(self, timeout: Optional[float] = None):
        """``(t, batch)``: the next batch and its 0-based sequence number,
        paired under the take lock. In an ordered pool batch t is worker
        ``t mod N``'s; a timeout (``queue.Empty``) hands nothing out, so the
        next call waits for the same worker."""
        with self._take_lock:
            if self._failure is not None:
                self._raise(self._failure)
            if self._peeked is not _NOTHING:
                out, self._peeked = self._peeked, _NOTHING
                return out
            q = self.queues[self._taken % len(self.queues)]
            try:
                item = q.get_nowait()
            except queue.Empty:
                t0 = time.perf_counter()
                try:
                    with telemetry.span("pipeline/wait", batch=self._taken):
                        item = q.get(timeout=timeout)
                finally:
                    self._add_wait("_consumer_wait", t0)
            if isinstance(item, _Failure):
                self._failure = item
                self._raise(item)
            seq = self._taken
            self._taken += 1
            return seq, item

    @staticmethod
    def _raise(failure: _Failure):
        raise RuntimeError("a sampler thread failed") from failure.exc

    def peek(self, timeout: Optional[float] = None):
        """One-batch lookahead: the next batch WITHOUT consuming it.

        Repeated ``peek()`` calls return the same object until the next
        ``get()``, which returns the peeked batch first. Single-consumer
        only: the lookahead cell is unlocked, so mixing ``peek()`` with
        concurrent ``get()`` from other threads can deliver one batch twice.
        The Hogwild runtime never peeks.
        """
        if self._peeked is _NOTHING:
            self._peeked = self.get_numbered(timeout)
        return self._peeked[1]

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.get()

    # ---- diagnostics / shutdown -------------------------------------------
    def qsize(self) -> int:
        """Batches waiting in the queues."""
        return sum(q.qsize() for q in self.queues)

    def stats(self) -> dict:
        """Backpressure snapshot: who is waiting on whom."""
        with self._stat_lock:
            return {
                "queue_depth": self.qsize(),
                "produced": self._produced,
                "producer_wait_s": self._producer_wait,
                "consumer_wait_s": self._consumer_wait,
            }

    def close(self, timeout: float = 2.0):
        # Producers check _stop only between put attempts, so each can hold
        # one more batch after a single drain and then block in ``put`` until
        # its 0.2 s timeout: drain repeatedly until every thread has exited.
        self._stop.set()
        deadline = time.monotonic() + timeout
        while (any(t.is_alive() for t in self.threads)
               and time.monotonic() < deadline):
            for q in self.queues:
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
            for t in self.threads:
                if t.is_alive():
                    t.join(timeout=0.05)
        stuck = [t.name for t in self.threads if t.is_alive()]
        if stuck:
            warnings.warn(
                f"{type(self).__name__} producer thread(s) {stuck} did not "
                f"exit within {timeout:.1f}s of close(); sample_fn is slow or "
                "hung — the daemon thread(s) will be abandoned", RuntimeWarning)


class Prefetcher(WorkerPool):
    """Single-producer WorkerPool: ``sample_fn`` runs ahead of the trainer."""

    def __init__(self, sample_fn: Callable[[], object], depth: int = 2):
        super().__init__(lambda _wid: sample_fn, n_workers=1, depth=depth)

    @property
    def thread(self) -> threading.Thread:
        return self.threads[0]
