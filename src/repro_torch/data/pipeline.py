"""Host data pipeline: one sampler thread feeding a bounded batch queue.

DGL-KE offloads sampling to CPU workers while accelerators compute (paper
§3.3). ``Prefetcher`` is the single-producer case of the JAX package's
data/pipeline.py ``WorkerPool``: a daemon thread runs ``sample_fn`` ahead
of the trainer, so the host builds batch t+1 while the card computes
batch t (PyTorch launches CUDA work asynchronously).

Backpressure contract, as in the reference: the queue is bounded; a sampled
batch is never discarded — when the queue is full the producer holds it
and retries. ``close()`` drains until the thread exits.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Callable

from repro_torch.common import telemetry

_NOTHING = object()  # "no batch held" sentinel for the producer retry loop


class _Failure:
    """A ``sample_fn`` exception, handed to the consumer to re-raise."""

    def __init__(self, exc: Exception):
        self.exc = exc


class Prefetcher:
    """``sample_fn`` on a producer thread -> bounded queue of ``DEPTH``.

    Consume with ``get()`` or iteration; call ``close()`` when done.
    """

    DEPTH = 2  # batches sampled ahead of the trainer
    CLOSE_TIMEOUT_S = 2.0

    def __init__(self, sample_fn: Callable[[], object]):
        self.q: queue.Queue = queue.Queue(maxsize=self.DEPTH)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(sample_fn,),
                                       daemon=True, name="sampler-0")
        self.thread.start()

    def _run(self, sample_fn: Callable[[], object]):
        held = _NOTHING
        while not self._stop.is_set():
            if held is _NOTHING:
                try:
                    with telemetry.span("pipeline/sample"):
                        held = sample_fn()
                except Exception as exc:  # reported by get(), not lost here
                    held = _Failure(exc)
            try:
                self.q.put(held, timeout=0.2)
            except queue.Full:
                continue  # still holding `held`; check stop, retry
            if isinstance(held, _Failure):
                return
            held = _NOTHING
            telemetry.inc("pipeline/produced")

    def get(self):
        """Next batch; re-raises an exception of ``sample_fn``."""
        item = self.q.get()
        if isinstance(item, _Failure):
            raise RuntimeError("the sampler thread failed") from item.exc
        return item

    def __iter__(self):
        return self

    def __next__(self):
        return self.get()

    def close(self):
        # the producer checks _stop only between put attempts, so drain
        # repeatedly until it has actually exited
        self._stop.set()
        deadline = time.monotonic() + self.CLOSE_TIMEOUT_S
        while self.thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.05)
        if self.thread.is_alive():
            warnings.warn(
                f"Prefetcher thread did not exit within "
                f"{self.CLOSE_TIMEOUT_S:.1f}s of "
                "close(); sample_fn is slow or hung — the daemon thread will "
                "be abandoned", RuntimeWarning)
