"""The step loop of the port's drivers, with behavior injected as hooks.

A port of the single-trainer part of the JAX package's launch/engine.py:

    state = train_loop(step_fn, state, make_batch, n_steps,
                       hooks=[LoggingHook(...), MetricsHook(...)])

``make_batch() -> (batch, stats)`` runs on the Prefetcher's producer thread,
overlapping host-side sampling (and the host-to-device copy of the batch)
with device compute. ``step_fn(state, batch) -> (state, metrics)``; the
metrics are 0-d tensors. PyTorch launches CUDA work asynchronously, so the
loop never waits for the card: only hooks read metric values, and only at
their cadence (``LoggingHook`` every ``log_every`` steps; ``MetricsHook``
keeps the tensors and reads them when its history is asked for).

Hooks see every step after it is issued: ``on_step(i, state, metrics,
stats)`` with ``i`` the 1-based step number, then ``on_end(i, state)`` once.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, List, Sequence

import torch

from repro_torch.common import telemetry
from repro_torch.data.pipeline import Prefetcher


class Hook:
    """Base hook: all callbacks optional no-ops."""

    def on_step(self, i: int, state, metrics, stats) -> None:
        pass

    def on_end(self, i: int, state) -> None:
        pass


class LoggingHook(Hook):
    """Periodic loss/throughput lines; reading the loss synchronises with the
    card, once every ``log_every`` steps.

    If the step metrics carry ``pend_dropped`` > 0 (capacity-bounded T5
    defer losing updates), the first occurrence raises a one-shot
    ``RuntimeWarning`` and the count is appended to every log line.
    """

    def __init__(self, log_every: int = 100, batch_size: int = 0,
                 print_fn: Callable[[str], None] = print):
        self.log_every = max(1, log_every)
        self.batch_size = batch_size
        self.print_fn = print_fn
        self.t0 = None
        self.pend_dropped = 0.0
        self._warned_pend = False

    def on_step(self, i, state, metrics, stats):
        if self.t0 is None:
            self.t0 = time.perf_counter()
        if i % self.log_every:
            return
        loss = float(metrics["loss"])  # waits for the step's device work
        dt = max(time.perf_counter() - self.t0, 1e-9)
        line = f"step {i:6d} loss {loss:8.4f} ({i/dt:6.1f} steps/s"
        if self.batch_size:
            line += f", {i*self.batch_size/dt:9.0f} triplets/s"
        if "pend_dropped" in metrics:
            self.pend_dropped = float(metrics["pend_dropped"])
            if self.pend_dropped > 0 and not self._warned_pend:
                self._warned_pend = True
                warnings.warn(
                    f"deferred-update pend buffer overflowed: "
                    f"{self.pend_dropped:.0f} unique rows dropped by step {i} "
                    "— their gradient updates are LOST. Increase pend_slots.",
                    RuntimeWarning, stacklevel=2)
            if self.pend_dropped > 0:
                line += f", pend_drop {self.pend_dropped:.0f}"
        self.print_fn(line + ")")


class MetricsHook(Hook):
    """Record scalar metrics per step — used by tests, benchmarks and the
    chip smoke run.

    Values are kept as they come (0-d tensors stay on the device, so
    recording never waits for the card) and converted to floats when
    ``history`` is read. A key absent from a step's metrics records ``nan``.
    """

    def __init__(self, keys: Sequence[str] = ("loss",)):
        self.keys = tuple(keys)
        self._raw: Dict[str, List[object]] = {k: [] for k in self.keys}

    def on_step(self, i, state, metrics, stats):
        for k in self.keys:
            v = None if metrics is None else metrics.get(k)
            if torch.is_tensor(v):
                v = v.detach()
            self._raw[k].append(float("nan") if v is None else v)

    @property
    def history(self) -> Dict[str, List[float]]:
        return {k: [float(v) for v in vals] for k, vals in self._raw.items()}


def train_loop(step_fn, state, make_batch, n_steps: int, *,
               hooks: Sequence[Hook] = ()):
    """Drive ``step_fn`` for steps 1..``n_steps``.

    make_batch() -> (batch, stats); stats may be None. Batches are produced
    ahead on a host thread.
    """
    src = Prefetcher(make_batch)
    i = 0
    try:
        for i, (batch, stats) in zip(range(1, n_steps + 1), src):
            with telemetry.span("engine/step"):
                state, metrics = step_fn(state, batch)
            for h in hooks:
                h.on_step(i, state, metrics, stats)
    finally:
        src.close()
    for h in hooks:
        h.on_end(i, state)
    return state
