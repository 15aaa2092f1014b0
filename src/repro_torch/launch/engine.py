"""The step loops of the port's drivers, with behavior injected as hooks.

A port of the JAX package's launch/engine.py:

    state = train_loop(step_fn, state, make_batch, n_steps, start=start,
                       hooks=[LoggingHook(...), CheckpointHook(...),
                              EvalHook(...), TelemetryHook(...)])
    state = run_loop(step_fn, state, n_steps, hooks=[ThroughputHook(...)])

``run_loop`` is the batch-free loop of the serve driver:
``step_fn(i, state) -> (state, metrics)`` with the 0-based step index.

``make_batch() -> (batch, stats)`` runs on the Prefetcher's producer thread,
overlapping host-side sampling (and the host-to-device copy of the batch)
with device compute. ``step_fn(state, batch) -> (state, metrics)``; the
metrics are 0-d tensors. PyTorch launches CUDA work asynchronously, so the
loop never waits for the card: only hooks read metric values, and only at
their cadence (``LoggingHook`` every ``log_every`` steps, ``TelemetryHook``
every ``every``; ``MetricsHook`` keeps the tensors and reads them when its
history is asked for).

Hooks see every step after it is issued, ``on_step(i, state, metrics,
stats)`` with ``i`` the 1-based step number, then ``on_end(i, state)``
once. ``on_end`` may return a replacement state; ``None`` keeps the current
one. (The port's T5 flush works in place on the loop's state,
``kge_model.flush_state``, so its hooks return ``None``.)

With ``n_trainers > 1`` or ``n_samplers > 1`` the loop is the Hogwild
multi-trainer runtime (launch/runtime.py, paper §3.1): M trainer threads
step one shared ``StoreSlot`` and N sampler workers feed one bounded queue.
The runtime calls every ``on_step`` holding the slot's lock, with a
monotone step counter, so hooks may keep plain mutable state without locks
of their own and read tables no apply is changing; ``stats`` also carries
``trainer`` (which trainer stepped) and ``queue_depth`` (sampler-queue
backpressure). With ``ordered`` (the distributed path) batch t comes from
sampler ``t mod N`` and step t, hooks included, runs after step t-1.
"""

from __future__ import annotations

import json
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.common import telemetry
from repro_torch.data.pipeline import Prefetcher


class Hook:
    """Base hook: all callbacks optional no-ops."""

    def on_step(self, i: int, state, metrics, stats) -> None:
        pass

    def on_end(self, i: int, state):
        return None


class LoggingHook(Hook):
    """Periodic loss/throughput lines (and the drop rate when the sampler's
    stats carry ``dropped``, as ``DistBatch.stats`` does); reading the loss
    synchronises with the card, once every ``log_every`` steps.

    If the step metrics carry ``pend_dropped`` > 0 (capacity-bounded T5
    defer losing updates), the first occurrence raises a one-shot
    ``RuntimeWarning`` and the count is appended to every log line. Rates
    count the steps after ``start`` (a resumed run's first step) and are
    aggregate across trainers (the step counter is global); under the
    multi-trainer runtime the line also reports how many trainers stepped
    and the sampler-queue depth.
    """

    def __init__(self, log_every: int = 100, batch_size: int = 0,
                 start: int = 0, print_fn: Callable[[str], None] = print):
        self.log_every = max(1, log_every)
        self.batch_size = batch_size
        self.start = start
        self.print_fn = print_fn
        self.t0 = None
        self.drops = 0
        self.saw_drops = False
        self.trainers = set()
        self.qdepth = None
        self.pend_dropped = 0.0
        self._warned_pend = False

    def on_step(self, i, state, metrics, stats):
        if self.t0 is None:
            self.t0 = time.perf_counter()
        if stats and "dropped" in stats:
            self.saw_drops = True
            self.drops += stats["dropped"]
        if stats and "trainer" in stats:
            self.trainers.add(stats["trainer"])
        if stats and "queue_depth" in stats:
            self.qdepth = stats["queue_depth"]
        if i % self.log_every:
            return
        loss = float(metrics["loss"])  # waits for the step's device work
        done = i - self.start
        dt = max(time.perf_counter() - self.t0, 1e-9)
        line = f"step {i:6d} loss {loss:8.4f} ({done/dt:6.1f} steps/s"
        if self.batch_size:
            line += f", {done*self.batch_size/dt:9.0f} triplets/s"
            if self.saw_drops:
                line += f", drop {self.drops/(done*self.batch_size):.2%}"
        if len(self.trainers) > 1:
            line += f", {len(self.trainers)} trainers, q={self.qdepth}"
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


class CheckpointHook(Hook):
    """Periodic saves; the final save is skipped if the last periodic save
    already covers the final step (no redundant duplicate checkpoint).

    ``flush_fn`` (``kge_model.flush_state``) is applied before each save so
    deferred (T5) gradients land in the checkpoint; ``save_fn(ckpt_dir, i,
    state)`` writes it (``checkpoint.save_checkpoint`` by default).
    """

    def __init__(self, ckpt_dir: str, save_every: int = 0,
                 flush_fn: Optional[Callable] = None,
                 save_fn: Optional[Callable] = None):
        if save_fn is None:
            from repro_torch.common.checkpoint import save_checkpoint

            save_fn = save_checkpoint
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.flush_fn = flush_fn
        self.save_fn = save_fn
        self.last_saved = -1

    def _save(self, i, state):
        if self.flush_fn is not None:
            state = self.flush_fn(state)
        self.save_fn(self.ckpt_dir, i, state)
        self.last_saved = i

    def on_step(self, i, state, metrics, stats):
        if self.ckpt_dir and self.save_every and i % self.save_every == 0:
            self._save(i, state)

    def on_end(self, i, state):
        if self.ckpt_dir and self.last_saved != i:
            self._save(i, state)


class EvalHook(Hook):
    """Run ``eval_fn(state)`` after the loop and, with ``eval_every``, also
    periodically during training (MRR-vs-steps curves). The final eval is
    skipped if a periodic eval already covered the final step."""

    def __init__(self, eval_fn: Callable, eval_every: int = 0):
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.last_eval = -1

    def on_step(self, i, state, metrics, stats):
        if self.eval_every and i % self.eval_every == 0:
            self.eval_fn(state)
            self.last_eval = i

    def on_end(self, i, state):
        if self.last_eval != i:
            self.eval_fn(state)


class ThroughputHook(Hook):
    """One end-of-run throughput line (serve loops).

    The clock starts at the first step, so set-up time before the loop is
    not counted. Like the JAX package's hook it reads the host clock and
    does not wait for the card: a loop that reads a result each step (the
    serve loop reads its greedy tokens) keeps the two in step.
    """

    def __init__(self, items_per_step: int = 1, label: str = "steps",
                 print_fn: Callable[[str], None] = print):
        self.items_per_step = items_per_step
        self.label = label
        self.print_fn = print_fn
        self.t0 = None

    def on_step(self, i, state, metrics, stats):
        if self.t0 is None:
            self.t0 = time.perf_counter()

    def on_end(self, i, state):
        t0 = self.t0 if self.t0 is not None else time.perf_counter()
        dt = max(time.perf_counter() - t0, 1e-9)
        self.print_fn(f"{i} steps in {dt:.2f}s -> "
                      f"{i * self.items_per_step / dt:.1f} {self.label}/s")


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


class TelemetryHook(Hook):
    """Bridge the step loop into the telemetry registry + JSONL/trace files.

    Every step (host-side only, no device sync):
      * ``engine/steps`` counter;
      * sampler ``stats`` folded in (``pipeline/queue_depth`` gauge,
        ``sampler/dropped`` counter);
      * static per-step volumes (``telemetry.trace_inc``) drained and
        replayed as sticky per-step gauges (``<name>_per_step``) plus
        accumulating counters (``<name>``).

    Every ``every`` steps (the snapshot cadence: reading the 0-d metric
    tensors synchronises with the card, so keep ``every`` near the log
    cadence):
      * scalar step metrics recorded as ``step/<key>`` gauges (missing keys
        skipped);
      * ``store/pend_dropped`` counter bumped from the sampled
        ``pend_dropped`` metric (a lower bound at coarse cadences);
      * one JSONL snapshot line appended to ``metrics_out``.

    ``on_end`` writes a final snapshot and, with ``trace_out``, the Chrome
    trace-event file (Perfetto-loadable). Inert when telemetry is disabled.
    The runtime serialises hook calls and the registry's own lock covers the
    counters, so one instance serves N trainers.
    """

    _METRIC_KEYS = ("loss", "pos_score", "neg_score", "pend_dropped",
                    "push_dropped")

    def __init__(self, metrics_out: Optional[str] = None,
                 trace_out: Optional[str] = None, every: int = 50):
        self.metrics_out = metrics_out
        self.trace_out = trace_out
        self.every = max(1, every)
        self._file = None
        self._per_step = {}

    def _snapshot(self, i, metrics):
        reg = telemetry.get_registry()
        if metrics:
            for k in self._METRIC_KEYS:
                v = metrics.get(k)
                if v is not None:
                    reg.gauge(f"step/{k}", float(v))
            pend = metrics.get("pend_dropped")
            if pend is not None:
                # the metric is cumulative over the store's lifetime;
                # accumulate the sampled values: exact at every=1, a lower
                # bound at coarser cadences (docs/TELEMETRY.md)
                reg.inc("store/pend_dropped", max(0.0, float(pend)))
            push = metrics.get("push_dropped")
            if push is not None:
                reg.inc("kvstore/coalesced_push_dropped", max(0.0, float(push)))
        if self.metrics_out:
            if self._file is None:
                self._file = open(self.metrics_out, "w")
            self._file.write(json.dumps(reg.snapshot(step=i)) + "\n")
            self._file.flush()

    def on_step(self, i, state, metrics, stats):
        reg = telemetry.get_registry()
        if not reg.enabled:
            return
        reg.inc("engine/steps")
        if stats:
            if "queue_depth" in stats:
                reg.gauge("pipeline/queue_depth", stats["queue_depth"])
            if "dropped" in stats:
                reg.inc("sampler/dropped", stats["dropped"])
        drained = reg.drain_statics()
        if drained:
            # the drained statics are the per-step volumes from here on
            self._per_step.update(drained)
        for name, v in self._per_step.items():
            reg.gauge(f"{name}_per_step", v)
            reg.inc(name, v)
        if i % self.every == 0:
            self._snapshot(i, metrics)

    def on_end(self, i, state):
        reg = telemetry.get_registry()
        if not reg.enabled:
            return
        if i % self.every != 0:  # final snapshot not already written
            self._snapshot(i, None)
        if self._file is not None:
            self._file.close()
            self._file = None
        if self.trace_out:
            reg.write_trace(self.trace_out)
        return None


def _finish(i: int, state, hooks):
    """The hooks' ``on_end``, in order; a hook that returns a state replaces
    the loop's. Returns the final state."""
    for h in hooks:
        out = h.on_end(i, state)
        if out is not None:
            state = out
    return state


def train_loop(step_fn, state, make_batch, n_steps: int, *, start: int = 0,
               hooks: Sequence[Hook] = (), prefetch: bool = True,
               n_trainers: int = 1, n_samplers: int = 1, sampler_factory=None,
               split_step=None, ordered: bool = False):
    """Drive ``step_fn`` from ``start`` (exclusive) to ``n_steps``.

    make_batch() -> (batch, stats); stats may be None. With ``prefetch``
    batches are produced ahead on a host thread; without it each is drawn
    inline, just before its step.

    ``n_trainers``/``n_samplers`` > 1 switch to the Hogwild multi-trainer
    runtime (launch/runtime.py): ``sampler_factory(worker_id)`` builds one
    sample callable per sampler worker (required for n_samplers > 1), and
    ``split_step=(grad_fn, apply_fn)`` enables stale-gradient Hogwild steps
    (without it the whole ``step_fn`` is swapped under the slot's lock).
    ``ordered`` (the distributed path) makes batch t sampler ``t mod N``'s
    and runs the steps, each with its hooks, in that order, so every rank
    of a world steps one sequence.

    A ``step_fn`` with a truthy ``lookahead`` attribute (the pipelined
    distributed runner, ``core.distributed.PipelinedDistStep``) is called as
    ``step_fn(state, batch, next_batch)``: the loop *peeks* batch t+1 from
    the prefetcher without consuming it, so the step can issue the pull for
    t+1 before the push of t. A ``step_fn.finalize`` method, when present,
    is applied to the final state before the ``on_end`` hooks (it flushes a
    partial coalesced-push window).
    """
    lookahead = bool(getattr(step_fn, "lookahead", False))
    if lookahead and (n_trainers > 1 or n_samplers > 1):
        raise ValueError(
            "pipelined lookahead step and the Hogwild multi-trainer runtime "
            "are mutually exclusive (peek() is single-consumer; the pipeline "
            "is its own overlap mechanism)")
    if n_trainers > 1 or n_samplers > 1:
        from repro_torch.launch.runtime import hogwild_train_loop

        return hogwild_train_loop(
            step_fn, state, make_batch, n_steps, start=start, hooks=hooks,
            n_trainers=n_trainers, n_samplers=n_samplers,
            sampler_factory=sampler_factory, split_step=split_step,
            ordered=ordered)
    if start >= n_steps:
        return _finish(start, state, hooks)
    if lookahead and not prefetch:
        raise ValueError(
            "pipelined lookahead step requires prefetch=True: the one-batch "
            "lookahead is WorkerPool.peek() on the prefetch queue")
    src = Prefetcher(make_batch) if prefetch else iter(make_batch, object())
    i = start
    try:
        if lookahead:
            for i in range(start + 1, n_steps + 1):
                batch, stats = src.get()
                nxt, _ = src.peek()
                with telemetry.span("engine/step", step=i):
                    state, metrics = step_fn(state, batch, nxt)
                for h in hooks:
                    h.on_step(i, state, metrics, stats)
        else:
            for i, (batch, stats) in zip(range(start + 1, n_steps + 1), src):
                with telemetry.span("engine/step", step=i):
                    state, metrics = step_fn(state, batch)
                for h in hooks:
                    h.on_step(i, state, metrics, stats)
    finally:
        if prefetch:
            src.close()
    finalize = getattr(step_fn, "finalize", None)
    if finalize is not None:
        state = finalize(state)
    return _finish(i, state, hooks)


def run_loop(step_fn, state, n_steps: int, *, start: int = 0,
             hooks: Sequence[Hook] = ()):
    """Batch-free loop: ``step_fn(i, state) -> (state, metrics)`` for
    i = start .. n_steps - 1; hooks see the 1-based step number."""
    i = start
    for i in range(start + 1, n_steps + 1):
        with telemetry.span("engine/step", step=i):
            state, metrics = step_fn(i - 1, state)
        for h in hooks:
            h.on_step(i, state, metrics, None)
    return _finish(i, state, hooks)
