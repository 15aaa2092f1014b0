"""Process-wide telemetry for the port: metrics registry + phase tracer.

A copy of the JAX package's common/telemetry.py (the port imports nothing
of that package), under the same metric names and file formats, so a file
either package writes passes either package's validators (but for the
port's own ``PORT_METRICS``, which only this module's accept):

* ``MetricsRegistry`` — thread-safe counters / gauges / histograms. All
  recording goes through the module-level helpers (``inc``/``gauge``/
  ``observe``/``span``/``trace_inc``), which dispatch to the active registry.
  The default registry is **disabled**: every helper is one attribute check
  and a return, so instrumented hot paths (WorkerPool producers, Hogwild
  trainer threads) cost nothing unless telemetry is switched on.
* ``span()`` — a context manager that records one Chrome-trace "complete"
  event (``ph: "X"``) per block. ``write_trace`` emits the standard Chrome
  trace-event JSON (load it at https://ui.perfetto.dev). Tracks are threads:
  each Hogwild trainer (``trainer-N``) and each WorkerPool producer
  (``sampler-N``) gets its own named track via thread-name metadata events.
* ``trace_inc()`` — static per-step accounting (volumes known from shapes,
  such as KVStore rows and bytes a step). In the JAX package it fires once,
  at trace time; the port has no jit, so it fires every step it is called
  and ``launch/engine.TelemetryHook``'s drain yields true per-step values.

PyTorch launches CUDA work asynchronously: a span around device work times
its enqueue unless the block ends in a synchronize. Timing is
``time.perf_counter`` throughout (monotonic). A span may carry ``args``
(``span("engine/step", step=i)``), written into its event.

One clock with the device trace: each registry reads ``perf_counter_ns``
and ``time_ns`` back to back when it starts (``clock``), and span ``ts`` 0
is that ``perf_counter_ns`` reading. torch.profiler (Kineto) stamps host
calls and device ops in Unix-epoch ns, ``time_ns``'s scale, so
``profiler_ns`` puts a span's ``ts`` on the profiler's timebase;
``trace_json`` writes the pair under ``otherData.clock``.

Metric-name stability: every name is listed in ``KNOWN_METRICS`` (exact) or
``KNOWN_PREFIXES`` (families), the JAX package's table (docs/TELEMETRY.md),
or in ``PORT_METRICS``, the port's own (the RESCAL route counters).
The validators (``validate_metrics_jsonl`` / ``validate_trace``) reject
unknown names. Run them from the command line:

    python -m repro_torch.common.telemetry METRICS.jsonl [TRACE.json]
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# schema: every stable metric name, with meaning. docs/TELEMETRY.md mirrors
# this table; CI validates emitted files against it.
# ---------------------------------------------------------------------------
KNOWN_METRICS: Dict[str, str] = {
    # engine / runtime (host-side, exact)
    "engine/steps": "counter: completed train-loop steps seen by TelemetryHook",
    "runtime/steps": "counter: steps completed by Hogwild trainer threads",
    "runtime/stale_steps": "counter: Hogwild steps whose grads were computed "
                           "against a store older than the one they applied to",
    "runtime/staleness": "histogram: per stale step, how many other swaps "
                         "landed between this trainer's read and its apply",
    # host data pipeline (exact; mirrors WorkerPool.stats())
    "pipeline/produced": "counter: batches produced across all sampler workers",
    "pipeline/producer_wait_s": "counter(seconds): producers blocked on a "
                                "full queue (consumer is the bottleneck)",
    "pipeline/consumer_wait_s": "counter(seconds): consumers blocked on an "
                                "empty queue (sampling is the bottleneck)",
    "pipeline/queue_depth": "gauge: bounded batch-queue depth at last update",
    # embedding stores
    "store/flush_calls": "counter: non-empty pend-buffer flushes (per trace "
                         "under jit, per call in eager code)",
    "store/pend_dropped": "counter: unique rows dropped by the "
                          "capacity-bounded T5 defer, sampled from the "
                          "step metric at TelemetryHook snapshot cadence",
    # KVStore comm accounting (static per-machine per-step volumes,
    # discovered at trace time via trace_inc; capacity slots incl. pads)
    "kvstore/local_rows": "counter: rows gathered via the local fast path",
    "kvstore/local_rows_per_step": "gauge: same, per step",
    "kvstore/pull_rows": "counter: remote row-slots pulled over the wire",
    "kvstore/pull_rows_per_step": "gauge: same, per step",
    "kvstore/pull_bytes": "counter: ICI bytes moved by remote pulls "
                          "(request ids + returned rows, wire dtype)",
    "kvstore/pull_bytes_per_step": "gauge: same, per step",
    "kvstore/push_rows": "counter: remote grad row-slots pushed to owners",
    "kvstore/push_rows_per_step": "gauge: same, per step",
    "kvstore/push_bytes": "counter: ICI bytes moved by remote grad pushes",
    "kvstore/push_bytes_per_step": "gauge: same, per step",
    # pipelined pull prefetch (--pipeline-depth 1): the lookahead pull for
    # batch t+1, issued before the push/apply of batch t
    "kvstore/prefetch_rows": "counter: remote row-slots pulled by the "
                             "pipelined one-step lookahead",
    "kvstore/prefetch_rows_per_step": "gauge: same, per step",
    "kvstore/prefetch_bytes": "counter: ICI bytes moved by prefetch pulls",
    "kvstore/prefetch_bytes_per_step": "gauge: same, per step",
    # micro-batched coalesced push (--push-every K): one deduplicated
    # all_to_all flushes K steps' remote grads
    "kvstore/coalesced_push_rows": "counter: remote grad row-slots moved by "
                                   "coalesced-push flushes",
    "kvstore/coalesced_push_rows_per_flush": "gauge: same, per flush",
    "kvstore/coalesced_push_bytes": "counter: ICI bytes moved by "
                                    "coalesced-push flushes",
    "kvstore/coalesced_push_bytes_per_flush": "gauge: same, per flush",
    "kvstore/coalesced_push_flushes": "counter: coalesced-push flush "
                                      "programs run (one per K steps, plus "
                                      "a final partial-window flush)",
    "kvstore/coalesced_push_dropped": "counter: unique rows dropped by the "
                                      "capacity-bounded coalesce buffers, "
                                      "sampled from the step metric at "
                                      "TelemetryHook snapshot cadence",
    # optimizer dispatch (trace-time decisions)
    "optim/dispatch_fused": "counter: sparse_adagrad_apply traces that chose "
                            "the fused Pallas kernel path",
    "optim/dispatch_jnp": "counter: sparse_adagrad_apply traces that chose "
                          "the jnp sort/segment/scatter path",
    # step metrics sampled by TelemetryHook at snapshot cadence
    "step/loss": "gauge: loss at the last snapshot step",
    "step/pos_score": "gauge: mean positive score at the last snapshot step",
    "step/neg_score": "gauge: mean negative score at the last snapshot step",
    "step/pend_dropped": "gauge: pend-buffer rows dropped by the snapshot "
                         "step (cumulative over a store's lifetime)",
    "step/push_dropped": "gauge: coalesce-buffer rows dropped by the "
                         "snapshot step (--push-every overflow)",
    # sampler-side stats forwarded from make_batch
    "sampler/dropped": "counter: triplets dropped by capacity-bounded "
                       "distributed samplers (stats['dropped'])",
    # telemetry self-accounting
    "telemetry/trace_events_dropped": "counter: span events discarded after "
                                      "the in-memory trace buffer filled",
}

# name families with dynamic suffixes (benchmark rows, phase spans)
KNOWN_PREFIXES = ("bench/",)

# names of code that only the port has: the validators here accept them
# beside the JAX package's schema (a file holding them fails that package's)
PORT_METRICS: Dict[str, str] = {
    "scores/rescal_proj_fused": "counter: RESCAL steps whose projection "
                                "products took one op over the workspace "
                                "rows (kernels/rescal_proj)",
    "scores/rescal_proj_einsum": "counter: RESCAL steps that scored through "
                                 "the einsums over per-triplet copies (a "
                                 "model group, or a lowering that does not "
                                 "state rel_slot_is_arange)",
}

_PID = os.getpid()


class _NullSpan:
    """Shared no-op context manager — the disabled-telemetry span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_reg", "_name", "_args", "_t0")

    def __init__(self, reg: "MetricsRegistry", name: str, args: dict):
        self._reg = reg
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        reg = self._reg
        ev = {
            "name": self._name, "ph": "X", "pid": _PID,
            "tid": threading.get_ident(),
            "ts": (self._t0 - reg._t0) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
        }
        if self._args:
            ev["args"] = self._args
        reg._emit_event(ev)
        return False


class MetricsRegistry:
    """Thread-safe counters / gauges / histograms + Chrome-trace events.

    All mutation goes through one lock; reads used on hot paths (``enabled``,
    ``trace_on``) are plain attribute loads. ``max_events`` bounds trace
    memory — past it, events are counted into
    ``telemetry/trace_events_dropped`` instead of stored.
    """

    def __init__(self, enabled: bool = True, trace: bool = False,
                 max_events: int = 500_000):
        self.enabled = enabled
        self.trace_on = trace
        self.max_events = max_events
        self._lock = threading.Lock()
        # the clock anchor: span ts 0 is this perf_counter reading
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        self.clock = {"perf_counter_ns": (p0 + p1) // 2, "time_ns": wall}
        self._t0 = self.clock["perf_counter_ns"] / 1e9
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self._hists: Dict[str, list] = {}  # name -> [count, total, min, max]
        self._statics: Dict[str, float] = {}  # pending static increments
        self._events: list = []
        self._tracks: Dict[int, str] = {}  # tid -> label

    # ---- recording --------------------------------------------------------
    def inc(self, name: str, n: float = 1.0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + n

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = [0, 0.0, math.inf, -math.inf]
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)

    def trace_inc(self, name: str, n: float) -> None:
        """Static per-step increment (see module docstring), buffered until
        ``drain_statics``."""
        if not self.enabled:
            return
        with self._lock:
            self._statics[name] = self._statics.get(name, 0.0) + n

    def drain_statics(self) -> Dict[str, float]:
        if not self._statics:  # benign unlocked fast path
            return {}
        with self._lock:
            out, self._statics = self._statics, {}
        return out

    # ---- tracing ----------------------------------------------------------
    def span(self, name: str, **args):
        if not (self.enabled and self.trace_on):
            return _NULL_SPAN
        return _Span(self, name, args)

    def set_track_name(self, label: str, tid: Optional[int] = None) -> None:
        if not (self.enabled and self.trace_on):
            return
        with self._lock:
            self._tracks[tid or threading.get_ident()] = label

    def _emit_event(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.counters["telemetry/trace_events_dropped"] = (
                    self.counters.get("telemetry/trace_events_dropped", 0.0) + 1)
                return
            tid = ev["tid"]
            if tid not in self._tracks:
                self._tracks[tid] = threading.current_thread().name
            self._events.append(ev)

    # ---- export -----------------------------------------------------------
    def snapshot(self, step: Optional[int] = None, **extra) -> dict:
        """One self-contained metrics record — the JSONL line schema and the
        ``BENCH_*.json`` schema are both exactly this dict."""
        with self._lock:
            out = {
                "ts": time.time(),
                "uptime_s": time.perf_counter() - self._t0,
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "hists": {
                    k: {"count": h[0], "sum": h[1], "min": h[2], "max": h[3],
                        "mean": (h[1] / h[0]) if h[0] else 0.0}
                    for k, h in self._hists.items()
                },
            }
        if step is not None:
            out["step"] = step
        out.update(extra)
        return out

    def trace_json(self) -> dict:
        with self._lock:
            meta = [
                {"name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
                 "args": {"name": label}}
                for tid, label in sorted(self._tracks.items())
            ]
            events = list(self._events)
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"clock": dict(self.clock)}}

    def write_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.trace_json(), f)
            f.write("\n")


# ---------------------------------------------------------------------------
# the process-wide registry + module-level fast helpers
# ---------------------------------------------------------------------------
_REGISTRY = MetricsRegistry(enabled=False)


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, reg
    return prev


def enable(trace: bool = False) -> MetricsRegistry:
    """Install a fresh enabled registry (optionally collecting trace spans)."""
    set_registry(MetricsRegistry(enabled=True, trace=trace))
    return _REGISTRY


def disable() -> None:
    set_registry(MetricsRegistry(enabled=False))


def enabled() -> bool:
    return _REGISTRY.enabled


@contextlib.contextmanager
def active(trace: bool = False):
    """Temporarily enabled registry (tests, benchmark overhead probes)."""
    prev = set_registry(MetricsRegistry(enabled=True, trace=trace))
    try:
        yield _REGISTRY
    finally:
        set_registry(prev)


def inc(name: str, n: float = 1.0) -> None:
    _REGISTRY.inc(name, n)


def gauge(name: str, value: float) -> None:
    _REGISTRY.gauge(name, value)


def observe(name: str, value: float) -> None:
    _REGISTRY.observe(name, value)


def trace_inc(name: str, n: float) -> None:
    _REGISTRY.trace_inc(name, n)


def span(name: str, **args):
    return _REGISTRY.span(name, **args)


def profiler_ns(ts_us: float, clock: dict) -> int:
    """A span's ``ts`` (us from its registry's start) in Unix-epoch ns, the
    timebase torch.profiler stamps its events with; ``clock`` is the
    registry's ``clock`` (a trace file's ``otherData.clock``)."""
    return clock["time_ns"] + round(ts_us * 1e3)


def set_track_name(label: str) -> None:
    _REGISTRY.set_track_name(label)


def snapshot(step: Optional[int] = None, **extra) -> dict:
    return _REGISTRY.snapshot(step=step, **extra)


def write_trace(path: str) -> None:
    _REGISTRY.write_trace(path)


# ---------------------------------------------------------------------------
# schema validation (CI smoke leg; see docs/TELEMETRY.md)
# ---------------------------------------------------------------------------
def _check_name(name: str) -> None:
    if name in KNOWN_METRICS or name in PORT_METRICS:
        return
    if any(name.startswith(p) for p in KNOWN_PREFIXES):
        return
    raise ValueError(
        f"unknown metric name {name!r}: add it to telemetry.KNOWN_METRICS "
        "and docs/TELEMETRY.md (renames are schema breaks)")


def validate_metrics_jsonl(path: str, require: tuple = ("engine/steps",)) -> int:
    """Validate a ``--metrics-out`` JSONL file. Returns the line count.

    Checks: every line parses and carries the snapshot schema; every metric
    name is documented; counters are monotone non-decreasing across lines;
    ``require`` names appear in the final snapshot's counters.
    """
    prev: Dict[str, float] = {}
    n = 0
    last = None
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            for section in ("counters", "gauges", "hists"):
                if section not in rec:
                    raise ValueError(f"{path}:{ln}: missing {section!r}")
                for name in rec[section]:
                    _check_name(name)
            for name, v in rec["counters"].items():
                if v < prev.get(name, 0.0) - 1e-9:
                    raise ValueError(
                        f"{path}:{ln}: counter {name!r} decreased "
                        f"({prev[name]} -> {v})")
                prev[name] = v
            last = rec
            n += 1
    if n == 0:
        raise ValueError(f"{path}: no snapshots")
    for name in require:
        if name not in last["counters"]:
            raise ValueError(f"{path}: required counter {name!r} missing "
                             "from the final snapshot")
    return n


def validate_trace(path: str) -> int:
    """Validate a ``--trace-out`` Chrome trace file. Returns the event count.

    Checks it parses, is the ``traceEvents`` envelope, contains at least one
    complete ("X") span with the required fields, and names its tracks.
    """
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a Chrome trace (no traceEvents list)")
    n_spans = 0
    n_meta = 0
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            n_meta += 1
            continue
        for field in ("name", "pid", "tid", "ts"):
            if field not in ev:
                raise ValueError(f"{path}: event missing {field!r}: {ev}")
        if ph == "X":
            if "dur" not in ev:
                raise ValueError(f"{path}: X event missing dur: {ev}")
            n_spans += 1
    if n_spans == 0:
        raise ValueError(f"{path}: no complete ('X') span events")
    if n_meta == 0:
        raise ValueError(f"{path}: no thread_name track metadata")
    return len(events)


def _main(argv) -> int:
    if not argv:
        print("usage: python -m repro_torch.common.telemetry METRICS.jsonl [TRACE.json]")
        return 2
    n = validate_metrics_jsonl(argv[0])
    print(f"{argv[0]}: OK ({n} snapshots)")
    if len(argv) > 1:
        m = validate_trace(argv[1])
        print(f"{argv[1]}: OK ({m} trace events)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main(sys.argv[1:]))
