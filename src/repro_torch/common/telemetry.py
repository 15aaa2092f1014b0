"""Process-wide telemetry for the port: counters and Chrome-trace spans.

A copy of the part of the JAX package's common/telemetry.py that the
training slice calls (``span``, ``inc``, ``enable``, ``snapshot``), under
the same metric names. The default registry is disabled, so every
instrumented call site is one attribute check. Spans time host-side phases:
PyTorch launches work asynchronously, so a span around device work measures
its enqueue unless the block ends in a synchronize.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

_PID = os.getpid()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_reg", "_name", "_t0")

    def __init__(self, reg: "MetricsRegistry", name: str):
        self._reg = reg
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        reg = self._reg
        reg._emit_event({
            "name": self._name, "ph": "X", "pid": _PID,
            "tid": threading.get_ident(),
            "ts": (self._t0 - reg._t0) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
        })
        return False


class MetricsRegistry:
    """Thread-safe counters + Chrome-trace events (bounded by ``MAX_EVENTS``)."""

    MAX_EVENTS = 500_000

    def __init__(self, enabled: bool = True, trace: bool = False):
        self.enabled = enabled
        self.trace_on = trace
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.counters: Dict[str, float] = {}
        self._events: list = []

    def inc(self, name: str, n: float = 1.0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + n

    def span(self, name: str):
        if not (self.enabled and self.trace_on):
            return _NULL_SPAN
        return _Span(self, name)

    def _emit_event(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.MAX_EVENTS:
                self.counters["telemetry/trace_events_dropped"] = (
                    self.counters.get("telemetry/trace_events_dropped", 0.0) + 1)
                return
            self._events.append(ev)

    def snapshot(self, step: Optional[int] = None) -> dict:
        with self._lock:
            out = {
                "ts": time.time(),
                "uptime_s": time.perf_counter() - self._t0,
                "counters": dict(self.counters),
                "events": len(self._events),
            }
        if step is not None:
            out["step"] = step
        return out

    def trace_json(self) -> dict:
        with self._lock:
            return {"traceEvents": list(self._events), "displayTimeUnit": "ms"}


_REGISTRY = MetricsRegistry(enabled=False)


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def enable(trace: bool = False) -> MetricsRegistry:
    """Install a fresh enabled registry (optionally collecting trace spans)."""
    global _REGISTRY
    _REGISTRY = MetricsRegistry(enabled=True, trace=trace)
    return _REGISTRY


def disable() -> None:
    global _REGISTRY
    _REGISTRY = MetricsRegistry(enabled=False)


def inc(name: str, n: float = 1.0) -> None:
    _REGISTRY.inc(name, n)


def span(name: str):
    return _REGISTRY.span(name)


def snapshot(step: Optional[int] = None) -> dict:
    return _REGISTRY.snapshot(step=step)
