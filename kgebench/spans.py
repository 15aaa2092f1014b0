"""Tie the port's telemetry spans to a torch.profiler trace, on one clock.

The port's registry (``repro_torch.common.telemetry``) writes its clock
anchor into its trace, ``otherData.clock``: ``perf_counter_ns`` and
``time_ns`` read back to back, span ``ts`` 0 at that ``perf_counter_ns``.
Kineto stamps host calls and device ops in Unix-epoch ns, ``time_ns``'s
scale, so a span starts at ``time_ns + ts`` on the profiler's clock.

A trace of the device's activity alone (CUDA, no CPU ops) still holds the
CUDA runtime's calls: each launch, memcpy and memset with its host times,
its thread (the low 32 bits of the caller's pthread id, which is Python's
``threading.get_ident()``) and the correlation id of the device op it
enqueued. So each device op is tied to the thread that launched it and to
that thread's innermost open span at the launch. A thread that records no
span is autograd's device thread: it launches the backward while the
thread that called ``torch.autograd.grad`` waits in ``step/backward``, so
its calls are put down to the trainer's innermost span at their time.

Plain tuples, so tests need no profiler, all in us from the profiler
trace's start (``trace_start_ns``):

    Op    (name, start, end, corr)            a device op
    Call  (name, start, end, thread, corr)    a runtime launch/memcpy/memset
    Span  (name, thread, start, end, args)    a span of the port
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from kgebench.trace import merged
from repro_torch.common.telemetry import profiler_ns

Op = Tuple[str, float, float, int]
Call = Tuple[str, float, float, int, int]
Span = Tuple[str, int, float, float, dict]
Piece = Tuple[float, float, str]  # start, end, the innermost open span

LAUNCH = re.compile(r"cu(da)?(Launch|Memcpy|Memset)")
THREAD = 0xFFFFFFFF  # the bits of a pthread id that Kineto keeps
# the trainer's spans around a step's phases, and the phase each times
PHASES = {"step/gather": "gather", "step/score": "score",
          "step/backward": "backward", "step/flush": "update",
          "step/apply": "update"}
LOOP = "loop"  # the trainer's time in no span: the loop and its hooks


@dataclasses.dataclass
class Profile:
    ops: List[Op]  # sorted by start
    calls: List[Call]
    start_ns: int  # the trace's start, Unix-epoch ns


def from_profiler(prof) -> Profile:
    """A finished ``torch.profiler.profile``'s device ops (the events that
    ran on the CUDA device, less user annotations' spans there, as
    ``trace.from_profiler`` keeps them) and runtime calls."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, calls = [], []
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                ops.append((e.name, s, t, e.id))
        elif LAUNCH.match(e.name):
            calls.append((e.name, s, t, e.device_resource_id & THREAD, e.id))
    return Profile(sorted(ops, key=lambda op: op[1]),
                   sorted(calls, key=lambda c: c[1]),
                   prof.profiler.kineto_results.trace_start_ns())


def clock_of(doc: dict) -> Optional[dict]:
    """The registry's clock anchor in its trace, or None (a program that
    writes none)."""
    return doc.get("otherData", {}).get("clock")


def trace_us(ts_us: float, clock: dict, start_ns: int) -> float:
    """A span's ``ts`` in us from the trace's start."""
    return (profiler_ns(ts_us, clock) - start_ns) / 1e3


def perf_to_us(perf_s: float, clock: dict, start_ns: int) -> float:
    """A ``time.perf_counter()`` reading in us from the trace's start."""
    return trace_us((perf_s * 1e9 - clock["perf_counter_ns"]) / 1e3, clock, start_ns)


def spans_of(doc: dict, start_ns: int) -> Optional[List[Span]]:
    """The complete spans of a registry's ``trace_json()``, on the trace's
    timebase, by start (an enclosing span before the spans it holds);
    None without a clock anchor."""
    clock = clock_of(doc)
    if clock is None:
        return None
    out = []
    for e in doc["traceEvents"]:
        if e.get("ph") == "X":
            s = trace_us(e["ts"], clock, start_ns)
            out.append((e["name"], e["tid"] & THREAD, s, s + e["dur"], e.get("args", {})))
    return sorted(out, key=lambda sp: (sp[2], -sp[3]))


def innermost(spans: Sequence[Span], thread: int) -> List[Piece]:
    """Disjoint pieces of ``thread``'s time, each named for the innermost
    of its spans open there; time in none of them is in no piece. Spans of
    one thread nest (they are ``with`` blocks)."""
    out: List[Piece] = []
    stack: List[Tuple[str, float]] = []  # open spans: name, end
    t = 0.0
    for name, _, s, e, _ in sorted((sp for sp in spans if sp[1] == thread),
                                    key=lambda sp: (sp[2], -sp[3])):
        while stack and stack[-1][1] <= s:
            top, end = stack.pop()
            out.append((t, end, top))
            t = end
        if stack:
            out.append((t, s, stack[-1][0]))
        stack.append((name, e))
        t = s
    while stack:
        top, end = stack.pop()
        out.append((t, end, top))
        t = end
    return [p for p in out if p[1] > p[0]]


def label_at(pieces: Sequence[Piece], starts: Sequence[float], t: float) -> str:
    """The piece holding ``t`` (``starts``: the pieces' starts), or LOOP."""
    i = bisect.bisect_right(starts, t) - 1
    return pieces[i][2] if i >= 0 and t < pieces[i][1] else LOOP


def overlap(a: Sequence[Tuple[float, float]], b: Sequence[Tuple[float, float]]) -> float:
    """Length of the intersection of two sets of disjoint sorted intervals."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


@dataclasses.dataclass
class Attribution:
    """A traced slice of the closed loop, each number a step's mean."""

    steps: int  # the trainer's engine/step spans inside the window
    window_us: float
    device_ms: Dict[str, float]  # by phase, of the ops the trainer launched
    copy_ms: float  # ops launched inside pipeline/copy, any thread
    other_ms: float  # every other op
    idle_us: Dict[str, float]  # device idle time by the trainer's innermost span
    launches: Dict[str, float]  # the trainer's calls in engine/step, by innermost span
    host_ms: Dict[str, float]  # each span name's time
    sample_overlap: float  # share of engine/step time the sampler samples
    inside: float  # share of the trainer's calls in the window inside engine/step
    outside_us: float  # the farthest such call from an engine/step span

    def metrics(self) -> Dict[str, float]:
        """The per-layer metrics these spans feed, by their names."""
        enqueue = sum(us for label, us in self.idle_us.items()
                      if label == "engine/step" or label.startswith("step/"))
        out = {f"{p}_device_ms": self.device_ms.get(p, 0.0)
               for p in ("gather", "score", "backward", "update")}
        out["idle_enqueue_share"] = 100.0 * enqueue / self.window_us
        out["idle_wait_share"] = 100.0 * self.idle_us.get("pipeline/wait", 0.0) / self.window_us
        out["launches_per_step"] = sum(self.launches.values())
        out["sample_overlap_share"] = 100.0 * self.sample_overlap
        return out


def attribute(prof: Profile, spans: Sequence[Span], w0: float, w1: float
              ) -> Optional[Attribution]:
    """Tie ``prof``'s ops and calls to ``spans`` over the window
    ``[w0, w1]`` (us, the trace's timebase); None where the spans hold no
    trainer step there. The trainer is the thread of ``engine/step``."""
    trainers = {sp[1] for sp in spans if sp[0] == "engine/step"}
    if len(trainers) != 1:
        return None
    trainer, = trainers
    steps = [sp for sp in spans if sp[0] == "engine/step" and sp[1] == trainer
             and w0 <= sp[2] and sp[3] <= w1]
    n = len(steps)
    if not n:
        return None
    pieces = {th: innermost(spans, th) for th in {sp[1] for sp in spans}}
    starts = {th: [p[0] for p in ps] for th, ps in pieces.items()}

    def owner(call: Call) -> int:
        """The thread whose span a call is put down to."""
        return call[3] if call[3] in pieces else trainer

    def label(call: Call) -> str:
        th = owner(call)
        return label_at(pieces[th], starts[th], call[1])

    by_corr = {c[4]: c for c in prof.calls}
    device: Dict[str, float] = collections.defaultdict(float)
    copy = other = 0.0
    for _, s, e, corr in prof.ops:
        call = by_corr.get(corr)
        where = label(call) if call is not None else LOOP
        if call is not None and owner(call) == trainer and where in PHASES:
            device[PHASES[where]] += e - s
        elif where == "pipeline/copy":
            copy += e - s
        else:
            other += e - s

    step_iv = [(sp[2], sp[3]) for sp in steps]
    step_starts = [iv[0] for iv in step_iv]
    launches: Dict[str, float] = collections.defaultdict(float)
    inside, far = 0, 0.0
    mine = [c for c in prof.calls if owner(c) == trainer and w0 <= c[1] <= w1]
    for c in mine:
        i = bisect.bisect_right(step_starts, c[1]) - 1
        if i >= 0 and c[1] < step_iv[i][1]:
            inside += 1
            launches[label(c)] += 1.0 / n
        else:
            gaps = [c[1] - step_iv[i][1]] if i >= 0 else []
            if i + 1 < n:
                gaps.append(step_iv[i + 1][0] - c[1])
            far = max(far, min(gaps))

    busy = [(max(s, w0), min(e, w1)) for s, e in merged([op[:3] for op in prof.ops])
            if e > w0 and s < w1]
    idle_iv, t = [], w0
    for s, e in busy:
        if s > t:
            idle_iv.append((t, s))
        t = max(t, e)
    if t < w1:
        idle_iv.append((t, w1))
    idle: Dict[str, float] = collections.defaultdict(float)
    idle_starts = [iv[0] for iv in idle_iv]
    for s, e, name in pieces[trainer]:
        k = max(bisect.bisect_right(idle_starts, s) - 1, 0)
        while k < len(idle_iv) and idle_iv[k][0] < e:
            idle[name] += max(0.0, min(e, idle_iv[k][1]) - max(s, idle_iv[k][0]))
            k += 1
    idle[LOOP] += sum(e - s for s, e in idle_iv) - sum(idle.values())

    host: Dict[str, float] = collections.defaultdict(float)
    for name, _, s, e, _ in spans:
        if w0 <= s and e <= w1:
            host[name] += (e - s) / 1e3 / n
    sampling = merged([("", sp[2], sp[3]) for sp in spans if sp[0] == "pipeline/sample"])
    return Attribution(
        steps=n, window_us=w1 - w0,
        device_ms={p: us / 1e3 / n for p, us in device.items()},
        copy_ms=copy / 1e3 / n, other_ms=other / 1e3 / n, idle_us=dict(idle),
        launches=dict(launches), host_ms=dict(host),
        sample_overlap=overlap(step_iv, sampling) / sum(e - s for s, e in step_iv),
        inside=inside / len(mine) if mine else 1.0, outside_us=far)


DROPPED = "telemetry/trace_events_dropped"  # the registry's count of lost spans


def slice_attribution(prof: Profile, doc: dict, tp0: float, tp1: float,
                      dropped: float = 0.0
                      ) -> Tuple[Optional[List[Span]], Optional[Attribution]]:
    """A traced slice from ``tp0`` to ``tp1`` (``time.perf_counter()``
    readings at its two syncs): the spans of the registry's ``trace_json()``
    ``doc`` that overlap it, on ``prof``'s timebase, and ``attribute`` over
    it. (None, None) without a clock anchor; the attribution is None where
    the registry lost spans (``dropped`` > 0), so a truncated trace cannot
    read as a short phase."""
    clock = clock_of(doc)
    if clock is None:
        return None, None
    every = spans_of(doc, prof.start_ns)
    w0, w1 = (perf_to_us(t, clock, prof.start_ns) for t in (tp0, tp1))
    inside = [sp for sp in every if sp[3] > w0 and sp[2] < w1]
    return inside, None if dropped > 0 else attribute(prof, every, w0, w1)


def metric_reader(name: str):
    """The reader of the per-layer metric ``name`` of ``Attribution.metrics``
    (``metrics/<name>.py``): None where the run has no attribution."""
    def read(rec):
        return None if rec.phases is None else rec.phases.metrics()[name]
    return read
