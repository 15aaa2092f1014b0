"""Reduce a torch.profiler trace to the records the metric readers read.

The profiler arithmetic is copied from ``chip_smoke.py`` (``_self_device_us``,
``trace_by_kernel``, ``step_window``) at commit 481f696: an event counts as
device time when it ran on the CUDA device and is not a user annotation's
span on the device timeline, which covers kernels counted on their own.

``Trace`` keeps plain tuples, so readers and tests need no profiler:
``device`` holds every device operation of the traced steps (kernels,
memcpy, memset) as ``(name, start_us, end_us)``.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Sequence, Tuple

Op = Tuple[str, float, float]  # name, start us, end us


@dataclasses.dataclass
class Trace:
    device: List[Op]
    steps: int  # traced steps
    window_s: float  # host clock from the sync before them to the sync after

    def by_name(self, *parts: str) -> List[Op]:
        """Device ops whose name holds any of ``parts``, in start order."""
        return sorted((op for op in self.device if any(p in op[0] for p in parts)),
                      key=lambda op: op[1])


def from_profiler(prof, steps: int, window_s: float) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``: the events that
    ran on the CUDA device, less user annotations' spans there."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device = [(e.name, float(e.time_range.start), float(e.time_range.end))
              for e in prof.events()
              if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]
    return Trace(device=sorted(device, key=lambda op: op[1]), steps=steps,
                 window_s=window_s)


def merged(ops: Sequence[Op]) -> List[Tuple[float, float]]:
    """The union of the ops' intervals, as disjoint sorted intervals."""
    out: List[List[float]] = []
    for _, s, e in sorted(ops, key=lambda op: op[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(ops: Sequence[Op]) -> float:
    """Microseconds in which at least one of ``ops`` ran."""
    return sum(e - s for s, e in merged(ops))


def total_us(ops: Sequence[Op]) -> float:
    return sum(e - s for _, s, e in ops)


def top_ops(ops: Sequence[Op], n: int = 10) -> List[List]:
    """[[name, seconds], ...]: the ``n`` names with the most device time."""
    by: Dict[str, float] = collections.defaultdict(float)
    for name, s, e in ops:
        by[name] += e - s
    best = sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [[short(name), us / 1e6] for name, us in best]


def idle_gaps(trace: Trace, n: int = 10) -> List[List]:
    """[[what the host was issuing, seconds], ...]: the device's idle gaps
    between its first and last op, summed by the op that ended each gap
    (the host was issuing it), longest first. The trace holds the device's
    activity alone, so the op that ends a gap names the host's work."""
    spans = merged(trace.device)
    starts = [op[1] for op in trace.device]  # sorted by start
    by: Dict[str, float] = collections.defaultdict(float)
    for (_, e0), (s1, _) in zip(spans, spans[1:]):
        nxt = trace.device[bisect.bisect_left(starts, s1)][0]
        by["before " + short(nxt)] += s1 - e0
    best = sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [[label, us / 1e6] for label, us in best]


def short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."
