"""The work of the program's kernels and of a whole step, and the least
time the card could take for it.

``pairwise.py``, ``dedup_aggregate.py`` and ``fused_update.py`` are frozen
copies of the port's ``kernels/*/cost.py`` formulas; ``step.py`` counts the
work a training step needs, whatever implements it. A bound is the larger
of the operations over their unit's data-sheet rate and the bytes over the
memory rate (``peaks.json``): counted from shapes, never from the program.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Tuple

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """``flops`` operations on ``unit`` and ``more`` (ops, unit) pairs on
    other units, which may run at the same time; ``bytes`` each input read
    once and each output written once."""

    name: str
    flops: float
    bytes: float
    unit: str = "fp32"
    more: Tuple[Tuple[float, str], ...] = ()


def peaks(kind: str) -> Dict[str, float]:
    """The data-sheet rates of the card ``torch.cuda.get_device_name()``
    calls ``kind``; raises for a card the file does not list."""
    table = json.loads(PEAKS.read_text())["cards"]
    if kind not in table:
        raise KeyError(f"peaks.json lists no rates for {kind!r}")
    return table[kind]


def bound_s(kc: KernelCost, rates: Dict[str, float]) -> float:
    """Least seconds for ``kc`` on a card with ``rates``."""
    t_ops = max([kc.flops / rates[kc.unit]]
                + [ops / rates[unit] for ops, unit in kc.more])
    return max(t_ops, kc.bytes / rates["hbm_bytes_per_s"])


def roofline_share(rec, marks, costs):
    """100 x the summed least time of the traced launches of a kernel (one
    ``KernelCost`` a launch, in launch order) over their summed profiler
    time; the launches are the traced device ops whose names hold one of
    ``marks``. None where the trace holds no such op, or not one for each
    launch."""
    if rec.trace is None or rec.rates is None:
        return None
    ops = rec.trace.by_name(*marks)
    if not ops or len(ops) != len(costs):
        return None
    t = sum(e - s for _, s, e in ops) / 1e6
    return 100.0 * sum(bound_s(kc, rec.rates) for kc in costs) / t
