"""The seam between the port's programs and a cost analysis.

``launch/hlo_analysis.py`` counts a program's work op by op under a
``TorchDispatchMode``. Two kinds of work never reach a dispatch mode: a
kernel of ``csrc/`` launched through ``ctypes`` (``kernels/build.py``),
and the bytes a collective moves between ranks. So their call sites
report them here: each kernel wrapper, on CUDA and on meta tensors, hands
``ACTIVE`` its ``KernelCost`` (from the ``cost.py`` beside its
``ops.py``), and ``common/collectives.py`` each collective's kind, group
size and bytes.

``ACTIVE`` is the analysis that is counting, or None. With none, a call
site pays one module-level check (``if cost.ACTIVE is not None``) and
builds nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

ACTIVE = None  # the counting analysis (launch/hlo_analysis.CostMode) or None


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """The work one call of a kernel wrapper needs: ``flops`` operations on
    ``unit`` and ``more`` (ops, unit) pairs on other units, which may run
    at the same time; ``bytes`` each input read once and each output
    written once. Where the work depends on the data, the count is what the
    shapes allow (every slot valid), unless the caller names the data. A
    unit is one whose peak rate ``chip_smoke.py``'s bounds divide by
    (``common/hw.py``): ``fp32`` outside the tensor cores, ``tf32x3`` (TF32
    taken three times for one fp32-accurate product), ``bf16``."""

    name: str
    flops: float
    bytes: float
    unit: str = "fp32"
    more: Tuple[Tuple[float, str], ...] = ()

    @property
    def total_flops(self) -> float:
        return self.flops + sum(ops for ops, _ in self.more)
