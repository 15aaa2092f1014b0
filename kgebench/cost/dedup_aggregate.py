"""The work of one launch of the dedup-aggregate kernel
(``csrc/dedup_aggregate.cu``).

Frozen copy of ``dedup_cost`` in ``src/repro_torch/kernels/sparse_adagrad/cost.py``
at commit 481f696: the ids and the grad rows in, the first-occurrence ids and
the aggregated rows out; an id compare for every slot pair and a row add a
slot, on the fp32 units.
"""

from __future__ import annotations

from kgebench.cost import KernelCost


def dedup_cost(n: int, D: int) -> KernelCost:
    return KernelCost("dedup_aggregate", n * n + n * D, 4 * (2 * n + 2 * n * D))
