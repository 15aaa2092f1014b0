"""The work of the sparse-Adagrad kernels (csrc/dedup_aggregate.cu,
csrc/fused_update.cu), read by the wrappers (``ops.py``) and by
``chip_smoke.py``'s bounds; f32 rows, int32 ids, all on the fp32 units.

dedup_aggregate: the ids and the grad rows in, the first-occurrence ids
and the aggregated rows out; an id compare for every slot pair and a row
add a slot. fused_update: the ids, then for each valid slot its grad,
table and gsq rows in and two rows out, 7 operations an element. Which
slots are valid is data: the wrappers, which see no data on the host,
count every slot (``valid=None``); a caller that knows the ids passes
their count.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.common.cost import KernelCost


def dedup_cost(n: int, D: int) -> KernelCost:
    return KernelCost("dedup_aggregate", n * n + n * D, 4 * (2 * n + 2 * n * D))


def update_cost(n: int, D: int, valid: Optional[int] = None) -> KernelCost:
    v = n if valid is None else valid
    return KernelCost("fused_update", 7 * v * D, 4 * (n + 5 * v * D))
