"""The work of one launch of the fused row-Adagrad update
(``csrc/fused_update.cu``).

Frozen copy of ``update_cost`` in ``src/repro_torch/kernels/sparse_adagrad/cost.py``
at commit 481f696: the ids, then for each valid slot its grad, table and gsq
rows in and two rows out, 7 operations an element. ``valid`` is the number
of slots that hold a row: the unique ids of the batch the apply serves.
"""

from __future__ import annotations

from typing import Optional

from kgebench.cost import KernelCost


def update_cost(n: int, D: int, valid: Optional[int] = None) -> KernelCost:
    v = n if valid is None else valid
    return KernelCost("fused_update", 7 * v * D, 4 * (n + 5 * v * D))
