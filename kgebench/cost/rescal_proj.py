"""The work of one launch of the rescal_proj kernels (``csrc/rescal_proj.cu``).

Frozen copy of ``rescal_proj_cost`` in ``src/repro_torch/kernels/rescal_proj/cost.py``
at commit 303e0ce; f32, all on the fp32 units. Forward: the b matrices of
d x r floats and h, t in, ph and pt out; two multiply-adds an element of
the matrices (4 operations). Backward: the matrices, h, t, dph and dpt in,
dh, dt and dm out; two multiply-adds and dm's two products and sum an
element (7 operations).
"""

from __future__ import annotations

from kgebench.cost import KernelCost


def rescal_proj_cost(b: int, d: int, r: int, backward: bool = False) -> KernelCost:
    n, vecs = b * d * r, b * (d + r)
    if backward:
        return KernelCost("rescal_proj_bwd", 7 * n, 4 * (2 * n + 3 * vecs))
    return KernelCost("rescal_proj_fwd", 4 * n, 4 * (n + 2 * vecs))
