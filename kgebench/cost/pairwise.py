"""The work of one launch of the pairwise kernel (``csrc/pairwise.cu``).

Frozen copy of ``pairwise_cost`` in ``src/repro_torch/kernels/kge_score/cost.py``
at commit 481f696. Bytes: each input read once and each output written once,
f32. Operations: the dot and l2sq product as 2 B K D on the tensor cores
(3xTF32), l2sq's norms and epilogue beside it on the fp32 units; the l1
distance as 3 an element pair on the fp32 units.
"""

from __future__ import annotations

from kgebench.cost import KernelCost

# the pairwise mode of each model's joint-negative score; None where the
# model scores its negatives without the pairwise kernel
MODE_OF = {"transe_l1": "l1", "transe_l2": "l2sq", "distmult": "dot",
           "complex": "dot", "rotate": "l2sq", "rescal": "dot", "transr": None}


def pairwise_cost(mode: str, G: int, B: int, K: int, D: int) -> KernelCost:
    """A (G, B, D) x (G, K, D) -> (G, B, K) launch."""
    n_bytes = 4 * G * (B * D + K * D + B * K)
    if mode == "l1":
        return KernelCost("pairwise_l1", 3 * G * B * K * D, n_bytes)
    more = ((G * (2 * (B + K) * D + 3 * B * K), "fp32"),) if mode == "l2sq" else ()
    return KernelCost(f"pairwise_{mode}", 2 * G * B * K * D, n_bytes, "tf32x3", more)
