"""The work of the kge_score kernels (csrc/pairwise.cu, csrc/l1_bwd.cu).

One formula for each, read by the wrappers (``ops.py``: the cost analysis
of ``launch/hlo_analysis.py``) and by ``chip_smoke.py``'s bounds. Bytes:
each input read once and each output written once, f32. Operations: the
pairwise dot and l2sq product as 2 B K D on the tensor cores (3xTF32),
l2sq's norms and epilogue beside it on the fp32 units; the l1 distance as
3 an element pair (a difference, its magnitude, the sum) on the fp32
units; the l1 backward as a sign, a product and a sum an element pair for
each product, 5 for both from one pass (the sign taken once).
"""

from __future__ import annotations

from repro_torch.common.cost import KernelCost


def pairwise_cost(mode: str, G: int, B: int, K: int, D: int) -> KernelCost:
    """A (G, B, D) x (G, K, D) -> (G, B, K) call of ``pairwise_kernel``."""
    n_bytes = 4 * G * (B * D + K * D + B * K)
    if mode == "l1":
        return KernelCost("pairwise_l1", 3 * G * B * K * D, n_bytes)
    more = ((G * (2 * (B + K) * D + 3 * B * K), "fp32"),) if mode == "l2sq" else ()
    return KernelCost(f"pairwise_{mode}", 2 * G * B * K * D, n_bytes, "tf32x3", more)


def l1_bwd_cost(G: int, B: int, K: int, D: int, need_do: bool = True,
                need_dn: bool = True) -> KernelCost:
    """A call of ``l1_bwd_kernel`` for the products it asks for: both (the
    pair launch, ``l1_bwd_pair``), d_o alone or d_n alone."""
    if need_do and need_dn:
        name, outs, ops = "l1_bwd_pair", (B + K) * D, 5
    elif need_do:
        name, outs, ops = "l1_bwd_do", B * D, 3
    else:
        name, outs, ops = "l1_bwd_dn", K * D, 3
    return KernelCost(name, ops * G * B * K * D, 4 * G * (B * D + K * D + B * K + outs))
