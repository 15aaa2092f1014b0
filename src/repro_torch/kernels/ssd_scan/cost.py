"""The work of the SSD-scan kernel (csrc/ssd_scan.cu), read by the wrapper
(``ops.py``) and by ``chip_smoke.py``'s bounds; f32, the products as
3xTF32 on the tensor cores.

Operations at the kernel's chunks (``CHUNK`` rows), each as long as T
makes it, counting (as flash does) only the pairs the causal mask keeps:
per (sequence, chunk) of k rows the Gram matrix's lower triangle once,
k (k + 1) N, and per head the intra-chunk product over the same triangle,
k (k + 1) P; the inter-chunk product, 2 k N P, for every chunk but the
first (the state is 0 there) and the state update, 2 k P N, for every
chunk but the last (nothing reads it). Bytes: x and y, dt, B and C, A.
"""

from __future__ import annotations

from repro_torch.common.cost import KernelCost

CHUNK = 64  # the kernel's chunk rows (csrc/ssd_scan.cu)


def ssd_ops(B: int, T: int, H: int, P: int, N: int) -> int:
    rows = [min(CHUNK, T - t0) for t0 in range(0, T, CHUNK)]
    tri = sum(k * (k + 1) * (N + H * P) for k in rows)
    carried = sum(rows[1:]) + sum(rows[:-1])  # rows that meet a carried state
    return B * (tri + H * 2 * N * P * carried)


def ssd_cost(B: int, T: int, H: int, P: int, N: int) -> KernelCost:
    n_bytes = 4 * (2 * B * T * H * P + B * T * H + 2 * B * T * N + H)
    return KernelCost("ssd_scan", ssd_ops(B, T, H, P, N), n_bytes, "tf32x3")
