"""The work of the flash-attention kernel (csrc/flash_attention.cu), read
by the wrapper (``ops.py``) and by ``chip_smoke.py``'s bounds.

Operations: 4 dh for every (query, key) pair the mask keeps (the score
and the P V product, two each), counted per (batch, query head); on the
bf16 tensor cores for bf16, as 3xTF32 for f32. Bytes: q, k, v read and o
written once.
"""

from __future__ import annotations

import numpy as np

from repro_torch.common.cost import KernelCost


def flash_pairs(T: int, S: int, causal: bool = True, window: int = 0,
                q_offset: int = 0) -> int:
    """(query, key) pairs of one (batch, head) that the mask keeps: key j of
    query row i (at position p = i + q_offset) when j < S, j <= p if causal
    and j > p - window if window > 0."""
    p = np.arange(T, dtype=np.int64) + q_offset
    hi = np.minimum(S - 1, p) if causal else np.full(T, S - 1, np.int64)
    lo = np.maximum(0, p - window + 1) if window > 0 else np.zeros(T, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_cost(B: int, H: int, Hkv: int, T: int, S: int, dh: int, causal: bool,
               window: int, q_offset: int, itemsize: int) -> KernelCost:
    pairs = B * H * flash_pairs(T, S, causal, window, q_offset)
    n_bytes = itemsize * 2 * (B * H * T * dh + B * Hkv * S * dh)
    return KernelCost("flash_attention", 4 * dh * pairs, n_bytes,
                      "tf32x3" if itemsize == 4 else "bf16")
