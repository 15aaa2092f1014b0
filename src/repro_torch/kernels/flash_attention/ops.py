"""Dispatch of the flash-attention kernel (csrc/flash_attention.cu).

``flash_attention(q, k, v, causal, window, q_offset)`` takes the JAX
package's layout (kernels/flash_attention/ops.py:17-26): q (B, H, T, dh),
k and v (B, Hkv, S, dh), GQA with query head h reading kv head
h // (H // Hkv). The tensor's device picks the path: CUDA tensors go to the
kernel, which takes f32 or bf16, dh in ``HEAD_DIMS`` and H a multiple of
Hkv, or the wrapper raises; meta tensors take the same checks and get
the kernel's output as an empty meta tensor (the card's route, described
abstractly, for the dry run); CPU tensors go to the plain ``mha_ref``.
On CUDA and on meta the wrapper hands an active cost analysis the
kernel's work (``cost.flash_cost``, ``common/cost.py``). No
padding: the kernel masks ragged T and S itself. The TPU wrapper's tile
sizes (bq, bkv) are not arguments: the kernel picks its own tiles.
"""

from __future__ import annotations

import torch

from repro_torch.common import cost
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.cost import flash_cost
from repro_torch.kernels.flash_attention.ref import mha_ref

HEAD_DIMS = (32, 64, 80, 128)  # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_kernel(q, k, v, causal=True, window=0, q_offset=0):
    """Launch the CUDA kernel once for the whole (B, H) batch (on meta
    tensors, launch nothing); the output has q's shape and type."""
    ts = (q, k, v)
    if not ((q.is_cuda or q.is_meta) and all(t.device == q.device for t in ts)):
        raise ValueError("flash_attention kernel needs q, k, v on one CUDA device "
                         f"(or all on meta), got {[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError("flash_attention kernel takes f32 or bf16 q, k, v of "
                        f"one type, got {[t.dtype for t in ts]}")
    if any(t.dim() != 4 for t in ts):
        raise ValueError("flash_attention takes (B, H, T, dh) and "
                         f"(B, Hkv, S, dh), got {[tuple(t.shape) for t in ts]}")
    B, H, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, S, dh) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {dh} not in {HEAD_DIMS}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention kernel: {H} query heads are not a "
                         f"multiple of {Hkv} kv heads")
    # both kernels copy 16-byte chunks: a contiguous view that starts off
    # 16 bytes into its storage is copied to a fresh one
    q, k, v = (t.contiguous() for t in ts)
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel():
        if q.is_cuda:
            build.launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), B, H, Hkv, T, S, dh, int(causal), int(window),
                         int(q_offset), float(dh ** -0.5), _DTYPES[q.dtype],
                         torch.cuda.current_stream(q.device).cuda_stream)
            build.count("flash_attention")
        if cost.ACTIVE is not None:
            cost.ACTIVE.kernel(flash_cost(B, H, Hkv, T, S, dh, bool(causal), int(window),
                                          int(q_offset), q.element_size()))
    return out


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """(B, H, T, dh) x (B, Hkv, S, dh) -> (B, H, T, dh), forward only."""
    if any(t.is_cuda or t.is_meta for t in (q, k, v)):
        return flash_attention_kernel(q, k, v, causal, window, q_offset)
    return mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
