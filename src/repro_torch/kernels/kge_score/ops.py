"""Dispatch and autograd for the kge_score kernel.

``pairwise_scores`` is the reduction core/scores.negative_score calls. The
device of the tensors decides the path: on a CUDA tensor it launches the
hand-written kernel (csrc/pairwise.cu) or raises; on a CPU tensor it runs
the plain version (ref.py).

Backward (``_Pairwise``), as in the reference's custom VJP (JAX ops.py:64-84):
  dot  : d_o = g @ negs ; d_n = g.T @ o                 (plain matmuls)
  l2sq : d_o = 2 (o * rowsum(g) - g @ negs) ; symmetric (plain matmuls)
  l1   : the backward kernels (kge_score.py:119, l1_bwd_pallas) are not
         ported yet; on a CUDA tensor the backward raises, on the CPU l1 goes
         through the plain version's autograd.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kge_score.ref import MODES, pairwise_ref

_MODE_ID = {"dot": 0, "l2sq": 1, "l1": 2}


def pairwise_kernel(mode: str, o: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: (G, B, D) x (G, K, D) -> (G, B, K), or the same
    without the group dimension. fp32, contiguous, on one CUDA device."""
    if mode not in _MODE_ID:
        raise ValueError(mode)
    if not (o.is_cuda and negs.device == o.device):
        raise ValueError(f"pairwise kernel needs both operands on one CUDA "
                         f"device, got {o.device} and {negs.device}")
    if o.dtype != torch.float32 or negs.dtype != torch.float32:
        raise TypeError(f"pairwise kernel takes float32, got {o.dtype}, {negs.dtype}")
    if o.dim() not in (2, 3) or negs.dim() != o.dim():
        raise ValueError(f"pairwise kernel takes (B, D) x (K, D) or "
                         f"(G, B, D) x (G, K, D), got {tuple(o.shape)} x "
                         f"{tuple(negs.shape)}")
    if not (o.is_contiguous() and negs.is_contiguous()):
        raise ValueError("pairwise kernel takes contiguous operands")
    o3 = o if o.dim() == 3 else o.unsqueeze(0)
    n3 = negs if negs.dim() == 3 else negs.unsqueeze(0)
    G, B, D = o3.shape
    if n3.shape[0] != G or n3.shape[2] != D:
        raise ValueError(f"shape mismatch {tuple(o.shape)} x {tuple(negs.shape)}")
    K = n3.shape[1]
    out = torch.empty((G, B, K), device=o.device, dtype=torch.float32)
    if out.numel():
        build.launch("pairwise", o3.data_ptr(), n3.data_ptr(), out.data_ptr(),
                     G, B, K, D, _MODE_ID[mode],
                     torch.cuda.current_stream(o.device).cuda_stream)
        build.LAUNCHES[f"pairwise_{mode}"] += 1
    return out if o.dim() == 3 else out[0]


class _Pairwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mode, o, negs):
        ctx.mode = mode
        ctx.save_for_backward(o, negs)
        if o.is_cuda:
            return pairwise_kernel(mode, o, negs)
        return pairwise_ref(mode, o, negs)

    @staticmethod
    def backward(ctx, g):
        o, negs = ctx.saved_tensors
        gt = g.transpose(-1, -2)
        if ctx.mode == "dot":
            return None, g @ negs, gt @ o
        if ctx.mode == "l2sq":
            d_o = 2.0 * (o * g.sum(-1, keepdim=True) - g @ negs)
            d_n = 2.0 * (negs * g.sum(-2).unsqueeze(-1) - gt @ o)
            return None, d_o, d_n
        raise NotImplementedError(
            "the l1 backward kernels (kge_score.py:119 l1_bwd_pallas) are not "
            "ported yet: ROADMAP Queue B, next slice (TransE_l1 training)")


def pairwise_scores(mode: str, o: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """(..., B, D) x (..., K, D) -> (..., B, K), matching core/scores.pairwise_scores.

    At most one leading (group) dimension on the CUDA path.
    """
    if mode not in MODES:
        raise ValueError(mode)
    if mode == "l1" and not o.is_cuda:
        return pairwise_ref(mode, o, negs)
    return _Pairwise.apply(mode, o.contiguous(), negs.contiguous())
