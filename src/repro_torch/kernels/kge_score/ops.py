"""Dispatch and autograd for the kge_score kernels.

``pairwise_scores`` is the reduction core/scores.negative_score calls. The
device of the tensors decides the path: on CUDA tensors it launches the
hand-written kernels (csrc/pairwise.cu forward, csrc/l1_bwd.cu l1 backward)
or raises; on meta tensors it takes the same checks and returns the
kernels' outputs as empty meta tensors (the card's route, described
abstractly, for the dry run); on CPU tensors it runs the plain versions
(ref.py). Every device goes through the same ``autograd.Function``. On
CUDA and on meta each call hands an active cost analysis its kernel's
work (``cost.py``, ``common/cost.py``).

Backward (``_Pairwise``), as in the reference's custom VJP (JAX ops.py:64-84):
  dot  : d_o = g @ negs ; d_n = g.T @ o                 (plain matmuls)
  l2sq : d_o = 2 (o * rowsum(g) - g @ negs) ; symmetric (plain matmuls)
  l1   : d_o = sum_k g sign(o - n_k) ; d_n = -sum_b g sign(o_b - n)
         (``l1_bwd_kernel``; the plain ``l1_grads_ref`` on the CPU). Only the
         products autograd asks for are computed; both (the training path)
         from one pass over the compare pairs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.common import cost
from repro_torch.kernels import build
from repro_torch.kernels.kge_score.cost import l1_bwd_cost, pairwise_cost
from repro_torch.kernels.kge_score.ref import MODES, l1_grads_ref, pairwise_ref

PAIR_ROWS = 64  # rows of o a pair launch's tile takes (csrc/l1_bwd.cu kPairRows)

_MODE_ID = {"dot": 0, "l2sq": 1, "l1": 2}


def _as_groups(what: str, o: torch.Tensor, negs: torch.Tensor, *more: torch.Tensor):
    """The checks every kge_score kernel makes: one CUDA (or meta) device,
    float32, contiguous, (B, D) x (K, D) or (G, B, D) x (G, K, D). Returns
    the operands with a leading group dimension."""
    ts = (o, negs, *more)
    if not ((o.is_cuda or o.is_meta) and all(t.device == o.device for t in ts)):
        raise ValueError(f"{what} kernel needs its operands on one CUDA device "
                         f"(or all on meta), got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{what} kernel takes float32, got {[t.dtype for t in ts]}")
    if o.dim() not in (2, 3) or any(t.dim() != o.dim() for t in ts):
        raise ValueError(f"{what} kernel takes (B, D) x (K, D) or "
                         f"(G, B, D) x (G, K, D), got {[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} kernel takes contiguous operands")
    o3, n3, *m3 = (t if t.dim() == 3 else t.unsqueeze(0) for t in ts)
    if n3.shape[0] != o3.shape[0] or n3.shape[2] != o3.shape[2]:
        raise ValueError(f"shape mismatch {tuple(o.shape)} x {tuple(negs.shape)}")
    return (o3, n3, *m3)


def pairwise_kernel(mode: str, o: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: (G, B, D) x (G, K, D) -> (G, B, K), or the same
    without the group dimension. fp32, contiguous, on one CUDA device."""
    if mode not in _MODE_ID:
        raise ValueError(mode)
    o3, n3 = _as_groups("pairwise", o, negs)
    G, B, D = o3.shape
    K = n3.shape[1]
    out = torch.empty((G, B, K), device=o.device, dtype=torch.float32)
    if out.numel():
        if o.is_cuda:
            build.launch("pairwise", o3.data_ptr(), n3.data_ptr(), out.data_ptr(),
                         G, B, K, D, _MODE_ID[mode],
                         torch.cuda.current_stream(o.device).cuda_stream)
            build.count(f"pairwise_{mode}")
        if cost.ACTIVE is not None:
            cost.ACTIVE.kernel(pairwise_cost(mode, G, B, K, D))
    return out if o.dim() == 3 else out[0]


def pairwise_l1_plan(G: int, B: int, K: int, D: int) -> int:
    """Tile rows of o that the l1 mode of the pairwise kernel picks on the
    current CUDA device for a (G, B, D) x (G, K, D) call; a tile is as many
    negatives wide (64 x 64 wide, 32 x 32 narrow)."""
    return build.library("pairwise").pairwise_l1_plan(G, B, K, D)


def l1_bwd_kernel(o: torch.Tensor, negs: torch.Tensor, g: torch.Tensor,
                  need_do: bool = True, need_dn: bool = True
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch the CUDA l1 backward: d_o (.., B, D) and d_n (.., K, D) of
    ``sum(g * pairwise_l1(o, negs))``, each only when asked for (else None).
    ``g`` is (.., B, K); all fp32, contiguous, on one CUDA device.

    Both products come from one pass over the compare pairs (two launches:
    the pass, then the in-order sum of d_n's partials, kept in a scratch of
    ``B / 64`` (G, K, D) blocks); one product alone from a launch of its
    own, which splits its reduction over a thread-block cluster of up to 8
    blocks (``l1_bwd_plan``). Every partial sum is combined in a fixed
    order, so two calls give the same bits."""
    o3, n3, g3 = _as_groups("l1_bwd", o, negs, g)
    G, B, D = o3.shape
    K = n3.shape[1]
    if g3.shape != (G, B, K):
        raise ValueError(f"l1_bwd kernel: g {tuple(g.shape)} does not match "
                         f"{tuple(o.shape)} x {tuple(negs.shape)}")
    launch = o.is_cuda
    stream = torch.cuda.current_stream(o.device).cuda_stream if launch else None

    def empty(*shape):
        return torch.empty(shape, device=o.device, dtype=torch.float32)

    if need_do and need_dn:
        d_o, d_n = empty(G, B, D), empty(G, K, D)
        if d_o.numel() or d_n.numel():
            scratch = empty(build.library("l1_bwd").l1_bwd_pair_scratch(G, B, K, D)
                            if launch else -(-B // PAIR_ROWS) * G * K * D)
            if launch:
                build.launch("l1_bwd", o3.data_ptr(), n3.data_ptr(), g3.data_ptr(),
                             d_o.data_ptr(), d_n.data_ptr(), scratch.data_ptr(),
                             G, B, K, D, stream, symbol="l1_bwd_pair_launch")
                build.count("l1_bwd_pair", "l1_bwd_do", "l1_bwd_dn")
            if cost.ACTIVE is not None:
                cost.ACTIVE.kernel(l1_bwd_cost(G, B, K, D))
        out = [d_o, d_n]
    else:
        out = []
        # (need, x, y, rows, reduction length, w read transposed, counter)
        for need, x, y, R, C, trans, name in (
                (need_do, o3, n3, B, K, 0, "l1_bwd_do"),
                (need_dn, n3, o3, K, B, 1, "l1_bwd_dn")):
            if not need:
                out.append(None)
                continue
            d = empty(G, R, D)
            if d.numel():
                if launch:
                    build.launch("l1_bwd", x.data_ptr(), y.data_ptr(), g3.data_ptr(),
                                 d.data_ptr(), G, R, C, D, trans, stream)
                    build.count(name)
                if cost.ACTIVE is not None:
                    cost.ACTIVE.kernel(l1_bwd_cost(G, B, K, D, need_do=not trans,
                                                   need_dn=bool(trans)))
            out.append(d)
    if o.dim() == 2:
        out = [d if d is None else d[0] for d in out]
    return out[0], out[1]


def l1_bwd_plan(G: int, R: int, C: int, D: int, trans_w: bool) -> Tuple[int, int]:
    """(tile rows, blocks a tile's reduction is split over) that the l1
    backward kernel picks on the current CUDA device for one product, an
    (R, D) output summed over C: d_o is (B, K) with trans_w False, d_n
    (K, B) with True. The pair launch's tiles are 64 rows of o; its split
    of K is ``l1_bwd_pair_plan``."""
    rows, split = ctypes.c_int(), ctypes.c_int()
    build.library("l1_bwd").l1_bwd_plan(G, R, C, D, int(trans_w), ctypes.byref(rows),
                                        ctypes.byref(split))
    return rows.value, split.value


def l1_bwd_pair_plan(G: int, B: int, K: int, D: int) -> int:
    """The split of K that the pair launch picks on the current CUDA device."""
    return build.library("l1_bwd").l1_bwd_pair_plan(G, B, K, D)


class _Pairwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mode, o, negs):
        ctx.mode = mode
        ctx.save_for_backward(o, negs)
        if o.is_cuda or o.is_meta:
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
        _, need_do, need_dn = ctx.needs_input_grad
        # autograd may hand over an expanded (stride-0) g; the kernel reads
        # it by stride as a contiguous (G, B, K)
        g = g.contiguous()
        grads = l1_bwd_kernel if o.is_cuda or o.is_meta else l1_grads_ref
        return (None, *grads(o, negs, g, need_do, need_dn))


def pairwise_scores(mode: str, o: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """(..., B, D) x (..., K, D) -> (..., B, K), matching core/scores.pairwise_scores.

    At most one leading (group) dimension on the CUDA path.
    """
    if mode not in MODES:
        raise ValueError(mode)
    return _Pairwise.apply(mode, o.contiguous(), negs.contiguous())
