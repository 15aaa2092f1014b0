"""Plain PyTorch versions of the kge_score kernels: the CPU path and the
kernels' oracle on the card.

Contract (identical to core/scores.pairwise_scores), with any leading
(group) dimensions shared by both operands:
    (..., B, D) x (..., K, D) -> (..., B, K)
    dot   : o @ negs.T
    l2sq  : ||o_i||^2 - 2 o_i . n_j + ||n_j||^2   (partial, pre-psum)
    l1    : sum_d |o_id - n_jd|                    (partial, pre-psum)
"""

from __future__ import annotations

import torch

MODES = ("dot", "l2sq", "l1")


def pairwise_ref(mode: str, o: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    if mode == "dot":
        return o @ negs.transpose(-1, -2)
    if mode == "l2sq":
        o2 = torch.sum(o * o, dim=-1, keepdim=True)
        n2 = torch.sum(negs * negs, dim=-1).unsqueeze(-2)
        return o2 - 2.0 * (o @ negs.transpose(-1, -2)) + n2
    if mode == "l1":
        return torch.sum(torch.abs(o.unsqueeze(-2) - negs.unsqueeze(-3)), dim=-1)
    raise ValueError(mode)


def l1_grads_ref(o, negs, g, need_do=True, need_dn=True):
    """VJP of l1 for a cotangent g (..., B, K): d_o (..., B, D), d_negs
    (..., K, D), each only when asked for (else None). It builds the
    (..., B, K, D) sign tensor that the kernel (csrc/l1_bwd.cu) never
    materialises."""
    s = torch.sign(o.unsqueeze(-2) - negs.unsqueeze(-3))  # (..., B, K, D)
    d_o = torch.einsum("...bk,...bkd->...bd", g, s) if need_do else None
    d_n = -torch.einsum("...bk,...bkd->...kd", g, s) if need_dn else None
    return d_o, d_n
