"""KGE score functions (paper Table 1) in PyTorch.

A port of the JAX package's core/scores.py for one device: the dim-sharding
context exists only as ``ShardCtx(axis=None)``, whose psum is the identity
(the dim-striped form waits for the distributed slice). Every function
accepts leading batch dimensions, so the step scores all negative groups at
once with a leading group dimension instead of a loop.

Layout conventions (as in the reference)
----------------------------------------
* ComplEx / RotatE use an **interleaved (re, im) pair layout** along dim.
* TransR / RESCAL store the per-relation projection flattened row-major
  (d, rel_dim) -> (d * rel_dim,).

Joint-negative decomposition (paper §3.3, T1)
---------------------------------------------
Every model exposes ``neg_o(...)`` producing the per-triplet vector ``o``
such that the b x k negative scores reduce to a *pairwise* form
``pairwise(o, negs)``: a GEMM (``dot``, ``l2sq``) or an L1 distance, which is
what the CUDA pairwise kernel (csrc/pairwise.cu) computes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels.kge_score import ops as kge_score_ops
from repro_torch.kernels.kge_score.ref import pairwise_ref

MODELS = ("transe_l1", "transe_l2", "distmult", "complex", "rotate", "transr", "rescal")
# pairwise reduction used by each model's joint-negative form
PAIRWISE_OF = {
    "transe_l1": "l1",
    "transe_l2": "l2sq",
    "distmult": "dot",
    "complex": "dot",
    "rotate": "l2sq",
    "transr": "l2sq",
    "rescal": "dot",
}


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Dim-sharding context. Only the unsharded ``axis=None`` is ported."""

    axis: None = None

    def __post_init__(self):
        if self.axis is not None:
            raise NotImplementedError(
                "dim-sharded scoring is not ported yet (ROADMAP Queue A, "
                "distributed slice)")

    def psum(self, x):
        return x


def _cmul(a_re, a_im, b_re, b_im):
    return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re


def split_ri(x: torch.Tensor):
    """Interleaved (re, im) pairs -> (re, im), each (..., d/2)."""
    r = x.reshape(x.shape[:-1] + (-1, 2))
    return r[..., 0], r[..., 1]


def merge_ri(re: torch.Tensor, im: torch.Tensor):
    return torch.stack([re, im], dim=-1).reshape(re.shape[:-1] + (-1,))


def _phase(r: torch.Tensor, scale: float):
    """RotatE: relation row -> unit-modulus complex, phases read from the even
    positions of the interleaved layout (see the reference)."""
    ph = r.reshape(r.shape[:-1] + (-1, 2))[..., 0] / scale * math.pi
    return torch.cos(ph), torch.sin(ph)


def _proj(r_proj: torch.Tensor, ds: int, rel_dim: int) -> torch.Tensor:
    return r_proj.reshape(r_proj.shape[:-1] + (ds, rel_dim))


# --------------------------------------------------------------------------
# Positive scores: one per triplet, elementwise + dim reduction
# --------------------------------------------------------------------------
def positive_score(
    model: str,
    h: torch.Tensor,  # (..., d)
    r: torch.Tensor,  # (..., rel_d)
    t: torch.Tensor,  # (..., d)
    gamma: float,
    ctx: ShardCtx,
    r_proj: Optional[torch.Tensor] = None,  # (..., d * rel_dim) TransR/RESCAL
    rel_dim: int = 0,
    emb_scale: float = 1.0,
) -> torch.Tensor:
    if model == "transe_l1":
        d = ctx.psum(torch.sum(torch.abs(h + r - t), dim=-1))
        return gamma - d
    if model == "transe_l2":
        d2 = ctx.psum(torch.sum(torch.square(h + r - t), dim=-1))
        return gamma - torch.sqrt(d2 + 1e-12)
    if model == "distmult":
        return ctx.psum(torch.sum(h * r * t, dim=-1))
    if model == "complex":
        hr, hi = split_ri(h)
        rr, ri = split_ri(r)
        tr, ti = split_ri(t)
        s = hr * rr * tr + hi * rr * ti + hr * ri * ti - hi * ri * tr
        return ctx.psum(torch.sum(s, dim=-1))
    if model == "rotate":
        hr, hi = split_ri(h)
        rr, ri = _phase(r, emb_scale)
        tr, ti = split_ri(t)
        or_, oi = _cmul(hr, hi, rr, ri)
        d2 = ctx.psum(torch.sum(torch.square(or_ - tr) + torch.square(oi - ti), dim=-1))
        return gamma - torch.sqrt(d2 + 1e-12)
    if model in ("transr", "rescal"):
        if r_proj is None or rel_dim <= 0:
            raise ValueError(f"{model} needs r_proj and rel_dim")
        m = _proj(r_proj, h.shape[-1], rel_dim)
        ph = ctx.psum(torch.einsum("...d,...dr->...r", h, m))
        if model == "rescal":
            return ctx.psum(torch.sum(ph * t, dim=-1))
        pt = ctx.psum(torch.einsum("...d,...dr->...r", t, m))
        d2 = ctx.psum(torch.sum(torch.square(ph + r - pt), dim=-1))
        return gamma - torch.sqrt(d2 + 1e-12)
    raise ValueError(model)


# --------------------------------------------------------------------------
# Joint-negative decomposition (T1): score(b, neg_j) = pairwise(o_b, neg_j)
# --------------------------------------------------------------------------
def neg_o(
    model: str,
    h_or_t: torch.Tensor,  # (..., d) the NON-corrupted entity
    r: torch.Tensor,
    corrupt: str,  # 'tail' | 'head'
    ctx: ShardCtx,
    r_proj: Optional[torch.Tensor] = None,
    rel_dim: int = 0,
    emb_scale: float = 1.0,
) -> torch.Tensor:
    """The per-triplet vector o with score = pairwise(o, candidate)."""
    e = h_or_t
    if model in ("transe_l1", "transe_l2"):
        return e + r if corrupt == "tail" else e - r
    if model == "distmult":
        return e * r
    if model == "complex":
        er, ei = split_ri(e)
        rr, ri = split_ri(r)
        if corrupt == "tail":
            return merge_ri(*_cmul(er, ei, rr, ri))
        return merge_ri(*_cmul(er, ei, rr, -ri))
    if model == "rotate":
        er, ei = split_ri(e)
        rr, ri = _phase(r, emb_scale)
        if corrupt == "tail":
            return merge_ri(*_cmul(er, ei, rr, ri))  # o = h∘r, dist to t'
        return merge_ri(*_cmul(er, ei, rr, -ri))  # o = conj(r)∘t, dist to h'
    if model in ("transr", "rescal"):
        if r_proj is None or rel_dim <= 0:
            raise ValueError(f"{model} needs r_proj and rel_dim")
        m = _proj(r_proj, e.shape[-1], rel_dim)
        if model == "transr":
            pe = ctx.psum(torch.einsum("...d,...dr->...r", e, m))
            return pe + r if corrupt == "tail" else pe - r
        if corrupt == "tail":
            # score(t') = (M_r^T h) . t'
            return ctx.psum(torch.einsum("...d,...dr->...r", e, m))
        # score(h') = h' . (M_r t)
        return torch.einsum("...dr,...r->...d", m, e)
    raise ValueError(model)


def pairwise_scores(mode: str, o: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """Plain pairwise reduction: (..., b, d) x (..., k, d) -> (..., b, k).

    ``l2sq``/``l1`` return *partial distances* (the caller converts them to
    scores); ``dot`` returns partial dots. The CUDA pairwise kernel computes
    exactly this contract.
    """
    return pairwise_ref(mode, o, negs)


def finish_neg_scores(
    model: str, partial: torch.Tensor, gamma: float, ctx: ShardCtx
) -> torch.Tensor:
    """psum partial pairwise reductions and convert to scores."""
    s = ctx.psum(partial)
    if model in ("transe_l2", "rotate", "transr"):
        return gamma - torch.sqrt(torch.clamp_min(s, 0.0) + 1e-12)
    if model == "transe_l1":
        return gamma - s
    return s  # dot-family


def negative_score(
    model: str,
    h_or_t: torch.Tensor,  # (..., b, d)
    r: torch.Tensor,  # (..., b, rel_d)
    negs: torch.Tensor,  # (..., k, d) candidate entities
    corrupt: str,
    gamma: float,
    ctx: ShardCtx,
    r_proj: Optional[torch.Tensor] = None,
    rel_dim: int = 0,
    emb_scale: float = 1.0,
) -> torch.Tensor:
    """(..., b, k) negative scores via the joint decomposition.

    The pairwise reduction goes through kernels/kge_score/ops.py: the CUDA
    kernel for tensors on the card, the plain version for CPU tensors.
    """
    mode = PAIRWISE_OF[model]
    o = neg_o(model, h_or_t, r, corrupt, ctx, r_proj, rel_dim, emb_scale)
    if model == "transr":
        # negatives must be projected per relation: (..., b, k, rel_dim)
        m = _proj(r_proj, negs.shape[-1], rel_dim)
        pn = ctx.psum(torch.einsum("...kd,...bdr->...bkr", negs, m))
        d2 = torch.sum(torch.square(o.unsqueeze(-2) - pn), dim=-1)
        return gamma - torch.sqrt(d2 + 1e-12)
    partial = kge_score_ops.pairwise_scores(mode, o, negs)
    return finish_neg_scores(model, partial, gamma, ctx)
