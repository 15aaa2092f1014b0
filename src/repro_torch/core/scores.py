"""KGE score functions (paper Table 1) in PyTorch.

A port of the JAX package's core/scores.py. Every function takes
embeddings that may hold only a ``d/S`` slice of the true dimension
(dim-striping over the distributed world's model group, the KVStore
servers). Reductions over the embedding dimension go through
``ShardCtx.psum``; with ``axis=None`` they are plain sums (one device).
Every function accepts leading batch dimensions, so the step scores all
negative groups at once with a leading group dimension instead of the
reference's ``vmap``.

Layout conventions (as in the reference)
----------------------------------------
* ComplEx / RotatE use an **interleaved (re, im) pair layout** along dim.
* TransR / RESCAL store the per-relation projection flattened row-major
  (d, rel_dim) -> (d * rel_dim,), dim-striped on the *first* (d) axis:
  server ``s`` holds rows ``M_r[s*ds:(s+1)*ds, :]``, so ``h_s @ M_r_s`` is a
  partial product completed by one psum.

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
import torch.distributed as dist

from repro_torch.common import collectives as C
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
    """Dim-sharding context: the process group that stripes the embedding
    dim (a ``launch.mesh.ProcessGrid``'s model group), or None."""

    axis: object = None

    def __post_init__(self):
        if self.axis is not None and not isinstance(self.axis, dist.ProcessGroup):
            raise TypeError(f"ShardCtx takes a torch.distributed process group "
                            f"or None, not {self.axis!r} (a mesh axis name "
                            f"means nothing outside JAX)")

    def psum(self, x):
        if self.axis is None:
            return x
        return C.psum(x, self.axis)

    @property
    def size(self) -> int:
        return 1 if self.axis is None else dist.get_world_size(self.axis)

    def index(self) -> int:
        return 0 if self.axis is None else dist.get_rank(self.axis)


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
    ph: Optional[torch.Tensor] = None,  # (..., rel_dim) RESCAL's M_r^T h, if made
) -> torch.Tensor:
    """``ph``: RESCAL's replicated M_r^T h where the caller has it
    (``kernels/rescal_proj``); ``r_proj`` is then not read."""
    if model == "rescal" and ph is not None:
        return ctx.psum(torch.sum(_slice_replicated(ph, ctx) * t, dim=-1))
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
        m = _proj(r_proj, h.shape[-1], rel_dim)  # this server's rows of M_r
        ph = ctx.psum(torch.einsum("...d,...dr->...r", h, m))  # replicated
        if model == "rescal":
            # h^T M_r t == (M_r^T h) . t: this server's slice of ph times t
            return ctx.psum(torch.sum(_slice_replicated(ph, ctx) * t, dim=-1))
        pt = ctx.psum(torch.einsum("...d,...dr->...r", t, m))
        # TransR: the r slice belongs to this server, so compare slices of
        # the replicated projections
        rs = _slice_replicated(ph, ctx) + r - _slice_replicated(pt, ctx)
        d2 = ctx.psum(torch.sum(torch.square(rs), dim=-1))
        return gamma - torch.sqrt(d2 + 1e-12)
    raise ValueError(model)


def _slice_replicated(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """This server's dim slice of a replicated (..., rel_dim) tensor."""
    if ctx.axis is None:
        return x
    ds = x.shape[-1] // ctx.size
    return x.narrow(-1, ctx.index() * ds, ds)


def _gather_full_r(r_slice: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """All-gather a (..., ds) dim slice into the full replicated (..., dim)."""
    if ctx.axis is None:
        return r_slice
    return C.all_gather(r_slice, ctx.axis, axis=-1)


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
            pe = ctx.psum(torch.einsum("...d,...dr->...r", e, m))  # replicated
            r_full = _gather_full_r(r, ctx)
            return pe + r_full if corrupt == "tail" else pe - r_full
        if corrupt == "tail":
            # score(t') = (M_r^T h) . t': slice the replicated product
            pe = ctx.psum(torch.einsum("...d,...dr->...r", e, m))
            return _slice_replicated(pe, ctx)
        # score(h') = h' . (M_r t): this server's d-rows of M_r times full t
        return torch.einsum("...dr,...r->...d", m, _gather_full_r(e, ctx))
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
    return finish_neg_scores_local(model, ctx.psum(partial), gamma)


def negative_score_sharded(
    model: str,
    h_or_t: torch.Tensor,  # (..., b, ds) dim-sharded
    r: torch.Tensor,
    negs: torch.Tensor,  # (..., k, ds) dim-sharded candidate entities
    corrupt: str,
    gamma: float,
    ctx: ShardCtx,
    emb_scale: float = 1.0,
    wire_dtype: Optional[str] = None,  # cast o/negs for the exchange
) -> torch.Tensor:
    """Negative-sharded joint scoring (the reference's beyond-paper route):
    instead of psum-ing the full (b, k) score matrix over the dim-striped
    servers, all-gather the per-triplet ``o`` vectors (b x d, small) and
    re-shard the NEGATIVES over servers with an all_to_all; each server then
    owns complete full-dim scores for its k/S negatives, and only scalar
    loss terms cross the wire. For the elementwise-o family
    (TransE/DistMult/ComplEx/RotatE); TransR/RESCAL use ``negative_score``.

    Returns (..., b, k/S) *local* scores: reduce loss terms with a scalar
    psum. The pairwise product goes through kernels/kge_score/ops.py.
    """
    if model in ("transr", "rescal") or ctx.axis is None:
        raise ValueError(f"negative sharding needs an elementwise-o model and a "
                         f"model group, got {model} over {ctx.axis}")
    mode = PAIRWISE_OF[model]
    o = neg_o(model, h_or_t, r, corrupt, ctx, emb_scale=emb_scale)
    cdt = o.dtype if wire_dtype is None else getattr(torch, wire_dtype)
    o_full = C.all_gather(o.to(cdt), ctx.axis, axis=-1).to(o.dtype)  # (.., b, d)
    negs_loc = C.all_to_all(negs.to(cdt), ctx.axis, split_axis=-2,
                            concat_axis=-1).to(negs.dtype)  # (.., k/S, d)
    partial = kge_score_ops.pairwise_scores(mode, o_full, negs_loc)
    return finish_neg_scores_local(model, partial, gamma)


def finish_neg_scores_local(model: str, full: torch.Tensor, gamma: float):
    """Like finish_neg_scores but the reduction over dim is already complete."""
    if model in ("transe_l2", "rotate", "transr"):
        # max(full, 0) written so that its gradient at 0 is 0.5, as
        # jnp.maximum's (torch.clamp_min passes 1 there); same value bit for bit
        return gamma - torch.sqrt(0.5 * (full + full.abs()) + 1e-12)
    if model == "transe_l1":
        return gamma - full
    return full


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
    o: Optional[torch.Tensor] = None,  # (..., b, d) neg_o's vector, if made
) -> torch.Tensor:
    """(..., b, k) negative scores via the joint decomposition.

    The pairwise reduction goes through kernels/kge_score/ops.py: the CUDA
    kernel for tensors on the card, the plain version for CPU tensors.
    ``o``: the per-triplet vector where the caller has it (RESCAL's M_r^T h
    or M_r t from ``kernels/rescal_proj``); ``neg_o`` is then not called.
    """
    mode = PAIRWISE_OF[model]
    if o is None:
        o = neg_o(model, h_or_t, r, corrupt, ctx, r_proj, rel_dim, emb_scale)
    if model == "transr":
        # negatives must be projected per relation: (..., b, k, rel_dim)
        m = _proj(r_proj, negs.shape[-1], rel_dim)
        pn = ctx.psum(torch.einsum("...kd,...bdr->...bkr", negs, m))
        d2 = torch.sum(torch.square(o.unsqueeze(-2) - pn), dim=-1)
        return gamma - torch.sqrt(d2 + 1e-12)
    partial = kge_score_ops.pairwise_scores(mode, o, negs)
    return finish_neg_scores(model, partial, gamma, ctx)
