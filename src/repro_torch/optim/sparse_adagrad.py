"""Sparse per-row Adagrad — the optimizer DGL-KE uses for embeddings.

DGL-KE performs *sparse gradient updates* (paper §2, §3.4): only the
embedding rows touched by a mini-batch are read, adjusted by Adagrad, and
written back. The port updates ``table`` and ``gsq`` IN PLACE, where the JAX
package returns new arrays; every function returns the (same) tensors.

One entry point, ``sparse_adagrad_apply``, is what
``DenseStore.apply_sparse_grads`` calls: dedup-aggregate, then the fused
row update. The device of the tensors picks the path: on CUDA the two
hand-written kernels (kernels/sparse_adagrad), on the CPU their plain
versions. There is no flag and no environment override.

``segment_aggregate_rows`` (sort-based dedup), ``sparse_adagrad_update_rows``
(scatter-add update) and ``dense_adagrad_update`` port the reference's plain
formulations. Of these the training path uses only the sort-based dedup: the
coalesced push's per-peer merge (``dedup_compact_rows(..., by_sort=True)``,
embeddings/store.py), where the reference itself forces its jnp route, so
both packages keep the same rows when a merge buffer overflows.

Padding convention: ids < 0 are no-ops, enabling fixed-size buffers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.sparse_adagrad import dedup_aggregate, fused_sparse_adagrad


def sparse_adagrad_apply(
    table: torch.Tensor,
    gsq: torch.Tensor,
    ids: torch.Tensor,
    grads: torch.Tensor,
    lr: float,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """THE sparse update, in place: dedup-aggregate then per-row Adagrad.

    Accepts raw (possibly duplicated, possibly padded) workspace ids.
    """
    uid, agg = dedup_aggregate(ids, grads)
    return fused_sparse_adagrad(table, gsq, uid, agg, lr, eps)


def segment_aggregate_rows(
    ids: torch.Tensor, grads: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dedup: returns (unique ids, summed grads), compacted.

    ``ids``: (n,) row ids (may repeat, < 0 = pad); ``grads``: (n, d).
    Output keeps the fixed size n: the segments sit in the leading slots
    (sorted ascending, so a pad segment comes first with id -1), every
    remaining slot holds pad -1 with a zero gradient row.
    """
    n = ids.shape[0]
    ids = ids.to(torch.int64)
    if n == 0:
        return ids.to(torch.int32), grads
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    first = torch.ones_like(sids, dtype=torch.bool)
    first[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    agg = torch.zeros_like(grads).index_add_(0, seg, grads[order])
    uid = torch.full_like(sids, -1).scatter_reduce_(
        0, seg, torch.where(first, sids, torch.full_like(sids, -1)), "amax")
    return uid.to(torch.int32), agg


def dedup_compact_rows(
    ids: torch.Tensor,
    grads: torch.Tensor,
    capacity: int,
    *,
    by_sort: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dedup + compact into a ``capacity``-slot buffer (T5 pend buffers, the
    coalesced push's merge buffers).

    Returns (ids (capacity,) int32, grads (capacity, d), n_dropped). Uniques
    beyond ``capacity`` are DROPPED and counted exactly in ``n_dropped``.
    By default the uniques keep their first-occurrence order (the dedup
    kernel's layout, ``dedup_aggregate``). ``by_sort=True`` takes the
    reference's sort-based route on either device (``segment_aggregate_rows``,
    ascending ids, so an overflow drops the largest ids): the coalesce merge
    asks for it, as the reference's does with ``use_kernel=False``.
    """
    uid, agg = (segment_aggregate_rows if by_sort else dedup_aggregate)(ids, grads)
    first = uid >= 0
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    keep = first & (rank < capacity)
    dest = torch.where(keep, rank, torch.full_like(rank, capacity))  # trash slot
    out_ids = torch.full((capacity + 1,), -1, dtype=torch.int32, device=ids.device)
    out_grads = torch.zeros((capacity + 1,) + grads.shape[1:], dtype=grads.dtype,
                            device=grads.device)
    out_ids.index_put_((dest,), uid)
    out_grads.index_put_((dest,), agg.to(grads.dtype))
    n_dropped = torch.clamp_min(first.sum() - capacity, 0)
    return out_ids[:capacity], out_grads[:capacity], n_dropped


def sparse_adagrad_update_rows(
    table: torch.Tensor,
    gsq: torch.Tensor,
    ids: torch.Tensor,
    grad_rows: torch.Tensor,
    lr: float,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-add Adagrad of rows ``ids``, in place. ids < 0 are no-ops.

    Duplicate-id hazard: valid ids MUST be unique. Adagrad is nonlinear —
    with duplicates the scatter-add sums every occurrence into ``gsq``
    before the step is computed. Dedup first (``sparse_adagrad_apply``
    composes the two correctly).
    """
    valid = (ids >= 0) & (ids < table.shape[0])
    safe = torch.where(valid, ids, torch.zeros_like(ids)).to(torch.int64)
    v = valid[:, None]
    g = torch.where(v, grad_rows, torch.zeros_like(grad_rows)).to(table.dtype)
    gsq.index_put_((safe,), g * g, accumulate=True)
    # read back the *updated* accumulator for the step size (DGL-KE order)
    denom = torch.sqrt(gsq[safe]) + eps
    step = torch.where(v, lr * g / denom, torch.zeros_like(g))
    table.index_put_((safe,), -step, accumulate=True)
    return table, gsq


def dense_adagrad_update(
    table: torch.Tensor,
    gsq: torch.Tensor,
    grad: torch.Tensor,
    lr: float,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense Adagrad over the whole table, in place (what treating embeddings
    as dense weights costs — the PBG behaviour the paper §3.4 argues
    against)."""
    gsq.add_(grad * grad)
    table.sub_(lr * grad / (torch.sqrt(gsq) + eps))
    return table, gsq
