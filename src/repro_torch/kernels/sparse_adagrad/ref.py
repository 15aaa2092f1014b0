"""Plain PyTorch versions of the sparse-Adagrad kernels: the CPU path and
the kernels' oracles on the card.

``fused_update_ref(table, gsq, ids, grads, lr, eps)``
    IN PLACE on ``table`` and ``gsq`` (the JAX oracle returns new arrays).
    For each slot i with 0 <= ids[i] < n_rows (valid ids must be unique):
        gsq[ids[i]]   += grads[i]^2
        table[ids[i]] -= lr * grads[i] / (sqrt(updated gsq[ids[i]]) + eps)
    Slots with ids[i] < 0 are no-ops and ids past the table are dropped, as
    the JAX oracle's mode="drop" scatter drops them. Returns (table, gsq).

``dedup_aggregate_ref(ids, grads)``
    In-place-layout dedup: slot i keeps its id iff it is the *first*
    occurrence of that id; its gradient becomes the sum over all
    occurrences. Later duplicates and pads (< 0) get id -1 and a zero row.
    Returns (uid int32, agg).
"""

from __future__ import annotations

from typing import Tuple

import torch


def fused_update_ref(
    table: torch.Tensor,
    gsq: torch.Tensor,
    ids: torch.Tensor,
    grads: torch.Tensor,
    lr: float,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = ids[valid].long()
    g = grads[valid].to(gsq.dtype)
    q = gsq[rows] + g * g
    gsq[rows] = q
    table[rows] = table[rows] - lr * g / (torch.sqrt(q) + eps)
    return table, gsq


def dedup_aggregate_ref(
    ids: torch.Tensor, grads: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    ids = ids.to(torch.int32)
    valid = ids >= 0
    match = (ids[:, None] == ids[None, :]) & valid[:, None]
    first = valid & ~torch.any(torch.tril(match, diagonal=-1), dim=1)
    agg = match.to(torch.float32) @ grads.to(torch.float32)
    uid = torch.where(first, ids, torch.full_like(ids, -1))
    agg = torch.where(first[:, None], agg, torch.zeros_like(agg))
    return uid, agg.to(grads.dtype)
