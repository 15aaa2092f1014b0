"""Dispatch for the sparse-Adagrad kernels.

The device of the tensors decides the path: on CUDA tensors each wrapper
launches its hand-written kernel (csrc/dedup_aggregate.cu,
csrc/fused_update.cu) or raises; on meta tensors it takes the same checks
and returns the kernel's outputs as meta tensors (the card's route,
described abstractly, for the dry run); on CPU tensors it runs the plain
version (ref.py). On CUDA and on meta each call hands an active cost
analysis its kernel's work (``cost.py``, ``common/cost.py``). optim/sparse_adagrad.py composes the two; nothing else should call
them.

Contracts:
  * ``fused_sparse_adagrad``: updates ``table`` and ``gsq`` in place. Valid
    ids must be UNIQUE (two slots on one row would race on the card). Pads
    (id < 0) may appear anywhere and are exact no-ops.
  * ``dedup_aggregate``: any ids (duplicates + pads); returns the in-place
    layout of ref.dedup_aggregate_ref.

The kernels take int32 ids: the wrappers convert once, here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common import cost
from repro_torch.kernels import build
from repro_torch.kernels.sparse_adagrad.cost import dedup_cost, update_cost
from repro_torch.kernels.sparse_adagrad.ref import (
    dedup_aggregate_ref,
    fused_update_ref,
)


def _check_rows(ids: torch.Tensor, grads: torch.Tensor, what: str) -> torch.Tensor:
    if not ((ids.is_cuda or ids.is_meta) and grads.device == ids.device):
        raise ValueError(f"{what} kernel needs ids and grads on one CUDA device "
                         f"(or both on meta), got {ids.device} and {grads.device}")
    if grads.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32 grads, got {grads.dtype}")
    if ids.dim() != 1 or grads.dim() != 2 or grads.shape[0] != ids.shape[0]:
        raise ValueError(f"{what} kernel takes ids (n,) and grads (n, D), got "
                         f"{tuple(ids.shape)} and {tuple(grads.shape)}")
    if not grads.is_contiguous():
        raise ValueError(f"{what} kernel takes contiguous grads")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what} kernel takes integer ids, got {ids.dtype}")
    return ids.to(torch.int32).contiguous()


def dedup_aggregate(
    ids: torch.Tensor, grads: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uid (n,) int32, agg (n, D)) in the in-place dedup layout."""
    if not (ids.is_cuda or ids.is_meta):
        return dedup_aggregate_ref(ids, grads)
    ids32 = _check_rows(ids, grads, "dedup_aggregate")
    n, D = grads.shape
    uid = torch.empty_like(ids32)
    agg = torch.empty_like(grads)
    if n:
        if ids.is_cuda:
            build.launch("dedup_aggregate", ids32.data_ptr(), grads.data_ptr(),
                         uid.data_ptr(), agg.data_ptr(), n, D,
                         torch.cuda.current_stream(ids.device).cuda_stream)
            build.count("dedup_aggregate")
        if cost.ACTIVE is not None:
            cost.ACTIVE.kernel(dedup_cost(n, D))
    return uid, agg


def fused_sparse_adagrad(
    table: torch.Tensor,
    gsq: torch.Tensor,
    ids: torch.Tensor,
    grads: torch.Tensor,
    lr: float,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-place row Adagrad of ``table``/``gsq``; returns them."""
    if not (table.is_cuda or table.is_meta):
        return fused_update_ref(table, gsq, ids, grads, lr, eps)
    ids32 = _check_rows(ids, grads, "fused_update")
    if not (gsq.device == table.device == ids.device):
        raise ValueError("fused_update kernel needs table, gsq, ids and grads "
                         "on one CUDA device (or all on meta)")
    if table.dtype != torch.float32 or gsq.dtype != torch.float32:
        raise TypeError("fused_update kernel takes a float32 table and gsq")
    if (table.dim() != 2 or gsq.shape != table.shape
            or grads.shape[1] != table.shape[1]):
        raise ValueError(f"fused_update kernel: table {tuple(table.shape)}, gsq "
                         f"{tuple(gsq.shape)}, grads {tuple(grads.shape)}")
    if not (table.is_contiguous() and gsq.is_contiguous()):
        raise ValueError("fused_update kernel updates contiguous tensors in place")
    n, D = grads.shape
    if n:
        if table.is_cuda:
            build.launch("fused_update", table.data_ptr(), gsq.data_ptr(),
                         ids32.data_ptr(), grads.data_ptr(), n, D, table.shape[0],
                         float(lr), float(eps),
                         torch.cuda.current_stream(table.device).cuda_stream)
            build.count("fused_update")
        if cost.ACTIVE is not None:
            cost.ACTIVE.kernel(update_cost(n, D))
    return table, gsq
