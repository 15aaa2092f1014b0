"""The embedding store of the single-machine trainer: ``DenseStore``.

Every train step gathers rows and applies sparse gradients through the store
and never touches tables directly (the JAX package's embeddings/store.py;
the sharded and replicated stores wait for the distributed slice).

Update semantics (paper §3.4 + T5):

    store = store.flush()                      # apply last step's deferred grads
    rows  = store.gather(ids)                  # read post-update rows (a copy)
    ...compute grads w.r.t. rows...
    store = store.apply_sparse_grads(ids, g)   # apply now, or defer if overlap

Unlike the JAX stores, which are functional pytrees, ``DenseStore`` updates
``table`` and ``gsq`` IN PLACE; ``apply_sparse_grads`` and ``flush`` return
the same store. ``gather`` copies, so an in-place update never changes rows
that autograd saved for the step that gathered them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch

from repro_torch.common import telemetry
from repro_torch.optim.sparse_adagrad import dedup_compact_rows, sparse_adagrad_apply

Snapshot = Dict[str, torch.Tensor]


def _empty_pending(table: torch.Tensor, slots: int = 0):
    return (torch.full((slots,), -1, dtype=torch.int32, device=table.device),
            torch.zeros((slots, table.shape[-1]), dtype=table.dtype,
                        device=table.device))


def _park_pending(pend_ids, pend_grads, ids, grads):
    """Stage one step's grads into the fixed pend buffer (T5 defer).

    When the buffer matches the raw workspace size, parking is a passthrough
    (the flush dedups anyway). A *smaller* buffer triggers the
    capacity-bounded dedup-before-defer: duplicates are aggregated and the
    unique rows compacted into the buffer. Returns ``(ids, grads,
    n_dropped)``: uniques beyond capacity are dropped (their updates are
    LOST) and counted, so the loss is observable.
    """
    cap = pend_ids.shape[0]
    if cap == ids.shape[0]:
        return ids, grads.to(pend_grads.dtype), 0
    out_ids, out_grads, n_dropped = dedup_compact_rows(ids, grads, cap)
    return out_ids, out_grads.to(pend_grads.dtype), n_dropped


@dataclasses.dataclass
class DenseStore:
    """Whole-table store (single-machine path). ``ids`` are global rows.

    ``defer=True`` holds each step's gradient in the pending buffers and
    applies it at the *next* step's ``flush()`` — the paper's T5 overlap.
    ``table`` and ``gsq`` are updated in place.
    """

    table: torch.Tensor  # (n_rows, d)
    gsq: torch.Tensor  # Adagrad accumulator, same shape
    pend_ids: torch.Tensor  # (Lp,) -1 pad; (0,) when defer off
    pend_grads: torch.Tensor  # (Lp, d)
    lr: float = 0.1
    defer: bool = False
    # uniques dropped by the capacity-bounded defer over this store's
    # lifetime (an int 0 until a drop count is a tensor)
    pend_dropped: Union[int, torch.Tensor] = 0

    @classmethod
    def create(cls, table: torch.Tensor, lr: float, defer: bool = False,
               pend_slots: int = 0) -> "DenseStore":
        pid, pg = _empty_pending(table, pend_slots if defer else 0)
        return cls(table=table, gsq=torch.zeros_like(table), pend_ids=pid,
                   pend_grads=pg, lr=lr, defer=defer)

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        return self.table[ids]

    def apply_sparse_grads(self, ids, grads) -> "DenseStore":
        if self.defer:
            # T5: park this step's grads; flush() applies them next step
            self.pend_ids, self.pend_grads, nd = _park_pending(
                self.pend_ids, self.pend_grads, ids, grads)
            self.pend_dropped = self.pend_dropped + nd
            return self
        sparse_adagrad_apply(self.table, self.gsq, ids, grads, self.lr)
        return self

    def flush(self) -> "DenseStore":
        if self.pend_ids.shape[0] == 0:
            return self
        telemetry.inc("store/flush_calls")
        sparse_adagrad_apply(self.table, self.gsq, self.pend_ids,
                             self.pend_grads, self.lr)
        # fresh buffers: the parked ones may be tensors the caller still holds
        self.pend_ids = torch.full_like(self.pend_ids, -1)
        self.pend_grads = torch.zeros_like(self.pend_grads)
        return self

    def snapshot(self) -> Snapshot:
        return {"table": self.table, "gsq": self.gsq,
                "pend_ids": self.pend_ids, "pend_grads": self.pend_grads}

    def restore(self, snap: Snapshot) -> "DenseStore":
        for name, value in snap.items():
            setattr(self, name, value)
        return self
