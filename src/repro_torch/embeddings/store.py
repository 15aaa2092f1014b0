"""Pluggable embedding stores — the single update surface of the trainer.

Every train step gathers rows and applies sparse gradients through an
``EmbeddingStore`` and never touches tables directly (the JAX package's
embeddings/store.py). Three backends:

* ``DenseStore``      — one whole table on one device (single machine).
* ``ShardedStore``    — a machine-local block of a row-partitioned table
  plus the KVStore pull/push collectives (embeddings/kvstore.py), one per
  rank of the distributed world; with ``machine_axis=None`` (n_parts == 1)
  the collectives degrade to local gathers.
* ``ReplicatedStore`` — a small table replicated over machines (the
  "shared" split relations of T4): the dense gradient is summed over the
  machine group, then every replica takes the same dense Adagrad step.

``ShardedStore`` also carries the pipelined I/O of ``--pipeline-depth 1``
and ``--push-every K``: ``gather_prefetch`` (the lookahead pull, counted as
``kvstore/prefetch_*``) and, with ``coalesce``, per-peer merge buffers that
hold the remote grads of K steps until ``push_flush`` sends them in one
deduplicated all_to_all.

Update semantics (paper §3.4 + T5):

    store = store.flush()                      # apply last step's deferred grads
    rows  = store.gather(ids)                  # read post-update rows (a copy)
    ...compute grads w.r.t. rows...
    store = store.apply_sparse_grads(ids, g)   # apply now, or defer if overlap

Unlike the JAX stores, which are functional pytrees, the port's stores
update ``table`` and ``gsq`` IN PLACE; ``apply_sparse_grads`` and ``flush``
return the same store. ``gather`` copies, so an in-place update never
changes rows that autograd saved for the step that gathered them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Protocol, Union, runtime_checkable

import torch

from repro_torch.common import telemetry
from repro_torch.common.collectives import all_reduce_sum
from repro_torch.embeddings.kvstore import KVStoreSpec, pull, push_remote_grads
from repro_torch.optim.sparse_adagrad import (
    dedup_compact_rows,
    dense_adagrad_update,
    sparse_adagrad_apply,
)

Snapshot = Dict[str, torch.Tensor]


@runtime_checkable
class EmbeddingStore(Protocol):
    """What a train step may do with an embedding table."""

    def gather(self, ids) -> torch.Tensor: ...

    def apply_sparse_grads(self, ids, grads) -> "EmbeddingStore": ...

    def flush(self) -> "EmbeddingStore": ...

    def snapshot(self) -> Snapshot: ...

    def restore(self, snap: Snapshot) -> "EmbeddingStore": ...


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


def _coalesce_remote(co_ids, co_grads, req, g_remote):
    """Merge one step's remote grads into the per-peer coalesce buffers, in
    place.

    For each peer ``p`` the buffered ``(co_ids[p], co_grads[p])`` and this
    step's ``(req[p], g_remote[p])`` are dedup-aggregated and compacted back
    into the fixed per-peer capacity. The merge takes the reference's
    sort-based route on either device (the reference forces its jnp dedup
    here), so an overflow drops the same rows, the largest ids, as the
    reference's. Returns the uniques dropped, summed over peers.
    """
    dropped = 0
    for p in range(co_ids.shape[0]):
        ids = torch.cat([co_ids[p], req[p].to(torch.int32)])
        g = torch.cat([co_grads[p], g_remote[p].to(co_grads.dtype)], 0)
        ci, cg, nd = dedup_compact_rows(ids, g, co_ids.shape[1], by_sort=True)
        co_ids[p].copy_(ci)
        co_grads[p].copy_(cg)
        dropped = dropped + nd
    return dropped


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


# ===========================================================================
class ShardedIds(NamedTuple):
    """Addresses for one machine's pull: block-local rows + per-peer requests."""

    local: torch.Tensor  # (L,) machine-local row ids, -1 pad
    remote: torch.Tensor  # (n_parts, Rp) peer-local row ids, -1 pad


@dataclasses.dataclass
class ShardedStore:
    """Partition-local block of a row-sharded table + KVStore collectives.

    On a rank of the distributed world the collectives run over
    ``spec.machine_axis`` (the machine group); with ``machine_axis=None``
    (the n_parts == 1 degenerate KVStore) remote requests are served from
    the local block and the store needs no world. ``table`` and ``gsq`` are
    updated in place, and so are the coalesce buffers ``co_ids`` and
    ``co_grads`` (views of the caller's state, as the tables are).
    """

    table: torch.Tensor  # (rows_local, d or d_shard)
    gsq: torch.Tensor
    pend_ids: torch.Tensor  # (Lp,) -1 pad; (0,) when defer off
    pend_grads: torch.Tensor  # (Lp, d_shard)
    spec: KVStoreSpec = KVStoreSpec(None, 1, 1)
    lr: float = 0.1
    defer: bool = False
    # uniques dropped by the capacity-bounded defer (see DenseStore)
    pend_dropped: Union[int, torch.Tensor] = 0
    # the coalesced push (--push-every K): remote grads accumulate per peer
    # in (n_parts, Ck[, d_shard]) merge buffers across steps and leave in
    # one deduplicated all_to_all at push_flush(); None when off
    co_ids: Optional[torch.Tensor] = None
    co_grads: Optional[torch.Tensor] = None
    # uniques dropped by the merge buffers over this store's lifetime
    # (adapters rebuild stores each step: there, the step's drop count)
    co_dropped: Union[int, torch.Tensor] = 0
    coalesce: bool = False

    def __post_init__(self):
        if self.coalesce and self.defer:
            raise ValueError(
                "coalesce and defer are mutually exclusive: both hold this "
                "step's grads back, and mixing their buffers would apply "
                "remote rows on a different cadence than local ones")

    @classmethod
    def create(cls, table: torch.Tensor, spec: KVStoreSpec, lr: float,
               defer: bool = False, pend_slots: int = 0,
               coalesce_slots: int = 0) -> "ShardedStore":
        pid, pg = _empty_pending(table, pend_slots if defer else 0)
        co = {}
        if coalesce_slots:
            co = dict(
                co_ids=torch.full((spec.n_parts, coalesce_slots), -1,
                                  dtype=torch.int32, device=table.device),
                co_grads=torch.zeros((spec.n_parts, coalesce_slots, table.shape[-1]),
                                     dtype=table.dtype, device=table.device),
                coalesce=True)
        return cls(table=table, gsq=torch.zeros_like(table), pend_ids=pid,
                   pend_grads=pg, spec=spec, lr=lr, defer=defer, **co)

    def gather(self, ids: ShardedIds) -> torch.Tensor:
        """Workspace = [local rows (L,); remote rows (n_parts * Rp,)]."""
        return pull(self.table, ids.local, ids.remote, self.spec)

    def gather_prefetch(self, ids: ShardedIds) -> torch.Tensor:
        """``gather`` for the pipelined one-step lookahead (the same rows and
        collectives; a copy of the tables as they are now), its remote pull
        counted as ``kvstore/prefetch_*``."""
        return pull(self.table, ids.local, ids.remote, self.spec,
                    metric_prefix="kvstore/prefetch")

    def apply_sparse_grads(self, ids: ShardedIds, grads) -> "ShardedStore":
        """``grads`` covers the whole workspace returned by ``gather``: the
        local rows' grads stay, the remote rows' go to their owners, and
        every row this machine owns is updated (or parked, T5). When
        coalescing, the local rows are updated now and the remote rows'
        grads merge into the per-peer buffers until ``push_flush``."""
        L = ids.local.shape[0]
        if self.coalesce:
            n_parts = ids.remote.shape[0]
            nd = _coalesce_remote(self.co_ids, self.co_grads, ids.remote,
                                  grads[L:].reshape(n_parts, -1, grads.shape[-1]))
            sparse_adagrad_apply(self.table, self.gsq, ids.local, grads[:L], self.lr)
            self.co_dropped = self.co_dropped + nd
            return self
        owner_ids, owner_grads = push_remote_grads(grads[L:], ids.remote, self.spec)
        all_ids = torch.cat([ids.local.to(torch.int32), owner_ids.to(torch.int32)])
        all_grads = torch.cat([grads[:L], owner_grads], 0)
        if self.defer:
            self.pend_ids, self.pend_grads, nd = _park_pending(
                self.pend_ids, self.pend_grads, all_ids, all_grads)
            self.pend_dropped = self.pend_dropped + nd
            return self
        sparse_adagrad_apply(self.table, self.gsq, all_ids, all_grads, self.lr)
        return self

    def push_flush(self) -> "ShardedStore":
        """Flush the coalesce buffers: ONE deduplicated all_to_all of ``(n_parts
        * Ck)`` row slots returns the accumulated remote grads to their
        owners, the owners apply them with sparse Adagrad, and the buffers
        reset in place. A no-op when coalescing is off. The merge already
        summed duplicate rows, so one flush of K steps' grads applies their
        per-row sums in a single Adagrad step."""
        if not self.coalesce:
            return self
        n_parts, ck = self.co_ids.shape
        owner_ids, owner_grads = push_remote_grads(
            self.co_grads.reshape(n_parts * ck, -1), self.co_ids, self.spec,
            metric_prefix="kvstore/coalesced_push")
        sparse_adagrad_apply(self.table, self.gsq, owner_ids, owner_grads, self.lr)
        # after the apply: with machine_axis=None the owner's ids and grads
        # are views of these buffers
        self.co_ids.fill_(-1)
        self.co_grads.zero_()
        return self

    def flush(self) -> "ShardedStore":
        if self.pend_ids.shape[0] == 0:
            return self
        telemetry.inc("store/flush_calls")
        sparse_adagrad_apply(self.table, self.gsq, self.pend_ids,
                             self.pend_grads, self.lr)
        self.pend_ids = torch.full_like(self.pend_ids, -1)
        self.pend_grads = torch.zeros_like(self.pend_grads)
        return self

    def snapshot(self) -> Snapshot:
        snap = {"table": self.table, "gsq": self.gsq,
                "pend_ids": self.pend_ids, "pend_grads": self.pend_grads}
        if self.coalesce:
            snap["co_ids"] = self.co_ids
            snap["co_grads"] = self.co_grads
        return snap

    def restore(self, snap: Snapshot) -> "ShardedStore":
        for name, value in snap.items():
            setattr(self, name, value)
        return self


# ===========================================================================
@dataclasses.dataclass
class ReplicatedStore:
    """Small machine-replicated table (T4 "shared" split relations).

    Gradients are scattered into a full-table buffer and summed over the
    machine group, so every replica applies the identical dense Adagrad
    step (untouched rows get a zero gradient: an exact no-op). Without a
    machine group the local replica takes the sparse path.
    """

    table: torch.Tensor  # (n_rows, d)
    gsq: torch.Tensor
    lr: float = 0.1
    machine_axis: object = None  # the machine process group, or None

    @classmethod
    def create(cls, table: torch.Tensor, lr: float,
               machine_axis=None) -> "ReplicatedStore":
        return cls(table=table, gsq=torch.zeros_like(table), lr=lr,
                   machine_axis=machine_axis)

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows for ids; -1 pads return row 0 (callers mask)."""
        return self.table[torch.clamp_min(ids, 0).long()]

    def apply_sparse_grads(self, ids, grads) -> "ReplicatedStore":
        flat_ids = ids.reshape(-1).to(torch.int32)
        flat_grads = grads.reshape(flat_ids.shape[0], -1)
        if self.machine_axis is None:
            sparse_adagrad_apply(self.table, self.gsq, flat_ids, flat_grads, self.lr)
            return self
        # cross-machine: the sum needs the dense full-table gradient
        mask = (flat_ids >= 0).unsqueeze(1)
        g = torch.zeros_like(self.table).index_add_(
            0, torch.clamp_min(flat_ids, 0).long(),
            torch.where(mask, flat_grads, torch.zeros_like(flat_grads)))
        dense_adagrad_update(self.table, self.gsq,
                             all_reduce_sum(g, self.machine_axis), self.lr)
        return self

    def flush(self) -> "ReplicatedStore":
        return self

    def snapshot(self) -> Snapshot:
        return {"table": self.table, "gsq": self.gsq}

    def restore(self, snap: Snapshot) -> "ReplicatedStore":
        for name, value in snap.items():
            setattr(self, name, value)
        return self
