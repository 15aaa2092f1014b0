"""KVStore semantics over ``torch.distributed``: capacity-bounded pull/push.

A port of the JAX package's embeddings/kvstore.py. DGL-KE's distributed
KVStore (paper §3.6) serves entity rows over RPC, with a shared-memory fast
path for local rows. Here, one process per rank (launch/mesh.py):

  * **local pull**  — gather rows of the machine-local table block: no
    traffic (the shared-memory fast path).
  * **remote pull** — a fixed-capacity ``all_to_all_single`` over the
    machine group: each machine sends up to ``Rp = R / n_parts`` row
    requests to every peer, peers gather the rows from their local block,
    and a second ``all_to_all_single`` returns them. The int32 ids and the
    row payload travel in separate calls.
  * **remote push** — the reverse route for gradients, after which each
    owner applies the sparse Adagrad update locally.

The server axis (the model group, dim-striping) never communicates here.
With ``machine_axis=None`` (n_parts == 1) the KVStore is degenerate: every
"remote" request is served from the local block and no collective runs, so
the same pull/push code works outside any world (the single-machine parity
tests rely on it). A world of one machine still passes its machine group
and runs the collectives, as the reference's mesh axis of size 1 does.

Padding convention: id == -1 is an empty slot; its pulled row is zeroed and
its pushed gradient is dropped. Comm accounting: every pull/push records
its per-machine per-step rows and wire bytes with ``telemetry.trace_inc``
under the reference's names.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.common import telemetry
from repro_torch.common.collectives import all_to_all_plain


@dataclasses.dataclass(frozen=True)
class KVStoreSpec:
    # the machine process group (launch/mesh.ProcessGrid.machine_group);
    # None = the degenerate single-machine KVStore
    machine_axis: object
    n_parts: int  # number of machines
    remote_capacity: int  # R, total remote rows per machine per step
    # wire format for remote rows/grads: bfloat16 halves the bytes (rows are
    # cast back on arrival; Adagrad state stays fp32)
    comm_dtype: str = "float32"

    def wire(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(getattr(torch, self.comm_dtype))


def _gather_rows(block: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the local block for (possibly padded) ids; pad rows are zero."""
    valid = ids >= 0
    rows = block[torch.where(valid, ids, torch.zeros_like(ids)).long()]
    return torch.where(valid.unsqueeze(-1), rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))


def _wire_bytes(req: torch.Tensor, d: int, spec: KVStoreSpec) -> int:
    """Bytes of one capacity-bounded round trip: the int32 request ids plus
    the row payload in the wire dtype."""
    itemsize = torch.empty((), dtype=getattr(torch, spec.comm_dtype)).element_size()
    return req.numel() * (4 + d * itemsize)


def pull_local(block: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Shared-memory fast path: ids index this machine's row block."""
    telemetry.trace_inc("kvstore/local_rows", ids.numel())
    return _gather_rows(block, ids)


def pull_remote(block: torch.Tensor, req: torch.Tensor, spec: KVStoreSpec,
                metric_prefix: str = "kvstore/pull") -> torch.Tensor:
    """Fetch rows from peers.

    block: (rows_local, d_shard) this machine's table block (this server's
           dim slice).
    req:   (n_parts, Rp) int32 — req[p] are row ids *local to machine p*
           that this machine wants; -1 pads.
    returns: (n_parts * Rp, d_shard) the fetched rows, zeros at pads.
    """
    ax = spec.machine_axis
    # per machine per step; request slots include pads (the
    # capacity-bounded all_to_all always moves the full buffer)
    telemetry.trace_inc(f"{metric_prefix}_rows", req.numel())
    if ax is None:
        # degenerate single-machine KVStore: the only peer is ourselves
        rows = spec.wire(_gather_rows(block, req))
        return rows.reshape(-1, rows.shape[-1]).to(block.dtype)
    telemetry.trace_inc(f"{metric_prefix}_bytes",
                        _wire_bytes(req, block.shape[-1], spec))
    # route requests to owners: recv[p] = the ids peer p asked us for
    recv = all_to_all_plain(req.to(torch.int32), ax)
    served = spec.wire(_gather_rows(block, recv))  # (n_parts, Rp, d_shard)
    rows = all_to_all_plain(served, ax)  # route the rows back
    return rows.reshape(-1, rows.shape[-1]).to(block.dtype)


def push_remote_grads(grads: torch.Tensor, req: torch.Tensor, spec: KVStoreSpec,
                      metric_prefix: str = "kvstore/push"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return gradients for remotely-owned rows to their owners.

    grads: (n_parts * Rp, d_shard) gradients for the rows fetched by
           ``pull_remote`` (same order).
    req:   the request matrix passed to ``pull_remote``.
    returns: (ids, grad_rows) on the *owner*: machine-local row ids (-1
             pads) of the rows whose gradients arrived, and those rows'
             gradients. Apply with sparse Adagrad.
    """
    ax = spec.machine_axis
    telemetry.trace_inc(f"{metric_prefix}_rows", req.numel())
    if ax is None:
        # degenerate single-machine KVStore: grads already sit on the owner
        g = spec.wire(grads).to(grads.dtype)
        return req.reshape(-1), g.reshape(-1, grads.shape[-1])
    telemetry.trace_inc(f"{metric_prefix}_bytes",
                        _wire_bytes(req, grads.shape[-1], spec))
    g = spec.wire(grads).reshape(req.shape[0], -1, grads.shape[-1])
    recv_ids = all_to_all_plain(req.to(torch.int32), ax)
    recv_grads = all_to_all_plain(g, ax)
    return (recv_ids.reshape(-1),
            recv_grads.reshape(-1, grads.shape[-1]).to(grads.dtype))


def pull(block: torch.Tensor, local_ids: torch.Tensor, remote_req: torch.Tensor,
         spec: KVStoreSpec, metric_prefix: str = "kvstore/pull") -> torch.Tensor:
    """Full pull: workspace = [local rows; remote rows], (L + n_parts*Rp,
    d_shard). The pipelined step's lookahead pull passes
    ``metric_prefix="kvstore/prefetch"``, so its remote traffic is counted
    apart from the eager pulls'."""
    return torch.cat([pull_local(block, local_ids),
                      pull_remote(block, remote_req, spec, metric_prefix)], 0)
