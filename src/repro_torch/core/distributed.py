"""Distributed KGE training — the paper's cluster path, one process per rank.

A port of the JAX package's core/distributed.py. The reference runs one
SPMD program over a mesh ``(data=M, model=S)`` inside ``shard_map``; the
port runs the same per-device body on every rank of a ``torch.distributed``
world of ``M * S`` processes (launch/mesh.py, ``rank = m * S + s``):

  machine group of server s  ≙ the mesh's 'data' axis: DGL-KE machines, each
        holding one METIS partition of entities + its relation partition;
  model group of machine m   ≙ the 'model' axis: KVStore servers inside a
        machine; every table row is dim-striped across them.

Rank ``(m, s)`` holds rows ``[m*R, (m+1)*R)`` and columns ``[s*w/S,
(s+1)*w/S)`` of each table (the reference's ``P(machine, "model")`` blocks);
the shared relations are replicated over machines and striped over
servers; the T5 pend buffers hold this machine's ids and this server's
columns. One train step (``store_train_step`` on this rank's stores):

  1. pull: local entity rows (0 traffic) + remote rows via capacity-bounded
     all_to_all over the machine group (embeddings/kvstore.py); relations
     the same way; split ("shared") relations from the replicated table.
  2. compute: joint-negative scores (T1) — the negative-sharded route or
     pairwise products over the dim slice finished by a psum over the model
     group; loss; grads w.r.t. the pulled workspace rows only.
  3. push: local rows updated in place with sparse Adagrad; remote-row grads
     returned to owners by the reverse all_to_all; shared-relation grads
     summed over machines. Entity updates are deferred one step with T5.

Pipelined KVStore I/O (``build_pipelined_dist_step``, the reference's
overlap of §3.6 I/O with compute):

  * ``--pipeline-depth 1``: the pull for batch t+1 is issued after the
    grads of batch t and before its push/apply; the state carries the next
    step's workspaces (``pf_ent_ws``, ``pf_rel_ws``), filled for the first
    batch by a prime program. Each step computes against rows one update
    stale. The tables are updated in place, so the pull copies its rows
    (the owner's served rows too) before the apply: eager collectives in
    program order give the reference's pre-apply reads.
  * ``--push-every K``: remote grads merge in per-peer buffers (``co_ids``,
    ``co_grads``) for K steps and leave in one deduplicated all_to_all (the
    flush program, run on every rank at the same step, and by ``finalize``
    for a partial window).

Every rank issues its collectives in one order: the backward's sums over
the model group, pull(t+1, entity), pull(t+1, relation), push(t, entity)
(none when coalescing), push(t, relation), the shared relations' sum.

Weights cross between the packages as the reference's *global* state dict
(its keys and shapes, ``DistKGEProgram.state_shapes``):
``dist_state_from_arrays`` cuts this rank's block out of it,
``gather_dist_state`` rebuilds it on rank 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common import telemetry
from repro_torch.common.config import KGEConfig
from repro_torch.core import scores as S
from repro_torch.core.sampling import MODES, DistBatch
from repro_torch.core.step import (
    prefetch_workspaces,
    store_pipelined_step,
    store_train_step,
)
from repro_torch.embeddings.kvstore import KVStoreSpec
from repro_torch.embeddings.store import ReplicatedStore, ShardedIds, ShardedStore
from repro_torch.embeddings.table import emb_init_scale

# how each state field is laid over the world: (rows split over machines,
# last axis split over servers) — the reference's PartitionSpecs
LAYOUT = {
    "entity": (True, True), "ent_gsq": (True, True),
    "r_emb": (True, True), "rel_gsq": (True, True),
    "r_proj": (True, True), "proj_gsq": (True, True),
    "shared_rel": (False, True), "shared_gsq": (False, True),
    "pend_ids": (True, False), "pend_grads": (True, True),
    "pf_ent_ws": (True, True), "pf_rel_ws": (True, True),
    "co_ids": (True, False), "co_grads": (True, True),
    "step": (False, False),
}
BATCH_IDS = ("ent_local_ids", "ent_remote_req", "rel_local_ids", "rel_remote_req")
BATCH_SLOTS = ("h_slot", "t_slot", "neg_slot", "rel_slot", "rel_shared")


@dataclasses.dataclass(frozen=True)
class DistKGEProgram:
    """Shapes for one (cfg, world) pair."""

    cfg: KGEConfig
    rows_per_part: int  # entity rows per machine
    rel_slots: int  # owned relation slots per machine
    n_shared: int  # shared (split) relations, padded
    L: int  # entity workspace local slots
    Rp: int  # remote entity rows per peer
    Lr: int
    Rrp: int
    # --pipeline-depth: 1 = double-buffered pull prefetch (the state carries
    # the next step's workspaces; the pull for batch t+1 issues before the
    # push of batch t). 0 = the eager step.
    pipeline_depth: int = 0
    # --push-every K: remote grads coalesce in per-peer merge buffers for K
    # steps and leave in one deduplicated all_to_all (the flush program)
    push_every: int = 1

    def state_shapes(self) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
        """The reference's global state: name -> (shape, dtype)."""
        cfg = self.cfg
        P_ = cfg.n_parts
        f32, i32 = np.dtype(np.float32), np.dtype(np.int32)
        ent = (P_ * self.rows_per_part, cfg.dim)
        rel = (P_ * self.rel_slots, cfg.rel_dim)
        out = {
            "entity": (ent, f32), "ent_gsq": (ent, f32),
            "r_emb": (rel, f32), "rel_gsq": (rel, f32),
            "shared_rel": ((self.n_shared, cfg.rel_dim), f32),
            "shared_gsq": ((self.n_shared, cfg.rel_dim), f32),
            "pend_ids": ((P_, self.pend_slots), i32),
            "pend_grads": ((P_, self.pend_slots, cfg.dim), f32),
            "step": ((), i32),
        }
        if cfg.model in ("transr", "rescal"):
            proj = (P_ * self.rel_slots, cfg.dim * cfg.rel_dim)
            out["r_proj"] = (proj, f32)
            out["proj_gsq"] = (proj, f32)
        if self.pipeline_depth:
            # the double buffer: the next step's entity/relation workspaces
            out["pf_ent_ws"] = ((P_, self.L + P_ * self.Rp, cfg.dim), f32)
            out["pf_rel_ws"] = ((P_, self.Lr + P_ * self.Rrp, cfg.rel_dim), f32)
        if self.push_every > 1:
            ck = self.coalesce_slots
            out["co_ids"] = ((P_, P_, ck), i32)
            out["co_grads"] = ((P_, P_, ck, cfg.dim), f32)
        return out

    @property
    def pend_slots(self) -> int:
        # deferred update rows: all local slots + all remote arrivals
        return self.L + self.cfg.n_parts * self.Rp

    @property
    def coalesce_slots(self) -> int:
        """Per-peer merge-buffer capacity Ck for --push-every K: max(Rp,
        K*Rp // 2), half the worst-case unique rows of K steps and never
        below one step's capacity. Overflow drops are counted
        (``push_dropped``)."""
        if self.push_every <= 1:
            return 0
        return max(self.Rp, (self.push_every * self.Rp) // 2)

    def batch_shapes(self) -> Dict[str, Tuple[int, ...]]:
        cfg = self.cfg
        P_, b = cfg.n_parts, cfg.batch_size
        ng, k = cfg.n_neg_groups, cfg.neg_sample_size
        return {
            "ent_local_ids": (P_, self.L),
            "ent_remote_req": (P_, P_, self.Rp),
            "h_slot": (P_, b),
            "t_slot": (P_, b),
            "neg_slot": (P_, MODES, ng, k),
            "rel_local_ids": (P_, self.Lr),
            "rel_remote_req": (P_, P_, self.Rrp),
            "rel_slot": (P_, b),
            "rel_shared": (P_, b),
        }


def make_program(cfg: KGEConfig, rows_per_part: int, rel_slots: int,
                 n_shared: int, pipeline_depth: int = 0,
                 push_every: int = 1) -> DistKGEProgram:
    """The reference's ``make_program``, with its validation."""
    if pipeline_depth not in (0, 1):
        raise ValueError(f"pipeline_depth must be 0 or 1, got {pipeline_depth}")
    if push_every < 1:
        raise ValueError(f"push_every must be >= 1, got {push_every}")
    if pipeline_depth and cfg.model in ("transr", "rescal"):
        raise ValueError(
            f"pipeline_depth=1 does not support model={cfg.model!r}: the "
            "double buffer carries entity/relation workspaces only (no "
            "projection-matrix prefetch slot)")
    if (pipeline_depth or push_every > 1) and cfg.overlap_update:
        raise ValueError(
            "pipelined pull prefetch / coalesced push and overlap_update "
            "(T5 defer) are mutually exclusive: both are single-writer "
            "one-step-stale overlap mechanisms over the same pend state")
    k = cfg.neg_sample_size
    L = 3 * cfg.batch_size + MODES * cfg.n_neg_groups * k
    Rp = max(1, cfg.remote_capacity // cfg.n_parts)
    Lr = cfg.batch_size
    Rrp = max(1, max(8, cfg.remote_capacity // 8) // cfg.n_parts)
    return DistKGEProgram(
        cfg=cfg, rows_per_part=rows_per_part, rel_slots=rel_slots,
        n_shared=max(8, n_shared), L=L, Rp=Rp, Lr=Lr, Rrp=Rrp,
        pipeline_depth=pipeline_depth, push_every=push_every)


# ---------------------------------------------------------------------------
# the global state <-> this rank's blocks
# ---------------------------------------------------------------------------
def _check_world(prog: DistKGEProgram, grid) -> None:
    cfg = prog.cfg
    if cfg.n_parts != grid.M:
        raise ValueError(f"cfg.n_parts={cfg.n_parts} must equal the world's "
                         f"machines M={grid.M}")
    for what, width in (("dim", cfg.dim), ("rel_dim", cfg.rel_dim)):
        if width % grid.S:
            raise ValueError(f"{what}={width} does not stripe over {grid.S} servers")


def _block(name: str, arr, m: int, s: int, M: int, S_: int):
    rows, cols = LAYOUT[name]
    if rows:
        n = arr.shape[0] // M
        arr = arr[m * n:(m + 1) * n]
    if cols:
        n = arr.shape[-1] // S_
        arr = arr[..., s * n:(s + 1) * n]
    return arr


def init_dist_arrays(prog: DistKGEProgram, seed: int = 0) -> Dict[str, np.ndarray]:
    """A fresh global state (the reference's ``init_dist_state`` layout),
    drawn on the host from a torch generator, so a seed gives the same
    tables on every rank and device. torch draws other numbers than
    ``jax.random``: to start from the reference's tables, pass its state to
    ``dist_state_from_arrays``."""
    cfg = prog.cfg
    s = emb_init_scale(cfg)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, dtype) in prog.state_shapes().items():
        if name in ("entity", "r_emb", "shared_rel", "r_proj"):
            v = torch.rand(shape, generator=gen, dtype=torch.float32) * (2 * s) - s
            if name == "r_proj" and cfg.model == "transr":
                v = v * 0.1 + torch.eye(cfg.dim, cfg.rel_dim).reshape(-1)
            out[name] = v.numpy()
        elif name in ("pend_ids", "co_ids"):
            out[name] = np.full(shape, -1, dtype)
        else:
            out[name] = np.zeros(shape, dtype)
    return out


def dist_state_from_arrays(prog: DistKGEProgram, grid, arrays) -> Dict[str, object]:
    """This rank's blocks of a global state (numpy arrays or CPU tensors
    under the reference's keys, with its shapes), on the grid's device; the
    step as an int."""
    _check_world(prog, grid)
    state = {}
    for name, (shape, dtype) in prog.state_shapes().items():
        v = arrays[name]
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"{name}: global shape {tuple(v.shape)} != {shape}")
        if name == "step":
            state[name] = int(v)
            continue
        # a copy: training updates the block in place
        blk = np.array(_block(name, v, grid.m, grid.s, grid.M, grid.S), dtype)
        state[name] = torch.from_numpy(blk).to(grid.device)
    return state


def init_dist_state(prog: DistKGEProgram, grid, seed: int = 0) -> Dict[str, object]:
    return dist_state_from_arrays(prog, grid, init_dist_arrays(prog, seed))


def gather_dist_state(prog: DistKGEProgram, grid, state) -> Optional[Dict[str, np.ndarray]]:
    """The global state dict (numpy, the reference's keys and shapes) on
    rank 0, None on the others. Every rank must call it."""
    out = {} if grid.rank == 0 else None
    for name, (shape, dtype) in prog.state_shapes().items():
        if name == "step":
            if out is not None:
                out[name] = np.asarray(state[name], dtype)
            continue
        blk = state[name].contiguous()
        parts = [torch.empty_like(blk) for _ in range(grid.world)]
        dist.all_gather(parts, blk)
        if out is None:
            continue
        full = np.zeros(shape, dtype)
        for r, part in enumerate(parts):
            m, s = divmod(r, grid.S)
            _block(name, full, m, s, grid.M, grid.S)[...] = part.cpu().numpy()
        out[name] = full
    return out


def batch_to_rank(db: DistBatch, grid) -> Dict[str, torch.Tensor]:
    """Row ``m`` of every field of the whole ``DistBatch`` (every rank
    samples the same batch from the same seed and keeps its machine's row:
    the reference's single-controller batch with no communication). Ids
    stay int32 (they travel in the KVStore's requests), slots are int64."""
    out = {}
    for name in BATCH_IDS + BATCH_SLOTS:
        row = np.ascontiguousarray(getattr(db, name)[grid.m],
                                   np.int32 if name in BATCH_IDS else np.int64)
        x = torch.from_numpy(row)
        if grid.device.type == "cuda":
            x = x.pin_memory()
        out[name] = x.to(grid.device, non_blocking=True)
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def stores_from_dist_state(cfg: KGEConfig, state: Dict, spec: KVStoreSpec,
                           machine_axis) -> Dict[str, object]:
    """View one rank's state blocks as EmbeddingStores (tensors shared; the
    pend buffers squeezed of their machine axis).

    T5: the entity store defers when cfg.overlap_update, and its ``flush()``
    (run at the top of the next step) reads the post-update table, as the
    reference's does.
    """
    dev = state["entity"].device

    def empty(width):
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0, width), dtype=torch.float32, device=dev))

    ent_kw = {}
    if "co_ids" in state:
        # --push-every: the entity store merges remote grads into the
        # state's per-peer buffers (views, updated in place)
        ent_kw = dict(co_ids=state["co_ids"][0], co_grads=state["co_grads"][0],
                      coalesce=True)
    stores = {
        "entity": ShardedStore(state["entity"], state["ent_gsq"],
                               state["pend_ids"][0], state["pend_grads"][0],
                               spec=spec, lr=cfg.lr, defer=cfg.overlap_update,
                               **ent_kw),
        # relations are never deferred (paper: trainer-immediate)
        "rel": ShardedStore(state["r_emb"], state["rel_gsq"],
                            *empty(state["r_emb"].shape[-1]), spec=spec,
                            lr=cfg.lr, defer=False),
        "shared": ReplicatedStore(state["shared_rel"], state["shared_gsq"],
                                  lr=cfg.lr, machine_axis=machine_axis),
    }
    if "r_proj" in state:
        stores["proj"] = ShardedStore(state["r_proj"], state["proj_gsq"],
                                      *empty(state["r_proj"].shape[-1]), spec=spec,
                                      lr=cfg.lr, defer=False)
    return stores


def _spec(prog: DistKGEProgram, grid) -> KVStoreSpec:
    cfg = prog.cfg
    return KVStoreSpec(machine_axis=grid.machine_group, n_parts=cfg.n_parts,
                       remote_capacity=cfg.remote_capacity,
                       comm_dtype=cfg.comm_dtype)


def _addresses(batch: Dict) -> Dict:
    """The pull addresses of one batch."""
    return {"ent_ids": ShardedIds(batch["ent_local_ids"], batch["ent_remote_req"]),
            "rel_ids": ShardedIds(batch["rel_local_ids"], batch["rel_remote_req"])}


def _device_step(prog: DistKGEProgram, grid, state: Dict, batch: Dict):
    """One rank's step: every tensor is this rank's block; ``state`` is
    updated in place and returned with the step's metrics."""
    cfg = prog.cfg
    stores = stores_from_dist_state(cfg, state, _spec(prog, grid), grid.machine_group)
    step_batch = {**_addresses(batch), **{name: batch[name] for name in BATCH_SLOTS}}
    stores, metrics = store_train_step(
        cfg, stores, step_batch, ctx=S.ShardCtx(grid.model_group),
        n_servers=grid.S, machine_axis=grid.machine_group)
    ent = stores["entity"]
    state["pend_ids"] = ent.pend_ids[None]
    state["pend_grads"] = ent.pend_grads[None]
    state["step"] += 1
    return state, metrics


def _device_prime(prog: DistKGEProgram, grid, state: Dict, batch: Dict):
    """Fill the double buffer for the FIRST batch (step 0 of depth 1 has no
    previous step to have prefetched it)."""
    stores = stores_from_dist_state(prog.cfg, state, _spec(prog, grid),
                                    grid.machine_group)
    pf = prefetch_workspaces(stores, _addresses(batch))
    state["pf_ent_ws"] = pf["entity"][None]
    state["pf_rel_ws"] = pf["rel"][None]
    return state


def _device_step_pipelined(prog: DistKGEProgram, grid, state: Dict, batch: Dict,
                           next_batch: Dict):
    """One rank's depth-1 step: grads against the state's prefetched
    workspaces, then the pull for ``next_batch``, then the push/apply of
    ``batch`` (``store_pipelined_step``)."""
    cfg = prog.cfg
    stores = stores_from_dist_state(cfg, state, _spec(prog, grid), grid.machine_group)
    step_batch = {**_addresses(batch), **{name: batch[name] for name in BATCH_SLOTS}}
    prefetched = {"entity": state["pf_ent_ws"][0], "rel": state["pf_rel_ws"][0]}
    stores, pf, metrics = store_pipelined_step(
        cfg, stores, step_batch, prefetched, _addresses(next_batch),
        ctx=S.ShardCtx(grid.model_group), n_servers=grid.S,
        machine_axis=grid.machine_group)
    state["pf_ent_ws"] = pf["entity"][None]
    state["pf_rel_ws"] = pf["rel"][None]
    state["step"] += 1
    return state, metrics


def _device_push_flush(prog: DistKGEProgram, grid, state: Dict):
    """One rank's coalesced-push flush: ONE deduplicated all_to_all returns
    K steps' remote grads to their owners, which apply them; the merge
    buffers reset in place."""
    stores = stores_from_dist_state(prog.cfg, state, _spec(prog, grid),
                                    grid.machine_group)
    stores["entity"].push_flush()
    return state


def build_dist_train_step(prog: DistKGEProgram, grid):
    """This rank's step: ``step(state, batch) -> (state, metrics)`` with
    ``state`` from ``dist_state_from_arrays``/``init_dist_state`` and
    ``batch`` from ``batch_to_rank``. Every rank of the world must call it
    with its own batch row, step for step."""
    _check_world(prog, grid)
    return functools.partial(_device_step, prog, grid)


class PipelinedDistStep:
    """This rank's runner of the pipelined and coalesced programs.

    With ``lookahead`` it is called ``runner(state, batch, next_batch)``
    (``launch/engine.train_loop`` peeks batch t+1 without consuming it);
    otherwise ``runner(state, batch)`` like the eager step. Every K calls it
    runs the flush program; ``finalize(state)`` flushes a partial window at
    the end of a loop (``train_loop`` calls it before its ``on_end`` hooks).
    A new runner primes again and starts its window afresh, as on resume.

    Telemetry: the flush runs once every K steps, so the per-step replay of
    ``TelemetryHook`` would count its volumes K times over. The runner
    drains the KVStore accounting after each program call and replays it
    per call of that program (``*_per_step`` for the prime and the step,
    ``*_per_flush`` for the flush); the hook then finds nothing to drain.
    """

    def __init__(self, step_fn, prime_fn, flush_fn, push_every: int,
                 lookahead: bool):
        self._step = step_fn
        self._prime = prime_fn
        self._flush = flush_fn
        self._k = push_every
        self.lookahead = lookahead
        self._primed = False
        self._i = 0

    @staticmethod
    def _replay(per: str = "step") -> None:
        reg = telemetry.get_registry()
        if not reg.enabled:
            return
        for name, v in reg.drain_statics().items():
            reg.inc(name, v)
            reg.gauge(f"{name}_per_{per}", v)

    def _run_flush(self, state):
        state = self._flush(state)
        telemetry.inc("kvstore/coalesced_push_flushes")
        self._replay(per="flush")
        return state

    def __call__(self, state, batch, next_batch=None):
        if self.lookahead:
            if not self._primed:
                state = self._prime(state, batch)
                self._replay()
                self._primed = True
            state, metrics = self._step(state, batch, next_batch)
        else:
            state, metrics = self._step(state, batch)
        self._replay()
        self._i += 1
        if self._flush is not None and self._i % self._k == 0:
            state = self._run_flush(state)
        return state, metrics

    def finalize(self, state):
        """Flush a partial coalesce window (grads must never be lost)."""
        if self._flush is not None and self._i % self._k != 0:
            state = self._run_flush(state)
        return state


def build_pipelined_dist_step(prog: DistKGEProgram, grid):
    """The pipelined variant of ``build_dist_train_step``: this rank's
    ``PipelinedDistStep``, or the eager step itself when the program has no
    pipelining (depth 0, push_every 1)."""
    if prog.pipeline_depth == 0 and prog.push_every == 1:
        return build_dist_train_step(prog, grid)
    _check_world(prog, grid)
    if prog.pipeline_depth:
        step_fn = functools.partial(_device_step_pipelined, prog, grid)
        prime_fn = functools.partial(_device_prime, prog, grid)
    else:
        step_fn, prime_fn = functools.partial(_device_step, prog, grid), None
    flush_fn = (functools.partial(_device_push_flush, prog, grid)
                if prog.push_every > 1 else None)
    return PipelinedDistStep(step_fn, prime_fn, flush_fn, push_every=prog.push_every,
                             lookahead=prog.pipeline_depth > 0)


def run_batches(grid, prog: DistKGEProgram, arrays, batches, counters=False):
    """Carry the global state ``arrays`` onto this rank and step through
    ``batches`` (whole ``DistBatch``es, the same list on every rank). A
    pipelined program (depth 1) takes n + 1 batches for n steps, the last
    one only prefetched; a coalescing one is finalized after its steps.
    Returns (each step's metrics as floats, the global final state on rank
    0 / None elsewhere), and with ``counters`` rank 0's telemetry counters
    of the run after them. The parity tests and the smoke run call it on
    every rank of a world (``launch.mesh.run_world``)."""
    state = dist_state_from_arrays(prog, grid, arrays)
    step = build_pipelined_dist_step(prog, grid)
    lookahead = getattr(step, "lookahead", False)
    history = []
    with (telemetry.active() if counters else contextlib.nullcontext()) as reg:
        for i in range(len(batches) - lookahead):
            b = batch_to_rank(batches[i], grid)
            if lookahead:
                state, metrics = step(state, b, batch_to_rank(batches[i + 1], grid))
            else:
                state, metrics = step(state, b)
            history.append({k: float(v) for k, v in metrics.items()})
        finalize = getattr(step, "finalize", None)
        if finalize is not None:
            state = finalize(state)
        snap = reg.snapshot()["counters"] if counters else None
    out = (history, gather_dist_state(prog, grid, state))
    return out + (snap,) if counters else out
