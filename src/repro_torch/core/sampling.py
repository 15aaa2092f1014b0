"""Host-side mini-batch construction (paper §3.3, T1/T2), numpy.

The single-machine samplers of the JAX package's core/sampling.py, copied so
that the same seed gives the same batch stream in both packages:

  * **joint** (T1): a group of ``g`` triplets shares one pool of ``k``
    corrupting entities, so the negative scores become a pairwise product;
  * **degree-based / in-batch** (T2): part of each pool is drawn from the
    entities already in the batch (proportional to in-batch degree);
  * **naive**: independent corruption per triplet, the O(b·k·d) baseline.

  * **local** (T3): in distributed mode, ``DistSampler`` draws corrupting
    entities from the machine's own partition, so negatives add no network
    traffic; its ``DistBatch`` holds every machine's fixed-shape buffers.

Both head- and tail-corruption modes are generated (modes axis = 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.common.config import KGEConfig
from repro_torch.core.graph_part import PartitionBook
from repro_torch.core.rel_part import RelationPartition

MODES = 2  # 0: corrupt tail, 1: corrupt head


@dataclasses.dataclass
class KGBatch:
    """Single-machine batch: ids are global table rows."""

    h: np.ndarray  # (b,)
    r: np.ndarray  # (b,)
    t: np.ndarray  # (b,)
    neg: np.ndarray  # (MODES, n_groups, k) shared negative entity rows
    n_groups: int

    @property
    def group_size(self) -> int:
        return self.h.shape[0] // self.n_groups


@dataclasses.dataclass
class NaiveBatch:
    """Independent corruption (the baseline the paper improves on)."""

    h: np.ndarray
    r: np.ndarray
    t: np.ndarray
    neg: np.ndarray  # (MODES, b, k) per-triplet negatives

    def distinct_entities(self) -> int:
        return len(
            np.unique(np.concatenate([self.h, self.t, self.neg.reshape(-1)]))
        )


def batch_distinct_entities(b: KGBatch) -> int:
    return len(np.unique(np.concatenate([b.h, b.t, b.neg.reshape(-1)])))


class TripletSampler:
    """Uniform positive-triplet sampler over a triplet array."""

    def __init__(self, triplets: np.ndarray, rng: np.random.Generator):
        self.triplets = triplets
        self.rng = rng

    def positives(self, b: int) -> np.ndarray:
        idx = self.rng.integers(0, self.triplets.shape[0], size=b)
        return self.triplets[idx]


class JointSampler(TripletSampler):
    """T1 + T2 sampler for single-machine training."""

    def __init__(
        self,
        triplets: np.ndarray,
        n_entities: int,
        cfg: KGEConfig,
        rng: Optional[np.random.Generator] = None,
        candidate_pool: Optional[np.ndarray] = None,  # T3: local entities
    ):
        super().__init__(triplets, rng or np.random.default_rng(0))
        self.n_entities = n_entities
        self.cfg = cfg
        self.pool = candidate_pool

    def _uniform_negs(self, n: int) -> np.ndarray:
        if self.pool is not None:
            return self.pool[self.rng.integers(0, self.pool.size, size=n)]
        return self.rng.integers(0, self.n_entities, size=n)

    def _inbatch_negs(self, pos: np.ndarray, n: int, mode: int) -> np.ndarray:
        """T2: sample triplets uniformly, take their head (tail) entities —
        an entity distribution proportional to in-batch degree."""
        idx = self.rng.integers(0, pos.shape[0], size=n)
        col = 2 if mode == 0 else 0  # corrupting tails -> use batch tails, etc.
        return pos[idx, col]

    def sample(self) -> KGBatch:
        cfg = self.cfg
        pos = self.positives(cfg.batch_size)
        ng = cfg.n_neg_groups
        k = cfg.neg_sample_size
        n_deg = int(round(k * cfg.neg_deg_ratio))
        neg = np.empty((MODES, ng, k), dtype=np.int64)
        for m in range(MODES):
            for g in range(ng):
                u = self._uniform_negs(k - n_deg)
                d = self._inbatch_negs(pos, n_deg, m)
                neg[m, g] = np.concatenate([u, d])
        return KGBatch(
            h=pos[:, 0].copy(),
            r=pos[:, 1].copy(),
            t=pos[:, 2].copy(),
            neg=neg,
            n_groups=ng,
        )


class NaiveSampler(TripletSampler):
    """Independent per-triplet corruption — the O(b·k·d) baseline."""

    def __init__(self, triplets, n_entities, cfg, rng=None):
        super().__init__(triplets, rng or np.random.default_rng(0))
        self.n_entities = n_entities
        self.cfg = cfg

    def sample(self) -> NaiveBatch:
        cfg = self.cfg
        pos = self.positives(cfg.batch_size)
        neg = self.rng.integers(
            0, self.n_entities, size=(MODES, cfg.batch_size, cfg.neg_sample_size)
        )
        return NaiveBatch(h=pos[:, 0], r=pos[:, 1], t=pos[:, 2], neg=neg)


# ===========================================================================
# Distributed batches (T3 + T4 + KVStore capacity machinery)
# ===========================================================================
@dataclasses.dataclass
class DistBatch:
    """Per-machine fixed-shape buffers, stacked on a leading machine axis P.

    Entity workspace on machine p = [local rows (L) ; remote rows (P*Rp)];
    relation workspace        = [local rows (Lr); remote rows (P*Rrp)];
    shared (split) relations live in a small replicated table addressed by
    ``rel_shared`` (-1 when the triplet's relation is owned).
    """

    ent_local_ids: np.ndarray  # (P, L) machine-local entity rows, -1 pad
    ent_remote_req: np.ndarray  # (P, P, Rp) peer-local entity rows, -1 pad
    h_slot: np.ndarray  # (P, b) workspace slots
    t_slot: np.ndarray  # (P, b)
    neg_slot: np.ndarray  # (P, MODES, n_groups, k) workspace slots (local only)
    rel_local_ids: np.ndarray  # (P, Lr) machine-local relation slots, -1 pad
    rel_remote_req: np.ndarray  # (P, P, Rrp)
    rel_slot: np.ndarray  # (P, b) relation-workspace slots
    rel_shared: np.ndarray  # (P, b) shared-table row or -1
    n_groups: int
    # diagnostics
    remote_rows_used: int = 0
    dropped_triplets: int = 0

    @property
    def stats(self):
        return {
            "remote_rows_used": self.remote_rows_used,
            "dropped": self.dropped_triplets,
        }


class DistSampler:
    """Builds DistBatch buffers for the distributed KGE step (one process per
    rank; each rank keeps its machine's row).

    Triplets are assigned to the METIS part of their head entity; tails (and
    relations) may be remote, fetched under capacity. Negatives are sampled
    from the local partition only (T3), so they never add network traffic.
    """

    def __init__(
        self,
        triplets: np.ndarray,
        book: PartitionBook,
        relpart: RelationPartition,
        cfg: KGEConfig,
        rng: Optional[np.random.Generator] = None,
    ):
        self.cfg = cfg
        self.book = book
        self.relpart = relpart
        self.rng = rng or np.random.default_rng(0)
        P = book.n_parts
        hp = book.part_of[triplets[:, 0]]
        self.part_triplets = [triplets[hp == p] for p in range(P)]
        # entities local to each part (for T3 negatives)
        self.part_entities = [
            np.where(book.part_of == p)[0] for p in range(P)
        ]
        self.P = P
        k = cfg.neg_sample_size
        # worst-case uniques + resampling slack
        self.L = 3 * cfg.batch_size + MODES * cfg.n_neg_groups * k
        self.Rp = max(1, cfg.remote_capacity // P)
        self.Lr = cfg.batch_size
        self.Rrp = max(1, max(8, cfg.remote_capacity // 8) // P)

    def sample(self) -> DistBatch:
        cfg, book, rp = self.cfg, self.book, self.relpart
        P, b = self.P, cfg.batch_size
        k, ng = cfg.neg_sample_size, cfg.n_neg_groups
        L, Rp, Lr, Rrp = self.L, self.Rp, self.Lr, self.Rrp

        ent_local = np.full((P, L), -1, np.int32)
        ent_req = np.full((P, P, Rp), -1, np.int32)
        h_slot = np.zeros((P, b), np.int32)
        t_slot = np.zeros((P, b), np.int32)
        neg_slot = np.zeros((P, MODES, ng, k), np.int32)
        rel_local = np.full((P, Lr), -1, np.int32)
        rel_req = np.full((P, P, Rrp), -1, np.int32)
        rel_slot = np.zeros((P, b), np.int32)
        rel_shared = np.full((P, b), -1, np.int32)
        dropped = 0
        remote_used = 0

        for p in range(P):
            trip = self.part_triplets[p]
            if trip.shape[0] == 0:
                continue
            # --- draw local positives, with resampling on capacity overflow
            idx = self.rng.integers(0, trip.shape[0], size=b)
            pos = trip[idx]
            lmap: dict = {}  # machine-local entity row -> local slot
            rmap: dict = {}  # (peer, peer-local row) -> remote slot index
            req_fill = np.zeros(P, np.int32)

            def local_slot(ent: int) -> int:
                row = int(book.local_row[ent])
                s = lmap.get(row)
                if s is None:
                    s = len(lmap)
                    lmap[row] = s
                    ent_local[p, s] = row
                return s

            def remote_slot(ent: int) -> int:
                owner = int(book.part_of[ent])
                row = int(book.local_row[ent])
                key = (owner, row)
                s = rmap.get(key)
                if s is None:
                    if req_fill[owner] >= Rp:
                        return -1  # capacity exceeded
                    s = owner * Rp + req_fill[owner]
                    ent_req[p, owner, req_fill[owner]] = row
                    req_fill[owner] += 1
                    rmap[key] = s
                return s

            # --- relations: local/remote/shared (T4 ownership)
            rel_lmap: dict = {}
            rel_rmap: dict = {}
            rel_req_fill = np.zeros(P, np.int32)

            def relation_slot(rel: int) -> Tuple[int, int]:
                """(workspace slot, shared row) — one of them is -1."""
                if rp.owner[rel] < 0:
                    return -1, int(rp.slot[rel])
                owner, slot = int(rp.owner[rel]), int(rp.slot[rel])
                if owner == p:
                    s = rel_lmap.get(slot)
                    if s is None:
                        s = len(rel_lmap)
                        rel_lmap[slot] = s
                        rel_local[p, s] = slot
                    return s, -1
                key = (owner, slot)
                s = rel_rmap.get(key)
                if s is None:
                    if rel_req_fill[owner] >= Rrp:
                        return -2, -1  # capacity exceeded
                    s = Lr + owner * Rrp + rel_req_fill[owner]
                    rel_req[p, owner, rel_req_fill[owner]] = slot
                    rel_req_fill[owner] += 1
                    rel_rmap[key] = s
                return s, -1

            for i in range(b):
                committed = False
                for _attempt in range(17):
                    h, r, t = int(pos[i, 0]), int(pos[i, 1]), int(pos[i, 2])
                    rs, sh = relation_slot(r)
                    if rs == -2:  # relation remote capacity exceeded
                        ok, ts_final = False, 0
                    elif book.part_of[t] == p:
                        ok, ts_final = True, local_slot(t)
                    else:
                        s = remote_slot(t)
                        ok, ts_final = (s >= 0), L + max(s, 0)
                    if ok:
                        h_slot[p, i] = local_slot(h)
                        t_slot[p, i] = ts_final
                        rel_slot[p, i] = max(rs, 0)
                        rel_shared[p, i] = sh
                        committed = True
                        break
                    dropped += 1  # resample another local triplet
                    pos[i] = trip[int(self.rng.integers(0, trip.shape[0]))]
                if not committed:
                    # degenerate filler: score h against itself w/ relation 0
                    hs = local_slot(int(pos[i, 0]))
                    h_slot[p, i] = hs
                    t_slot[p, i] = hs
                    rel_slot[p, i] = 0
                    rel_shared[p, i] = -1 if rp.n_shared == 0 else 0

            # --- negatives from the local partition (T3) + in-batch (T2)
            ents = self.part_entities[p]
            n_deg = int(round(k * cfg.neg_deg_ratio))
            for m in range(MODES):
                col = 2 if m == 0 else 0  # corrupting tails -> batch tails
                for g in range(ng):
                    cand = ents[self.rng.integers(0, ents.size, size=k)]
                    inb = pos[self.rng.integers(0, b, size=n_deg), col]
                    keep = book.part_of[inb] == p  # in-batch, but stay local
                    cand[: n_deg][keep] = inb[keep]
                    for j, e in enumerate(cand):
                        neg_slot[p, m, g, j] = local_slot(int(e))
            remote_used += int((ent_req[p] >= 0).sum())

        return DistBatch(
            ent_local_ids=ent_local,
            ent_remote_req=ent_req,
            h_slot=h_slot,
            t_slot=t_slot,
            neg_slot=neg_slot,
            rel_local_ids=rel_local,
            rel_remote_req=rel_req,
            rel_slot=rel_slot,
            rel_shared=rel_shared,
            n_groups=ng,
            remote_rows_used=remote_used,
            dropped_triplets=dropped,
        )
