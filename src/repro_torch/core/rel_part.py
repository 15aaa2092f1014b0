"""Relation partitioning (paper §3.4, T4), numpy only.

A copy of the JAX package's core/rel_part.py (the port imports nothing of
that package), so that the same seed gives the same assignment in both.

Greedy frequency-sorted bin-packing of relations onto compute units:
  * sort relations by frequency, non-increasing;
  * assign each to the partition with the fewest triplets so far;
  * relations more frequent than a partition's fair share are **split**:
    their triplets are spread across all partitions. Split-relation
    embeddings cannot be single-owner, so they live in a small *replicated*
    table whose gradients are psum'd each step (the synchronous analogue of
    the paper's "updated by more than one process").
  * per-epoch reshuffling (``seed``) restores SGD randomization, as §3.4
    prescribes.

The result is a ``RelationPartition`` mapping every relation to either
(part, slot) ownership or a shared slot.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class RelationPartition:
    n_parts: int
    slots_per_part: int
    owner: np.ndarray  # (n_relations,) int32 part id, -1 if shared
    slot: np.ndarray  # (n_relations,) int32 slot within owner / shared table
    n_shared: int
    triplet_load: np.ndarray  # (n_parts,) triplets per part (balance metric)

    def owned_row(self, rel: np.ndarray) -> np.ndarray:
        """Row in the (n_parts * slots_per_part, d) owned table (-1 if shared)."""
        row = self.owner * self.slots_per_part + self.slot
        return np.where(self.owner[rel] >= 0, row[rel], -1).astype(np.int32)

    @property
    def max_rel_per_part(self) -> int:
        return self.slots_per_part


def relation_partition(
    rel_counts: np.ndarray,
    n_parts: int,
    seed: int = 0,
    split_threshold: float = 1.0,
    multiple: int = 8,
) -> RelationPartition:
    """rel_counts[r] = #triplets with relation r."""
    n_rel = rel_counts.shape[0]
    total = int(rel_counts.sum())
    fair = total / max(1, n_parts)
    rng = np.random.default_rng(seed)

    owner = np.full(n_rel, -1, dtype=np.int32)
    slot = np.zeros(n_rel, dtype=np.int32)
    load = np.zeros(n_parts, dtype=np.int64)
    slots_used = np.zeros(n_parts, dtype=np.int32)

    # split over-frequent relations (they exceed a fair partition share)
    shared = np.where(rel_counts > split_threshold * fair)[0]
    n_shared = shared.size
    slot[shared] = np.arange(n_shared, dtype=np.int32)
    load += int(rel_counts[shared].sum() // max(1, n_parts))  # spread evenly

    rest = np.where(rel_counts <= split_threshold * fair)[0]
    # frequency sort, with per-epoch random tie-shuffle (paper randomization)
    keys = rel_counts[rest].astype(np.float64) + rng.random(rest.size) * 0.5
    rest = rest[np.argsort(-keys, kind="stable")]
    for r in rest:
        p = int(np.argmin(load))
        owner[r] = p
        slot[r] = slots_used[p]
        slots_used[p] += 1
        load[p] += int(rel_counts[r])

    slots = int(slots_used.max()) if n_parts else 1
    slots = max(multiple, ((slots + multiple - 1) // multiple) * multiple)
    return RelationPartition(
        n_parts=n_parts,
        slots_per_part=slots,
        owner=owner,
        slot=slot,
        n_shared=n_shared,
        triplet_load=load,
    )


def load_imbalance(part: RelationPartition) -> float:
    """max/mean triplet load — 1.0 is perfect balance."""
    m = part.triplet_load.mean()
    return float(part.triplet_load.max() / m) if m else 1.0


def distinct_relations_per_batch(
    rels: np.ndarray, part: RelationPartition, batch_of: np.ndarray
) -> Tuple[float, float]:
    """Diagnostic for the paper's §3.4 claim: with relation partitioning a
    compute unit touches fewer distinct relations per batch."""
    uniq_all = len(np.unique(rels))
    per_part = [
        len(np.unique(rels[batch_of == p])) for p in range(part.n_parts)
    ]
    return float(np.mean(per_part)), float(uniq_all)
