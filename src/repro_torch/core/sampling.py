"""Host-side mini-batch construction (paper §3.3, T1/T2), numpy.

The single-machine samplers of the JAX package's core/sampling.py, copied so
that the same seed gives the same batch stream in both packages:

  * **joint** (T1): a group of ``g`` triplets shares one pool of ``k``
    corrupting entities, so the negative scores become a pairwise product;
  * **degree-based / in-batch** (T2): part of each pool is drawn from the
    entities already in the batch (proportional to in-batch degree);
  * **naive**: independent corruption per triplet, the O(b·k·d) baseline.

Both head- and tail-corruption modes are generated (modes axis = 2). The
distributed sampler (T3 local negatives) waits for the distributed slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.common.config import KGEConfig

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
