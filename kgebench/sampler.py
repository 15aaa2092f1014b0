"""The reference's joint sampler: a frozen copy of the port's.

Copied from ``src/repro_torch/core/sampling.py`` (``TripletSampler``,
``JointSampler.sample``) at commit 481f696. The reference draws its batches
with it from the run's seed, so a change to the program's sampler shows as
batches that differ from these.

A batch: ``pos`` triplets drawn uniformly from the train split, and for
each corruption side (0: tails, 1: heads) and group of triplets one shared
pool of ``k`` negatives, ``k - round(k * deg_ratio)`` uniform entities and
the rest the tails (heads) of uniformly drawn triplets of the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

MODES = 2  # 0: corrupt tail, 1: corrupt head


class Batch(NamedTuple):
    h: np.ndarray  # (b,)
    r: np.ndarray  # (b,)
    t: np.ndarray  # (b,)
    neg: np.ndarray  # (MODES, n_groups, k)


class JointSampler:
    def __init__(self, triplets: np.ndarray, n_entities: int, batch_size: int,
                 k: int, n_groups: int, deg_ratio: float,
                 rng: np.random.Generator):
        self.triplets = triplets
        self.n_entities = n_entities
        self.batch_size = batch_size
        self.k = k
        self.n_groups = n_groups
        self.deg_ratio = deg_ratio
        self.rng = rng

    def sample(self) -> Batch:
        rng, k = self.rng, self.k
        pos = self.triplets[rng.integers(0, self.triplets.shape[0],
                                         size=self.batch_size)]
        n_deg = int(round(k * self.deg_ratio))
        neg = np.empty((MODES, self.n_groups, k), dtype=np.int64)
        for m in range(MODES):
            col = 2 if m == 0 else 0  # corrupting tails -> the batch's tails
            for g in range(self.n_groups):
                u = rng.integers(0, self.n_entities, size=k - n_deg)
                d = pos[rng.integers(0, pos.shape[0], size=n_deg), col]
                neg[m, g] = np.concatenate([u, d])
        return Batch(pos[:, 0].copy(), pos[:, 1].copy(), pos[:, 2].copy(), neg)
