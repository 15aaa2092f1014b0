"""Synthetic knowledge-graph generation.

FB15k / WN18 / Freebase are not redistributable in this offline container, so
benchmarks train on *structure-matched* synthetic graphs:

  * **learnable**: entities get latent points ``z_e``; each relation is a
    latent translation ``v_r``; a triplet (h, r, t) is created by picking the
    entity nearest to ``z_h + v_r`` among candidates — so TransE-family models
    can genuinely fit the graph and accuracy benchmarks are meaningful.
  * **clustered**: entities live in clusters and candidates are drawn from the
    cluster nearest to the target point — giving the min-cut structure that
    makes METIS partitioning (paper §3.2) effective.
  * **degree-skewed**: head entities are drawn from a Zipf-like weighting, so
    degree-based negative sampling (paper T2) has something to bite on.

Dataset-scale presets mirror the paper's Table 3 row shapes.

This is the port's own copy of the JAX package's data/kg_synth.py (numpy
only): the same seed gives the identical graph in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticKG:
    n_entities: int
    n_relations: int
    triplets: np.ndarray  # (E, 3) [h, r, t]
    train: np.ndarray
    valid: np.ndarray
    test: np.ndarray
    cluster_of: np.ndarray  # (n_entities,) ground-truth clusters
    latent: np.ndarray  # (n_entities, m) ground-truth geometry

    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.n_entities, dtype=np.int64)
        np.add.at(deg, self.triplets[:, 0], 1)
        np.add.at(deg, self.triplets[:, 2], 1)
        return deg

    def rel_counts(self) -> np.ndarray:
        c = np.zeros(self.n_relations, dtype=np.int64)
        np.add.at(c, self.triplets[:, 1], 1)
        return c


def make_synthetic_kg(
    n_entities: int,
    n_relations: int,
    n_edges: int,
    n_clusters: int = 16,
    latent_dim: int = 16,
    zipf_a: float = 0.8,
    cross_cluster_frac: float = 0.1,
    seed: int = 0,
    valid_frac: float = 0.05,
    test_frac: float = 0.05,
) -> SyntheticKG:
    rng = np.random.default_rng(seed)

    # clustered latents
    centers = rng.normal(0, 4.0, size=(n_clusters, latent_dim))
    cluster_of = rng.integers(0, n_clusters, size=n_entities)
    latent = centers[cluster_of] + rng.normal(0, 1.0, size=(n_entities, latent_dim))

    # relation translations: most stay in-cluster (small), some jump clusters
    v = rng.normal(0, 0.6, size=(n_relations, latent_dim))
    jump = rng.random(n_relations) < cross_cluster_frac
    tgt_cluster = rng.integers(0, n_clusters, size=n_relations)
    # a jumping relation translates toward a fixed other cluster's center

    # degree skew for head sampling (Zipf-ish over a permutation)
    w = (1.0 + np.arange(n_entities)) ** (-zipf_a)
    w = w[rng.permutation(n_entities)]
    w /= w.sum()

    # relation frequencies are long-tailed too (paper §3.6)
    rw = (1.0 + np.arange(n_relations)) ** (-1.0)
    rw = rw[rng.permutation(n_relations)]
    rw /= rw.sum()

    # padded cluster->members table for fully vectorized candidate draws
    ents_by_cluster = [np.where(cluster_of == c)[0] for c in range(n_clusters)]
    csizes = np.array([e.size for e in ents_by_cluster], dtype=np.int64)
    members = np.zeros((n_clusters, max(1, int(csizes.max()))), dtype=np.int64)
    for c, e in enumerate(ents_by_cluster):
        if e.size:
            members[c, : e.size] = e

    triplets = np.empty((n_edges, 3), dtype=np.int64)
    chunk = 65536
    n_cand = 32
    for start in range(0, n_edges, chunk):
        m = min(chunk, n_edges - start)
        h = rng.choice(n_entities, size=m, p=w)
        r = rng.choice(n_relations, size=m, p=rw)
        target = latent[h] + v[r]
        target[jump[r]] = centers[tgt_cluster[r[jump[r]]]] + rng.normal(
            0, 1.0, size=(int(jump[r].sum()), latent_dim)
        )
        # nearest cluster to the target
        d2c = ((target[:, None, :] - centers[None]) ** 2).sum(-1)
        tc = np.argmin(d2c, axis=1)
        # vectorized: n_cand uniform draws from each row's target cluster
        draws = (rng.random((m, n_cand)) * csizes[tc][:, None]).astype(np.int64)
        cand = members[tc[:, None], draws]  # (m, n_cand)
        d = ((latent[cand] - target[:, None, :]) ** 2).sum(-1)
        t = cand[np.arange(m), np.argmin(d, axis=1)]
        triplets[start : start + m, 0] = h
        triplets[start : start + m, 1] = r
        triplets[start : start + m, 2] = t

    rng.shuffle(triplets)
    n_valid = int(n_edges * valid_frac)
    n_test = int(n_edges * test_frac)
    return SyntheticKG(
        n_entities=n_entities,
        n_relations=n_relations,
        triplets=triplets,
        train=triplets[n_valid + n_test :],
        valid=triplets[:n_valid],
        test=triplets[n_valid : n_valid + n_test],
        cluster_of=cluster_of,
        latent=latent,
    )


# ---- paper Table 3 shape-matched presets ----------------------------------
def fb15k_like(scale: float = 1.0, seed: int = 0) -> SyntheticKG:
    return make_synthetic_kg(
        n_entities=int(14_951 * scale),
        n_relations=max(8, int(1_345 * scale)),
        n_edges=int(592_213 * scale),
        n_clusters=16,
        seed=seed,
    )


def wn18_like(scale: float = 1.0, seed: int = 0) -> SyntheticKG:
    return make_synthetic_kg(
        n_entities=int(40_943 * scale),
        n_relations=max(4, int(18 * max(scale, 1.0))),
        n_edges=int(151_442 * scale),
        n_clusters=16,
        seed=seed,
    )


def freebase_like(scale: float = 0.001, seed: int = 0) -> SyntheticKG:
    """Freebase is 86M nodes / 338M edges; default preset is 0.1% scale —
    the *shape* (relations ≫ batch, heavy skew) is what matters for T2/T4."""
    return make_synthetic_kg(
        n_entities=max(1000, int(86_054_151 * scale)),
        n_relations=max(16, int(14_824 * scale * 10)),
        n_edges=max(10_000, int(338_586_276 * scale)),
        n_clusters=64,
        seed=seed,
    )
