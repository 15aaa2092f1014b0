"""The benchmark's knowledge graph: a frozen copy of the port's generator.

Copied from ``src/repro_torch/data/kg_synth.py`` (``make_synthetic_kg``) at
commit 481f696, so a later change to the program cannot change the data
the benchmark trains on. The same parameters and seed give the identical
graph. A dataset is fixed, so a configuration states its generator seed and
``--seed`` does not change it.

Generating FB15k's 592,213 triplets takes seconds of numpy on the host, so
the train split is kept in a cache file inside the checkout
(``kgebench/.cache/``, named by a hash of this file and the parameters):
only the first run in a checkout pays the generation, as only the first
run pays the kernels' build.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

CACHE_DIR = Path(__file__).resolve().parent / ".cache"


def make_train_triplets(
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
) -> np.ndarray:
    """The train split (E_train, 3) [h, r, t] of ``make_synthetic_kg``."""
    rng = np.random.default_rng(seed)

    centers = rng.normal(0, 4.0, size=(n_clusters, latent_dim))
    cluster_of = rng.integers(0, n_clusters, size=n_entities)
    latent = centers[cluster_of] + rng.normal(0, 1.0, size=(n_entities, latent_dim))

    v = rng.normal(0, 0.6, size=(n_relations, latent_dim))
    jump = rng.random(n_relations) < cross_cluster_frac
    tgt_cluster = rng.integers(0, n_clusters, size=n_relations)

    w = (1.0 + np.arange(n_entities)) ** (-zipf_a)
    w = w[rng.permutation(n_entities)]
    w /= w.sum()

    rw = (1.0 + np.arange(n_relations)) ** (-1.0)
    rw = rw[rng.permutation(n_relations)]
    rw /= rw.sum()

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
        d2c = ((target[:, None, :] - centers[None]) ** 2).sum(-1)
        tc = np.argmin(d2c, axis=1)
        draws = (rng.random((m, n_cand)) * csizes[tc][:, None]).astype(np.int64)
        cand = members[tc[:, None], draws]
        d = ((latent[cand] - target[:, None, :]) ** 2).sum(-1)
        t = cand[np.arange(m), np.argmin(d, axis=1)]
        triplets[start : start + m, 0] = h
        triplets[start : start + m, 1] = r
        triplets[start : start + m, 2] = t

    rng.shuffle(triplets)
    n_valid = int(n_edges * valid_frac)
    n_test = int(n_edges * test_frac)
    return triplets[n_valid + n_test :]


def train_triplets(params: dict) -> np.ndarray:
    """The train split for a configuration's ``dataset`` parameters, from
    the checkout's cache when an earlier run made it."""
    key = hashlib.sha256(Path(__file__).read_bytes())
    key.update(json.dumps(params, sort_keys=True).encode())
    path = CACHE_DIR / f"train-{key.hexdigest()[:16]}.npy"
    if path.exists():
        return np.load(path)
    train = make_train_triplets(**params)
    CACHE_DIR.mkdir(exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.save(f, train)
    os.replace(tmp, path)  # atomic: a concurrent run sees a whole file
    return train
