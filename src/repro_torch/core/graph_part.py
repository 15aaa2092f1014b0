"""Graph partitioning (paper §3.2, T3), numpy only.

A copy of the JAX package's core/graph_part.py (the port imports nothing of
that package), so that the same seed gives the same partition in both.

DGL-KE uses METIS to min-cut partition the knowledge graph across machines so
that most triplets touch only machine-local entity embeddings. METIS itself is
not redistributable here; we implement a streaming min-cut partitioner with the
same objective (balanced parts, minimized edge cut): BFS-ordered **linear
deterministic greedy (LDG)** assignment — node v goes to the part with the most
already-assigned neighbors, damped by a balance penalty. On clustered graphs
this recovers most of the locality METIS finds; `cut_fraction` quantifies it
and benchmarks/bench_partitioning.py reproduces the paper's Fig. 7 comparison
against random partitioning.

A partition book maps global entity id -> (part, local_row), where local rows
are padded per part to a common `rows_per_part` so the entity table shards
evenly over the machine axis.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class PartitionBook:
    n_parts: int
    rows_per_part: int
    part_of: np.ndarray  # (n_entities,) int32
    local_row: np.ndarray  # (n_entities,) int32 row within the part
    part_sizes: np.ndarray  # (n_parts,)

    def global_row(self, ent: np.ndarray) -> np.ndarray:
        """Row in the concatenated (n_parts * rows_per_part, d) table."""
        return self.part_of[ent] * self.rows_per_part + self.local_row[ent]

    @property
    def n_rows(self) -> int:
        return self.n_parts * self.rows_per_part


def _csr(triplets: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected adjacency in CSR form."""
    src = np.concatenate([triplets[:, 0], triplets[:, 2]])
    dst = np.concatenate([triplets[:, 2], triplets[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst.astype(np.int64)


def random_partition(n_entities: int, n_parts: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_parts, size=n_entities).astype(np.int32)


def metis_like_partition(
    triplets: np.ndarray, n_entities: int, n_parts: int, seed: int = 0
) -> np.ndarray:
    """BFS-ordered LDG streaming partition. Returns part_of (n_entities,)."""
    if n_parts == 1:
        return np.zeros(n_entities, dtype=np.int32)
    indptr, nbrs = _csr(triplets, n_entities)
    deg = np.diff(indptr)
    rng = np.random.default_rng(seed)

    # BFS order from high-degree seeds (keeps clusters contiguous in stream)
    order = np.empty(n_entities, dtype=np.int64)
    visited = np.zeros(n_entities, dtype=bool)
    pos = 0
    by_deg = np.argsort(-deg, kind="stable")
    from collections import deque

    q: deque = deque()
    for seed_node in by_deg:
        if visited[seed_node]:
            continue
        q.append(seed_node)
        visited[seed_node] = True
        while q:
            v = q.popleft()
            order[pos] = v
            pos += 1
            for u in nbrs[indptr[v] : indptr[v + 1]]:
                if not visited[u]:
                    visited[u] = True
                    q.append(u)
    assert pos == n_entities

    cap = 1.02 * n_entities / n_parts + 1
    part_of = np.full(n_entities, -1, dtype=np.int32)
    sizes = np.zeros(n_parts, dtype=np.int64)
    score = np.empty(n_parts, dtype=np.float64)
    for v in order:
        ns = nbrs[indptr[v] : indptr[v + 1]]
        score[:] = 0.0
        if ns.size:
            ps = part_of[ns]
            ps = ps[ps >= 0]
            if ps.size:
                np.add.at(score, ps, 1.0)
        score *= 1.0 - sizes / cap
        score += rng.random(n_parts) * 1e-9  # tie-break
        score[sizes >= cap] = -np.inf
        p = int(np.argmax(score))
        part_of[v] = p
        sizes[p] += 1
    return part_of


def make_partition_book(
    part_of: np.ndarray, n_parts: int, multiple: int = 8
) -> PartitionBook:
    n = part_of.shape[0]
    local_row = np.zeros(n, dtype=np.int32)
    sizes = np.zeros(n_parts, dtype=np.int64)
    for p in range(n_parts):
        idx = np.where(part_of == p)[0]
        local_row[idx] = np.arange(idx.size, dtype=np.int32)
        sizes[p] = idx.size
    rows = int(sizes.max()) if n else 1
    rows = ((rows + multiple - 1) // multiple) * multiple
    return PartitionBook(
        n_parts=n_parts,
        rows_per_part=rows,
        part_of=part_of.astype(np.int32),
        local_row=local_row,
        part_sizes=sizes,
    )


def cut_fraction(triplets: np.ndarray, part_of: np.ndarray) -> float:
    """Fraction of triplets whose head and tail live in different parts."""
    return float(np.mean(part_of[triplets[:, 0]] != part_of[triplets[:, 2]]))


def partition(
    triplets: np.ndarray,
    n_entities: int,
    n_parts: int,
    method: str = "metis",
    seed: int = 0,
) -> PartitionBook:
    if method == "metis":
        part_of = metis_like_partition(triplets, n_entities, n_parts, seed)
    elif method == "random":
        part_of = random_partition(n_entities, n_parts, seed)
    else:
        raise ValueError(method)
    return make_partition_book(part_of, n_parts)
