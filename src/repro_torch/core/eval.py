"""Link-prediction evaluation (paper §5.3): Hit@k, MR, MRR.

A port of the JAX package's core/eval.py. Two protocols, as in the paper:
  * protocol 1 (FB15k/WN18): rank the positive against *all* entities,
    filtered — candidate triplets that exist in the dataset are removed.
  * protocol 2 (Freebase): rank against 2000 sampled negatives — 1000
    uniform + 1000 degree-proportional — unfiltered.

Scoring runs under ``torch.no_grad()`` on the state's device and goes
through ``scores.negative_score``, so on the card the pairwise kernel
(csrc/pairwise.cu) scores every candidate. Ranks use a strict ``>``: a
candidate tied with the positive does not push it down.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.common.config import KGEConfig
from repro_torch.core import scores as S
from repro_torch.core.kge_model import KGEState
from repro_torch.embeddings.table import emb_init_scale


@dataclasses.dataclass
class Metrics:
    mrr: float
    mr: float
    hits1: float
    hits3: float
    hits10: float
    n: int

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    def __str__(self):
        return (
            f"MRR {self.mrr:.4f} | MR {self.mr:.1f} | Hit@1 {self.hits1:.4f} "
            f"| Hit@3 {self.hits3:.4f} | Hit@10 {self.hits10:.4f} (n={self.n})"
        )


def _ids(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int64).to(device)


def _candidate_scores(
    cfg: KGEConfig, state: KGEState, h, r, t, cand, corrupt: str,
    q_chunk: int = 64,
) -> torch.Tensor:
    """Scores of (q, C) candidate corruptions. ``cand``: None for every
    entity in order (protocol 1: the table itself, one pairwise call), or
    (q, C) ids, one row per query (protocol 2).

    Per-query candidates are one grouped pairwise call for ``q_chunk``
    queries at a time (G = queries, B = 1, K = C), so peak memory is the
    (q_chunk, C, d) candidate gather rather than the full (q, C, d).
    """
    scale = emb_init_scale(cfg)
    ctx = S.ShardCtx(None)
    e = state.entity[h if corrupt == "tail" else t]
    rr = state.r_emb[r]
    pr = None if state.r_proj is None else state.r_proj[r]
    if cand is None:
        return S.negative_score(
            cfg.model, e, rr, state.entity, corrupt, cfg.gamma, ctx,
            r_proj=pr, rel_dim=cfg.rel_dim, emb_scale=scale,
        )
    out = []
    qc = max(1, q_chunk)
    for i in range(0, cand.shape[0], qc):
        sl = slice(i, i + qc)
        out.append(S.negative_score(
            cfg.model, e[sl, None], rr[sl, None], state.entity[cand[sl]],
            corrupt, cfg.gamma, ctx,
            r_proj=None if pr is None else pr[sl, None],
            rel_dim=cfg.rel_dim, emb_scale=scale)[:, 0])
    return torch.cat(out)


def _pos_scores(cfg, state, h, r, t) -> torch.Tensor:
    scale = emb_init_scale(cfg)
    pr = None if state.r_proj is None else state.r_proj[r]
    return S.positive_score(
        cfg.model, state.entity[h], state.r_emb[r], state.entity[t],
        cfg.gamma, S.ShardCtx(None), r_proj=pr, rel_dim=cfg.rel_dim,
        emb_scale=scale,
    )


@torch.no_grad()
def ranks_against_all(
    cfg: KGEConfig,
    state: KGEState,
    test: np.ndarray,
    filter_map: Optional[Dict] = None,
    chunk: int = 512,
) -> np.ndarray:
    """Protocol 1 ranks (both corruption sides), optionally filtered.

    filter_map: {('t', h, r): set(tails), ('h', t, r): set(heads)} of known
    true triplets to exclude. Returns the tail-side ranks of every query,
    then the head-side ones.
    """
    dev = state.entity.device
    ranks = []
    for corrupt in ("tail", "head"):
        for i in range(0, test.shape[0], chunk):
            ch = test[i: i + chunk]
            h, r, t = (_ids(ch[:, j], dev) for j in range(3))
            cand_s = _candidate_scores(cfg, state, h, r, t, None, corrupt)
            pos_s = _pos_scores(cfg, state, h, r, t)
            cand_s = cand_s.cpu().numpy()
            pos_s = pos_s.cpu().numpy()
            for q in range(ch.shape[0]):
                s = cand_s[q]
                if filter_map is not None:
                    key = ("t", int(ch[q, 0]), int(ch[q, 1])) if corrupt == "tail" else (
                        "h", int(ch[q, 2]), int(ch[q, 1]))
                    known = filter_map.get(key)
                    if known:
                        s = s.copy()
                        s[list(known)] = -np.inf
                ranks.append(1 + int(np.sum(s > pos_s[q])))
    return np.asarray(ranks)


@torch.no_grad()
def ranks_protocol2(
    cfg: KGEConfig,
    state: KGEState,
    test: np.ndarray,
    degrees: np.ndarray,
    n_uniform: int = 1000,
    n_degree: int = 1000,
    rng: Optional[np.random.Generator] = None,
    chunk: int = 256,
    q_chunk: int = 64,
) -> np.ndarray:
    """Protocol 2 (Freebase): 2000 sampled negatives, unfiltered.

    ``chunk`` bounds host-side work per dispatch; ``q_chunk`` bounds device
    peak memory (queries scored at once — see ``_candidate_scores``). The
    candidates are drawn from ``rng`` in the JAX package's order, so the same
    generator gives the same candidates.
    """
    rng = rng or np.random.default_rng(0)
    dev = state.entity.device
    p = degrees / degrees.sum()
    ranks = []
    for corrupt in ("tail", "head"):
        for i in range(0, test.shape[0], chunk):
            ch = test[i: i + chunk]
            q = ch.shape[0]
            uni = rng.integers(0, cfg.n_entities, size=(q, n_uniform))
            deg = rng.choice(cfg.n_entities, size=(q, n_degree), p=p)
            cand = _ids(np.concatenate([uni, deg], axis=1), dev)
            h, r, t = (_ids(ch[:, j], dev) for j in range(3))
            cand_s = _candidate_scores(cfg, state, h, r, t, cand, corrupt,
                                       q_chunk=q_chunk)
            pos_s = _pos_scores(cfg, state, h, r, t)
            rank = 1 + (cand_s > pos_s[:, None]).sum(1)
            ranks.extend(rank.cpu().tolist())
    return np.asarray(ranks)


def metrics_from_ranks(ranks: np.ndarray) -> Metrics:
    r = ranks.astype(np.float64)
    return Metrics(
        mrr=float(np.mean(1.0 / r)),
        mr=float(np.mean(r)),
        hits1=float(np.mean(r <= 1)),
        hits3=float(np.mean(r <= 3)),
        hits10=float(np.mean(r <= 10)),
        n=int(r.size),
    )


def build_filter_map(triplets: np.ndarray) -> Dict:
    fm: Dict = {}
    for h, r, t in triplets:
        fm.setdefault(("t", int(h), int(r)), set()).add(int(t))
        fm.setdefault(("h", int(t), int(r)), set()).add(int(h))
    return fm
