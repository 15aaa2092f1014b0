"""KGE losses (paper §2): logistic and pairwise ranking, plus the
self-adversarial negative weighting of the RotatE codebase DGL-KE builds on."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def logistic_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor) -> torch.Tensor:
    """softplus(-y * f): y=+1 positives, y=-1 negatives. Mean over all."""
    return torch.mean(F.softplus(-pos_scores)) + torch.mean(F.softplus(neg_scores))


def ranking_loss(
    pos_scores: torch.Tensor, neg_scores: torch.Tensor, margin: float = 1.0
) -> torch.Tensor:
    """max(0, margin - f(pos) + f(neg)), pos broadcast against its negatives.

    pos: (b,), neg: (b, k) — each positive paired with its negative set.
    """
    return torch.mean(torch.clamp_min(margin - pos_scores[:, None] + neg_scores, 0.0))


def self_adversarial_loss(
    pos_scores: torch.Tensor, neg_scores: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """RotatE-style: negatives weighted by softmax(T * f(neg)), stop-grad."""
    w = torch.softmax(temperature * neg_scores.detach(), dim=-1)
    lp = F.softplus(-pos_scores)
    ln = torch.sum(w * F.softplus(neg_scores), dim=-1)
    return torch.mean(lp) + torch.mean(ln)


def kge_loss(
    kind: str,
    pos_scores: torch.Tensor,
    neg_scores: torch.Tensor,
    margin: float = 1.0,
) -> torch.Tensor:
    if kind == "logistic":
        return logistic_loss(pos_scores, neg_scores)
    if kind == "ranking":
        return ranking_loss(pos_scores, neg_scores, margin)
    if kind == "self_adv":
        return self_adversarial_loss(pos_scores, neg_scores)
    raise ValueError(kind)
