"""Embedding-table initialisation scale (RotatE-codebase init, which DGL-KE
is built on). The tables themselves are made by core/kge_model.init_state."""

from __future__ import annotations

from repro_torch.common.config import KGEConfig


def emb_init_scale(cfg: KGEConfig) -> float:
    # RotatE-codebase init (DGL-KE is built on it): (gamma + eps) / dim
    return (cfg.gamma + 2.0) / cfg.dim
