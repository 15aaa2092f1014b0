"""FFN layers of the LM zoo: the dense (gated / gelu) FFN.

A port of ``ffn_defs`` and ``ffn_apply`` of the JAX package's
models/moe.py. The Mixture-of-Experts layer (``moe_defs``, ``moe_apply``)
waits for ROADMAP Queue A10 (MoE: mixtral, dbrx); ``build_model`` refuses
MoE configs.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.config import ArchConfig
from repro_torch.models.layers import ParamDef, activation_fn, matmul

Params = Dict[str, torch.Tensor]


def ffn_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    out = {
        "w_up": ParamDef((d, ff), init="fan_in"),
        "w_down": ParamDef((ff, d), init="fan_in"),
    }
    if cfg.activation == "silu":
        out["w_gate"] = ParamDef((d, ff), init="fan_in")
    return out


def ffn_apply(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    h = matmul(x, params["w_up"])
    if "w_gate" in params:
        h = act(matmul(x, params["w_gate"])) * h
    else:
        h = act(h)
    return matmul(h, params["w_down"])
