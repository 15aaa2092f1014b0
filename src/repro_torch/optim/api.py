"""Optimizer factory: a port of the JAX package's optim/api.py."""

from __future__ import annotations

from repro_torch.optim.dense import Optimizer, adafactor, adamw, sgd


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
