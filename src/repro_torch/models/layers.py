"""Parameter definitions, norms, rope and activations of the LM zoo.

A port of the JAX package's models/layers.py. Params are nested dicts of
tensors with the JAX package's keys and layouts. Every init site creates a
``ParamDef`` (shape, init rule, dtype); ``materialize`` draws real tensors
from a ``torch.Generator`` with the JAX package's rules (normal x scale,
fan_in 1/sqrt(shape[0]), ones, zeros). The numbers differ from
``jax.random``'s, so parity tests carry JAX's weights across
(``transformer.params_from_arrays``). The port has no mesh, so a def has no
sharding spec; a def that is one rank's slice of a global tensor (the
experts of an MoE layer over a model group of S ranks) says which slice
(``parts``, ``part``, ``axis``), and is drawn and carried across at the
global shape, then sliced.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | fan_in
    scale: float = 0.02
    dtype: torch.dtype = torch.float32
    # ``shape`` is slice ``part`` of ``parts`` equal slices of a global
    # tensor along ``axis`` (counted from the end, so stacking keeps it)
    parts: int = 1
    part: int = 0
    axis: int = -1

    @property
    def global_shape(self) -> Tuple[int, ...]:
        shape = list(self.shape)
        shape[self.axis] *= self.parts
        return tuple(shape)

    def local(self, a):
        """This def's slice of a global tensor or array ``a``."""
        if self.parts == 1:
            return a
        n = self.shape[self.axis]
        idx = [slice(None)] * len(self.shape)
        idx[self.axis] = slice(self.part * n, (self.part + 1) * n)
        return a[tuple(idx)]

    def materialize(self, gen: Optional[torch.Generator], device="cpu") -> torch.Tensor:
        """Draw on the generator's device, then move to ``device``; ``zeros``
        and ``ones`` need no generator.

        As in the JAX package, ``fan_in`` reads ``shape[0]``: for a def
        stacked over layers that is the layer count. A slice (``parts`` >
        1) draws the whole global tensor, so the generator's stream and the
        slice's numbers are those of the unsliced def; the global f32
        temporary is the cost."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        shape = self.global_shape
        std = self.scale
        if self.init == "fan_in":
            std = 1.0 / math.sqrt(shape[0])
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        x = self.local(x.mul_(std))  # one f32 temporary
        if self.parts > 1:
            x = x.clone(memory_format=torch.contiguous_format)  # frees the rest
        return x.to(device=device, dtype=self.dtype)


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def materialize(defs, gen: Optional[torch.Generator], device="cpu"):
    """Real tensors for a tree of defs, drawn from ``gen`` leaf by leaf."""
    return tree_map(lambda d: d.materialize(gen, device), defs)


def stack_defs(defs_list):
    """Stack per-layer defs along a leading scan axis."""
    d0 = defs_list[0]
    if isinstance(d0, dict):
        return {k: stack_defs([d[k] for d in defs_list]) for k in d0}
    return dataclasses.replace(d0, shape=(len(defs_list),) + tuple(d0.shape))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("float32", "bfloat16")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# --------------------------------------------------------------------------- ops
def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion: an f32 operand and a bf16 one
    multiply in f32 (torch.matmul refuses mixed types)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, n, dh) rotary on last dim; positions (..., T). The angle
    is computed in f32 as the JAX package computes it."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None, None].float() * freq  # (..., T, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _gelu(x):  # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]
