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


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of a nested dict, in insertion order; with
    ``rest``, on the leaves of several trees of ``tree``'s structure (a
    leaf of ``tree`` may stand over a subtree of the others)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


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


# ----------------------------------------------------------------- cross entropy
def cross_entropy_logits(logits: torch.Tensor, labels: torch.Tensor,
                         vocab: int) -> torch.Tensor:
    """Mean next-token CE of logits (..., V) in f32. As in JAX, ``vocab``
    is not read: the log-sum-exp runs over every column, the padded ones
    too (their logits are not zero: ``tok_emb`` and ``unembed`` draw them
    like the rest)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def chunked_cross_entropy(x: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
                          chunk: int) -> torch.Tensor:
    """JAX's streaming-softmax CE over vocab tiles of ``chunk`` columns: x
    (B, T, D) final hidden states, unembed (D, Vp), labels (B, T). The (B,
    T, Vp) logits are never held whole: each tile's body runs under
    ``torch.utils.checkpoint``, so the backward recomputes its logits, as
    JAX's ``@jax.checkpoint`` scan body does."""
    from torch.utils.checkpoint import checkpoint

    D, Vp = unembed.shape
    assert Vp % chunk == 0, (Vp, chunk)
    tiles = unembed.T.reshape(Vp // chunk, chunk, D)
    B, T = labels.shape
    labels = labels.long()
    m = torch.full((B, T), -1e30, dtype=torch.float32, device=x.device)  # running max
    s = torch.zeros((B, T), dtype=torch.float32, device=x.device)  # sum exp(l - m)
    lab = torch.zeros((B, T), dtype=torch.float32, device=x.device)  # label logit

    def body(m, s, lab, w, idx: int):
        logits = matmul(x, w.T).float()  # (B, T, chunk)
        cm = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - cm) + torch.exp(logits - cm[..., None]).sum(dim=-1)
        loc = labels - idx * chunk
        hit = (loc >= 0) & (loc < chunk)
        ll = torch.gather(logits, -1, loc.clamp(0, chunk - 1)[..., None])[..., 0]
        return cm, s, lab + torch.where(hit, ll, 0.0)

    for i in range(Vp // chunk):
        m, s, lab = checkpoint(body, m, s, lab, tiles[i], i, use_reentrant=False)
    return torch.mean(torch.log(s) + m - lab)
