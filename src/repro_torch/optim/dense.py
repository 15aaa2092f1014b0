"""Dense optimizers of the LM zoo: SGD, AdamW, Adafactor.

A port of the JAX package's optim/dense.py, with its functional API and
state trees:

    opt = Optimizer(init, update)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)

The state trees are JAX's: ``{"step"}`` (SGD), ``{"step", "mu"}`` (SGD
with momentum), ``{"step", "m", "v"}`` (AdamW) and ``{"step", "stats"}``
(Adafactor; a leaf of two or more dimensions keeps ``{"vr", "vc"}``, a
vector ``{"v"}``), so ``state_from_arrays`` carries JAX's state across.
``step`` is a 0-d int32 tensor. Where JAX returns new trees, ``update``
writes the parameters and the state in place, under ``torch.no_grad()``,
and returns the same tensors (a stated divergence, ROADMAP Queue C).

The arithmetic is JAX's, op for op: the step counter is cast to f32 and
every scalar of it (``b1**t``, ``b2**t``, ``t**(-decay)``) is an f32
tensor, not a Python float64; the elementwise chains keep JAX's order.

Adafactor treats each leaf as it is stored: under ``scan_layers`` a
stacked (G, ...) leaf has its ``vr``/``vc`` over its last two axes and
one RMS clip over the whole stack, nothing per layer. A leaf that is this
rank's slice of a global tensor (the experts of an MoE layer over a model
group) takes every mean that crosses its sliced axis over the ``group``
(``sliced``: the tree of ``(axis, parts)`` or None per leaf, as
``transformer.Model.sliced()`` gives it), so the step is JAX's on the
global tensor. SGD and AdamW are elementwise and need no group.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common import collectives
from repro_torch.models.layers import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]  # (params, grads, state) -> (params, state)


def _step0(params):
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _grad(p, g):
    """JAX hands every leaf a gradient; a leaf autograd never reached has a
    zero one."""
    return torch.zeros_like(p) if g is None else g


# --------------------------------------------------------------------------- SGD
def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params), "mu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(params, grads, state):
        if momentum == 0.0:
            def upd(p, g):
                p.sub_(lr * _grad(p, g).to(p.dtype))

            tree_map(upd, params, grads)
        else:
            def upd(p, g, m):
                m.mul_(momentum).add_(_grad(p, g).to(m.dtype))
                p.sub_(lr * m)

            tree_map(upd, params, grads, state["mu"])
        state["step"].add_(1)
        return params, state

    return Optimizer(init, update)


# --------------------------------------------------------------------------- AdamW
def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return {"step": _step0(params), "m": tree_map(z, params), "v": tree_map(z, params)}

    @torch.no_grad()
    def update(params, grads, state):
        state["step"].add_(1)
        t = state["step"].to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)

        def upd(p, g, m, v):
            g = _grad(p, g).float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.copy_(p.float() - lr * u)

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer(init, update)


# --------------------------------------------------------------------------- Adafactor
def _factored(shape) -> bool:
    return len(shape) >= 2


def stat_axis(stat: str, axis: Optional[int]) -> Optional[int]:
    """The axis (from the end) along which Adafactor's ``stat`` of a leaf
    sliced along ``axis`` is sliced too, or None where the stat is whole:
    ``v`` keeps the leaf's shape; ``vr`` drops the leaf's last axis, ``vc``
    its second to last (a mean over the sliced axis is whole on every
    rank)."""
    if axis is None:
        return None
    if stat == "v":
        return axis
    if stat == "vr":
        return None if axis == -1 else axis + 1
    return None if axis == -2 else (axis if axis == -1 else axis + 1)


def _mean(x: torch.Tensor, dim, keepdim: bool, sliced, group) -> torch.Tensor:
    """``x.mean(dim)`` of the global tensor whose local slice ``x`` is:
    where ``dim`` (an axis, or None for all) crosses the sliced axis, the
    sum over the group divided by the global count."""
    if sliced is None:
        return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
    axis, parts = sliced  # both axes counted from the end
    if dim is not None and dim != axis:
        return x.mean(dim=dim, keepdim=keepdim)
    s = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
    n = (x.numel() if dim is None else x.shape[dim]) * parts
    return collectives.all_reduce_sum(s, group) / n


def adafactor(lr: float, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, sliced=None, group=None) -> Optimizer:
    """Factored second moments (Shazeer & Stern 2018): a matrix keeps row
    and column statistics, a vector its full second moment; the update is
    clipped by its RMS. ``sliced`` and ``group``: see the module
    docstring."""

    def init(params):
        def leaf(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32, device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return {"step": _step0(params), "stats": tree_map(leaf, params)}

    @torch.no_grad()
    def update(params, grads, state):
        state["step"].add_(1)
        t = state["step"].to(torch.float32)
        beta = 1.0 - torch.pow(t, -decay)
        slices = sliced if sliced is not None else tree_map(lambda p: None, params)

        def upd(p, g, s, sl):
            g = _grad(p, g).float()
            gsq = torch.square(g) + eps
            if _factored(p.shape):
                ax_r = stat_axis("vr", sl[0]) if sl else None
                sl_r = None if ax_r is None else (ax_r, sl[1])
                mr = _mean(gsq, -1, False, sl, group)
                mc = _mean(gsq, -2, False, sl, group)
                del gsq
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * mr)
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * mc)
                vr, vc = s["vr"], s["vc"]
                rfac = torch.rsqrt(vr / torch.clamp_min(
                    _mean(vr, -1, True, sl_r, group), eps))
                cfac = torch.rsqrt(vc)
                u = g * rfac[..., None] * cfac[..., None, :]
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * gsq)
                u = g * torch.rsqrt(s["v"])
            del g
            rms = torch.sqrt(_mean(torch.square(u), None, False, sl, group) + 1e-12)
            u.div_(torch.clamp_min(rms / clip_threshold, 1.0))
            p.copy_(p.float() - u.mul_(lr))

        tree_map(upd, params, grads, state["stats"], slices)
        return params, state

    return Optimizer(init, update)


# ------------------------------------------------------------ state across
def state_from_arrays(tree, defs=None, device="cpu"):
    """The port's optimizer state from the JAX package's (nested numpy
    arrays, ``jax.tree.map(np.asarray, state)``). With ``defs`` (the
    model's param defs) a leaf of a def that is this rank's slice keeps
    its slice: ``mu``/``m``/``v`` as the parameter, Adafactor's stats
    along ``stat_axis``; ``mu`` takes the parameter's dtype, as JAX's
    ``zeros_like`` does. ``step`` becomes a 0-d int32 tensor."""

    def conv(a, d=None, stat=None, dtype=torch.float32):
        a = np.asarray(a)
        if d is not None and d.parts > 1:
            ax = d.axis if stat is None else stat_axis(stat, d.axis)
            if ax is not None:
                n = a.shape[ax] // d.parts
                a = np.take(a, range(d.part * n, (d.part + 1) * n), axis=ax)
        a = np.ascontiguousarray(a, dtype=np.int32 if a.dtype.kind in "iu" else np.float32)
        return torch.tensor(a, dtype=torch.int32 if a.dtype == np.int32 else dtype,
                            device=device)

    out = {}
    for k, v in tree.items():
        if k == "step":
            out[k] = conv(v)
        elif defs is None:
            out[k] = tree_map(conv, v)
        elif k == "stats":
            out[k] = tree_map(lambda d, s: {n: conv(x, d, n) for n, x in s.items()}, defs, v)
        else:
            out[k] = tree_map(lambda d, a: conv(a, d, dtype=d.dtype if k == "mu" else
                                            torch.float32), defs, v)
    return out


def state_to_arrays(state):
    """The JAX package's layout as nested numpy arrays (f32; ``step``
    int32)."""
    return tree_map(lambda t: t.detach().cpu().numpy() if t.dtype == torch.int32
                else t.detach().cpu().float().numpy(), state)
