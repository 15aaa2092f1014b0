"""FFN layers of the LM zoo: the dense (gated / gelu) FFN and the
Mixture-of-Experts layer.

A port of the JAX package's models/moe.py. The MoE parameters are JAX's:
``router`` (d, E) and ``w_up``/``w_gate`` (E, d, ff), ``w_down`` (E, ff, d),
drawn by JAX's ``fan_in`` rule, which reads ``shape[0]``: an expert matrix
draws at std 1/sqrt(E), and stacked over layers at 1/sqrt(L).

Routing (``route``): the router product in the activations' type, cast to
f32, softmaxed; the top k by a stable descending sort, so equal gates
take the lower expert index first, as ``jax.lax.top_k`` does; the k gates
renormalised. Two routes of the layer:

  * ``moe_dense_ref``: JAX's ``_moe_dense_ref``, the route JAX takes with
    no mesh. Every expert computes every token; each expert's output is
    cast to f32, weighted and summed in f32, and the sum cast to the
    activations' type once. No token is dropped.
  * ``moe_local``: JAX's ``_moe_local``, the capacity-bounded route JAX
    runs under a mesh. ``cap = int(capacity_factor * T * k / E) + 1`` slots
    an expert, filled in the flattened (b, s) order; a token-choice past
    the capacity goes to the trash slot ``cap`` and is dropped. The local
    experts (``e0`` on) compute their slots in the activations' type; the
    weighted outputs are summed in f32, cast to the activations' type where
    JAX's psum over ``model`` sits (a sum over ``group`` when one is
    given), and returned with the Switch-style load-balance ``aux``.

``moe_apply(params, x, cfg, grid)`` picks the dense route with no grid and
the local route over ``grid.model_group`` with one, placing the experts on
the model group's S ranks by JAX's rule (``expert_parallel``): with ``E %
S == 0`` and ``E >= S`` rank s owns experts ``s*E/S ..`` (its ``e0``) and
the psum takes the union of the experts; otherwise every rank holds all E
experts on its ``d_ff / S`` slice (``w_up``/``w_gate`` ``[:, :, slice]``,
``w_down`` ``[:, slice, :]``) and the same psum, a sum of partial products
in the activations' type, completes the contraction. ``moe_defs(cfg,
model_par, part)`` gives rank ``part``'s local shapes, each def marked as
a slice of JAX's global tensor (``layers.ParamDef.parts``). The tokens a
rank routes are its machine's batch rows (``transformer.machine_rows``),
so the capacity is per data shard, as in JAX.
The expert products are ``torch.matmul`` (cuBLAS on the card), as JAX's
are jnp: no kernel of the port runs here.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.common import collectives
from repro_torch.common.config import ArchConfig
from repro_torch.models.layers import ParamDef, activation_fn, matmul

Params = Dict[str, torch.Tensor]

# ------------------------------------------------------------------- dense FFN
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


# ------------------------------------------------------------------------- MoE
def expert_parallel(cfg: ArchConfig, model_par: int) -> bool:
    """JAX's placement rule: each rank owns ``E / model_par`` whole experts,
    else (tensor-parallel experts) every rank a ``d_ff`` slice of all E."""
    return cfg.n_experts % model_par == 0 and cfg.n_experts >= model_par


def moe_defs(cfg: ArchConfig, model_par: int = 1, part: int = 0) -> Dict[str, ParamDef]:
    """Rank ``part``'s MoE parameters of a model group of ``model_par``
    ranks: local shapes, the expert tensors marked as slices of JAX's
    global ones (the router is whole on every rank)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    S = model_par
    if expert_parallel(cfg, S):
        up = dict(shape=(E // S, d, ff), axis=-3)
        down = dict(shape=(E // S, ff, d), axis=-3)
    else:
        if ff % S:
            raise ValueError(f"{cfg.name}: d_ff {ff} does not split over {S} ranks")
        up = dict(shape=(E, d, ff // S), axis=-1)
        down = dict(shape=(E, ff // S, d), axis=-2)
    sl = dict(init="fan_in", parts=S, part=part)
    out = {
        "router": ParamDef((d, E), init="fan_in"),
        "w_up": ParamDef(**up, **sl),
        "w_down": ParamDef(**down, **sl),
    }
    if cfg.activation == "silu":
        out["w_gate"] = ParamDef(**up, **sl)
    return out


def top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest gates of each row and their indices, largest first;
    equal gates in ascending index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: Params, xf: torch.Tensor, cfg: ArchConfig):
    """(gates (T, E) f32, renormalised top-k weights (T, k), expert ids
    (T, k)) of the tokens ``xf`` (T, D)."""
    gates = torch.softmax(matmul(xf, params["router"]).float(), dim=-1)
    topw, topi = top_k(gates, cfg.moe_top_k)
    return gates, topw / topw.sum(dim=-1, keepdim=True), topi


def _experts(params: Params):
    """Each local expert's (w_up, w_gate or None, w_down): views of the
    stacked tensors taken by one ``unbind``, whose backward stacks the
    experts' gradients into one tensor (indexing each expert on its own
    would, under autograd, add a zero-filled gradient of the whole stack
    per expert)."""
    up, down = params["w_up"].unbind(0), params["w_down"].unbind(0)
    gate = params["w_gate"].unbind(0) if "w_gate" in params else (None,) * len(up)
    return list(zip(up, gate, down))


def _expert(w, x: torch.Tensor, act) -> torch.Tensor:
    up, gate, down = w
    h = matmul(x, up)
    if gate is not None:
        h = act(matmul(x, gate)) * h
    else:
        h = act(h)
    return matmul(h, down)


def moe_dense_ref(params: Params, x: torch.Tensor, cfg: ArchConfig):
    """JAX's ``_moe_dense_ref``: every expert sees every token. Returns
    (out (B, S, D) in x's type, 0)."""
    B, S, D = x.shape
    act = activation_fn(cfg.activation)
    xf = x.reshape(B * S, D)
    _, topw, topi = route(params, xf, cfg)
    out = torch.zeros((B * S, D), dtype=torch.float32, device=x.device)
    for e, w in enumerate(_experts(params)):
        eo = _expert(w, xf, act).float()
        w = (topw * (topi == e)).sum(dim=-1)
        out = out + eo * w[:, None]
    return out.reshape(B, S, D).to(x.dtype), torch.zeros((), device=x.device)


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots an expert of ``moe_local`` keeps for ``n_tokens`` local tokens."""
    return int(cfg.capacity_factor * n_tokens * cfg.moe_top_k / cfg.n_experts) + 1


def slots(topi: torch.Tensor, e: int, cap: int):
    """(whether each token chose expert ``e``, its slot: the order of the
    choice among the tokens that chose ``e``, or ``cap``, the trash slot,
    where that order reaches the capacity)."""
    sel = (topi == e).any(dim=-1)
    pos = torch.cumsum(sel.to(torch.int64), dim=0) - 1
    return sel, torch.where(sel & (pos < cap), pos, torch.full_like(pos, cap))


def moe_local(params: Params, x: torch.Tensor, cfg: ArchConfig, e0: int = 0,
              group=None):
    """JAX's ``_moe_local`` on this rank's tokens ``x`` (B, S, D) and its
    experts ``e0 ..`` (the leading axis of the expert weights). With a
    ``group`` the outputs are summed over it (JAX's psum over ``model``),
    and under autograd the gradients are JAX's: the sum's backward is the
    identity, and ``x``'s and the router's sum the ranks' parts
    (``collectives.psum_replicated``, ``replicated_input``); with none
    there is no collective, but the sum is still cast to x's type where
    JAX's psum takes it. Returns (out (B, S, D) in x's type, aux)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.moe_top_k
    act = activation_fn(cfg.activation)
    xf = x.reshape(T, D)
    if group is not None:
        # x and the router are equal on every rank, each rank computes its
        # experts' part: the backward sums the parts (JAX's transpose)
        xf = collectives.replicated_input(xf, group)
        params = {**params, "router": collectives.replicated_input(params["router"], group)}
    gates, topw, topi = route(params, xf, cfg)
    cap = capacity(cfg, T)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for j, ws in enumerate(_experts(params)):
        e = e0 + j
        sel, slot = slots(topi, e, cap)
        w = (topw * (topi == e)).sum(dim=-1)
        # every slot below cap takes one token; the rest land in the trash
        # slot, which nothing reads
        buf = torch.zeros((cap + 1, D), dtype=xf.dtype, device=x.device)
        buf.index_copy_(0, slot, xf)
        eo = _expert(ws, buf[:cap], act)  # (cap, D)
        keep = (sel & (slot < cap) & (w > 0)).float() * w
        out = out + eo[torch.clamp(slot, max=cap - 1)].float() * keep[:, None]
    out = out.to(x.dtype)
    if group is not None:
        out = collectives.psum_replicated(out, group)
    out = out.float()
    me = gates.mean(dim=0)
    ce = torch.nn.functional.one_hot(topi, E).float().sum(dim=1).mean(dim=0)
    aux = E * (me * ce).sum() / k
    return out.reshape(B, S, D).to(x.dtype), aux


def moe_apply(params: Params, x: torch.Tensor, cfg: ArchConfig, grid=None
              ) -> torch.Tensor:
    """The MoE layer of x (B, S, D): the dense route with no ``grid`` (as
    JAX with no mesh), else the capacity-bounded route over the grid's
    model group, on this rank's experts (``params`` as ``moe_defs(cfg,
    grid.S, grid.s)`` shapes them)."""
    if grid is None:
        return moe_dense_ref(params, x, cfg)[0]
    e0 = grid.s * (cfg.n_experts // grid.S) if expert_parallel(cfg, grid.S) else 0
    return moe_local(params, x, cfg, e0=e0, group=grid.model_group)[0]


def flipped(sets_a: Sequence[torch.Tensor], sets_b: Sequence[torch.Tensor],
            shape: Tuple[int, int]) -> torch.Tensor:
    """The routing rule's tokens: (B, T) True where a token's top-k expert
    set differs between two runs in any MoE layer. ``sets_*`` are each
    layer's expert ids (B*T, k), as ``route`` gives them; order within a
    set does not count."""
    out = torch.zeros(shape[0] * shape[1], dtype=torch.bool)
    for a, b in zip(sets_a, sets_b):
        a = a.sort(dim=-1).values.cpu()
        b = b.sort(dim=-1).values.cpu()
        out |= (a != b).any(dim=-1)
    return out.reshape(shape)


def dropped_share(topi: torch.Tensor, cfg: ArchConfig) -> float:
    """The share of the T * k token-choices ``topi`` (T, k) that
    ``moe_local`` drops at the config's capacity: each expert's choices past
    its ``cap`` slots."""
    counts = torch.bincount(topi.reshape(-1), minlength=cfg.n_experts)
    over = (counts - capacity(cfg, topi.shape[0])).clamp(min=0)
    return float(over.sum()) / topi.numel()
