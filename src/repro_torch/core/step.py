"""The one KGE train step, parameterized by embedding stores.

A port of the JAX package's core/step.py for the single-machine stores.
The step follows the paper's update discipline (§2, §3.4, T5):

  1. ``flush()`` the entity store — applies the previous step's deferred
     gradients in place (overlap on) or is a no-op (overlap off);
  2. ``gather()`` the workspace rows — copies, made leaves that require
     grad, so the in-place updates of steps 1 and 4 never touch a tensor
     autograd saved;
  3. score + loss + grads w.r.t. the *workspace rows only* (sparse), by
     ``torch.autograd.grad``;
  4. ``apply_sparse_grads()`` on every touched table — the stores decide
     whether to apply now or defer.

``store_grads`` is phases 2–3 and ``store_apply_grads`` phase 4;
``store_train_step`` composes them on one (flushed) store set.

Batch normal form (what both samplers lower to):

    ent_ids   (n_ws,) int64 entity rows of the workspace
    rel_ids   (b,)    int64 relation rows of the workspace
    h_slot, t_slot   (b,)  workspace slots of heads / tails
    neg_slot  (MODES, ng, k) joint  |  (MODES, b, k) naive — workspace slots
    rel_slot  (b,)  relation-workspace slots

The reference ``jax.vmap``s the joint negative score over the ``ng``
negative groups; here the group is a leading dimension of one batched call.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.common import telemetry
from repro_torch.common.config import KGEConfig
from repro_torch.core import losses as L
from repro_torch.core import scores as S
from repro_torch.core.sampling import MODES
from repro_torch.embeddings.table import emb_init_scale

Stores = Dict[str, object]  # "entity", "rel", optional "proj"


def store_grads(
    cfg: KGEConfig,
    stores: Stores,
    batch: Dict[str, torch.Tensor],
    *,
    neg_mode: str = "joint",
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Phases 2–3: gather workspaces + loss/metrics + sparse row gradients.

    Returns ``({store name: workspace-row grads}, metrics)``; the metrics are
    0-d tensors (reading them synchronises with the device). Does NOT flush.
    """
    ctx = S.ShardCtx(None)
    scale = emb_init_scale(cfg)
    h_slot, t_slot = batch["h_slot"], batch["t_slot"]
    rel_slot, neg_slot = batch["rel_slot"], batch["neg_slot"]
    has_proj = "proj" in stores

    # ---- 2. gather the workspaces: copies, leaves of this step's graph
    ws = stores["entity"].gather(batch["ent_ids"]).requires_grad_()
    rel_ws = stores["rel"].gather(batch["rel_ids"]).requires_grad_()
    proj_ws = (stores["proj"].gather(batch["rel_ids"]).requires_grad_()
               if has_proj else None)

    b = h_slot.shape[0]
    ng = cfg.n_neg_groups
    model = cfg.model

    # ---- 3. loss + grads w.r.t. workspace rows ONLY (sparse, paper §2)
    h, t = ws[h_slot], ws[t_slot]
    r = rel_ws[rel_slot]
    pr = None if proj_ws is None else proj_ws[rel_slot]
    pos = S.positive_score(model, h, r, t, cfg.gamma, ctx, r_proj=pr,
                           rel_dim=cfg.rel_dim, emb_scale=scale)

    neg_out = []
    if neg_mode == "naive":
        # independent negatives per triplet — the paper's O(b·k·d) strawman
        mode = S.PAIRWISE_OF[model]
        for m in range(MODES):
            corrupt = "tail" if m == 0 else "head"
            e = h if m == 0 else t
            o = S.neg_o(model, e, r, corrupt, ctx, emb_scale=scale)
            negs = ws[neg_slot[m]]  # (b, k, d)
            if mode == "dot":
                part = torch.einsum("bd,bkd->bk", o, negs)
            elif mode == "l2sq":
                part = torch.sum(torch.square(o[:, None, :] - negs), dim=-1)
            else:
                part = torch.sum(torch.abs(o[:, None, :] - negs), dim=-1)
            neg_out.append(S.finish_neg_scores(model, part, cfg.gamma, ctx))
    elif neg_mode == "joint":
        # joint negatives (T1): one pool of k entities per group of gsz
        # triplets; the groups are a leading dimension of one call
        gsz = b // ng
        rg = r.reshape(ng, gsz, -1)
        prg = None if pr is None else pr.reshape(ng, gsz, -1)
        for m in range(MODES):
            corrupt = "tail" if m == 0 else "head"
            e = (h if m == 0 else t).reshape(ng, gsz, -1)
            negs = ws[neg_slot[m]]  # (ng, k, d)
            neg_out.append(S.negative_score(
                model, e, rg, negs, corrupt, cfg.gamma, ctx, r_proj=prg,
                rel_dim=cfg.rel_dim, emb_scale=scale))
    else:
        raise ValueError(f"neg_mode {neg_mode!r}")
    neg = torch.stack(neg_out)  # (MODES, ng, gsz, k) | (MODES, b, k)
    loss = L.kge_loss(cfg.loss, torch.cat([pos, pos]),
                      neg.reshape(MODES * b, -1), margin=cfg.gamma)

    leaves = [ws, rel_ws] + ([proj_ws] if has_proj else [])
    grads = torch.autograd.grad(loss, leaves)
    out = {"entity": grads[0], "rel": grads[1]}
    if has_proj:
        out["proj"] = grads[2]
    metrics = {"loss": loss.detach(), "pos_score": pos.detach().mean(),
               "neg_score": neg.detach().mean()}
    return out, metrics


def store_apply_grads(
    stores: Stores,
    batch: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
) -> Stores:
    """Phase 4: every row update goes through ``apply_sparse_grads``."""
    stores["entity"].apply_sparse_grads(batch["ent_ids"], grads["entity"])
    stores["rel"].apply_sparse_grads(batch["rel_ids"], grads["rel"])
    if "proj" in grads:
        stores["proj"].apply_sparse_grads(batch["rel_ids"], grads["proj"])
    return stores


def store_train_step(
    cfg: KGEConfig,
    stores: Stores,
    batch: Dict[str, torch.Tensor],
    *,
    neg_mode: str = "joint",
) -> Tuple[Stores, Dict[str, torch.Tensor]]:
    """One sparse mini-batch step: flush -> ``store_grads`` ->
    ``store_apply_grads``, updating the stores in place.

    When the entity store defers (T5), ``metrics["pend_dropped"]`` reports
    its capacity-bounded defer drop count.
    """
    # ---- 1. flush deferred updates (T5) before gathering
    with telemetry.span("step/flush"):
        stores["entity"].flush()
    with telemetry.span("step/grad"):
        grads, metrics = store_grads(cfg, stores, batch, neg_mode=neg_mode)
    with telemetry.span("step/apply"):
        store_apply_grads(stores, batch, grads)
    ent = stores["entity"]
    if ent.defer:
        metrics["pend_dropped"] = ent.pend_dropped
    return stores, metrics
