"""The one KGE train step, parameterized by embedding stores.

A port of the JAX package's core/step.py. Every trainer of the port is this
function applied to different store backends:

    single machine   stores = DenseStore(entity/rel[/proj])
    distributed      stores = ShardedStore(entity/rel[/proj]) +
                              ReplicatedStore(shared split relations),
                     called on every rank of the world (core/distributed.py)
                     with ``ctx`` over the model group

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
``store_train_step`` composes them on one (flushed) store set. The phases
are telemetry spans: ``step/flush``, ``step/grad`` holding ``step/gather``,
``step/score`` (up to the loss) and ``step/backward``, then
``step/apply``. The step is eager, so a span times its phase's enqueue;
the device time of a phase is that of the launches made inside its span.
``store_pipelined_step`` is the depth-1 pipelined step of the distributed
path (``--pipeline-depth 1``): grads against the workspaces the previous
step prefetched, then the pull for the next batch, then the apply.

Batch normal form (what both samplers lower to):

    ent_ids   store-address of the entity workspace (tensor / ShardedIds)
    rel_ids   store-address of the relation workspace
    h_slot, t_slot   (b,)  workspace slots of heads / tails
    neg_slot  (MODES, ng, k) joint  |  (MODES, b, k) naive — workspace slots
    rel_slot  (b,)  relation-workspace slots
    rel_shared (b,) optional: row in the shared relation table, -1 = owned
    rel_slot_is_arange  optional, True: rel_slot is arange(b), triplet i
              reads relation-workspace row i (the single-machine lowering,
              ``kge_model.dense_step_batch``)

RESCAL on one device (no model group) over a batch that states
``rel_slot_is_arange`` computes both products of each triplet's matrix,
M_r^T h and M_r t, in one op over the projection workspace itself
(``kernels/rescal_proj``: a kernel pair on the card, einsums on the CPU);
every other step indexes the workspace by ``rel_slot`` and scores through
``core/scores.py``'s einsums. The telemetry counters
``scores/rescal_proj_fused`` and ``scores/rescal_proj_einsum`` count
RESCAL's steps by route.

The reference ``jax.vmap``s the joint negative score over the ``ng``
negative groups; here the group is a leading dimension of one batched call.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common import telemetry
from repro_torch.common.collectives import all_reduce_sum, pmean
from repro_torch.common.config import KGEConfig
from repro_torch.core import losses as L
from repro_torch.core import scores as S
from repro_torch.core.sampling import MODES
from repro_torch.embeddings.table import emb_init_scale
from repro_torch.kernels.rescal_proj.ops import rescal_proj

Stores = Dict[str, object]  # "entity", "rel", optional "proj", "shared"


def store_grads(
    cfg: KGEConfig,
    stores: Stores,
    batch: Dict[str, torch.Tensor],
    *,
    neg_mode: str = "joint",
    ctx: Optional[S.ShardCtx] = None,
    n_servers: int = 1,
    prefetched: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Phases 2–3: gather workspaces + loss/metrics + sparse row gradients.

    Returns ``({store name: workspace-row grads}, metrics)``; the metrics are
    0-d tensors (reading them synchronises with the device). Does NOT flush.
    ``ctx`` is the dim-sharding context of a distributed rank (its model
    group) and ``n_servers`` that group's size.

    ``prefetched`` (the pipelined path) supplies the entity and relation
    workspaces the previous step pulled: the two gathers are skipped, and
    the gradients are computed against those one-step-stale rows (copies,
    so they become this step's leaves as gathered rows do).
    """
    ctx = S.ShardCtx(None) if ctx is None else ctx
    scale = emb_init_scale(cfg)
    h_slot, t_slot = batch["h_slot"], batch["t_slot"]
    rel_slot, neg_slot = batch["rel_slot"], batch["neg_slot"]
    rel_shared = batch.get("rel_shared")
    has_shared = "shared" in stores and rel_shared is not None
    has_proj = "proj" in stores

    # ---- 2. gather the workspaces (or take the previous step's prefetch):
    # copies, leaves of this step's graph
    with telemetry.span("step/gather"):
        if prefetched is None:
            ws = stores["entity"].gather(batch["ent_ids"])
            rel_ws = stores["rel"].gather(batch["rel_ids"])
        else:
            ws, rel_ws = prefetched["entity"].detach(), prefetched["rel"].detach()
        ws, rel_ws = ws.requires_grad_(), rel_ws.requires_grad_()
        proj_ws = (stores["proj"].gather(batch["rel_ids"]).requires_grad_()
                   if has_proj else None)
        shared_rows = (stores["shared"].gather(rel_shared).requires_grad_()
                       if has_shared else None)

    b = h_slot.shape[0]
    k = cfg.neg_sample_size
    ng = cfg.n_neg_groups
    model = cfg.model
    # negative sharding (the reference's beyond-paper route): local (b, k/S)
    # score slices + scalar loss sums, instead of summing (b, k) scores
    sharded_negs = (neg_mode == "joint" and ctx.axis is not None
                    and model not in ("transr", "rescal")
                    and cfg.loss in ("logistic", "ranking")
                    and k % n_servers == 0)
    # RESCAL's products straight off the projection workspace: one op, no
    # per-triplet copy (the distributed lowering's slots repeat and its rows
    # are dim-striped, so it indexes and takes the einsums)
    fused_proj = (model == "rescal" and ctx.axis is None
                  and batch.get("rel_slot_is_arange", False))
    if model == "rescal":
        telemetry.inc("scores/rescal_proj_fused" if fused_proj
                      else "scores/rescal_proj_einsum")

    # ---- 3. loss + grads w.r.t. workspace rows ONLY (sparse, paper §2)
    with telemetry.span("step/score"):
        h, t = ws[h_slot], ws[t_slot]
        r = rel_ws[rel_slot]
        if has_shared:
            r = torch.where((rel_shared >= 0).unsqueeze(1), shared_rows, r)
        pr = ph = pt = None
        if fused_proj:
            # triplet i reads row i; rows past b (none in the lowering) read
            # by nobody get zero gradients through the slice
            rows = proj_ws if proj_ws.shape[0] == b else proj_ws[:b]
            ph, pt = rescal_proj(rows, h, t)  # M_r^T h, M_r t
        elif has_proj:
            pr = proj_ws[rel_slot]
        pos = S.positive_score(model, h, r, t, cfg.gamma, ctx, r_proj=pr,
                               rel_dim=cfg.rel_dim, emb_scale=scale, ph=ph)

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
                if sharded_negs:
                    neg_out.append(S.negative_score_sharded(
                        model, e, rg, negs, corrupt, cfg.gamma, ctx, emb_scale=scale,
                        wire_dtype=cfg.comm_dtype))  # (ng, gsz, k/S) local
                else:
                    o = None if ph is None else (ph if m == 0 else pt).reshape(
                        ng, gsz, -1)
                    neg_out.append(S.negative_score(
                        model, e, rg, negs, corrupt, cfg.gamma, ctx, r_proj=prg,
                        rel_dim=cfg.rel_dim, emb_scale=scale, o=o))
        else:
            raise ValueError(f"neg_mode {neg_mode!r}")
        neg = torch.stack(neg_out)  # (MODES, ng, gsz, k or k/S) | (MODES, b, k)
        if sharded_negs:
            # scalar-reduced loss: the same value on every server
            n_all = MODES * b * k
            if cfg.loss == "logistic":
                neg_sum = ctx.psum(torch.sum(F.softplus(neg)))
                loss = torch.mean(F.softplus(-torch.cat([pos, pos]))) + neg_sum / n_all
            else:  # ranking: pair each positive with its group's negatives
                p2 = torch.stack([pos, pos]).reshape(MODES, ng, b // ng, 1)
                hinge = torch.clamp_min(cfg.gamma - p2 + neg, 0.0)
                loss = ctx.psum(torch.sum(hinge)) / n_all
            neg_mean = all_reduce_sum(torch.sum(neg.detach()), ctx.axis) / n_all
        else:
            loss = L.kge_loss(cfg.loss, torch.cat([pos, pos]),
                              neg.reshape(MODES * b, -1), margin=cfg.gamma)
            neg_mean = neg.detach().mean()

    leaves = ([ws, rel_ws] + ([shared_rows] if has_shared else [])
              + ([proj_ws] if has_proj else []))
    # a leaf the score never reads (RESCAL's rel_ws: it reads only the
    # projection rows) gets a zero gradient, as JAX's value_and_grad gives
    with telemetry.span("step/backward"):
        grads = list(torch.autograd.grad(loss, leaves, materialize_grads=True))
    out = {"entity": grads.pop(0), "rel": grads.pop(0)}
    if has_shared:
        out["shared"] = grads.pop(0)
    if has_proj:
        out["proj"] = grads.pop(0)
    metrics = {"loss": loss.detach(), "pos_score": pos.detach().mean(),
               "neg_score": neg_mean}
    return out, metrics


def store_apply_grads(
    stores: Stores,
    batch: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
) -> Stores:
    """Phase 4: every row update goes through ``apply_sparse_grads``."""
    stores["entity"].apply_sparse_grads(batch["ent_ids"], grads["entity"])
    stores["rel"].apply_sparse_grads(batch["rel_ids"], grads["rel"])
    if "shared" in grads:
        stores["shared"].apply_sparse_grads(batch["rel_shared"], grads["shared"])
    if "proj" in grads:
        stores["proj"].apply_sparse_grads(batch["rel_ids"], grads["proj"])
    return stores


def store_train_step(
    cfg: KGEConfig,
    stores: Stores,
    batch: Dict[str, torch.Tensor],
    *,
    neg_mode: str = "joint",
    ctx: Optional[S.ShardCtx] = None,
    n_servers: int = 1,
    machine_axis=None,
) -> Tuple[Stores, Dict[str, torch.Tensor]]:
    """One sparse mini-batch step: flush -> ``store_grads`` ->
    ``store_apply_grads``, updating the stores in place.

    When the entity store defers (T5), ``metrics["pend_dropped"]`` reports
    its capacity-bounded defer drop count. With ``machine_axis`` (a
    distributed rank's machine group) the metrics are averaged over the
    machines. The backward's collectives all run inside ``store_grads``,
    before any KVStore push of the step, in one order on every rank.
    """
    # ---- 1. flush deferred updates (T5) before gathering
    with telemetry.span("step/flush"):
        stores["entity"].flush()
    with telemetry.span("step/grad"):
        grads, metrics = store_grads(cfg, stores, batch, neg_mode=neg_mode,
                                     ctx=ctx, n_servers=n_servers)
    with telemetry.span("step/apply"):
        store_apply_grads(stores, batch, grads)
    ent = stores["entity"]
    if ent.defer:
        metrics["pend_dropped"] = ent.pend_dropped
    return stores, _finish_metrics(ent, metrics, machine_axis)


def _finish_metrics(ent, metrics, machine_axis):
    """Add the coalesced push's drop count when the entity store coalesces,
    then average the metrics over the machines (with ``machine_axis``)."""
    if getattr(ent, "coalesce", False):
        metrics["push_dropped"] = ent.co_dropped
    if machine_axis is not None:
        names = list(metrics)
        vals = torch.stack([torch.as_tensor(metrics[n], dtype=torch.float32,
                                            device=metrics["loss"].device)
                            for n in names])
        metrics = dict(zip(names, pmean(vals, machine_axis).unbind(0)))
    return metrics


def prefetch_workspaces(stores: Stores, batch: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Issue the entity and relation workspace pulls for the NEXT batch.

    The depth-1 staleness contract (``--pipeline-depth 1``): the pull reads
    the tables as they are now, before this step's gradients apply, so the
    rows the next step computes against are at most one update stale, and
    the gradients still apply to the latest table. The pulled rows are
    copies: the in-place apply that follows leaves them as they were.
    """
    def pull(store, ids):
        fetch = getattr(store, "gather_prefetch", None)
        return fetch(ids) if fetch is not None else store.gather(ids)

    return {"entity": pull(stores["entity"], batch["ent_ids"]),
            "rel": pull(stores["rel"], batch["rel_ids"])}


def store_pipelined_step(
    cfg: KGEConfig,
    stores: Stores,
    batch: Dict[str, torch.Tensor],
    prefetched: Dict[str, torch.Tensor],
    next_batch: Dict[str, torch.Tensor],
    *,
    ctx: Optional[S.ShardCtx] = None,
    n_servers: int = 1,
    machine_axis=None,
) -> Tuple[Stores, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Depth-1 pipelined ``store_train_step``: grads from the PREVIOUS
    step's prefetched workspaces, then the pull for ``next_batch``, then the
    push/apply of this batch, in that order on every rank.

    Returns ``(stores, next_prefetched, metrics)``. No flush phase: the
    pipelined path runs with T5 defer off (``core.distributed.make_program``
    refuses both). ``next_batch`` needs only its ``ent_ids``/``rel_ids``.
    """
    with telemetry.span("step/grad"):
        grads, metrics = store_grads(cfg, stores, batch, ctx=ctx,
                                     n_servers=n_servers, prefetched=prefetched)
    with telemetry.span("step/prefetch"):
        new_pf = prefetch_workspaces(stores, next_batch)
    with telemetry.span("step/apply"):
        store_apply_grads(stores, batch, grads)
    return stores, new_pf, _finish_metrics(stores["entity"], metrics, machine_axis)
