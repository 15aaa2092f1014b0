"""Single-machine KGE training (the paper's many-core path).

A port of the JAX package's core/kge_model.py. It adapts the ``KGEState``
container and the global-id batches of the single-machine samplers onto
``DenseStore`` and core/step.py. The tables live on ``state``'s device and
are updated in place by every step. ``grad_step`` / ``apply_step`` split the
step for the Hogwild trainers (launch/runtime.py).

Weights cross between the packages as numpy arrays under the JAX
``KGEState``'s field names: ``state_from_arrays`` / ``state_to_arrays``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import telemetry
from repro_torch.common.config import KGEConfig
from repro_torch.common.device import resolve_device
from repro_torch.core.sampling import MODES
from repro_torch.core.step import store_apply_grads, store_grads, store_train_step
from repro_torch.embeddings.store import DenseStore
from repro_torch.embeddings.table import emb_init_scale

ARRAY_FIELDS = ("entity", "ent_gsq", "r_emb", "rel_gsq", "r_proj", "proj_gsq",
                "step", "pend_ids", "pend_grads")


@dataclasses.dataclass
class KGEState:
    entity: torch.Tensor  # (n_entities, d)
    ent_gsq: torch.Tensor
    r_emb: torch.Tensor  # (n_relations, rel_dim)
    rel_gsq: torch.Tensor
    r_proj: Optional[torch.Tensor]  # (n_relations, d*rel_dim) TransR/RESCAL
    proj_gsq: Optional[torch.Tensor]
    step: int = 0
    # T5 deferred-update buffers (overlap=True); None = immediate updates
    pend_ids: Optional[torch.Tensor] = None  # (Lp,) -1 pad
    pend_grads: Optional[torch.Tensor] = None  # (Lp, d)


def ent_workspace_slots(cfg: KGEConfig) -> int:
    """Entity rows touched by one joint batch: h + t + negatives."""
    return 2 * cfg.batch_size + MODES * cfg.n_neg_groups * cfg.neg_sample_size


def _uniform(shape, s: float, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=torch.float32) * (2 * s) - s


def init_state(cfg: KGEConfig, generator: Optional[torch.Generator] = None,
               overlap: bool = False, device="cuda") -> KGEState:
    """Uniform(-s, s) tables from ``generator`` (a CPU generator: the tables
    are drawn on the host, then moved, so a seed gives the same tables on
    every device). torch draws other numbers than ``jax.random``: to start
    from the JAX package's tables use ``state_from_arrays``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    s = emb_init_scale(cfg)
    ent = _uniform((cfg.n_entities, cfg.dim), s, gen)
    rel = _uniform((cfg.n_relations, cfg.rel_dim), s, gen)
    proj = None
    if cfg.model in ("transr", "rescal"):
        proj = _uniform((cfg.n_relations, cfg.dim * cfg.rel_dim), s, gen)
        if cfg.model == "transr":
            eye = torch.eye(cfg.dim, cfg.rel_dim, dtype=torch.float32).reshape(-1)
            proj = proj * 0.1 + eye
    arrays = {"entity": ent, "r_emb": rel, "r_proj": proj}
    if overlap:
        slots = ent_workspace_slots(cfg)
        arrays["pend_ids"] = torch.full((slots,), -1, dtype=torch.int32)
        arrays["pend_grads"] = torch.zeros((slots, cfg.dim), dtype=torch.float32)
    return state_from_arrays(cfg, arrays, dev)


def state_from_arrays(cfg: KGEConfig, arrays: Mapping[str, object],
                      device="cuda") -> KGEState:
    """Build the port's state from the JAX ``KGEState``'s fields.

    ``arrays`` maps the JAX field names (``entity``, ``ent_gsq``, ``r_emb``,
    ``rel_gsq``, ``r_proj``, ``proj_gsq``, ``step``, ``pend_ids``,
    ``pend_grads``) to numpy arrays or tensors; a missing or None
    accumulator starts at zero, a missing ``step`` at 0. Numpy arrays are
    copied; a tensor already on the device with the dtype is used as it is,
    and training then updates it in place.
    """
    dev = resolve_device(device)

    def tensor(name, dtype=torch.float32):
        v = arrays.get(name)
        if v is None:
            return None
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        return t.to(device=dev, dtype=dtype).contiguous()

    ent, rel, proj = tensor("entity"), tensor("r_emb"), tensor("r_proj")
    if ent is None or rel is None:
        raise ValueError("state_from_arrays needs 'entity' and 'r_emb'")
    if ent.shape != (cfg.n_entities, cfg.dim):
        raise ValueError(f"entity {tuple(ent.shape)} != "
                         f"{(cfg.n_entities, cfg.dim)} of the config")
    if rel.shape != (cfg.n_relations, cfg.rel_dim):
        raise ValueError(f"r_emb {tuple(rel.shape)} != "
                         f"{(cfg.n_relations, cfg.rel_dim)} of the config")
    if (proj is not None) != (cfg.model in ("transr", "rescal")):
        raise ValueError(f"r_proj is required exactly for transr/rescal, "
                         f"model is {cfg.model}")

    def gsq(name, table):
        if table is None:
            return None
        g = tensor(name)
        return torch.zeros_like(table) if g is None else g

    pend_ids = tensor("pend_ids", torch.int32)
    pend_grads = tensor("pend_grads")
    if (pend_ids is None) != (pend_grads is None):
        raise ValueError("pend_ids and pend_grads come together (T5 overlap)")
    step = arrays.get("step")
    return KGEState(
        entity=ent, ent_gsq=gsq("ent_gsq", ent),
        r_emb=rel, rel_gsq=gsq("rel_gsq", rel),
        r_proj=proj, proj_gsq=gsq("proj_gsq", proj),
        step=0 if step is None else int(np.asarray(step)),
        pend_ids=pend_ids, pend_grads=pend_grads,
    )


def state_to_arrays(state: KGEState) -> Dict[str, Optional[np.ndarray]]:
    """The reverse of ``state_from_arrays``: numpy arrays (int32 ids, as in
    JAX) under the JAX ``KGEState``'s field names."""
    out = {}
    for name in ARRAY_FIELDS:
        v = getattr(state, name)
        if name == "step":
            out[name] = np.asarray(v, np.int32)
        elif v is None:
            out[name] = None
        else:
            v = v.detach().cpu().numpy()
            out[name] = v.astype(np.int32) if name == "pend_ids" else v
    return out


# --------------------------------------------------------------------------
# KGEState <-> DenseStore adapters
# --------------------------------------------------------------------------
def _empty(width: int, device):
    return (torch.zeros((0,), dtype=torch.int32, device=device),
            torch.zeros((0, width), dtype=torch.float32, device=device))


def stores_from_state(cfg: KGEConfig, state: KGEState) -> Dict[str, DenseStore]:
    """View the flat KGEState as DenseStores (zero-copy; tensors are shared)."""
    dev = state.entity.device
    defer = state.pend_ids is not None
    pid, pg = (state.pend_ids, state.pend_grads) if defer else _empty(cfg.dim, dev)
    stores = {
        "entity": DenseStore(state.entity, state.ent_gsq, pid, pg,
                             lr=cfg.lr, defer=defer),
        # relations are never deferred (paper: trainer-immediate)
        "rel": DenseStore(state.r_emb, state.rel_gsq, *_empty(cfg.rel_dim, dev),
                          lr=cfg.lr, defer=False),
    }
    if state.r_proj is not None:
        stores["proj"] = DenseStore(state.r_proj, state.proj_gsq,
                                    *_empty(cfg.dim * cfg.rel_dim, dev),
                                    lr=cfg.lr, defer=False)
    return stores


def state_from_stores(state: KGEState, stores: Dict[str, DenseStore]) -> KGEState:
    ent, rel = stores["entity"], stores["rel"]
    proj = stores.get("proj")
    defer = state.pend_ids is not None
    return dataclasses.replace(
        state,
        entity=ent.table, ent_gsq=ent.gsq,
        r_emb=rel.table, rel_gsq=rel.gsq,
        r_proj=None if proj is None else proj.table,
        proj_gsq=None if proj is None else proj.gsq,
        step=state.step + 1,
        pend_ids=ent.pend_ids if defer else None,
        pend_grads=ent.pend_grads if defer else None,
    )


def dense_step_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Lower a global-id batch (h, r, t, neg) to the step's workspace form.

    Its relation workspace holds one row a triplet, in triplet order, which
    the batch states as ``rel_slot_is_arange`` (core/step.py)."""
    h, r, t, neg = batch["h"], batch["r"], batch["t"], batch["neg"]
    b = h.shape[0]

    def arange(n):
        return torch.arange(n, dtype=torch.int64, device=h.device)

    return {
        "ent_ids": torch.cat([h, t, neg.reshape(-1)]),
        "rel_ids": r,
        "h_slot": arange(b),
        "t_slot": b + arange(b),
        "neg_slot": 2 * b + arange(neg.numel()).reshape(neg.shape),
        "rel_slot": arange(b),
        "rel_slot_is_arange": True,
    }


def flush_state(cfg: KGEConfig, state: KGEState) -> KGEState:
    """Apply any pending (deferred) entity update — call before eval/save.

    In place, like every update of the port: the tables change and ``state``
    gets empty pend buffers, so a training loop that goes on with the same
    state object does not apply the flushed grads a second time. Returns
    ``state``.
    """
    if state.pend_ids is None:
        return state
    ent = DenseStore(state.entity, state.ent_gsq, state.pend_ids,
                     state.pend_grads, lr=cfg.lr, defer=True).flush()
    state.pend_ids, state.pend_grads = ent.pend_ids, ent.pend_grads
    return state


# --------------------------------------------------------------------------
def train_step(
    cfg: KGEConfig,
    state: KGEState,
    batch: Dict[str, torch.Tensor],
) -> Tuple[KGEState, Dict[str, torch.Tensor]]:
    """One sparse mini-batch step; updates the tables in place.

    batch: h, r, t (b,), neg (MODES, ng, k), on the state's device.
    """
    stores, metrics = store_train_step(
        cfg, stores_from_state(cfg, state), dense_step_batch(batch))
    return state_from_stores(state, stores), metrics


# --------------------------------------------------------------------------
# Hogwild two-phase step (paper §3.1, launch/runtime.py): gradients computed
# against a possibly STALE view of the tables, applied to the LATEST ones.
# --------------------------------------------------------------------------
def grad_step(cfg: KGEConfig, state: KGEState, batch):
    """Phases 2–3 of the step against ``state``: ``(grads, metrics)``.

    The gather copies the rows, so an apply dispatched after it (another
    trainer's) does not change the gradient. Multi-trainer requires
    immediate updates (``overlap=False``): Hogwild already overlaps update
    with compute, and a deferred pending buffer is single-writer.
    """
    if state.pend_ids is not None:
        raise ValueError("Hogwild trainers require overlap off: "
                         "init_state(..., overlap=False)")
    return store_grads(cfg, stores_from_state(cfg, state), dense_step_batch(batch))


def apply_step(cfg: KGEConfig, state: KGEState, batch, grads) -> KGEState:
    """Phase 4: apply ``grads`` (from ``grad_step``) to ``state``'s tables in
    place; returns the state with its step advanced.

    In the runtime this runs inside ``StoreSlot.swap``, so it lands on the
    latest tables and no trainer's update is lost.
    """
    stores = store_apply_grads(stores_from_state(cfg, state),
                               dense_step_batch(batch), grads)
    return state_from_stores(state, stores)


def make_hogwild_step(cfg: KGEConfig):
    """(grad_fn, apply_fn) pair for ``train_loop(..., split_step=...)``."""
    return (functools.partial(grad_step, cfg), functools.partial(apply_step, cfg))


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A sampler batch (joint or naive) as int64 tensors on ``device``.

    For a CUDA device the host arrays are pinned and copied asynchronously,
    so a prefetch thread can stage the next batch while the card computes.
    The copies are one ``pipeline/copy`` span; on a prefetch thread it
    lies inside the ``pipeline/sample`` span that carries the batch's number.
    """
    dev = torch.device(device)
    out = {}
    with telemetry.span("pipeline/copy"):
        for name in ("h", "r", "t", "neg"):
            x = torch.from_numpy(np.ascontiguousarray(getattr(batch, name), np.int64))
            if dev.type == "cuda":
                x = x.pin_memory()
            out[name] = x.to(dev, non_blocking=True)
    return out


# --------------------------------------------------------------------------
# Naive baseline step: independent negatives per triplet (paper's strawman).
# Same stores, same update path; only the negative layout differs.
# --------------------------------------------------------------------------
def naive_train_step(cfg: KGEConfig, state: KGEState, batch):
    if state.pend_ids is not None:
        raise ValueError("naive_train_step does not support overlap (T5) "
                         "state; init_state(..., overlap=False)")
    stores, metrics = store_train_step(
        cfg, stores_from_state(cfg, state), dense_step_batch(batch),
        neg_mode="naive")
    return state_from_stores(state, stores), metrics

