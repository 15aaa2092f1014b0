"""Train, prefill and serve steps of the LM zoo: a port of the JAX package's
models/steps.py.

``build_train_step(model, lr, shape) -> (train_step, opt)``:
``train_step(params, opt_state, batch) -> (params, opt_state, {"loss"})``
takes the global batch, as JAX's does: ``tokens`` and ``labels`` (B, T)
with one microbatch, else (mb, B / mb, T) (``input_defs``). Each
microbatch's loss (``Model.loss``) goes backward on its own; the
gradients are summed in f32 in JAX's order (g1 + g2 + ...), divided by
mb, and the config's optimizer (``optim.make_optimizer``) updates the
parameters and its state in place. The reported loss is the mean over
the microbatches. An f32 parameter's sum builds up in place in its
``.grad``; a parameter stored in a lower precision (DBRX and Jamba keep
their matrices in bf16) has its microbatch gradients added into an f32
tensor of its own, JAX's f32 accumulator, since ``.grad`` takes the
parameter's dtype.

On a grid (``build_model(cfg, grid)``, JAX's mesh) each rank takes its
rows of every microbatch (``data_parallel``: its machine's share, JAX's
``P(None, batch_axes, None)``; with ``cfg.parallel == "dp"`` its share
of the batch split over all M x S ranks, as JAX's ``batch_axes`` then
hold ``model`` too). The gradients, an expert slice's too, and the loss
are averaged over the ranks that share the rest of the batch (the
machine group; every rank in dp), so each rank's step is JAX's. Within a
model group the MoE layers' collectives give every rank the whole
gradient of the replicated parameters (``common/collectives.py``), and
Adafactor reduces an expert slice's statistics over the model group
(``optim/dense.py``).

The training route launches no kernel of the port, as JAX's reaches no
Pallas kernel (``Model.loss``).

The dry run's arguments (``launch/dryrun.py``) are meta tensors of this
rank's shapes, which the steps take as they take real ones:
``train_abstract_args`` (the parameters, ``opt.init``'s state on them:
JAX's ``eval_shape(opt.init)``, and the global batch, which the step
narrows to this rank's rows), ``serve_abstract_args`` (the parameters,
the caches and token of this machine's rows, ``index`` as an int),
``abstract_inputs``/``abstract_inputs_tree`` (defs as meta tensors) and
``opt_state_specs`` (the state's per-rank layout).

``build_prefill_step`` and ``build_serve_step`` run without autograd:
serving needs no graph.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.common import collectives
from repro_torch.common.config import ArchConfig, Frontend, InputShape
from repro_torch.models.layers import ParamDef, torch_dtype, tree_leaves, tree_map
from repro_torch.models.transformer import Model, machine_rows
from repro_torch.optim.api import make_optimizer
from repro_torch.optim.dense import stat_axis


# ------------------------------------------------------------- optimizer specs
def opt_state_specs(name: str, param_specs, abstract_params):
    """The optimizer state's per-rank layout, as ``Model.param_specs``
    gives the parameters' (JAX's ``opt_state_specs``): the step is whole;
    AdamW's moments lie as their parameters; Adafactor's ``vr``/``vc`` are
    sliced along ``optim.dense.stat_axis`` of their leaf's axis (whole
    where the mean crosses it), a vector's ``v`` as the vector."""
    if name == "adamw":
        return {"step": None, "m": param_specs, "v": param_specs}
    if name == "sgd":
        return {"step": None}
    if name == "adafactor":
        def along(spec, stat):
            if spec is None:
                return None
            ax = stat_axis(stat, spec[0])
            return None if ax is None else (ax,) + tuple(spec[1:])

        def leaf(spec, ap):
            if ap.dim() >= 2:
                return {"vr": along(spec, "vr"), "vc": along(spec, "vc")}
            return {"v": along(spec, "v")}

        return {"step": None, "stats": tree_map(
            lambda ap, spec: leaf(spec, ap), abstract_params, param_specs)}
    raise ValueError(name)


# ----------------------------------------------------------------- input specs
def n_machines_of(model: Model) -> int:
    """The ranks a batch splits over: JAX's product of the mesh's
    ``batch_axes`` (the machines, or every rank in dp mode)."""
    return data_parallel(model)[2]


def data_parallel(model: Model):
    """(the group the batch splits over, this rank's index in it, its
    size): with no grid (None, 0, 1); else the machine group and ``grid.m``
    of ``grid.M``, or in dp mode the whole world (group None) and
    ``grid.rank`` of ``M * S``."""
    grid = model.grid
    if grid is None:
        return None, 0, 1
    if model.cfg.parallel == "dp":
        return None, grid.rank, grid.M * grid.S
    return grid.machine_group, grid.m, grid.M


def effective_microbatches(cfg: ArchConfig, shape: InputShape, model: Model) -> int:
    """Largest grad-accum factor <= cfg.microbatches with each microbatch
    still divisible across the machines."""
    if shape.kind != "train":
        return 1
    machines = n_machines_of(model)
    mb = min(cfg.microbatches, max(1, shape.global_batch // machines))
    while shape.global_batch % mb or (shape.global_batch // mb) % machines:
        mb -= 1
    return max(1, mb)


def input_defs(cfg: ArchConfig, shape: InputShape, model: Model,
               microbatches: int = 0) -> Dict[str, ParamDef]:
    """Shape and dtype of every model input of this (arch, shape), global:
    ``tokens`` (and for training ``labels``), LLaVA's ``patch_embeds``,
    Whisper's ``enc_frames``, with a leading microbatch axis when mb > 1;
    a decode step's ``token`` (B, 1)."""
    gb, T = shape.global_batch, shape.seq_len
    mb = microbatches or effective_microbatches(cfg, shape, model)
    lead = () if mb == 1 else (mb,)
    rows = gb if mb == 1 else gb // mb
    dt = torch_dtype(cfg.dtype)
    out: Dict[str, ParamDef] = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = ParamDef(lead + (rows, T), init="zeros", dtype=torch.int32)
        if shape.kind == "train":
            out["labels"] = ParamDef(lead + (rows, T), init="zeros", dtype=torch.int32)
        if cfg.frontend == Frontend.VISION:
            nf = min(cfg.n_frontend_tokens, T)
            out["patch_embeds"] = ParamDef(lead + (rows, nf, cfg.d_model), init="zeros",
                                           dtype=dt)
        if cfg.enc_dec:
            out["enc_frames"] = ParamDef(lead + (rows, cfg.encoder_ctx, cfg.d_model),
                                         init="zeros", dtype=dt)
    else:  # decode
        out["token"] = ParamDef((gb, 1), init="zeros", dtype=torch.int32)
    return out


def abstract_inputs(defs: Dict[str, ParamDef], grid=None) -> Dict[str, torch.Tensor]:
    """The inputs of ``input_defs`` as meta tensors; with a grid, the rows
    (axis 0) of this rank's machine (``transformer.machine_rows``), which
    a prefill or decode step takes. A train step takes the global batch
    (it narrows each microbatch itself): pass no grid."""
    out = {}
    for k, d in defs.items():
        shape = tuple(d.shape)
        if grid is not None:
            rows = machine_rows(grid, shape[0])
            shape = (rows.stop - rows.start,) + shape[1:]
        out[k] = torch.empty(shape, dtype=d.dtype, device="meta")
    return out


def abstract_inputs_tree(defs):
    """A tree of defs (the caches) as meta tensors of their shapes."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


# ------------------------------------------------------------------ train step
def build_train_step(model: Model, lr: float = 1e-4, shape: Optional[InputShape] = None):
    """(train_step, opt): see the module docstring. ``shape`` sets the
    microbatches by ``effective_microbatches``, else ``cfg.microbatches``."""
    cfg = model.cfg
    grid = model.grid
    kw = {}
    if cfg.optimizer == "adafactor" and grid is not None and grid.S > 1:
        kw = dict(sliced=model.sliced(), group=grid.model_group)
    opt = make_optimizer(cfg.optimizer, lr, **kw)
    mb = effective_microbatches(cfg, shape, model) if shape is not None else cfg.microbatches
    group, index, n = data_parallel(model)

    def local(batch):
        """This rank's rows (axis 0) of one microbatch."""
        if n == 1:
            return batch
        return {k: v.narrow(0, index * (v.shape[0] // n), v.shape[0] // n)
                for k, v in batch.items()}

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        sums = {}  # f32 gradient sums of the leaves stored below f32
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        try:
            if mb == 1:
                loss = model.loss(params, local(batch))
                loss.backward()
                loss = loss.detach()
            else:
                losses = []
                for i in range(mb):
                    li = model.loss(params, local({k: v[i] for k, v in batch.items()}))
                    li.backward()
                    losses.append(li.detach())
                    for p in leaves:
                        if p.dtype != torch.float32 and p.grad is not None:
                            g = p.grad.float()
                            sums[id(p)] = g if id(p) not in sums else sums[id(p)].add_(g)
                            p.grad = None
                loss = torch.stack(losses).mean()
        finally:
            for p in leaves:
                p.requires_grad_(False)
        with torch.no_grad():
            grads = {id(p): sums.get(id(p), p.grad) for p in leaves}
            for g in grads.values():
                if g is None:
                    continue
                if mb > 1:
                    g.div_(mb)
                if n > 1:
                    g.copy_(collectives.all_reduce_sum(g, group)).div_(n)
            if n > 1:
                loss = collectives.pmean(loss, group)
            params, opt_state = opt.update(params, tree_map(lambda p: grads[id(p)], params),
                                           opt_state)
        for p in leaves:
            p.grad = None
        return params, opt_state, {"loss": loss}

    return train_step, opt


def train_abstract_args(model: Model, shape: InputShape, lr: float = 1e-4):
    """(parameters, optimizer state, batch) as meta tensors for a dry run
    of ``build_train_step(model, lr, shape)``: this rank's parameters, the
    config's optimizer's state built on them (JAX's ``jax.eval_shape(
    opt.init, aps)``) and the global batch of ``input_defs``."""
    aps = model.abstract_params()
    _, opt = build_train_step(model, lr, shape)
    aos = opt.init(aps)
    batch = abstract_inputs(input_defs(model.cfg, shape, model))
    return aps, aos, batch


# ------------------------------------------------------- prefill / serve steps
def build_prefill_step(model: Model, use_flash: bool = False):
    """``prefill(params, inputs) -> logits`` of the whole prompt batch;
    ``use_flash`` routes every attention layer through the flash kernel.
    Mamba2 layers run the SSD scan through the ssd_scan kernel whenever the
    tensors are on the card (64 launches a forward of Mamba2-2.7B)."""

    @torch.no_grad()
    def prefill(params, inputs):
        return model.forward(params, inputs, use_flash=use_flash)

    return prefill


def build_serve_step(model: Model):
    """``serve(params, caches, token, index) -> (logits, caches)``: one
    decode step, the caches written in place."""

    @torch.no_grad()
    def serve(params, caches, token, index):
        return model.decode_step(params, caches, token, index)

    return serve


def serve_abstract_args(model: Model, shape: InputShape):
    """(parameters, caches, token, index) for a dry run of one
    ``build_serve_step`` call: meta tensors of this rank's parameters and
    of the caches and token of this machine's rows of the global batch
    (``transformer.machine_rows``), a cache of ``shape.seq_len`` positions,
    and the last position as ``index`` (a decode step reads its whole
    cache, masked, whatever the index)."""
    aps = model.abstract_params()
    token = abstract_inputs(input_defs(model.cfg, shape, model), model.grid)["token"]
    caches = abstract_inputs_tree(model.cache_defs(token.shape[0], shape.seq_len))
    return aps, caches, token, shape.seq_len - 1
