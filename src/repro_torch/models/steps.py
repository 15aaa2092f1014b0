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
Pallas kernel (``Model.loss``). The dry-run's twins (``opt_state_specs``,
``train_abstract_args``, ``abstract_inputs``, ``serve_abstract_args``)
wait for the tooling (ROADMAP Queue A11).

``build_prefill_step`` and ``build_serve_step`` run without autograd:
serving needs no graph.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.common import collectives
from repro_torch.common.config import ArchConfig, Frontend, InputShape
from repro_torch.models.layers import ParamDef, torch_dtype, tree_leaves, tree_map
from repro_torch.models.transformer import Model
from repro_torch.optim.api import make_optimizer


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
