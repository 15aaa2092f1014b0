"""Serving steps of the LM zoo: a port of ``build_prefill_step`` and
``build_serve_step`` of the JAX package's models/steps.py. The training
steps wait for LM training (ROADMAP Queue A10, with ``optim/dense.py``).

Both steps run without autograd: serving needs no graph.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import Model


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
