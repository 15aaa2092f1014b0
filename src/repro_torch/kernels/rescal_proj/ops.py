"""Dispatch and autograd for RESCAL's projection products.

``rescal_proj(m, h, t)`` returns ``(ph, pt)`` = (M_i^T h_i, M_i t_i) for
every row i of ``m`` (b, d * r), the matrix M_i viewed (d, r) row-major:
core/step.py's single-machine RESCAL step scores its positives with
``ph . t``, its tail negatives against ``ph`` and its head negatives
against ``pt``. The device of the tensors decides the path: on CUDA tensors
each direction launches its hand-written kernel (csrc/rescal_proj.cu:
``rescal_proj_kernel<.., false>`` forward, ``<.., true>`` backward) or
raises; on meta tensors it takes the same checks and returns the kernel's
outputs as meta tensors (the card's route, described abstractly, for the
dry run); on CPU tensors it runs the plain versions (ref.py). Every device
goes through the same ``autograd.Function``. On CUDA and on meta each
launch hands an active cost analysis its work (``cost.py``,
``common/cost.py``).

Backward (``_RescalProj``): one launch gives dh, dt and the gradient of
every row of ``m``, dm = h (x) dph + dpt (x) t, written once; all three are
computed whichever autograd asks for.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common import cost
from repro_torch.kernels import build
from repro_torch.kernels.rescal_proj.cost import rescal_proj_cost
from repro_torch.kernels.rescal_proj.ref import rescal_proj_grads_ref, rescal_proj_ref


def _check(what: str, m: torch.Tensor, *vecs: torch.Tensor) -> Tuple[int, int, int]:
    """The checks every rescal_proj kernel makes: one CUDA (or meta) device,
    float32, contiguous, m (b, d * r) with vecs alternating (b, d), (b, r).
    Returns (b, d, r)."""
    ts = (m, *vecs)
    if not ((m.is_cuda or m.is_meta) and all(x.device == m.device for x in ts)):
        raise ValueError(f"{what} kernel needs its operands on one CUDA device "
                         f"(or all on meta), got {[str(x.device) for x in ts]}")
    if any(x.dtype != torch.float32 for x in ts):
        raise TypeError(f"{what} kernel takes float32, got {[x.dtype for x in ts]}")
    if not all(x.is_contiguous() for x in ts):
        raise ValueError(f"{what} kernel takes contiguous operands")
    b = m.shape[0] if m.dim() == 2 else -1
    d, r = vecs[0].shape[-1], vecs[1].shape[-1]
    want = [(b, d * r)] + [(b, d), (b, r)] * (len(vecs) // 2)
    if [tuple(x.shape) for x in ts] != want:
        raise ValueError(f"{what} kernel takes m (b, d * r) with vectors (b, d), "
                         f"(b, r), got {[tuple(x.shape) for x in ts]}")
    return b, d, r


def _launch(m, a, v, h, t, out_col, out_row, dm, b, d, r):
    build.launch("rescal_proj", m.data_ptr(), a.data_ptr(), v.data_ptr(),
                 None if h is None else h.data_ptr(),
                 None if t is None else t.data_ptr(), out_col.data_ptr(),
                 out_row.data_ptr(), None if dm is None else dm.data_ptr(), b, d, r,
                 torch.cuda.current_stream(m.device).cuda_stream)


def rescal_proj_kernel(m: torch.Tensor, h: torch.Tensor, t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward: (ph (b, r), pt (b, d)) from m (b, d * r), h (b, d)
    and t (b, r); fp32, contiguous, on one CUDA device."""
    b, d, r = _check("rescal_proj", m, h, t)
    ph = torch.empty((b, r), device=m.device, dtype=torch.float32)
    pt = torch.empty((b, d), device=m.device, dtype=torch.float32)
    if m.numel():
        if m.is_cuda:
            _launch(m, h, t, None, None, ph, pt, None, b, d, r)
            build.count("rescal_proj_fwd")
        if cost.ACTIVE is not None:
            cost.ACTIVE.kernel(rescal_proj_cost(b, d, r))
    return ph, pt


def rescal_proj_grads_kernel(m: torch.Tensor, h: torch.Tensor, t: torch.Tensor,
                             dph: torch.Tensor, dpt: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward: (dh (b, d), dt (b, r), dm (b, d * r)) from the
    forward's operands and the cotangents dph (b, r), dpt (b, d)."""
    b, d, r = _check("rescal_proj backward", m, h, t, dpt, dph)
    dh = torch.empty((b, d), device=m.device, dtype=torch.float32)
    dt = torch.empty((b, r), device=m.device, dtype=torch.float32)
    dm = torch.empty_like(m)
    if m.numel():
        if m.is_cuda:
            _launch(m, dpt, dph, h, t, dt, dh, dm, b, d, r)
            build.count("rescal_proj_bwd")
        if cost.ACTIVE is not None:
            cost.ACTIVE.kernel(rescal_proj_cost(b, d, r, backward=True))
    return dh, dt, dm


class _RescalProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, h, t):
        ctx.save_for_backward(m, h, t)
        if m.is_cuda or m.is_meta:
            return rescal_proj_kernel(m, h, t)
        return rescal_proj_ref(m, h, t)

    @staticmethod
    def backward(ctx, dph, dpt):
        m, h, t = ctx.saved_tensors
        # autograd may hand over an expanded (stride-0) cotangent
        dph, dpt = dph.contiguous(), dpt.contiguous()
        grads = (rescal_proj_grads_kernel if m.is_cuda or m.is_meta
                 else rescal_proj_grads_ref)
        dh, dt, dm = grads(m, h, t, dph, dpt)
        return dm, dh, dt


def rescal_proj(m: torch.Tensor, h: torch.Tensor, t: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M_i^T h_i, M_i t_i) for every row i of m (b, d * r), differentiable
    in all three operands."""
    return _RescalProj.apply(m, h.contiguous(), t.contiguous())
