"""Mamba2 (SSD) mixer: the chunked prefill path and the recurrent decode.

A port of the JAX package's models/ssm.py. ``mamba_train`` runs the SSD
scan through ``kernels.ssd_scan.ssd_scan``: on the card that is the CUDA
kernel (csrc/ssd_scan.cu), where JAX runs the jnp ``ssd_chunked_jnp``
(its Pallas kernel is a serving-path twin that no JAX path launches); on
the CPU it is the plain chunked form at JAX's chunk, JAX's own arithmetic.
``mamba_decode`` is plain PyTorch, as it is plain jnp in JAX, and writes
the decode state in place (JAX returns a new one): the conv windows
``conv_x`` (B, cw - 1, d_inner) and ``conv_bc`` (B, cw - 1, 2N) in the
config's dtype, the SSM state ``ssm`` (B, H, P, N) in f32.

Types follow JAX's promotion: ``dt`` is clipped to [0, 1] in f32 and
``A = -exp(A_log)`` is f32; the scan runs in f32 and its output is cast
back to the activations' type before the gate.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ArchConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import ParamDef, matmul, torch_dtype

Params = Dict[str, torch.Tensor]


def mamba_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.n_mamba_heads
    cw = cfg.conv_width
    return {
        "w_xz": ParamDef((d, 2 * di), init="fan_in"),
        "w_bc": ParamDef((d, 2 * N), init="fan_in"),
        "w_dt": ParamDef((d, H), init="fan_in"),
        "dt_bias": ParamDef((H,), init="zeros"),
        "A_log": ParamDef((H,), init="zeros"),  # A = -exp(A_log)
        "D_skip": ParamDef((H,), init="ones"),
        "conv_x": ParamDef((cw, di), init="normal", scale=0.5),
        "conv_bc": ParamDef((cw, 2 * N), init="normal", scale=0.5),
        "w_out": ParamDef((di, d), init="fan_in"),
        "norm_z": ParamDef((di,), init="ones"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, T, C), w (cw, C). The taps are summed as
    JAX's ``sum(...)`` does, 0 + t0 + t1 + ..., each in the inputs' type."""
    cw, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = 0
    for i in range(cw):
        out = out + xp[:, i:i + T, :] * w[i]
    return out


class _Clip01(torch.autograd.Function):
    """``jnp.clip(x, 0, 1)`` with JAX's gradient: ``minimum(maximum(x, 0),
    1)``, each of whose derivatives multiplies the cotangent by a mask (1
    inside, 1/2 at a tie, 0 outside). ``torch.clamp``'s backward selects
    instead, so a NaN cotangent at a clipped entry (a Mamba2 scan whose
    masked decay overflows, ``kernels/ssd_scan/ref.py``) would give 0 here
    and NaN in JAX."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo = torch.clamp_min(x, 0.0)
        d_min = torch.where(lo < 1.0, 1.0, torch.where(lo == 1.0, 0.5, 0.0))
        d_max = torch.where(x > 0.0, 1.0, torch.where(x == 0.0, 0.5, 0.0))
        return g * d_min * d_max


def _dt(x, params):
    """(..., H) f32: softplus(x @ w_dt + dt_bias) clipped to [0, 1] (the
    standard Mamba dt limit; an unbounded dt makes dt x ⊗ B explode)."""
    v = matmul(x, params["w_dt"]).float() + params["dt_bias"]
    return _Clip01.apply(F.softplus(v))


def _gate_out(y, xh, z, params, dtype):
    """D skip, the cast back to the activations' type, the silu(z) gate and
    the output projection."""
    y = y + params["D_skip"][:, None] * xh
    y = y.reshape(*y.shape[:-2], -1).to(dtype)
    y = y * F.silu(z) * params["norm_z"]
    return matmul(y, params["w_out"])


def mamba_train(params: Params, x: torch.Tensor, cfg: ArchConfig,
                scan=ssd_scan) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D), the whole sequence at once. ``scan`` runs
    the SSD scan: ``ssd_scan`` (the kernel on the card, forward only) by
    default; the training route (``transformer.Model.loss``) names the
    plain ``ssd_chunked_batched``, JAX's ``ssd_chunked_jnp`` route, which
    autograd differentiates."""
    Bsz, T, _ = x.shape
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.n_mamba_heads, cfg.mamba_headdim
    xz = matmul(x, params["w_xz"])
    xs, z = xz[..., :di], xz[..., di:]
    bc = matmul(x, params["w_bc"])
    dt = _dt(x, params)  # (B, T, H)
    xs = F.silu(_causal_conv(xs, params["conv_x"]))
    bc = F.silu(_causal_conv(bc, params["conv_bc"]))
    Bm, Cm = bc[..., :N], bc[..., N:]
    A = -torch.exp(params["A_log"].float())  # (H,)
    xh = xs.reshape(Bsz, T, H, Pd).float()
    y = scan(xh, dt, A, Bm.float(), Cm.float())  # (B, T, H, P) f32
    return _gate_out(y, xh, z, params, x.dtype)


# --------------------------------------------------------------------- decode
def mamba_state_defs(cfg: ArchConfig, batch: int) -> Dict[str, ParamDef]:
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.n_mamba_heads, cfg.mamba_headdim
    cw = cfg.conv_width
    dt = torch_dtype(cfg.dtype)
    return {
        "conv_x": ParamDef((batch, cw - 1, di), init="zeros", dtype=dt),
        "conv_bc": ParamDef((batch, cw - 1, 2 * N), init="zeros", dtype=dt),
        "ssm": ParamDef((batch, H, Pd, N), init="zeros", dtype=torch.float32),
    }


def mamba_decode(params: Params, x1: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ArchConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x1 (B, 1, D): one token through the recurrence. Writes ``state`` in
    place and returns (y (B, 1, D), state)."""
    Bsz = x1.shape[0]
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.n_mamba_heads, cfg.mamba_headdim
    x = x1[:, 0]  # (B, D)
    xz = matmul(x, params["w_xz"])
    xs, z = xz[..., :di], xz[..., di:]
    bc = matmul(x, params["w_bc"])
    dt = _dt(x, params)  # (B, H)

    # the conv windows: the last cw - 1 inputs and this one, in f32
    cx = torch.cat([state["conv_x"], xs[:, None].to(state["conv_x"].dtype)], dim=1)
    cb = torch.cat([state["conv_bc"], bc[:, None].to(state["conv_bc"].dtype)], dim=1)
    xs = F.silu(torch.einsum("bwc,wc->bc", cx.float(), params["conv_x"].float()))
    bcc = F.silu(torch.einsum("bwc,wc->bc", cb.float(), params["conv_bc"].float()))
    Bm, Cm = bcc[..., :N], bcc[..., N:]
    A = -torch.exp(params["A_log"].float())

    xh = xs.reshape(Bsz, H, Pd)
    a = torch.exp(A[None] * dt)  # (B, H)
    s = (state["ssm"] * a[..., None, None]
         + (dt[..., None] * xh)[..., None] * Bm[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", s, Cm)  # (B, H, P)
    state["conv_x"].copy_(cx[:, 1:])
    state["conv_bc"].copy_(cb[:, 1:])
    state["ssm"].copy_(s)
    return _gate_out(y, xh, z, params, x1.dtype)[:, None], state
