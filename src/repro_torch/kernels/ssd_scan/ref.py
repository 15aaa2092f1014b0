"""Plain PyTorch Mamba2 SSD scan: the CPU path of ``ssd_scan`` and the
kernel's oracle on the card (csrc/ssd_scan.cu).

Twins of the JAX package's kernels/ssd_scan/ref.py. The recurrence, per
head h (ngroups = 1, so B and C are shared by the heads):

    a_t = exp(A_h dt_{t,h})                      (A_h < 0)
    S_t = a_t S_{t-1} + dt_{t,h} x_t ⊗ B_t       S: (P, N)
    y_t = S_t C_t                                (P,)

``ssd_ref`` walks it step by step; ``ssd_chunked`` is the chunked
(state-space duality) form the model runs, with JAX's arithmetic: the
decay-masked Gram matrix inside a chunk and the state carried across
chunks. Both take one sequence in the model's time-major layout, x
(T, H, P), dt (T, H), B and C (T, N), and return (y (T, H, P), the final
state (H, P, N)). ``ssd_chunked_batched`` is the model's call over
(batch, T, H, P), what ``jax.vmap`` does at the JAX package's
models/ssm.py:73-76, with JAX's chunk rule (``chunk_for``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def chunk_for(T: int, chunk: int = 64) -> int:
    """The JAX model's chunk: 64, halved until it divides T."""
    while T % chunk:
        chunk //= 2
    return chunk


def ssd_ref(x, dt, A, B, C, init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step scan of one sequence: (y (T, H, P), state (H, P, N))."""
    T, H, P = x.shape
    N = B.shape[1]
    s = (torch.zeros(H, P, N, dtype=x.dtype, device=x.device) if init_state is None
         else init_state)
    ys = []
    for t in range(T):
        a = torch.exp(A * dt[t])  # (H,)
        s = a[:, None, None] * s + (dt[t][:, None] * x[t])[..., None] * B[t]
        ys.append(torch.einsum("hpn,n->hp", s, C[t]))
    y = torch.stack(ys) if ys else x.new_zeros(0, H, P)
    return y, s


def _chunked(x, dt, A, B, C, chunk: int, state: torch.Tensor):
    """The chunked scan over a leading batch dim: x (b, T, H, P), dt
    (b, T, H), B and C (b, T, N), state (b, H, P, N)."""
    b, T, H, P = x.shape
    N = B.shape[-1]
    if T % chunk:
        raise ValueError(f"chunk {chunk} does not divide T {T}")
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    ys = []
    for c0 in range(0, T, chunk):
        xc, dtc = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        bc, cc = B[:, c0:c0 + chunk], C[:, c0:c0 + chunk]
        cs = torch.cumsum(A * dtc, dim=1)  # (b, c, H) inclusive log-decay
        # intra-chunk: y_t += sum_{s<=t} exp(cs_t - cs_s) (C_t.B_s) dt_s x_s;
        # exp(cs_t - cs_s) for t < s may be inf: a select drops it, where a
        # multiply by the mask would give inf * 0 = NaN
        L = torch.where(tri[None, :, :, None],
                        torch.exp(cs[:, :, None, :] - cs[:, None, :, :]), 0.0)
        G = torch.einsum("btn,bsn->bts", cc, bc)
        W = G[..., None] * L  # (b, t, s, H)
        y = torch.einsum("btsh,bshp->bthp", W, dtc[..., None] * xc)
        # inter-chunk: y_t += exp(cs_t) C_t . state
        y = y + torch.exp(cs)[..., None] * torch.einsum("bhpn,btn->bthp", state, cc)
        tot = cs[:, -1]  # (b, H)
        w = torch.exp(tot[:, None, :] - cs)  # (b, c, H)
        state = torch.exp(tot)[..., None, None] * state + torch.einsum(
            "bshp,bsn->bhpn", (w * dtc)[..., None] * xc, bc)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else x.new_zeros(b, 0, H, P)
    return y, state


def ssd_chunked(x, dt, A, B, C, chunk: int = 64,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan of one sequence: (y (T, H, P), state (H, P, N)).
    ``chunk`` must divide T, as JAX asserts."""
    T, H, P = x.shape
    N = B.shape[1]
    s0 = (torch.zeros(1, H, P, N, dtype=x.dtype, device=x.device)
          if init_state is None else init_state[None])
    y, s = _chunked(x[None], dt[None], A, B[None], C[None], chunk, s0)
    return y[0], s[0]


def ssd_chunked_batched(x, dt, A, B, C) -> torch.Tensor:
    """y (batch, T, H, P) of x (batch, T, H, P), dt (batch, T, H), A (H,),
    B and C (batch, T, N), from a zero state, at ``chunk_for(T)``."""
    b, T, H, P = x.shape
    s0 = torch.zeros(b, H, P, B.shape[-1], dtype=x.dtype, device=x.device)
    return _chunked(x, dt, A, B, C, chunk_for(T), s0)[0]
