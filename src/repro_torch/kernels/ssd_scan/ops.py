"""Dispatch of the SSD-scan kernel (csrc/ssd_scan.cu).

``ssd_scan(x, dt, A, B, C)`` takes the model's time-major layout, batched:
x (batch, T, H, P), dt (batch, T, H), A (H,), B and C (batch, T, N), and
returns y (batch, T, H, P) from a zero state; all f32. The JAX package's
wrapper (kernels/ssd_scan/ops.py) took one sequence, made it head-major and
formed ga = A dt; the kernel does that itself, for every (sequence, head)
in one call of two launches (C B^T of every (sequence, chunk) into a
scratch the wrapper allocates, then the scan), at any T (it masks a ragged
last chunk; the TPU wrapper's ``chunk`` is not an argument: the kernel
picks its own).

The tensors' device picks the path: CUDA tensors go to the kernel, which
takes f32 of these shapes with P <= 64 and N <= 128, both multiples of 4
(the wrapper makes them contiguous and 16-byte aligned), or the wrapper
raises; CPU tensors go to the plain ``ssd_chunked_batched`` at
JAX's chunk. The scan is forward only, in JAX too: with grad mode on, an
input that requires grad raises, on either path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_batched

MAX_HEAD_DIM = 64  # P, the kernel's staged width
MAX_STATE = 128  # N
CHUNK = 64  # the kernel's chunk rows


def _check_no_grad(ts):
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("ssd_scan has no backward (nor has the JAX package's); "
                           "call it under torch.no_grad() or on tensors that do "
                           "not require grad")


def ssd_scan_kernel(x, dt, A, B, C) -> torch.Tensor:
    """Launch the CUDA kernel for the whole (batch, H) grid: two launches,
    the Gram matrices of every (sequence, chunk), then the scan."""
    ts = (x, dt, A, B, C)
    _check_no_grad(ts)
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError("ssd_scan kernel needs x, dt, A, B, C on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"ssd_scan kernel takes f32, got {[t.dtype for t in ts]}")
    if (x.dim(), dt.dim(), A.dim(), B.dim(), C.dim()) != (4, 3, 1, 3, 3):
        raise ValueError("ssd_scan takes x (batch, T, H, P), dt (batch, T, H), A (H,), "
                         f"B and C (batch, T, N), got {[tuple(t.shape) for t in ts]}")
    Bsz, T, H, P = x.shape
    N = B.shape[2]
    if (dt.shape != (Bsz, T, H) or A.shape != (H,) or B.shape != (Bsz, T, N)
            or C.shape != B.shape):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    if not (0 < P <= MAX_HEAD_DIM and 0 < N <= MAX_STATE and P % 4 == 0 and N % 4 == 0):
        raise ValueError(f"ssd_scan kernel takes P <= {MAX_HEAD_DIM} and N <= "
                         f"{MAX_STATE}, both multiples of 4, got P {P}, N {N}")
    # the kernel reads rows as float4: a view that starts off 16 bytes is copied
    x, dt, A, B, C = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (t.contiguous() for t in ts))
    y = torch.empty_like(x)
    if y.numel():
        # scratch for C B^T of every (sequence, chunk), which the kernel's
        # first launch writes and its second reads for every head
        gram = torch.empty(Bsz, -(-T // CHUNK), CHUNK, CHUNK, device=x.device)
        build.launch("ssd_scan", x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                     C.data_ptr(), y.data_ptr(), gram.data_ptr(), Bsz, T, H, P, N,
                     torch.cuda.current_stream(x.device).cuda_stream)
        build.count("ssd_scan")
    return y


def ssd_scan(x, dt, A, B, C) -> torch.Tensor:
    """y (batch, T, H, P) of the SSD scan, forward only."""
    ts = (x, dt, A, B, C)
    if any(t.is_cuda for t in ts):
        return ssd_scan_kernel(x, dt, A, B, C)
    _check_no_grad(ts)
    return ssd_chunked_batched(x, dt, A, B, C)
