"""Device choice for the port's entry points: CUDA unless the caller asks
for the CPU, and no silent fallback when there is no card."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and there is no GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch versions of the kernels on the CPU")
    return dev
