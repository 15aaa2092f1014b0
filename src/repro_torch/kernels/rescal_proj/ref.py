"""Plain PyTorch versions of the rescal_proj kernels: the CPU path and the
kernels' oracle on the card. The einsums of core/scores.py's RESCAL branch,
on each triplet's own matrix.

``rescal_proj_ref(m, h, t)``
    m (b, d * r), row i the matrix M_i viewed (d, r) row-major; h (b, d),
    t (b, r). Returns (ph, pt) = (M_i^T h_i, M_i t_i): (b, r) and (b, d).

``rescal_proj_grads_ref(m, h, t, dph, dpt)``
    The VJP: (dh, dt, dm) = (M_i dph_i, M_i^T dpt_i,
    h_i (x) dph_i + dpt_i (x) t_i flattened as m).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _matrices(m: torch.Tensor, h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return m.reshape(m.shape[0], h.shape[-1], t.shape[-1])


def rescal_proj_ref(m: torch.Tensor, h: torch.Tensor, t: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    mm = _matrices(m, h, t)
    return (torch.einsum("bd,bdr->br", h, mm), torch.einsum("bdr,br->bd", mm, t))


def rescal_proj_grads_ref(m: torch.Tensor, h: torch.Tensor, t: torch.Tensor,
                          dph: torch.Tensor, dpt: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    mm = _matrices(m, h, t)
    dh = torch.einsum("bdr,br->bd", mm, dph)
    dt = torch.einsum("bd,bdr->br", dpt, mm)
    dm = h[:, :, None] * dph[:, None, :] + dpt[:, :, None] * t[:, None, :]
    return dh, dt, dm.reshape(m.shape)
