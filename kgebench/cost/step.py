"""The work one training step needs, counted from its batch and shapes.

This is what ``step_mfu`` divides by the step's measured time: the least
time on the card for the step's arithmetic and memory traffic, whatever
code implements it, so a later change to the program cannot move it.

Operations: the products of the scores, each at 2 M N K, forward and, for
the two operands' gradients, twice more backward (3x in all). Elementwise
work (distances, softplus, the update's arithmetic) is not counted: it is
under 1% of either model's products, and leaving it out keeps the count a
lower bound. Products that several triplets share are counted once:
TransR projects a group's pool of negatives once for each distinct
relation of the group, not once a triplet.

Bytes: every unique table row the step reads and its accumulator row,
each read once and written once, f32. The activations in between are not
counted: a step could keep them on chip.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Sequence

import numpy as np

from kgebench import load_module
from kgebench.cost import KernelCost, bound_s

MODELS = Path(__file__).resolve().parent / "models"


@functools.lru_cache(maxsize=None)
def _model(name: str):
    return load_module(MODELS / f"{name}.py")


def step_cost(model: str, h: np.ndarray, r: np.ndarray, t: np.ndarray,
              neg: np.ndarray, dim: int, rel_dim: int) -> KernelCost:
    """``neg``: (2, n_groups, k) negatives of the tail and head sides; the
    model's products from ``cost/models/<model>.py``."""
    m = _model(model)
    b = h.shape[0]
    _, ng, k = neg.shape
    gsz = b // ng
    rel_groups = sum(np.unique(r[g * gsz:(g + 1) * gsz]).size for g in range(ng))
    rows = {"entity": (np.unique(np.concatenate([h, t, neg.reshape(-1)])).size, dim),
            "relation": (np.unique(r).size, rel_dim),
            "projection": (np.unique(r).size, dim * rel_dim)}
    # each row and its accumulator row, read once and written once, f32
    n_bytes = sum(4 * 4 * n * width for name, (n, width) in rows.items()
                  if name in m.READS)
    return KernelCost(f"{model}_step", 3 * m.products(b, k, dim, rel_dim, rel_groups),
                      n_bytes, "tf32x3")


def mean_bound_s(model: str, batches: Sequence, dim: int, rel_dim: int,
                 rates) -> float:
    """Mean least seconds a step over ``batches`` of (h, r, t, neg)."""
    return float(np.mean([bound_s(step_cost(model, *bt, dim, rel_dim), rates)
                          for bt in batches]))
