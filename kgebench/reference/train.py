"""The plain reference of a KGE training run's first steps.

Each step, as DGL-KE's single-trainer loop with its deferred entity update
(T5) describes it:

1. apply the previous step's entity gradient (T5 on) to the entity table;
2. score the batch's positives and its two pools of joint negatives
   (``<model>.py``) and take the loss: the mean of softplus(-f) over the
   positives plus, for each positive and side, its negatives' softplus(f)
   weighted by softmax(f) over them, a constant to the gradient, averaged
   (DGL-KE's ``-adv`` at temperature 1);
3. take the loss's gradient with respect to the whole tables by autograd
   (a row's gradient is the sum over every slot that reads it);
4. Adagrad on every table: gsq += g^2, table -= lr g / (sqrt(gsq) + eps)
   where g is that gradient: rows the batch does not touch have g = 0 and
   stay as they are. The entity table's step waits for step 1 of the next
   step when T5 is on, and the last step's for the flush after the run.

In float32 with cuBLAS's TF32 off; with ``tf32`` (the control) every
product's operands are rounded to TF32 (``precision.py``). It takes the
initial tables and the batches from the caller, who draws them from the
seed for the program too, and nothing else.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from kgebench.reference.precision import matmul_of

LEAVES = ("entity", "relation", "projection")


@contextlib.contextmanager
def float32_products():
    """cuBLAS's own TF32 off, whatever the caller had set."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _adagrad(table, gsq, g, lr, eps):
    gsq.add_(g * g)
    table.sub_(lr * g / (torch.sqrt(gsq) + eps))


def self_adversarial_loss(pos, neg):
    """``pos`` (b,), ``neg`` (2, b, k): the scalar loss."""
    w = torch.softmax(neg.detach(), dim=-1)
    return F.softplus(-pos).mean() + (w * F.softplus(neg)).sum(-1).mean()


def run(scores, spec: dict, tables: Dict[str, torch.Tensor], batches: Sequence,
        tf32: bool = False, fault: Optional[str] = None) -> dict:
    """Train ``len(batches)`` steps from ``tables`` (entity, relation and,
    for the models that have one, projection; modified in place).
    ``batches``: (h, r, t, neg) int64 tensors on the tables' device. ``fault="half_batch"`` leaves out the
    second half of every batch's triplets, the loss their mean over the
    rest (a fault the comparison must catch).

    Returns ``losses`` (one a step), ``grad_norms`` (each table's first
    gradient, by leaf), ``change_norms`` (each table's change after the
    last step and the flush of the entity table's pending update)."""
    lr, eps = spec["lr"], spec["eps"]
    leaves_of = [n for n in LEAVES if n in tables]  # no projection: None
    t0 = {n: tables[n].clone() for n in leaves_of}
    gsq = {n: torch.zeros_like(tables[n]) for n in leaves_of}
    pending = None
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    mm = matmul_of(tf32)
    with float32_products():
        for step, (h, r, t, neg) in enumerate(batches):
            if pending is not None:  # T5: last step's entity gradient
                _adagrad(tables["entity"], gsq["entity"], pending, lr, eps)
                pending = None
            if fault == "half_batch":
                half = h.shape[0] // 2
                h, r, t = h[:half], r[:half], t[:half]
            leaves = {n: tables[n].detach().requires_grad_() for n in leaves_of}
            pos, neg_s = scores(*(leaves.get(n) for n in LEAVES), h, r, t, neg, spec,
                                mm)
            loss = self_adversarial_loss(pos, neg_s)
            grads = dict(zip(leaves_of, torch.autograd.grad(
                loss, list(leaves.values()), allow_unused=True)))
            grads = {n: torch.zeros_like(tables[n]) if g is None else g
                     for n, g in grads.items()}
            losses.append(float(loss.detach()))
            if step == 0:
                grad_norms = {n: float(torch.linalg.vector_norm(
                    g, dtype=torch.float64)) for n, g in grads.items()}
            with torch.no_grad():
                for n in leaves_of[1:]:  # the relation-indexed tables
                    _adagrad(tables[n], gsq[n], grads[n], lr, eps)
                if spec["overlap_update"]:
                    pending = grads["entity"]
                else:
                    _adagrad(tables["entity"], gsq["entity"], grads["entity"], lr, eps)
            del leaves, grads, pos, neg_s, loss
        if pending is not None:  # the flush after the run
            _adagrad(tables["entity"], gsq["entity"], pending, lr, eps)
    change = {n: float(torch.linalg.vector_norm(tables[n] - t0[n], dtype=torch.float64))
              for n in leaves_of}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
