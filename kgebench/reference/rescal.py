"""RESCAL's scores (Nickel et al., 2011), as DGL-KE trains it.

f(h, r, t) = h^T M_r t, with M_r the relation's (dim, rel_dim) matrix,
stored row-major as one row of the projection table.
"""

from __future__ import annotations

import torch


def scores(E, R, P, h, r, t, neg, spec, mm=torch.matmul):
    """Positive scores (b,) and negative scores (2, b, k): tails corrupted
    from the group's first pool, heads from its second; ``mm`` takes every
    product."""
    b, d, rd = h.shape[0], spec["dim"], spec["rel_dim"]
    ng, k = neg.shape[1], neg.shape[2]
    M = P[r].view(b, d, rd)
    eh, et = E[h], E[t]
    hM = mm(eh.unsqueeze(1), M).squeeze(1)  # (b, rel_dim): h^T M_r
    Mt = mm(M, et.unsqueeze(2)).squeeze(2)  # (b, dim): M_r t
    pos = (hM * et).sum(-1)
    tails, heads = E[neg[0]], E[neg[1]]  # (ng, k, dim)
    neg_t = mm(hM.view(ng, b // ng, rd), tails.transpose(1, 2))
    neg_h = mm(Mt.view(ng, b // ng, d), heads.transpose(1, 2))
    return pos, torch.stack([neg_t.reshape(b, k), neg_h.reshape(b, k)])
