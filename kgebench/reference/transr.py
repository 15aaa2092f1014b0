"""TransR's scores (Lin et al., 2015), as DGL-KE trains it.

f(h, r, t) = gamma - || h M_r + r - t M_r ||_2, with M_r the relation's
(dim, rel_dim) projection, stored row-major as one row of the projection
table, and 1e-12 under the square root.
"""

from __future__ import annotations

import torch


def _score(diff, gamma):
    return gamma - torch.sqrt((diff * diff).sum(-1) + 1e-12)


def scores(E, R, P, h, r, t, neg, spec, mm=torch.matmul):
    """Positive scores (b,) and negative scores (2, b, k): tails corrupted
    from the group's first pool, heads from its second. Every negative is
    projected through the matrix of each triplet that it corrupts; ``mm``
    takes every product."""
    b, d, rd, gamma = h.shape[0], spec["dim"], spec["rel_dim"], spec["gamma"]
    ng, k = neg.shape[1], neg.shape[2]
    gsz = b // ng
    M = P[r].view(b, d, rd)
    hM = mm(E[h].unsqueeze(1), M).squeeze(1)  # (b, rel_dim)
    tM = mm(E[t].unsqueeze(1), M).squeeze(1)
    rr = R[r]
    pos = _score(hM + rr - tM, gamma)
    Mg = M.view(ng, gsz, d, rd)
    # the pools projected by every triplet's matrix: (ng, gsz, k, rel_dim)
    pt = mm(E[neg[0]].unsqueeze(1), Mg)
    ph = mm(E[neg[1]].unsqueeze(1), Mg)
    neg_t = _score((hM + rr).view(ng, gsz, 1, rd) - pt, gamma)  # h M + r - t'M
    neg_h = _score(ph + (rr - tM).view(ng, gsz, 1, rd), gamma)  # h'M + r - t M
    return pos, torch.stack([neg_t.reshape(b, k), neg_h.reshape(b, k)])
