"""Which launches of the port's kernels one training step makes, in order,
with the shapes their cost formulas take.

The step's sparse updates run in this order: the entity table (with T5 on,
the flush of the previous step's gradients at the step's start; else the
apply at its end), then the relation table, then the projection table.
Each is one dedup-aggregate launch and one fused-update launch over the
step's workspace ids: the entity rows of h, t and both negative pools, and
the relation ids once for each relation-indexed table. Valid slots are the
unique ids. The joint negatives' pairwise kernel runs once a corruption
side for the models that score their negatives through it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from kgebench.cost.pairwise import MODE_OF


def _entity_ids(batch) -> np.ndarray:
    h, r, t, neg = batch
    return np.concatenate([h, t, np.asarray(neg).reshape(-1)])


def applies(spec: dict, prev, cur) -> List[Tuple[int, int, int]]:
    """(slots n, row width D, valid slots) of each apply of the step that
    takes batch ``cur`` after batch ``prev``."""
    d, rd = spec["dim"], spec["rel_dim"]
    ent = _entity_ids(prev if spec["overlap_update"] else cur)
    r = np.asarray(cur[1])
    out = [(ent.size, d, np.unique(ent).size), (r.size, rd, np.unique(r).size)]
    if spec["projection_init"] is not None:  # the projection table
        out.append((r.size, d * rd, np.unique(r).size))
    return out


def pairwise(spec: dict) -> List[Tuple[str, int, int, int, int]]:
    """(mode, G, B, K, D) of each pairwise launch of a step."""
    mode = MODE_OF[spec["model"]]
    if mode is None:
        return []
    b = spec["batch_size"]
    ng = b // spec["neg_group_size"]
    return [(mode, ng, b // ng, spec["neg_sample_size"], spec["dim"])] * 2
