"""The rescal_proj kernel pair's share of its roofline over every traced
launch (``csrc/rescal_proj.cu``: a step's forward, then its backward, each
one launch over the batch's projection rows)."""

from kgebench.cost import roofline_share
from kgebench.cost.rescal_proj import rescal_proj_cost


def read(rec):
    if rec.trace is None:
        return None
    s = rec.spec
    per_step = [rescal_proj_cost(s["batch_size"], s["dim"], s["rel_dim"], backward)
                for backward in (False, True)]
    return roofline_share(rec, ("rescal_proj_kernel",), per_step * rec.trace.steps)
