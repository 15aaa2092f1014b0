"""The pairwise kernel's share of its roofline over every traced launch
(``csrc/pairwise.cu``; the joint negatives' scores, one launch a side)."""

from kgebench.cost import launches, roofline_share
from kgebench.cost.pairwise import pairwise_cost


def read(rec):
    if rec.trace is None:
        return None
    per_step = [pairwise_cost(*shape) for shape in launches.pairwise(rec.spec)]
    return roofline_share(rec, ("pairwise_",), per_step * rec.trace.steps)
