"""The fused row-Adagrad kernel's share of its roofline over every traced
launch (``csrc/fused_update.cu``; one launch an apply), its valid slots the
unique ids of the batch each apply serves."""

from kgebench.cost import launches, roofline_share
from kgebench.cost.fused_update import update_cost


def read(rec):
    if rec.trace is None:
        return None
    b = rec.traced_batches
    costs = [update_cost(n, D, valid) for prev, cur in zip(b, b[1:])
             for n, D, valid in launches.applies(rec.spec, prev, cur)]
    return roofline_share(rec, ("fused_update",), costs)
