"""The dedup-aggregate kernel's share of its roofline over every traced
launch (``csrc/dedup_aggregate.cu``; one launch an apply)."""

from kgebench.cost import launches, roofline_share
from kgebench.cost.dedup_aggregate import dedup_cost


def read(rec):
    if rec.trace is None:
        return None
    b = rec.traced_batches
    costs = [dedup_cost(n, D) for prev, cur in zip(b, b[1:])
             for n, D, _ in launches.applies(rec.spec, prev, cur)]
    return roofline_share(rec, ("dedup_",), costs)
