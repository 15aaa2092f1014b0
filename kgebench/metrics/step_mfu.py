"""The whole step's share of the card's peak: its least time on the card
(``cost/step.py``: the products at the fastest f32-accurate rate, 3xTF32,
against the unique rows' bytes at the memory rate, the larger) over the
window's measured time a step, averaged over the window's batches."""

from kgebench.cost.step import mean_bound_s


def read(rec):
    if rec.rates is None or not rec.batches:
        return None
    s = rec.spec
    least = mean_bound_s(s["model"], rec.batches, s["dim"], s["rel_dim"], rec.rates)
    return 100.0 * least / (rec.window_s / rec.steps)
