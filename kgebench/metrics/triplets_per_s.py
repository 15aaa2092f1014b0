"""Positive triplets of every step in the window over the window's seconds
(host clock, from a device sync before the first timed step to one after
the last)."""


def read(rec):
    return rec.steps * rec.spec["batch_size"] / rec.window_s
