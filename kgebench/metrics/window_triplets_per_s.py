"""Positive triplets of every step in the window over the window's seconds
(host clock, from a device sync before the first timed step to one after
the last). The host's enqueue paces RESCAL's step, and a loaded host
TransR's, so this swings with the host's load from run to run; it stands
per layer beside the device time a step, the end-to-end metric."""


def read(rec):
    return rec.steps * rec.spec["batch_size"] / rec.window_s
