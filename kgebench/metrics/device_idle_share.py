"""The share of the traced window in which the device ran nothing: one less
the union of the traced device operations' intervals over the traced
window's length (the result line's ``device.busy_s`` over its
``window_s``).

The trace holds the device's activity alone; CUPTI's cost on every launch
still slows the host while it traces, so where the host's enqueue is near
the device's step, as RESCAL's is, this reads above the untraced window's
idle share.
"""

from kgebench.trace import busy_us


def read(rec):
    if rec.trace is None or not rec.trace.device:
        return None
    return 100.0 * (1.0 - busy_us(rec.trace.device) / 1e6 / rec.trace.window_s)
