"""The device time of every operation in the steps profiled after the
window (every run profiles them), a step."""

from kgebench.trace import total_us


def read(rec):
    if rec.trace is None or not rec.trace.device:
        return None
    return total_us(rec.trace.device) / rec.trace.steps / 1e3
