"""The 95th percentile, over every step of the window, of the time between
consecutive step boundaries on the device's timeline (CUDA events recorded
between steps), idle gaps included."""

import numpy as np


def read(rec):
    return float(np.percentile(rec.step_ms, 95)) if rec.step_ms else None
