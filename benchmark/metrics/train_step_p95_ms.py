"""The 95th percentile over every step of the window of the time from a
step's start to the next one's as the card sees it (CUDA events recorded
at each step's start, read after the window)."""

import numpy as np


def read(ctx):
    ms = ctx["window"].get("step_ms")
    if not ms:
        return None
    return float(np.percentile(np.asarray(ms, np.float64), 95))
