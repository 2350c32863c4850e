"""Per cent of the card's peak: step A's forward and backward FLOPs of the
window's images (``counts/flops.py``) over the window's seconds."""

from benchmark.metrics._shared import train_mfu


def read(ctx):
    return train_mfu(ctx)
