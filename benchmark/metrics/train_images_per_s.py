"""Images stepped in the window over the window's seconds (host clock,
first step enqueued to the last step done)."""

from benchmark.metrics._shared import train_rate


def read(ctx):
    return train_rate(ctx)
