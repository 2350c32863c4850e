"""Images stepped in the window over all ranks of a data-parallel cell,
over the window's seconds (rank 0's host clock)."""

from benchmark.metrics._shared import train_rate


def read(ctx):
    return train_rate(ctx)
