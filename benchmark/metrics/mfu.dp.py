"""Per cent of the cards' peak in a data-parallel cell: step A's forward
and backward FLOPs of the window's images over all ranks, over the
window's seconds, against the peak of every card."""

from benchmark.metrics._shared import train_mfu


def read(ctx):
    return train_mfu(ctx)
