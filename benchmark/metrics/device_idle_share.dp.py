"""Per cent of rank 0's traced stretch in which no operation ran on its
card (an NCCL kernel waiting for the other ranks counts as running)."""

from benchmark.metrics._shared import idle_share


def read(ctx):
    return idle_share(ctx, "steps")
