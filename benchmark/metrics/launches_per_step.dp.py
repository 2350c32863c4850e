"""CUDA kernel launches in rank 0's traced stretch over its steps."""

from benchmark.metrics._shared import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, "steps")
