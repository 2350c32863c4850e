"""CUDA kernel launches in the traced stretch over its training steps."""

from benchmark.metrics._shared import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, "steps")
