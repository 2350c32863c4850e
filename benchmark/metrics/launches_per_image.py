"""CUDA kernel launches in the traced stretch over its images: the host's
dispatch load a served image costs (copies and memsets not counted)."""

from benchmark.metrics._shared import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, "images")
