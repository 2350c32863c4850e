"""The engine's device pipeline alone (``bench_device_exec``: every TTA
scale and the fusion on resident tensors, no host prep, upload or
download), images a second over chained calls timed with CUDA events."""


def read(ctx):
    return getattr(ctx["driver"], "device_only", None)
