"""Seconds from process start to the first timed batch or step: loading,
weights, the program's objects, warm-up (and, in a checkout's first run,
the kernels' build)."""


def read(ctx):
    return ctx["setup_s"]
