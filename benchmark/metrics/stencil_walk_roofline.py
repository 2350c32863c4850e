"""Per cent of its roofline that the stencil walk reaches in the traced
stretch: the least time the stretch's walks need on an H100
(``counts/stencil_walk.py``: each image's labelled classes on its own
(eh, ew) grid) over the device time of the walk kernel's steps in the
trace.  The kernel walks every class of the canvas, so the share is low
by design.  Nothing to read where no such kernel ran."""

from benchmark.counts.stencil_walk import least_seconds

KERNELS = r"\bstencil_step<"


def read(ctx):
    s = ctx["trace"]
    if s is None or not hasattr(ctx["driver"], "stretch_walks"):
        return None
    device_s = s.seconds_matching(KERNELS)
    if device_s <= 0:
        return None
    c = ctx["config"]
    least = sum(least_seconds(grids, c["radius"], 2 ** c["exp_times"])
                for grids in ctx["driver"].stretch_walks())
    return 100.0 * least / device_s
