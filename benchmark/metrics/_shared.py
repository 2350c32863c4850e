"""Arithmetic the readers share."""

from benchmark.counts import PEAK_OF_PRECISION, PEAKS
from benchmark.counts.flops import train_image_flops


def peak_flops(ctx) -> float:
    """The peak FLOP/s of the cell's chips at its stated precision."""
    return PEAKS[PEAK_OF_PRECISION[ctx["config"]["precision"]]] * ctx["chips"]


def idle_share(ctx, units: str):
    """Per cent of the traced stretch (rank 0's) in which no operation ran
    on the device, in cells whose driver counts ``units``: both the busy
    time and the stretch on the device's clock (``trace.py``).  The
    profiler adds host time to every launch, so the stretch idles more than
    the untraced window does."""
    s = ctx["trace"]
    if s is None or ctx["driver"].units != units or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def train_rate(ctx):
    """Images stepped over all ranks, over the window's seconds."""
    w = ctx["window"]
    return w["images"] / w["seconds"] if "step_ms" in w else None


def train_mfu(ctx):
    """Per cent of the cell's cards' peak that the window's training FLOPs
    reach (step A's forward and backward, ``counts/flops.py``)."""
    w, t = ctx["window"], ctx["traffic"]
    if not ctx["cuda"] or ctx["trace"] is None or "step_ms" not in w:
        return None
    per_rank = t["batch"] // ctx["chips"]
    flops = w["images"] * train_image_flops(ctx["config"], per_rank, t["crop"])
    return 100.0 * flops / w["seconds"] / peak_flops(ctx)


def launches_per_unit(ctx, units: str):
    s = ctx["trace"]
    if s is None or ctx["driver"].units != units or s.launches == 0:
        return None
    return s.launches / s.units
