"""The least time an H100 needs for the random walks of a refinement
cell's traced batches (the roofline of ``stencil_walk_roofline``).

The work is what the refinement needs, whatever implements the walk: each
image's labelled classes on its own (eh, ew) grid, for 2^exp_times steps.
Walked canvas padding and unlabelled classes are waste.  A step of one
class at one node adds, for each of the D search directions, the two
neighbours' weighted mass (two multiply-adds), then scales the sum by the
node's reciprocal column sum: 4 D + 1 operations.  A walk (one call per
batch) reads the iterate and writes it once, and reads the direction
weights (D planes) and the reciprocal column sums once.  Operations are
held to the f32 peak, bytes to HBM's; the arithmetic is that of the port's
``ops/stencil_walk.py`` ``walk_work``.
"""

from __future__ import annotations

from benchmark.counts import PEAKS


def directions(radius: int) -> int:
    """D: the search directions of the radius, (0, 1) .. (0, radius - 1)
    and every (dy > 0, dx) strictly inside it."""
    r2 = radius * radius
    return (radius - 1) + sum(1 for y in range(1, radius) for x in range(1 - radius, radius)
                              if x * x + y * y < r2)


def walk_work(grids, radius: int, steps: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one walk over images of ``grids`` ((eh, ew,
    labelled classes) each)."""
    d = directions(radius)
    nbytes = flops = 0
    for eh, ew, c in grids:
        nodes = eh * ew
        nbytes += 4 * (2 * c * nodes + d * nodes + nodes)
        flops += c * steps * nodes * (4 * d + 1)
    return nbytes, flops


def least_seconds(grids, radius: int, steps: int) -> float:
    """The larger of one walk's bytes' time and its operations' time."""
    nbytes, flops = walk_work(grids, radius, steps)
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / PEAKS["f32_flops_per_s"])
