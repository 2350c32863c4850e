"""Per cent of the card's peak in the refinement cell: the edge net's
FLOPs for the window's images (each image and its flip through ResNet-50
and the edge head at the image's own size, ``counts/irn.py``) over the
window's seconds.  The walk and the canvas's padding are not counted."""

from benchmark.counts.irn import image_flops
from benchmark.metrics._shared import peak_flops


def read(ctx):
    w = ctx["window"]
    if (not ctx["cuda"] or ctx["trace"] is None or "images_by_size" not in w
            or not hasattr(ctx["driver"], "stretch_walks")):
        return None
    flops = sum(n * image_flops(ctx["config"], size) for size, n in w["images_by_size"].items())
    return 100.0 * flops / w["seconds"] / peak_flops(ctx)
