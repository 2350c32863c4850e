"""Per cent of the chip's peak: the model FLOPs of the window's images
(each image through every TTA scale and flip at its unpadded scaled size,
``counts/flops.py``) over the window's seconds."""

from benchmark.counts.flops import image_flops
from benchmark.metrics._shared import peak_flops


def read(ctx):
    w = ctx["window"]
    if not ctx["cuda"] or ctx["trace"] is None or "images_by_size" not in w:
        return None
    scales = ctx["traffic"]["engine"]["scales"]
    flops = sum(n * image_flops(ctx["config"], scales, size)
                for size, n in w["images_by_size"].items())
    return 100.0 * flops / w["seconds"] / peak_flops(ctx)
