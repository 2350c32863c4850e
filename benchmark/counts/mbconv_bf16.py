"""The least time an H100 needs for the stride-1 MBConv blocks of a
serving cell whose model computes in bfloat16 (the roofline of
``mbconv_roofline.bf16``).

The same work as ``counts/mbconv.py`` counts (each image at its unpadded
scaled size, both flips, every TTA scale, every fused block; a call reads
x and its weights once and writes y once), at bfloat16: x, y and the
weight matrices in 2 bytes, the folded scales and biases in 4; the 1x1
products held to the bf16 tensor-core peak, the depthwise and elementwise
work to the f32 peak (the kernel computes them in f32), the bytes to
HBM's.
"""

from __future__ import annotations

from benchmark.counts import PEAKS
from benchmark.counts.mbconv import fused_blocks


def call_work(px: int, cin: int, cmid: int, csq: int, cout: int, k: int,
              has_expand: bool) -> tuple[int, int, int]:
    """(bytes, 1x1-product FLOPs, depthwise FLOPs) of one bf16 block call
    over ``px`` output pixels."""
    matrices = (cin * cmid if has_expand else 0) + k * k * cmid + 2 * cmid * csq + cmid * cout
    vectors = (2 * cmid if has_expand else 0) + 2 * cmid + csq + cmid + 2 * cout
    nbytes = 2 * (px * (cin + cout) + matrices) + 4 * vectors
    products = 2 * px * ((cin * cmid if has_expand else 0) + cmid * cout)
    return nbytes, products, 2 * px * k * k * cmid


def least_seconds(nbytes: float, products: float, depthwise: float) -> float:
    """The larger of the bytes' time and the operations' time."""
    ops = products / PEAKS["bf16_flops_per_s"] + depthwise / PEAKS["f32_flops_per_s"]
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops)


def batch_least_seconds(config: dict, scales, sizes) -> float:
    """Least seconds of one bf16 TTA batch of images of ``sizes`` ((h, w)
    each): one call per scale and block over the batch's unpadded
    pixels."""
    total = 0.0
    for s in scales:
        scaled = [(round(h * s), round(w * s)) for h, w in sizes]
        for stride, cin, cmid, csq, cout, k, ex in fused_blocks(config):
            px = sum(2 * (h // stride) * (w // stride) for h, w in scaled)
            total += least_seconds(*call_work(px, cin, cmid, csq, cout, k, ex))
    return total
