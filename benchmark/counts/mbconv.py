"""The least time an H100 needs for the stride-1 MBConv blocks that a
serving cell's traffic runs through the MBConv kernel (the roofline of
``mbconv_roofline``).

The work is what the traffic needs, whatever implements the block: each
image at its unpadded scaled size (both flips), at every TTA scale, through
every stride-1 block with at most ``fuse_mbconv`` input channels.  Canvas
padding is waste.  A call (one per batch, scale and block) reads x and its
weights once and writes y once; the expanded map never leaves the chip.
The 1x1 products are held to the TF32 tensor-core peak, which no
f32-accurate implementation beats, the depthwise and elementwise work to
the f32 peak, the bytes to HBM's.  The arithmetic is that of the port's
``chip_smoke.py`` / ``ops/mbconv.py`` (``block_work``, ``block_flops``,
``bound_tc_ms``), with the products at TF32's full rate.
"""

from __future__ import annotations

from benchmark.counts import PEAKS
from benchmark.reference.model import blocks_of


def fused_blocks(config: dict) -> list[tuple[int, int, int, int, int, int, bool]]:
    """(output stride, Cin, Cmid, Csq, Cout, k, has_expand) of each block of
    the configuration that the kernel runs."""
    out, stride = [], 2  # the stem is stride 2
    for a in blocks_of(config["backbone"], config["last_pooling"]):
        stride *= a.stride
        if a.stride == 1 and a.input_filters <= config["fuse_mbconv"]:
            cin = a.input_filters
            out.append((stride, cin, cin * a.expand_ratio, max(1, int(cin * 0.25)),
                        a.output_filters, a.kernel_size, a.expand_ratio != 1))
    return out


def call_work(px: int, cin: int, cmid: int, csq: int, cout: int, k: int,
              has_expand: bool) -> tuple[int, int, int]:
    """(bytes, 1x1-product FLOPs, depthwise FLOPs) of one f32 block call over
    ``px`` output pixels: x in and y out once, the weight matrices and the
    folded scales and biases once, and the products' multiply-adds."""
    matrices = (cin * cmid if has_expand else 0) + k * k * cmid + 2 * cmid * csq + cmid * cout
    vectors = (2 * cmid if has_expand else 0) + 2 * cmid + csq + cmid + 2 * cout
    nbytes = 4 * (px * (cin + cout) + matrices + vectors)
    products = 2 * px * ((cin * cmid if has_expand else 0) + cmid * cout)
    return nbytes, products, 2 * px * k * k * cmid


def least_seconds(nbytes: float, products: float, depthwise: float) -> float:
    """The larger of the bytes' time and the operations' time."""
    ops = products / PEAKS["tf32_flops_per_s"] + depthwise / PEAKS["f32_flops_per_s"]
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops)


def batch_least_seconds(config: dict, scales, sizes) -> float:
    """Least seconds of one TTA batch of images of ``sizes`` ((h, w) each):
    one call per scale and block over the batch's unpadded pixels."""
    total = 0.0
    for s in scales:
        scaled = [(round(h * s), round(w * s)) for h, w in sizes]
        for stride, cin, cmid, csq, cout, k, ex in fused_blocks(config):
            px = sum(2 * (h // stride) * (w // stride) for h, w in scaled)
            total += least_seconds(*call_work(px, cin, cmid, csq, cout, k, ex))
    return total
