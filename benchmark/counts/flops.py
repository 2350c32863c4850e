"""Model FLOPs of a cell's work, for the ``mfu.*`` metrics: counted by
``torch.utils.flop_counter.FlopCounterMode`` on the reference model on the
meta device (no memory, no compute), at the traffic's own shapes.

Serving: one forward of each image at its unpadded scaled size at every TTA
scale, times two for the flip; canvas padding is waste.  Training: step A's
forward and backward over one batch, divided by the batch.
"""

from __future__ import annotations

import functools
import json
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.weights import reference_model

# the model's forward mode in each kind of serving cell
SERVE_MODE = {"enc": "cam_lowres", "dec": "seg_lowres"}


def _conv_backward(grad_out_shape, x_shape, w_shape, *args, **kwargs) -> int:
    """A convolution's backward: the input's and the weight's gradients
    each cost the forward's 2 * out elements * (Cin / groups) * k * k.
    (The counter's own formula ignores ``groups``, which counts a
    depthwise convolution's backward as a dense one.)"""
    output_mask = args[7]
    fwd = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def _count(fn) -> int:
    mapping = {torch.ops.aten.convolution_backward: _conv_backward}
    with FlopCounterMode(display=False, custom_mapping=mapping) as fc:
        fn()
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=64)
def _forward_flops(config_json: str, h: int, w: int) -> int:
    config = json.loads(config_json)
    model = reference_model(config).eval()
    x = torch.empty((1, h, w, 3), device="meta")
    with torch.no_grad():
        return _count(lambda: model(x, mode=SERVE_MODE[config["mode"]]))


def image_flops(config: dict, scales, size) -> int:
    """FLOPs of one image of ``size`` (h, w) through every scale and flip."""
    h, w = size
    key = json.dumps(config, sort_keys=True)
    return sum(2 * _forward_flops(key, round(h * s), round(w * s)) for s in scales)


def train_image_flops(config: dict, batch: int, crop: int) -> float:
    """FLOPs of step A's forward and backward, per image, at ``batch`` x
    ``crop`` x ``crop``."""
    from benchmark.reference.mcl import loss_a

    model = reference_model(config).train()
    side = crop // 2
    b = {"img_y": torch.zeros((batch, crop, crop), dtype=torch.uint8, device="meta"),
         "img_c": torch.zeros((batch, side, side, 2), dtype=torch.uint8, device="meta"),
         "label": torch.zeros((batch, 20), device="meta")}
    return _count(lambda: loss_a(model, b, None).backward()) / batch
