"""Model FLOPs of the IRN refinement cell, for ``mfu.irn``: the edge net
(ResNet-50 and the edge head) on an image's own (H, W), for the image and
its flip, counted by ``torch.utils.flop_counter.FlopCounterMode`` on the
reference model on the meta device.  The program runs both views on the
whole crop canvas; the padding is not counted, so it shows as lost MFU.
The walk is not counted."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.weights_irn import reference_model


@functools.lru_cache(maxsize=8)
def _image_flops(config_json: str, size: tuple[int, int]) -> int:
    config = json.loads(config_json)
    model = reference_model(config).eval()
    x = torch.empty((2, 3, *size), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x)
    return int(fc.get_total_flops())


def image_flops(config: dict, size) -> int:
    """FLOPs of one (H, W) image's two views through the edge net."""
    return _image_flops(json.dumps(config, sort_keys=True), tuple(int(s) for s in size))
