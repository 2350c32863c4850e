"""Seeded random weights for the IRN configuration, made on the device and
named by the reference's state-dict keys (``reference/irn.py``), so one set
loads into the reference's ``EdgeNet`` and the program's
``EdgeDisplacement``.

Convolutions and batch norms as ``weights.fill`` draws them (lecun-normal
kernels, norms near the identity with random running statistics); group
norms' scales and shifts drawn from the same ranges as a batch norm's.
Then the edge head's last convolution is rescaled on two of the traffic's
images so that its logits there have a median of logit(0.24) and a
spread of 2 (the configuration's ``assumed``): the edge map then spreads
over (0, 1) with a median near 0.24.  Unscaled, a random head puts the
edges near 0.5 or near 0 depending on the draw, and the walk is either
stopped everywhere ((1 - e)^8 ~ 4e-3) or free everywhere.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from benchmark.reference.irn import EdgeNet, normalised
from benchmark.weights import BN_RANGES, fill

EDGE_MEDIAN, EDGE_SPREAD = 0.24, 2.0


def reference_model(config: dict) -> EdgeNet:
    """The configuration's reference edge net, uninitialised, on the meta
    device."""
    with torch.device("meta"):
        return EdgeNet(strides=tuple(config["strides"]))


@torch.no_grad()
def calibrate_edge(model: EdgeNet, images, crop: int, stride: int) -> None:
    """Rescale ``fc_edge6`` so that its logits over the feature windows of
    ``images`` (HWC uint8) have the median logit(EDGE_MEDIAN) and the
    standard deviation EDGE_SPREAD."""
    dev = next(model.parameters()).device
    feats = []
    hook = model.fc_edge6.register_forward_pre_hook(lambda m, args: feats.append(args[0]))
    for img in images:
        h, w = img.shape[:2]
        model(normalised(img, crop, dev)[:1])
        f = feats.pop()[0, :, : (h - 1) // stride + 1, : (w - 1) // stride + 1]
        feats.append(f.reshape(f.shape[0], -1))
    hook.remove()
    f = torch.cat(feats, dim=1)
    w = model.fc_edge6.weight[0, :, 0, 0]
    logits = w @ f
    w = w * (EDGE_SPREAD / logits.std())
    model.fc_edge6.weight.copy_(w[None, :, None, None])
    model.fc_edge6.bias.fill_(math.log(EDGE_MEDIAN / (1 - EDGE_MEDIAN)))
    model.fc_edge6.bias.sub_((w @ f).median())


@torch.no_grad()
def make(config: dict, seed: int, device, images=()) -> EdgeNet:
    """The seed's reference edge net for ``config`` on ``device``, in eval
    mode, its edge head calibrated on ``images`` (HWC uint8, the
    traffic's own) at the configuration's crop."""
    model = reference_model(config).to_empty(device=device)
    fill(model, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, nn.GroupNorm):
            for name in ("weight", "bias"):
                lo, hi = BN_RANGES[name]
                t = getattr(m, name)
                t.copy_(torch.rand(t.shape, generator=gen, device=device) * (hi - lo) + lo)
    model.eval()
    calibrate_edge(model, [np.asarray(i) for i in images], config["crop"], config["stride"])
    return model
