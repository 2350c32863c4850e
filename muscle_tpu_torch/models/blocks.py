"""Spare building blocks of the reference's model file, off the main path
(port of ``muscle_tpu/models/blocks.py``): ``SELayer`` and
``SeparableConvBlock``.  NHWC in and out, as every module of the port;
they compute in their input's dtype (``models/layers.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from muscle_tpu_torch.models.efficientnet import BN_EPS, BN_MOMENTUM, BatchNorm2d
from muscle_tpu_torch.models.layers import Conv2d


class SELayer(nn.Module):
    """Squeeze-excite with two bias-free dense layers: the mean over the
    image, ``fc.0`` to channel // reduction, ReLU, ``fc.2`` back, and the
    sigmoid gate on x (the reference's ``fc`` Sequential; the JAX
    package's ``fc1`` / ``fc2``)."""

    def __init__(self, channel: int, reduction: int = 2):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channel, channel // reduction, bias=False),
                                nn.ReLU(),
                                nn.Linear(channel // reduction, channel, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(1, 2))
        y = F.linear(y, self.fc[0].weight.to(x.dtype))
        y = F.linear(F.relu(y), self.fc[2].weight.to(x.dtype))
        return x * torch.sigmoid(y)[:, None, None, :]


class SeparableConvBlock(nn.Module):
    """Depthwise 3 x 3 (padding 1, no bias) and pointwise 1 x 1 (bias)
    convolutions, then optionally a batch norm (eps 1e-3, the reference's
    torch momentum 0.01) and swish.  ``out_channels`` None keeps the input's
    channel count."""

    def __init__(self, in_channels: int, out_channels: int | None = None, norm: bool = True,
                 activation: bool = False):
        super().__init__()
        out = out_channels or in_channels
        self.depthwise_conv = Conv2d(in_channels, in_channels, 3, padding=1,
                                     groups=in_channels, bias=False)
        self.pointwise_conv = Conv2d(in_channels, out, 1)
        self.norm, self.activation = norm, activation
        if norm:
            self.bn = BatchNorm2d(out, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pointwise_conv(self.depthwise_conv(x.permute(0, 3, 1, 2)))
        if self.norm:
            h = self.bn(h)
        if self.activation:
            h = F.silu(h)
        return h.permute(0, 2, 3, 1)
