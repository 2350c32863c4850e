"""ResNet-50 backbone for IRN (port of ``muscle_tpu/models/resnet50.py``).

Every BatchNorm runs on its running statistics and never updates them
(the reference's ``FixedBatchNorm``).  Convolutions pad symmetrically
(``k // 2``, torch semantics, as the published IRN weights were trained),
the stem's max pool is 3x3 / 2 with implicit -inf padding 1, and the stride
sits on each bottleneck's 3x3 conv.  Tensors are NCHW inside this module;
the IRN wrapper (``models/irn.py``) takes NHWC at its boundary.

Keys follow the reference: ``conv1``, ``bn1``, ``layer{1..4}.{i}.conv{1,2,3}``,
``bn{1,2,3}``, ``downsample.{0,1}``.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class FixedBatchNorm(nn.BatchNorm2d):
    """BatchNorm that always applies its running statistics (eps 1e-5)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, momentum=0.0, eps=self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = FixedBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FixedBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FixedBatchNorm(planes * 4)
        self.downsample = None
        if stride != 1 or cin != planes * 4:
            self.downsample = nn.Sequential(_conv(cin, planes * 4, 1, stride),
                                            FixedBatchNorm(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet50(nn.Module):
    """Returns the five stage outputs (x1..x5, NCHW) used by the IRN heads:
    the pooled stem (stride 4) and layers 1-4."""

    def __init__(self, strides: Sequence[int] = (2, 2, 2, 1)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=strides[0], padding=3, bias=False)
        self.bn1 = FixedBatchNorm(64)
        cin = 64
        for i, (planes, blocks, stride) in enumerate(
                ((64, 3, 1), (128, 4, strides[1]), (256, 6, strides[2]), (512, 3, strides[3]))):
            layer = [Bottleneck(cin, planes, stride)]
            layer += [Bottleneck(planes * 4, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            cin = planes * 4

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x1 = F.max_pool2d(x, 3, 2, 1)
        x2 = self.layer1(x1)
        x3 = self.layer2(x2)
        x4 = self.layer3(x3)
        x5 = self.layer4(x4)
        return [x1, x2, x3, x4, x5]
