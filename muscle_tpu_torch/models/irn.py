"""IRN (Inter-pixel Relation Network) edge and displacement heads (port of
``muscle_tpu/models/irn.py``).

A frozen ResNet-50 feeds two heads: a class-boundary edge map and a
2-channel displacement field.  ``IRNNet`` is the raw two-head net that IRN
training runs; ``EdgeDisplacement`` is its inference wrapper for the
random-walk refinement: it pads the (orig, flip) pair to a fixed crop,
runs the net once, and fuses ``sigmoid(e0/2 + flip(e1)/2)``.

Keys follow the reference: ``resnet50.*``, ``fc_edge{1..5}.{0,1}``,
``fc_edge6.{weight,bias}``, ``fc_dp{1..6}.{0,1}``, ``fc_dp7.{0,1,3}``,
``mean_shift.running_mean``.  Heads run NCHW; the wrapper takes NHWC.
The net computes in its input's dtype, float32 or bfloat16
(``models/layers.py``): group norms in float32 rounded to it, the heads'
upsamples with interpolation matrices in it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from muscle_tpu_torch.core.resize import resize_bilinear
from muscle_tpu_torch.models.layers import Conv2d, GroupNorm
from muscle_tpu_torch.models.resnet50 import ResNet50


def _upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Half-pixel bilinear upsample of an NCHW tensor by ``factor``."""
    _, _, h, w = x.shape
    up = resize_bilinear(x.permute(0, 2, 3, 1), (h * factor, w * factor), align_corners=False)
    return up.permute(0, 3, 1, 2)


class _ConvGN(nn.Sequential):
    """1x1 conv (no bias) + GroupNorm (eps 1e-5), then an optional bilinear
    upsample and ReLU."""

    def __init__(self, cin: int, cout: int, groups: int, upsample: int = 1):
        super().__init__(Conv2d(cin, cout, 1, bias=False), GroupNorm(groups, cout, eps=1e-5))
        self.upsample = upsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        if self.upsample > 1:
            x = _upsample(x, self.upsample)
        return F.relu(x)


class _MeanShift(nn.Module):
    """Inference MeanShift: subtracts the running mean of the displacement."""

    def __init__(self, channels: int = 2):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x - self.running_mean[None, :, None, None]


class IRNNet(nn.Module):
    """ResNet-50 + the edge and displacement heads, the net IRN training
    runs: the backbone is frozen (run without autograd, as the JAX
    package's ``stop_gradient``), the heads train."""

    def __init__(self):
        super().__init__()
        self.resnet50 = ResNet50(strides=(2, 2, 2, 1))
        self.fc_edge1 = _ConvGN(64, 32, 4)
        self.fc_edge2 = _ConvGN(256, 32, 4)
        self.fc_edge3 = _ConvGN(512, 32, 4, upsample=2)
        self.fc_edge4 = _ConvGN(1024, 32, 4, upsample=4)
        self.fc_edge5 = _ConvGN(2048, 32, 4, upsample=4)
        self.fc_edge6 = Conv2d(160, 1, 1, bias=True)
        self.fc_dp1 = _ConvGN(64, 64, 8)
        self.fc_dp2 = _ConvGN(256, 128, 16)
        self.fc_dp3 = _ConvGN(512, 256, 16)
        self.fc_dp4 = _ConvGN(1024, 256, 16, upsample=2)
        self.fc_dp5 = _ConvGN(2048, 256, 16, upsample=2)
        self.fc_dp6 = _ConvGN(768, 256, 16, upsample=2)
        self.fc_dp7 = nn.Sequential(Conv2d(448, 256, 1, bias=False),
                                    GroupNorm(16, 256, eps=1e-5), nn.ReLU(),
                                    Conv2d(256, 2, 1, bias=False))
        self.mean_shift = _MeanShift(2)

    def head_parameters(self) -> list[nn.Parameter]:
        """The parameters IRN training updates: every one but the
        backbone's."""
        return [p for n, p in self.named_parameters() if not n.startswith("resnet50.")]

    def _edge_logits(self, feats) -> torch.Tensor:
        x1, x2, x3, x4, x5 = feats
        e1 = self.fc_edge1(x1)
        e2 = self.fc_edge2(x2)
        h, w = e2.shape[2:]
        e3 = self.fc_edge3(x3)[..., :h, :w]
        e4 = self.fc_edge4(x4)[..., :h, :w]
        e5 = self.fc_edge5(x5)[..., :h, :w]
        return self.fc_edge6(torch.cat([e1, e2, e3, e4, e5], dim=1))

    def _displacement(self, feats) -> torch.Tensor:
        x1, x2, x3, x4, x5 = feats
        d1 = self.fc_dp1(x1)
        d2 = self.fc_dp2(x2)
        d3 = self.fc_dp3(x3)
        h3, w3 = d3.shape[2:]
        d4 = self.fc_dp4(x4)[..., :h3, :w3]
        d5 = self.fc_dp5(x5)[..., :h3, :w3]
        d_up3 = self.fc_dp6(torch.cat([d3, d4, d5], dim=1))[..., :d2.shape[2], :d2.shape[3]]
        return self.mean_shift(self.fc_dp7(torch.cat([d1, d2, d_up3], dim=1)))

    def forward(self, x: torch.Tensor):
        """x: (N, H, W, 3) NHWC normalised images.  Returns the raw
        (edge logits (N, h, w, 1), displacement (N, h, w, 2)) at stride 4,
        NHWC, without the inference wrapper's flip fusion."""
        with torch.no_grad():
            feats = self.resnet50(x.permute(0, 3, 1, 2).contiguous())
        return (self._edge_logits(feats).permute(0, 2, 3, 1),
                self._displacement(feats).permute(0, 2, 3, 1))


class EdgeDisplacement(IRNNet):
    """``IRNNet`` with the reference's inference wrapper; the two share
    modules and state-dict keys, so trained ``IRNNet`` weights load here."""

    def __init__(self, crop_size: int = 512, stride: int = 4):
        super().__init__()
        self.crop_size = crop_size
        self.stride = stride

    def _run(self, x: torch.Tensor, valid_hw, crop_size, with_dp: bool):
        single = x.ndim == 4
        if single:
            x = x[None]
            valid_hw = None if valid_hw is None else valid_hw[None]
        b, _, hh, ww, _ = x.shape
        crop = self.crop_size if crop_size is None else crop_size
        fh = (hh - 1) // self.stride + 1
        fw = (ww - 1) // self.stride + 1
        x = x.reshape(2 * b, hh, ww, 3).permute(0, 3, 1, 2)
        x = F.pad(x, (0, crop - ww, 0, crop - hh)).contiguous()
        feats = self.resnet50(x)
        edge_out = self._edge_logits(feats)[:, 0, :fh, :fw].reshape(b, 2, fh, fw)
        if valid_hw is None:
            flipped = edge_out[:, 1].flip(-1)
        else:
            # un-flip the flipped branch within each image's valid feature
            # width (the reference crops to the feature size before the flip)
            ew = (valid_hw[:, 1].to(torch.long) - 1) // self.stride + 1
            cols = torch.arange(fw, device=x.device)
            src = torch.clamp(ew[:, None] - 1 - cols[None], 0, fw - 1)
            flipped = torch.gather(edge_out[:, 1], 2, src[:, None, :].expand(b, fh, fw))
        edge = torch.sigmoid(edge_out[:, 0] / 2 + flipped / 2)
        dp = None
        if with_dp:
            dp = self._displacement(feats)[:, :, :fh, :fw].reshape(b, 2, 2, fh, fw)[:, 0]
        if single:
            edge = edge[0]
            dp = None if dp is None else dp[0]
        return edge, dp

    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor | None = None,
                crop_size: int | None = None):
        """x: (2, H, W, 3) NHWC image and its horizontal flip, or a batch
        (B, 2, H, W, 3) of such pairs.  Returns (edge, dp): edge (h', w')
        and dp (2, h', w') with h' = (H-1)//stride + 1 (a leading B for a
        batch).

        valid_hw: optional (2,) (or (B, 2)) valid (h, w) of each pair
        placed top-left in a larger canvas; the flipped branch is then
        un-flipped within the valid feature width.  crop_size: the canvas
        the net runs on (default ``self.crop_size``); GroupNorm statistics
        cover the whole canvas, so it is part of the result."""
        return self._run(x, valid_hw, crop_size, with_dp=True)

    def edge(self, x: torch.Tensor, valid_hw: torch.Tensor | None = None,
             crop_size: int | None = None) -> torch.Tensor:
        """The edge map of ``forward`` alone, without running the
        displacement heads (what the random walk consumes)."""
        return self._run(x, valid_hw, crop_size, with_dp=False)[0]
