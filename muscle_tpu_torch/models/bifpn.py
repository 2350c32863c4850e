"""BiFPN decoder of MuSCLe's segmentation mode (port of
``muscle_tpu/models/bifpn.py``).  Tensors are NHWC.

The fusion topology is the reference's, quirks included:

  p6_mid = mid(cat[p6, p7])
  p5_mid = mid(cat[p5, up(p6_mid)])
  p4_mid = mid(cat[p4, p5])             # p5, not p5_mid
  p3_out = mid(cat[p3, up(p4_mid)])
  p4_out = out4(p4 + p4_mid + up(avgpool3x3s2(p3_out)))
  p5_out = out5(p5 + p5_mid + p4_out)
  p6_out = out6(p6 + p6_mid + [up(avgpool3x3s2(p5_out)) if last_pooling else p5_out])
  p7_out = out7(p7 + p6_out)

Mid convs are 1x1 + swish with no batch norm; lateral (``inp*``) and out
convs are 1x1 + BN + swish.  These BNs keep torch's defaults (eps 1e-5,
momentum 0.1 = Flax's 0.9), unlike the backbone's (1e-3), and update
their running variance with the biased batch variance, as the backbone's
do.  ``up`` is an align_corners=True bilinear resize to the target
level's size.

Compute dtype: the decoder runs in its inputs' dtype (float32 or
bfloat16, ``models/layers.py``).  The window resizes and pools take float32
weights, so at bfloat16 their outputs, and the sums they enter, promote to
float32 as in the JAX package; each conv's input is cast back to the
compute dtype, where Flax's ``nn.Conv(dtype=bf16)`` casts it.

Window-exact mode (``windows``): every conv is 1x1, so a padded canvas can
only leak into the valid windows through the upsamples and the pools.
Given per-level windows, those become per-image window resizes and window
pools, and every output is re-zeroed outside its window after every conv
(a mid's swish(bias) or an out's BN would otherwise paint the padding).
The canvas forward then equals the unpadded one.

State-dict keys follow the reference: ``inp{3..7}.{0,1}`` and
``BIFPN_Layers.{i}.{convp67,convp56,convp45,convp34,out4..out7}.{0,1}``
(0 the conv, 1 the batch norm).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from muscle_tpu_torch.core.resize import (
    avg_pool_3x3_s2,
    batched_window_avgpool_s2,
    batched_window_resize_ac,
    resize_to,
)
from muscle_tpu_torch.models.efficientnet import BatchNorm2d
from muscle_tpu_torch.models.layers import Conv2d
from muscle_tpu_torch.ops.mbconv import window_mask


class ConvBNSwish(nn.Sequential):
    """1x1 conv (with bias), optional BatchNorm (eps 1e-5), swish;
    NHWC in and out, computing in ``dtype`` (default: x's)."""

    def __init__(self, cin: int, cout: int, use_bn: bool = True):
        layers = [Conv2d(cin, cout, 1)]
        if use_bn:
            layers.append(BatchNorm2d(cout))
        super().__init__(*layers)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        x = x if dtype is None else x.to(dtype)
        return F.silu(super().forward(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)


def _cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, b], dim=-1)


def _hw(p: torch.Tensor) -> tuple[int, int]:
    return p.shape[1], p.shape[2]


class BiFPNLayer(nn.Module):
    def __init__(self, channels: int = 256, last_pooling: bool = True):
        super().__init__()
        c = channels
        self.last_pooling = last_pooling
        for name in ("convp67", "convp56", "convp45", "convp34"):
            setattr(self, name, ConvBNSwish(2 * c, c, use_bn=False))
        for name in ("out4", "out5", "out6", "out7"):
            setattr(self, name, ConvBNSwish(c, c))

    def forward(self, feats, windows=None, masks=None):
        p3, p4, p5, p6, p7 = feats
        if windows is None:
            p6_mid = self.convp67(_cat(p6, p7))
            p5_mid = self.convp56(_cat(p5, resize_to(p6_mid, p5)))
            p4_mid = self.convp45(_cat(p4, p5))
            p3_out = self.convp34(_cat(p3, resize_to(p4_mid, p3)))
            p4_out = self.out4(p4 + p4_mid + resize_to(avg_pool_3x3_s2(p3_out), p4))
            p5_out = self.out5(p5 + p5_mid + p4_out)
            if self.last_pooling:
                p6_out = self.out6(p6 + p6_mid + resize_to(avg_pool_3x3_s2(p5_out), p6))
            else:
                p6_out = self.out6(p6 + p6_mid + p5_out)
            p7_out = self.out7(p7 + p6_out)
            return [p3_out, p4_out, p5_out, p6_out, p7_out]

        # the resizes' outputs are f32 (promoted); each conv computes in dt
        dt = p3.dtype
        w3, w4, w5, w6, _ = windows
        m3, m4, m5, m6, m7 = masks
        p6_mid = self.convp67(_cat(p6, p7)) * m6
        up65 = batched_window_resize_ac(p6_mid, w6, w5, _hw(p5))
        p5_mid = self.convp56(_cat(p5, up65), dt) * m5
        p4_mid = self.convp45(_cat(p4, p5)) * m4
        up43 = batched_window_resize_ac(p4_mid, w4, w3, _hw(p3))
        p3_out = self.convp34(_cat(p3, up43), dt) * m3
        pool3, pw3 = batched_window_avgpool_s2(p3_out, w3, _hw(p4))
        p4_out = self.out4(p4 + p4_mid + batched_window_resize_ac(pool3, pw3, w4, _hw(p4)),
                           dt) * m4
        p5_out = self.out5(p5 + p5_mid + p4_out) * m5
        if self.last_pooling:
            pool5, pw5 = batched_window_avgpool_s2(p5_out, w5, _hw(p6))
            p6_out = self.out6(
                p6 + p6_mid + batched_window_resize_ac(pool5, pw5, w6, _hw(p6)), dt) * m6
        else:
            p6_out = self.out6(p6 + p6_mid + p5_out) * m6
        p7_out = self.out7(p7 + p6_out) * m7
        return [p3_out, p4_out, p5_out, p6_out, p7_out]


class BiFPN(nn.Module):
    """Lateral 1x1 + BN + swish projections of p3..p7, then ``num_layers``
    BiFPN layers.  ``windows``: optional per-level (N, 4) valid windows,
    the window-exact mode."""

    def __init__(self, in_channels, channels: int = 256, num_layers: int = 3,
                 last_pooling: bool = True):
        super().__init__()
        for level, cin in zip(range(3, 8), in_channels):
            setattr(self, f"inp{level}", ConvBNSwish(cin, channels))
        self.BIFPN_Layers = nn.ModuleList(
            BiFPNLayer(channels, last_pooling) for _ in range(num_layers))

    def forward(self, feats, windows=None):
        masks = None
        if windows is not None:
            masks = [window_mask(_hw(p), w, p.dtype) for p, w in zip(feats, windows)]
        feats = [getattr(self, f"inp{level}")(p) for level, p in zip(range(3, 8), feats)]
        if masks is not None:
            feats = [f * m for f, m in zip(feats, masks)]
        for layer in self.BIFPN_Layers:
            feats = layer(feats, windows=windows, masks=masks)
        return feats
