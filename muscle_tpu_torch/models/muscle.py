"""MuSCLe core network in encoder mode (port of
``muscle_tpu/models/muscle.py``): the EfficientNet pyramid, CAMs from the
classifier weights, and the Pixel Correlation Module (PCM) that refines
them into spatially-guided CAMs (SGC).  Tensors are NHWC.

Forward modes:

  'logits'     -> (emb, logits)
  'cam'        -> (cams, sgc, emb, logits)   maps upsampled to input H x W
  'cam_lowres' -> (cams, sgc, emb, logits)   maps at the stride-16 grid
  'pix'        -> (cams, sgc)

Decoder mode (BiFPN) and the 'seg*'/'vis' modes are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from muscle_tpu_torch.core.resize import batched_window_resize_ac, resize_bilinear, resize_to
from muscle_tpu_torch.models.efficientnet import EfficientNet, advance_window, window_mask

# Per-variant pyramid: (channels p1..p7, block indices p1..p7)
PYRAMID_TABLE = {
    "efficientnet-b1": ((16, 24, 40, 80, 112, 192, 320), (1, 4, 7, 11, 15, 20, 22)),
    "efficientnet-b3": ((24, 32, 48, 96, 136, 232, 384), (1, 4, 7, 12, 17, 23, 25)),
    "efficientnet-b5": ((24, 40, 64, 128, 176, 304, 512), (2, 7, 12, 19, 26, 35, 38)),
    "efficientnet-b7": ((32, 48, 80, 160, 224, 384, 640), (3, 10, 17, 27, 37, 50, 54)),
}


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MuSCLe(nn.Module):
    def __init__(self, num_classes: int = 21, backbone_name: str = "efficientnet-b3",
                 bifpn_layers: int = 3, bifpn_channels: int = 256,
                 last_pooling: bool = True, mode: str = "enc", fuse_mbconv: int = 0):
        """fuse_mbconv: stride-1 MBConv blocks with at most this many input
        channels run through the MBConv kernel in inference (0 = none)."""
        super().__init__()
        if backbone_name not in PYRAMID_TABLE:
            raise ValueError(f"no pyramid table for {backbone_name}")
        if mode != "enc":
            raise NotImplementedError(f"MuSCLe mode {mode!r} (BiFPN decoder) is not ported yet")
        self.mode = mode
        self.backbone = EfficientNet(backbone_name, last_pooling=last_pooling,
                                     fuse_max_in_filters=fuse_mbconv)
        channels, self.p_seq = PYRAMID_TABLE[backbone_name]
        p1_ch, _, p3_ch, _, p5_ch, _, p7_ch = channels
        # PCM embedding projection + bias-free classifier
        self.fuse = nn.Conv2d(p1_ch + p3_ch + p5_ch, 128, 1)
        self.fc = nn.Linear(p7_ch, num_classes, bias=False)
        # defined in both modes by the reference, so checkpoints trained in
        # one mode load in the other
        self.fuse_dec = nn.Conv2d(bifpn_channels, num_classes, 1)

    def _cams(self, p7: torch.Tensor) -> torch.Tensor:
        """Per-class weighted sum of p7 channels by the detached classifier
        weights, rectified."""
        return F.relu(torch.einsum("nhwc,kc->nhwk", p7, self.fc.weight.detach()))

    def pcm(self, cam: torch.Tensor, f: torch.Tensor, mask: torch.Tensor | None = None
            ) -> torch.Tensor:
        """Pixel Correlation Module.  cam: (N, h, w, C) raw CAMs at p7
        resolution; f: (N, h, w, F) detached fused features; mask: optional
        (N, h, w, 1) valid-feature mask that removes pad pixels from the
        affinity and its normalisation.  Returns the SGC, shaped like cam."""
        n, h, w, _ = f.shape
        cam = resize_bilinear(cam, (h, w), align_corners=True)
        f = _conv_nhwc(self.fuse, f).reshape(n, h * w, -1)
        f = f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-5)
        if mask is not None:
            f = f * mask.reshape(n, h * w, 1)
        aff = F.relu(torch.bmm(f, f.transpose(1, 2)))
        aff = aff / (torch.sum(aff, dim=1, keepdim=True) + 1e-5)
        sgc = torch.bmm(aff.transpose(1, 2), cam.reshape(n, h * w, -1))
        return sgc.reshape(n, h, w, -1)

    def _feature_mask(self, p7: torch.Tensor, hh: int, valid_hw: torch.Tensor) -> torch.Tensor:
        """(N, h7, w7, 1) mask of the valid feature window, valid // stride
        (the static-pad floor chain)."""
        _, h7, w7, _ = p7.shape
        eff = valid_hw // (hh // h7)
        rows = torch.arange(h7, device=p7.device)[None, :, None]
        cols = torch.arange(w7, device=p7.device)[None, None, :]
        m = (rows < eff[:, 0:1, None]) & (cols < eff[:, 1:2, None])
        return m[..., None].to(p7.dtype)

    def forward(self, x: torch.Tensor, mode: str = "cam",
                valid_hw: torch.Tensor | None = None,
                valid_window: torch.Tensor | None = None):
        """x: (N, H, W, 3) normalised images.  valid_hw: optional (N, 2)
        valid (h, w) inside a padded canvas, masking the GAP and the PCM
        normalisation.  valid_window: optional (N, 4) (oy, ox, h, w) for the
        window-exact canvas mode; supersedes valid_hw."""
        if mode in ("seg", "vis", "seg_lowres"):
            raise NotImplementedError(f"mode {mode!r} (BiFPN decoder) is not ported yet")
        if mode not in ("logits", "cam", "pix", "cam_lowres"):
            raise ValueError(f"unknown mode {mode!r}")
        _, hh, ww, _ = x.shape
        feats = self.backbone(x, valid_window=valid_window)
        p1, _, p3, _, p5, _, p7 = (feats[i] for i in self.p_seq)

        if mode == "logits":
            emb = p7.mean(dim=(1, 2))
            return emb, self.fc(emb)

        cams = self._cams(p7)
        hw7 = (p7.shape[1], p7.shape[2])
        if valid_window is not None:
            # per-stride windows: p1 @ 2, p3 @ 8, p5/p7 @ 16
            w2 = advance_window(valid_window)
            w8 = advance_window(advance_window(w2))
            w16 = advance_window(w8)
            f1 = F.relu(batched_window_resize_ac(p1, w2, w16, hw7))
            f2 = F.relu(batched_window_resize_ac(p3, w8, w16, hw7))
        else:
            f1 = F.relu(resize_to(p1, p7, align_corners=True))
            f2 = F.relu(resize_to(p3, p7, align_corners=True))
        fs = torch.cat([f1, f2, F.relu(p5)], dim=-1).detach()
        if valid_window is not None or valid_hw is not None:
            if valid_window is not None:
                m = window_mask(hw7, w16, p7.dtype)
            else:
                m = self._feature_mask(p7, hh, valid_hw)
            sgc = self.pcm(cams, fs, mask=m)
            emb = torch.sum(p7 * m, dim=(1, 2)) / torch.sum(m, dim=(1, 2))
        else:
            sgc = self.pcm(cams, fs)
            emb = p7.mean(dim=(1, 2))
        if mode == "cam_lowres":
            return cams, sgc, emb, self.fc(emb)
        cams = resize_bilinear(cams, (hh, ww), align_corners=True)
        sgc = resize_bilinear(sgc, (hh, ww), align_corners=True)
        if mode == "pix":
            return cams, sgc
        return cams, sgc, emb, self.fc(emb)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init: truncated lecun-normal conv and linear kernels
    (the JAX package's initialiser), zero biases, and batch norms near the
    identity with random scale, shift and statistics, so a random b3 keeps
    O(1) activations to its last block (identity norms let them decay to
    ~1e-7, where the CAM fusion's min-max normalisation degenerates)."""
    def uniform(n, lo, hi):
        return torch.rand(n, generator=generator) * (hi - lo) + lo

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            n = m.num_features
            m.weight.copy_(uniform(n, 0.75, 1.25))
            m.bias.copy_(uniform(n, -0.1, 0.1))
            m.running_mean.copy_(uniform(n, -0.2, 0.2))
            m.running_var.copy_(uniform(n, 0.5, 1.0))
    return model
