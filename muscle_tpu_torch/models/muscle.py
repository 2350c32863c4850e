"""MuSCLe core network (port of ``muscle_tpu/models/muscle.py``): the
EfficientNet pyramid, and on it either (mode='enc') CAMs from the
classifier weights and the Pixel Correlation Module (PCM) that refines
them into spatially-guided CAMs (SGC), or (mode='dec') the BiFPN decoder
and the segmentation head.  Tensors are NHWC.

Forward modes of an 'enc' model:

  'logits'     -> (emb, logits)
  'cam'        -> (cams, sgc, emb, logits)   maps upsampled to input H x W
  'cam_lowres' -> (cams, sgc, emb, logits)   maps at the stride-16 grid
  'pix'        -> (cams, sgc)

and of a 'dec' model:

  'seg'        -> (seg_map, dense_ft)        both at input H x W
  'seg_lowres' -> (logits, p3_dec)           at the stride-8 p3 grid
  'vis'        -> (seg_map, p7)

Spatial sharding (``forward(..., stripes=)``, inference in either dtype): the
backbone runs on this rank's stripe of the canvas
(``models/efficientnet.py``); the heads then run whole on every rank.  In
'enc' modes the stride-16 levels p5 and p7 are gathered, and p1 (stride 2)
and p3 (stride 8) are window-resized to the stride-16 grid on their
stripes, the partial resizes summed over the group
(``parallel.spatial.window_resize_ac``), so the large p1 never moves; the
PCM's affinity is global over the stride-16 map.  In 'dec' modes p3..p7
are gathered and the BiFPN and head run whole.

The model computes in its input's dtype (float32, or bfloat16 as the JAX
package's ``dtype=jnp.bfloat16``; ``models/layers.py``).  At bfloat16, as
under jnp's promotion: the CAMs, the SGC and the logits come out in the
promotion of bfloat16 and the classifier kernel's dtype (float32 against
a checkpoint's float32 kernel, bfloat16 against a bf16 model's fresh
kernel, ``classifier_as``); the embedding, the seg maps and the dense
features bfloat16; the window resizes promote to float32 and the next
convolution casts back to bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from muscle_tpu_torch.core.resize import batched_window_resize_ac, resize_bilinear, resize_to
from muscle_tpu_torch.models.bifpn import BiFPN
from muscle_tpu_torch.models.efficientnet import EfficientNet, advance_window, window_mask
from muscle_tpu_torch.models.layers import Conv2d
from muscle_tpu_torch.parallel import spatial

# Per-variant pyramid: (channels p1..p7, block indices p1..p7)
ENC_MODES = ("logits", "cam", "pix", "cam_lowres")
DEC_MODES = ("seg", "seg_lowres", "vis")

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
        """mode: 'enc' (classifier, CAM and PCM heads) or 'dec' (the BiFPN
        decoder with ``bifpn_layers`` layers of ``bifpn_channels``, and the
        segmentation head).  fuse_mbconv: stride-1 MBConv blocks with at
        most this many input channels run through the MBConv kernel in
        inference (0 = none)."""
        super().__init__()
        if backbone_name not in PYRAMID_TABLE:
            raise ValueError(f"no pyramid table for {backbone_name}")
        if mode not in ("enc", "dec"):
            raise ValueError(f"unknown MuSCLe mode {mode!r}: 'enc' or 'dec'")
        self.mode = mode
        self.backbone = EfficientNet(backbone_name, last_pooling=last_pooling,
                                     fuse_max_in_filters=fuse_mbconv)
        channels, self.p_seq = PYRAMID_TABLE[backbone_name]
        p1_ch, _, p3_ch, _, p5_ch, _, p7_ch = channels
        if mode == "enc":
            # PCM embedding projection + bias-free classifier
            self.fuse = Conv2d(p1_ch + p3_ch + p5_ch, 128, 1)
            self.fc = nn.Linear(p7_ch, num_classes, bias=False)
        else:
            self.BIFPN = BiFPN(channels[2:], bifpn_channels, bifpn_layers, last_pooling)
        # defined in both modes by the reference, so checkpoints trained in
        # one mode load in the other
        self.fuse_dec = Conv2d(bifpn_channels, num_classes, 1)

    def trained_parameters(self) -> list[nn.Parameter]:
        """The parameters the mode's network uses, those the JAX package's
        model holds: all but ``fuse_dec`` in 'enc' mode."""
        skip = "fuse_dec." if self.mode == "enc" else None
        return [p for n, p in self.named_parameters() if skip is None or not n.startswith(skip)]

    def _cams(self, p7: torch.Tensor) -> torch.Tensor:
        """Per-class weighted sum of p7 channels by the detached classifier
        weights, rectified, in the promotion of p7's and the kernel's
        dtypes (jnp's ``einsum``)."""
        w = self.fc.weight.detach()
        dt = torch.promote_types(p7.dtype, w.dtype)
        return F.relu(torch.einsum("nhwc,kc->nhwk", p7.to(dt), w.to(dt)))

    def _logits(self, emb: torch.Tensor) -> torch.Tensor:
        """The classifier, in the promotion of emb's and the kernel's dtypes
        (jnp's ``emb @ kernel``)."""
        dt = torch.promote_types(emb.dtype, self.fc.weight.dtype)
        return F.linear(emb.to(dt), self.fc.weight.to(dt))

    def pcm(self, cam: torch.Tensor, f: torch.Tensor, mask: torch.Tensor | None = None
            ) -> torch.Tensor:
        """Pixel Correlation Module.  cam: (N, h, w, C) raw CAMs at p7
        resolution; f: (N, h, w, F) detached fused features; mask: optional
        (N, h, w, 1) valid-feature mask that removes pad pixels from the
        affinity and its normalisation.  Returns the SGC, shaped like cam.
        The affinity computes in f's dtype (the compute dtype) and the SGC
        promotes to cam's (float32)."""
        n, h, w, _ = f.shape
        cam = resize_bilinear(cam, (h, w), align_corners=True)
        f = _conv_nhwc(self.fuse, f).reshape(n, h * w, -1)
        f = f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-5)
        if mask is not None:
            f = f * mask.reshape(n, h * w, 1)
        aff = F.relu(torch.bmm(f, f.transpose(1, 2)))
        aff = aff / (torch.sum(aff, dim=1, keepdim=True) + 1e-5)
        sgc = torch.bmm(aff.transpose(1, 2).to(cam.dtype), cam.reshape(n, h * w, -1))
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
                valid_window: torch.Tensor | None = None,
                generator: torch.Generator | None = None, stripes=None):
        """x: (N, H, W, 3) normalised images.  valid_hw (enc modes): optional
        (N, 2) valid (h, w) inside a padded canvas, masking the GAP and the
        PCM normalisation.  valid_window: optional (N, 4) (oy, ox, h, w) for the
        window-exact canvas mode; supersedes valid_hw.  generator: where the
        backbone's training-mode drop-connect draws.  stripes
        (``parallel.spatial.Stripes``): x is this rank's stripe of the
        canvas (the windows and sizes in canvas rows); the outputs are the
        whole canvas's on every rank."""
        own = ENC_MODES if self.mode == "enc" else DEC_MODES
        if mode not in own:
            if mode in ENC_MODES + DEC_MODES:
                raise ValueError(f"mode {mode!r} needs a model built with mode="
                                 f"{'dec' if self.mode == 'enc' else 'enc'!r}")
            raise ValueError(f"unknown mode {mode!r}")
        _, hh, ww, _ = x.shape
        feats = self.backbone(x, valid_window=valid_window, generator=generator,
                              stripes=stripes)
        if stripes is not None:
            hh *= stripes.size
            strides = self.backbone.block_strides()
            # the levels the heads take whole: dec p3..p7; enc p5 and p7, and
            # p1 and p3 too where no window resize takes them on stripes
            if self.mode == "dec":
                need = self.p_seq[2:]
            else:
                need = self.p_seq[4::2] if valid_window is not None else self.p_seq[::2]
            feats = [stripes.whole(f, hh // strides[i]) if i in need else f
                     for i, f in enumerate(feats)]
        if self.mode == "dec":
            return self._decode([feats[i] for i in self.p_seq[2:]], mode, hh, ww, valid_window)
        p1, _, p3, _, p5, _, p7 = (feats[i] for i in self.p_seq)

        if mode == "logits":
            emb = p7.mean(dim=(1, 2))
            return emb, self._logits(emb)

        cams = self._cams(p7)
        hw7 = (p7.shape[1], p7.shape[2])
        if valid_window is not None:
            # per-stride windows: p1 @ 2, p3 @ 8, p5/p7 @ 16
            w2 = advance_window(valid_window)
            w8 = advance_window(advance_window(w2))
            w16 = advance_window(w8)
            f1 = F.relu(self._window_resize(p1, w2, w16, hw7, hh // 2, stripes))
            f2 = F.relu(self._window_resize(p3, w8, w16, hw7, hh // 8, stripes))
        else:
            f1 = F.relu(resize_to(p1, p7, align_corners=True))
            f2 = F.relu(resize_to(p3, p7, align_corners=True))
        # the window resizes promote to f32; the embedding conv casts back
        fs = torch.cat([f1, f2, F.relu(p5)], dim=-1).detach().to(p7.dtype)
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
            return cams, sgc, emb, self._logits(emb)
        cams = resize_bilinear(cams, (hh, ww), align_corners=True)
        sgc = resize_bilinear(sgc, (hh, ww), align_corners=True)
        if mode == "pix":
            return cams, sgc
        return cams, sgc, emb, self._logits(emb)

    @staticmethod
    def _window_resize(p, src_win, dst_win, hw, rows: int, stripes):
        """``batched_window_resize_ac`` of level ``p`` (``rows`` canvas
        rows), on its stripes where it is split (``spatial.window_resize_ac``)."""
        if stripes is None or p.shape[1] == rows:
            return batched_window_resize_ac(p, src_win, dst_win, hw)
        return spatial.window_resize_ac(p, src_win, dst_win, hw, stripes)

    def _decode(self, feats5, mode: str, hh: int, ww: int, valid_window):
        """BiFPN + segmentation head over p3..p7.  With ``valid_window``
        the BiFPN runs window-exact with per-level windows by stride
        (p3 @ 8, p4/p5 @ 16, p6/p7 @ 32 under last_pooling)."""
        windows = None
        if valid_window is not None:
            windows = []
            w, k_done = valid_window, 0
            for p in feats5:
                k = (hh // p.shape[1]).bit_length() - 1
                while k_done < k:
                    w = advance_window(w)
                    k_done += 1
                windows.append(w)
        p3_dec = self.BIFPN(feats5, windows=windows)[0]
        if mode == "seg_lowres":
            # a 1x1 conv commutes with the bilinear upsample (a linear map
            # and row-stochastic weights), so stride-8 logits resized later
            # equal the reference's resize-then-conv
            return _conv_nhwc(self.fuse_dec, p3_dec), p3_dec
        if valid_window is not None:
            # the p3 window onto the window-size region at the canvas origin
            dst_win = torch.cat([torch.zeros_like(valid_window[:, :2]), valid_window[:, 2:]],
                                dim=-1)
            dense_ft = batched_window_resize_ac(p3_dec, windows[0], dst_win, (hh, ww))
        else:
            dense_ft = resize_bilinear(p3_dec, (hh, ww), align_corners=True)
        seg_map = _conv_nhwc(self.fuse_dec, dense_ft.to(p3_dec.dtype))
        if mode == "vis":
            return seg_map, feats5[-1]
        return seg_map, dense_ft


@torch.no_grad()
def classifier_as(model: MuSCLe, dtype: torch.dtype) -> MuSCLe:
    """An enc model's classifier kernel cast to ``dtype``, the rest left
    float32: the JAX package's ``MuSCLe(dtype=jnp.bfloat16)`` initialises
    its classifier kernel in bfloat16 (its ``_Classifier`` creates the
    kernel in the model's ``dtype``; Flax's ``Dense`` would take a separate
    ``param_dtype``), every other parameter in float32.  A checkpoint's
    ``fc.weight`` then replaces it in its own dtype (``convert.load_into``),
    as the JAX package's loader does.  The parameter object is kept, so an
    optimizer built on it stays valid."""
    if model.mode == "enc":
        model.fc.weight.data = model.fc.weight.data.to(dtype)
    return model


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


@torch.no_grad()
def calibrate_seg_head(model: MuSCLe, images: torch.Tensor, gain: float = 3.0) -> MuSCLe:
    """For a dec model with random weights: rescale the segmentation head
    so that its logits vary over the image.  A random BiFPN's output is
    nearly constant over the pixels (a spread ~0.15x its mean), so the raw
    head gives every pixel one class and a comparison of labels means
    nothing.  Each input channel of ``fuse_dec`` is scaled by ``gain`` over
    its spread on ``images`` (NHWC, normalised) and the bias cancels its
    mean: the logits become centred, with a spread ~``gain``."""
    _, f = model(images, mode="seg_lowres")
    f = f.reshape(-1, f.shape[-1])
    mean, std = f.mean(dim=0), f.std(dim=0)
    w = model.fuse_dec.weight[:, :, 0, 0] * (gain / (std + 1e-6))
    model.fuse_dec.weight.copy_(w[:, :, None, None])
    model.fuse_dec.bias.copy_(-(w @ mean))
    return model
