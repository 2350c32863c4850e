"""Plain PyTorch MuSCLe in float32: the EfficientNet backbone (Tan & Le,
arXiv:1905.11946, with the reference's static stride-2 pads), the CAM and
PCM heads of 'enc' mode and the BiFPN decoder and segmentation head of
'dec' mode (SCoulY/MuSCLe).  NHWC across modules; state-dict keys are the
reference's (``_conv_stem``, ``_blocks.{i}._expand_conv``, ``BIFPN_Layers``
...), so one set of weights loads into the reference and the program.

Only what the benchmark's cells run: inference in 'cam_lowres' (enc) and
'seg_lowres' (dec) on window-exact canvases, and training step A's 'cam'
forward in train mode with drop-connect, on one process or as this
rank's rows of a global batch (``set_group``: batch statistics and
drop-connect draws of the global batch, over ``torch.distributed``).  No
kernel, no cache, no lower precision.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch import nn

from benchmark.reference.resize import (
    avg_pool_3x3_s2,
    resize_bilinear,
    window_avgpool_s2,
    window_resize_ac,
)


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    kernel_size: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    stride: int


# EfficientNet-b0's stages: (kernel, repeats, in, out, expand, stride)
_STAGES = ((3, 1, 32, 16, 1, 1), (3, 2, 16, 24, 6, 2), (5, 2, 24, 40, 6, 2),
           (3, 3, 40, 80, 6, 2), (5, 3, 80, 112, 6, 1), (5, 4, 112, 192, 6, 2),
           (3, 1, 192, 320, 6, 1))
# compound scaling: width, depth
SCALING = {"efficientnet-b0": (1.0, 1.0), "efficientnet-b1": (1.0, 1.1),
           "efficientnet-b2": (1.1, 1.2), "efficientnet-b3": (1.2, 1.4),
           "efficientnet-b5": (1.6, 2.2), "efficientnet-b7": (2.0, 3.1)}
# pyramid of each backbone: (channels p1..p7, block indices p1..p7)
PYRAMID = {
    "efficientnet-b1": ((16, 24, 40, 80, 112, 192, 320), (1, 4, 7, 11, 15, 20, 22)),
    "efficientnet-b3": ((24, 32, 48, 96, 136, 232, 384), (1, 4, 7, 12, 17, 23, 25)),
    "efficientnet-b7": ((32, 48, 80, 160, 224, 384, 640), (3, 10, 17, 27, 37, 50, 54)),
}
BN_EPS, BN_MOMENTUM = 1e-3, 0.01
DROP_CONNECT = 0.2


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * filters else new)


def blocks_of(name: str, last_pooling: bool) -> list[BlockArgs]:
    """One BlockArgs per block, stages flattened; stage 6's stride is 1
    without ``last_pooling``."""
    width, depth = SCALING[name]
    out = []
    for i, (k, rep, cin, cout, e, s) in enumerate(_STAGES):
        s = 1 if i == 5 and not last_pooling else s
        cin, cout = round_filters(cin, width), round_filters(cout, width)
        out.append(BlockArgs(k, cin, cout, e, s))
        out += [BlockArgs(k, cout, cout, e, 1)] * (int(math.ceil(depth * rep)) - 1)
    return out


def static_pad(k: int) -> tuple[int, int]:
    """The reference's stride-2 pad (low, high) of a k x k conv."""
    return (k - 2) // 2, k - 2 - (k - 2) // 2


def window_mask(hw, win: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1) float indicator of the windows (N, 4) (oy, ox, h, w)."""
    rows = torch.arange(hw[0], device=win.device)[None, :, None]
    cols = torch.arange(hw[1], device=win.device)[None, None, :]
    m = ((rows >= win[:, 0, None, None]) & (rows < win[:, 0, None, None] + win[:, 2, None, None])
         & (cols >= win[:, 1, None, None]) & (cols < win[:, 1, None, None] + win[:, 3, None, None]))
    return m[..., None].to(torch.float32)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, with gradient."""
    return t if group is None else dist_fn.all_reduce(t, group=group)


def set_group(model: nn.Module, group) -> None:
    """Make ``model``'s train-mode batch statistics and drop-connect draws
    those of the global batch over ``group`` (None: this process's)."""
    for m in model.modules():
        if isinstance(m, (BatchNorm2d, MBConvBlock)):
            m.group = group


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm with Flax's train-mode update: the running variance takes
    the biased batch variance.  Eval mode normalises by the running
    statistics.  With a ``group`` the statistics are the global batch's."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        g = self.group
        n = x.numel() // x.shape[1] * (1 if g is None else dist.get_world_size(g))
        mean = _global_sum(x.sum(dim=(0, 2, 3)), g) / n
        var = _global_sum(torch.square(x - mean[:, None, None]).sum(dim=(0, 2, 3)), g) / n
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            m = self.momentum
            self.num_batches_tracked.add_(1)
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
        return y


def _bn(c: int, eps: float = BN_EPS, momentum: float = BN_MOMENTUM) -> BatchNorm2d:
    return BatchNorm2d(c, eps=eps, momentum=momentum)


class MBConvBlock(nn.Module):
    """expand 1x1 -> BN -> swish -> depthwise -> BN -> swish -> SE ->
    project 1x1 -> BN (+ identity, with drop-connect in training: with a
    ``group``, this rank's rows of the global batch's draw)."""

    group = None

    def __init__(self, a: BlockArgs):
        super().__init__()
        self.a = a
        cin, mid = a.input_filters, a.input_filters * a.expand_ratio
        if a.expand_ratio != 1:
            self._expand_conv = nn.Conv2d(cin, mid, 1, bias=False)
            self._bn0 = _bn(mid)
        pad = a.kernel_size // 2 if a.stride == 1 else 0
        self._depthwise_conv = nn.Conv2d(mid, mid, a.kernel_size, stride=a.stride, groups=mid,
                                         bias=False, padding=pad)
        self._bn1 = _bn(mid)
        sq = max(1, int(cin * 0.25))
        self._se_reduce = nn.Conv2d(mid, sq, 1)
        self._se_expand = nn.Conv2d(sq, mid, 1)
        self._project_conv = nn.Conv2d(mid, a.output_filters, 1, bias=False)
        self._bn2 = _bn(a.output_filters)

    def forward(self, x, rate: float, mask_in, mask_out, count, generator):
        a = self.a
        h = _nchw(x)
        if a.expand_ratio != 1:
            h = F.silu(self._bn0(self._expand_conv(h)))
            if mask_in is not None:
                h = h * _nchw(mask_in)
        if a.stride != 1:
            lo, hi = static_pad(a.kernel_size)
            h = F.pad(h, (lo, hi, lo, hi))
        h = F.silu(self._bn1(self._depthwise_conv(h)))
        if mask_out is not None:
            h = h * _nchw(mask_out)
        se = (h.mean(dim=(2, 3), keepdim=True) if count is None
              else h.sum(dim=(2, 3), keepdim=True) / _nchw(count))
        h = torch.sigmoid(self._se_expand(F.silu(self._se_reduce(se)))) * h
        h = self._bn2(self._project_conv(h))
        if mask_out is not None:
            h = h * _nchw(mask_out)
        out = _nhwc(h)
        if a.stride == 1 and a.input_filters == a.output_filters:
            if self.training and rate > 0.0:
                keep, b = 1.0 - rate, out.shape[0]
                w = 1 if self.group is None else dist.get_world_size(self.group)
                r = 0 if self.group is None else dist.get_rank(self.group)
                u = torch.rand((b * w, 1, 1, 1), generator=generator, dtype=out.dtype,
                               device=out.device)[r * b:(r + 1) * b]
                out = out / keep * torch.floor(keep + u)
            out = out + x
        return out


class EfficientNet(nn.Module):
    def __init__(self, name: str, last_pooling: bool):
        super().__init__()
        self.args = blocks_of(name, last_pooling)
        stem = round_filters(32, SCALING[name][0])
        self._conv_stem = nn.Conv2d(3, stem, 3, stride=2, bias=False)
        self._bn0 = _bn(stem)
        self._blocks = nn.ModuleList(MBConvBlock(a) for a in self.args)

    def forward(self, x, valid_window=None, generator=None) -> list[torch.Tensor]:
        """Every block's output; with ``valid_window`` (N, 4) the features
        outside each image's window are zeroed after every BN and the SE
        pools over the window, so a padded canvas computes the unpadded
        image's forward."""
        lo, hi = static_pad(3)
        x = _nhwc(F.silu(self._bn0(self._conv_stem(F.pad(_nchw(x), (lo, hi, lo, hi))))))
        win = mask = count = None
        if valid_window is not None:
            win = valid_window // 2
            mask = window_mask(x.shape[1:3], win)
            count = (win[:, 2] * win[:, 3]).to(torch.float32)[:, None, None, None]
            x = x * mask
        out, n = [], len(self.args)
        for i, (a, block) in enumerate(zip(self.args, self._blocks)):
            mask_in = mask
            if win is not None and a.stride == 2:
                win = win // 2
                mask = window_mask(((x.shape[1] + 1) // 2, (x.shape[2] + 1) // 2), win)
                count = (win[:, 2] * win[:, 3]).to(torch.float32)[:, None, None, None]
            x = block(x, DROP_CONNECT * i / n, mask_in, mask, count, generator)
            out.append(x)
        return out


class ConvBNSwish(nn.Sequential):
    """1x1 conv with bias, optional BN (eps 1e-5, momentum 0.1), swish."""

    def __init__(self, cin: int, cout: int, use_bn: bool = True):
        layers = [nn.Conv2d(cin, cout, 1)]
        if use_bn:
            layers.append(_bn(cout, 1e-5, 0.1))
        super().__init__(*layers)

    def forward(self, x):
        return _nhwc(F.silu(super().forward(_nchw(x))))


def _hw(p):
    return p.shape[1], p.shape[2]


def _resize_to(x, like):
    return resize_bilinear(x, _hw(like), align_corners=True)


class BiFPNLayer(nn.Module):
    """One BiFPN layer with the reference's topology (p4_mid takes p5)."""

    def __init__(self, c: int, last_pooling: bool):
        super().__init__()
        self.last_pooling = last_pooling
        for n in ("convp67", "convp56", "convp45", "convp34"):
            setattr(self, n, ConvBNSwish(2 * c, c, use_bn=False))
        for n in ("out4", "out5", "out6", "out7"):
            setattr(self, n, ConvBNSwish(c, c))

    def forward(self, feats, windows=None, masks=None):
        p3, p4, p5, p6, p7 = feats
        cat = lambda a, b: torch.cat([a, b], dim=-1)  # noqa: E731
        if windows is None:
            p6m = self.convp67(cat(p6, p7))
            p5m = self.convp56(cat(p5, _resize_to(p6m, p5)))
            p4m = self.convp45(cat(p4, p5))
            p3o = self.convp34(cat(p3, _resize_to(p4m, p3)))
            p4o = self.out4(p4 + p4m + _resize_to(avg_pool_3x3_s2(p3o), p4))
            p5o = self.out5(p5 + p5m + p4o)
            six = _resize_to(avg_pool_3x3_s2(p5o), p6) if self.last_pooling else p5o
            p6o = self.out6(p6 + p6m + six)
            return [p3o, p4o, p5o, p6o, self.out7(p7 + p6o)]
        w3, w4, w5, w6, _ = windows
        m3, m4, m5, m6, m7 = masks
        p6m = self.convp67(cat(p6, p7)) * m6
        p5m = self.convp56(cat(p5, window_resize_ac(p6m, w6, w5, _hw(p5)))) * m5
        p4m = self.convp45(cat(p4, p5)) * m4
        p3o = self.convp34(cat(p3, window_resize_ac(p4m, w4, w3, _hw(p3)))) * m3
        pool3, pw3 = window_avgpool_s2(p3o, w3, _hw(p4))
        p4o = self.out4(p4 + p4m + window_resize_ac(pool3, pw3, w4, _hw(p4))) * m4
        p5o = self.out5(p5 + p5m + p4o) * m5
        if self.last_pooling:
            pool5, pw5 = window_avgpool_s2(p5o, w5, _hw(p6))
            p6o = self.out6(p6 + p6m + window_resize_ac(pool5, pw5, w6, _hw(p6))) * m6
        else:
            p6o = self.out6(p6 + p6m + p5o) * m6
        return [p3o, p4o, p5o, p6o, self.out7(p7 + p6o) * m7]


class BiFPN(nn.Module):
    def __init__(self, in_channels, c: int, layers: int, last_pooling: bool):
        super().__init__()
        for level, cin in zip(range(3, 8), in_channels):
            setattr(self, f"inp{level}", ConvBNSwish(cin, c))
        self.BIFPN_Layers = nn.ModuleList(BiFPNLayer(c, last_pooling) for _ in range(layers))

    def forward(self, feats, windows=None):
        masks = None if windows is None else [window_mask(_hw(p), w)
                                              for p, w in zip(feats, windows)]
        feats = [getattr(self, f"inp{lv}")(p) for lv, p in zip(range(3, 8), feats)]
        if masks is not None:
            feats = [f * m for f, m in zip(feats, masks)]
        for layer in self.BIFPN_Layers:
            feats = layer(feats, windows, masks)
        return feats


class MuSCLe(nn.Module):
    """MuSCLe: 'enc' (classifier, CAMs, PCM) or 'dec' (BiFPN + seg head)."""

    def __init__(self, num_classes: int = 21, backbone: str = "efficientnet-b3",
                 bifpn_layers: int = 3, bifpn_channels: int = 256, last_pooling: bool = True,
                 mode: str = "enc"):
        super().__init__()
        self.mode = mode
        self.backbone = EfficientNet(backbone, last_pooling)
        ch, self.p_seq = PYRAMID[backbone]
        if mode == "enc":
            self.fuse = nn.Conv2d(ch[0] + ch[2] + ch[4], 128, 1)
            self.fc = nn.Linear(ch[6], num_classes, bias=False)
        else:
            self.BIFPN = BiFPN(ch[2:], bifpn_channels, bifpn_layers, last_pooling)
        self.fuse_dec = nn.Conv2d(bifpn_channels, num_classes, 1)

    def trained_parameters(self) -> list[tuple[str, nn.Parameter]]:
        """(name, parameter) of what the mode's network trains: all but
        ``fuse_dec`` in 'enc' mode."""
        return [(n, p) for n, p in self.named_parameters()
                if self.mode != "enc" or not n.startswith("fuse_dec.")]

    def pcm(self, cam, f, mask=None):
        n, h, w, _ = f.shape
        cam = resize_bilinear(cam, (h, w), align_corners=True)
        f = _nhwc(self.fuse(_nchw(f))).reshape(n, h * w, -1)
        f = f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-5)
        if mask is not None:
            f = f * mask.reshape(n, h * w, 1)
        aff = F.relu(torch.bmm(f, f.transpose(1, 2)))
        aff = aff / (torch.sum(aff, dim=1, keepdim=True) + 1e-5)
        return torch.bmm(aff.transpose(1, 2), cam.reshape(n, h * w, -1)).reshape(n, h, w, -1)

    def forward(self, x, mode: str = "cam", valid_window=None, generator=None):
        """'cam' -> (cams, sgc, emb, logits) at the input size; 'cam_lowres'
        -> the same at the stride-16 grid; 'seg_lowres' -> (stride-8
        logits, p3 features)."""
        hh, ww = x.shape[1:3]
        feats = self.backbone(x, valid_window=valid_window, generator=generator)
        if self.mode == "dec":
            return self._decode([feats[i] for i in self.p_seq[2:]], hh, valid_window)
        p1, _, p3, _, p5, _, p7 = (feats[i] for i in self.p_seq)
        cams = F.relu(torch.einsum("nhwc,kc->nhwk", p7, self.fc.weight.detach()))
        hw7 = _hw(p7)
        if valid_window is not None:
            w2 = valid_window // 2
            w8 = w2 // 4
            w16 = w8 // 2
            f1 = F.relu(window_resize_ac(p1, w2, w16, hw7))
            f2 = F.relu(window_resize_ac(p3, w8, w16, hw7))
        else:
            f1 = F.relu(resize_bilinear(p1, hw7, align_corners=True))
            f2 = F.relu(resize_bilinear(p3, hw7, align_corners=True))
        fs = torch.cat([f1, f2, F.relu(p5)], dim=-1).detach()
        if valid_window is not None:
            m = window_mask(hw7, w16)
            sgc = self.pcm(cams, fs, mask=m)
            emb = torch.sum(p7 * m, dim=(1, 2)) / torch.sum(m, dim=(1, 2))
        else:
            sgc = self.pcm(cams, fs)
            emb = p7.mean(dim=(1, 2))
        logits = F.linear(emb, self.fc.weight)
        if mode == "cam_lowres":
            return cams, sgc, emb, logits
        cams = resize_bilinear(cams, (hh, ww), align_corners=True)
        sgc = resize_bilinear(sgc, (hh, ww), align_corners=True)
        return cams, sgc, emb, logits

    def _decode(self, feats5, hh: int, valid_window):
        windows = None
        if valid_window is not None:
            windows, w, done = [], valid_window, 0
            for p in feats5:
                k = (hh // p.shape[1]).bit_length() - 1
                while done < k:
                    w, done = w // 2, done + 1
                windows.append(w)
        p3 = self.BIFPN(feats5, windows=windows)[0]
        return _nhwc(self.fuse_dec(_nchw(p3))), p3
