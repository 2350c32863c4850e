"""Resizes of the plain reference, float32 only: bilinear under both corner
conventions, PIL's antialiased bicubic, window resizes and window pools,
each as a pair of 1-D weight matrices applied as two contractions.

A frozen copy of the arithmetic the MuSCLe pipeline specifies (PyTorch's
``F.interpolate`` corners, PIL's BICUBIC, the window-exact canvas forms),
kept apart from the program so that a change there cannot move it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=256)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic bilinear interpolation matrix."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = np.zeros((1,)) if out_size == 1 else dst * (in_size - 1) / (out_size - 1)
    else:
        src = np.clip((dst + 0.5) * in_size / out_size - 0.5, 0.0, in_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 2)
    frac = src - lo
    w[np.arange(out_size), lo] = 1.0 - frac
    w[np.arange(out_size), lo + 1] = frac
    return w


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of the spatial axes of NHWC ``x`` (``F.interpolate``'s
    semantics under the given corner convention)."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    wh = torch.from_numpy(_interp_matrix(h, oh, align_corners)).to(x.device)
    ww = torch.from_numpy(_interp_matrix(w, ow, align_corners)).to(x.device)
    x = torch.einsum("Ih,nhwc->nIwc", wh, x)
    return torch.einsum("Jw,nIwc->nIJc", ww, x)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(torch.float32)


def _lead(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)[..., None, None]
    return float(v)


def _normalise_rows(w: torch.Tensor) -> torch.Tensor:
    denom = torch.sum(w, dim=-1, keepdim=True)
    return w / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def _cubic(t: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    """Keys cubic convolution kernel (a = -0.5, PIL's BICUBIC)."""
    at = torch.abs(t)
    at2, at3 = at * at, at * at * at
    w1 = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
    w2 = a * (at3 - 5.0 * at2 + 8.0 * at - 4.0)
    return torch.where(at <= 1.0, w1, torch.where(at < 2.0, w2, torch.zeros_like(at)))


def cubic_weights(src_len, dst_len, src_cap: int, dst_cap: int, flip: bool = False,
                  dst_off=0.0) -> torch.Tensor:
    """(..., dst_cap, src_cap) PIL-bicubic weights (antialiased: the support
    widened by the downscale factor, rows renormalised) for src_len ->
    dst_len inside fixed canvases, the output at [dst_off, dst_off +
    dst_len); ``flip`` samples the source right to left."""
    device = src_len.device
    src = _f32(src_len, device)[..., None, None]
    dst = _f32(dst_len, device)[..., None, None]
    off = _lead(dst_off, device)
    i0 = torch.arange(dst_cap, dtype=torch.float32, device=device)[:, None] - off
    i = dst - 1.0 - i0 if flip else i0
    y = torch.arange(src_cap, dtype=torch.float32, device=device)[None, :]
    center = (i + 0.5) * src / dst - 0.5
    w = _cubic((y - center) / torch.clamp(src / dst, min=1.0))
    zero = torch.zeros((), device=device)
    w = torch.where(y < src, w, zero)
    w = torch.where((i0 >= 0.0) & (i0 < dst), w, zero)
    return _normalise_rows(w)


def bilinear_weights(src_len, dst_len, src_cap: int, dst_cap: int, align_corners: bool,
                     flip: bool = False, src_off=0.0, dst_off=0.0) -> torch.Tensor:
    """(..., dst_cap, src_cap) bilinear weights for src_len -> dst_len
    between windows at ``src_off`` / ``dst_off`` of fixed canvases."""
    device = src_len.device
    src = _f32(src_len, device)[..., None, None]
    dst = _f32(dst_len, device)[..., None, None]
    soff, doff = _lead(src_off, device), _lead(dst_off, device)
    i0 = torch.arange(dst_cap, dtype=torch.float32, device=device)[:, None] - doff
    i = dst - 1.0 - i0 if flip else i0
    y = torch.arange(src_cap, dtype=torch.float32, device=device)[None, :] - soff
    if align_corners:
        center = i * (src - 1.0) / torch.clamp(dst - 1.0, min=1.0)
    else:
        center = (i + 0.5) * src / dst - 0.5
    w = torch.clamp(1.0 - torch.abs(y - center), min=0.0)
    zero = torch.zeros((), device=device)
    w = torch.where((y >= 0.0) & (y < src), w, zero)
    w = torch.where((i0 >= 0.0) & (i0 < dst), w, zero)
    return _normalise_rows(w)


def cam_resize_weights(map_len, mid_len, dst_len, map_cap: int, mid_cap: int, dst_cap: int,
                       flip: bool = False) -> torch.Tensor:
    """The CAM resample chain as one matrix: the stride-16 map to the input
    size (align_corners=True), then to the original size (half-pixel)."""
    w1 = bilinear_weights(map_len, mid_len, map_cap, mid_cap, align_corners=True)
    w2 = bilinear_weights(mid_len, dst_len, mid_cap, dst_cap, align_corners=False, flip=flip)
    return w2 @ w1


def window_resize_ac(src: torch.Tensor, src_win: torch.Tensor, dst_win: torch.Tensor,
                     dst_hw) -> torch.Tensor:
    """Per-image align_corners=True resize of the window ``src_win`` (N, 4)
    (oy, ox, h, w) of NHWC ``src`` onto the window ``dst_win`` of a
    ``dst_hw`` canvas, zero elsewhere."""
    hs, ws = src.shape[1:3]
    hd, wd = dst_hw
    wh = bilinear_weights(src_win[:, 2], dst_win[:, 2], hs, hd, True,
                          src_off=src_win[:, 0], dst_off=dst_win[:, 0])
    ww = bilinear_weights(src_win[:, 3], dst_win[:, 3], ws, wd, True,
                          src_off=src_win[:, 1], dst_off=dst_win[:, 1])
    a = torch.einsum("nIy,nyxc->nIxc", wh, src)
    return torch.einsum("nJx,nIxc->nIJc", ww, a)


def _pool_weights(src_len, src_cap: int, dst_cap: int, src_off) -> torch.Tensor:
    """One axis of avg_pool(3, stride 2, pad 1, zero pads counted) over the
    window [src_off, src_off + src_len), written at the origin."""
    device = src_len.device
    src = src_len.to(torch.int64)[..., None, None]
    off = src_off.to(torch.int64)[..., None, None]
    i = torch.arange(dst_cap, device=device)[:, None]
    y = torch.arange(src_cap, device=device)[None, :] - off
    w = (y >= 2 * i - 1) & (y <= 2 * i + 1) & (y >= 0) & (y < src) & (i < (src + 1) // 2)
    return w.to(torch.float32) / 3.0


def window_avgpool_s2(src: torch.Tensor, src_win: torch.Tensor, dst_hw):
    """Per-image 3x3 / stride-2 average pool of the windows ``src_win`` of
    ``src`` onto a ``dst_hw`` canvas at the origin: (pooled, its windows)."""
    hs, ws = src.shape[1:3]
    hd, wd = dst_hw
    wh = _pool_weights(src_win[:, 2], hs, hd, src_win[:, 0])
    ww = _pool_weights(src_win[:, 3], ws, wd, src_win[:, 1])
    pooled = torch.einsum("nJx,nIxc->nIJc", ww, torch.einsum("nIy,nyxc->nIxc", wh, src))
    zero = torch.zeros_like(src_win[:, 0])
    return pooled, torch.stack([zero, zero, (src_win[:, 2] + 1) // 2,
                                (src_win[:, 3] + 1) // 2], dim=-1)


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-2 / pad-1 average pool of NHWC ``x``, zero pads counted."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1, count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def window_sample(fm: torch.Tensor, src_box: torch.Tensor, out_hw, dst_hw: torch.Tensor,
                  align_corners: bool, flip_x: bool = False) -> torch.Tensor:
    """Bilinear sampling of each image's source window ``src_box`` (B, 4)
    (row, col, h, w) of ``fm`` (B, H, W, C) onto an ``out_hw`` grid whose
    valid part is ``dst_hw`` (B, 2); ``flip_x`` samples right to left."""
    b, hh, ww, c = fm.shape
    oh, ow = out_hw
    dev = fm.device
    box = _f32(src_box, dev)
    d = _f32(dst_hw, dev)

    def coords(start, size, dst, out_size, limit, flip):
        i = torch.arange(out_size, dtype=torch.float32, device=dev)[None]
        if flip:
            i = dst - 1.0 - i
        if align_corners:
            src = start + i * (size - 1.0) / torch.clamp(dst - 1.0, min=1.0)
        else:
            src = start + (i + 0.5) * size / dst - 0.5
        src = torch.minimum(torch.maximum(src, start), start + size - 1.0)
        return src.clamp(0.0, limit - 1.0)

    ys = coords(box[:, 0:1], box[:, 2:3], d[:, 0:1], oh, hh, False)
    xs = coords(box[:, 1:2], box[:, 3:4], d[:, 1:2], ow, ww, flip_x)
    ylo = torch.clamp(torch.floor(ys).long(), 0, hh - 2)
    fy = (ys - ylo)[:, :, None, None]
    idx = ylo[:, :, None, None].expand(b, oh, ww, c)
    out = torch.gather(fm, 1, idx) * (1 - fy) + torch.gather(fm, 1, idx + 1) * fy
    xlo = torch.clamp(torch.floor(xs).long(), 0, ww - 2)
    fx = (xs - xlo)[:, None, :, None]
    idx = xlo[:, None, :, None].expand(b, oh, ow, c)
    return torch.gather(out, 2, idx) * (1 - fx) + torch.gather(out, 2, idx + 1) * fx
