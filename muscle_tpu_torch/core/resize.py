"""Bilinear and PIL-bicubic resizes as matrix products, with PyTorch's
corner semantics (port of ``muscle_tpu/core/resize.py``).

The reference model resizes with ``F.interpolate`` under both corner
conventions (align_corners=True inside the model, half-pixel elsewhere),
and its TTA datasets resize with PIL's antialiased BICUBIC.  Every resize
here is a pair of 1-D weight matrices applied as two contractions:

    out[n, I, J, c] = W_h[I, h] * x[n, h, w, c] * W_w[J, w]

The ``dynamic_*`` builders take lengths as tensors (any leading batch
shape) so one call yields the per-image matrices of a whole batch.  Sizes
are carried in float32, as on the device in the JAX package.

Dtypes follow the JAX package's: ``resize_bilinear`` takes its matrices
in x's dtype (a bfloat16 map resizes in bfloat16) and ``avg_pool_3x3_s2``
sums in x's dtype, while the window resizes and pools build float32
weights, so a bfloat16 source promotes to float32 there, as jnp promotes
it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic bilinear interpolation matrix."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), dtype=np.float64)
        else:
            src = dst * (in_size - 1) / (out_size - 1)
    else:
        src = (dst + 0.5) * in_size / out_size - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 2)
    frac = src - lo
    w[np.arange(out_size), lo] = 1.0 - frac
    w[np.arange(out_size), lo + 1] = frac
    return w


@functools.lru_cache(maxsize=256)
def _interp_tensor(in_size: int, out_size: int, align_corners: bool,
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``_interp_matrix`` in ``dtype`` on ``device``, made there once.  Made
    outside inference mode even when first asked for inside it: an
    inference tensor in the cache could not take part in a later autograd
    graph (the training step after an epoch-end eval)."""
    with torch.inference_mode(False):
        m = torch.from_numpy(_interp_matrix(in_size, out_size, align_corners))
        return m.to(device=device, dtype=dtype)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinearly resize the two spatial axes of an NHWC (or HWC/HW)
    tensor; equals ``F.interpolate(mode='bilinear')`` under the requested
    corner convention.  Computes in x's dtype, the matrices rounded to it
    (the JAX package's bf16 resize)."""
    squeeze_batch = squeeze_channel = False
    if x.ndim == 2:
        x = x[None, :, :, None]
        squeeze_batch = squeeze_channel = True
    elif x.ndim == 3:
        x = x[None]
        squeeze_batch = True
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (h, w) != (oh, ow):
        wh = _interp_tensor(h, oh, align_corners, x.device, x.dtype)
        ww = _interp_tensor(w, ow, align_corners, x.device, x.dtype)
        x = torch.einsum("Ih,nhwc->nIwc", wh, x)
        x = torch.einsum("Jw,nIwc->nIJc", ww, x)
    if squeeze_channel:
        x = x[..., 0]
    if squeeze_batch:
        x = x[0]
    return x


def resize_to(x: torch.Tensor, like: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """Resize ``x`` to the spatial shape of ``like`` (both NHWC)."""
    return resize_bilinear(x, (like.shape[1], like.shape[2]), align_corners)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(torch.float32)


def _lead(v, device):
    """A length or offset as f32 with two trailing axes for broadcasting
    against a (rows, cols) grid.  A Python number stays a number: making
    it a device tensor would be a host-to-device copy on every call."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)[..., None, None]
    return float(v)


def dynamic_window_resize(
    fm: torch.Tensor,
    src_box: torch.Tensor,
    out_hw: tuple[int, int],
    dst_hw: torch.Tensor | None = None,
    align_corners: bool = True,
    flip_x: bool = False,
) -> torch.Tensor:
    """Bilinearly sample a per-image source window onto a fixed output grid.

    fm: (H, W, C) or (B, H, W, C); src_box: (4,) or (B, 4) int (row, col,
    h, w); dst_hw: optional (2,) or (B, 2) valid size inside the output
    grid (pixels beyond it are clamped values the caller masks).
    align_corners=False is the half-pixel (cv2/PIL) convention; flip_x
    samples the window right-to-left (the TTA un-flip)."""
    single = fm.ndim == 3
    if single:
        fm = fm[None]
        src_box = src_box[None]
        dst_hw = None if dst_hw is None else dst_hw[None]
    b, hh, ww, c = fm.shape
    oh, ow = out_hw
    dev = fm.device
    box = _f32(src_box, dev)
    r, col, h, w = box[:, 0:1], box[:, 1:2], box[:, 2:3], box[:, 3:4]
    if dst_hw is None:
        dh = torch.full((b, 1), float(oh), device=dev)
        dw = torch.full((b, 1), float(ow), device=dev)
    else:
        d = _f32(dst_hw, dev)
        dh, dw = d[:, 0:1], d[:, 1:2]

    def coords(start, size, dst, out_size, limit, flip):
        i = torch.arange(out_size, dtype=torch.float32, device=dev)[None]
        if flip:
            i = dst - 1.0 - i
        if align_corners:
            scale = (size - 1.0) / torch.clamp(dst - 1.0, min=1.0)
            src = start + i * scale
        else:
            src = start + (i + 0.5) * size / dst - 0.5
        src = torch.minimum(torch.maximum(src, start), start + size - 1.0)
        return src.clamp(0.0, limit - 1.0)

    ys = coords(r, h, dh, oh, hh, False)  # (B, oh)
    xs = coords(col, w, dw, ow, ww, flip_x)  # (B, ow)

    ylo = torch.clamp(torch.floor(ys).long(), 0, hh - 2)
    fy = (ys - ylo)[:, :, None, None]
    idx = ylo[:, :, None, None].expand(b, oh, ww, c)
    out = torch.gather(fm, 1, idx) * (1 - fy) + torch.gather(fm, 1, idx + 1) * fy
    xlo = torch.clamp(torch.floor(xs).long(), 0, ww - 2)
    fx = (xs - xlo)[:, None, :, None]
    idx = xlo[:, None, :, None].expand(b, oh, ow, c)
    out = torch.gather(out, 2, idx) * (1 - fx) + torch.gather(out, 2, idx + 1) * fx
    return out[0] if single else out


def _cubic_kernel(t: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    """Keys cubic convolution kernel (a=-0.5, what PIL's BICUBIC uses)."""
    at = torch.abs(t)
    at2 = at * at
    at3 = at2 * at
    w1 = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
    w2 = a * (at3 - 5.0 * at2 + 8.0 * at - 4.0)
    return torch.where(at <= 1.0, w1, torch.where(at < 2.0, w2, torch.zeros_like(at)))


def _normalise_rows(w: torch.Tensor) -> torch.Tensor:
    denom = torch.sum(w, dim=-1, keepdim=True)
    return w / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def dynamic_cubic_resize_weights(
    src_len, dst_len, src_cap: int, dst_cap: int, flip: bool = False,
    dst_off=0.0, device=None,
) -> torch.Tensor:
    """(..., dst_cap, src_cap) bicubic weights for src_len -> dst_len
    resizes inside fixed canvases, one matrix per leading index of the
    length tensors.

    Replicates PIL's antialiased BICUBIC: half-pixel centres, kernel
    support widened by the downscale factor, boundary renormalisation.
    Rows beyond dst_len are zero; columns beyond src_len are masked out
    before the row normalisation.  ``flip`` samples the source
    right-to-left; ``dst_off`` places the output window at
    [dst_off, dst_off + dst_len)."""
    if device is None and isinstance(src_len, torch.Tensor):
        device = src_len.device
    src = _f32(src_len, device)[..., None, None]
    dst = _f32(dst_len, device)[..., None, None]
    off = _lead(dst_off, device)
    i0 = torch.arange(dst_cap, dtype=torch.float32, device=device)[:, None] - off
    i = dst - 1.0 - i0 if flip else i0
    y = torch.arange(src_cap, dtype=torch.float32, device=device)[None, :]
    center = (i + 0.5) * src / dst - 0.5
    support_scale = torch.clamp(src / dst, min=1.0)
    w = _cubic_kernel((y - center) / support_scale)
    zero = torch.zeros((), device=device)
    w = torch.where(y < src, w, zero)
    w = torch.where((i0 >= 0.0) & (i0 < dst), w, zero)
    return _normalise_rows(w)


def dynamic_bilinear_resize_weights(
    src_len, dst_len, src_cap: int, dst_cap: int, align_corners: bool,
    flip: bool = False, src_off=0.0, dst_off=0.0, device=None,
) -> torch.Tensor:
    """(..., dst_cap, src_cap) bilinear weights for src_len -> dst_len
    resizes inside fixed canvases (torch align_corners=True, or the
    cv2/PIL half-pixel convention).  The boundary renormalisation equals
    coordinate clamping for the width-1 kernel.  ``flip`` indexes the
    output right-to-left; ``src_off``/``dst_off`` place the windows."""
    if device is None and isinstance(src_len, torch.Tensor):
        device = src_len.device
    src = _f32(src_len, device)[..., None, None]
    dst = _f32(dst_len, device)[..., None, None]
    soff = _lead(src_off, device)
    doff = _lead(dst_off, device)
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


def composed_cam_resize_weights(
    map_len, mid_len, dst_len, map_cap: int, mid_cap: int, dst_cap: int,
    flip: bool = False, device=None,
) -> torch.Tensor:
    """The reference CAM resample chain as one (..., dst_cap, map_cap)
    matrix: stride-16 map -> input size (align_corners=True), then ->
    original size (half-pixel).  Both stages are linear, so composing them
    is exact."""
    w1 = dynamic_bilinear_resize_weights(
        map_len, mid_len, map_cap, mid_cap, align_corners=True, device=device
    )
    w2 = dynamic_bilinear_resize_weights(
        mid_len, dst_len, mid_cap, dst_cap, align_corners=False, flip=flip,
        device=device,
    )
    return w2 @ w1


def batched_window_resize_ac(src: torch.Tensor, src_win: torch.Tensor,
                             dst_win: torch.Tensor, dst_hw: tuple[int, int]) -> torch.Tensor:
    """Per-image align_corners=True resize of the valid window ``src_win``
    ((N, 4) int (oy, ox, h, w)) of ``src`` (N, hs, ws, C) onto the window
    ``dst_win`` of an (dst_h, dst_w) canvas; zero outside that window.
    float32 weights: a bfloat16 ``src`` promotes, the output is float32."""
    hs, ws = src.shape[1:3]
    hd, wd = dst_hw
    wh = dynamic_bilinear_resize_weights(
        src_win[:, 2], dst_win[:, 2], hs, hd, align_corners=True,
        src_off=src_win[:, 0], dst_off=dst_win[:, 0],
    )
    ww = dynamic_bilinear_resize_weights(
        src_win[:, 3], dst_win[:, 3], ws, wd, align_corners=True,
        src_off=src_win[:, 1], dst_off=dst_win[:, 1],
    )
    a = torch.einsum("nIy,nyxc->nIxc", wh, src.to(wh.dtype))
    return torch.einsum("nJx,nIxc->nIJc", ww, a)


def dynamic_avgpool3s2_weights(src_len, src_cap: int, dst_cap: int, src_off=0,
                               device=None) -> torch.Tensor:
    """(..., dst_cap, src_cap) weights of one axis of torch's
    ``F.avg_pool2d(kernel_size=3, stride=2, padding=1)`` (count_include_pad)
    applied to the window [src_off, src_off + src_len), one matrix per
    leading index of the length tensor.  Output row j (written at the
    canvas origin) averages source rows 2j-1 .. 2j+1 with weight 1/3 each;
    taps outside the window add zero while the divisor stays 3, which is
    torch's zero-pad counting.  Rows from ceil(src_len / 2) on are zero.
    The 2-D pool is separable: two contractions with these weights."""
    if device is None and isinstance(src_len, torch.Tensor):
        device = src_len.device
    src = torch.as_tensor(src_len, device=device).to(torch.int64)[..., None, None]
    off = src_off
    if isinstance(off, torch.Tensor):
        off = off.to(device=device, dtype=torch.int64)[..., None, None]
    dst = (src + 1) // 2
    i = torch.arange(dst_cap, device=device)[:, None]
    y = torch.arange(src_cap, device=device)[None, :] - off
    w = (y >= 2 * i - 1) & (y <= 2 * i + 1) & (y >= 0) & (y < src) & (i < dst)
    return w.to(torch.float32) / 3.0


def batched_window_avgpool_s2(src: torch.Tensor, src_win: torch.Tensor,
                              dst_hw: tuple[int, int]):
    """Per-image avg_pool(3, 2, pad=1, count_include_pad) of the windows
    ``src_win`` ((N, 4) int (oy, ox, h, w)) of ``src`` (N, hs, ws, C) onto
    an (dst_h, dst_w) canvas at the origin.  Returns (pooled, pooled_win),
    pooled_win = (0, 0, ceil(h / 2), ceil(w / 2)).  float32 weights: a
    bfloat16 ``src`` promotes, ``pooled`` is float32."""
    hs, ws = src.shape[1:3]
    hd, wd = dst_hw
    wh = dynamic_avgpool3s2_weights(src_win[:, 2], hs, hd, src_off=src_win[:, 0])
    ww = dynamic_avgpool3s2_weights(src_win[:, 3], ws, wd, src_off=src_win[:, 1])
    a = torch.einsum("nIy,nyxc->nIxc", wh, src.to(wh.dtype))
    pooled = torch.einsum("nJx,nIxc->nIJc", ww, a)
    zero = torch.zeros_like(src_win[:, 0])
    pooled_win = torch.stack(
        [zero, zero, (src_win[:, 2] + 1) // 2, (src_win[:, 3] + 1) // 2], dim=-1)
    return pooled, pooled_win


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-2 / pad-1 average pool of NHWC ``x`` counting the
    padded zeros (torch's default ``count_include_pad``): the BiFPN's
    downsample.  Output sides are floor((n - 1) / 2) + 1.  At bfloat16 the
    window sum runs in bfloat16, tap by tap in row-major order, then / 9:
    the JAX package's ``reduce_window`` add over a bf16 array."""
    if x.dtype != torch.bfloat16:
        y = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1,
                                           count_include_pad=True)
        return y.permute(0, 2, 3, 1)
    _, h, w, _ = x.shape
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + 2 * oh - 1:2, dx:dx + 2 * ow - 1:2]
            acc = tap if acc is None else acc + tap
    return acc / 9.0
