"""Batched multi-scale + flip TTA producers (port of
``muscle_tpu/data/tta.py``).

Images are PIL images or HWC uint8 arrays.  The device-TTA engines upload
each image once as a uint8 canvas (``pack_canvas``, or the 4:2:0
``pack_canvas_ycbcr``); the host-prep path resizes and normalises on the
host (``msf_batch``); the exact path groups images of one shape
(``group_by_shape``).  PIL is imported only where a function resizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from muscle_tpu_torch.data import transforms as T

VOC_MAX_SIDE = 500


def bucket_side(scale: float, max_side: int = VOC_MAX_SIDE, align: int = 64) -> int:
    return int(math.ceil(max_side * scale / align)) * align


# the canvas side of each TTA scale at VOC's max side
MSF_BUCKETS = {s: bucket_side(s) for s in (0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0)}


def scaled_size(w: int, h: int, scale: float) -> tuple[int, int]:
    """(w, h) after the reference's rounding."""
    return round(w * scale), round(h * scale)


def _short_canvas(orig_sizes: np.ndarray, out_side: int) -> int:
    short = int(max(min(h, w) for (h, w) in orig_sizes))
    return min(out_side, ((short + 63) // 64) * 64)


def pack_canvas(images, names, out_side: int, tight: bool):
    """uint8 upload canvas for the device-TTA engines.

    tight=False: square (B, out_side, out_side, 3) canvas, images top-left.
    tight=True: (B, cs, out_side, 3) with portrait images stored TRANSPOSED,
    cs = the batch's max short side bucketed to a multiple of 64.  Returns
    (canvas, orig_sizes, transposed), transposed None for the square
    layout."""
    b = len(images)
    orig_sizes = np.zeros((b, 2), np.int32)
    arrs = []
    for i, img in enumerate(images):
        arr = np.asarray(img)[..., :3]
        h, w = arr.shape[:2]
        if h > out_side or w > out_side:
            raise ValueError(f"image {names[i]} ({h}x{w}) exceeds canvas {out_side}")
        orig_sizes[i] = (h, w)
        arrs.append(arr)
    if not tight:
        canvas = np.zeros((b, out_side, out_side, 3), np.uint8)
        for i, arr in enumerate(arrs):
            canvas[i, : arr.shape[0], : arr.shape[1]] = arr
        return canvas, orig_sizes, None
    cs = _short_canvas(orig_sizes, out_side)
    canvas = np.zeros((b, cs, out_side, 3), np.uint8)
    transposed = np.zeros(b, bool)
    for i, arr in enumerate(arrs):
        if arr.shape[0] > cs:
            arr = arr.transpose(1, 0, 2)
            transposed[i] = True
        canvas[i, : arr.shape[0], : arr.shape[1]] = arr
    return canvas, orig_sizes, transposed


def pack_canvas_ycbcr(images, names, out_side: int, tight: bool = True):
    """Chroma-subsampled (4:2:0) upload canvases: Y at full resolution,
    Cb/Cr box-averaged 2x (PIL's YCbCr conversion and BOX resize), 1.5
    bytes per pixel.  Layout as ``pack_canvas``; the padded chroma edge is
    replicated one row/column so the device's bilinear 2x upsample never
    blends chroma with canvas zeros inside the image.

    Returns (y (B, cs, S) u8, c (B, cs//2, S//2, 2) u8, orig_sizes (B, 2),
    transposed (B,) bool); device inverse: inference/upload.py."""
    from PIL import Image

    b = len(images)
    orig_sizes = np.zeros((b, 2), np.int32)
    planes = []
    for i, img in enumerate(images):
        img = T.to_pil(img)
        w, h = img.size
        if h > out_side or w > out_side:
            raise ValueError(f"image {names[i]} ({h}x{w}) exceeds canvas {out_side}")
        orig_sizes[i] = (h, w)
        y, cb, cr = (np.asarray(p) for p in img.convert("YCbCr").split())
        cw, ch = (w + 1) // 2, (h + 1) // 2
        c = np.stack([np.asarray(Image.fromarray(p).resize((cw, ch), Image.BOX))
                      for p in (cb, cr)], axis=-1)
        planes.append((y, c))
    cs = _short_canvas(orig_sizes, out_side) if tight else out_side
    y_canvas = np.zeros((b, cs, out_side), np.uint8)
    c_canvas = np.zeros((b, cs // 2, out_side // 2, 2), np.uint8)
    transposed = np.zeros(b, bool)
    for i, (y, c) in enumerate(planes):
        if y.shape[0] > cs:
            y = y.transpose(1, 0)
            c = c.transpose(1, 0, 2)
            transposed[i] = True
        y_canvas[i, : y.shape[0], : y.shape[1]] = y
        ch, cw = c.shape[:2]
        c_canvas[i, :ch, :cw] = c
        if ch < cs // 2:
            c_canvas[i, ch, :cw] = c[-1]
        if cw < out_side // 2:
            c_canvas[i, : ch + (ch < cs // 2), cw] = c_canvas[i, : ch + (ch < cs // 2), cw - 1]
    return y_canvas, c_canvas, orig_sizes, transposed


@dataclass
class MSFBatch:
    """One scale's TTA batch: images (2B, H, W, 3) float32 with originals
    at even and flips at odd indices; sizes (B, 2) valid (h, w) inside the
    canvas; orig_sizes (B, 2) original (H, W)."""

    scale: float
    images: np.ndarray
    sizes: np.ndarray
    names: list[str]
    orig_sizes: np.ndarray


def msf_batch(images, names, scale: float, canvas: int | tuple[int, int] | None = None,
              flip: bool = True, offsets: np.ndarray | None = None) -> MSFBatch:
    """Resize a batch to ``scale`` (PIL BICUBIC, like the reference),
    normalise, and place orig(+flip) into a canvas at per-image ``offsets``
    (B, 2) (oy, ox), default the origin."""
    b = len(images)
    if canvas is None:
        ch = cw = bucket_side(scale)
    elif isinstance(canvas, tuple):
        ch, cw = canvas
    else:
        ch = cw = canvas
    per = 2 if flip else 1
    out = np.zeros((per * b, ch, cw, 3), np.float32)
    sizes = np.zeros((b, 2), np.int32)
    orig = np.zeros((b, 2), np.int32)
    for i, img in enumerate(images):
        img = T.to_pil(img)
        w, h = img.size
        orig[i] = (h, w)
        tw, th = scaled_size(w, h, scale)
        oy, ox = (0, 0) if offsets is None else (int(offsets[i, 0]), int(offsets[i, 1]))
        arr = T.color_norm(np.asarray(img.resize((tw, th), resample=T.BICUBIC)))
        out[per * i, oy: oy + th, ox: ox + tw] = arr
        if flip:
            out[per * i + 1, oy: oy + th, ox: ox + tw] = arr[:, ::-1]
        sizes[i] = (th, tw)
    return MSFBatch(scale, out, sizes, list(names), orig)


def group_by_shape(images, names):
    """Indices of the images sharing each (w, h)."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, img in enumerate(images):
        groups.setdefault(T.image_size(img), []).append(i)
    return groups
