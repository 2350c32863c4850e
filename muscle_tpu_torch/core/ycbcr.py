"""YCbCr 4:2:0 host pack and device decode (port of
``muscle_tpu/core/ycbcr.py``).

A training crop ships as full-resolution luma plus 2x2-subsampled chroma:
1.5 bytes a pixel instead of 3.  The decode is a bilinear 2x chroma
upsample (half-pixel centres, the standard 4:2:0 siting) and the BT.601
full-range transform (PIL's 'YCbCr' convention); the TTA engines' canvas
unpacker (``inference/upload.py``) decodes through the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from muscle_tpu_torch.core.resize import resize_bilinear


def rgb_to_ycbcr420(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 RGB (H, W, 3), even H and W -> (y (H, W) uint8,
    c (H/2, W/2, 2) uint8): PIL's RGB -> YCbCr and a BOX 2x chroma
    subsample, on the host."""
    from PIL import Image

    h, w = arr.shape[:2]
    if h % 2 or w % 2:
        raise ValueError(f"ycbcr420 pack needs even sides, got {h}x{w}")
    ycc = Image.fromarray(np.ascontiguousarray(arr), "RGB").convert("YCbCr")
    y, cb, cr = (np.asarray(p) for p in ycc.split())
    c = np.stack([np.asarray(Image.fromarray(p).resize((w // 2, h // 2), Image.BOX))
                  for p in (cb, cr)], axis=-1)
    return y, c


def ycbcr420_to_rgb(y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """y (B, H, W) uint8 + c (B, H/2, W/2, 2) uint8 -> (B, H, W, 3) float32
    RGB in [0, 255], on the tensors' device."""
    cup = resize_bilinear(c.to(torch.float32), tuple(y.shape[1:3]), align_corners=False)
    yf = y.to(torch.float32)
    cb = cup[..., 0] - 128.0
    cr = cup[..., 1] - 128.0
    r = yf + 1.402 * cr
    g = yf - 0.344136 * cb - 0.714136 * cr
    b = yf + 1.772 * cb
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)
