"""Device-side unpacking of the host upload canvases (port of
``muscle_tpu/inference/upload.py``; host side: data/tta.py ``pack_canvas``
and ``pack_canvas_ycbcr``).  Every layout unpacks to the same
(B, side, side, 3) working canvas:

* square uint8 RGB (parity layout);
* tight uint8 RGB with portrait images stored transposed (bitwise equal);
* tight YCbCr 4:2:0 (Y full-res + chroma half-res), reconstructed to RGB
  with a bilinear 2x chroma upsample and the BT.601 full-range transform
  (PIL's 'YCbCr' convention).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from muscle_tpu_torch.core.resize import resize_bilinear


def square_unpack_fn(side: int):
    """tight RGB canvas (B, cs, side, 3) + per-image transposed flags ->
    square (B, side, side, 3) uint8 canvas (exact un-transpose)."""

    def unpack(canvas: torch.Tensor, transposed: torch.Tensor) -> torch.Tensor:
        sq = F.pad(canvas, (0, 0, 0, 0, 0, side - canvas.shape[1]))
        return torch.where(transposed[:, None, None, None], sq.transpose(1, 2), sq)

    return unpack


def ycbcr420_unpack_fn(side: int):
    """(B, cs, side) uint8 Y + (B, cs//2, side//2, 2) uint8 CbCr (stored
    transposed per the flags) -> (B, side, side, 3) float32 RGB in
    [0, 255]."""
    half = side // 2

    def unpack(y: torch.Tensor, c: torch.Tensor, transposed: torch.Tensor) -> torch.Tensor:
        ysq = F.pad(y, (0, 0, 0, side - y.shape[1]))
        ysq = torch.where(transposed[:, None, None], ysq.transpose(1, 2), ysq)
        csq = F.pad(c, (0, 0, 0, 0, 0, half - c.shape[1]))
        csq = torch.where(transposed[:, None, None, None], csq.transpose(1, 2), csq)
        cup = resize_bilinear(csq.to(torch.float32), (side, side), align_corners=False)
        yf = ysq.to(torch.float32)
        cb = cup[..., 0] - 128.0
        cr = cup[..., 1] - 128.0
        r = yf + 1.402 * cr
        g = yf - 0.344136 * cb - 0.714136 * cr
        b = yf + 1.772 * cb
        return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)

    return unpack
