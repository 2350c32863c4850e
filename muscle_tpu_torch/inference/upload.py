"""Host-device transfers of the TTA engines, and the device-side unpacking
of the host upload canvases (port of ``muscle_tpu/inference/upload.py``;
host side: data/tta.py ``pack_canvas`` and ``pack_canvas_ycbcr``).  Every
layout unpacks to the same (B, side, side, 3) working canvas:

* square uint8 RGB (parity layout);
* tight uint8 RGB with portrait images stored transposed (bitwise equal);
* tight YCbCr 4:2:0 (Y full-res + chroma half-res), reconstructed to RGB
  by ``core/ycbcr.py`` ``ycbcr420_to_rgb``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from muscle_tpu_torch.core.ycbcr import ycbcr420_to_rgb


def to_device(a, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``.  To a card it goes through
    pinned memory without blocking the host: a pageable copy would wait
    for the device to drain the previous batch first."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def start_download(t: torch.Tensor):
    """Start copying ``t`` to the host; returns a function that waits for
    the copy and returns it as a numpy array."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return wait


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
    [0, 255] (the decode: ``core/ycbcr.py``)."""
    half = side // 2

    def unpack(y: torch.Tensor, c: torch.Tensor, transposed: torch.Tensor) -> torch.Tensor:
        ysq = F.pad(y, (0, 0, 0, side - y.shape[1]))
        ysq = torch.where(transposed[:, None, None], ysq.transpose(1, 2), ysq)
        csq = F.pad(c, (0, 0, 0, 0, 0, half - c.shape[1]))
        csq = torch.where(transposed[:, None, None, None], csq.transpose(1, 2), csq)
        return ycbcr420_to_rgb(ysq, csq)

    return unpack
