"""Bit-packed 0/1 masks (port of ``muscle_tpu/core/bitpack.py``): packed on
the host 8 pairs a byte, unpacked on the device.

The IRN affinity targets (bg_pos, fg_pos, neg over the (D, P) pair grid)
are strictly 0/1 and the largest part of a training batch once the image
ships as 4:2:0; packing them is an exact re-encoding.
"""

from __future__ import annotations

import numpy as np
import torch


def packbits_last(mask: np.ndarray) -> np.ndarray:
    """0/1 array (..., P), P % 8 == 0 -> uint8 (..., P / 8), big-endian bit
    order (``np.packbits``' default: bit 7 of byte 0 is element 0)."""
    p = mask.shape[-1]
    if p % 8:
        raise ValueError(f"packbits_last needs last dim % 8 == 0, got {p}")
    return np.packbits(mask.astype(bool), axis=-1)


def unpackbits_last(packed: torch.Tensor, p: int) -> torch.Tensor:
    """The inverse on the tensor's device: uint8 (..., P / 8) -> float32
    0/1 (..., P), by a broadcast right shift and mask."""
    if packed.shape[-1] * 8 != p:
        raise ValueError(f"packed last dim {packed.shape[-1]} does not unpack to {p}")
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], p).to(torch.float32)
