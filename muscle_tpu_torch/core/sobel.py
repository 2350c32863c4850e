"""Sobel gradients and 8-direction orientation quantisation (port of
``muscle_tpu/core/sobel.py``), the fixed-kernel machinery of the BEACON
boundary loss.

The reference's 1e-6 entries in place of zeros are kept: they leak into
gradient magnitudes and so into the >= 0.8 * max boundary-pixel selection.
The bin edges are multiples of ``3.1416 / 8`` (not ``math.pi / 8``), the
reference's, so pixels near an edge bin as they do there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_E = 1e-6
_DIV = 3.1416 / 8


def sobel_kernel(kernel_size: int = 3) -> np.ndarray:
    """(kh, kw, 2) stacked Gx/Gy kernels."""
    if kernel_size == 3:
        gx = np.array([[1.0, _E, -1.0], [2.0, _E, -2.0], [1.0, _E, -1.0]])
        gy = np.array([[1.0, 2.0, 1.0], [_E, _E, _E], [-1.0, -2.0, -1.0]])
    elif kernel_size == 5:
        gx = np.array([
            [2.0, 1.0, _E, -1.0, -2.0],
            [3.0, 2.0, _E, -2.0, -3.0],
            [4.0, 3.0, 0.0, -3.0, -4.0],
            [3.0, 2.0, _E, -2.0, -3.0],
            [2.0, 1.0, _E, -1.0, -2.0],
        ])
        gy = np.array([
            [2.0, 3.0, 4.0, 3.0, 2.0],
            [1.0, 2.0, 3.0, 2.0, 1.0],
            [_E, _E, _E, _E, _E],
            [-1.0, -2.0, -3.0, -2.0, -1.0],
            [-2.0, -3.0, -4.0, -3.0, -2.0],
        ])
    else:
        raise ValueError(f"unsupported sobel kernel size {kernel_size}")
    return np.stack([gx, gy], axis=-1).astype(np.float32)


def sobel_weight(kernel_size: int, groups: int, like: torch.Tensor) -> torch.Tensor:
    """The Gx/Gy pair as a grouped ``F.conv2d`` weight (2 * groups, 1, k, k):
    output channel ``g * 2 + {0: gx, 1: gy}`` of input channel g (a
    cross-correlation, as the JAX package's ``conv_general_dilated``)."""
    k = torch.from_numpy(sobel_kernel(kernel_size).transpose(2, 0, 1)[:, None])
    return k.repeat(groups, 1, 1, 1).to(dtype=like.dtype, device=like.device)


def sobel_edges(x: torch.Tensor, kernel_size: int = 3, orient: bool = True) -> torch.Tensor:
    """The Sobel pair on a single-channel NHWC map x (N, H, W, 1): the raw
    (N, H, W, 2) gradient field when ``orient``, else the magnitude
    sqrt(gx^2 + gy^2 + 1e-8), (N, H, W, 1)."""
    pad = kernel_size // 2
    g = F.conv2d(x.permute(0, 3, 1, 2), sobel_weight(kernel_size, 1, x), padding=pad)
    g = g.permute(0, 2, 3, 1)
    if orient:
        return g
    return torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True) + 1e-8)


def orient_quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Magnitude and 8-direction bin of a (..., 2) (gx, gy) field."""
    return orient_quantize_xy(g[..., 0], g[..., 1])


def orient_quantize_xy(gx: torch.Tensor, gy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """mag = sqrt(gx^2 + gy^2 + 1e-8) and ``orient_bins(atan2(gy, gx))``."""
    mag = torch.sqrt(gx * gx + gy * gy + 1e-8)
    return mag, orient_bins(torch.atan2(gy, gx))


def orient_bins(theta: torch.Tensor) -> torch.Tensor:
    """The int64 bin in [0, 8) of angles theta: bin 0 = [div, 3 div),
    1 = [3 div, 5 div), 2 = [5 div, 7 div), 3 = [7 div, 8 div) or
    [-8 div, -7 div) and the default (the +-pi seam), 4..6 the lower
    half-plane's sectors, 7 = [-div, div), with div = 3.1416 / 8; the
    edges compared in theta's dtype."""
    d = _DIV

    def band(lo, hi):
        return (theta >= lo) & (theta < hi)

    bins = torch.full(theta.shape, 3, dtype=torch.int64, device=theta.device)
    edges = [
        (band(d, 3 * d), 0),
        (band(3 * d, 5 * d), 1),
        (band(5 * d, 7 * d), 2),
        (band(7 * d, 8 * d) | band(-8 * d, -7 * d), 3),
        (band(-7 * d, -5 * d), 4),
        (band(-5 * d, -3 * d), 5),
        (band(-3 * d, -d), 6),
        (band(-d, d), 7),
    ]
    for mask, value in edges:
        bins = torch.where(mask, value, bins)
    return bins
