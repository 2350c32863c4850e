"""Support functions around the BEACON loss (port of
``muscle_tpu/losses/edge_support.py``): the reference's BGFilter,
Edge_detector, UnitVec, FieldGenerator and ArgMax.  Off the training path,
kept as part of the API.  Maps are NHWC.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from muscle_tpu_torch.core.sobel import sobel_edges
from muscle_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

_E = 1e-6


def box_filter(x: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Mean box filter of an (N, H, W, 1) map, zeros outside."""
    pad = kernel_size // 2
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel_size, stride=1, padding=pad,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def _gaussian_kernel_2d(size: int, sigma: float | None) -> np.ndarray:
    if sigma is None:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8  # torchvision's default
    ax = np.arange(size) - (size - 1) / 2.0
    k1 = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k1 /= k1.sum()
    return np.outer(k1, k1).astype(np.float32)


def grayscale_edge(x: torch.Tensor, gaussian_size: int = 7, gaussian_sigma: float | None = None,
                   sobel_size: int = 3) -> torch.Tensor:
    """Sobel edge magnitude of the Gaussian-blurred ITU-R grayscale of a
    normalised image batch x (N, H, W, 3); returns (N, H, W, 1)."""
    mean = torch.tensor(IMAGENET_MEAN[0, 0], dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD[0, 0], dtype=x.dtype, device=x.device)
    img = torch.clamp((x * std + mean) * 255.0, 0.0, 255.0).permute(0, 3, 1, 2)
    k = torch.from_numpy(_gaussian_kernel_2d(gaussian_size, gaussian_sigma)).to(x)
    blurred = F.conv2d(img, k[None, None].repeat(3, 1, 1, 1), padding=gaussian_size // 2,
                       groups=3)
    gray = (0.2989 * blurred[:, 0] + 0.587 * blurred[:, 1] + 0.114 * blurred[:, 2])[..., None]
    return sobel_edges(gray / 255.0, sobel_size, orient=False)


def unit_vectors(orient: torch.Tensor) -> torch.Tensor:
    """Unit vectors (..., 2) of orientation bins in [0, 8)."""
    u = 1.0 / math.sqrt(2.0)
    table = torch.tensor([[u, u], [_E, u], [-u, u], [-u, _E],
                          [-u, -u], [_E, -u], [u, -u], [u, _E]],
                         dtype=torch.float32, device=orient.device)
    return table[orient]


def field_masks(orient: torch.Tensor):
    """5x5 outside/inside half-plane masks of orientation bins: (outs,
    outs > 1e-5, ins, ins > 1e-5), each with a trailing 25-entry axis."""
    k = [None] * 8
    k[0] = np.where(np.triu(np.ones((5, 5)), 1) > 0, 1.0, _E)
    k[1] = np.where(np.arange(5)[:, None] < 2, 1.0, _E) * np.ones((5, 5))
    k[2] = np.where(np.fliplr(np.triu(np.ones((5, 5)), 1)) > 0, 1.0, _E)
    k[3] = np.where(np.arange(5)[None, :] < 2, 1.0, _E) * np.ones((5, 5))
    k[4] = np.where(np.tril(np.ones((5, 5)), -1) > 0, 1.0, _E)
    k[5] = np.where(np.arange(5)[:, None] > 2, 1.0, _E) * np.ones((5, 5))
    k[6] = np.where(np.fliplr(np.tril(np.ones((5, 5)), -1)) > 0, 1.0, _E)
    k[7] = np.where(np.arange(5)[None, :] > 2, 1.0, _E) * np.ones((5, 5))
    outs_table = torch.tensor(np.stack([m.reshape(-1) for m in k]), dtype=torch.float32,
                              device=orient.device)
    ins_table = torch.roll(outs_table, 4, dims=0)
    outs, ins = outs_table[orient], ins_table[orient]
    return outs, outs > 1e-5, ins, ins > 1e-5


class _StraightThroughArgmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        idx = torch.argmax(x, dim=-1)
        ctx.save_for_backward(idx)
        ctx.depth = x.shape[-1]
        return idx.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        onehot = F.one_hot(idx, ctx.depth).to(g.dtype)
        return onehot * g.sum()


def straight_through_argmax(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis (as x's dtype) whose gradient puts the
    SUMMED upstream gradient on each argmax position (the reference's
    ArgMax autograd function)."""
    return _StraightThroughArgmax.apply(x)
