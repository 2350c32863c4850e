"""CAM normalisers (port of ``muscle_tpu/core/cam_norm.py``).

CAM stacks are NHWC, (N, H, W, C) with C = num_classes (channel 0 the
background where there is one).  The +-1e-6 epsilons are the reference's,
kept bit for bit: downstream background thresholds were tuned against
them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-6


def _minmax_norm(cams: torch.Tensor) -> torch.Tensor:
    """ReLU, then per-(sample, class) min-max normalisation over space."""
    cams = F.relu(cams)
    cam_min = torch.amin(cams, dim=(1, 2), keepdim=True)
    cam_max = torch.amax(cams, dim=(1, 2), keepdim=True)
    return (cams - cam_min - _EPS) / (cam_max - cam_min + _EPS)


def cam_maxnorm(cams: torch.Tensor) -> torch.Tensor:
    """Per-class min-max normalisation: (N, H, W, C) raw scores -> [0, 1)
    with negatives clamped to 0."""
    return F.relu(_minmax_norm(cams))


def cam_maxnorm_with_bg(cams: torch.Tensor) -> torch.Tensor:
    """Min-max normalise, then replace channel 0 by 1 - max(foreground)."""
    norm = _minmax_norm(cams)
    fg = norm[..., 1:]
    bg = 1.0 - torch.amax(fg, dim=-1, keepdim=True)
    return F.relu(torch.cat([bg, fg], dim=-1))


def cam_softmaxnorm(cams: torch.Tensor, relu_first: bool = False) -> torch.Tensor:
    """Softmax over the foreground channels; bg = 1 - max(foreground).  The
    training losses call it without the leading ReLU, CAM inference with
    it (``relu_first``)."""
    if relu_first:
        cams = F.relu(cams)
    fg = torch.softmax(cams[..., 1:], dim=-1)
    bg = 1.0 - torch.amax(fg, dim=-1, keepdim=True)
    return torch.cat([bg, fg], dim=-1)


def gap2d(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Global average pool over the spatial axes of NHWC."""
    return x.mean(dim=(1, 2), keepdim=keepdim)


def gap2d_pos(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Sum over space divided by the count of positives in the whole batch
    tensor (the reference's quirk: not per channel)."""
    out = x.sum(dim=(1, 2), keepdim=keepdim)
    return out / ((x > 0).sum() + 1e-12)


def attach_bg_channel(label: torch.Tensor, value: float = 1.0) -> torch.Tensor:
    """(N, 20) multi-hot -> (N, 21) with channel 0 == ``value``."""
    bg = torch.full(label.shape[:-1] + (1,), value, dtype=label.dtype, device=label.device)
    return torch.cat([bg, label], dim=-1)
