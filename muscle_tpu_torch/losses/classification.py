"""Multi-label classification losses (port of
``muscle_tpu/losses/classification.py``).  (N, C) and NHWC tensors;
scalars unless noted.  ``group``: a data-parallel process group; a mean
over the batch is then this rank's share of the global batch's
(``parallel.batch_mean``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from muscle_tpu_torch.parallel.mesh import batch_mean


def focal_loss(probs: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
               alpha: float = 0.5, group=None) -> torch.Tensor:
    """Multi-label focal loss on sigmoid probabilities (N, C): summed over
    classes, averaged over the batch."""
    pt = target * probs + (1.0 - target) * (1.0 - probs)
    focal = -alpha * (1.0 - pt) ** gamma * torch.log(pt + 1e-9)
    return batch_mean(focal.sum(dim=1), group)


def lsep_loss(pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp pairwise ranking loss, per sample (N,).  The reference's
    quirk stays: invalid entries are zeroed, not excluded, so absent
    classes still add exp(0) terms."""
    pos = torch.where(labels == 0, torch.zeros_like(pred), pred)
    neg = torch.where(labels == 1, torch.zeros_like(pred), pred)
    exp_sub = torch.exp(neg[:, None, :] - pos[:, :, None])  # (N, C_pos, C_neg)
    exp_sum = exp_sub.sum(dim=(1, 2)) / (exp_sub.shape[1] * exp_sub.shape[2])
    return torch.log(1.0 + exp_sum)


def soft_margin_loss(logits: torch.Tensor, target: torch.Tensor, group=None) -> torch.Tensor:
    """MultiLabelSoftMarginLoss: per-class BCE with logits, averaged over
    classes and then over the batch."""
    per_class = -(target * F.logsigmoid(logits) + (1.0 - target) * F.logsigmoid(-logits))
    return batch_mean(per_class.mean(dim=-1), group)


def er_topk_loss(cams: torch.Tensor, sgcs: torch.Tensor, valid_channels: torch.Tensor,
                 frac: float = 0.2, iters: int = 22, group=None) -> torch.Tensor:
    """Equivariant-regularisation top-k loss: the mean of the top
    ``k = int(frac * valid_channels * h * w)`` values of |cams - sgcs| per
    sample, averaged over the batch.

    cams: (N, H, W, C) detached; sgcs: (N, H, W, C) with gradient;
    valid_channels: the label sum over the whole (global) batch (a 0-d
    tensor).  k is ~10^6 at crop 448, where a top-k is a sort, so the
    per-sample threshold is found by ``iters`` halvings of [0, max] (masked
    counts, no gradient), and the top-k sum is sum(x * [x > t]) + (k - count) * t,
    boundary ties resolved at the threshold, as in the JAX package."""
    n, h, w, _ = cams.shape
    diff = torch.abs(cams.detach() - sgcs).reshape(n, -1)
    k = (frac * valid_channels.to(torch.float32) * h * w).to(torch.int32)
    kf = torch.clamp(k, 1, diff.shape[-1]).to(torch.float32)
    with torch.no_grad():
        d = diff.detach().to(torch.float32)  # the search in f32 at any dtype
        lo = torch.zeros((n,), dtype=torch.float32, device=d.device)
        hi = d.amax(dim=-1)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            above = (d > mid[:, None]).sum(dim=-1).to(torch.float32)
            more = above > kf
            lo = torch.where(more, mid, lo)
            hi = torch.where(more, hi, mid)
        above_mask = d > hi[:, None]  # count(d > t) <= k <= count(d >= t)
        n_above = above_mask.sum(dim=-1).to(torch.float32)
    top_sum = torch.where(above_mask, diff, torch.zeros_like(diff)).sum(dim=-1)
    top_sum = top_sum + (kf - n_above) * hi
    return batch_mean(top_sum / kf, group)
