"""Earth-mover cross-view matching loss (port of ``muscle_tpu/losses/emd.py``).

The reference scores ragged random crop grids of the two views' overlap
with a no-grad Sinkhorn EMD and backpropagates through the best pair.
As in the JAX package, every crop is sampled onto a fixed P x P grid
(``core/resize.py`` ``dynamic_window_resize``, align_corners=True): the
shapes are static and the geometry stays data-dependent (DEVIATIONS #2:
crops fixed at a 3 x 3 grid of 7 x 7).  Here every sample of a batch is
scored at once.
"""

from __future__ import annotations

import torch

from muscle_tpu_torch.core.resize import dynamic_window_resize
from muscle_tpu_torch.parallel.mesh import draw_rows, reduced


def sinkhorn_emd(cost: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, reg: float = 0.1,
                 maxiter: int = 10) -> torch.Tensor:
    """Log-domain Sinkhorn distance over the last two axes (any leading
    batch axes): cost (..., N, M), marginals mu (..., N) and nu (..., M),
    unnormalised.  Each step computes the modified cost once from (u, v)
    and updates u and then v from that same matrix, as the reference does.
    Returns sum(pi * cost.detach()) / (N * M)."""
    u = torch.zeros_like(mu)
    v = torch.zeros_like(nu)
    log_mu = torch.log(mu + 1e-6)
    log_nu = torch.log(nu + 1e-6)
    for _ in range(maxiter):
        m = (-cost + u[..., :, None] + v[..., None, :]) / reg
        u = reg * (log_mu - torch.logsumexp(m, dim=-1)) + u
        v = reg * (log_nu - torch.logsumexp(m, dim=-2)) + v
    pi = torch.exp((-cost + u[..., :, None] + v[..., None, :]) / reg)
    return (pi * cost.detach()).sum(dim=(-2, -1)) / (cost.shape[-2] * cost.shape[-1])


def pairwise_cosine_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - <x_i, y_j>: x (..., N, C), y (..., M, C) -> (..., N, M)."""
    return 1.0 - x @ y.transpose(-1, -2)


def crop_weight_vector(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cross-attention marginals w_i = <x_i, mean_j y_j>: (..., N)."""
    return (x @ y.mean(dim=-2)[..., :, None])[..., 0]


def _pair_emd(x: torch.Tensor, y: torch.Tensor, maxiter: int) -> torch.Tensor:
    return sinkhorn_emd(pairwise_cosine_cost(x, y), crop_weight_vector(x, y),
                        crop_weight_vector(y, x), maxiter=maxiter)


def _crops(fm: torch.Tensor, boxes: torch.Tensor, crop_px: int) -> torch.Tensor:
    """(N, K, P*P, C): each NHWC map's K (row, col, h, w) windows of
    ``boxes`` (N, K, 4) sampled onto P x P."""
    n, _, _, c = fm.shape
    return torch.stack([
        dynamic_window_resize(fm, boxes[:, j], (crop_px, crop_px)).reshape(n, -1, c)
        for j in range(boxes.shape[1])], dim=1)


def static_matching_emd(vw1: torch.Tensor, vw2: torch.Tensor, coord1: torch.Tensor,
                        coord2: torch.Tensor, crop_px: int = 7) -> torch.Tensor:
    """'static' EMD: the mean pairwise cosine distance of the two views'
    overlaps sampled onto crop_px x crop_px; the sum of the two smallest
    per-sample distances."""
    x = _crops(vw1, coord1.long()[:, None], crop_px)[:, 0]
    y = _crops(vw2.detach(), coord2.long()[:, None], crop_px)[:, 0]
    dists = pairwise_cosine_cost(x, y).mean(dim=(-2, -1))
    return torch.sort(dists).values[:2].sum()


def draw_crop_fractions(n: int, generator: torch.Generator | None = None,
                        device=None, group=None) -> torch.Tensor:
    """(n, 2) crop-size fractions of the overlap's (h, w), uniform in
    [1/3, 1/2); with a data-parallel ``group``, this rank's rows of the
    global batch's draw."""
    u = draw_rows((n, 2), generator, group, device=device)
    return u * (1 / 2 - 1 / 3) + 1 / 3


def dynamic_matching_emd(vw1: torch.Tensor, vw2: torch.Tensor, coord1: torch.Tensor,
                         coord2: torch.Tensor, crop_frac: torch.Tensor | None = None,
                         generator: torch.Generator | None = None, grid: int = 3,
                         crop_px: int = 7, maxiter: int = 10, group=None) -> torch.Tensor:
    """Cross-view EMD with dynamic crop matching.

    vw1: (N, Hv, Wv, C) view with gradient (normalised softmax CAMs); vw2:
    the view without; coord1/coord2: (N, 4) overlaps (row, col, h, w) in
    each view; crop_frac: (N, 2) fractions of the overlap's (h, w) that
    size view 1's crops, drawn from ``generator`` when None.  View 1 gives
    a grid x grid set of crops spread over its overlap, view 2 the four
    half-size quadrants of its own; every pair is scored without gradient
    and the best pair carries it.  Samples whose overlap is under 15
    pixels a side or more elongated than 5:1 add 0; the mean is over the
    others (of the global batch with a data-parallel ``group``: this rank's
    sum over the global count, its share)."""
    n = vw1.shape[0]
    dev = vw1.device
    if crop_frac is None:
        crop_frac = draw_crop_fractions(n, generator, dev, group)
    c1, c2 = coord1.to(dev).long(), coord2.to(dev).long()
    h, w = c1[:, 2], c1[:, 3]
    hf, wf = h.to(torch.float32), w.to(torch.float32)
    valid = (h >= 15) & (w >= 15) & (hf / wf <= 5.0) & (wf / hf <= 5.0)

    frac = crop_frac.to(device=dev, dtype=torch.float32)
    lh = torch.clamp((hf * frac[:, 0]).to(torch.int32), min=5).long()
    lw = torch.clamp((wf * frac[:, 1]).to(torch.int32), min=5).long()
    steps = torch.linspace(0.0, 1.0, grid, device=dev)
    r = c1[:, 0:1] + (steps[None] * (hf - lh.to(torch.float32))[:, None]).to(torch.int32)
    c = c1[:, 1:2] + (steps[None] * (wf - lw.to(torch.float32))[:, None]).to(torch.int32)
    boxes1 = torch.stack([
        r[:, :, None].expand(n, grid, grid), c[:, None, :].expand(n, grid, grid),
        lh[:, None, None].expand(n, grid, grid), lw[:, None, None].expand(n, grid, grid),
    ], dim=-1).reshape(n, grid * grid, 4)

    h2 = torch.clamp(c2[:, 2] // 2, min=1)
    w2 = torch.clamp(c2[:, 3] // 2, min=1)
    qy = torch.tensor([0, 0, 1, 1], device=dev)
    qx = torch.tensor([0, 1, 0, 1], device=dev)
    boxes2 = torch.stack([
        c2[:, 0:1] + qy[None] * h2[:, None], c2[:, 1:2] + qx[None] * w2[:, None],
        h2[:, None].expand(n, 4), w2[:, None].expand(n, 4)], dim=-1)

    crops2 = _crops(vw2.detach(), boxes2, crop_px)  # (N, 4, P*P, C)
    with torch.no_grad():
        crops1 = _crops(vw1, boxes1, crop_px)  # (N, G*G, P*P, C)
        scores = _pair_emd(crops1[:, :, None], crops2[:, None], maxiter)  # (N, G*G, 4)
        best = torch.argmin(scores.reshape(n, -1), dim=-1)
    rows = torch.arange(n, device=dev)
    x = _crops(vw1, boxes1[rows, best // 4][:, None], crop_px)[:, 0]
    top1 = _pair_emd(x, crops2[rows, best % 4], maxiter)
    losses = torch.where(valid, top1, torch.zeros_like(top1))
    return losses.sum() / torch.clamp(reduced(valid.sum(), group), min=1)
