"""BEACON boundary-enhancement field loss (port of
``muscle_tpu/losses/beacon.py``).

  1. (no gradient) the beta-sharpened softmax of the seg map, 5x5 Sobel
     gradients of each foreground class, magnitude and orientation
     quantised to 8 directions;
  2. boundary pixels: magnitude >= 0.8 * the class's max, max > 1, class
     present;
  3. a +-step walk from each boundary pixel along its quantised gradient
     gives an "outside" and an "inside" sample;
  4. k boundary pixels sampled, k x k similarity matrices of the
     channel-softmaxed dense features and of the softmaxed pseudo-mask
     between their outside and inside samples, and FP/FN/TP/TN pairs
     pushed and pulled.

The JAX package's deviations from the reference are kept (DEVIATIONS #3,
#4): the stated +-step walk geometry in all 8 directions, and k samples
without replacement as the top k of uniform scores on the valid pixels;
an (image, class) pair counts only with more than k valid pixels.

All N x (C-1) (image, class) pairs run batched: one top-k over their
scores, one gather of the k outside and k inside rows, one ``bmm`` per
similarity.  The feature softmax is taken over the gathered rows only
(it is per pixel, so this is exact), not over all H x W pixels.
"""

from __future__ import annotations

import dataclasses

import torch

from muscle_tpu_torch.core.sobel import orient_quantize_xy, sobel_weight
from muscle_tpu_torch.parallel.mesh import draw_rows, world

# bin -> (dy, dx) unit walk along the gradient direction for the 8 sectors
# of orient_quantize (y points down)
_DIR_DY = (1, 1, 1, 0, -1, -1, -1, 0)
_DIR_DX = (1, 0, -1, -1, -1, 0, 1, 1)


@dataclasses.dataclass(frozen=True)
class FieldLossConfig:
    num_classes: int = 21
    sobel_size: int = 5
    beta: float = 1e2  # softmax sharpening
    k: int = 128  # samples per side (train_muscle --k)
    step: int = 7  # walk distance (train_muscle --step)


def _class_edges(seg_map: torch.Tensor, label_with_bg: torch.Tensor, cfg: FieldLossConfig):
    """Per-foreground-class Sobel gradients of the sharpened softmax: one
    grouped conv (groups C-1, two output channels each).  seg_map (N, H, W,
    C), label_with_bg (N, C).  Returns (gx, gy), each (N, C-1, H, W),
    zero for classes not in the label."""
    nfg = seg_map.shape[-1] - 1
    probs = torch.softmax(seg_map * cfg.beta, dim=-1)[..., 1:].permute(0, 3, 1, 2)
    g = torch.nn.functional.conv2d(probs, sobel_weight(cfg.sobel_size, nfg, probs),
                                   padding=cfg.sobel_size // 2, groups=nfg)
    lab = label_with_bg[:, 1:, None, None]  # float32: a bf16 map's gradients promote
    return g[:, 0::2] * lab, g[:, 1::2] * lab


def pair_signs(sim: torch.Tensor, sim_mask: torch.Tensor, axis: int):
    """(sign_mask, sign_sim), each (P, k): whether each sample's marginal
    mean (axis 1 of each k x k matrix: the out marginal; 0: the in
    marginal) of the mask similarity, and of the feature similarity,
    exceeds its matrix's mean.  Threshold comparisons: a near-tie can
    flip between two devices' roundings."""
    dim = axis + 1
    sign_mask = sim_mask.mean(dim=dim) > sim_mask.mean(dim=(1, 2))[:, None]
    sim_d = sim.detach()
    sign_sim = sim_d.mean(dim=dim) > sim_d.mean(dim=(1, 2))[:, None]
    return sign_mask, sign_sim


def _pair_loss(sim: torch.Tensor, sim_mask: torch.Tensor, axis: int) -> torch.Tensor:
    """FP/FN/TP/TN push-pull over a batch of (P, k, k) similarities; axis
    1 (of each k x k matrix) takes the out marginal, 0 the in marginal.
    Returns (P,)."""
    mean_sim = sim.mean(dim=axis + 1)
    sign_mask, sign_sim = pair_signs(sim, sim_mask, axis)

    def masked_mean(mask, sign):
        cnt = mask.sum(dim=-1)
        val = torch.where(mask, mean_sim, 0.0).sum(dim=-1) / torch.clamp(cnt, min=1)
        return torch.where(cnt > 0, sign * val, 0.0)

    return (masked_mean(sign_mask & ~sign_sim, -1.0) + masked_mean(~sign_mask & sign_sim, 1.0)
            + masked_mean(~sign_mask & ~sign_sim, 1.0) + masked_mean(sign_mask & sign_sim, -1.0))


def boundary_samples(seg_map: torch.Tensor, label_with_bg: torch.Tensor, cfg: FieldLossConfig,
                     draws: torch.Tensor):
    """The sampling half of the loss, without gradients: per (image,
    class) pair p = image * (C-1) + class, the flat indices (P, k) of the
    outside and inside samples of k boundary pixels (in the boundary
    pixels' raster order), which of them are
    valid (P, k), each pair's count of valid boundary pixels (P,), and the
    summed foreground gradient magnitude (N, H, W).  draws: (N, C-1, H, W)
    uniform scores."""
    n, h, w, _ = seg_map.shape
    with torch.no_grad():
        gx, gy = _class_edges(seg_map, label_with_bg, cfg)
        mag, orient = orient_quantize_xy(gx, gy)  # (N, C-1, H, W)
        max_fg = mag.amax(dim=(2, 3), keepdim=True)
        pos = (mag >= 0.8 * max_fg) & (max_fg > 1.0)
        pos = pos & (label_with_bg[:, 1:, None, None] > 0)
        dev = seg_map.device
        dy = torch.tensor(_DIR_DY, device=dev)[orient] * cfg.step
        dx = torch.tensor(_DIR_DX, device=dev)[orient] * cfg.step
        rows = torch.arange(h, device=dev)[:, None]
        cols = torch.arange(w, device=dev)[None, :]
        out_r, out_c, in_r, in_c = rows + dy, cols + dx, rows - dy, cols - dx

        def inb(r, c):
            return (r >= 0) & (r < h) & (c >= 0) & (c < w)

        valid = (pos & inb(out_r, out_c) & inb(in_r, in_c)).flatten(2).flatten(0, 1)  # (P, HW)
        count = valid.sum(dim=-1)
        # float32 scores whatever the map's dtype, as the JAX package draws
        # them: bf16 draws would tie by the hundreds and top-k pick others
        scores = torch.where(valid, draws.to(torch.float32).flatten(2).flatten(0, 1), -1.0)
        # (P, k), in ascending pixel order: the same order on every device
        idx = torch.topk(scores, cfg.k, dim=-1, sorted=False).indices.sort(dim=-1).values
        sel_valid = torch.gather(valid, 1, idx)

        def pick(r, c):
            flat = (r * w + c).flatten(2).flatten(0, 1)
            return torch.clamp(torch.gather(flat, 1, idx), 0, h * w - 1)

        return pick(out_r, out_c), pick(in_r, in_c), sel_valid, count, mag.sum(dim=1)


def pair_similarities(seg_map: torch.Tensor, dense_ft: torch.Tensor, mask: torch.Tensor,
                      label_with_bg: torch.Tensor, cfg: FieldLossConfig, draws: torch.Tensor):
    """The k x k similarities of every (image, class) pair: (sim, sim_mask,
    count, mag_fg), sim/sim_mask (P, k, k) between the softmaxed features
    (the inside side detached) and the softmaxed mask (detached) of the
    outside and inside samples, count (P,) the valid boundary pixels, and
    mag_fg (N, H, W) (``boundary_samples``)."""
    n, h, w, c = seg_map.shape
    out_idx, in_idx, sel_valid, count, mag_fg = boundary_samples(seg_map, label_with_bg, cfg,
                                                                 draws)
    # rows of image p // (C-1) in the flattened (N * H * W, .) maps
    base = (torch.arange(out_idx.shape[0], device=seg_map.device) // (c - 1) * (h * w))[:, None]
    wsel = sel_valid.to(dense_ft.dtype)[..., None]

    def rows(x, idx):
        return x.reshape(n * h * w, -1)[(idx + base).reshape(-1)].reshape(*idx.shape, -1)

    outs = torch.softmax(rows(dense_ft, out_idx), dim=-1) * wsel
    ins = torch.softmax(rows(dense_ft, in_idx), dim=-1) * wsel
    mask_d = mask.detach()
    outs_m = torch.softmax(rows(mask_d, out_idx), dim=-1) * wsel
    ins_m = torch.softmax(rows(mask_d, in_idx), dim=-1) * wsel
    sim = torch.bmm(outs, ins.detach().transpose(1, 2))
    sim_mask = torch.bmm(outs_m, ins_m.transpose(1, 2))
    return sim, sim_mask, count, mag_fg


def field_loss(seg_map: torch.Tensor, dense_ft: torch.Tensor, mask: torch.Tensor,
               label_with_bg: torch.Tensor, cfg: FieldLossConfig = FieldLossConfig(),
               generator: torch.Generator | None = None,
               draws: torch.Tensor | None = None,
               group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """BEACON loss.

    seg_map (N, H, W, C) raw logits; dense_ft (N, H, W, F) dense decoder
    features; mask (N, H, W, C) soft pseudo-label; label_with_bg (N, C)
    image labels with the background channel.  draws: optional
    (N, C-1, H, W) uniform scores of the boundary-pixel sampling, drawn
    from ``generator`` when None.  group: a data-parallel group: the draws
    are this rank's rows of the global batch's and the sum over pairs is
    divided by the global N (this rank's share).  Returns (loss, mag_fg):
    the scalar loss and the summed foreground gradient magnitude
    (N, H, W)."""
    n, h, w, c = seg_map.shape
    if draws is None:
        draws = draw_rows((n, c - 1, h, w), generator, group, device=seg_map.device)
    sim, sim_mask, count, mag_fg = pair_similarities(seg_map, dense_ft, mask, label_with_bg,
                                                     cfg, draws)
    per_pair = _pair_loss(sim, sim_mask, axis=1) + _pair_loss(sim, sim_mask, axis=0)
    per_pair = torch.where(count > cfg.k, per_pair, 0.0)
    return per_pair.sum() / (n * world(group)), mag_fg
