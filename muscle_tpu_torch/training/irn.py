"""IRN training (port of ``muscle_tpu/training/irn.py``): the inter-pixel
affinity and displacement-field losses of the reference's
AffinityDisplacementLoss, normalised as the IRN lineage's trainer does
(mask sums over the whole batch; the displacement terms divide by
2 * sum(mask), the |.| having summed the (dy, dx) channels):

  aff     = 1 - max(sigmoid(edge) along the pixel pair's path)
  L_pos   = sum(bg_pos * -log(aff + 1e-5)) / (sum(bg_pos) + 1e-5) / 2 + fg term / 2
  L_neg   = sum(neg * -log(1 + 1e-5 - aff)) / (sum(neg) + 1e-5)
  L_dp_fg = sum(fg_pos * |(dp_src - dp_dst) - offset|) / (2 sum(fg_pos) + 1e-5)
  L_dp_bg = sum(bg_pos * |dp_src - dp_dst|) / (2 sum(bg_pos) + 1e-5)
  total   = (L_pos + L_neg) / 2 + (L_dp_fg + L_dp_bg) / 2

The recipe (``make_irn_sgd``): SGD with momentum 0.9 and L2 weight decay
on the two heads only, the ResNet-50 frozen, the learning rate
poly-decayed (power 0.9) over the run by the caller.  The JAX package's
CLI differs on both counts (ROADMAP Queue C): its learning rate is fixed
at 1 and its decay also shrinks the frozen backbone.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from muscle_tpu_torch.core.bitpack import unpackbits_last
from muscle_tpu_torch.ops.random_walk import PathIndex
from muscle_tpu_torch.training.mcl import decode_image
from muscle_tpu_torch.training.state import minimize


@dataclasses.dataclass(frozen=True)
class IRNTrainConfig:
    crop_size: int = 512
    stride: int = 4
    radius: int = 5

    @property
    def grid(self) -> int:
        return self.crop_size // self.stride


@functools.lru_cache(maxsize=4)
def _grid_path_index(cfg: IRNTrainConfig) -> PathIndex:
    return PathIndex(cfg.radius, (cfg.grid, cfg.grid))


@functools.lru_cache(maxsize=8)
def _tables(pi: PathIndex, device: torch.device):
    """The path index's tables on ``device``, built once: the path groups
    (n_dirs, plen, P), src (P,), dst (D, P) and the (D, 1, 2) offsets."""
    paths = [torch.from_numpy(g).to(device) for g in pi.path_indices]
    src = torch.from_numpy(pi.src_indices).to(device)
    dst = torch.from_numpy(pi.dst_indices).to(device)
    offsets = torch.tensor(pi.search_dst, dtype=torch.float32, device=device)[:, None, :]
    return paths, src, dst, offsets


def path_affinity(edge_sigmoid_flat: torch.Tensor, pi: PathIndex) -> torch.Tensor:
    """1 - max(edge along each pair's path): (..., V) -> (..., D, P).  The
    max's gradient is shared among tied path pixels, as JAX's is."""
    paths = _tables(pi, edge_sigmoid_flat.device)[0]
    return torch.cat([1.0 - torch.amax(edge_sigmoid_flat[..., ind], dim=-2) for ind in paths],
                     dim=-2)


def pair_displacement(dp_flat: torch.Tensor, pi: PathIndex) -> torch.Tensor:
    """dp_flat (..., V, 2) displacement field -> (..., D, P, 2) pairwise
    differences dp[src] - dp[dst]."""
    _, src, dst, _ = _tables(pi, dp_flat.device)
    return dp_flat[..., src, :][..., None, :, :] - dp_flat[..., dst, :]


def irn_losses(edge_out: torch.Tensor, dp_out: torch.Tensor, bg_pos: torch.Tensor,
               fg_pos: torch.Tensor, neg: torch.Tensor, pi: PathIndex):
    """edge_out (N, V) logits, dp_out (N, V, 2), masks (N, D, P).  Returns
    (total, metrics)."""
    aff = path_affinity(torch.sigmoid(edge_out), pi)
    pos_loss = -torch.log(aff + 1e-5)
    neg_loss = -torch.log(1.0 + 1e-5 - aff)

    def masked_sum_norm(loss, mask, denom_scale=1.0):
        return torch.sum(loss * mask) / (denom_scale * torch.sum(mask) + 1e-5)

    l_bg_pos = masked_sum_norm(pos_loss, bg_pos)
    l_fg_pos = masked_sum_norm(pos_loss, fg_pos)
    l_neg = masked_sum_norm(neg_loss, neg)

    pdisp = pair_displacement(dp_out, pi)  # (N, D, P, 2)
    offsets = _tables(pi, dp_out.device)[3]
    l_dp_fg = masked_sum_norm(torch.abs(pdisp - offsets).sum(-1), fg_pos, denom_scale=2.0)
    l_dp_bg = masked_sum_norm(torch.abs(pdisp).sum(-1), bg_pos, denom_scale=2.0)

    l_pos = l_bg_pos / 2 + l_fg_pos / 2
    total = (l_pos + l_neg) / 2 + (l_dp_fg + l_dp_bg) / 2
    return total, {"loss": total, "loss_aff_pos": l_pos, "loss_aff_neg": l_neg,
                   "loss_dp_fg": l_dp_fg, "loss_dp_bg": l_dp_bg}


def make_irn_sgd(model, lr: float, weight_decay: float) -> torch.optim.SGD:
    """SGD with momentum 0.9 and L2 decay over the heads only
    (``IRNNet.head_parameters``): the frozen backbone is neither updated
    nor decayed."""
    return torch.optim.SGD(model.head_parameters(), lr=lr, momentum=0.9,
                           weight_decay=weight_decay)


def _decode_mask(v: torch.Tensor, p_pairs: int) -> torch.Tensor:
    """A bit-packed (trailing P / 8), uint8 or float 0/1 mask as float32."""
    if v.dtype == torch.uint8 and v.shape[-1] * 8 == p_pairs:
        return unpackbits_last(v, p_pairs)
    return v.to(torch.float32)


def irn_train_step(model, opt: torch.optim.Optimizer, batch: dict,
                   cfg: IRNTrainConfig = IRNTrainConfig()) -> dict[str, torch.Tensor]:
    """One step of the raw two-head ``IRNNet`` (no flip fusion).  batch:
    img (N, S, S, 3) (or img_y/img_c) and bg_pos/fg_pos/neg (N, D, P)
    masks over the stride grid's path index (or bit-packed, (N, D, P/8)),
    on the model's device.  Returns the detached metrics."""
    model.train()
    pi = _grid_path_index(cfg)
    p_pairs = int(pi.src_indices.size)
    masks = [_decode_mask(batch[k], p_pairs) for k in ("bg_pos", "fg_pos", "neg")]
    edge_out, dp_out = model(decode_image(batch, "img"))  # (N, g, g, 1), (N, g, g, 2)
    n = edge_out.shape[0]
    total, metrics = irn_losses(edge_out.reshape(n, -1), dp_out.reshape(n, -1, 2), *masks, pi)
    minimize(opt, total)
    return {k: v.detach() for k, v in metrics.items()}
