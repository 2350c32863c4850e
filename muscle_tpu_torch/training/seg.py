"""MuSCLe segmentation training step (port of ``muscle_tpu/training/seg.py``):
cross-entropy on the argmax of the soft pseudo-mask plus lamb x the BEACON
field loss, the gradients clipped to a global norm of 9, then Adam (lr
1e-5, L2 1e-5 at the CLI's defaults).

The model runs in train mode (batch statistics, drop-connect) with the
plain MBConv blocks under autograd: the MBConv kernel has no backward.

compute_dtype: float32, or bfloat16 as the JAX package's
``MuSCLe(dtype=jnp.bfloat16)`` trains (``training/mcl.py`` says how): the
cross entropy then takes the bf16 seg map, BEACON its bf16 maps with
float32 draws, and the gradients of the float32 parameters are float32,
their global-norm clip too.  Metrics come back float32.

group: a data-parallel process group, as in ``training/mcl.py``: global
BN statistics, drop-connect and BEACON draws, the CE's mean over the
global batch's pixels, BEACON's sum over the global image count, the
gradients summed over the ranks before the clip (which sees the global
norm), and global metrics.
"""

from __future__ import annotations

import dataclasses

import torch

from muscle_tpu_torch.core.cam_norm import attach_bg_channel
from muscle_tpu_torch.losses.beacon import FieldLossConfig, field_loss
from muscle_tpu_torch.parallel.mesh import all_reduce_sum, batch_mean
from muscle_tpu_torch.training.liveness import term_liveness
from muscle_tpu_torch.training.mcl import decode_image
from muscle_tpu_torch.training.state import batch_stats_train, minimize


@dataclasses.dataclass(frozen=True)
class SegConfig:
    lamb: float = 5e-2  # BEACON weight (--lamb)
    step: int = 7
    k: int = 128
    beta: float = 1e2
    clip_norm: float = 9.0
    num_classes: int = 21  # with the background; the model head's and pack_mask's


def _dequant_batch(batch: dict, num_classes: int | None = None,
                   compute_dtype: torch.dtype = torch.float32) -> dict:
    """The batch as the losses take it: the image decoded and normalised
    (any upload format, ``decode_image``), a uint8 mask mapped back to
    [0, 1] (/ 255), and a packed mask (``mask`` (N, H, W, K) +
    ``mask_idx`` (N, K), ``VOC12SegDataset`` pack_mask) added back into the
    dense (N, H, W, num_classes) stack.  Pad slots carry id 0 and zero
    values: the scatter adds, so they leave the background as it is.
    Float batches pass through.  The image comes out in ``compute_dtype``
    (the model's input), the mask float32."""
    out = dict(batch, img=decode_image(batch, "img").to(compute_dtype))
    out.pop("img_y", None)
    out.pop("img_c", None)
    if batch["mask"].dtype == torch.uint8:
        out["mask"] = batch["mask"].to(torch.float32) / 255.0
    if "mask_idx" in out:
        if num_classes is None:
            num_classes = batch["label"].shape[-1] + 1
        packed = out["mask"].to(torch.float32)
        idx = out.pop("mask_idx").to(torch.int64)[:, None, None, :].expand(packed.shape)
        dense = torch.zeros((*packed.shape[:-1], num_classes), dtype=torch.float32,
                            device=packed.device)
        out["mask"] = dense.scatter_add_(-1, idx, packed)
    return out


def cross_entropy(seg_logits: torch.Tensor, hard_mask: torch.Tensor,
                  group=None) -> torch.Tensor:
    """Mean over pixels of -log softmax(logits)[label]: NHWC logits, NHW
    int labels (this rank's share of the global batch's mean with a
    data-parallel ``group``)."""
    logp = torch.log_softmax(seg_logits, dim=-1)
    return -batch_mean(torch.gather(logp, -1, hard_mask[..., None]), group)


def _terms(forward, batch: dict, cfg: SegConfig, generator, draws,
           group=None) -> dict[str, torch.Tensor]:
    """The two loss terms (this rank's shares with a ``group``) from a
    train-mode ``forward(x, mode=..., generator=...)`` on a dequantised
    batch."""
    seg_map, dense_ft = forward(batch["img"], mode="seg", generator=generator)
    hard_mask = torch.argmax(batch["mask"], dim=-1)
    out = {"seg": cross_entropy(seg_map, hard_mask, group)}
    if cfg.lamb > 0:
        flc = FieldLossConfig(num_classes=seg_map.shape[-1], k=cfg.k, step=cfg.step,
                              beta=cfg.beta)
        out["beacon"], _ = field_loss(seg_map, dense_ft, batch["mask"],
                                      attach_bg_channel(batch["label"]), flc, generator, draws,
                                      group)
    return out


def seg_train_step(model, opt: torch.optim.Optimizer, batch: dict, cfg: SegConfig = SegConfig(),
                   generator: torch.Generator | None = None,
                   draws: torch.Tensor | None = None,
                   compute_dtype: torch.dtype = torch.float32,
                   group=None) -> dict[str, torch.Tensor]:
    """One step: puts ``model`` (MuSCLe, mode 'dec') in train mode, updates
    its parameters and BN statistics.  batch: img (or img_y/img_c), mask
    (N, H, W, C) soft (or packed with mask_idx), label (N, 20), on the
    model's device.  ``generator`` feeds drop-connect and BEACON's
    sampling; draws: optional (N, C-1, H, W) BEACON scores in its place
    (this rank's rows with a ``group``).
    Returns the detached metrics (float32 0-d tensors): loss, loss_seg,
    loss_beacon and grad_norm (before clipping)."""
    model.train()
    t = _terms(model, _dequant_batch(batch, cfg.num_classes, compute_dtype), cfg, generator,
               draws, group)
    beacon = t.get("beacon", torch.zeros((), device=t["seg"].device))
    loss = t["seg"] + cfg.lamb * beacon
    gnorm = minimize(opt, loss, clip_norm=cfg.clip_norm, group=group)
    shares = all_reduce_sum(torch.stack([v.detach().to(torch.float32)
                                         for v in (loss, t["seg"], beacon)]), group)
    return dict(zip(("loss", "loss_seg", "loss_beacon"), shares.unbind()),
                grad_norm=gnorm.detach().to(torch.float32))


def seg_term_grad_norms(model, batch: dict, cfg: SegConfig = SegConfig(),
                        generator: torch.Generator | None = None,
                        draws: torch.Tensor | None = None, return_values: bool = False,
                        compute_dtype: torch.dtype = torch.float32, method: str = "jacrev"):
    """Per-term liveness of 'seg' (CE) and 'beacon' over the model's
    trained parameters (``training/liveness.py``): gradient norms
    ('jacrev') or |directional derivatives| along seeded random tangents
    ('jvp'), from one train-mode forward whose BN statistics are not
    updated.
    return_values: also the terms' values, which tell a dead path (value
    nonzero, liveness 0) from BEACON not engaged on the batch (value 0:
    no class had more than k valid boundary pixels).  Parameters,
    statistics and the mode are left as they were."""
    names = {id(p): n for n, p in model.named_parameters()}
    params = {names[id(p)]: p for p in model.trained_parameters()}
    batch = _dequant_batch(batch, cfg.num_classes, compute_dtype)
    keys = ["beacon", "seg"] if cfg.lamb > 0 else ["seg"]

    def stacked(p):
        fwd = lambda x, **kw: torch.func.functional_call(model, p, (x,), kw)  # noqa: E731
        d = _terms(fwd, batch, cfg, generator, draws)
        return torch.stack([d[k] for k in keys])

    with batch_stats_train(model):
        values, vals = term_liveness(stacked, len(keys), params, method)
    norms = {k: float(v) for k, v in zip(keys, vals)}
    if return_values:
        return norms, {k: float(v) for k, v in zip(keys, values)}
    return norms
