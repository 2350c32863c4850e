"""MCL contrastive-classifier training steps (port of
``muscle_tpu/training/mcl.py``).  Each iteration takes up to two optimizer
steps, as the reference does:

  step A (``mcl_train_step``): the full image in mode 'cam', train mode:
      focal + soft margin + LSEP + ER top-k (+ IMC from epoch 4); the BN
      statistics move.
  step B (``mcl_views_step``), from epoch 8: view 1 in mode 'pix' in eval
      mode with gradients, view 2 without: PixPro (+ EMD from epoch 12);
      the BN statistics stay.

Batches are dicts of tensors on the model's device, in any of the
dataset's upload formats (``decode_image``).

compute_dtype: float32, or bfloat16 as the JAX package's
``MuSCLe(dtype=jnp.bfloat16)`` trains: the image is decoded in float32
and cast at the model's input (where Flax's first ``nn.Conv`` casts it),
the model computes in bf16 on its float32 parameters
(``models/layers.py``), the losses take the dtypes the model hands them
(jnp's promotions: the labels and the CAM normalisers' outputs against
float32 promote to float32), and the float32 parameters receive float32
gradients through the casts' backward.  Metrics come back float32.
"""

from __future__ import annotations

import dataclasses

import torch

from muscle_tpu_torch.core.cam_norm import attach_bg_channel, cam_maxnorm, cam_softmaxnorm
from muscle_tpu_torch.core.ycbcr import ycbcr420_to_rgb
from muscle_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from muscle_tpu_torch.losses import (
    dynamic_matching_emd,
    er_topk_loss,
    focal_loss,
    image_level_contrast,
    lsep_loss,
    pixpro_loss,
    soft_margin_loss,
)
from muscle_tpu_torch.training.liveness import term_liveness
from muscle_tpu_torch.training.state import batch_stats_train, minimize


@dataclasses.dataclass(frozen=True)
class MCLConfig:
    use_imc: bool = False  # epoch >= 4
    use_pixpro: bool = False  # epoch >= 8
    use_emd: bool = False  # epoch >= 12


def _imagenet_norm(rgb: torch.Tensor) -> torch.Tensor:
    """[0, 255] float RGB -> ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN[0, 0], dtype=torch.float32, device=rgb.device)
    std = torch.tensor(IMAGENET_STD[0, 0], dtype=torch.float32, device=rgb.device)
    return (rgb / 255.0 - mean) / std


def norm_on_device(img: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalise a uint8 batch on its device; float batches were
    normalised on the host and pass through."""
    if img.dtype != torch.uint8:
        return img
    return _imagenet_norm(img.to(torch.float32))


def decode_image(batch: dict, key: str) -> torch.Tensor:
    """The normalised float32 NHWC image batch ``key`` in whichever upload
    format the batch carries: ``{key}_y`` + ``{key}_c`` 4:2:0 planes,
    ``{key}`` uint8 RGB, or ``{key}`` float already normalised."""
    if key + "_y" in batch:
        return _imagenet_norm(ycbcr420_to_rgb(batch[key + "_y"], batch[key + "_c"]))
    return norm_on_device(batch[key])


def _terms_a(forward, img: torch.Tensor, label: torch.Tensor, cfg: MCLConfig,
             generator) -> dict[str, torch.Tensor]:
    """Step A's loss terms from a train-mode ``forward(x, mode=...,
    generator=...)``."""
    raw_cams, raw_sgcs, emb, logits = forward(img, mode="cam", generator=generator)
    lb = attach_bg_channel(label)[:, None, None, :]
    probs_fg = torch.sigmoid(logits[:, 1:])
    cams = cam_softmaxnorm(raw_cams).detach() * lb
    sgcs = cam_softmaxnorm(raw_sgcs) * lb
    out = {
        "focal": focal_loss(probs_fg, label),
        "softmargin": soft_margin_loss(logits[:, 1:], label),
        "pair": lsep_loss(probs_fg, label).mean(),
        "er": er_topk_loss(cams, sgcs, label.sum()),
    }
    if cfg.use_imc:
        out["imc"] = image_level_contrast(emb, label)
    return out


def _unit(x: torch.Tensor) -> torch.Tensor:
    """F.normalize over the class axis."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _terms_b(forward, view1: torch.Tensor, view2: torch.Tensor, batch: dict, cfg: MCLConfig,
             generator, crop_frac) -> dict[str, torch.Tensor]:
    """Step B's loss terms: view 1 through ``forward`` with gradients,
    view 2 without."""
    lb = attach_bg_channel(batch["label"])[:, None, None, :]
    _, sgcs_vw1 = forward(view1, mode="pix", generator=generator)
    with torch.no_grad():
        cams_vw2, _ = forward(view2, mode="pix", generator=generator)
    cams_vw2 = cams_vw2.detach()
    out = {"pixpro": pixpro_loss(cam_maxnorm(sgcs_vw1) * lb, cam_maxnorm(cams_vw2) * lb,
                                 batch["coord1"], batch["coord2"])}
    if cfg.use_emd:
        out["emd"] = dynamic_matching_emd(
            _unit(cam_softmaxnorm(sgcs_vw1)), _unit(cam_softmaxnorm(cams_vw2)),
            batch["coord1"], batch["coord2"], crop_frac=crop_frac, generator=generator)
    return out


def _metrics(terms: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The detached terms as float32 0-d tensors."""
    return {k: v.detach().to(torch.float32) for k, v in terms.items()}


def mcl_train_step(model, opt: torch.optim.Optimizer, batch: dict, cfg: MCLConfig,
                   generator: torch.Generator | None = None,
                   compute_dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Step A: puts ``model`` in train mode, updates its parameters and BN
    statistics; ``generator`` feeds drop-connect.  Returns the detached
    metrics (float32 0-d tensors)."""
    model.train()
    t = _terms_a(model, decode_image(batch, "img").to(compute_dtype), batch["label"], cfg,
                 generator)
    loss = t["focal"] + t["softmargin"] + t["pair"] + t["er"]
    if cfg.use_imc:
        loss = loss + t["imc"]
    minimize(opt, loss)
    zero = torch.zeros((), device=loss.device)
    return _metrics({"loss": loss, "loss_focal": t["focal"], "loss_softmargin": t["softmargin"],
                     "loss_pair": t["pair"], "loss_er": t["er"],
                     "loss_imc": t.get("imc", zero)})


def mcl_views_step(model, opt: torch.optim.Optimizer, batch: dict, cfg: MCLConfig,
                   generator: torch.Generator | None = None,
                   crop_frac: torch.Tensor | None = None,
                   compute_dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Step B: puts ``model`` in eval mode (frozen BN statistics, no
    drop-connect, as the reference's model.eval()) and keeps gradients for
    view 1.  ``crop_frac``: EMD's (N, 2) crop fractions, drawn from
    ``generator`` when None."""
    model.eval()
    t = _terms_b(model, decode_image(batch, "view1").to(compute_dtype),
                 decode_image(batch, "view2").to(compute_dtype), batch, cfg, generator,
                 crop_frac)
    loss = t["pixpro"]
    if cfg.use_emd:
        loss = loss + t["emd"]
    minimize(opt, loss)
    zero = torch.zeros((), device=loss.device)
    return _metrics({"loss_pixpro": t["pixpro"], "loss_emd": t.get("emd", zero)})


def mcl_term_grad_norms(model, batch: dict, generator: torch.Generator | None = None,
                        cfg: MCLConfig = MCLConfig(True, True, True),
                        views_train_mode: bool = False,
                        method: str = "jacrev",
                        compute_dtype: torch.dtype = torch.float32) -> dict[str, float]:
    """Per-term liveness over the model's trained parameters
    (``training/liveness.py``): gradient norms ('jacrev') or
    |directional derivatives| along seeded random tangents ('jvp').  EMD's
    crop fractions are drawn from ``generator``.  The batch
    carries img/label for step A's terms and, when ``cfg.use_pixpro``,
    view1/view2/coord1/coord2 for step B's.  Parameters, BN statistics and
    the train/eval mode are left as they were.

    views_train_mode: probe step B's terms with train-mode BN.  The real
    step B runs in eval mode; on an uncalibrated model (identity running
    statistics) eval-mode BN flattens the maxnormed maps and PixPro/EMD
    show zero gradients that say nothing about the graph."""
    names = {id(p): n for n, p in model.named_parameters()}
    params = {names[id(p)]: p for p in model.trained_parameters()}
    imgs = {k: decode_image(batch, k).to(compute_dtype) for k in ("img", "view1", "view2")
            if k in batch or k + "_y" in batch}

    def terms_a(p):
        model.train()
        fwd = lambda x, **kw: torch.func.functional_call(model, p, (x,), kw)  # noqa: E731
        return _terms_a(fwd, imgs["img"], batch["label"], cfg, generator)

    def terms_b(p):
        model.train(views_train_mode)
        fwd = lambda x, **kw: torch.func.functional_call(model, p, (x,), kw)  # noqa: E731
        return _terms_b(fwd, imgs["view1"], imgs["view2"], batch, cfg, generator, None)

    makers = [(terms_a, ["er", "focal", "pair", "softmargin"] + ["imc"] * cfg.use_imc)]
    if cfg.use_pixpro and "view1" in imgs:
        makers.append((terms_b, ["pixpro"] + ["emd"] * cfg.use_emd))
    norms: dict[str, float] = {}
    with batch_stats_train(model):  # the makers set each term's mode
        for maker, keys in makers:
            keys = sorted(keys)

            def stacked(p, maker=maker, keys=keys):
                d = maker(p)
                return torch.stack([d[k] for k in keys])

            _, vals = term_liveness(stacked, len(keys), params, method)
            norms.update({k: float(v) for k, v in zip(keys, vals)})
    return norms
