"""In-training overlays (port of ``muscle_tpu/utils/train_vis.py``): the
reference's tensorboard image streams, as PNG files under
``<log_dir>/vis`` (and, given an event writer, as image summaries).

Every N iterations (and at step 1) a batch-1 eval-mode forward of the
batch's first image writes:

* MCL ('cam'): JET overlays of the maxnormed CAM and SGC of each labelled
  class (``step{S}_cls{c}_cam.png`` / ``_sgc.png``) and the input;
* seg: the argmax mask in VOC palette colours (``step{S}_seg.png``) and
  the input.

The model is put back in the mode it was in.  PIL is imported inside.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from muscle_tpu_torch.core.cam_norm import cam_maxnorm
from muscle_tpu_torch.data.transforms import color_norm, denorm_to_uint8
from muscle_tpu_torch.utils.visualize import save_overlay


def denorm_uint8(img: np.ndarray) -> np.ndarray:
    """Invert the ImageNet normalisation of one (H, W, 3) image."""
    return denorm_to_uint8(img)


def _first_image_u8(batch: dict) -> np.ndarray:
    """(H, W, 3) uint8 of the batch's first image, in any upload format."""
    if "img_y" in batch:
        from muscle_tpu_torch.core.ycbcr import ycbcr420_to_rgb

        y = torch.as_tensor(np.asarray(batch["img_y"][:1]))
        c = torch.as_tensor(np.asarray(batch["img_c"][:1]))
        rgb = ycbcr420_to_rgb(y, c)[0].numpy()
        return np.clip(np.round(rgb), 0, 255).astype(np.uint8)
    raw = np.asarray(batch["img"][0])
    return raw if raw.dtype == np.uint8 else denorm_to_uint8(raw)


class TrainVisualizer:
    """Args: model (MuSCLe), out_dir (created on the first dump), mode 'cam'
    (MCL training) or 'seg', every (period in iterations; <= 0 disables),
    tb (optional ``utils.tb_events.EventWriter``), compute_dtype (the
    training's: the forward runs in it, as the JAX package's bf16 model
    computes in bf16 whatever its input's dtype)."""

    def __init__(self, model, out_dir: str, mode: str = "cam", every: int = 25, tb=None,
                 compute_dtype: torch.dtype = torch.float32):
        self.model = model
        self.out_dir = out_dir
        self.mode = mode
        self.every = every
        self.tb = tb
        self.compute_dtype = compute_dtype

    def maybe_dump(self, step: int, batch: dict) -> None:
        if self.every <= 0 or (step % self.every and step != 1):
            return
        from PIL import Image

        os.makedirs(self.out_dir, exist_ok=True)
        img8 = _first_image_u8(batch)
        Image.fromarray(img8).save(os.path.join(self.out_dir, f"step{step}_img.png"))
        if self.tb is not None:
            self.tb.add_image("vis/input", img8, step)
        dev = next(self.model.parameters()).device
        x = torch.from_numpy(color_norm(img8)[None]).to(dev, self.compute_dtype)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                if self.mode == "cam":
                    cams, sgcs, _, _ = self.model(x, mode="cam")
                    cam = cam_maxnorm(cams)[0].float().cpu().numpy()
                    sgc = cam_maxnorm(sgcs)[0].float().cpu().numpy()
                else:
                    seg_map, _ = self.model(x, mode="seg")
                    mask = seg_map[0].argmax(dim=-1).cpu().numpy()
        finally:
            self.model.train(was_training)
        if self.mode == "cam":
            for c in np.nonzero(np.asarray(batch["label"][0]) > 1e-5)[0]:
                for name, m in (("cam", cam), ("sgc", sgc)):
                    ov = save_overlay(os.path.join(self.out_dir, f"step{step}_cls{c}_{name}.png"),
                                      img8, m[..., 1 + c])
                    if self.tb is not None:
                        self.tb.add_image(f"vis/cls{c}_{name}", ov, step)
        else:
            from muscle_tpu_torch.core.palette import voc_color_map

            rgb = voc_color_map()[mask].astype(np.uint8)
            Image.fromarray(rgb).save(os.path.join(self.out_dir, f"step{step}_seg.png"))
            if self.tb is not None:
                self.tb.add_image("vis/seg", rgb, step)
