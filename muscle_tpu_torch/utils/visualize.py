"""CAM overlays (port of ``muscle_tpu/utils/visualize.py``): the classic
JET colormap in numpy, blended over the image; PNGs through PIL."""

from __future__ import annotations

import numpy as np


def jet_colormap(values: np.ndarray) -> np.ndarray:
    """values in [0, 1] -> (..., 3) uint8 RGB, classic JET."""
    v = np.clip(values, 0.0, 1.0)
    four = 4.0 * v
    r = np.clip(np.minimum(four - 1.5, -four + 4.5), 0, 1)
    g = np.clip(np.minimum(four - 0.5, -four + 3.5), 0, 1)
    b = np.clip(np.minimum(four + 0.5, -four + 2.5), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def show_cam_on_image(img: np.ndarray, mask: np.ndarray, heat_weight: float = 0.5,
                      img_weight: float = 0.5) -> np.ndarray:
    """img: (H, W, 3) uint8; mask: (H, W) in [0, 1] -> uint8 overlay."""
    heat = jet_colormap(mask).astype(np.float32)
    out = heat * heat_weight + img.astype(np.float32) * img_weight
    return np.clip(out, 0, 255).astype(np.uint8)


def save_overlay(path: str, img: np.ndarray, mask: np.ndarray, **kw) -> np.ndarray:
    from PIL import Image

    out = show_cam_on_image(img, mask, **kw)
    Image.fromarray(out).save(path)
    return out
