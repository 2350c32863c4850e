"""Host-side image helpers (port of the parts of
``muscle_tpu/data/transforms.py`` that CAM generation uses).

PIL is imported inside the functions that need it, so the package imports
where Pillow is absent.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([[[0.485, 0.456, 0.406]]], dtype=np.float64)
IMAGENET_STD = np.array([[[0.229, 0.224, 0.225]]], dtype=np.float64)


def color_norm(img: np.ndarray) -> np.ndarray:
    """ImageNet mean/std normalisation of an HWC uint8 image."""
    return ((np.asarray(img) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def __getattr__(name: str):
    """``BICUBIC`` (the reference's multi-scale resize) and ``BILINEAR``:
    PIL's resample constants, looked up on first use."""
    if name in ("BICUBIC", "BILINEAR"):
        from PIL import Image

        return getattr(Image, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def image_size(img) -> tuple[int, int]:
    """(w, h) of a PIL image or an HWC array, PIL's convention."""
    if hasattr(img, "size") and not isinstance(img, np.ndarray):
        return img.size
    h, w = np.asarray(img).shape[:2]
    return w, h


def to_pil(img):
    """A PIL image for a PIL image or an HWC uint8 array."""
    from PIL import Image

    if isinstance(img, Image.Image):
        return img
    return Image.fromarray(np.asarray(img, np.uint8)[..., :3])
