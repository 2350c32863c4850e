"""Host-side image transforms, numpy and PIL, deterministic through
explicit numpy Generators (port of ``muscle_tpu/data/transforms.py``).

Every random transform draws from its ``rng`` in the JAX package's order,
so one seed gives the same crops, jitters and erasures in both packages.
PIL is imported inside the functions that need it, so the package imports
where Pillow is absent.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([[[0.485, 0.456, 0.406]]], dtype=np.float64)
IMAGENET_STD = np.array([[[0.229, 0.224, 0.225]]], dtype=np.float64)
# the nearest uint8 to the mean: the pad and erase fill of the uint8
# (device-normalised) pipeline, which normalises on the device to
# |x| <= 0.5/255/std ~ 0.009 where the reference has exactly 0
IMAGENET_MEAN_U8 = np.round(IMAGENET_MEAN[0, 0] * 255.0).astype(np.uint8)


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


def denorm_to_uint8(img: np.ndarray) -> np.ndarray:
    """Inverse of ``color_norm``, for visualisation."""
    x = (img * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return np.clip(x, 0, 255).astype(np.uint8)


def random_resize_long(img, min_long: int, max_long: int, rng: np.random.Generator):
    """Resize a PIL image so its long side is uniform in [min_long,
    max_long] (bicubic)."""
    from PIL import Image

    target_long = int(rng.integers(min_long, max_long + 1))
    w, h = img.size
    if w < h:
        shape = (int(round(w * target_long / h)), target_long)
    else:
        shape = (target_long, int(round(h * target_long / w)))
    return img.resize(shape, resample=Image.BICUBIC)


def random_crop(arr: np.ndarray, cropsize: int, rng: np.random.Generator,
                extra: np.ndarray | None = None, fill=0.0):
    """Random crop of an HWC array (and ``extra``, cropped jointly), padding
    where the image is smaller than the crop.  Float inputs give float32,
    uint8 stays uint8; ``fill`` pads the first array only (``extra``, a
    mask, pads with 0)."""
    h, w = arr.shape[:2]
    ch, cw = min(cropsize, h), min(cropsize, w)
    w_space, h_space = w - cropsize, h - cropsize
    if w_space > 0:
        cont_left, img_left = 0, int(rng.integers(0, w_space + 1))
    else:
        cont_left, img_left = int(rng.integers(0, -w_space + 1)), 0
    if h_space > 0:
        cont_top, img_top = 0, int(rng.integers(0, h_space + 1))
    else:
        cont_top, img_top = int(rng.integers(0, -h_space + 1)), 0

    def place(a: np.ndarray, fill_value=0.0) -> np.ndarray:
        dt = a.dtype if a.dtype == np.uint8 else np.float32
        out = np.full((cropsize, cropsize, a.shape[-1]), fill_value, dt)
        out[cont_top: cont_top + ch, cont_left: cont_left + cw] = a[
            img_top: img_top + ch, img_left: img_left + cw]
        return out

    if extra is None:
        return place(arr, fill)
    return place(arr, fill), place(extra)


def color_jitter(img, rng: np.random.Generator, brightness: float = 0.2,
                 contrast: float = 0.2, saturation: float = 0.2, hue: float = 0.1):
    """torchvision-style ColorJitter of a PIL image: the enhance ops in a
    random order and an HSV hue shift."""
    from PIL import Image, ImageEnhance

    ops = []
    if brightness > 0:
        f = float(rng.uniform(1 - brightness, 1 + brightness))
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f2 = float(rng.uniform(1 - contrast, 1 + contrast))
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
    if saturation > 0:
        f3 = float(rng.uniform(1 - saturation, 1 + saturation))
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
    if hue > 0:
        shift = float(rng.uniform(-hue, hue))

        def hue_op(im):
            hsv = np.array(im.convert("HSV"))
            hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(shift * 255)) % 256
            return Image.fromarray(hsv, "HSV").convert("RGB")

        ops.append(hue_op)
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return img


def random_erasing(arr: np.ndarray, rng: np.random.Generator, p: float = 0.5,
                   scale: tuple[float, float] = (0.02, 0.2),
                   ratio: tuple[float, float] = (0.3, 3.3), value=0.0) -> np.ndarray:
    """torchvision RandomErasing: with probability p, set a random
    rectangle of the HWC array to ``value``."""
    if rng.random() >= p:
        return arr
    h, w = arr.shape[:2]
    area = h * w
    for _ in range(10):
        target = float(rng.uniform(*scale)) * area
        aspect = float(np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1]))))
        eh = int(round(np.sqrt(target * aspect)))
        ew = int(round(np.sqrt(target / aspect)))
        if eh < h and ew < w:
            top = int(rng.integers(0, h - eh + 1))
            left = int(rng.integers(0, w - ew + 1))
            arr = arr.copy()
            arr[top: top + eh, left: left + ew] = value
            return arr
    return arr


def hflip(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr[:, ::-1])


def _intersection(coord1, coord2):
    """Overlap of two (top, left, h, w) crops: its coordinates relative to
    each crop, and absolute as (left, top, h, w); Nones when disjoint."""
    t1, l1, h1, w1 = coord1
    t2, l2, h2, w2 = coord2
    top, left = max(t1, t2), max(l1, l2)
    bot, right = min(t1 + h1, t2 + h2), min(l1 + w1, l2 + w2)
    if bot - top <= 0 or right - left <= 0:
        return None, None, None
    hi, wi = bot - top, right - left
    return (top - t1, left - l1, hi, wi), (top - t2, left - l2, hi, wi), (left, top, hi, wi)


def two_views(img, rng: np.random.Generator, view_size: tuple[int, int] = (224, 224)):
    """Two random overlapping crops of a PIL image (resized to 448 x 448
    first when a side is shorter) and their overlap: (view1, view2,
    rel_coord1, rel_coord2, ori_coord)."""
    from PIL import Image

    w, h = img.size
    if w < 448 or h < 448:
        img = img.resize((448, 448), resample=Image.BILINEAR)
        w, h = img.size
    th, tw = view_size
    while True:
        i1 = int(rng.integers(0, h - th + 1))
        j1 = int(rng.integers(0, w - tw + 1))
        i2 = int(rng.integers(0, h - th + 1))
        j2 = int(rng.integers(0, w - tw + 1))
        rel1, rel2, ori = _intersection((i1, j1, th, tw), (i2, j2, th, tw))
        if rel1 is not None:
            break
    view1 = img.crop((j1, i1, j1 + tw, i1 + th))
    view2 = img.crop((j2, i2, j2 + tw, i2 + th))
    return view1, view2, rel1, rel2, ori


def cutout(arr: np.ndarray, mask: np.ndarray, rng: np.random.Generator,
           mask_size: int = 66, p: float = 0.5) -> tuple[np.ndarray, np.ndarray]:
    """Joint image and mask cutout: with probability p, zero a
    mask_size square centred at a random point."""
    if rng.random() > p:
        return arr, mask
    h, w = arr.shape[:2]
    half = mask_size // 2
    cy = int(rng.integers(0, h + (1 if mask_size % 2 == 0 else 0)))
    cx = int(rng.integers(0, w + (1 if mask_size % 2 == 0 else 0)))
    y0, x0 = max(0, cy - half), max(0, cx - half)
    y1, x1 = min(h, cy - half + mask_size), min(w, cx - half + mask_size)
    arr = arr.copy()
    mask = mask.copy()
    arr[y0:y1, x0:x1] = 0
    mask[y0:y1, x0:x1] = 0
    return arr, mask


def rot90_with_mask(arr: np.ndarray, mask: np.ndarray, rng: np.random.Generator
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Random +-90 degree rotation of an image and its mask, each with
    probability 1/8 (the reference's Rot90WithMask)."""
    p = rng.random()
    if p < 0.125:
        return np.rot90(arr, 1, (0, 1)).copy(), np.rot90(mask, 1, (0, 1)).copy()
    if p > 0.875:
        return np.rot90(arr, 3, (0, 1)).copy(), np.rot90(mask, 3, (0, 1)).copy()
    return arr, mask


def resize_soft_mask(mask: np.ndarray, target_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (H, W, C) float soft mask, channel by channel
    through PIL's float ('F') images."""
    from PIL import Image

    th, tw = target_hw
    out = np.empty((th, tw, mask.shape[-1]), np.float32)
    for c in range(mask.shape[-1]):
        im = Image.fromarray(mask[..., c].astype(np.float32), mode="F")
        out[..., c] = np.asarray(im.resize((tw, th), resample=Image.BILINEAR))
    return out
