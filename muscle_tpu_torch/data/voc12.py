"""VOC2012 lists, labels and the training datasets (port of
``muscle_tpu/data/voc12.py``): MCL (``VOC12ClsPixDataset``), IRN
(``VOC12AffinityDataset``) and segmentation (``VOC12SegDataset``).

Datasets yield fixed-shape numpy arrays, NHWC; all randomness flows through
the numpy Generator the loader passes to ``get``, in the JAX package's
order, so one seed gives bit-equal samples in both packages.  PIL is
imported inside the functions that decode images.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from muscle_tpu_torch.data import transforms as T

IMG_FOLDER_NAME = "JPEGImages"

VOC_CAT_LIST = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

# per-class instance counts, for inverse-frequency sample weights
VOC_CLASS_COUNTS = [
    590, 504, 705, 468, 714, 393, 1150, 1005, 1228, 267,
    613, 1188, 445, 492, 4155, 522, 300, 649, 503, 567,
]


def get_img_path(img_name: str, voc12_root: str) -> str:
    return os.path.join(voc12_root, IMG_FOLDER_NAME, img_name + ".jpg")


def load_img_name_list(dataset_path: str) -> list[str]:
    """Image ids from a list file."""
    with open(dataset_path) as f:
        lines = f.read().splitlines()
    return [line.split(" ")[0].split("/")[-1].split(".")[0] for line in lines if line]


def load_label_dict(cls_labels_path: str) -> dict[str, np.ndarray]:
    """{name: float32[20] multi-hot} (the reference's cls_labels.npy)."""
    return np.load(cls_labels_path, allow_pickle=True).item()


def load_label_from_xml(img_name: str, voc12_root: str) -> np.ndarray:
    """Multi-hot label from a VOC Annotations XML file."""
    from xml.dom import minidom

    doc = minidom.parse(os.path.join(voc12_root, "Annotations", img_name + ".xml"))
    label = np.zeros(20, np.float32)
    for el in doc.getElementsByTagName("name"):
        name = el.firstChild.data
        if name in VOC_CAT_LIST:
            label[VOC_CAT_LIST.index(name)] = 1.0
    return label


def build_cls_labels(name_list, voc12_root: str, out_path: str) -> dict:
    """Write the cls_labels.npy dict from the VOC XML annotations."""
    d = {n: load_label_from_xml(n, voc12_root) for n in name_list}
    np.save(out_path, d)
    return d


def class_frequency_sample_weights(labels: list[np.ndarray]) -> np.ndarray:
    """Per-image weight: n_images / the summed instance counts of the
    image's classes."""
    counts = np.asarray(VOC_CLASS_COUNTS, np.float64)
    n = len(labels)
    weights = np.empty(n, np.float64)
    for i, lab in enumerate(labels):
        weights[i] = n / max(counts[np.asarray(lab) > 0].sum(), 1.0)
    return weights


@dataclass
class VOC12ImageDataset:
    """Names and PIL images (and labels, given a label dict)."""

    name_list: list[str]
    voc12_root: str
    labels: dict[str, np.ndarray] | None = None

    def __len__(self) -> int:
        return len(self.name_list)

    def image(self, idx: int):
        from PIL import Image

        return Image.open(get_img_path(self.name_list[idx], self.voc12_root)).convert("RGB")

    def label(self, idx: int) -> np.ndarray:
        if self.labels is None:
            raise ValueError("this dataset was built without a label dict")
        return np.asarray(self.labels[self.name_list[idx]], np.float32)


@dataclass
class SBDImageDataset:
    """An image corpus without labels addressed by a name list (the
    reference's SBD / SBDMSF): images at ``<root>/<name>.jpg`` (names may
    carry subdirectories).  ``unit`` > 1 rounds each image's size to the
    nearest multiple of it (at least one unit) with a bicubic resize at
    decode, the reference SBDMSF's ``unit``."""

    name_list: list[str]
    root: str
    unit: int = 1

    def __len__(self) -> int:
        return len(self.name_list)

    def image(self, idx: int):
        from PIL import Image

        img = Image.open(os.path.join(self.root, self.name_list[idx] + ".jpg")).convert("RGB")
        if self.unit > 1:
            w, h = img.size
            rw = max(self.unit, int(round(w / self.unit) * self.unit))
            rh = max(self.unit, int(round(h / self.unit) * self.unit))
            if (rw, rh) != (w, h):
                img = img.resize((rw, rh), resample=T.BICUBIC)
        return img


class VOC12ClsPixDataset(VOC12ImageDataset):
    """MCL training set: an augmented full image and two overlapping views
    with their overlap coordinates.

    ``get(idx, rng)`` -> img (crop, crop, 3), view1/view2 (view, view, 3),
    coord1/coord2 (4,) int32 (row, col, h, w of the overlap in each view),
    label (20,) float32.  device_norm: uint8 images, normalised on the
    device, padded and erased with ``IMAGENET_MEAN_U8`` (float32
    host-normalised images otherwise).  upload='ycbcr420' (device_norm
    only): each image as ``{key}_y`` (H, W) and ``{key}_c`` (H/2, W/2, 2)
    uint8 planes."""

    def __init__(self, name_list, voc12_root, labels, crop_size: int = 448,
                 view_size: tuple[int, int] = (224, 224), device_norm: bool = False,
                 upload: str = "rgb"):
        super().__init__(name_list, voc12_root, labels)
        self.crop_size = crop_size
        self.view_size = view_size
        self.device_norm = device_norm
        _check_upload(upload, device_norm, crop_size)
        if upload == "ycbcr420" and (view_size[0] % 2 or view_size[1] % 2):
            raise ValueError(f"upload='ycbcr420' needs an even view_size, got {view_size}")
        self.upload = upload

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
        from PIL import Image

        img = self.image(idx)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        view1, view2, coord1, coord2, _ = T.two_views(img, rng, self.view_size)

        main = T.random_resize_long(img, 448, 768, rng)
        main = T.color_jitter(main, rng)
        if self.device_norm:
            fill = T.IMAGENET_MEAN_U8
            main = T.random_crop(np.asarray(main), self.crop_size, rng, fill=fill)
            main = T.random_erasing(main, rng, value=fill)

            def view_tf(v) -> np.ndarray:
                return np.asarray(T.color_jitter(v, rng), np.uint8)

            out_dtype = np.uint8
        else:
            main = T.color_norm(np.asarray(main))
            main = T.random_crop(main, self.crop_size, rng)
            main = T.random_erasing(main, rng)

            def view_tf(v) -> np.ndarray:
                return T.color_norm(np.asarray(T.color_jitter(v, rng)))

            out_dtype = np.float32

        out = {
            "img": main.astype(out_dtype),
            "view1": view_tf(view1).astype(out_dtype),
            "view2": view_tf(view2).astype(out_dtype),
            "coord1": np.asarray(coord1, np.int32),
            "coord2": np.asarray(coord2, np.int32),
            "label": self.label(idx),
        }
        if self.upload == "ycbcr420":
            from muscle_tpu_torch.core.ycbcr import rgb_to_ycbcr420

            for k in ("img", "view1", "view2"):
                out[k + "_y"], out[k + "_c"] = rgb_to_ycbcr420(out.pop(k))
        return out


def _check_upload(upload: str, device_norm: bool, crop_size: int) -> None:
    if upload not in ("rgb", "ycbcr420"):
        raise ValueError(f"upload must be 'rgb' or 'ycbcr420', got {upload!r}")
    if upload == "ycbcr420" and not device_norm:
        raise ValueError("upload='ycbcr420' requires device_norm=True")
    if upload == "ycbcr420" and crop_size % 2:
        raise ValueError(f"upload='ycbcr420' needs an even crop_size, got {crop_size}")


class VOC12AffinityDataset(VOC12ImageDataset):
    """IRN training set: a crop-padded image and the path-pair affinity
    masks of its pseudo-label PNG on the stride-``stride`` grid.

    ``get(idx, rng)`` -> img (crop, crop, 3) and bg_pos/fg_pos/neg (D, P)
    over the PathIndex of radius ``radius`` on the (crop / stride)^2 grid.
    device_norm: uint8 image (pad filled with ``IMAGENET_MEAN_U8``) and
    uint8 0/1 masks, decoded on the device by ``irn_train_step``;
    upload='ycbcr420': the image as img_y/img_c planes; pack_bits: the
    masks 8 pairs a byte (``core/bitpack.py``, exact)."""

    def __init__(self, name_list, voc12_root, labels, pseudo_label_root: str,
                 crop_size: int = 512, stride: int = 4, radius: int = 5,
                 min_scale: float = 0.5, max_scale: float = 1.5, device_norm: bool = False,
                 upload: str = "rgb", pack_bits: bool = False):
        super().__init__(name_list, voc12_root, labels)
        self.pseudo_label_root = pseudo_label_root
        self.crop_size = crop_size
        self.stride = stride
        self.radius = radius
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.device_norm = device_norm
        if pack_bits and not device_norm:
            raise ValueError("pack_bits requires device_norm=True")
        _check_upload(upload, device_norm, crop_size)
        self.upload = upload
        self.pack_bits = bool(pack_bits)
        from muscle_tpu_torch.ops.random_walk import PathIndex

        g = crop_size // stride
        self._pi = PathIndex(radius, (g, g))
        if self.pack_bits and self._pi.src_indices.size % 8:
            raise ValueError(f"pack_bits needs the pair-grid width P={self._pi.src_indices.size} "
                             "divisible by 8: use pack_bits=False for this "
                             "crop_size/stride/radius")

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
        from PIL import Image

        name = self.name_list[idx]
        img = self.image(idx)
        lab = Image.open(os.path.join(self.pseudo_label_root, name + ".png"))

        scale = float(rng.uniform(self.min_scale, self.max_scale))
        tw, th = round(img.size[0] * scale), round(img.size[1] * scale)
        img = img.resize((tw, th), resample=Image.BILINEAR)
        lab = lab.resize((tw, th), resample=Image.NEAREST)

        cs = self.crop_size
        if self.device_norm:
            arr = np.asarray(img)
            canvas = np.full((cs, cs, 3), T.IMAGENET_MEAN_U8, np.uint8)
        else:
            arr = T.color_norm(np.asarray(img))
            canvas = np.zeros((cs, cs, 3), np.float32)
        lab_arr = np.asarray(lab)
        lab_canvas = np.full((cs, cs), 255, np.uint8)  # pad = void
        ch, cw = min(th, cs), min(tw, cs)
        top = int(rng.integers(0, max(th - cs, 0) + 1))
        left = int(rng.integers(0, max(tw - cs, 0) + 1))
        canvas[:ch, :cw] = arr[top: top + ch, left: left + cw]
        lab_canvas[:ch, :cw] = lab_arr[top: top + ch, left: left + cw]
        if rng.random() < 0.5:
            canvas = T.hflip(canvas)
            lab_canvas = np.ascontiguousarray(lab_canvas[:, ::-1])

        # nearest downsample to the stride grid
        s = self.stride
        bg_pos, fg_pos, neg = self._affinity_masks(lab_canvas[s // 2:: s, s // 2:: s])
        if not self.device_norm:
            return {"img": canvas, "bg_pos": bg_pos, "fg_pos": fg_pos, "neg": neg}
        out = {"img": canvas, "bg_pos": bg_pos.astype(np.uint8),
               "fg_pos": fg_pos.astype(np.uint8), "neg": neg.astype(np.uint8)}
        if self.pack_bits:
            from muscle_tpu_torch.core.bitpack import packbits_last

            for k in ("bg_pos", "fg_pos", "neg"):
                out[k] = packbits_last(out[k])
        if self.upload == "ycbcr420":
            from muscle_tpu_torch.core.ycbcr import rgb_to_ycbcr420

            out["img_y"], out["img_c"] = rgb_to_ycbcr420(out.pop("img"))
        return out

    def _affinity_masks(self, small: np.ndarray):
        import torch

        from muscle_tpu_torch.ops.affinity_labels import affinity_labels_from_indices

        flat = torch.from_numpy(small.reshape(-1).astype(np.int64))
        return tuple(m.numpy() for m in affinity_labels_from_indices(flat, self._pi))


class VOC12SegDataset(VOC12ImageDataset):
    """Segmentation training set: an image and its soft pseudo mask
    (``<mask_root>/<name>.npy``, (H, W, C) float) with joint augmentation
    (jitter, scale 0.5-1.75, crop, flip).

    ``get(idx, rng)`` -> img (crop, crop, 3), mask (crop, crop, C), label
    (20,).  device_norm: uint8 image (pad ``IMAGENET_MEAN_U8``) and the
    mask x255-quantised to uint8, decoded on the device by
    ``seg_train_step``.  pack_mask: ship only the mask channels that can
    be nonzero (the background and the image's classes: the walk's
    pseudo-masks zero every other class) as (crop, crop, K) plus their
    (K,) int32 channel ids ``mask_idx``, zero-padded, an exact
    re-encoding; K > 0 a fixed budget that raises when a mask has more
    nonzero channels, -1 K from the dataset's labels, 0 the dense mask.
    upload='ycbcr420': the image as img_y/img_c planes."""

    def __init__(self, name_list, voc12_root, labels, mask_root: str, min_scale: float = 0.5,
                 max_scale: float = 1.75, crop_size: int = 448, device_norm: bool = False,
                 pack_mask: int = 0, upload: str = "rgb"):
        super().__init__(name_list, voc12_root, labels)
        self.mask_root = mask_root
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.crop_size = crop_size
        self.device_norm = device_norm
        if pack_mask == -1:
            pack_mask = 1 + max(1, max(int(self.label(i).sum()) for i in range(len(name_list))))
        self.pack_mask = int(pack_mask)
        _check_upload(upload, device_norm, crop_size)
        self.upload = upload

    def _pack_mask(self, mask: np.ndarray, name: str):
        """(H, W, C) -> ((H, W, k <= K) active channels, (K,) int32 channel
        ids, zero-padded).  Channel 0 is always kept, so a pad id 0
        scatters zeros onto a channel that exists."""
        k = self.pack_mask
        nz = np.flatnonzero((mask != 0).any(axis=(0, 1)))
        active = nz if (nz.size and nz[0] == 0) else np.concatenate(([0], nz))
        if active.size > k:
            raise ValueError(f"pack_mask={k} but {name} has {active.size} nonzero mask channels "
                             f"{active.tolist()}: raise pack_mask or use pack_mask=0 (dense)")
        idx = np.zeros(k, np.int32)
        idx[: active.size] = active
        return mask[..., active], idx

    def get(self, idx: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
        from PIL import Image

        name = self.name_list[idx]
        img = self.image(idx)
        mask = np.load(os.path.join(self.mask_root, name + ".npy"),
                       allow_pickle=True).astype(np.float32)  # (H, W, C)
        mask_idx = None
        if self.pack_mask:
            # before the geometric augmentation: the per-channel resize then
            # runs on k channels (an all-zero channel stays zero, and no draw
            # depends on the channel count)
            mask, mask_idx = self._pack_mask(mask, name)

        img = T.color_jitter(img, rng, 0.1, 0.1, 0.1, 0.05)
        scale = float(rng.uniform(self.min_scale, self.max_scale))
        w, h = img.size
        tw, th = round(w * scale), round(h * scale)
        img = img.resize((tw, th), resample=Image.BILINEAR)
        mask = T.resize_soft_mask(mask, (th, tw))

        if self.device_norm:
            arr, mask = T.random_crop(np.asarray(img), self.crop_size, rng, extra=mask,
                                      fill=T.IMAGENET_MEAN_U8)
        else:
            arr, mask = T.random_crop(T.color_norm(np.asarray(img)), self.crop_size, rng,
                                      extra=mask)
        if rng.random() < 0.5:
            arr, mask = T.hflip(arr), T.hflip(mask)
        if mask_idx is not None and mask.shape[-1] < self.pack_mask:
            mask = np.pad(mask, ((0, 0), (0, 0), (0, self.pack_mask - mask.shape[-1])))
        if self.device_norm:
            out = {"img": arr.astype(np.uint8),
                   "mask": np.round(np.clip(mask, 0.0, 1.0) * 255.0).astype(np.uint8),
                   "label": self.label(idx)}
            if self.upload == "ycbcr420":
                from muscle_tpu_torch.core.ycbcr import rgb_to_ycbcr420

                out["img_y"], out["img_c"] = rgb_to_ycbcr420(out.pop("img"))
        else:
            out = {"img": arr.astype(np.float32), "mask": mask.astype(np.float32),
                   "label": self.label(idx)}
        if mask_idx is not None:
            out["mask_idx"] = mask_idx
        return out
