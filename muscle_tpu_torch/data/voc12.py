"""VOC2012 lists, labels and the MCL training dataset (port of the parts of
``muscle_tpu/data/voc12.py`` that CAM generation and MCL training use).

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
        if upload not in ("rgb", "ycbcr420"):
            raise ValueError(f"upload must be 'rgb' or 'ycbcr420', got {upload!r}")
        if upload == "ycbcr420" and not device_norm:
            raise ValueError("upload='ycbcr420' requires device_norm=True")
        if upload == "ycbcr420" and (crop_size % 2 or view_size[0] % 2 or view_size[1] % 2):
            raise ValueError(f"upload='ycbcr420' needs even crop_size/view_size, got "
                             f"{crop_size}/{view_size}")
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
