"""VOC2012 list and label access (port of the parts of
``muscle_tpu/data/voc12.py`` that CAM generation uses)."""

from __future__ import annotations

import os

import numpy as np

IMG_FOLDER_NAME = "JPEGImages"


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
