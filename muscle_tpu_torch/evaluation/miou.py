"""Segmentation evaluation: vectorised mIoU with a background-threshold
sweep (the port's own copy of ``muscle_tpu/evaluation/miou.py``).

One pass accumulates one confusion matrix per threshold via bincount.  All
functions are numpy (CPU post-processing of on-disk artifacts).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

VOC_CATEGORIES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def confusion_matrix(pred: np.ndarray, gt: np.ndarray, num_cls: int) -> np.ndarray:
    """(num_cls, num_cls) confusion; gt==255 (void) excluded."""
    valid = gt < 255
    idx = gt[valid].astype(np.int64) * num_cls + pred[valid].astype(np.int64)
    return np.bincount(idx, minlength=num_cls * num_cls).reshape(num_cls, num_cls)


def iou_from_confusion(conf: np.ndarray) -> dict:
    """Per-class IoU + mIoU + FP/FN rates (reference :59-75)."""
    tp = np.diag(conf).astype(np.float64)
    t = conf.sum(1).astype(np.float64)
    p = conf.sum(0).astype(np.float64)
    denom = t + p - tp + 1e-10
    iou = tp / denom
    out = {c: iou[i] * 100 for i, c in enumerate(VOC_CATEGORIES[: conf.shape[0]])}
    out["mIoU"] = float(iou.mean() * 100)
    out["FP"] = ((p - tp) / denom).tolist()
    out["FN"] = ((t - tp) / denom).tolist()
    return out


def _load_pred_npy(path: str, num_cls: int, thresholds: np.ndarray) -> np.ndarray:
    """Load a {class_idx: (H, W) score} dict npy and argmax against each
    background threshold (reference :25-33).  Returns (T, H, W) uint8."""
    d = np.load(path, allow_pickle=True).item()
    first = next(iter(d.values()))
    h, w = first.shape
    tensor = np.zeros((num_cls, h, w), np.float32)
    for k, v in d.items():
        tensor[k + 1] = v
    preds = []
    for t in thresholds:
        tensor[0] = t
        preds.append(np.argmax(tensor, axis=0).astype(np.uint8))
    return np.stack(preds)


def evaluate_folder(
    predict_folder: str,
    gt_folder: str,
    name_list,
    num_cls: int = 21,
    input_type: str = "png",
    threshold: float | None = None,
    num_workers: int = 8,
) -> dict:
    """Single-threshold evaluation (reference do_python_eval)."""
    thresholds = np.asarray([threshold if threshold is not None else 1.0])
    confs = _accumulate(
        predict_folder, gt_folder, name_list, num_cls, input_type, thresholds, num_workers
    )
    return iou_from_confusion(confs[0])


def threshold_sweep(
    predict_folder: str,
    gt_folder: str,
    name_list,
    thresholds,
    num_cls: int = 21,
    num_workers: int = 8,
) -> list[dict]:
    """One-pass background-threshold sweep for npy score dicts (replaces the
    reference's per-threshold re-evaluation, train_mcl.py:310-316 /
    evaluation.py:126-133)."""
    thresholds = np.asarray(list(thresholds), dtype=np.float32)
    confs = _accumulate(
        predict_folder, gt_folder, name_list, num_cls, "npy", thresholds, num_workers
    )
    return [iou_from_confusion(c) for c in confs]


def _accumulate(
    predict_folder, gt_folder, name_list, num_cls, input_type, thresholds, num_workers
) -> np.ndarray:
    from PIL import Image

    nt = len(thresholds)

    def one(name: str) -> np.ndarray:
        gt = np.array(Image.open(os.path.join(gt_folder, f"{name}.png")))
        out = np.zeros((nt, num_cls, num_cls), np.int64)
        if input_type == "png":
            pred = np.array(Image.open(os.path.join(predict_folder, f"{name}.png")))
            conf = confusion_matrix(pred, gt, num_cls)
            out[:] = conf[None]
        else:
            preds = _load_pred_npy(
                os.path.join(predict_folder, f"{name}.npy"), num_cls, thresholds
            )
            for i in range(nt):
                out[i] = confusion_matrix(preds[i], gt, num_cls)
        return out

    total = np.zeros((nt, num_cls, num_cls), np.int64)
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        for conf in ex.map(one, name_list):
            total += conf
    return total


def write_log(filepath: str, metric: dict, comment: str) -> None:
    """Append-only text log, format-compatible with reference writelog
    (src/evaluation.py:94-102)."""
    import time

    with open(filepath, "a") as f:
        f.write(time.strftime("%Y-%m-%d %H:%M:%S", time.localtime()))
        f.write("\t%s\n" % comment)
        f.write("".join("%s:%s  " % (k, v) for k, v in metric.items()) + "\n")
        f.write("=====================================\n")
