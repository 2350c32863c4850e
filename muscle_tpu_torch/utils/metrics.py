"""Classification metrics (port of ``muscle_tpu/utils/metrics.py``)."""

from __future__ import annotations

import numpy as np


def topk_accuracy(scores: np.ndarray, target: np.ndarray, topk=(1, 5)) -> list[float]:
    """Multi-label top-k hit rates: for each sample, whether any of its
    top-k scored classes is a ground-truth class.  scores: (N, C); target:
    (N, C) multi-hot.  Returns [top-1 rate, top-max(topk) rate]."""
    order = np.argsort(-np.asarray(scores), axis=1)[:, :max(topk)]
    hits = np.take_along_axis(np.asarray(target), order, axis=1) > 0  # (N, maxk)
    return [float(hits[:, 0].mean()), float(hits.any(axis=1).mean())]
