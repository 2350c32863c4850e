"""The exact dense CRF: the native permutohedral-lattice library on the
CPU (port of ``muscle_tpu/ops/exact_crf.py``; ``--crf_backend native``).

The same C++ as the JAX package's, so the same inputs give the same bits.
``dense_crf`` takes the reference crf_inference's defaults and argument
layout (probabilities channel-first).
"""

from __future__ import annotations

import ctypes

import numpy as np

from muscle_tpu_torch.ops.native_lib import load


def _run(img: np.ndarray, probs: np.ndarray, t: int, sxy_g: float, compat_g: float,
         sxy_b: float, srgb: float, compat_b: float, confidence: float) -> np.ndarray:
    """One call of the native mean field: img (H, W, 3) uint8, probs
    (L, H, W); returns the refined (L, H, W) float32."""
    h, w = img.shape[:2]
    probs = np.ascontiguousarray(probs, np.float32)
    if probs.ndim != 3 or probs.shape[1:] != (h, w):
        raise ValueError(f"probs (L, H, W) {probs.shape} and image {img.shape} disagree")
    img_c = np.ascontiguousarray(img[..., :3], np.uint8)
    out = np.empty_like(probs)
    f32p = ctypes.POINTER(ctypes.c_float)
    load().muscle_dense_crf(
        probs.ctypes.data_as(f32p), img_c.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        h, w, probs.shape[0], t, sxy_g, compat_g, sxy_b, srgb, compat_b, confidence,
        out.ctypes.data_as(f32p))
    return out


def dense_crf(img: np.ndarray, probs: np.ndarray, t: int = 2, scale_factor: float = 1.5,
              labels: int = 21, confidence: float = 0.5) -> np.ndarray:
    """img: (H, W, 3) uint8; probs: (L, H, W) softmax scores.  Returns the
    refined (L, H, W) distribution (reference crf_inference)."""
    return _run(img, probs, t, 3.0 / scale_factor, 1.0, 32.0 / scale_factor, 10.0, 10.0,
                confidence)


def dense_crf_seam(img: np.ndarray, probs: np.ndarray, t: int = 10,
                   scale_factor: float = 1.0) -> np.ndarray:
    """SEAM's parameters (reference crf_inference_seam): Gaussian sxy 3
    compat 3, bilateral sxy 80 srgb 13 compat 10, unary -log(probs)."""
    return _run(img, probs, t, 3.0 / scale_factor, 3.0, 80.0 / scale_factor, 13.0, 10.0, 1.0)


def dense_crf_label(img: np.ndarray, labels: np.ndarray, t: int = 10, n_labels: int = 21,
                    gt_prob: float = 0.7) -> np.ndarray:
    """Hard-label variant (reference crf_inference_label): a unary from the
    labels (gt_prob on the label, the rest spread), Gaussian (3, 3) and
    bilateral (50, 5, 10); returns the refined argmax labels (H, W)."""
    h, w = img.shape[:2]
    p = np.full((n_labels, h, w), (1.0 - gt_prob) / (n_labels - 1), np.float32)
    rows, cols = np.indices((h, w))
    p[labels.astype(np.int64), rows, cols] = gt_prob
    return np.argmax(_run(img, p, t, 3.0, 3.0, 50.0, 5.0, 10.0, 1.0), axis=0)
