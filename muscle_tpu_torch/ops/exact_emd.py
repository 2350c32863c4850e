"""Exact EMD through the native transportation-simplex solver (port of
``muscle_tpu/ops/exact_emd.py``): the reference's exact backends (a QP and
cv2.EMD), for validating the Sinkhorn training path on the host."""

from __future__ import annotations

import ctypes

import numpy as np

from muscle_tpu_torch.ops.native_lib import load


def exact_emd(cost: np.ndarray, weight1: np.ndarray, weight2: np.ndarray,
              return_flow: bool = False):
    """cost: (N, M); weight1: (N,); weight2: (M,).  The marginals are
    relu+1e-5'd and normalised to equal mass (the reference's opencv-path
    preprocessing).  Returns the cost, or (cost, flow)."""
    cost = np.ascontiguousarray(cost, np.float32)
    w1 = np.ascontiguousarray(weight1, np.float32)
    w2 = np.ascontiguousarray(weight2, np.float32)
    n, m = cost.shape
    if w1.shape != (n,) or w2.shape != (m,):
        raise ValueError(f"weights {w1.shape} and {w2.shape} do not match cost {cost.shape}")
    flow = np.zeros((n, m), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    val = load().muscle_exact_emd(cost.ctypes.data_as(f32p), w1.ctypes.data_as(f32p),
                                  w2.ctypes.data_as(f32p), n, m, flow.ctypes.data_as(f32p))
    if return_flow:
        return float(val), flow
    return float(val)
