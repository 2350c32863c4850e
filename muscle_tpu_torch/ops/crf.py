"""Mean-field dense CRF in plain PyTorch (port of ``muscle_tpu/ops/crf.py``,
the ``--crf_backend xla`` of ``infer_seg``), on the device of its inputs.

The reference refines its segmentation with the Krähenbühl dense CRF
(pydensecrf): a unary from a confidence-mixed softmax, one Gaussian
smoothness kernel, one bilateral appearance kernel, Potts compatibility
and t mean-field iterations.  Here:

* the Gaussian kernel is an exact separable blur (truncated at 3 sigma);
* the bilateral kernel is a 5-D bilateral grid over (y, x, r, g, b) with
  cells one sigma wide: a nearest-cell splat (``index_add_``), a Gaussian
  blur along each of the five axes, then a slice back to the pixels.

The JAX package runs this as XLA code, not as a Pallas kernel, so its
port is torch operations too.  On a card ``index_add_`` adds with atomics
in no fixed order, so two runs may differ in the last bits; the CPU sums
in order.  ``ops/exact_crf.py`` is the native permutohedral CRF, the
bit-faithful backend.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel_1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    return np.exp(-(x * x) / (2.0 * sigma * sigma)).astype(np.float32)


def _blur_axis(x: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate along one axis with zero padding, unnormalised (dense-CRF
    kernels are affinities, not averages): a weighted sum of shifted
    slices, one fused multiply-add pass per tap."""
    r = (len(kernel) - 1) // 2
    n = x.shape[axis]
    xp = F.pad(x, [0, 0] * (x.ndim - 1 - axis) + [r, r])
    out = xp.narrow(axis, 0, n) * float(kernel[0])
    for i in range(1, len(kernel)):
        out.add_(xp.narrow(axis, i, n), alpha=float(kernel[i]))
    return out


def _gaussian_filter(q: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable spatial Gaussian over (H, W) of (H, W, L)."""
    k = _gaussian_kernel_1d(sigma)
    return _blur_axis(_blur_axis(q, k, 0), k, 1)


def _bilateral_filter(q: torch.Tensor, guide: torch.Tensor, sxy: float, srgb: float,
                      color_bins: int) -> torch.Tensor:
    """Bilateral filter of q (H, W, L) guided by (H, W, 3) colours in
    [0, 255], by splat, blur and slice on a 5-D grid."""
    h, w, l = q.shape
    dev = q.device
    gh = int(math.ceil(h / sxy)) + 3
    gw = int(math.ceil(w / sxy)) + 3
    gc = color_bins + 3
    color_sigma_cells = srgb / (256.0 / color_bins)

    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] / sxy + 1.5
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] / sxy + 1.5
    cs = guide / (256.0 / color_bins) + 1.5
    coords = [ys.expand(h, w), xs.expand(h, w), cs[..., 0], cs[..., 1], cs[..., 2]]
    dims = (gh, gw, gc, gc, gc)
    # nearest cell (round half to even, as the JAX package)
    idx = [torch.clamp(torch.round(c).to(torch.int64), 0, d - 1) for c, d in zip(coords, dims)]
    flat = ((((idx[0] * gw + idx[1]) * gc + idx[2]) * gc + idx[3]) * gc + idx[4]).reshape(-1)

    grid = torch.zeros((gh * gw * gc * gc * gc, l), dtype=q.dtype, device=dev)
    grid.index_add_(0, flat, q.reshape(-1, l))
    grid = grid.reshape(*dims, l)
    k_sp = _gaussian_kernel_1d(1.0)
    k_cl = _gaussian_kernel_1d(max(color_sigma_cells, 1e-3))
    for axis, k in ((0, k_sp), (1, k_sp), (2, k_cl), (3, k_cl), (4, k_cl)):
        grid = _blur_axis(grid, k, axis)
    return grid.reshape(-1, l)[flat].reshape(h, w, l)


@torch.no_grad()
def mean_field_crf(probs: torch.Tensor, image: torch.Tensor, t: int = 2,
                   scale_factor: float = 1.5, sxy_gaussian: float = 3.0,
                   compat_gaussian: float = 1.0, sxy_bilateral: float = 32.0,
                   srgb: float = 10.0, compat_bilateral: float = 10.0,
                   confidence: float = 0.5, color_bins: int = 12) -> torch.Tensor:
    """Dense-CRF mean field with the reference crf_inference's defaults
    (``infer_seg`` calls it with t = 4).

    probs: (H, W, L) class probabilities; image: (H, W, 3) RGB in [0, 255]
    (any dtype), on the same device.  Returns the refined (H, W, L)
    distribution, float32."""
    if probs.ndim != 3 or image.shape[:2] != probs.shape[:2]:
        raise ValueError(f"probs (H, W, L) and image (H, W, 3) disagree: "
                         f"{tuple(probs.shape)} vs {tuple(image.shape)}")
    probs = probs.to(torch.float32)
    l = probs.shape[-1]
    mixed = confidence * probs + (1.0 - confidence) / l
    neg_unary = torch.log(torch.clamp(mixed, min=1e-20))
    sg = sxy_gaussian / scale_factor
    sb = sxy_bilateral / scale_factor
    guide = image.to(device=probs.device, dtype=torch.float32)
    q = torch.softmax(neg_unary, dim=-1)
    for _ in range(t):
        msg_g = _gaussian_filter(q, sg) - q  # without the pixel's own contribution
        msg_b = _bilateral_filter(q, guide, sb, srgb, color_bins) - q
        q = torch.softmax(neg_unary + compat_gaussian * msg_g + compat_bilateral * msg_b, dim=-1)
    return q
