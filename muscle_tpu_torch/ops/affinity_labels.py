"""Affinity labels for IRN training (port of
``muscle_tpu/ops/affinity_labels.py``).

For every pixel pair (src, dst) that the PathIndex enumerates within the
radius:

  bg_pos: both pixels labelled background,
  fg_pos: both pixels of the same foreground class,
  neg:    the labels differ and neither is void (255).

Pairs touching void are ignored.  Masks are (D, P), direction-major, the
layout of the IRN losses (``training/irn.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from muscle_tpu_torch.ops.random_walk import PathIndex


def get_indices_of_pairs(radius: int, size: tuple[int, int]):
    """(indices_from (P,), indices_to (D, P)) of every pixel pair within
    ``radius`` on a grid, in the PathIndex's order."""
    pi = PathIndex(radius, size)
    return pi.src_indices.copy(), pi.dst_indices.copy()


def _raster_pairs(offsets: np.ndarray, size: tuple[int, int], from_slice: tuple[slice, slice]):
    """``indices_from``: the region ``from_slice`` in raster order; each
    offset (dy, dx) maps a source index i to i + dy * W + dx."""
    h, w = size
    full = np.arange(h * w, dtype=np.int64).reshape(h, w)
    indices_from = full[from_slice].reshape(-1)
    deltas = offsets[:, 0] * w + offsets[:, 1]
    indices_to = (indices_from[None, :] + deltas[:, None]).reshape(-1)
    return indices_from, indices_to


def get_indices_of_pairs_raster(radius: int, size: tuple[int, int], orient: bool = False):
    """The reference's half-plane pair enumeration: offsets (0, x) for x in
    [1, radius), then (y, x) for y in [1, radius) with y^2 + x^2 <
    radius^2, over the interior rows [0, H-r+1) and cols [r-1, W-r+1).

    Returns (indices_from (P,), indices_to (D*P,)) and with ``orient`` each
    offset's orientation bin (the angle quantised as ``core/sobel.py``
    does; the reference tests its flag instead of the angles and puts
    every offset in bin 0, DEVIATIONS.md)."""
    offs = [(0, x) for x in range(1, radius)]
    offs += [(y, x) for y in range(1, radius) for x in range(-radius + 1, radius)
             if x * x + y * y < radius * radius]
    offsets = np.asarray(offs, np.int64)
    rf = radius - 1
    indices_from, indices_to = _raster_pairs(
        offsets, size, (slice(0, size[0] - rf), slice(rf, size[1] - rf)))
    if not orient:
        return indices_from, indices_to
    ang = np.arctan2(offsets[:, 0].astype(np.float64), offsets[:, 1].astype(np.float64))
    div = 3.1416 / 8
    bins = np.full(ang.shape, 7, np.float64)
    for b, (lo, hi) in enumerate([(1, 3), (3, 5), (5, 7)]):
        bins[(ang >= lo * div) & (ang < hi * div)] = b
    bins[((ang >= 7 * div) & (ang < 8 * div)) | ((ang >= -8 * div) & (ang < -7 * div))] = 3
    for b, (lo, hi) in enumerate([(-7, -5), (-5, -3), (-3, -1)], start=4):
        bins[(ang >= lo * div) & (ang < hi * div)] = b
    return indices_from, indices_to, bins


def get_indices_of_pairs_circle(radius: int, size: tuple[int, int]):
    """The reference's full punctured disc of offsets over the interior
    rows and cols [r-1, dim-r+1): (indices_from (P,), indices_to (D*P,))."""
    offsets = np.asarray([(y, x) for y in range(-radius + 1, radius)
                          for x in range(-radius + 1, radius)
                          if 0 < x * x + y * y < radius * radius], np.int64)
    rf = radius - 1
    return _raster_pairs(offsets, size, (slice(rf, size[0] - rf), slice(rf, size[1] - rf)))


def affinity_labels_from_indices(label_flat: torch.Tensor, path_index: PathIndex):
    """label_flat: (V,) integer labels over the grid (255 = void; fill any
    pad with 255 so its pairs are ignored).  Returns float32 (bg_pos,
    fg_pos, neg), each (D, P)."""
    dev = label_flat.device
    src = torch.from_numpy(np.ascontiguousarray(path_index.src_indices)).to(dev)
    dst = torch.from_numpy(np.ascontiguousarray(path_index.dst_indices)).to(dev)
    a = label_flat[src][None, :]
    b = label_flat[dst]
    valid = (a != 255) & (b != 255)
    equal = (a == b) & valid
    return ((equal & (a == 0)).to(torch.float32), (equal & (a > 0)).to(torch.float32),
            ((a != b) & valid).to(torch.float32))
