"""PASCAL VOC colour palette and indexed-PNG writer (port of
``muscle_tpu/core/palette.py``).  PIL is imported only inside the writer."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=4)
def voc_color_map(n: int = 256) -> np.ndarray:
    """(n, 3) uint8 VOC label palette via bit-reversal (cached, read-only)."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    cmap.setflags(write=False)
    return cmap


def save_indexed_png(path: str, labels: np.ndarray) -> None:
    """Write an argmax label map as a palettised PNG (the reference
    infer_irn's output format)."""
    from PIL import Image

    img = Image.fromarray(labels.astype(np.uint8), mode="P")
    img.putpalette(voc_color_map().reshape(-1).tolist())
    img.save(path)
