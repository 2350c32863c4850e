"""Spatial sharding: one image's height split over the ranks of a model
group (the JAX package's ``shard_spatial``, ``muscle_tpu/parallel/mesh.py``
``spatial_sharding``).

The JAX engines constrain the conv stack's input to P('data', 'model') and
GSPMD runs every conv with halo exchanges.  The port runs the backbone on
stripes and makes each exchange explicit (``models/efficientnet.py``,
``models/muscle.py``):

* a stripe: rank r of the k ranks owns rows [r s, (r + 1) s) of every level
  whose k s rows split evenly.  Canvases are multiples of 64 rows, so each
  stride-2 conv halves the stripes exactly until one would leave fewer
  than ``MAX_HALO`` rows a stripe (``can_halve``): that level is gathered
  and the rest of the network runs whole on every rank.  No canvas is
  padded for it: a taller canvas moves the maps;
* ``halo``: before a conv, ``lo`` rows of the stripe above and ``hi`` of the
  stripe below, zero rows at the image's top and bottom (the convs' zero
  padding there), by one all-gather of every rank's boundary rows, which
  gloo and NCCL both take on CPU and CUDA tensors;
* ``sum``: a sum over the image (the SE means, the row half of a window
  resize) as each stripe's own sum added over the group;
* ``gather``: a level whole on every rank.

A ``Stripes`` counts each kind of exchange in ``stats`` (calls and the
bytes a rank receives; the seconds only while ``timed`` is set, which
synchronises the device around every exchange and so perturbs what it
times).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from muscle_tpu_torch.core.resize import dynamic_bilinear_resize_weights
from muscle_tpu_torch.parallel.mesh import rank, world

# rows of the widest halo: a k5 depthwise's, and the k5 stride-2 conv's
# bottom pad (its static pad (1, 2))
MAX_HALO = 2
EXCHANGES = ("halo", "sum", "gather")


class Stripes:
    """This rank's horizontal stripe of every level of an image whose
    height is split over the ranks of ``group`` (a mesh's model group, in
    rank order top to bottom)."""

    def __init__(self, group):
        if world(group) < 2:
            raise ValueError("stripes need a group of at least 2 ranks")
        self.group = group
        self.size = world(group)
        self.rank = rank(group)
        self.timed = False  # synchronise around every exchange and time it
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {kind: {"calls": 0, "bytes": 0, "seconds": 0.0} for kind in EXCHANGES}

    def row0(self, rows: int) -> int:
        """The image row of this rank's first row, for stripes of ``rows``."""
        return self.rank * rows

    @staticmethod
    def can_halve(rows: int) -> bool:
        """Whether stripes of ``rows`` halve exactly through a stride-2 conv
        into stripes that can still feed every halo."""
        return rows % 2 == 0 and rows // 2 >= MAX_HALO

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole NHWC ``x``."""
        s = x.shape[1] // self.size
        if s * self.size != x.shape[1]:
            raise ValueError(f"{x.shape[1]} rows do not split into {self.size} stripes")
        return x[:, self.rank * s:(self.rank + 1) * s]

    def _exchange(self, kind: str, nbytes: int, fn):
        rec = self.stats[kind]
        rec["calls"] += 1
        rec["bytes"] += nbytes
        if not self.timed:
            return fn()
        sync = torch.cuda.synchronize if torch.cuda.is_initialized() else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        rec["seconds"] += time.perf_counter() - t0
        return out

    def _all_gather(self, x: torch.Tensor, kind: str) -> list:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        nbytes = (self.size - 1) * x.numel() * x.element_size()
        self._exchange(kind, nbytes, lambda: dist.all_gather(parts, x, group=self.group))
        return parts

    def halo(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """NHWC stripe ``x`` with ``lo`` rows of the stripe above on top and
        ``hi`` rows of the stripe below underneath; zero rows beyond the
        image's first and last rows."""
        if lo == hi == 0:
            return x
        s = x.shape[1]
        if max(lo, hi) > s:
            raise ValueError(f"a halo of {lo}/{hi} rows from stripes of {s}")
        parts = self._all_gather(torch.cat([x[:, :hi], x[:, s - lo:]], dim=1), "halo")
        if self.rank > 0:
            top = parts[self.rank - 1][:, hi:]
        else:
            top = x.new_zeros((x.shape[0], lo, *x.shape[2:]))
        if self.rank < self.size - 1:
            bottom = parts[self.rank + 1][:, :hi]
        else:
            bottom = x.new_zeros((x.shape[0], hi, *x.shape[2:]))
        return torch.cat([top, x, bottom], dim=1)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place; returns it."""
        self._exchange("sum", t.numel() * t.element_size(),
                       lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group))
        return t

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole level of which NHWC ``x`` is this rank's stripe."""
        return torch.cat(self._all_gather(x, "gather"), dim=1)

    def whole(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """A level of ``rows`` image rows whole: ``x`` itself if it is,
        else gathered from the stripes."""
        return x if x.shape[1] == rows else self.gather(x)


def window_resize_ac(src: torch.Tensor, src_win: torch.Tensor, dst_win: torch.Tensor,
                     dst_hw: tuple[int, int], stripes: Stripes) -> torch.Tensor:
    """``core.resize.batched_window_resize_ac`` of a level split over
    ``stripes`` (``src`` this rank's stripe, the windows in image rows),
    whole on every rank: each rank contracts its own rows, then its
    columns, and the partial resizes are summed over the group, which
    moves a (N, dst_h, dst_w, C) map instead of the source level."""
    s, ws = src.shape[1:3]
    hd, wd = dst_hw
    r0 = stripes.row0(s)
    wh = dynamic_bilinear_resize_weights(
        src_win[:, 2], dst_win[:, 2], s * stripes.size, hd, align_corners=True,
        src_off=src_win[:, 0], dst_off=dst_win[:, 0],
    )[..., r0:r0 + s]
    ww = dynamic_bilinear_resize_weights(
        src_win[:, 3], dst_win[:, 3], ws, wd, align_corners=True,
        src_off=src_win[:, 1], dst_off=dst_win[:, 1],
    )
    a = torch.einsum("nIy,nyxc->nIxc", wh, src.to(wh.dtype))
    return stripes.sum(torch.einsum("nJx,nIxc->nIJc", ww, a).contiguous())
