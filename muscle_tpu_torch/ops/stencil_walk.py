"""Stencil random walk: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the Pallas TPU kernel ``muscle_tpu/ops/pallas/stencil_walk.py``
(``stencil_walk_pallas``): ``steps`` iterations of, per image, class and
pixel p,

    x'[p] = (x[p] + sum_d x[p-d] * v_d[p-d] + x[p+d] * v_d[p]) * inv[p]

over the D = 34 radius-5 directions d, neighbours outside the grid
contributing zero.  The classes walk independently.  The kernel
(``csrc/stencil_walk.cu``) runs one launch per step; a CTA owns a 32 x 16
pixel tile of one image, staged by TMA with its halo (the vs tile once,
the iterate by class chunks), and a thread owns 4 pixels of a row for a
chunk of classes (``stencil_plan``), with one tap row's weights and one
class window at a time in registers.

Bound on an H100 SXM: max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s f32) with
bytes = x in + x' out + vs + inv, each once, and FLOPs =
B*C*steps*H*W*(4D + 1) (``walk_work``, ``ops.mbconv.bound_ms``).  At the
IRN shapes the operations bound it; the kernel's times are in PERF.md.

The TPU kernel pads the grid to (8, 128) tiles and uses circular rolls; the
CUDA kernel works on the (H, W) grid with zero fill, as the plain loop does,
its width padded with zeros to a multiple of 4 (``pad_width``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from muscle_tpu_torch.utils.timers import span


def shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., r, c] = a[..., r - dy, c - dx], zero-filled (any sign)."""
    h, w = a.shape[-2:]
    p = F.pad(a, (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)))
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return p[..., y0: y0 + h, x0: x0 + w]


def stencil_walk_plain(x: torch.Tensor, vs: torch.Tensor, inv: torch.Tensor, *,
                       dirs: tuple[tuple[int, int], ...], steps: int) -> torch.Tensor:
    """The walk in plain PyTorch ops (the JAX package's XLA loop, batched):
    the CPU path of ``stencil_walk`` and its reference on the card."""
    for _ in range(steps):
        acc = x
        for d, (dy, dx) in enumerate(dirs):
            v = vs[:, d, None]
            acc = acc + shift2d(x * v, dy, dx)
            acc = acc + shift2d(x, -dy, -dx) * v
        x = acc * inv[:, None]
    return x


def _check(x, vs, inv, dirs) -> None:
    if x.ndim != 4 or vs.ndim != 4 or inv.ndim != 3:
        raise ValueError("stencil_walk takes x (B, C, H, W), vs (B, D, H, W), inv (B, H, W)")
    b, _, h, w = x.shape
    if tuple(vs.shape) != (b, len(dirs), h, w) or tuple(inv.shape) != (b, h, w):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, vs {tuple(vs.shape)}, "
                         f"inv {tuple(inv.shape)}, {len(dirs)} directions")
    for name, t in (("x", x), ("vs", vs), ("inv", inv)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: want a contiguous float32 tensor on {x.device}, got "
                             f"{t.dtype} on {t.device} contiguous={t.is_contiguous()}")


def _lib():
    from muscle_tpu_torch.ops import build

    lib = build.load("stencil_walk")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.stencil_walk_f32.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
        lib.stencil_walk_f32.restype = i32
        lib.stencil_walk_error_string.argtypes = [i32]
        lib.stencil_walk_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


# the kernel's tiling (csrc/stencil_walk.cu): TILE_W x TILE_H pixels per CTA,
# 4 pixels per thread, class groups of 128 threads; the classes per thread
# it is compiled for; a halo of 4 around the staged iterate, 4 above and at
# the sides of the staged vs (34 planes)
TILE_W, TILE_H, GROUP_THREADS = 32, 16, 128
CLASS_CHUNKS = (1, 2, 3, 4, 5, 6, 8, 10)
N_DIRS, HALO = 34, 4
SMEM_LIMIT = 232_448  # bytes of shared memory a CTA may use on an H100


class StencilPlan(NamedTuple):
    cc: int  # classes per thread in a pass
    ng: int  # class groups of GROUP_THREADS threads
    passes: int  # class chunks of ng * cc, one after the other
    buffers: int  # staged iterate chunks (2: the next loads while one computes)
    width: int  # W padded to a multiple of 4
    grid: tuple[int, int, int]  # CTAs: column tiles, row tiles, images
    threads: int
    smem: int  # dynamic shared bytes per CTA


def stencil_plan(b: int, c: int, h: int, w: int) -> StencilPlan:
    """How the kernel tiles a walk of x (b, c, h, w).  Up to 10 classes: one
    group, cc the smallest compiled chunk that holds them; up to 20: two
    groups (8 warps); more: passes of 2 x 5 classes, double-buffered."""
    if c <= 10:
        ng, cc = 1, min(k for k in CLASS_CHUNKS if k >= c)
    elif c <= 20:
        ng, cc = 2, min(k for k in CLASS_CHUNKS if k >= -(-c // 2))
    else:
        ng, cc = 2, 5
    passes = -(-c // (ng * cc))
    buffers = 1 if passes == 1 else 2
    width = -(-w // 4) * 4
    xplane = (TILE_H + 2 * HALO) * (TILE_W + 2 * HALO)
    vtile = N_DIRS * (TILE_H + HALO) * (TILE_W + 2 * HALO)
    smem = 128 + 4 * (vtile + buffers * ng * cc * xplane) + 3 * 8
    assert smem <= SMEM_LIMIT
    grid = (-(-width // TILE_W), -(-h // TILE_H), b)
    return StencilPlan(cc, ng, passes, buffers, width, grid, ng * GROUP_THREADS, smem)


def pad_width(t: torch.Tensor, width: int) -> torch.Tensor:
    """t (..., W) with zero columns up to ``width``, contiguous and 16-byte
    aligned (the kernel's TMA rows); t itself where it already is."""
    if t.shape[-1] == width and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return F.pad(t, (0, width - t.shape[-1])).contiguous()


def stencil_walk(x: torch.Tensor, vs: torch.Tensor, inv: torch.Tensor, *,
                 dirs: tuple[tuple[int, int], ...], steps: int) -> torch.Tensor:
    """Run ``steps`` walk steps of x (B, C, H, W) float32 with per-direction
    affinities vs (B, D, H, W) and reciprocal column sums inv (B, H, W);
    ``dirs`` is the ((dy, dx), ...) table of vs' direction axis.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (building it on first use) or raises.  ``stencil_walk.launches``
    counts calls that launch the kernel (one call, ``steps`` launches).
    The span ``walk`` (``utils/timers.py``) covers a call's host work: on
    a card the kernel's call, on the CPU the plain walk itself."""
    if x.requires_grad or vs.requires_grad or inv.requires_grad:
        raise RuntimeError("stencil_walk is inference-only (the kernel has no backward)")
    _check(x, vs, inv, dirs)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stencil_walk runs on cpu or cuda, not {x.device}")
    with span("walk"):
        if x.device.type == "cpu":
            return stencil_walk_plain(x, vs, inv, dirs=dirs, steps=steps)
        return _launch(x, vs, inv, dirs, steps)


def _launch(x, vs, inv, dirs, steps: int) -> torch.Tensor:
    """``stencil_walk``'s card path: the kernel's one call."""
    lib = _lib()
    b, c, h, w = x.shape
    plan = stencil_plan(b, c, h, w)
    # zero columns up to a multiple of 4: zero weights and zero iterate, so
    # the walk keeps them zero and the grid's own pixels see no change
    x0, vs, inv = (pad_width(t, plan.width) for t in (x, vs, inv))
    table = np.ascontiguousarray(dirs, dtype=np.int32).reshape(-1)
    y = torch.empty_like(x0)
    tmp = torch.empty_like(x0) if steps > 1 else y

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    rc = lib.stencil_walk_f32(
        p(x0), p(vs), p(inv), p(tmp), p(y), table.ctypes.data_as(ctypes.c_void_p), len(dirs),
        b, c, h, plan.width, steps, plan.cc, plan.ng,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError("stencil walk kernel launch failed: "
                           f"{lib.stencil_walk_error_string(rc).decode()} (the kernel takes "
                           "the 34 radius-5 directions)")
    stencil_walk.launches += 1
    return y if plan.width == w else y[..., :w].contiguous()


stencil_walk.launches = 0


def walk_work(b: int, c: int, h: int, w: int, n_dirs: int, steps: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one walk: x read and x' written once, vs and inv
    read once; two multiply-adds per direction and the inv product per
    pixel, class and step."""
    nbytes = 4 * (2 * b * c * h * w + b * n_dirs * h * w + b * h * w)
    flops = b * c * steps * h * w * (4 * n_dirs + 1)
    return nbytes, flops
