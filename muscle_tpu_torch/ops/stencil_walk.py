"""Stencil random walk: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the Pallas TPU kernel ``muscle_tpu/ops/pallas/stencil_walk.py``
(``stencil_walk_pallas``): ``steps`` iterations of, per image, class and
pixel p,

    x'[p] = (x[p] + sum_d x[p-d] * v_d[p-d] + x[p+d] * v_d[p]) * inv[p]

over the D = 34 radius-5 directions d, neighbours outside the grid
contributing zero.  The classes walk independently.  The kernel
(``csrc/stencil_walk.cu``) runs one launch per step; a CTA owns a 16 x 16
pixel tile of one image for all classes, holds its pixels' 2*D weights in
registers and the class tiles with their halo in shared memory.

Bound on an H100 SXM: max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s f32) with
bytes = x in + x' out + vs + inv, each once, and FLOPs =
B*C*steps*H*W*(4D + 1) (``walk_work``, ``ops.mbconv.bound_ms``).  At the
IRN shapes the operations bound it.  One shared-memory read per FMA caps
this version at ~4.5x that bound; its times are in PERF.md.

The TPU kernel pads the grid to (8, 128) tiles and uses circular rolls; the
CUDA kernel works on the (H, W) grid with zero fill, as the plain loop does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F


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
        lib.stencil_walk_f32.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.stencil_walk_f32.restype = i32
        lib.stencil_walk_error_string.argtypes = [i32]
        lib.stencil_walk_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def stencil_walk(x: torch.Tensor, vs: torch.Tensor, inv: torch.Tensor, *,
                 dirs: tuple[tuple[int, int], ...], steps: int) -> torch.Tensor:
    """Run ``steps`` walk steps of x (B, C, H, W) float32 with per-direction
    affinities vs (B, D, H, W) and reciprocal column sums inv (B, H, W);
    ``dirs`` is the ((dy, dx), ...) table of vs' direction axis.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (building it on first use) or raises.  ``stencil_walk.launches``
    counts calls that launch the kernel (one call, ``steps`` launches)."""
    if x.requires_grad or vs.requires_grad or inv.requires_grad:
        raise RuntimeError("stencil_walk is inference-only (the kernel has no backward)")
    _check(x, vs, inv, dirs)
    if x.device.type == "cpu":
        return stencil_walk_plain(x, vs, inv, dirs=dirs, steps=steps)
    if x.device.type != "cuda":
        raise ValueError(f"stencil_walk runs on cpu or cuda, not {x.device}")
    lib = _lib()
    b, c, h, w = x.shape
    table = np.ascontiguousarray(dirs, dtype=np.int32).reshape(-1)
    y = torch.empty_like(x)
    tmp = torch.empty_like(x) if steps > 1 else y

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    rc = lib.stencil_walk_f32(
        p(x), p(vs), p(inv), p(tmp), p(y), table.ctypes.data_as(ctypes.c_void_p), len(dirs),
        b, c, h, w, steps, ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError("stencil walk kernel launch failed: "
                           f"{lib.stencil_walk_error_string(rc).decode()} (the kernel takes "
                           "the 34 radius-5 directions and at most ~100 classes)")
    stencil_walk.launches += 1
    return y


stencil_walk.launches = 0


def walk_work(b: int, c: int, h: int, w: int, n_dirs: int, steps: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one walk: x read and x' written once, vs and inv
    read once; two multiply-adds per direction and the inv product per
    pixel, class and step."""
    nbytes = 4 * (2 * b * c * h * w + b * n_dirs * h * w + b * h * w)
    flops = b * c * steps * h * w * (4 * n_dirs + 1)
    return nbytes, flops
