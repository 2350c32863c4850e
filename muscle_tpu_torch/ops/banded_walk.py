"""Banded random walk: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the Pallas TPU kernel ``muscle_tpu/ops/pallas/banded_walk.py``
(``banded_random_walk``): ``x @ T^steps`` for a dense-stored (V, V)
transition matrix T whose nonzeros lie within ``band`` of the diagonal
(``walk_band``).  Both versions read T only inside the band windows of
their column blocks and take it as zero elsewhere.  The kernel
(``csrc/banded_walk.cu``) runs one launch per step; a CTA owns 32 columns
of one image for all classes, its warps split the band rows, and the
iterate ping-pongs through two (B, V, CP) buffers.

Bound on an H100 SXM: max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s f32) with
bytes = the band of T read once + x in + x' out and FLOPs =
2*C*steps*(band entries) (``walk_work``, ``ops.mbconv.bound_ms``): the
operations bound it.  This version reads the band from device memory once
per step (68 MB at grid 128 does not stay in the 50 MB L2), ~2x the
bound at the full memory rate; its times are in PERF.md.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F


def walk_band(w: int, radius: int = 5) -> int:
    """Max |i - j| with T[i, j] != 0 on an (h, w) grid walk."""
    rf = int(np.ceil(radius) - 1)
    return rf * w + rf


PLAIN_BLOCK = 128  # columns per block of the plain version


def banded_walk_plain(x: torch.Tensor, trans: torch.Tensor, *, steps: int,
                      band: int) -> torch.Tensor:
    """The walk in plain PyTorch ops: per step, each block of PLAIN_BLOCK
    columns multiplies its (block + 2*band) row window of x by T's band
    window.  x (B, C, V), trans (B, V, V)."""
    b, c, v = x.shape
    bc = PLAIN_BLOCK
    nblk = -(-v // bc)
    vp = nblk * bc
    r = bc + 2 * band
    tpad = F.pad(trans, (0, vp - v, band, vp - v + band))
    blocks = torch.stack([tpad[:, k * bc: k * bc + r, k * bc: (k + 1) * bc]
                          for k in range(nblk)], dim=1)  # (B, nblk, R, bc)
    for _ in range(steps):
        xw = F.pad(x, (band, vp - v + band)).unfold(2, r, bc)  # (B, C, nblk, R)
        x = torch.einsum("bcnr,bnrj->bcnj", xw, blocks).reshape(b, c, vp)[..., :v]
    return x


def _check(x, trans) -> None:
    if x.ndim != 3 or trans.ndim != 3:
        raise ValueError("banded_walk takes x (B, C, V) and trans (B, V, V)")
    b, c, v = x.shape
    if tuple(trans.shape) != (b, v, v):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, trans {tuple(trans.shape)}")
    for name, t in (("x", x), ("trans", trans)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: want a contiguous float32 tensor on {x.device}, got "
                             f"{t.dtype} on {t.device} contiguous={t.is_contiguous()}")
    if c > 32:
        raise ValueError(f"banded_walk takes at most 32 classes, got {c}")


def _lib():
    from muscle_tpu_torch.ops import build

    lib = build.load("banded_walk")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.banded_walk_f32.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.banded_walk_f32.restype = i32
        lib.banded_walk_error_string.argtypes = [i32]
        lib.banded_walk_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def banded_walk(x: torch.Tensor, trans: torch.Tensor, *, steps: int, band: int) -> torch.Tensor:
    """x (B, C, V) @ trans (B, V, V) ** steps, float32, for T banded at
    ``band``; returns (B, C, V).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (building it on first use) or raises.  ``banded_walk.launches`` counts
    calls that launch the kernel (one call, ``steps`` launches)."""
    if x.requires_grad or trans.requires_grad:
        raise RuntimeError("banded_walk is inference-only (the kernel has no backward)")
    _check(x, trans)
    if x.device.type == "cpu":
        return banded_walk_plain(x, trans, steps=steps, band=band)
    if x.device.type != "cuda":
        raise ValueError(f"banded_walk runs on cpu or cuda, not {x.device}")
    lib = _lib()
    b, c, v = x.shape
    cp = -(-c // 4) * 4
    # the kernel's layout: (B, V, CP), classes padded with zeros
    x0 = torch.zeros((b, v, cp), dtype=torch.float32, device=x.device)
    x0[..., :c] = x.transpose(1, 2)
    y = torch.empty_like(x0)
    tmp = torch.empty_like(x0) if steps > 1 else y

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    rc = lib.banded_walk_f32(p(x0), p(trans), p(tmp), p(y), b, v, cp, band, steps,
                             ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"banded walk kernel launch failed: "
                           f"{lib.banded_walk_error_string(rc).decode()}")
    banded_walk.launches += 1
    return y[..., :c].transpose(1, 2).contiguous()


banded_walk.launches = 0


def band_entries(v: int, band: int) -> int:
    """Entries of a (V, V) matrix within ``band`` of the diagonal."""
    j = np.arange(v)
    return int(np.sum(np.minimum(v, j + band + 1) - np.maximum(0, j - band)))


def walk_work(b: int, c: int, v: int, band: int, steps: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one walk: the band of T read once, x read and x'
    written once; a multiply-add per class, step and band entry."""
    n = band_entries(v, band)
    return 4 * (b * n + 2 * b * c * v), 2 * b * c * steps * n
