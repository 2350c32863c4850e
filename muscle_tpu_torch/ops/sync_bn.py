"""Cross-rank batch norm in training: the CUDA kernels' wrapper and their
plain PyTorch stages.

``sync_bn`` normalises x over the statistics of the global batch, split
over the ranks of a data-parallel group, as Flax's ``BatchNorm`` does
under a sharded batch: float32 statistics at float32 and bfloat16, the
output in x's dtype, the running statistics updated with the biased
variance.  x is the model's channels-last NCHW view, so its memory is a
(P, C) matrix, P = N H W, and every reduction is a column reduction.  The
stages, each a ``<stage>_plain`` and a ``<stage>_kernel`` function:

(a) ``local_stats``: this rank's [count, mean, M2] (1 + 2C floats),
    written straight into its row of the (W, 1 + 2C) buffer that
(b) one all-gather fills in place (``parallel.mesh.all_gather_into``);
(c) ``normalize``: the W rows combined by Chan's parallel update (the
    variance never takes E[x^2] - mean^2), the running update, and y;
    keeps ``saved`` = [mean (C), invstd (C), n] for the backward;
(d) ``backward_reduce``: [sum g, sum g xhat] (2C floats) for
(e) one all-reduce, and this rank's db, dw (copies the all-reduce does
    not touch: the affine's gradients stay this rank's share, summed with
    every other gradient in ``training/state.py`` ``minimize``);
(f) ``backward_dx``: dx = g s - s (sum g / n + xhat sum g xhat / n),
    s = invstd * w, the global batch's input gradient.  At bfloat16 it is
    rounded on the two paths JAX's autodiff rounds (the direct g s and the
    rest, each to bf16, then summed; ``_LowpBatchStatsNorm`` in
    ``models/efficientnet.py``).

A CPU tensor runs the plain stages; a CUDA tensor, float32 or bfloat16
and channels-last contiguous, launches the kernels (``csrc/sync_bn.cu``:
one launch each for (a), (c), (d) and (f)) or raises.  The kernels replace
no TPU kernel: XLA computes the JAX package's statistics over the sharded
batch, and the plain stages cost ~25 eager launches a BN forward and ~15
backward.  They are bound by bytes; ``chip_smoke.py`` times them against
that bound.

``sync_bn.launches`` counts forward calls through the kernels,
``sync_bn.launches_backward`` backward calls.
"""

from __future__ import annotations

import ctypes

import torch

from muscle_tpu_torch.parallel.mesh import all_gather_into, all_reduce_sum, rank, world

DTYPES = (torch.float32, torch.bfloat16)
_DIMS = (0, 2, 3)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


# ---- the plain stages -------------------------------------------------------


def local_stats_plain(x: torch.Tensor, row: torch.Tensor) -> None:
    """(a): x's [count, mean, M2] per channel into ``row`` (1 + 2C float32)."""
    xf, c = x.to(torch.float32), x.shape[1]
    mean = xf.mean(_DIMS)
    row[0] = x.numel() // c
    row[1: 1 + c] = mean
    row[1 + c:] = torch.square(xf - _col(mean)).sum(_DIMS)


def normalize_plain(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float, running=None):
    """(c): the (W, 1 + 2C) rows of ``stats`` combined, y in x's dtype, and
    ``saved`` = [mean, invstd, n].  ``running``: (running_mean,
    running_var, num_batches_tracked, momentum), updated with the biased
    variance as Flax does, or None."""
    c = x.shape[1]
    counts, means, m2s = stats[:, :1], stats[:, 1: 1 + c], stats[:, 1 + c:]
    n = counts.sum()
    mean = (counts * means).sum(0) / n
    var = (m2s.sum(0) + (counts * torch.square(means - mean)).sum(0)) / n
    invstd = torch.rsqrt(var + eps)
    y = (x.to(torch.float32) - _col(mean)) * _col(invstd * weight) + _col(bias)
    if running is not None:
        run_mean, run_var, batches, m = running
        batches.add_(1)
        run_mean.mul_(1.0 - m).add_(mean, alpha=m)
        run_var.mul_(1.0 - m).add_(var, alpha=m)
    return y.to(x.dtype), torch.cat([mean, invstd, n[None]])


def backward_reduce_plain(g: torch.Tensor, x: torch.Tensor, saved: torch.Tensor):
    """(d): (red = [sum g, sum g xhat], dw, db), float32."""
    c = x.shape[1]
    xhat = (x.to(torch.float32) - _col(saved[:c])) * _col(saved[c: 2 * c])
    gf = g.to(torch.float32)
    db, dw = gf.sum(_DIMS), (gf * xhat).sum(_DIMS)
    return torch.cat([db, dw]), dw, db


def backward_dx_plain(g: torch.Tensor, x: torch.Tensor, saved: torch.Tensor,
                      weight: torch.Tensor, red: torch.Tensor) -> torch.Tensor:
    """(f): dx in x's dtype from the summed ``red``."""
    c = x.shape[1]
    mean, invstd, n = saved[:c], saved[c: 2 * c], saved[2 * c]
    red = red / n
    xhat = (x.to(torch.float32) - _col(mean)) * _col(invstd)
    scale = _col(invstd * weight)
    direct = g.to(torch.float32) * scale
    dx = direct - scale * (_col(red[:c]) + xhat * _col(red[c:]))
    if x.dtype != torch.float32:
        dx = direct.to(x.dtype) + (dx - direct).to(x.dtype)
    return dx


# ---- the kernels ---------------------------------------------------------------


def _lib():
    if _LIB:
        return _LIB[0]
    from muscle_tpu_torch.ops import build

    lib = build.load("sync_bn")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for d in ("f32", "bf16"):
        typed = {"stats": [ptr] * 4 + [i32] * 2 + [ptr],
                 "normalize": [ptr, ptr, i32, ptr, ptr, f32, f32] + [ptr] * 5 + [i32] * 2 + [ptr],
                 "reduce": [ptr] * 8 + [i32] * 2 + [ptr],
                 "dx": [ptr] * 6 + [i32] * 2 + [ptr]}
        for name, argtypes in typed.items():
            fn = getattr(lib, f"sync_bn_{name}_{d}")
            fn.argtypes, fn.restype = argtypes, i32
    lib.sync_bn_workspace_floats.argtypes = [i32] * 2
    lib.sync_bn_workspace_floats.restype = i32
    lib.sync_bn_tickets.argtypes = [i32]
    lib.sync_bn_tickets.restype = i32
    lib.sync_bn_error_string.argtypes = [i32]
    lib.sync_bn_error_string.restype = ctypes.c_char_p
    _LIB.append(lib)
    return lib


_LIB = []  # the typed library, once loaded
_TICKETS: dict = {}  # device -> int32 tickets, zero between launches


def _tickets(lib, device: torch.device, c: int) -> torch.Tensor:
    """The kernels' tickets on ``device``, at least as many as C channels
    take; every launch leaves them zero."""
    need = lib.sync_bn_tickets(c)
    t = _TICKETS.get(device)
    if t is None or t.numel() < need:
        t = _TICKETS[device] = torch.zeros(max(need, 64), dtype=torch.int32, device=device)
    return t


def _check(x: torch.Tensor, name: str = "x") -> None:
    if x.dtype not in DTYPES or x.ndim != 4 or not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError(f"sync_bn on a card takes a channels-last contiguous float32 or "
                         f"bfloat16 NCHW {name}, got {x.dtype} {tuple(x.shape)} strides "
                         f"{x.stride()}")


def _vector(t: torch.Tensor | None, c: int, device, dtype=torch.float32) -> None:
    if t is not None and (t.shape != (c,) or t.dtype != dtype or t.device != device
                          or not t.is_contiguous()):
        raise ValueError(f"want a contiguous {dtype} ({c},) tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _pc(x: torch.Tensor) -> tuple[int, int]:
    c = x.shape[1]
    return x.numel() // c, c


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _suffix(x: torch.Tensor) -> str:
    return "bf16" if x.dtype == torch.bfloat16 else "f32"


def _raise(lib, rc: int, stage: str) -> None:
    if rc != 0:
        raise RuntimeError(f"sync_bn {stage} launch failed: "
                           f"{lib.sync_bn_error_string(rc).decode()}")


def local_stats_kernel(x: torch.Tensor, row: torch.Tensor) -> None:
    """(a) on the card: one launch."""
    _check(x)
    p, c = _pc(x)
    _vector(row, 1 + 2 * c, x.device)
    lib = _lib()
    ws = torch.empty(lib.sync_bn_workspace_floats(p, c), dtype=torch.float32, device=x.device)
    rc = getattr(lib, f"sync_bn_stats_{_suffix(x)}")(
        _ptr(x), _ptr(row), _ptr(ws), _ptr(_tickets(lib, x.device, c)), p, c, _stream(x))
    _raise(lib, rc, "stats")


def normalize_kernel(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, running=None):
    """(c) on the card: one launch; ``normalize_plain``'s arguments and
    results."""
    _check(x)
    p, c = _pc(x)
    w = stats.shape[0]
    if stats.shape != (w, 1 + 2 * c) or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError(f"stats: want a contiguous float32 (W, {1 + 2 * c}), got "
                         f"{stats.dtype} {tuple(stats.shape)}")
    for t in (weight, bias):
        _vector(t, c, x.device)
    run_mean = run_var = batches = None
    m = 0.0
    if running is not None:
        run_mean, run_var, batches, m = running
        _vector(run_mean, c, x.device)
        _vector(run_var, c, x.device)
        _vector(batches.view(1), 1, x.device, torch.int64)
    lib = _lib()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    saved = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
    rc = getattr(lib, f"sync_bn_normalize_{_suffix(x)}")(
        _ptr(x), _ptr(stats), w, _ptr(weight), _ptr(bias), eps, m, _ptr(run_mean),
        _ptr(run_var), _ptr(batches), _ptr(saved), _ptr(y), p, c, _stream(x))
    _raise(lib, rc, "normalize")
    return y, saved


def _check_pair(g: torch.Tensor, x: torch.Tensor) -> None:
    _check(x)
    _check(g, "g")
    if g.dtype != x.dtype or g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g {g.dtype} {tuple(g.shape)} on {g.device} does not match x "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def backward_reduce_kernel(g: torch.Tensor, x: torch.Tensor, saved: torch.Tensor):
    """(d) on the card: one launch."""
    _check_pair(g, x)
    p, c = _pc(x)
    lib = _lib()
    red = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    dw, db = torch.empty_like(red[:c]), torch.empty_like(red[:c])
    ws = torch.empty(lib.sync_bn_workspace_floats(p, c), dtype=torch.float32, device=x.device)
    rc = getattr(lib, f"sync_bn_reduce_{_suffix(x)}")(
        _ptr(g), _ptr(x), _ptr(saved), _ptr(red), _ptr(dw), _ptr(db), _ptr(ws),
        _ptr(_tickets(lib, x.device, c)), p, c, _stream(x))
    _raise(lib, rc, "reduce")
    return red, dw, db


def backward_dx_kernel(g: torch.Tensor, x: torch.Tensor, saved: torch.Tensor,
                       weight: torch.Tensor, red: torch.Tensor) -> torch.Tensor:
    """(f) on the card: one launch."""
    _check_pair(g, x)
    p, c = _pc(x)
    lib = _lib()
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    rc = getattr(lib, f"sync_bn_dx_{_suffix(x)}")(
        _ptr(g), _ptr(x), _ptr(saved), _ptr(weight), _ptr(red), _ptr(dx), p, c, _stream(x))
    _raise(lib, rc, "dx")
    return dx


# (a), (c), (d), (f) by device: the CPU's plain stages, a card's kernels
PLAIN = (local_stats_plain, normalize_plain, backward_reduce_plain, backward_dx_plain)
KERNELS = (local_stats_kernel, normalize_kernel, backward_reduce_kernel, backward_dx_kernel)


def stages(x: torch.Tensor) -> tuple:
    """The four stages x's device runs: ``PLAIN`` on the CPU, ``KERNELS`` on
    a card."""
    if x.device.type == "cpu":
        return PLAIN
    if x.device.type != "cuda":
        raise ValueError(f"sync_bn runs on cpu or cuda, not {x.device}")
    return KERNELS


class _SyncBatchNorm(torch.autograd.Function):
    """``sync_bn`` with its backward: the global batch's input gradient,
    this rank's share of the affine's."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, running):
        local_stats, normalize, _, _ = ctx.stages = stages(x)
        r = rank(group)
        stats = torch.empty((world(group), 1 + 2 * x.shape[1]), dtype=torch.float32,
                            device=x.device)
        local_stats(x, stats[r])
        all_gather_into(stats, stats[r: r + 1], group)
        y, saved = normalize(x, stats, weight, bias, eps, running)
        if ctx.stages is KERNELS:
            sync_bn.launches += 1
        ctx.save_for_backward(x, weight, saved)
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight, saved = ctx.saved_tensors
        _, _, backward_reduce, backward_dx = ctx.stages
        if ctx.stages is KERNELS:  # the incoming gradient may come in any layout
            gy = gy.contiguous(memory_format=torch.channels_last)
            sync_bn.launches_backward += 1
        red, dw, db = backward_reduce(gy, x, saved)
        all_reduce_sum(red, ctx.group)
        return backward_dx(gy, x, saved, weight, red), dw, db, None, None, None


def sync_bn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, group,
            running=None) -> torch.Tensor:
    """Train-mode batch norm of NCHW ``x`` (float32 or bfloat16; on a card
    channels-last contiguous) on the statistics of the global batch over
    ``group``'s ranks; y in x's dtype.  ``running``: (running_mean,
    running_var, num_batches_tracked, momentum), updated in place as Flax
    updates them (the biased variance), or None."""
    return _SyncBatchNorm.apply(x, weight, bias, eps, group, running)


sync_bn.launches = 0
sync_bn.launches_backward = 0

