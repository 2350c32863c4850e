"""Inference stride-1 MBConv block: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``muscle_tpu/ops/pallas/mbconv.py``
(``fused_mbconv_stride1``): expand 1x1 + BN0 + swish, depthwise k x k +
BN1 + swish, squeeze-excite over the valid window, project 1x1 + BN2, the
window mask after every BN, and the residual iff Cin == Cout.  The kernel
(``csrc/mbconv.cu``) runs it as three launches: expand + depthwise with SE
partial sums, the SE gate, and a project GEMM that applies the gate as it
loads and BN2, the mask and the residual in its epilogue.

Bound on an H100 SXM: max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s f32),
with bytes = x in + y out + the weights (the ideal kernel keeps the
expanded map on chip) and FLOPs = 2*B*H*W*(Cin*Cmid + k*k*Cmid +
Cmid*Cout) (``block_work``, ``bound_ms``).  At the b3 CAM shapes the blocks are bound by
operations.  This version writes the depthwise output to HBM and reads it
back, and runs its products on the f32 pipes without tensor cores; the
gap to the bound is recorded in PERF.md.

Layout: NHWC float32, like the JAX package.  The BNs arrive folded to
(scale, bias) pairs (``fold_bn``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# weight names of one block, as the wrapper takes them (shapes for a block
# with Cin -> Cmid -> Cout channels, Csq squeeze channels, a k x k depthwise)
WEIGHT_SHAPES = {
    "w_exp": ("Cin", "Cmid"), "s0": ("Cmid",), "b0": ("Cmid",),
    "w_dw": ("kk", "Cmid"), "s1": ("Cmid",), "b1": ("Cmid",),
    "w_se_r": ("Cmid", "Csq"), "b_se_r": ("Csq",),
    "w_se_e": ("Csq", "Cmid"), "b_se_e": ("Cmid",),
    "w_proj": ("Cmid", "Cout"), "s2": ("Cout",), "b2": ("Cout",),
}

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, f32 outside the tensor cores


def fold_bn(weight, bias, mean, var, eps: float):
    """Inference BatchNorm as (scale, bias): y = x * scale + bias."""
    scale = weight * torch.rsqrt(var + eps)
    return scale, bias - mean * scale


def full_window(x: torch.Tensor) -> torch.Tensor:
    """(B, 4) int32 windows covering each whole image of NHWC ``x``."""
    b, h, w, _ = x.shape
    win = torch.zeros((b, 4), dtype=torch.int32, device=x.device)
    win[:, 2], win[:, 3] = h, w  # fills on the device: no host-to-device copy
    return win


def window_mask(hw: tuple[int, int], win: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, H, W, 1) indicator of the per-image valid windows ``win``
    ((N, 4) int (oy, ox, h, w)) inside an (H, W) canvas."""
    rows = torch.arange(hw[0], device=win.device)[None, :, None]
    cols = torch.arange(hw[1], device=win.device)[None, None, :]
    oy, ox = win[:, 0, None, None], win[:, 1, None, None]
    m = ((rows >= oy) & (rows < oy + win[:, 2, None, None])
         & (cols >= ox) & (cols < ox + win[:, 3, None, None]))
    return m[..., None].to(dtype)


def mbconv_stride1_plain(x, weights, window, *, k: int, has_expand: bool,
                         has_skip: bool) -> torch.Tensor:
    """The block in plain PyTorch ops, with the kernel's folding and
    masking: the CPU path of ``mbconv_stride1`` and its reference on the
    card."""
    b, h, w, _ = x.shape
    win = full_window(x) if window is None else window
    mask = window_mask((h, w), win)
    wd = weights
    if has_expand:
        e = F.silu(x @ wd["w_exp"] * wd["s0"] + wd["b0"])
    else:
        e = x
    e = e * mask
    cmid = wd["w_dw"].shape[1]
    kern = wd["w_dw"].t().reshape(cmid, 1, k, k)
    dw = F.conv2d(e.permute(0, 3, 1, 2), kern, padding=k // 2, groups=cmid)
    d = F.silu(dw.permute(0, 2, 3, 1) * wd["s1"] + wd["b1"]) * mask
    count = (win[:, 2] * win[:, 3]).to(torch.float32)[:, None]
    se = d.sum(dim=(1, 2)) / count
    sq = F.silu(se @ wd["w_se_r"] + wd["b_se_r"])
    gate = torch.sigmoid(sq @ wd["w_se_e"] + wd["b_se_e"])
    y = ((d * gate[:, None, None, :]) @ wd["w_proj"] * wd["s2"] + wd["b2"]) * mask
    if has_skip:
        y = y + x
    return y


def _check(x: torch.Tensor, weights: dict, window, k: int, has_expand: bool,
           has_skip: bool) -> dict:
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("mbconv_stride1 takes a contiguous float32 NHWC tensor, "
                         f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    if k not in (3, 5):
        raise ValueError(f"mbconv_stride1 supports k in (3, 5), got {k}")
    cin = x.shape[3]
    dims = {"Cin": cin, "Cmid": weights["w_dw"].shape[1], "kk": k * k,
            "Csq": weights["w_se_r"].shape[1], "Cout": weights["w_proj"].shape[1]}
    names = [n for n in WEIGHT_SHAPES if has_expand or n not in ("w_exp", "s0", "b0")]
    for n in names:
        t = weights[n]
        want = tuple(dims[s] for s in WEIGHT_SHAPES[n])
        if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != want):
            raise ValueError(f"weight {n}: want contiguous float32 {want} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not has_expand and dims["Cmid"] != cin:
        raise ValueError("a block without expand has Cmid == Cin")
    if has_skip != (cin == dims["Cout"]):
        raise ValueError("the residual is taken iff Cin == Cout")
    if window is not None and (window.device != x.device or window.dtype != torch.int32
                               or tuple(window.shape) != (x.shape[0], 4)
                               or not window.is_contiguous()):
        raise ValueError("window must be a contiguous (B, 4) int32 tensor on x's device")
    return dims


def _lib():
    from muscle_tpu_torch.ops import build

    lib = build.load("mbconv")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mbconv_stride1_f32.argtypes = [ptr] * 19 + [i32] * 10 + [ptr]
        lib.mbconv_stride1_f32.restype = i32
        lib.mbconv_partials_per_image.argtypes = [i32, i32]
        lib.mbconv_partials_per_image.restype = i32
        lib.mbconv_error_string.argtypes = [i32]
        lib.mbconv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def mbconv_stride1(x: torch.Tensor, weights: dict, window: torch.Tensor | None, *,
                   k: int, has_expand: bool, has_skip: bool) -> torch.Tensor:
    """Inference stride-1 MBConv block on NHWC float32 ``x`` (B, H, W, Cin).

    weights: the folded tensors named in ``WEIGHT_SHAPES`` (``w_exp``,
    ``s0``, ``b0`` only when ``has_expand``).  window: (B, 4) int32
    (oy, ox, h, w) valid windows, or None for whole images.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (building it on first use) or raises.  ``mbconv_stride1.launches``
    counts kernel launches."""
    if x.requires_grad:
        raise RuntimeError("mbconv_stride1 is inference-only (the kernel has no "
                           "backward); call it under torch.inference_mode()")
    dims = _check(x, weights, window, k, has_expand, has_skip)
    if x.device.type == "cpu":
        return mbconv_stride1_plain(x, weights, window, k=k, has_expand=has_expand,
                                    has_skip=has_skip)
    if x.device.type != "cuda":
        raise ValueError(f"mbconv_stride1 runs on cpu or cuda, not {x.device}")
    lib = _lib()
    b, h, w, cin = x.shape
    cmid, csq, cout = dims["Cmid"], dims["Csq"], dims["Cout"]
    win = full_window(x) if window is None else window
    ntiles = lib.mbconv_partials_per_image(h, w)
    d = torch.empty((b, h, w, cmid), dtype=torch.float32, device=x.device)
    part = torch.empty((b, ntiles, cmid), dtype=torch.float32, device=x.device)
    gate = torch.empty((b, cmid), dtype=torch.float32, device=x.device)
    y = torch.empty((b, h, w, cout), dtype=torch.float32, device=x.device)
    wd = weights
    none = ctypes.c_void_p(0)

    def p(t):
        return ctypes.c_void_p(t.data_ptr()) if t is not None else none

    rc = lib.mbconv_stride1_f32(
        p(x), p(win), p(wd.get("w_exp") if has_expand else None),
        p(wd.get("s0") if has_expand else None), p(wd.get("b0") if has_expand else None),
        p(wd["w_dw"]), p(wd["s1"]), p(wd["b1"]), p(wd["w_se_r"]), p(wd["b_se_r"]),
        p(wd["w_se_e"]), p(wd["b_se_e"]), p(wd["w_proj"]), p(wd["s2"]), p(wd["b2"]),
        p(d), p(part), p(gate), p(y),
        b, h, w, cin, cmid, csq, cout, k, int(has_expand), int(has_skip),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"mbconv kernel launch failed: {lib.mbconv_error_string(rc).decode()}")
    mbconv_stride1.launches += 1
    return y


mbconv_stride1.launches = 0


def block_work(b: int, h: int, w: int, cin: int, cmid: int, csq: int, cout: int, k: int,
               has_expand: bool) -> tuple[int, int]:
    """(bytes, FLOPs) of one block call: x read and y written once plus
    the weights (the expanded map never leaves the chip), and the three
    products' multiply-adds."""
    px = b * h * w
    weights = ((cin + 2) * cmid if has_expand else 0) + (k * k + 2) * cmid \
        + 2 * cmid * csq + csq + cmid + cmid * cout + 2 * cout
    nbytes = 4 * (px * (cin + cout) + weights + b * 4)
    flops = 2 * px * ((cin * cmid if has_expand else 0) + k * k * cmid + cmid * cout)
    return nbytes, flops


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """(least time in ms an H100 SXM could take to move ``nbytes`` and do
    ``flops`` f32 operations, what bounds it: 'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
