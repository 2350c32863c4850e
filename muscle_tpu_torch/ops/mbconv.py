"""Inference stride-1 MBConv block: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``muscle_tpu/ops/pallas/mbconv.py``
(``fused_mbconv_stride1``): expand 1x1 + BN0 + swish, depthwise k x k +
BN1 + swish, squeeze-excite over the valid window, project 1x1 + BN2, the
window mask after every BN, and the residual iff Cin == Cout.  The kernel
(``csrc/mbconv.cu``) runs it as three launches: expand + depthwise with SE
partial sums, the SE gate, and the project with BN2, the mask and the
residual in its epilogue.  Its 1x1 products run on the tensor cores in the
3xTF32 split (f32 accuracy).  The depthwise output ``d`` goes to HBM once
and comes back through a TMA ring into the project's ``wgmma``.

Bounds on an H100 SXM, bytes = x in + y out + the weights (the ideal
kernel keeps the expanded map on chip): ``bound_ms`` takes every FLOP on
the f32 pipes (67 TFLOP/s, ``block_work``); ``bound_tc_ms`` takes the 1x1
products on the tensor cores at 495/3 TFLOP/s (three tf32 products each)
and the depthwise on the f32 pipes (``block_flops``).  PERF.md holds the
kernel's times against both.

Layout: NHWC float32, like the JAX package.  The BNs arrive folded to
(scale, bias) pairs (``fold_bn``).  Channel counts that are not multiples
of 8 are zero-padded for the kernel (exact; TMA wants 16-byte strides).
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
TC_3XTF32_FLOPS_PER_S = 495e12 / 3  # H100 SXM dense TF32, three products per f32 one


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
        lib.mbconv_partials_per_image.argtypes = [i32] * 4
        lib.mbconv_partials_per_image.restype = i32
        lib.mbconv_error_string.argtypes = [i32]
        lib.mbconv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _pad_dims(t: torch.Tensor, names, dims: dict) -> torch.Tensor:
    """``t`` (axes ``names``) zero-padded so that each axis named in
    ``dims`` has a multiple of 8 entries."""
    shape = tuple(-(-t.shape[i] // 8) * 8 if n in dims else t.shape[i]
                  for i, n in enumerate(names))
    if shape == tuple(t.shape):
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _pad8(weights: dict, has_expand: bool) -> dict:
    """The weights zero-padded to channel counts that are multiples of 8:
    padded input and mid channels stay 0 through every stage (zero weights,
    scale and bias; swish(0) = 0), padded output channels are dropped by
    the caller.  Exact."""
    dims = {"Cin", "Cmid", "Cout"}
    return {n: _pad_dims(weights[n], WEIGHT_SHAPES[n], dims) for n in WEIGHT_SHAPES
            if has_expand or n not in ("w_exp", "s0", "b0")}


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (10 mantissa bits): to nearest, ties
    away from zero, on the low 13 bits of the f32 pattern, with integer
    ops (the device's ``cvt.rna.tf32.f32``; finite inputs)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(t), lo = tf32(t - hi): the operands of a
    3xTF32 product, hi*hi + hi*lo + lo*hi."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


# the kernel's extra operands: the 1x1 weights K-major, split for 3xTF32,
# stacked (hi, lo), at channel counts padded to multiples of 8
KERNEL_OPERANDS = ("w_exp_kt", "w_proj_kt")


def kernel_operands(weights: dict, has_expand: bool) -> dict:
    """``w_exp_kt`` (2, Cmid8, Cin8) and ``w_proj_kt`` (2, Cout8, Cmid8):
    (hi, lo) of the transposed 1x1 weights, as the kernel's TMA loads
    them.  ``MBConvBlock.fused_weights`` caches them beside the folded
    weights; the wrapper makes them when a dict lacks them."""
    wd = _pad8(weights, has_expand)
    out = {"w_proj_kt": torch.stack(split_tf32(wd["w_proj"].t().contiguous()))}
    if has_expand:
        out["w_exp_kt"] = torch.stack(split_tf32(wd["w_exp"].t().contiguous()))
    return out


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
    cout = dims["Cout"]
    win = full_window(x) if window is None else window
    x8, wd = _pad_dims(x, ("B", "H", "W", "Cin"), {"Cin"}), _pad8(weights, has_expand)
    b, h, w, cin8 = x8.shape
    cmid8, cout8, csq = wd["w_dw"].shape[1], wd["w_proj"].shape[1], dims["Csq"]
    want = {"w_proj_kt": (2, cout8, cmid8), "w_exp_kt": (2, cmid8, cin8)}
    kt = {n: weights.get(n) for n in KERNEL_OPERANDS if has_expand or n != "w_exp_kt"}
    if any(t is None or tuple(t.shape) != want[n] or t.device != x.device
           for n, t in kt.items()):
        kt = kernel_operands(weights, has_expand)
    ntiles = lib.mbconv_partials_per_image(h, w, k, int(has_expand))

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    d, part = empty(b, h, w, cmid8), empty(b, ntiles, cmid8)
    gate, y = empty(b, cmid8), empty(b, h, w, cout8)
    none = ctypes.c_void_p(0)

    def p(t):
        return ctypes.c_void_p(t.data_ptr()) if t is not None else none

    rc = lib.mbconv_stride1_f32(
        p(x8), p(win), p(kt.get("w_exp_kt")),
        p(wd.get("s0") if has_expand else None), p(wd.get("b0") if has_expand else None),
        p(wd["w_dw"]), p(wd["s1"]), p(wd["b1"]), p(wd["w_se_r"]), p(wd["b_se_r"]),
        p(wd["w_se_e"]), p(wd["b_se_e"]), p(kt["w_proj_kt"]), p(wd["s2"]), p(wd["b2"]),
        p(d), p(part), p(gate), p(y),
        b, h, w, cin8, cmid8, csq, cout8, k, int(has_expand), int(has_skip),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"mbconv kernel launch failed: {lib.mbconv_error_string(rc).decode()}")
    mbconv_stride1.launches += 1
    return y if cout8 == cout else y[..., :cout].contiguous()


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


def block_flops(b: int, h: int, w: int, cin: int, cmid: int, cout: int, k: int,
                has_expand: bool) -> tuple[int, int]:
    """(FLOPs of the 1x1 products, FLOPs of the depthwise) of one block
    call; their sum is ``block_work``'s FLOPs."""
    px = b * h * w
    return 2 * px * ((cin * cmid if has_expand else 0) + cmid * cout), 2 * px * k * k * cmid


def bound_tc_ms(nbytes: float, product_flops: float, depthwise_flops: float
                ) -> tuple[float, str]:
    """(least time in ms an H100 SXM could take for a block with the 1x1
    products on the tensor cores in the 3xTF32 split and the depthwise on
    the f32 pipes, what bounds it: 'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (product_flops / TC_3XTF32_FLOPS_PER_S + depthwise_flops / F32_FLOPS_PER_S) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """(least time in ms an H100 SXM could take to move ``nbytes`` and do
    ``flops`` f32 operations, what bounds it: 'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
