"""Inference stride-1 MBConv block: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``muscle_tpu/ops/pallas/mbconv.py``
(``fused_mbconv_stride1``): expand 1x1 + BN0 + swish, depthwise k x k +
BN1 + swish, squeeze-excite over the valid window, project 1x1 + BN2, the
window mask after every BN, and the residual iff Cin == Cout.  The kernel
(``csrc/mbconv.cu``) runs it as expand + depthwise with SE partial sums,
the SE gate (two launches over channel slices), and the project with BN2,
the mask and the residual in its epilogue.  At float32 its 1x1 products
run on the tensor cores in the 3xTF32 split (f32 accuracy); at bfloat16
(the Pallas kernel's ``compute_dtype=bf16`` instantiation) as one bf16
product each, with f32 accumulation.  The depthwise output ``d`` goes to
HBM once, in x's dtype, and comes back through a TMA ring into the
project's ``wgmma``.

Bounds on an H100 SXM, bytes = x in + y out + the weights (the ideal
kernel keeps the expanded map on chip): ``bound_ms`` takes every FLOP on
the f32 pipes (67 TFLOP/s, ``block_work``); ``bound_tc_ms`` takes the 1x1
products on the tensor cores, at 495/3 TFLOP/s in f32 (three tf32
products each) or 989 TFLOP/s in bf16, and the depthwise on the f32 pipes
(``block_flops``).  PERF.md holds the kernel's times against both.

Layout: NHWC, like the JAX package; x and y float32 or bfloat16.  The BNs
arrive folded to float32 (scale, bias) pairs (``fold_bn``); at bfloat16
the five weight matrices (``MATRIX_WEIGHTS``) are bfloat16 and the scales
and biases stay float32, as the Pallas kernel takes them.  The kernel
takes channel counts that are multiples of 8 at both dtypes (TMA's
16-byte strides; the K tail of a chunk arrives zero-filled); others are
zero-padded, which is exact (no EfficientNet width needs it: its widths
round to multiples of 8).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from muscle_tpu_torch.utils.timers import span

# weight names of one block, as the wrapper takes them (shapes for a block
# with Cin -> Cmid -> Cout channels, Csq squeeze channels, a k x k depthwise)
WEIGHT_SHAPES = {
    "w_exp": ("Cin", "Cmid"), "s0": ("Cmid",), "b0": ("Cmid",),
    "w_dw": ("kk", "Cmid"), "s1": ("Cmid",), "b1": ("Cmid",),
    "w_se_r": ("Cmid", "Csq"), "b_se_r": ("Csq",),
    "w_se_e": ("Csq", "Cmid"), "b_se_e": ("Cmid",),
    "w_proj": ("Cmid", "Cout"), "s2": ("Cout",), "b2": ("Cout",),
}

# the weights that take the compute dtype; the scales and biases stay f32
MATRIX_WEIGHTS = ("w_exp", "w_dw", "w_se_r", "w_se_e", "w_proj")
DTYPES = (torch.float32, torch.bfloat16)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, f32 outside the tensor cores
TC_3XTF32_FLOPS_PER_S = 495e12 / 3  # H100 SXM dense TF32, three products per f32 one
TC_BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16


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


def window_mask(hw: tuple[int, int], win: torch.Tensor, dtype=torch.float32,
                row0: int = 0) -> torch.Tensor:
    """(N, H, W, 1) indicator of the per-image valid windows ``win``
    ((N, 4) int (oy, ox, h, w)) inside an (H, W) canvas, or inside rows
    row0 .. row0 + H - 1 of a taller one (a stripe, ``parallel/spatial.py``)."""
    rows = torch.arange(row0, row0 + hw[0], device=win.device)[None, :, None]
    cols = torch.arange(hw[1], device=win.device)[None, None, :]
    oy, ox = win[:, 0, None, None], win[:, 1, None, None]
    m = ((rows >= oy) & (rows < oy + win[:, 2, None, None])
         & (cols >= ox) & (cols < ox + win[:, 3, None, None]))
    return m[..., None].to(dtype)


def shift_rows(win: torch.Tensor, dy: int) -> torch.Tensor:
    """(B, 4) int32 windows ``win`` with their first row moved up by ``dy``:
    the window of a stripe whose row 0 is row ``dy`` of the image (its h
    stays the image's, so the SE mean divides by the whole window)."""
    out = win.to(torch.int32).clone()
    out[:, 0] -= dy
    return out


@dataclasses.dataclass
class MBConvPartial:
    """A block call between its two stages: ``part`` (B, n, Cmid') float32
    holds the SE sums of the depthwise output ``d`` over the call's own
    rows, ``n`` per image (the kernel's tiles, or 1); on a card x and the
    weights are the kernel's (padded where a channel count needs it, with
    the K-major operands).  Made by
    ``mbconv_stride1_begin`` or ``_plain_begin``; where x is a stripe of
    an image split over several ranks, the caller adds ``part`` over them
    before ``mbconv_stride1_end``."""
    x: torch.Tensor
    weights: dict
    win: torch.Tensor
    d: torch.Tensor
    part: torch.Tensor
    has_skip: bool
    owned: tuple[int, int] | None
    cout: int = 0


def _plain_begin(x, wd, window, *, k: int, has_expand: bool, has_skip: bool,
                 owned=None) -> MBConvPartial:
    """The plain expand + depthwise: ``d`` (float32) and its SE sums over
    the rows ``owned`` (all rows when None), (B, 1, Cmid), float32 at
    either dtype.  At bfloat16 the Pallas kernel's ``compute_dtype=bf16``
    instantiation: bf16 operands of every product with f32 accumulation,
    BN / swish / masks in f32, the masked expand output rounded to bf16,
    each depthwise product rounded to bf16 before the f32 sum, and ``d``
    kept in f32 for the SE sums (``_plain_end`` rounds it)."""
    h, w = x.shape[1:3]
    win = full_window(x) if window is None else window
    mask = window_mask((h, w), win)
    cmid = wd["w_dw"].shape[1]
    if x.dtype == torch.bfloat16:
        if has_expand:
            e = F.silu(_mm(x, wd["w_exp"]) * wd["s0"] + wd["b0"])
        else:
            e = x.float()
        e = (e * mask).to(torch.bfloat16)
        p = k // 2
        ep = F.pad(e, (0, 0, p, p, p, p))
        dw = torch.zeros(e.shape, dtype=torch.float32, device=x.device)
        for ky in range(k):
            for kx in range(k):
                dw += ep[:, ky:ky + h, kx:kx + w] * wd["w_dw"][ky * k + kx]
    else:
        if has_expand:
            e = F.silu(x @ wd["w_exp"] * wd["s0"] + wd["b0"])
        else:
            e = x
        e = e * mask
        kern = wd["w_dw"].t().reshape(cmid, 1, k, k)
        dw = F.conv2d(e.permute(0, 3, 1, 2), kern, padding=k // 2,
                      groups=cmid).permute(0, 2, 3, 1)
    d = F.silu(dw * wd["s1"] + wd["b1"]) * mask
    lo, hi = (0, h) if owned is None else owned
    return MBConvPartial(x, wd, win, d, d[:, lo:hi].sum(dim=(1, 2))[:, None], has_skip, owned)


def _plain_end(p: MBConvPartial) -> torch.Tensor:
    """The plain SE gate from ``p.part`` (summed over its partials and
    divided by the whole window's count) and the project: y of the rows
    ``p.owned`` (all rows when None), in x's dtype.  At bfloat16 the SE
    FCs' inputs and the gated ``d`` are rounded to bf16, the residual added
    in f32 and y rounded once."""
    wd, win, x = p.weights, p.win, p.x
    mask = window_mask(x.shape[1:3], win)
    count = (win[:, 2] * win[:, 3]).to(torch.float32)[:, None]
    se = p.part.sum(dim=1) / count
    if x.dtype == torch.bfloat16:
        bf16 = torch.bfloat16
        sq = F.silu(_mm(se.to(bf16), wd["w_se_r"]) + wd["b_se_r"])
        gate = torch.sigmoid(_mm(sq.to(bf16), wd["w_se_e"]) + wd["b_se_e"])
        dg = (p.d.to(bf16).float() * gate[:, None, None, :]).to(bf16)
        y = (_mm(dg, wd["w_proj"]) * wd["s2"] + wd["b2"]) * mask
        if p.has_skip:
            y = y + x.float()
        y = y.to(bf16)
    else:
        sq = F.silu(se @ wd["w_se_r"] + wd["b_se_r"])
        gate = torch.sigmoid(sq @ wd["w_se_e"] + wd["b_se_e"])
        y = ((p.d * gate[:, None, None, :]) @ wd["w_proj"] * wd["s2"] + wd["b2"]) * mask
        if p.has_skip:
            y = y + x
    return y if p.owned is None else y[:, p.owned[0]:p.owned[1]]


def mbconv_stride1_plain(x, weights, window, *, k: int, has_expand: bool, has_skip: bool,
                         owned=None, se_sum=None) -> torch.Tensor:
    """The block in plain PyTorch ops, with the kernel's folding and
    masking, float32 or bfloat16 (``_plain_begin`` / ``_plain_end``): the
    CPU path of ``mbconv_stride1`` and its reference on the card (``owned``
    and ``se_sum`` as there)."""
    p = _plain_begin(x, weights, window, k=k, has_expand=has_expand, has_skip=has_skip,
                     owned=owned)
    if se_sum is not None:
        se_sum(p.part)
    return _plain_end(p)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w of bf16 operands with f32 accumulation: the bf16 products are
    exact in f32, so this is the tensor cores' product."""
    return a.float() @ w.float()


# (name, axes) of the weights a block takes, with and without an expand
_WEIGHT_AXES = {True: tuple(WEIGHT_SHAPES.items()),
                False: tuple((n, a) for n, a in WEIGHT_SHAPES.items()
                             if n not in ("w_exp", "s0", "b0"))}


def _check(x: torch.Tensor, weights: dict, window, k: int, has_expand: bool,
           has_skip: bool) -> dict:
    if x.dtype not in DTYPES or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("mbconv_stride1 takes a contiguous float32 or bfloat16 NHWC tensor, "
                         f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    if k not in (3, 5):
        raise ValueError(f"mbconv_stride1 supports k in (3, 5), got {k}")
    cin = x.shape[3]
    dims = {"Cin": cin, "Cmid": weights["w_dw"].shape[1], "kk": k * k,
            "Csq": weights["w_se_r"].shape[1], "Cout": weights["w_proj"].shape[1]}
    device, f32 = x.get_device(), torch.float32
    for n, axes in _WEIGHT_AXES[has_expand]:
        t = weights[n]
        dtype = x.dtype if n in MATRIX_WEIGHTS else f32
        if (t.get_device() != device or t.dtype != dtype or not t.is_contiguous()
                or t.shape != tuple([dims[a] for a in axes])):
            want = tuple(dims[a] for a in axes)
            raise ValueError(f"weight {n}: want contiguous {dtype} {want} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not has_expand and dims["Cmid"] != cin:
        raise ValueError("a block without expand has Cmid == Cin")
    if has_skip != (cin == dims["Cout"]):
        raise ValueError("the residual is taken iff Cin == Cout")
    if window is not None and (window.get_device() != device or window.dtype != torch.int32
                               or window.shape != (x.shape[0], 4)
                               or not window.is_contiguous()):
        raise ValueError("window must be a contiguous (B, 4) int32 tensor on x's device")
    return dims


def _lib():
    if _LIB:
        return _LIB[0]
    from muscle_tpu_torch.ops import build

    lib = build.load("mbconv")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.mbconv_expand_dw_f32, lib.mbconv_expand_dw_bf16):
            fn.argtypes = [ptr] * 10 + [i32] * 9 + [ptr]
            fn.restype = i32
        for fn in (lib.mbconv_se_project_f32, lib.mbconv_se_project_bf16):
            fn.argtypes = [ptr] * 13 + [i32] * 8 + [ptr]
            fn.restype = i32
        lib.mbconv_partials_per_image.argtypes = [i32] * 4
        lib.mbconv_partials_per_image.restype = i32
        lib.mbconv_gate_floats.argtypes = [i32] * 2
        lib.mbconv_gate_floats.restype = i32
        lib.mbconv_error_string.argtypes = [i32]
        lib.mbconv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    _LIB.append(lib)
    return lib


_LIB = []  # the typed library, once loaded


# the kernel's channel granularity at both dtypes: TMA's 16-byte strides
CHANNEL_MULTIPLE = 8


def _pad_dims(t: torch.Tensor, names, dims: dict,
              multiple: int = CHANNEL_MULTIPLE) -> torch.Tensor:
    """``t`` (axes ``names``) zero-padded so that each axis named in
    ``dims`` has a multiple of ``multiple`` entries."""
    shape = tuple(-(-t.shape[i] // multiple) * multiple if n in dims else t.shape[i]
                  for i, n in enumerate(names))
    if shape == tuple(t.shape):
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _pad_channels(weights: dict, has_expand: bool) -> dict:
    """The weights zero-padded to channel counts that are multiples of
    ``CHANNEL_MULTIPLE``: padded input and mid channels stay 0 through
    every stage (zero weights, scale and bias; swish(0) = 0), padded output
    channels are dropped by the caller.  Exact."""
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


# the kernel's extra operands: the 1x1 weights K-major at padded channel
# counts; at float32 split for 3xTF32 and stacked (hi, lo)
KERNEL_OPERANDS = ("w_exp_kt", "w_proj_kt")
# the suffix of a weight's zero-padded copy for the kernel (kernel_operands)
PADDED = "_padded"


def _kernel_operand_shapes(cin: int, cmid: int, cout: int, dtype: torch.dtype) -> dict:
    lead = (2,) if dtype == torch.float32 else ()
    return {"w_exp_kt": lead + (cmid, cin), "w_proj_kt": lead + (cout, cmid)}


def kernel_operands(weights: dict, has_expand: bool) -> dict:
    """``w_exp_kt`` (Cmid', Cin') and ``w_proj_kt`` (Cout', Cmid'): the
    transposed 1x1 weights as the kernel's TMA loads them, at the channel
    counts padded to multiples of ``CHANNEL_MULTIPLE``; at float32 (hi, lo)
    of the 3xTF32 split stacked in a leading axis of 2, at bfloat16 the
    weights themselves.  Where a count needs padding, also each weight's
    padded copy as ``<name>_padded``.  ``MBConvBlock.fused_weights``
    caches them beside the folded weights, so a call pads no weight; the
    wrapper makes them when a dict lacks them."""
    wd = _pad_channels(weights, has_expand)
    names = {"w_proj_kt": "w_proj"} | ({"w_exp_kt": "w_exp"} if has_expand else {})
    out = {}
    for kt, n in names.items():
        t = wd[n].t().contiguous()
        out[kt] = torch.stack(split_tf32(t)) if t.dtype == torch.float32 else t
    out.update({n + PADDED: t for n, t in wd.items() if t is not weights[n]})
    return out


def _kernel_weights(weights: dict, x: torch.Tensor, dims: dict, has_expand: bool) -> dict:
    """The tensors the kernel takes, by weight name: ``weights`` itself
    when its K-major operands are there (``fused_weights``' cache) and no
    channel count needs padding; else with the padded copies in place of
    the weights, made here when the dict lacks them."""
    pad = lambda c: -(-c // CHANNEL_MULTIPLE) * CHANNEL_MULTIPLE  # noqa: E731
    cin, cmid, cout = pad(dims["Cin"]), pad(dims["Cmid"]), pad(dims["Cout"])
    padded = (cin, cmid, cout) != (dims["Cin"], dims["Cmid"], dims["Cout"])
    want = _kernel_operand_shapes(cin, cmid, cout, x.dtype)
    names = KERNEL_OPERANDS if has_expand else ("w_proj_kt",)
    if (padded and "w_dw" + PADDED not in weights) or any(
            n not in weights or weights[n].shape != want[n] or weights[n].dtype != x.dtype
            or weights[n].device != x.device for n in names):
        weights = {**weights, **kernel_operands(weights, has_expand)}
    if not padded:
        return weights
    return weights | {n: weights[n + PADDED] for n in WEIGHT_SHAPES if n + PADDED in weights}


def mbconv_stride1(x: torch.Tensor, weights: dict, window: torch.Tensor | None, *,
                   k: int, has_expand: bool, has_skip: bool, owned=None,
                   se_sum=None) -> torch.Tensor:
    """Inference stride-1 MBConv block on NHWC ``x`` (B, H, W, Cin),
    float32 or bfloat16; y comes back in x's dtype.

    weights: the folded tensors named in ``WEIGHT_SHAPES`` (``w_exp``,
    ``s0``, ``b0`` only when ``has_expand``), the ``MATRIX_WEIGHTS`` in
    x's dtype and the rest float32.  window: (B, 4) int32 (oy, ox, h, w)
    valid windows, or None for whole images.

    owned: (lo, hi) when x is a stripe of a taller image with halo rows
    above and below (``parallel/spatial.py``): only rows lo .. hi - 1
    are this call's, ``window`` is in x's rows (``shift_rows``), the SE
    sums of those rows, (B, 1, Cmid') float32, go through ``se_sum`` (in
    place: ``Stripes.sum`` adds the other stripes' sums) and are divided
    by the whole window's count, and y comes back for those rows only.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (building it on first use) or raises.  ``mbconv_stride1.launches``
    counts float32 kernel calls, ``mbconv_stride1.launches_bf16`` the
    bfloat16 ones: one a block call, its two entries (``_begin``, ``_end``)
    together.  The span ``mbconv`` (``utils/timers.py``) covers a card
    call's host work: the checks, the weights, the two C entries."""
    kw = dict(k=k, has_expand=has_expand, has_skip=has_skip, owned=owned)
    if x.device.type == "cpu":
        _check_call(x, weights, window, **kw)
        return mbconv_stride1_plain(x, weights, window, se_sum=se_sum, **kw)
    with span("mbconv"):  # the host's time a kernel call
        p = mbconv_stride1_begin(x, weights, window, **kw)
        if se_sum is not None:
            se_sum(p.part)
        return mbconv_stride1_end(p)


def _check_call(x, weights, window, *, k, has_expand, has_skip, owned) -> dict:
    if x.requires_grad:
        raise RuntimeError("mbconv_stride1 is inference-only (the kernel has no "
                           "backward); call it under torch.inference_mode()")
    dims = _check(x, weights, window, k, has_expand, has_skip)
    if owned is not None and not 0 <= owned[0] < owned[1] <= x.shape[1]:
        raise ValueError(f"owned rows {owned} outside x's {x.shape[1]} rows")
    return dims


def mbconv_stride1_begin(x: torch.Tensor, weights: dict, window: torch.Tensor | None, *,
                         k: int, has_expand: bool, has_skip: bool,
                         owned=None) -> MBConvPartial:
    """The block's first stage (``mbconv_stride1``'s arguments): on a card
    the kernel's launch (a), ``d`` and the SE partial sums of the rows
    ``owned`` (summed over its tiles to one per image when ``owned`` is
    given); on the CPU the plain version's."""
    dims = _check_call(x, weights, window, k=k, has_expand=has_expand, has_skip=has_skip,
                       owned=owned)
    if x.device.type == "cpu":
        return _plain_begin(x, weights, window, k=k, has_expand=has_expand, has_skip=has_skip,
                            owned=owned)
    if x.device.type != "cuda":
        raise ValueError(f"mbconv_stride1 runs on cpu or cuda, not {x.device}")
    lib = _lib()
    win = full_window(x) if window is None else window
    wd = _kernel_weights(weights, x, dims, has_expand)
    xk = _pad_dims(x, ("B", "H", "W", "Cin"), {"Cin"})
    b, h, w, cin = xk.shape
    cmid = wd["w_dw"].shape[1]
    ntiles = lib.mbconv_partials_per_image(h, w, k, int(has_expand))
    d = torch.empty((b, h, w, cmid), dtype=x.dtype, device=x.device)
    part = torch.empty((b, ntiles, cmid), dtype=torch.float32, device=x.device)
    lo, hi = (0, h) if owned is None else owned
    rc = (lib.mbconv_expand_dw_bf16 if x.dtype == torch.bfloat16 else lib.mbconv_expand_dw_f32)(
        _ptr(xk), _ptr(win), _ptr(wd.get("w_exp_kt")), _ptr(wd.get("s0")), _ptr(wd.get("b0")),
        _ptr(wd["w_dw"]), _ptr(wd["s1"]), _ptr(wd["b1"]), _ptr(d), _ptr(part),
        b, h, w, cin, cmid, k, int(has_expand), lo, hi, _stream(x))
    if rc != 0:
        raise RuntimeError(f"mbconv kernel launch failed: {lib.mbconv_error_string(rc).decode()}")
    if owned is not None:  # one partial per image, for the sum over the stripes
        part = part.sum(dim=1, keepdim=True)
    return MBConvPartial(xk, wd, win, d, part, has_skip, owned, cout=dims["Cout"])


def mbconv_stride1_end(p: MBConvPartial) -> torch.Tensor:
    """The block's second stage: on a card the kernel's launches (b) and
    (c), the SE gate from ``p.part`` and the project; y of the rows
    ``p.owned`` (all rows when None), in x's dtype."""
    if p.x.device.type == "cpu":
        return _plain_end(p)
    lib = _lib()
    wd, xk = p.weights, p.x
    b, h, w, _ = xk.shape
    cmid, cout, csq = wd["w_dw"].shape[1], wd["w_proj"].shape[1], wd["w_se_r"].shape[1]
    gate = torch.empty((b, lib.mbconv_gate_floats(cmid, csq)), dtype=torch.float32,
                       device=xk.device)
    y = torch.empty((b, h, w, cout), dtype=xk.dtype, device=xk.device)
    bf16 = xk.dtype == torch.bfloat16
    rc = (lib.mbconv_se_project_bf16 if bf16 else lib.mbconv_se_project_f32)(
        _ptr(xk), _ptr(p.win), _ptr(p.part), _ptr(wd["w_se_r"]), _ptr(wd["b_se_r"]),
        _ptr(wd["w_se_e"]), _ptr(wd["b_se_e"]), _ptr(wd["w_proj_kt"]), _ptr(wd["s2"]),
        _ptr(wd["b2"]), _ptr(p.d), _ptr(gate), _ptr(y),
        b, h, w, cmid, csq, cout, p.part.shape[1], int(p.has_skip), _stream(xk))
    if rc != 0:
        raise RuntimeError(f"mbconv kernel launch failed: {lib.mbconv_error_string(rc).decode()}")
    if bf16:
        mbconv_stride1.launches_bf16 += 1
    else:
        mbconv_stride1.launches += 1
    if p.owned is not None:
        y = y[:, p.owned[0]:p.owned[1]]
    return y if cout == p.cout else y[..., :p.cout].contiguous()


def _ptr(t: torch.Tensor | None) -> int:
    """A tensor's address for a ``c_void_p`` argument (0 for None)."""
    return 0 if t is None else t.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


mbconv_stride1.launches = 0
mbconv_stride1.launches_bf16 = 0


def block_work(b: int, h: int, w: int, cin: int, cmid: int, csq: int, cout: int, k: int,
               has_expand: bool, dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """(bytes, FLOPs) of one block call: x read and y written once and the
    weight matrices read once, in ``dtype``, the f32 scales, biases and
    windows once (the expanded map never leaves the chip), and the three
    products' multiply-adds."""
    px = b * h * w
    size = torch.finfo(dtype).bits // 8
    matrices = (cin * cmid if has_expand else 0) + k * k * cmid + 2 * cmid * csq + cmid * cout
    vectors = (2 * cmid if has_expand else 0) + 2 * cmid + csq + cmid + 2 * cout
    nbytes = size * (px * (cin + cout) + matrices) + 4 * (vectors + b * 4)
    flops = 2 * px * ((cin * cmid if has_expand else 0) + k * k * cmid + cmid * cout)
    return nbytes, flops


def block_flops(b: int, h: int, w: int, cin: int, cmid: int, cout: int, k: int,
                has_expand: bool) -> tuple[int, int]:
    """(FLOPs of the 1x1 products, FLOPs of the depthwise) of one block
    call; their sum is ``block_work``'s FLOPs."""
    px = b * h * w
    return 2 * px * ((cin * cmid if has_expand else 0) + cmid * cout), 2 * px * k * k * cmid


def bound_tc_ms(nbytes: float, product_flops: float, depthwise_flops: float,
                dtype: torch.dtype = torch.float32) -> tuple[float, str]:
    """(least time in ms an H100 SXM could take for a block with the 1x1
    products on the tensor cores, in the 3xTF32 split at float32 or as
    bf16 products at bfloat16, and the depthwise on the f32 pipes, what
    bounds it: 'bytes' or 'operations')."""
    rate = TC_BF16_FLOPS_PER_S if dtype == torch.bfloat16 else TC_3XTF32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (product_flops / rate + depthwise_flops / F32_FLOPS_PER_S) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """(least time in ms an H100 SXM could take to move ``nbytes`` and do
    ``flops`` f32 operations, what bounds it: 'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
