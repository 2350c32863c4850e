"""EfficientNet backbone (b0-b8) in PyTorch (port of
``muscle_tpu/models/efficientnet.py``).

Module and parameter names follow the reference's state dict
(``_conv_stem``, ``_bn0``, ``_blocks.{i}._expand_conv`` ...).  Tensors
cross module boundaries as NHWC, like the JAX package; inside a module they
are viewed as NCHW with channels-last strides (``permute``, no copy), which
is the layout cuDNN and the MBConv kernel both want.

* stride-1 convs pad k//2 on each side (== TF-SAME at stride 1);
* stride-2 convs use the reference's static pads, total k - 2 split
  ((k-2)//2, rest), then convolve unpadded: odd inputs give the floor size
  chain (25 -> 12 -> 6), which ``padding='same'`` would not;
* BatchNorm eps 1e-3, torch momentum 0.01 (Flax momentum 0.99), whose
  train-mode running variance takes the biased batch variance, as Flax's
  does (``BatchNorm2d``);
* in training, drop-connect (stochastic depth per sample) on the residual
  of the stride-1 Cin == Cout blocks, at rate 0.2 * block / blocks;
* ``forward`` returns every block output (the reference's 26-deep pyramid
  for b3) and, given ``valid_window``, re-zeroes features outside each
  image's window after every BN so a padded canvas computes what the
  reference computes on the unpadded image;
* ``fuse_max_in_filters`` runs eligible stride-1 blocks in inference
  (eval mode, no autograd) through the MBConv kernel (ops/mbconv.py);
* the forward computes in its input's dtype, float32 or bfloat16, with
  float32 parameters, as Flax's ``dtype=bf16`` does (``models/layers.py``):
  convolutions and their outputs in bf16, batch norms in f32 rounded to
  bf16, masks and the SE mean in bf16;
* given ``stripes`` (``parallel/spatial.py``; inference, float32 or
  bfloat16) the forward runs on this rank's stripe of the canvas: each
  conv takes halo rows from the neighbouring stripes (k//2 at stride 1,
  the static pad at stride 2) and pads only its width, the window masks
  are taken in image rows, and the SE means add the stripes' float32 sums
  (at bfloat16 rounded once after, as jnp's sum of a bf16 map); from the
  first stride-2 conv whose stripes would not halve (``Stripes.can_halve``)
  the level is gathered and the rest runs whole on every rank.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from muscle_tpu_torch.models.layers import Conv2d, norm_in_f32
from muscle_tpu_torch.ops.mbconv import (
    MATRIX_WEIGHTS,
    fold_bn,
    kernel_operands,
    mbconv_stride1,
    shift_rows,
    window_mask,
)
from muscle_tpu_torch.ops.sync_bn import sync_bn
from muscle_tpu_torch.parallel.mesh import draw_rows, world


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    kernel_size: int
    num_repeat: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    stride: int
    se_ratio: float | None = 0.25
    id_skip: bool = True


# Stage table shared by every variant before compound scaling;
# ``last_pooling`` toggles stage 6's stride.
_BASE_STAGES = (
    BlockArgs(3, 1, 32, 16, 1, 1),
    BlockArgs(3, 2, 16, 24, 6, 2),
    BlockArgs(5, 2, 24, 40, 6, 2),
    BlockArgs(3, 3, 40, 80, 6, 2),
    BlockArgs(5, 3, 80, 112, 6, 1),
    BlockArgs(5, 4, 112, 192, 6, 2),  # stride -> 1 when last_pooling=False
    BlockArgs(3, 1, 192, 320, 6, 1),
)

# width, depth, resolution, dropout
_SCALING = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    "efficientnet-b8": (2.2, 3.6, 672, 0.5),
}

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torch convention; Flax's 0.99


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """Compound width scaling."""
    if not width:
        return filters
    filters *= width
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth: float) -> int:
    """Compound depth scaling."""
    if not depth:
        return repeats
    return int(math.ceil(depth * repeats))


def efficientnet_config(model_name: str, last_pooling: bool = True
                        ) -> tuple[tuple[BlockArgs, ...], float]:
    """One BlockArgs per block (flattened stages) and the drop-connect
    rate."""
    width, depth, _, _ = _SCALING[model_name]
    blocks: list[BlockArgs] = []
    for stage_idx, stage in enumerate(_BASE_STAGES):
        stride = stage.stride
        if stage_idx == 5 and not last_pooling:
            stride = 1
        inp = round_filters(stage.input_filters, width)
        outp = round_filters(stage.output_filters, width)
        repeats = round_repeats(stage.num_repeat, depth)
        blocks.append(dataclasses.replace(stage, input_filters=inp, output_filters=outp,
                                          stride=stride))
        for _ in range(repeats - 1):
            blocks.append(dataclasses.replace(stage, input_filters=outp,
                                              output_filters=outp, stride=1))
    return tuple(blocks), 0.2


def _static_pad(kernel_size: int) -> tuple[int, int]:
    """The reference's stride-2 pad (low, high) on each spatial axis:
    k3 -> (0, 1), k5 -> (1, 2)."""
    lo = (kernel_size - 2) // 2
    return lo, kernel_size - 2 - lo


def advance_window(win):
    """Valid-window transform across one static-pad stride-2 conv:
    (oy, ox, h, w) -> floor halves.  ``win``: (..., 4) int, torch or
    numpy."""
    return win // 2


def placement_offset(sizes, n_strided: int):
    """Per-image canvas placement (oy, ox) keeping each valid window
    stride-grid aligned through ``n_strided`` static-pad stride-2 convs:
    identically zero, since the static pads do not depend on the size."""
    if isinstance(sizes, torch.Tensor):
        return torch.zeros_like(sizes[..., :2])
    return np.zeros_like(np.asarray(sizes)[..., :2])


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update of ``running_var`` takes
    the biased batch variance, as Flax's ``BatchNorm`` does (torch's takes
    the unbiased one).  Normalisation is unchanged: both normalise with
    the biased variance.  A bfloat16 input is normalised in float32 and the
    output rounded to bfloat16, as Flax's ``BatchNorm(dtype=bf16)``; on
    batch statistics with JAX's input gradient (``_LowpBatchStatsNorm``;
    one float32 batch norm under ``torch.func`` transforms, which take no
    autograd Function without a forward-mode rule).

    ``dp_group`` (set by ``parallel.replicate``): with more than one rank,
    train-mode statistics are those of the global batch, as Flax's under a
    sharded batch (``ops/sync_bn.py``: its kernels on a card, float32
    math at either dtype, JAX's input-gradient rounding at bfloat16);
    ``torch.func`` transforms (the liveness probes) stay rank-local."""

    dp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and self.track_running_stats:  # running statistics
            return norm_in_f32(super().forward, x)
        wrapped = torch._C._functorch.is_functorch_wrapped_tensor(x)
        if world(self.dp_group) > 1 and not wrapped:
            return self._synced(x)
        if x.dtype == torch.float32 or wrapped:
            return norm_in_f32(lambda t: self._on_batch_stats(t, F.batch_norm), x)
        return self._on_batch_stats(x, _LowpBatchStatsNorm.apply)

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """Batch statistics over every rank's batch (``ops/sync_bn.py``),
        with Flax's update of the running statistics (biased variance) when
        they are tracked."""
        running = None
        if self.track_running_stats:
            running = (self.running_mean, self.running_var, self.num_batches_tracked,
                       self.momentum)
        return sync_bn(x, self.weight, self.bias, self.eps, self.dp_group, running)

    def _on_batch_stats(self, x: torch.Tensor, norm) -> torch.Tensor:
        """``norm`` (``F.batch_norm``'s signature) on x's batch statistics,
        then Flax's update of the running statistics when they are
        tracked: ``norm`` updates running_mean as Flax does, and a copy of
        running_var (autograd keeps that copy as it was after the call),
        from which the biased update follows."""
        if not self.track_running_stats:
            return norm(x, None, None, self.weight, self.bias, True, self.momentum, self.eps)
        self.num_batches_tracked.add_(1)
        m = self.momentum
        var = self.running_var.clone()
        y = norm(x, self.running_mean, var, self.weight, self.bias, True, m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            # var = (1 - m) old + m v n / (n - 1); keep (1 - m) old + m v
            self.running_var.mul_((1.0 - m) / n).add_(var, alpha=(n - 1) / n)
        return y


class _LowpBatchStatsNorm(torch.autograd.Function):
    """Flax's batch norm on batch statistics for a bfloat16 ``x``: float32
    math on a float32 copy of x, the output rounded once.  Its input
    gradient is JAX's: autodiff of Flax's ``BatchNorm`` casts x to float32
    twice (once for the statistics, once for the normalisation) and each
    cast's transpose rounds its path's cotangent to bf16 before the two
    are summed in bf16.  So the backward splits torch's float32 input
    gradient into the normalisation's path, g * scale * rsqrt(var + eps),
    and the rest (the statistics'), and rounds each: one float32 batch
    norm rounds their sum once and puts 28% of the input gradient's
    entries one bf16 ulp from JAX's.  Takes ``F.batch_norm``'s arguments
    (training only) and updates the running statistics as it does."""

    @staticmethod
    def forward(ctx, x, running_mean, running_var, weight, bias, training, momentum, eps):
        y, mean, invstd = torch.ops.aten.native_batch_norm(
            x.to(torch.float32), weight, bias, running_mean, running_var, training, momentum,
            eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.eps = eps
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, invstd = ctx.saved_tensors
        g = gy.to(torch.float32)
        dx, dw, db = torch.ops.aten.native_batch_norm_backward(
            g, x.to(torch.float32), weight, None, None, mean, invstd, True, ctx.eps,
            [True, True, True])
        direct = g * (invstd * weight)[:, None, None]
        return (direct.to(x.dtype) + (dx - direct).to(x.dtype), None, None, dw, db, None,
                None, None)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def drop_connect(x: torch.Tensor, rate: float,
                 generator: torch.Generator | None = None, group=None) -> torch.Tensor:
    """Per-sample stochastic depth: each sample of ``x`` is kept with
    probability 1 - rate (floor(keep + U)) and scaled by 1 / keep.  With a
    data-parallel ``group``, U is this rank's rows of the global batch's
    draw (``parallel.draw_rows``)."""
    keep = 1.0 - rate
    u = draw_rows((x.shape[0],) + (1,) * (x.ndim - 1), generator, group, dtype=x.dtype,
                  device=x.device)
    return x / keep * torch.floor(keep + u)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck: expand 1x1 -> BN -> swish -> depthwise
    k x k -> BN -> swish -> squeeze-excite -> project 1x1 -> BN
    (+ identity).  ``dp_group`` (``parallel.replicate``): drop-connect
    draws the global batch's mask and keeps this rank's rows."""

    dp_group = None

    def __init__(self, args: BlockArgs):
        super().__init__()
        self.args = args
        cin, oup = args.input_filters, args.input_filters * args.expand_ratio
        if args.expand_ratio != 1:
            self._expand_conv = Conv2d(cin, oup, 1, bias=False)
            self._bn0 = _bn(oup)
        k = args.kernel_size
        self._depthwise_conv = Conv2d(
            oup, oup, k, stride=args.stride, groups=oup, bias=False,
            padding=k // 2 if args.stride == 1 else 0,
        )
        self._bn1 = _bn(oup)
        self.has_se = args.se_ratio is not None and 0 < args.se_ratio <= 1
        if self.has_se:
            squeezed = max(1, int(cin * args.se_ratio))
            self._se_reduce = Conv2d(oup, squeezed, 1)
            self._se_expand = Conv2d(squeezed, oup, 1)
        self._project_conv = Conv2d(oup, args.output_filters, 1, bias=False)
        self._bn2 = _bn(args.output_filters)
        self._fused = {}  # dtype -> (key, weights)

    def fusable(self) -> bool:
        """Whether the MBConv kernel can run this block: stride 1,
        inference (eval mode and no autograd: the kernel has no backward),
        squeeze-excite, and a residual iff Cin == Cout."""
        a = self.args
        return (not self.training and not torch.is_grad_enabled() and a.stride == 1
                and self.has_se
                and (a.id_skip or a.input_filters != a.output_filters))

    def fused_weights(self, dtype: torch.dtype = torch.float32) -> dict:
        """The block's weights as ``ops.mbconv.mbconv_stride1`` takes them
        for a ``dtype`` forward: 1x1 kernels as (in, out) matrices, the
        depthwise kernel as (k*k, C), the batch norms folded to float32
        scale and bias, the matrices (``MATRIX_WEIGHTS``) in ``dtype``, and
        on a card the kernel's extra operands (``kernel_operands``).
        Cached per dtype until a parameter or statistic changes (their
        version counters move); refolding on every forward costs ~15 small
        launches per block.  Modules built under inference mode keep no
        version counters and refold every time."""
        srcs = [t for m in self.modules() for n, t in (*m._parameters.items(),
                                                       *m._buffers.items())
                if t is not None and n != "num_batches_tracked"]
        key = None
        if not any(t.is_inference() for t in srcs):
            key = tuple([(t.data_ptr(), t._version) for t in srcs])
        hit = self._fused.get(dtype)
        if key is None or hit is None or hit[0] != key:
            hit = (key, self._fold(dtype))
            self._fused[dtype] = hit
        return hit[1]

    @torch.no_grad()
    def _fold(self, dtype: torch.dtype) -> dict:
        a = self.args
        cin, cmid, cout = a.input_filters, a.input_filters * a.expand_ratio, a.output_filters
        k = a.kernel_size

        def bn(m):
            return fold_bn(m.weight, m.bias, m.running_mean, m.running_var, m.eps)

        def t(w, rows, cols):  # 1x1 conv weight (O, I, 1, 1) -> (I, O)
            return w.reshape(cols, rows).t()

        wd = {}
        if a.expand_ratio != 1:
            wd["w_exp"] = t(self._expand_conv.weight, cin, cmid)
            wd["s0"], wd["b0"] = bn(self._bn0)
        wd["w_dw"] = self._depthwise_conv.weight.reshape(cmid, k * k).t()
        wd["s1"], wd["b1"] = bn(self._bn1)
        csq = self._se_reduce.weight.shape[0]
        wd["w_se_r"] = t(self._se_reduce.weight, cmid, csq)
        wd["b_se_r"] = self._se_reduce.bias
        wd["w_se_e"] = t(self._se_expand.weight, csq, cmid)
        wd["b_se_e"] = self._se_expand.bias
        wd["w_proj"] = t(self._project_conv.weight, cmid, cout)
        wd["s2"], wd["b2"] = bn(self._bn2)
        wd = {n: v.detach().to(dtype if n in MATRIX_WEIGHTS else torch.float32).contiguous()
              for n, v in wd.items()}
        if wd["w_proj"].is_cuda:  # the kernel's K-major 1x1 weights
            wd.update(kernel_operands(wd, a.expand_ratio != 1))
        return wd

    def forward(self, x: torch.Tensor, drop_rate: float = 0.0,
                mask_in: torch.Tensor | None = None, mask_out: torch.Tensor | None = None,
                se_count: torch.Tensor | None = None, fused: bool = False,
                window: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: NHWC, float32 or bfloat16 (the compute dtype).  mask_in/mask_out:
        optional (N, H, W, 1) valid-window indicators at the block's
        input/output resolution, se_count the per-image valid pixel count
        (N, 1, 1, 1) for a masked SE mean, all in x's dtype.
        fused: run the block through the MBConv kernel when ``fusable``;
        ``window`` is the (N, 4) scalar form of the masks it takes.
        drop_rate, generator: the training-mode drop-connect and where it
        draws."""
        a = self.args
        if fused and self.fusable():
            if window is not None:
                window = window.to(torch.int32).contiguous()
            return mbconv_stride1(
                x.contiguous(), self.fused_weights(x.dtype), window, k=a.kernel_size,
                has_expand=a.expand_ratio != 1,
                has_skip=a.input_filters == a.output_filters,
            )
        inputs = x
        h = _nchw(x)
        if a.expand_ratio != 1:
            h = F.silu(self._bn0(self._expand_conv(h)))
            if mask_in is not None:
                h = h * _nchw(mask_in)
        if a.stride != 1:
            lo, hi = _static_pad(a.kernel_size)
            h = F.pad(h, (lo, hi, lo, hi))
        h = F.silu(self._bn1(self._depthwise_conv(h)))
        if mask_out is not None:
            h = h * _nchw(mask_out)
        if self.has_se:
            if se_count is None:
                se = h.mean(dim=(2, 3), keepdim=True)
            else:
                se = h.sum(dim=(2, 3), keepdim=True) / _nchw(se_count)
            se = self._se_expand(F.silu(self._se_reduce(se)))
            h = torch.sigmoid(se) * h
        h = self._bn2(self._project_conv(h))
        if mask_out is not None:
            h = h * _nchw(mask_out)
        out = _nhwc(h)
        if a.id_skip and a.stride == 1 and a.input_filters == a.output_filters:
            if self.training and drop_rate > 0.0:
                out = drop_connect(out, drop_rate, generator, self.dp_group)
            out = out + inputs
        return out

    def forward_stripe(self, x: torch.Tensor, stripes, win_in: torch.Tensor,
                       win: torch.Tensor, se_count: torch.Tensor,
                       fused: bool = False) -> torch.Tensor:
        """Inference on this rank's stripe ``x`` (N, s, W, Cin) of a level
        split over ``stripes``: win_in / win the (N, 4) windows at the
        block's input / output grid in image rows, se_count the SE mean's
        (N, 1, 1, 1) whole-window pixel count.  Returns the block's output
        stripe.  The halo rows are exchanged on x (Cin channels, fewer
        than the expanded Cmid); fused runs the MBConv kernel on the stripe
        with its halo, the SE partials summed over the group."""
        a = self.args
        k, s = a.kernel_size, x.shape[1]
        row0 = stripes.row0(s)
        if fused and self.fusable():
            p = k // 2
            return mbconv_stride1(
                stripes.halo(x, p, p).contiguous(), self.fused_weights(x.dtype),
                shift_rows(win, row0 - p).contiguous(), k=k, has_expand=a.expand_ratio != 1,
                has_skip=a.input_filters == a.output_filters, owned=(p, p + s),
                se_sum=stripes.sum)
        lo, hi = (k // 2, k // 2) if a.stride == 1 else _static_pad(k)
        xe = stripes.halo(x, lo, hi)
        h = _nchw(xe)
        if a.expand_ratio != 1:
            h = F.silu(self._bn0(self._expand_conv(h)))
        # the window in the halo's rows: rows beyond the image are zero, as
        # the whole image's conv pads them
        h = h * _nchw(window_mask(xe.shape[1:3], win_in, h.dtype, row0=row0 - lo))
        if a.stride == 1:  # the conv pads k//2 on both axes: keep the own rows
            h = self._depthwise_conv(h)[:, :, lo:lo + s]
        else:  # the halo is the height's static pad; pad the width
            h = self._depthwise_conv(F.pad(h, (lo, hi, 0, 0)))
        h = F.silu(self._bn1(h))
        mask = _nchw(window_mask((h.shape[2], h.shape[3]), win, h.dtype,
                                 row0=stripes.row0(h.shape[2])))
        h = h * mask
        # the stripes' float32 partials summed, then rounded once to x's dtype
        se = stripes.sum(h.sum(dim=(2, 3), keepdim=True, dtype=torch.float32))
        se = se.to(h.dtype) / _nchw(se_count)
        h = torch.sigmoid(self._se_expand(F.silu(self._se_reduce(se)))) * h
        out = _nhwc(self._bn2(self._project_conv(h)) * mask)
        if a.id_skip and a.stride == 1 and a.input_filters == a.output_filters:
            out = out + x
        return out


class EfficientNet(nn.Module):
    """EfficientNet feature-pyramid extractor: ``forward`` returns the list
    of all per-block outputs (NHWC)."""

    def __init__(self, model_name: str = "efficientnet-b3", last_pooling: bool = True,
                 fuse_max_in_filters: int = 0):
        super().__init__()
        self.model_name = model_name
        self.block_args, self.drop_connect_rate = efficientnet_config(model_name, last_pooling)
        # stride-1 blocks with input_filters <= this many channels run
        # through the MBConv kernel in inference (0 disables)
        self.fuse_max_in_filters = fuse_max_in_filters
        stem = round_filters(32, _SCALING[model_name][0])
        self._conv_stem = Conv2d(3, stem, 3, stride=2, bias=False)
        self._bn0 = _bn(stem)
        self._blocks = nn.ModuleList(MBConvBlock(a) for a in self.block_args)

    def forward(self, x: torch.Tensor, valid_window: torch.Tensor | None = None,
                generator: torch.Generator | None = None, stripes=None) -> list[torch.Tensor]:
        """x: (N, H, W, 3), in the compute dtype (float32 or bfloat16; every
        block output comes back in it).  valid_window: optional (N, 4) int
        (oy, ox, h, w) per-image windows inside the canvas, with (oy, ox)
        from placement_offset(); features are re-zeroed outside the
        per-stage window after every BN and SE pools over the window, which
        makes the canvas forward equal the unpadded one.  generator: where
        training's drop-connect draws (``drop_connect_rate`` 0 turns it
        off).  stripes: x is this rank's stripe of the canvas, valid_window
        in canvas rows (``forward_stripes``)."""
        if stripes is not None:
            return self.forward_stripes(x, stripes, valid_window)
        lo, hi = _static_pad(3)
        h = F.pad(_nchw(x), (lo, hi, lo, hi))
        x = _nhwc(F.silu(self._bn0(self._conv_stem(h))))
        win = mask = count = None
        if valid_window is not None:
            win = advance_window(valid_window)  # the stem is stride 2
            mask = window_mask(x.shape[1:3], win, x.dtype)
            count = (win[:, 2] * win[:, 3]).to(x.dtype)[:, None, None, None]
            x = x * mask

        pyramid = []
        n_blocks = len(self.block_args)
        for idx, (args, block) in enumerate(zip(self.block_args, self._blocks)):
            rate = self.drop_connect_rate * idx / n_blocks
            mask_in = mask
            if win is not None and args.stride == 2:
                win = advance_window(win)
                mask = window_mask(((x.shape[1] + 1) // 2, (x.shape[2] + 1) // 2), win, x.dtype)
                count = (win[:, 2] * win[:, 3]).to(x.dtype)[:, None, None, None]
            x = block(x, drop_rate=rate, mask_in=mask_in, mask_out=mask, se_count=count,
                      fused=args.input_filters <= self.fuse_max_in_filters, window=win,
                      generator=generator)
            pyramid.append(x)
        return pyramid

    def block_strides(self) -> list[int]:
        """Each block output's stride in canvas pixels (the stem's 2 first)."""
        out, stride = [], 2
        for a in self.block_args:
            stride *= a.stride
            out.append(stride)
        return out

    def forward_stripes(self, x: torch.Tensor, stripes,
                        valid_window: torch.Tensor | None = None) -> list[torch.Tensor]:
        """Inference on this rank's stripe ``x`` (N, s, W, 3) of a canvas of
        s x ``stripes.size`` rows (module docstring): the pyramid, each level
        this rank's stripe, or whole from the level that was gathered on.
        Without ``valid_window`` the whole canvas is the window, which masks
        the halo rows beyond the image as the convs' zero padding would."""
        if self.training or torch.is_grad_enabled():
            raise RuntimeError("a striped forward is inference-only: eval mode under "
                               "torch.inference_mode()")
        n, s, w, _ = x.shape
        if not stripes.can_halve(s):
            raise ValueError(f"a canvas of {s * stripes.size} rows does not split into "
                             f"{stripes.size} stripes that halve through the stem")
        win = valid_window
        if win is None:
            win = torch.zeros((n, 4), dtype=torch.int32, device=x.device)
            win[:, 2], win[:, 3] = s * stripes.size, w
        lo, hi = _static_pad(3)
        h = F.pad(_nchw(stripes.halo(x, lo, hi)), (lo, hi, 0, 0))
        x = _nhwc(F.silu(self._bn0(self._conv_stem(h))))
        win = advance_window(win)
        count = (win[:, 2] * win[:, 3]).to(x.dtype)[:, None, None, None]
        x = x * window_mask(x.shape[1:3], win, x.dtype, row0=stripes.row0(x.shape[1]))

        pyramid, mask = [], None  # mask: the level's, once it is whole
        for args, block in zip(self.block_args, self._blocks):
            fused = args.input_filters <= self.fuse_max_in_filters
            win_in, mask_in = win, mask
            if args.stride == 2:
                if mask is None and not stripes.can_halve(x.shape[1]):
                    x = stripes.gather(x)
                    mask_in = window_mask(x.shape[1:3], win, x.dtype)
                win = advance_window(win)
                count = (win[:, 2] * win[:, 3]).to(x.dtype)[:, None, None, None]
                if mask_in is not None:
                    mask = window_mask(((x.shape[1] + 1) // 2, (x.shape[2] + 1) // 2), win,
                                       x.dtype)
            if mask is None:
                x = block.forward_stripe(x, stripes, win_in, win, count, fused=fused)
            else:
                x = block(x, mask_in=mask_in, mask_out=mask, se_count=count, fused=fused,
                          window=win)
            pyramid.append(x)
        return pyramid
