"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA card and skips without one (the
kernels have no CPU or interpret mode).  This file imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from muscle_tpu_torch.models.efficientnet import BlockArgs, MBConvBlock
from muscle_tpu_torch.models.muscle import init_weights
from muscle_tpu_torch.ops import mbconv as M
from muscle_tpu_torch.ops import random_walk as R
from muscle_tpu_torch.ops.banded_walk import banded_walk, banded_walk_plain
from muscle_tpu_torch.ops.stencil_walk import stencil_walk, stencil_walk_plain

# f32 kernel against f32 plain version (TF32 off): summation order only
ATOL, RTOL = 1e-4, 1e-4
# bf16 kernel against the bf16 plain version, relative to the output's
# largest value: y is rounded once in both (one bf16 ulp is 2^-8 of the
# leading power of two), the f32 sums run in another order, and the kernel
# keeps each depthwise product exact where the plain version (as the
# Pallas kernel) rounds it to bf16
BF16_REL = 2.0 ** -7
# the walks: the JAX package's bounds for its walk kernels, summation order
# compounded over the steps
STENCIL_RTOL, STENCIL_ATOL = 2e-4, 1e-6
BANDED_RTOL, BANDED_ATOL = 2e-3, 1e-5

CASES = {
    # name: (BlockArgs, h, w, windows (h, w) per image or None)
    "k3_expand": (BlockArgs(3, 1, 24, 24, 6, 1), 24, 40, None),
    "k5_expand": (BlockArgs(5, 1, 32, 32, 6, 1), 19, 33, None),
    "no_expand": (BlockArgs(3, 1, 40, 40, 1, 1), 24, 24, None),
    "no_expand_k5": (BlockArgs(5, 1, 24, 24, 1, 1), 13, 21, [(13, 21), (9, 17)]),
    "windowed": (BlockArgs(3, 1, 24, 24, 6, 1), 24, 40, [(17, 29), (24, 40)]),
    "no_skip": (BlockArgs(3, 1, 24, 40, 6, 1), 20, 28, None),
    "no_skip_windowed": (BlockArgs(5, 1, 32, 48, 6, 1), 20, 28, [(13, 21), (20, 28)]),
    # Cmid = 30: not a multiple of the 32-channel tile nor of 4 (the
    # project GEMM's scalar path), Csq = 1
    "odd_channels": (BlockArgs(3, 1, 5, 7, 6, 1), 11, 37, [(11, 30), (5, 37)]),
    # b3 _blocks_25 widths on a small grid
    "wide": (BlockArgs(3, 1, 384, 384, 6, 1), 6, 8, [(6, 7), (3, 8)]),
    # b3 _blocks_0 widths (expand ratio 1) on a grid of many tiles, windowed
    "many_tiles_no_expand": (BlockArgs(3, 1, 40, 40, 1, 1), 64, 96, [(64, 90), (50, 96)]),
    # expand 6 at b3 _blocks_3 widths
    "many_tiles_expand": (BlockArgs(3, 1, 32, 32, 6, 1), 48, 64, None),
    # Cmid 2304 on a grid that is not a multiple of any tile, windowed
    "wide_ragged": (BlockArgs(3, 1, 384, 384, 6, 1), 13, 21, [(13, 20), (9, 21)]),
    # a grid smaller than one tile
    "tiny_grid": (BlockArgs(5, 1, 24, 24, 6, 1), 3, 5, None),
    # b7 seg shapes (MuSCLe-b7 dec, fuse_mbconv=384): k 5 at Cin 384 /
    # Cmid 2304 (_blocks_39-50, stride 32 of the 896 canvas: 28 x 28)
    "b7_k5_wide": (BlockArgs(5, 1, 384, 384, 6, 1), 28, 28, [(28, 21), (22, 28)]),
    # Cout 640: ten project N-tiles (_blocks_51)
    "b7_cout640": (BlockArgs(3, 1, 384, 640, 6, 1), 28, 22, [(28, 22), (21, 16)]),
    # 64 -> 32, no expand and no residual (_blocks_0), windowed
    "b7_no_expand_no_skip": (BlockArgs(3, 1, 64, 32, 1, 1), 64, 96, [(64, 90), (47, 96)]),
    # a 448 x 448 grid (stride 2 of the 896 canvas: _blocks_1-3)
    "b7_grid448": (BlockArgs(3, 1, 32, 32, 1, 1), 448, 448, [(448, 336), (336, 448)]),
    # the channel granularity of 8 (b3's widths are multiples of 8, not of
    # 16): 40 -> 24 without an expand (_blocks_0), windowed
    "b3_40_to_24": (BlockArgs(3, 1, 40, 24, 1, 1), 50, 70, [(50, 66), (41, 70)]),
    # Cin 40: one K chunk whose last 16-deep step holds 8 real channels
    "b3_cin40": (BlockArgs(3, 1, 40, 40, 6, 1), 23, 29, None),
    # Cout 136, k 5 on a grid that is a multiple of no tile (_blocks_13)
    "b3_cout136_k5": (BlockArgs(5, 1, 96, 136, 6, 1), 19, 27, [(19, 25), (13, 27)]),
    # 136 and 232 in and out (_blocks_14, _blocks_19)
    "b3_136": (BlockArgs(5, 1, 136, 136, 6, 1), 13, 21, [(13, 20), (9, 21)]),
    "b3_232": (BlockArgs(5, 1, 232, 232, 6, 1), 11, 19, [(11, 17), (11, 19)]),
    # Cin 20 (Cmid 120): a width that still needs padding, to 24 / 128
    "pad_cin20": (BlockArgs(3, 1, 20, 24, 6, 1), 21, 35, [(21, 30), (15, 35)]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(case, device):
    args, h, w, sizes = CASES[case]
    gen = torch.Generator().manual_seed(len(case))
    block = init_weights(MBConvBlock(args), gen).eval().to(device)
    x = torch.randn((2, h, w, args.input_filters), generator=gen).to(device)
    win = None
    if sizes is not None:
        win = torch.tensor([[0, 0, a, b] for a, b in sizes], dtype=torch.int32, device=device)
    kw = dict(k=args.kernel_size, has_expand=args.expand_ratio != 1,
              has_skip=args.input_filters == args.output_filters)
    return block, x, win, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_mbconv_kernel_matches_plain(cuda, case):
    block, x, win, kw = _case(case, cuda)
    before = M.mbconv_stride1.launches
    with torch.inference_mode():
        got = M.mbconv_stride1(x, block.fused_weights(), win, **kw)
        want = M.mbconv_stride1_plain(x, block.fused_weights(), win, **kw)
        again = M.mbconv_stride1(x, block.fused_weights(), win, **kw)
    torch.cuda.synchronize()
    assert M.mbconv_stride1.launches == before + 2
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    # no atomics: the kernel repeats itself bit for bit
    assert torch.equal(got, again)


def stripes_by_hand(x, wd, win, kw, n):
    """The block on ``n`` stripes of x in one process (parallel/spatial.py's
    split): each stripe with its k//2 halo rows (zeros beyond the image)
    and its window in stripe rows, the first stage on every stripe, the SE
    partials of the stripes' own rows summed by hand, then the second
    stage; the stripes' rows concatenated.  Rows that ``n`` does not
    divide go to the last stripe."""
    p, h = kw["k"] // 2, x.shape[1]
    s = h // n
    rows = [(r * s, h if r == n - 1 else r * s + s) for r in range(n)]
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, p, p))
    parts = [M.mbconv_stride1_begin(xp[:, lo: hi + 2 * p].contiguous(), wd,
                                    M.shift_rows(win, lo - p).contiguous(),
                                    owned=(p, p + hi - lo), **kw) for lo, hi in rows]
    total = sum(q.part for q in parts)
    for q in parts:
        q.part = total
    return torch.cat([M.mbconv_stride1_end(q) for q in parts], dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["windowed", "no_expand_k5", "wide", "many_tiles_expand",
                                  "b7_grid448"])
def test_mbconv_kernel_on_stripes_matches_plain(cuda, case):
    """The kernel's two stages on 2 stripes, the SE partials of each
    stripe's own rows summed between them, against the plain version on
    the whole image."""
    block, x, win, kw = _case(case, cuda)
    if win is None:
        win = M.full_window(x)
    with torch.inference_mode():
        got = stripes_by_hand(x, block.fused_weights(), win, kw, 2)
        want = M.mbconv_stride1_plain(x, block.fused_weights(), win, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_mbconv_bf16_kernel_matches_plain(cuda, case):
    block, x, win, kw = _case(case, cuda)
    x = x.to(torch.bfloat16)
    wd = block.fused_weights(torch.bfloat16)
    before = (M.mbconv_stride1.launches, M.mbconv_stride1.launches_bf16)
    with torch.inference_mode():
        got = M.mbconv_stride1(x, wd, win, **kw)
        want = M.mbconv_stride1_plain(x, wd, win, **kw)
        again = M.mbconv_stride1(x, wd, win, **kw)
    torch.cuda.synchronize()
    # bf16 launches counted apart from the f32 ones
    assert (M.mbconv_stride1.launches, M.mbconv_stride1.launches_bf16) == (
        before[0], before[1] + 2)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= BF16_REL * float(want.float().abs().max()), err
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_mbconv_kernel_rejects_bad_input(cuda):
    block = MBConvBlock(BlockArgs(3, 1, 8, 8, 6, 1)).eval().to(cuda)
    wd = block.fused_weights()
    kw = dict(k=3, has_expand=True, has_skip=True)
    x = torch.zeros((1, 8, 6, 6), device=cuda).permute(0, 2, 3, 1)  # NHWC view, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        M.mbconv_stride1(x, wd, None, **kw)
    with pytest.raises(ValueError, match="weight"):
        M.mbconv_stride1(torch.zeros((1, 6, 6, 8), device=cuda),
                         {n: t.cpu() for n, t in wd.items()}, None, **kw)
    # bf16 x with the f32 weights, and a dtype the kernel has no version of
    with pytest.raises(ValueError, match="weight"):
        M.mbconv_stride1(torch.zeros((1, 6, 6, 8), device=cuda, dtype=torch.bfloat16), wd,
                         None, **kw)
    with pytest.raises(ValueError, match="bfloat16"):
        M.mbconv_stride1(torch.zeros((1, 6, 6, 8), device=cuda, dtype=torch.float16),
                         block.fused_weights(torch.float16), None, **kw)


def _stencil_inputs(b, c, h, w, seed, device):
    gen = torch.Generator().manual_seed(seed)
    cam = torch.rand((b, c, h, w), generator=gen)
    edge = 0.7 * torch.rand((b, h, w), generator=gen)
    vs, inv, dirs = R.stencil_operands(edge.to(device))
    x = (cam * (1.0 - edge)[:, None]).to(device).contiguous()
    return x, vs, inv, dirs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 3, 37, 53, 16), (1, 20, 16, 16, 64), (2, 3, 5, 3, 1), (1, 2, 9, 7, 0),
    # the tiling's edges (32 x 16 tiles): a grid a multiple of neither side,
    # W below one tile, H = 1, B x tiles above one wave of CTAs (256 CTAs)
    (2, 5, 37, 45, 8), (1, 4, 20, 9, 8), (2, 3, 1, 40, 8), (8, 20, 128, 128, 4),
    # class counts: one, and more than one chunk (double-buffered passes)
    (1, 1, 21, 19, 8), (2, 33, 19, 35, 6), (1, 120, 17, 33, 4)])
def test_stencil_walk_kernel_matches_plain(cuda, shape):
    b, c, h, w, steps = shape
    x, vs, inv, dirs = _stencil_inputs(b, c, h, w, seed=h, device=cuda)
    before = stencil_walk.launches
    with torch.inference_mode():
        got = stencil_walk(x, vs, inv, dirs=dirs, steps=steps)
        want = stencil_walk_plain(x, vs, inv, dirs=dirs, steps=steps)
        again = stencil_walk(x, vs, inv, dirs=dirs, steps=steps)
    torch.cuda.synchronize()
    assert stencil_walk.launches == before + 2
    torch.testing.assert_close(got, want, rtol=STENCIL_RTOL, atol=STENCIL_ATOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_stencil_walk_kernel_rejects_other_directions(cuda):
    x, vs, inv, dirs = _stencil_inputs(1, 2, 8, 8, seed=0, device=cuda)
    swapped = (dirs[1], dirs[0]) + dirs[2:]
    with pytest.raises(RuntimeError, match="launch failed"):
        stencil_walk(x, vs, inv, dirs=swapped, steps=2)


def _banded(b, v, band, seed):
    gen = torch.Generator().manual_seed(seed)
    t = torch.rand((b, v, v), generator=gen)
    i = torch.arange(v)
    t = t * ((i[:, None] - i[None, :]).abs() <= band)
    return t / t.sum(dim=1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 3, 600, 37, 8), (1, 20, 1000, 64, 16), (1, 5, 97, 3, 1), (2, 32, 300, 20, 3),
    # V not a multiple of the 64-column block, band >= V, one class, and
    # more classes than one 20-class chunk
    (2, 5, 700, 40, 8), (1, 4, 300, 400, 6), (1, 1, 500, 30, 8), (2, 33, 400, 25, 6)])
def test_banded_walk_kernel_matches_plain(cuda, shape):
    b, c, v, band, steps = shape
    t = _banded(b, v, band, seed=v).to(cuda)
    x = torch.rand((b, c, v), generator=torch.Generator().manual_seed(c)).to(cuda)
    before = banded_walk.launches
    with torch.inference_mode():
        got = banded_walk(x, t, steps=steps, band=band)
        want = banded_walk_plain(x, t, steps=steps, band=band)
        again = banded_walk(x, t, steps=steps, band=band)
        dense = x
        for _ in range(steps):
            dense = dense @ t
    torch.cuda.synchronize()
    assert banded_walk.launches == before + 2
    torch.testing.assert_close(got, want, rtol=BANDED_RTOL, atol=BANDED_ATOL)
    torch.testing.assert_close(got, dense, rtol=BANDED_RTOL, atol=BANDED_ATOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["stencil", "banded"])
def test_propagate_to_edge_launches_kernel_on_card(cuda, method):
    gen = torch.Generator().manual_seed(3)
    cam = torch.rand((2, 4, 23, 31), generator=gen).to(cuda)
    edge = (0.6 * torch.rand((2, 23, 31), generator=gen)).to(cuda)
    counter = stencil_walk if method == "stencil" else banded_walk
    before = counter.launches
    with torch.inference_mode():
        got = R.propagate_to_edge(cam, edge, exp_times=4, method=method)
        plain = R.propagate_to_edge(cam, edge, exp_times=4, method=method, kernel=False)
        vector = R.propagate_to_edge(cam, edge, exp_times=4, method="vector")
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    torch.testing.assert_close(got, plain, rtol=BANDED_RTOL, atol=BANDED_ATOL)
    torch.testing.assert_close(got, vector, rtol=BANDED_RTOL, atol=BANDED_ATOL)


# ---- the cross-rank batch norm (ops/sync_bn.py) ---------------------------------

# (N, C, H, W) of x, split over SYNC_BN_WORLD fake ranks along N: the b3
# step's stem BN at batch 16, crop 448; a 144-channel BN at 112^2; the
# 1536-channel head BN at 14^2; C 24; and C 7, which no 16-byte vector
# divides (the kernels' one-channel loads)
SYNC_BN_SHAPES = {"stem": (16, 40, 224, 224), "c144": (16, 144, 112, 112),
                  "c1536": (16, 1536, 14, 14), "c24": (8, 24, 56, 56), "c7": (4, 7, 33, 29)}
SYNC_BN_WORLD = 4
# kernel against plain stage at float32: the sums over up to 200,704 rows a
# rank in another order (the kernel's Chan merges by 4-row chunks, CTAs
# and row blocks); relative to each result's largest
SYNC_BN_F32 = 1e-5
SYNC_BN_SUMS = 1e-4  # the backward's sums, whose terms cancel


def _sync_bn_problem(shape, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    n, c, h, w = shape

    def cl(t):
        return t.to(device, dtype).contiguous(memory_format=torch.channels_last)

    return {"x": cl(torch.randn(shape, generator=gen) * 2 + 0.5),
            "g": cl(torch.randn(shape, generator=gen)),
            "weight": (torch.rand(c, generator=gen) + 0.5).to(device),
            "bias": torch.randn(c, generator=gen).to(device),
            "running_mean": torch.randn(c, generator=gen).to(device),
            "running_var": (torch.rand(c, generator=gen) + 0.5).to(device)}


def _near(got, want, share, what):
    err = float((got.float() - want.float()).abs().max())
    assert err <= share * float(want.float().abs().max()), (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(SYNC_BN_SHAPES))
def test_sync_bn_kernels_match_plain_stages(cuda, shape, dtype):
    """Kernels (a), (c), (d) and (f) against the plain stages on a fake
    4-way split of one batch: each rank's local row, y, ``saved``, the
    running statistics, the backward sums and dx (each kernel stage fed
    what the kernels before it produced)."""
    from muscle_tpu_torch.ops import sync_bn as S

    p = _sync_bn_problem(SYNC_BN_SHAPES[shape], dtype, cuda, seed=len(shape))
    c = p["x"].shape[1]
    xs, gs = p["x"].chunk(SYNC_BN_WORLD), p["g"].chunk(SYNC_BN_WORLD)
    rows = {k: torch.empty((SYNC_BN_WORLD, 1 + 2 * c), device=cuda) for k in ("k", "p")}
    for r, x in enumerate(xs):
        S.local_stats_kernel(x, rows["k"][r])
        S.local_stats_plain(x, rows["p"][r])
    torch.cuda.synchronize()
    k, pl = rows["k"], rows["p"]
    assert torch.equal(k[:, 0], pl[:, 0])
    _near(k[:, 1: 1 + c], pl[:, 1: 1 + c], SYNC_BN_F32, "mean")
    _near(k[:, 1 + c:], pl[:, 1 + c:], SYNC_BN_F32, "M2")
    tol = SYNC_BN_F32 if dtype == torch.float32 else BF16_REL
    saved, reds = [], []
    for x, g in zip(xs, gs):
        runs = [(p["running_mean"].clone(), p["running_var"].clone(),
                 torch.zeros((), dtype=torch.long, device=cuda), 0.01) for _ in range(2)]
        y_k, s_k = S.normalize_kernel(x, k, p["weight"], p["bias"], 1e-3, runs[0])
        y_p, s_p = S.normalize_plain(x, k, p["weight"], p["bias"], 1e-3, runs[1])
        assert y_k.dtype == dtype and y_k.is_contiguous(memory_format=torch.channels_last)
        _near(y_k, y_p, tol, "y")
        _near(s_k, s_p, SYNC_BN_F32, "saved")
        for a, b in zip(runs[0][:3], runs[1][:3]):
            _near(a, b, SYNC_BN_F32, "running")
        got, want = S.backward_reduce_kernel(g, x, s_k), S.backward_reduce_plain(g, x, s_k)
        for a, b, what in zip(got, want, ("red", "dw", "db")):
            _near(a, b, SYNC_BN_SUMS, what)
        saved.append(s_k)
        reds.append(got[0])
    red = sum(reds)
    for x, g, s in zip(xs, gs, saved):
        dx_k = S.backward_dx_kernel(g, x, s, p["weight"], red)
        dx_p = S.backward_dx_plain(g, x, s, p["weight"], red)
        assert dx_k.dtype == dtype
        _near(dx_k, dx_p, SYNC_BN_SUMS if dtype == torch.float32 else BF16_REL, "dx")


@pytest.mark.cuda
def test_sync_bn_kernels_reject_bad_input(cuda):
    """A card tensor takes the kernels or raises: NCHW-contiguous x, a dtype
    without a kernel, g of another dtype."""
    from muscle_tpu_torch.ops import sync_bn as S

    row = torch.empty(1 + 2 * 8, device=cuda)
    x = torch.zeros((2, 8, 5, 6), device=cuda)
    with pytest.raises(ValueError, match="channels-last"):
        S.local_stats_kernel(x, row)
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="bfloat16"):
        S.local_stats_kernel(x.half(), row)
    saved = torch.zeros(2 * 8 + 1, device=cuda)
    with pytest.raises(ValueError, match="does not match"):
        S.backward_reduce_kernel(x.bfloat16(), x, saved)
    assert S.stages(x) is S.KERNELS


def _sync_bn_rank(rank: int, world: int, backend: str, tmp: str) -> None:
    """One rank of the two-rank b3 step: MCL step A with IMC at crop 448,
    4 images a rank, once through the kernels and once through the plain
    stages (``stages`` patched), each from the same weights."""
    import os

    import numpy as np

    from muscle_tpu_torch import parallel
    from muscle_tpu_torch.models import MuSCLe
    from muscle_tpu_torch.ops import sync_bn as S
    from muscle_tpu_torch.training import MCLConfig, make_adam, mcl_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    group = parallel.init(rank, world, f"file://{tmp}/store", dev, backend)
    torch.manual_seed(0)
    state = init_weights(MuSCLe(backbone_name="efficientnet-b3", mode="enc",
                                last_pooling=False), torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(1)
    label = np.zeros((4 * world, 20), np.float32)
    for i in range(4 * world):
        label[i, (7, 11, 14)[i % 3]] = 1.0
    img = rng.integers(0, 256, (4 * world, 448, 448, 3), dtype=np.uint8)
    rows = slice(4 * rank, 4 * rank + 4)
    batch = {"img": torch.from_numpy(img[rows]).to(dev),
             "label": torch.from_numpy(label[rows]).to(dev)}
    out = {}
    for path in ("kernels", "plain"):
        if path == "plain":
            S.stages = lambda x: S.PLAIN
        model = MuSCLe(backbone_name="efficientnet-b3", mode="enc", last_pooling=False)
        model.load_state_dict(state)
        model = parallel.replicate(model.to(dev), group)
        opt = make_adam(model.trained_parameters(), 1e-4, 5e-5)
        gen = torch.Generator(device=dev).manual_seed(2)
        S.sync_bn.launches = S.sync_bn.launches_backward = 0
        metrics = mcl_train_step(model, opt, batch, MCLConfig(use_imc=True), gen, group=group)
        torch.cuda.synchronize(dev)
        names = {id(p): n for n, p in model.named_parameters()}
        out[path] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {names[id(p)]: p.grad.float().cpu() for g in opt.param_groups
                      for p in g["params"]},
            "stats": {k: v.float().cpu() for k, v in model.state_dict().items()
                      if k.endswith("running_mean") or k.endswith("running_var")},
            "launches": (S.sync_bn.launches, S.sync_bn.launches_backward)}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    parallel.barrier(group)
    parallel.shutdown(group)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_sync_bn_b3_step_on_two_ranks_matches_plain(cuda, backend, tmp_path):
    """One b3 training step on 2 ranks (NCCL, one card a rank, where 2
    cards are visible; gloo, both ranks on card 0) through the kernels
    against the same step through the plain stages: the loss terms 1e-5
    relative, every gradient within 1e-3 of its tensor's largest (or of a
    thousandth of the model's), the running statistics 1e-5 of their
    largest; 77 kernel calls forward and 77 backward a step, one a BN."""
    import torch.multiprocessing as mp

    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards for one NCCL rank a card")
    mp.spawn(_sync_bn_rank, args=(2, backend, str(tmp_path)), nprocs=2, join=True)
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        got, want = res["kernels"], res["plain"]
        assert got["launches"] == (77, 77) and want["launches"] == (0, 0)
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-5 * abs(v) + 1e-7, k
        top = max(float(g.abs().max()) for g in want["grads"].values())
        for k, g in want["grads"].items():
            scale = max(float(g.abs().max()), 1e-3 * top)
            assert float((got["grads"][k] - g).abs().max()) <= 1e-3 * scale, k
        for k, v in want["stats"].items():
            _near(got["stats"][k], v, 1e-5, k)
