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
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_mbconv_kernel_matches_plain(cuda, case):
    args, h, w, sizes = CASES[case]
    gen = torch.Generator().manual_seed(len(case))
    block = init_weights(MBConvBlock(args), gen).eval().to(cuda)
    x = torch.randn((2, h, w, args.input_filters), generator=gen).to(cuda)
    win = None
    if sizes is not None:
        win = torch.tensor([[0, 0, a, b] for a, b in sizes], dtype=torch.int32, device=cuda)
    kw = dict(k=args.kernel_size, has_expand=args.expand_ratio != 1,
              has_skip=args.input_filters == args.output_filters)
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


def _stencil_inputs(b, c, h, w, seed, device):
    gen = torch.Generator().manual_seed(seed)
    cam = torch.rand((b, c, h, w), generator=gen)
    edge = 0.7 * torch.rand((b, h, w), generator=gen)
    vs, inv, dirs = R.stencil_operands(edge.to(device))
    x = (cam * (1.0 - edge)[:, None]).to(device).contiguous()
    return x, vs, inv, dirs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 37, 53, 16), (1, 20, 16, 16, 64), (2, 3, 5, 3, 1),
                                   (1, 2, 9, 7, 0)])
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
@pytest.mark.parametrize("shape", [(2, 3, 600, 37, 8), (1, 20, 1000, 64, 16), (1, 5, 97, 3, 1),
                                   (2, 32, 300, 20, 3)])
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
