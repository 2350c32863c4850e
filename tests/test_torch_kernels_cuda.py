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

# f32 kernel against f32 plain version (TF32 off): summation order only
ATOL, RTOL = 1e-4, 1e-4

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
