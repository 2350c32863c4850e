"""The port's MBConv kernel wrapper (muscle_tpu_torch/ops/mbconv.py) and
unfused MBConvBlock against the JAX package's Pallas kernel (interpret
mode) and Flax block, on the block cases of test_pallas_mbconv.py.

On the CPU the wrapper runs its plain version; the CUDA kernel itself is
held against that plain version on the card (test_torch_kernels_cuda.py,
and chip_smoke.py at the b3 CAM shapes)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from muscle_tpu.models.efficientnet import BlockArgs, MBConvBlock, placement_offset, window_mask
from muscle_tpu.ops.pallas.mbconv import fused_mbconv_stride1
from muscle_tpu_torch.models.efficientnet import BlockArgs as TBlockArgs
from muscle_tpu_torch.models.efficientnet import MBConvBlock as TMBConvBlock
from muscle_tpu_torch.models.efficientnet import window_mask as t_window_mask
from muscle_tpu_torch.ops import mbconv as M

# the JAX kernel's own bound against the Flax block
# (test_pallas_mbconv.py): f32, different summation order
ATOL, RTOL = 2e-5, 1e-4


def _port_block(args: BlockArgs, variables) -> TMBConvBlock:
    """The port's block carrying the Flax block's weights (same layout
    transforms as muscle_tpu_torch.convert)."""
    block = TMBConvBlock(TBlockArgs(**args.__dict__)).eval()
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    for name, sub in p.items():
        if "kernel" in sub:
            sd[f"{name}.weight"] = np.asarray(sub["kernel"]).transpose(3, 2, 0, 1)
            if "bias" in sub:
                sd[f"{name}.bias"] = np.asarray(sub["bias"])
        else:  # batch norm
            sd[f"{name}.weight"] = np.asarray(sub["scale"])
            sd[f"{name}.bias"] = np.asarray(sub["bias"])
            sd[f"{name}.running_mean"] = np.asarray(s[name]["mean"])
            sd[f"{name}.running_var"] = np.asarray(s[name]["var"])
    block.load_state_dict({k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()},
                          strict=False)
    return block


CASES = {
    # name: (BlockArgs, h, w, windowed sizes or None, seed)
    "k3_expand": (BlockArgs(3, 1, 24, 24, 6, 1), 24, 40, None, 0),
    "k5_expand": (BlockArgs(5, 1, 32, 32, 6, 1), 19, 33, None, 1),
    "no_expand": (BlockArgs(3, 1, 40, 40, 1, 1), 24, 24, None, 2),
    "windowed": (BlockArgs(3, 1, 24, 24, 6, 1), 24, 40, [[17, 29], [24, 40]], 3),
    "no_skip": (BlockArgs(3, 1, 24, 40, 6, 1), 20, 28, None, 5),
    "no_skip_windowed": (BlockArgs(5, 1, 32, 48, 6, 1), 20, 28, [[13, 21], [20, 28]], 6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mbconv_matches_jax(case):
    args, h, w, sizes, seed = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, args.input_filters)).astype(np.float32) * 0.5
    flax_block = MBConvBlock(args)
    v = flax_block.init({"params": jax.random.key(seed)}, jnp.asarray(x))
    # non-identity BN statistics, so the folding is exercised
    bs = jax.tree.map(lambda a: jnp.asarray(np.abs(rng.normal(size=a.shape, scale=0.3)) + 0.2,
                                            a.dtype), v["batch_stats"])
    v = {"params": v["params"], "batch_stats": bs}
    window = None
    if sizes is not None:
        sizes = np.asarray(sizes, np.int32)
        window = np.concatenate([placement_offset(sizes, 1), sizes], axis=-1).astype(np.int32)

    kw = {}
    if window is not None:
        jw = jnp.asarray(window)
        mask = window_mask((h, w), jw, jnp.float32)
        kw = dict(mask_in=mask, mask_out=mask,
                  se_count=(jw[:, 2] * jw[:, 3]).astype(jnp.float32)[:, None, None, None])
    want_flax = np.asarray(flax_block.apply(v, jnp.asarray(x), **kw))
    want_pallas = np.asarray(fused_mbconv_stride1(
        jnp.asarray(x), v["params"], v["batch_stats"],
        None if window is None else jnp.asarray(window),
        k=args.kernel_size, has_expand=args.expand_ratio != 1,
        se_ratio_filters=max(1, int(args.input_filters * args.se_ratio)), interpret=True,
    ))

    block = _port_block(args, v)
    tx = torch.from_numpy(x)
    tw = None if window is None else torch.from_numpy(window)
    launches = M.mbconv_stride1.launches
    with torch.inference_mode():
        got_kernel_path = M.mbconv_stride1(
            tx, block.fused_weights(), tw, k=args.kernel_size,
            has_expand=args.expand_ratio != 1,
            has_skip=args.input_filters == args.output_filters,
        ).numpy()
        tkw = {}
        if tw is not None:
            tmask = t_window_mask((h, w), tw)
            tkw = dict(mask_in=tmask, mask_out=tmask,
                       se_count=(tw[:, 2] * tw[:, 3]).float()[:, None, None, None])
        got_unfused = block(tx, **tkw).numpy()
        got_fused_block = block(tx, fused=True, window=tw).numpy()
    # on the CPU the wrapper takes the plain version and launches nothing
    assert M.mbconv_stride1.launches == launches
    for got in (got_kernel_path, got_fused_block):
        np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_unfused, want_flax, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_kernel_path, got_unfused, atol=ATOL, rtol=RTOL)


def test_mbconv_wrapper_rejects_bad_input():
    block = TMBConvBlock(TBlockArgs(3, 1, 8, 8, 6, 1)).eval()
    wd = block.fused_weights()
    kw = dict(k=3, has_expand=True, has_skip=True)
    x = torch.zeros((1, 6, 6, 8))
    with pytest.raises(RuntimeError, match="inference-only"):
        M.mbconv_stride1(x.requires_grad_(), wd, None, **kw)
    with pytest.raises(ValueError, match="float32"):
        M.mbconv_stride1(torch.zeros((1, 6, 6, 8), dtype=torch.float64), wd, None, **kw)
    with pytest.raises(ValueError, match="residual"):
        M.mbconv_stride1(torch.zeros((1, 6, 6, 8)), wd, None, k=3, has_expand=True,
                         has_skip=False)
    with pytest.raises(ValueError, match="window"):
        M.mbconv_stride1(torch.zeros((1, 6, 6, 8)), wd, torch.zeros((1, 4)), **kw)


def test_mbconv_bound_counts():
    # b3 _blocks_25 at scale 1 (VOC canvas 384 x 512 -> stride 16: 24 x 32),
    # B = 16: operations bound the block
    nbytes, flops = M.block_work(16, 24, 32, 384, 2304, 96, 384, 3, True)
    assert flops == 2 * 16 * 24 * 32 * (384 * 2304 + 9 * 2304 + 2304 * 384)
    assert nbytes > 4 * 16 * 24 * 32 * (384 + 384)
    ms, by = M.bound_ms(nbytes, flops)
    assert by == "operations"
    assert ms == pytest.approx(flops / 67e12 * 1e3)
