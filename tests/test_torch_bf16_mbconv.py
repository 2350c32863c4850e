"""The port's MBConv block at bfloat16 against the JAX package's: the
wrapper's plain bf16 version (what ``mbconv_stride1`` runs on the CPU, and
the CUDA bf16 kernel's yardstick on the card) against the Pallas kernel at
``compute_dtype=jnp.bfloat16`` in interpret mode, and the port's unfused
block on a bf16 input against the Flax block at ``dtype=jnp.bfloat16``, on
the block cases of test_torch_mbconv.py.  Both sides take the same
bf16-rounded inputs and the same f32 parameters.

One evaluation detail of the reference is set here, not in the JAX
package: XLA's CPU backend evaluates a bf16 sigmoid as exp, add and
divide, each rounded to bf16 (up to 0.84% off the true value, against
0.39% rounded once), and a bf16 silu as x times that; torch evaluates
both in f32 and rounds once.  The tests take the reference's silu and
sigmoid in f32, rounded once (``_round_once``); the Flax modules, the
Pallas kernel (whose swish and sigmoid run in f32 already), their
rounding points and every other op are the JAX package's.  Without it 39%
of a silu's bf16 outputs differ, and the two sides carry unrelated noise
from the first layer on."""

import flax.linen
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from muscle_tpu.models.efficientnet import MBConvBlock, placement_offset, window_mask
from muscle_tpu.ops.pallas.mbconv import fused_mbconv_stride1
from muscle_tpu_torch.models.efficientnet import BlockArgs as TBlockArgs
from muscle_tpu_torch.models.efficientnet import MBConvBlock as TMBConvBlock
from muscle_tpu_torch.models.efficientnet import window_mask as t_window_mask
from muscle_tpu_torch.ops import mbconv as M
from test_torch_mbconv import CASES, _port_block

# relative to the output's largest value: one bf16 ulp of the outputs
# (|y| in [2, 4): 2^-7) covers a rounding that lands the other way; the
# mean stays well below it (the JAX package's own Pallas-vs-Flax bf16
# difference: max one ulp, mean ~0.1 ulp)
MAX_REL, MEAN_REL = 2.0 ** -7, 2.0 ** -10
# the bf16 results differ from the f32 ones by far more than this (they
# really ran in bf16)
CONTROL_REL = 1e-4
# the unfused block rounds where Flax rounds: bit-equal outputs but for f32
# sums taken in another order (measured >= 99.97%; one rounding placed
# elsewhere flips ~30% of them)
SAME_BITS = 0.999


@pytest.fixture(autouse=True)
def _round_once(monkeypatch):
    """The reference's silu and sigmoid in f32, rounded once to the input's
    dtype (see the module docstring)."""
    def once(fn):
        return lambda x: fn(x.astype(jnp.float32)).astype(x.dtype)

    monkeypatch.setattr(flax.linen, "silu", once(flax.linen.silu))
    monkeypatch.setattr(jax.nn, "sigmoid", once(jax.nn.sigmoid))


def _setup(case):
    args, h, w, sizes, seed = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, args.input_filters)).astype(np.float32) * 0.5
    x16 = jnp.asarray(x, jnp.bfloat16)  # the same bf16 values on both sides
    v = MBConvBlock(args).init({"params": jax.random.key(seed)}, jnp.asarray(x))
    bs = jax.tree.map(lambda a: jnp.asarray(np.abs(rng.normal(size=a.shape, scale=0.3)) + 0.2,
                                            a.dtype), v["batch_stats"])
    v = {"params": v["params"], "batch_stats": bs}
    window = None
    if sizes is not None:
        sizes = np.asarray(sizes, np.int32)
        window = np.concatenate([placement_offset(sizes, 1), sizes], axis=-1).astype(np.int32)
    tx16 = torch.from_numpy(np.array(x16.astype(jnp.float32))).to(torch.bfloat16)
    return args, h, w, v, window, x16, tx16


def _close(got: torch.Tensor, want, what: str) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    assert diff.max() <= MAX_REL * scale, (what, float(diff.max()), scale)
    assert diff.mean() <= MEAN_REL * scale, (what, float(diff.mean()), scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mbconv_bf16_matches_jax(case):
    args, h, w, v, window, x16, tx16 = _setup(case)
    kw = dict(k=args.kernel_size, has_expand=args.expand_ratio != 1,
              has_skip=args.input_filters == args.output_filters)
    want_pallas = fused_mbconv_stride1(
        x16, v["params"], v["batch_stats"], None if window is None else jnp.asarray(window),
        k=args.kernel_size, has_expand=args.expand_ratio != 1,
        se_ratio_filters=max(1, int(args.input_filters * args.se_ratio)),
        compute_dtype=jnp.bfloat16, interpret=True)
    jkw = {}
    if window is not None:
        jw = jnp.asarray(window)
        mask = window_mask((h, w), jw, jnp.bfloat16)
        jkw = dict(mask_in=mask, mask_out=mask,
                   se_count=(jw[:, 2] * jw[:, 3]).astype(jnp.bfloat16)[:, None, None, None])
    want_flax = MBConvBlock(args, dtype=jnp.bfloat16).apply(v, x16, **jkw)
    assert want_pallas.dtype == want_flax.dtype == jnp.bfloat16

    block = _port_block(args, v)
    tw = None if window is None else torch.from_numpy(window)
    tkw = {}
    if tw is not None:
        tmask = t_window_mask((h, w), tw, torch.bfloat16)
        tkw = dict(mask_in=tmask, mask_out=tmask,
                   se_count=(tw[:, 2] * tw[:, 3]).to(torch.bfloat16)[:, None, None, None])
    launches = (M.mbconv_stride1.launches, M.mbconv_stride1.launches_bf16)
    with torch.inference_mode():
        got_plain = M.mbconv_stride1(tx16, block.fused_weights(torch.bfloat16), tw, **kw)
        got_fused_block = block(tx16, fused=True, window=tw)
        got_unfused = block(tx16, **tkw)
        f32_unfused = block(tx16.float(), **{k: t.float() for k, t in tkw.items()})
        f32_plain = M.mbconv_stride1(tx16.float(), block.fused_weights(), tw, **kw)
    # the CPU takes the plain version and launches nothing
    assert (M.mbconv_stride1.launches, M.mbconv_stride1.launches_bf16) == launches
    for got in (got_plain, got_fused_block, got_unfused):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want_flax.shape
    _close(got_plain, want_pallas, f"{case} plain vs Pallas")
    torch.testing.assert_close(got_fused_block, got_plain, atol=0, rtol=0)
    _close(got_unfused, want_flax, f"{case} unfused vs Flax")
    same = (got_unfused.float().numpy() == np.asarray(want_flax.astype(jnp.float32))).mean()
    assert same >= SAME_BITS, (case, float(same))
    # control: bf16 really ran on both paths
    for got, f32 in ((got_plain, f32_plain), (got_unfused, f32_unfused)):
        scale = float(f32.abs().max())
        assert float((got.float() - f32).abs().max()) > CONTROL_REL * scale, case


def _random_block(cin, cout, expand, k=3, seed=2):
    block = TMBConvBlock(TBlockArgs(k, 1, cin, cout, expand, 1)).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in block.parameters():
            t.copy_(0.3 * torch.randn(t.shape, generator=gen))
    return block, gen


def _padded_weights(wd: dict, ops: dict) -> dict:
    """The weights as the kernel takes them: each padded copy of
    ``kernel_operands`` (``<name>_padded``) in place of its weight."""
    return {n: ops.get(n + M.PADDED, t) for n, t in wd.items()}


# (Cin, Cout, expand ratio): b3's widths, multiples of 8 and not of 16 (24,
# 40), and 20, which still pads (to 24; Cmid 120 or 20 -> 24)
@pytest.mark.parametrize("cin,cout,expand", [(24, 40, 6), (40, 24, 1), (20, 24, 6), (20, 20, 1)])
def test_kernel_operands_bf16_are_k_major_and_padded_to_16(cin, cout, expand):
    # the kernel's channel granularity is 8 at bf16 as at f32 (the name
    # keeps the 16 it had before); only counts off a multiple of 8 are padded
    has_expand = expand != 1
    block, gen = _random_block(cin, cout, expand)
    wd = block.fused_weights(torch.bfloat16)
    for n in M.WEIGHT_SHAPES:
        if n in wd:
            want = torch.bfloat16 if n in M.MATRIX_WEIGHTS else torch.float32
            assert wd[n].dtype == want, n
    ops = M.kernel_operands(wd, has_expand)
    names = {"w_proj": "w_proj_kt"} | ({"w_exp": "w_exp_kt"} if has_expand else {})
    pads = cin % 8 != 0
    assert sorted(n for n in ops if not n.endswith(M.PADDED)) == sorted(names.values())
    assert any(n.endswith(M.PADDED) for n in ops) == pads
    for n, kt in names.items():
        rows, cols = wd[n].t().shape
        padded = (-(-rows // 8) * 8, -(-cols // 8) * 8)
        # K-major (out, in), both sides padded to 8 with zeros, no split
        assert ops[kt].dtype == torch.bfloat16 and tuple(ops[kt].shape) == padded
        assert torch.equal(ops[kt][:rows, :cols], wd[n].t())
        assert not ops[kt][rows:].any() and not ops[kt][:, cols:].any()
    # the padded block computes the same outputs: the padding is exact
    x = torch.randn((2, 9, 21, cin), generator=gen).to(torch.bfloat16)
    win = torch.tensor([[0, 0, 9, 17], [0, 0, 6, 21]], dtype=torch.int32)
    kw = dict(k=3, has_expand=has_expand, has_skip=cin == cout)
    wdk = _padded_weights(wd, ops)
    xk = M._pad_dims(x, ("B", "H", "W", "Cin"), {"Cin"})
    assert xk.shape[-1] % 8 == 0 and wdk["w_dw"].shape[1] % 8 == 0
    assert (xk is x) == (not pads)
    want = M.mbconv_stride1_plain(x, wd, win, **kw)
    got = M.mbconv_stride1_plain(xk, wdk, win, **kw)
    torch.testing.assert_close(got[..., :cout], want, atol=0, rtol=0)
    assert not got[..., cout:].any()


# every stride-1 block width of MuSCLe-b3 (Cin, Cout, expand ratio)
B3_WIDTHS = [(40, 24, 1), (24, 24, 1), (32, 32, 6), (48, 48, 6), (96, 96, 6), (96, 136, 6),
             (136, 136, 6), (136, 232, 6), (232, 232, 6), (232, 384, 6), (384, 384, 6)]


@pytest.mark.parametrize("cin,cout,expand", B3_WIDTHS)
def test_fused_weights_bf16_at_b3_widths_need_no_padding(cin, cout, expand):
    # with the kernel operands that fused_weights caches on a card, the
    # wrapper hands the kernel the cached dict itself and x as it is: a b3
    # call copies no weight, no x and no y
    has_expand = expand != 1
    block, gen = _random_block(cin, cout, expand)
    wd = block.fused_weights(torch.bfloat16)
    ops = M.kernel_operands(wd, has_expand)
    assert not any(n.endswith(M.PADDED) for n in ops)
    cmid = cin * expand
    want = M._kernel_operand_shapes(cin, cmid, cout, torch.bfloat16)
    for n, t in ops.items():
        assert tuple(t.shape) == want[n] and t.dtype == torch.bfloat16, n
    cached = {**wd, **ops}
    x = torch.zeros((1, 4, 4, cin), dtype=torch.bfloat16)
    dims = M._check(x, cached, None, 3, has_expand, cin == cout)
    assert M._kernel_weights(cached, x, dims, has_expand) is cached
    assert M._pad_dims(x, ("B", "H", "W", "Cin"), {"Cin"}) is x
    assert cached["w_proj"].shape[1] == cout  # y is made at its own width


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,expand,k", [(5, 7, 6, 3), (20, 24, 6, 5), (20, 20, 1, 3)])
def test_plain_block_at_padded_widths_is_bit_exact(cin, cout, expand, k, dtype):
    # the plain block on the zero-padded x and weights the kernel takes
    # gives the unpadded block's outputs, and zeros beyond Cout: at bf16 bit
    # for bit; at f32 to the summation order of a BLAS product whose K grew
    # by zeros (test_torch_mbconv.py's test_channel_padding_is_exact)
    has_expand = expand != 1
    block, gen = _random_block(cin, cout, expand, k, seed=5)
    wd = block.fused_weights(dtype)
    ops = M.kernel_operands(wd, has_expand)
    x = torch.randn((2, 11, 19, cin), generator=gen).to(dtype)
    win = torch.tensor([[0, 0, 11, 15], [0, 0, 8, 19]], dtype=torch.int32)
    kw = dict(k=k, has_expand=has_expand, has_skip=cin == cout)
    want = M.mbconv_stride1_plain(x, wd, win, **kw)
    got = M.mbconv_stride1_plain(M._pad_dims(x, ("B", "H", "W", "Cin"), {"Cin"}),
                                 _padded_weights(wd, ops), win, **kw)
    assert got.shape[-1] == -(-cout // 8) * 8
    tol = 0 if dtype == torch.bfloat16 else 1e-6
    torch.testing.assert_close(got[..., :cout], want, atol=tol, rtol=tol)
    assert not got[..., cout:].any()


def test_bound_tc_takes_bf16_rates_and_bytes():
    # b3 _blocks_25 at scale 2, B = 16: bf16 products at 989 TFLOP/s, half
    # the activation and matrix bytes, the depthwise still on the f32 pipes
    dims = (16, 48, 64, 384, 2304, 96, 384, 3, True)
    n32, f32 = M.block_work(*dims)
    n16, f16 = M.block_work(*dims, dtype=torch.bfloat16)
    assert f16 == f32 and n32 / 2 < n16 < n32 / 2 + 4 * 10 * 2304
    products, depthwise = M.block_flops(16, 48, 64, 384, 2304, 384, 3, True)
    ms, by = M.bound_tc_ms(n16, products, depthwise, torch.bfloat16)
    assert by == "operations"
    assert ms == pytest.approx((products / 989e12 + depthwise / 67e12) * 1e3)
    assert ms < M.bound_tc_ms(n32, products, depthwise)[0]


def test_wrapper_rejects_other_dtypes():
    block = TMBConvBlock(TBlockArgs(3, 1, 8, 8, 6, 1)).eval()
    kw = dict(k=3, has_expand=True, has_skip=True)
    x = torch.zeros((1, 6, 6, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="weight"):  # bf16 x with f32 weights
        M.mbconv_stride1(x, block.fused_weights(), None, **kw)
    with pytest.raises(ValueError, match="bfloat16"):
        M.mbconv_stride1(x.to(torch.float16), block.fused_weights(torch.float16), None, **kw)
