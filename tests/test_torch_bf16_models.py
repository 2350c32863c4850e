"""The port's models at bfloat16 against the JAX package's at
``dtype=jnp.bfloat16`` (f32 parameters, the same weights and inputs).

Rounding points first, where they can be seen bit for bit (single
MBConv blocks in test_torch_bf16_mbconv.py), the reference run op by op
(under jit XLA keeps fused elementwise chains in f32, so a compiled bf16
model rounds less often than its program says): the EfficientNet stem and
first blocks, the ResNet-50 stem and first stage,
and a one-layer BiFPN on given bf16 features (windowed, with the window
resizes' promotions) must give the same bf16 values as Flax on at least
99% of their outputs (f32 sums in other orders flip 0.02-0.3% of them).
One rounding placed elsewhere than Flax's flips a third or more of them:
torch's fused conv bias 32%, a silu rounded differently 39%.  Then one direct case each for
the batch norm's f32-then-round and the resizes' dtypes.

Then whole models: MuSCLe-b1 enc ('cam' and windowed 'cam_lowres'),
MuSCLe-b1 dec with a one-layer 64-channel BiFPN ('seg' and windowed
'seg_lowres') and the IRN EdgeDisplacement at crop 64 (b1 is the smallest
backbone with a pyramid table).  Deep in a network the two sides' f32
sums, taken in other orders, land on the other side of a bf16 rounding
now and then, and each such flip spreads: the b1 backbone is bit-equal
to Flax through block 5, and by its last block the port's distance from
JAX's bf16 result is ~0.7 of JAX's own bf16-vs-f32 distance.  So the
bound per output is: mean |port16 - jax16| <= 2 mean |jax16 - jax32| and
max <= 3 max |jax16 - jax32| (measured: 0.55-1.42 and up to 2.06 of
them), with the control that bf16 ran: mean |port16 - jax32| >= 0.5 mean
|jax16 - jax32|.

The reference's silu and sigmoid are taken in f32 and rounded once
(``_round_once``, test_torch_bf16_mbconv.py says why)."""

import numpy as np
import pytest
import torch
from flax import linen as nn

import jax
import jax.numpy as jnp

import muscle_tpu.core.resize as JR
from muscle_tpu.convert import convert_muscle_state_dict
from muscle_tpu.models import EdgeDisplacement as JEdgeDisplacement
from muscle_tpu.models import MuSCLe as JMuSCLe
import muscle_tpu_torch.core.resize as TR
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.data.transforms import color_norm
from muscle_tpu_torch.models import MuSCLe, calibrate_seg_head, init_weights
from muscle_tpu_torch.models.efficientnet import BatchNorm2d
from test_torch_bf16_mbconv import _round_once  # noqa: F401  (autouse)
from test_torch_irn_models import make_irn, port_model

BACKBONE = "efficientnet-b1"
BF16 = torch.bfloat16


def _ramps(n, hw, seed):
    """Colour ramps with noise, normalised: structure for the random net."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 1, hw[0])[:, None, None]
    xx = np.linspace(0, 1, hw[1])[None, :, None]
    out = []
    for _ in range(n):
        mix = rng.uniform(-1.0, 1.0, size=(2, 3))
        base = 127.5 + 100 * (yy * mix[0] + xx * mix[1]) + rng.normal(0, 8, size=(*hw, 3))
        out.append(color_norm(np.clip(base, 0, 255).astype(np.uint8)))
    return np.stack(out).astype(np.float32)


def _canvas(sizes, side=64, seed=1):
    """(x rounded to bf16, as f32, and its windows): images at the origin of
    a side x side canvas."""
    x = np.zeros((len(sizes), side, side, 3), np.float32)
    imgs = _ramps(len(sizes), (side, side), seed)
    for i, (h, w) in enumerate(sizes):
        x[i, :h, :w] = imgs[i, :h, :w]
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, np.asarray([[0, 0, h, w] for h, w in sizes], np.int32)


# whole-model bounds, in units of JAX's own bf16-vs-f32 distance (mean, max),
# and the least distance from f32 that shows bf16 ran (module docstring)
MEAN_FACTOR, MAX_FACTOR, RAN_FACTOR = 2.0, 3.0, 0.5
# rounding points: the share of bf16 outputs bit-equal to Flax's (summation
# order flips 0.02-0.3% of them in these layers; a misplaced rounding 30%+)
SAME_BITS = 0.99


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bounded(port16, jax16, jax32, what: str) -> None:
    p, j16, j32 = (_f32(a) for a in (port16, jax16, jax32))
    assert p.shape == j16.shape == j32.shape, what
    ref, d = np.abs(j16 - j32), np.abs(p - j16)
    assert ref.max() > 0, f"{what}: JAX's bf16 equals its f32"
    assert d.mean() <= MEAN_FACTOR * ref.mean(), (what, float(d.mean()), float(ref.mean()))
    assert d.max() <= MAX_FACTOR * ref.max(), (what, float(d.max()), float(ref.max()))
    ran = np.abs(p - j32).mean()
    assert ran >= RAN_FACTOR * ref.mean(), (what, float(ran), float(ref.mean()))


def _same_bits(port16, jax16, share: float, what: str) -> None:
    p, j = _f32(port16), _f32(jax16)
    assert p.shape == j.shape, what
    assert (p == j).mean() >= share, (what, float((p == j).mean()))


def _run_port(model, x, **kw):
    with torch.inference_mode():
        return model(torch.from_numpy(np.array(x)).to(BF16), **kw)


# ---- MuSCLe enc ------------------------------------------------------------

ENC_SIZES = [(60, 44), (40, 64)]


def _randomize_bn(tree, stats, rng):
    for k, sub in tree.items():
        if "scale" in sub:
            n = sub["scale"].shape
            sub["scale"] = rng.uniform(0.75, 1.25, n).astype(np.float32)
            sub["bias"] = rng.uniform(-0.1, 0.1, n).astype(np.float32)
            stats[k]["mean"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
            stats[k]["var"] = rng.uniform(0.5, 1.0, n).astype(np.float32)
        elif "kernel" not in sub:
            _randomize_bn(sub, stats.setdefault(k, {}), rng)


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("windowed", [False, True])
def test_efficientnet_first_blocks_round_where_flax_rounds(windowed):
    from muscle_tpu.models.efficientnet import EfficientNet as JEfficientNet
    from muscle_tpu_torch.models.efficientnet import EfficientNet

    je = JEfficientNet(BACKBONE, last_pooling=False)
    v = _plain(je.init({"params": jax.random.key(1)}, jnp.zeros((1, 32, 32, 3))))
    _randomize_bn(v["params"], v["batch_stats"], np.random.default_rng(1))
    x, win = _canvas(ENC_SIZES)
    kw = dict(valid_window=jnp.asarray(win)) if windowed else {}
    # op by op, not jitted: each op's output in its dtype, the program's
    # rounding points (under jit XLA keeps fused elementwise chains in f32)
    j16 = JEfficientNet(BACKBONE, last_pooling=False, dtype=jnp.bfloat16).apply(
        v, jnp.asarray(x, jnp.bfloat16), **kw)
    model = EfficientNet(BACKBONE, last_pooling=False)
    sd = state_dict_from_jax({"params": {"backbone": v["params"]},
                              "batch_stats": {"backbone": v["batch_stats"]}})
    model.load_state_dict({k[len("backbone."):]: t for k, t in sd.items()}, strict=False)
    tkw = dict(valid_window=torch.from_numpy(win)) if windowed else {}
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(np.array(x)).to(BF16), **tkw)
    for i in range(3):  # the stem and blocks 0-2 (block 2: stride 2, expand 6)
        assert got[i].dtype == BF16
        _same_bits(got[i], j16[i], SAME_BITS, f"block {i}")


def test_enc_cam_modes_match_jax_bf16():
    jm32 = JMuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False)
    v = _plain(jm32.init({"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)), mode="cam"))
    _randomize_bn(v["params"], v["batch_stats"], np.random.default_rng(0))
    x, win = _canvas(ENC_SIZES)

    def run(dtype):
        jm = JMuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False, dtype=dtype)
        fn = jax.jit(lambda v, x, w: (jm.apply(v, x, mode="cam"),
                                      jm.apply(v, x, mode="cam_lowres", valid_window=w)))
        return fn(v, jnp.asarray(x, dtype), jnp.asarray(win))

    (cam16, low16), (cam32, low32) = run(jnp.bfloat16), run(jnp.float32)
    model = MuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False)
    model.load_state_dict(state_dict_from_jax(v), strict=False)
    model.eval()
    got_cam = _run_port(model, x, mode="cam")
    got_low = _run_port(model, x, mode="cam_lowres", valid_window=torch.from_numpy(win))
    names = ("cams", "sgc", "emb", "logits")
    for mode, got, j16, j32 in (("cam", got_cam, cam16, cam32),
                                ("cam_lowres", got_low, low16, low32)):
        # jnp's promotion: maps and logits f32 (the f32 classifier kernel),
        # the embedding bf16
        for name, g, w in zip(names, got, j16):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (mode, name, g.dtype, w.dtype)
        for name, g, w16, w32 in zip(names, got, j16, j32):
            _bounded(g.float(), w16, w32, f"enc {mode} {name}")


# ---- MuSCLe dec ------------------------------------------------------------

DEC_SIZES = [(50, 40), (40, 56)]


def test_dec_seg_modes_match_jax_bf16():
    model = MuSCLe(backbone_name=BACKBONE, mode="dec", bifpn_layers=1, bifpn_channels=64)
    init_weights(model, torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode():
        calibrate_seg_head(model, torch.from_numpy(_ramps(2, (64, 64), seed=0)))
    sd = {k: t.numpy() for k, t in model.state_dict().items() if "num_batches_tracked" not in k}
    v = convert_muscle_state_dict(sd)
    x, win = _canvas(DEC_SIZES)

    def run(dtype):
        jm = JMuSCLe(backbone_name=BACKBONE, mode="dec", bifpn_layers=1, bifpn_channels=64,
                     dtype=dtype)
        fn = jax.jit(lambda v, x, w: (jm.apply(v, x, mode="seg"),
                                      jm.apply(v, x, mode="seg_lowres", valid_window=w)))
        return fn(v, jnp.asarray(x, dtype), jnp.asarray(win))

    (seg16, low16), (seg32, low32) = run(jnp.bfloat16), run(jnp.float32)
    got_seg = _run_port(model, x, mode="seg")
    got_low = _run_port(model, x, mode="seg_lowres", valid_window=torch.from_numpy(win))
    for mode, got, j16, j32 in (("seg", got_seg, seg16, seg32),
                                ("seg_lowres", got_low, low16, low32)):
        for name, g, w16, w32 in zip(("logits", "features"), got, j16, j32):
            assert g.dtype == BF16 and w16.dtype == jnp.bfloat16, (mode, name)
            _bounded(g.float(), w16, w32, f"dec {mode} {name}")


@pytest.mark.parametrize("windowed", [False, True])
def test_bifpn_rounds_where_flax_rounds(windowed):
    """One 64-channel BiFPN layer on the same bf16 features (b1's p3..p7 on
    a 128 x 128 dec canvas): windowed, its resizes and pools promote to f32
    and the next conv casts back, as under jnp."""
    from muscle_tpu.models.bifpn import BiFPN as JBiFPN

    dec = MuSCLe(backbone_name=BACKBONE, mode="dec", bifpn_layers=1, bifpn_channels=64)
    init_weights(dec, torch.Generator().manual_seed(3)).eval()
    sd = {k: t.numpy() for k, t in dec.state_dict().items() if "num_batches_tracked" not in k}
    v = convert_muscle_state_dict(sd)
    v = {"params": v["params"]["BIFPN"], "batch_stats": v["batch_stats"]["BIFPN"]}
    model = dec.BIFPN
    rng = np.random.default_rng(3)
    shapes = [(16, 40), (8, 80), (8, 112), (4, 192), (4, 320)]  # strides 8, 16, 16, 32, 32
    feats = [np.asarray(jnp.asarray(rng.normal(size=(2, s, s, c)), jnp.bfloat16))
             for s, c in shapes]
    windows = None
    if windowed:
        sizes = np.asarray([[100, 76], [64, 128]], np.int32)
        # the static-pad floor chain: each level's window is size // stride
        windows = [np.concatenate([np.zeros_like(sizes), sizes // st], -1).astype(np.int32)
                   for st in (8, 16, 16, 32, 32)]
    want = JBiFPN(channels=64, num_layers=1, dtype=jnp.bfloat16).apply(
        v, [jnp.asarray(f) for f in feats],
        windows=None if windows is None else [jnp.asarray(w) for w in windows])
    with torch.inference_mode():
        got = model([torch.from_numpy(np.array(f.astype(np.float32))).to(BF16) for f in feats],
                    windows=None if windows is None else [torch.from_numpy(w) for w in windows])
    assert all(g.dtype == BF16 and w.dtype == jnp.bfloat16 for g, w in zip(got, want))
    # over all levels: windowed, the f32 resizes' sums (another order) flip
    # a cast now and then, and the small p6/p7 maps spread a flip over a
    # pixel's 64 channels (97.8% there, 99.94% at p3; unwindowed all equal)
    _same_bits(torch.cat([g.reshape(-1) for g in got]),
               jnp.concatenate([w.reshape(-1) for w in want]), SAME_BITS, "BiFPN levels")


# ---- IRN ----------------------------------------------------------------------

def test_resnet50_stem_rounds_where_flax_rounds():
    from muscle_tpu.models.resnet50 import ResNet50 as JResNet50

    _, variables, sd = make_irn()
    model = port_model(sd)
    x = np.zeros((2, 64, 64, 3), np.float32)
    x[:, :50, :44] = np.random.default_rng(6).normal(size=(2, 50, 44, 3))
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    sub = {"params": variables["params"]["net"]["resnet50"],
           "batch_stats": variables["batch_stats"]["net"]["resnet50"]}
    want = JResNet50(strides=(2, 2, 2, 1), dtype=jnp.bfloat16).apply(  # op by op
        sub, jnp.asarray(x, jnp.bfloat16))
    with torch.inference_mode():
        got = model.resnet50(torch.from_numpy(np.array(x)).to(BF16).permute(0, 3, 1, 2))
    for i in range(2):  # the pooled stem and layer 1
        assert got[i].dtype == BF16
        _same_bits(got[i].permute(0, 2, 3, 1), want[i], SAME_BITS, f"resnet50 stage {i}")


def test_edge_displacement_matches_jax_bf16():
    jm32, variables, sd = make_irn()
    model = port_model(sd)
    rng = np.random.default_rng(5)
    img = rng.normal(size=(50, 44, 3)).astype(np.float32)
    pair = np.stack([img, img[:, ::-1]])
    pair = np.asarray(jnp.asarray(pair, jnp.bfloat16).astype(jnp.float32))
    hw = np.asarray([50, 44], np.int32)

    def run(dtype):
        jm = JEdgeDisplacement(crop_size=64, dtype=dtype)
        return jax.jit(lambda v, x, s: jm.apply(v, x, valid_hw=s))(
            variables, jnp.asarray(pair, dtype), jnp.asarray(hw))

    (e16, d16), (e32, d32) = run(jnp.bfloat16), run(jnp.float32)
    edge, dp = _run_port(model, pair, valid_hw=torch.from_numpy(hw))
    # the displacement promotes to f32 at the f32 MeanShift, as under jnp
    assert edge.dtype == BF16 and e16.dtype == jnp.bfloat16
    assert dp.dtype == torch.float32 and d16.dtype == jnp.float32
    _bounded(edge.float(), e16, e32, "irn edge")
    _bounded(dp.float(), d16, d32, "irn displacement")


# ---- the rounding points, one case each ------------------------------------------

def test_batch_norm_computes_in_f32_and_rounds_to_bf16():
    """BatchNorm at bf16 computes (x - mean) * scale / sqrt(var + eps) + bias
    in f32 against the f32 statistics and parameters and rounds the output
    once, as Flax's ``BatchNorm(dtype=bf16)``; a norm run in bf16 with bf16
    parameters rounds at every step and misses it."""
    rng = np.random.default_rng(3)
    c = 48
    x = np.asarray(jnp.asarray(rng.normal(2.0, 3.0, size=(2, 7, 9, c)), jnp.bfloat16))
    scale, bias = rng.uniform(0.5, 2.0, c), rng.uniform(-1.0, 1.0, c)
    mean, var = rng.uniform(-1.0, 3.0, c), rng.uniform(0.2, 4.0, c)
    fl = nn.BatchNorm(use_running_average=True, epsilon=1e-3, dtype=jnp.bfloat16)
    want = fl.apply({"params": {"scale": jnp.asarray(scale, jnp.float32),
                                "bias": jnp.asarray(bias, jnp.float32)},
                     "batch_stats": {"mean": jnp.asarray(mean, jnp.float32),
                                     "var": jnp.asarray(var, jnp.float32)}}, jnp.asarray(x))
    bn = BatchNorm2d(c, eps=1e-3).eval()
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.tensor(a, dtype=torch.float32))
    tx = torch.from_numpy(np.asarray(x.astype(np.float32))).to(BF16).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = bn(tx).permute(0, 2, 3, 1)
        in_bf16 = torch.nn.functional.batch_norm(
            tx, bn.running_mean.to(BF16), bn.running_var.to(BF16), bn.weight.to(BF16),
            bn.bias.to(BF16), False, 0.0, 1e-3).permute(0, 2, 3, 1)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().numpy()
    # f32 sums in another order: a rounding may land one ulp apart
    assert (np.abs(g - w) <= 2.0 ** -8 * np.abs(w)).all()
    assert (g == w).mean() >= 0.99
    assert (in_bf16.float().numpy() != w).mean() > 0.05


def test_resizes_take_the_jax_dtypes():
    """resize_bilinear's matrices take x's dtype (a bf16 map resizes in
    bf16); the window resize's weights stay f32, so a bf16 source promotes
    to an f32 output, as under jnp."""
    rng = np.random.default_rng(4)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, 9, 13, 5)), jnp.bfloat16))
    jx = jnp.asarray(x)
    tx = torch.from_numpy(np.asarray(x.astype(np.float32))).to(BF16)
    want = JR.resize_bilinear(jx, (17, 6), align_corners=True)
    got = TR.resize_bilinear(tx, (17, 6), align_corners=True)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2.0 ** -8, atol=2.0 ** -8)
    # not the f32 resize rounded at the end: the matrices are bf16 too
    f32 = TR.resize_bilinear(tx.float(), (17, 6), align_corners=True).to(BF16)
    assert not torch.equal(f32, got)
    sw = np.array([[0, 0, 7, 11], [0, 0, 9, 6]], np.int32)
    dw = np.array([[0, 0, 3, 5], [0, 0, 4, 2]], np.int32)
    want = JR.batched_window_resize_ac(jx, jnp.asarray(sw), jnp.asarray(dw), (4, 6))
    got = TR.batched_window_resize_ac(tx, torch.from_numpy(sw), torch.from_numpy(dw), (4, 6))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    pooled, _ = TR.batched_window_avgpool_s2(tx, torch.from_numpy(sw), (5, 7))
    jpooled, _ = JR.batched_window_avgpool_s2(jx, jnp.asarray(sw), (5, 7))
    assert pooled.dtype == torch.float32 and jpooled.dtype == jnp.float32
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=1e-5)
