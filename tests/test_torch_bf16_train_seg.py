"""The port's segmentation training step at bfloat16 against the JAX
package's ``seg_train_step`` on ``MuSCLe(dtype=jnp.bfloat16)``, from the
same weights and batch as tests/test_torch_train_seg.py (MuSCLe-b1 dec,
BiFPN 1 x 64, crop 64, batch 2, k 16, step 3, a clip that acts,
drop-connect off, BEACON's draws JAX's own), held by
test_torch_bf16_train_mcl.py's rules (its docstring): each loss term and
the gradient norm over DRAW_RUNS runs with other BEACON draws, and on the
first run every parameter's gradient, the Adam step and every BN
statistic's change, each within a stated multiple of JAX's own
bf16-vs-f32 distance on it.  Also the dtypes the losses see, and BEACON's
sampling at bf16: its scores stay float32."""

import functools

import flax.linen

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import muscle_tpu.models.efficientnet as jeff
from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu.training import SegConfig as JSegConfig
from muscle_tpu.training import create_train_state
from muscle_tpu.training import seg_train_step as j_seg_train_step
from muscle_tpu.training.state import make_adam as j_make_adam
from muscle_tpu_torch.core.cam_norm import attach_bg_channel
from muscle_tpu_torch.losses.beacon import FieldLossConfig, boundary_samples
from muscle_tpu_torch.training import SegConfig, make_adam, seg_train_step
from muscle_tpu_torch.training.seg import _dequant_batch, _terms
from test_torch_bf16_mbconv import _round_once  # noqa: F401  (autouse)
from test_torch_bf16_train_mcl import (
    BF16,
    FLIP_FLOOR,
    MEAN_FACTOR,
    SATURATED,
    UPDATE_TOL,
    ZERO_SHARE,
    _np,
    _plain,
    _ran,
    excess,
)
from test_torch_train_seg import CFG, LR, N, WD, _jax_draws, _port, problem  # noqa: F401

BACKBONE = "efficientnet-b1"
DRAW_RUNS = 3  # BEACON draws (JAX keys) whose loss terms are compared
FLOOR_ULPS, HALF_ULP = 4.0, 2.0 ** -8
# bf16 entries bit-equal to Flax's, op by op: one layer (summation order
# flips a few), a train-mode block (batch statistics spread them)
OP_SAME_BITS, BLOCK_SAME_BITS = 0.999, 0.98


def _jmodel(dtype):
    return JMuSCLe(backbone_name=BACKBONE, mode="dec", bifpn_layers=1, bifpn_channels=64,
                   dtype=dtype)


@pytest.fixture(scope="module")
def jax_runs(problem):  # noqa: F811
    """JAX's step at bf16 and at f32 from the same weights and batch, once
    per key: per dtype a list of (new state, float metrics), and the
    draws of each key."""
    _, variables, batch = problem
    keys = [jax.random.key(7 + i) for i in range(DRAW_RUNS)]
    mp = pytest.MonkeyPatch()
    mp.setattr(jeff, "drop_connect", lambda x, rate, key: x)
    out = {}
    try:
        for name, dtype in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
            tx = j_make_adam(LR, WD)
            jm = _jmodel(dtype)
            runs = []
            for key in keys:
                state = create_train_state(jax.tree.map(jnp.asarray, variables), tx)
                new, metrics = j_seg_train_step(jm, tx, state,
                                                {k: jnp.asarray(v) for k, v in batch.items()},
                                                key, JSegConfig(**CFG))
                runs.append((new, {k: float(v) for k, v in metrics.items()}))
            out[name] = runs
    finally:
        mp.undo()
    out["draws"] = [_jax_draws(key, N, 20, 64, 64) for key in keys]
    return out


def test_seg_step_matches_jax_bf16(problem, jax_runs):  # noqa: F811
    """Loss terms and the gradient norm over DRAW_RUNS draws; on the
    first, the clipped gradients, the Adam step and the BN statistics,
    with BEACON engaged."""
    sd, _, batch = problem
    from muscle_tpu_torch.convert import state_dict_from_jax

    got, first = [], None
    for draws in jax_runs["draws"]:
        model = _port(sd)
        before = {k: t.clone() for k, t in model.state_dict().items()}
        opt = make_adam(model.trained_parameters(), LR, WD)
        got.append(seg_train_step(model, opt, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  SegConfig(**CFG), draws=torch.from_numpy(draws),
                                  compute_dtype=BF16))
        first = first or (model, opt, before)
    j16 = [m for _, m in jax_runs["bf16"]]
    j32 = [m for _, m in jax_runs["f32"]]
    # BEACON engaged (at bf16 one draw's push and pull may cancel exactly)
    assert all(m["loss_beacon"] != 0 for m in j32) and any(m["loss_beacon"] for m in j16)
    assert all(m["grad_norm"] > CFG["clip_norm"] for m in j16)
    ratios = {}
    for k in j16[0]:
        assert all(g[k].dtype == torch.float32 for g in got)
        p = np.asarray([float(g[k]) for g in got])
        a = np.asarray([m[k] for m in j16])
        b = np.asarray([m[k] for m in j32])
        floor = FLOOR_ULPS * HALF_ULP * np.abs(a).max()
        ratios[k] = float(np.abs(p - a).mean() / (MEAN_FACTOR * np.abs(a - b).mean() + floor))
    assert all(r <= 1.0 for r in ratios.values()), ratios

    model, opt, before = first
    names = {id(p): n for n, p in model.named_parameters()}
    keys = [names[id(p)] for p in model.trained_parameters()]
    trees = {}
    for name in ("bf16", "f32"):
        new = jax_runs[name][0][0]
        after = state_dict_from_jax({"params": _plain(new.params),
                                     "batch_stats": _plain(new.batch_stats)})
        mu = state_dict_from_jax({"params": _plain(new.opt_state.inner_state[1].mu)})
        trees[name] = (after, {k: _np(mu[k]) / 0.1 - WD * _np(before[k]) for k in keys})
    (a16, g16), (a32, g32) = trees["bf16"], trees["f32"]
    port = dict(model.named_parameters())
    zero = ZERO_SHARE * max(np.abs(g).max() for g in g16.values())
    worst = {"grad": 0.0, "stat": 0.0, "update_same_sign": 0.0}
    flips = own = total = 0
    for k in keys:
        p = port[k]
        worst["grad"] = max(worst["grad"], excess(p.grad, g16[k], g32[k], zero))
        w0 = _np(before[k])
        du, d16, d32 = _np(p) - w0, _np(a16[k]) - w0, _np(a32[k]) - w0
        same = np.sign(du) == np.sign(d16)
        flips += int((~same).sum())
        own += int((np.sign(d32) != np.sign(d16)).sum())
        total += du.size
        sat = same & (np.abs(_np(p.grad) + WD * w0) > SATURATED) & (
            np.abs(g16[k] + WD * w0) > SATURATED)
        if sat.any():
            worst["update_same_sign"] = max(worst["update_same_sign"],
                                            np.abs(du - d16)[sat].max() / (UPDATE_TOL * LR))
    worst["flips"] = flips / (MEAN_FACTOR * own + FLIP_FLOOR * total)
    after = model.state_dict()
    for k in a16:
        if k.endswith("running_mean") or k.endswith("running_var"):
            s0 = _np(before[k])
            worst["stat"] = max(worst["stat"], excess(_np(after[k]) - s0, _np(a16[k]) - s0,
                                                      _np(a32[k]) - s0))
    _ran({k: port[k].grad for k in keys}, g16, g32)
    assert all(v <= 1.0 for v in worst.values()), worst


def test_seg_loss_inputs_have_jax_dtypes(problem):  # noqa: F811
    """At bf16 the train-mode outputs (seg_map, dense_ft) and the loss
    terms have the dtypes of the JAX package's bf16 step (traced, not
    compiled)."""
    sd, variables, batch = problem
    jm = _jmodel(jnp.bfloat16)
    tx = j_make_adam(LR, WD)
    state = create_train_state(jax.tree.map(jnp.asarray, variables), tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    img = _dequant_batch({k: torch.from_numpy(v) for k, v in batch.items()}, 21, BF16)["img"]
    want = jax.eval_shape(lambda v, x: jm.apply(v, x, mode="seg", train=True,
                                                mutable=["batch_stats"],
                                                rngs={"dropout": jax.random.key(0)})[0],
                          {"params": state.params, "batch_stats": state.batch_stats},
                          jnp.asarray(img.float().numpy()))
    model = _port(sd).train()
    with torch.no_grad():
        outs = model(img, mode="seg")
        terms = _terms(model, _dequant_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                                             21, BF16), SegConfig(**CFG), None,
                       torch.from_numpy(np.random.default_rng(0).uniform(
                           size=(N, 20, 64, 64)).astype(np.float32)))
    assert [str(o.dtype).split(".")[-1] for o in outs] == [str(w.dtype) for w in want]
    _, jmet = jax.eval_shape(functools.partial(j_seg_train_step, jm, tx, cfg=JSegConfig(**CFG)),
                             state, jb, jax.random.key(0))
    assert str(terms["seg"].dtype).split(".")[-1] == str(jmet["loss_seg"].dtype)
    assert str(terms["beacon"].dtype).split(".")[-1] == str(jmet["loss_beacon"].dtype)


def _discs(n: int, hw: int, classes: int, seed: int) -> np.ndarray:
    """(n, hw, hw, classes) logits of a few overlapping discs of classes 1..
    on background: long curved boundaries in every orientation."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw].astype(np.float32)
    out = np.zeros((n, hw, hw, classes), np.float32)
    out[..., 0] = 1.0
    for i in range(n):
        for c in range(1, classes):
            cy, cx = rng.uniform(0.25 * hw, 0.75 * hw, 2)
            r = rng.uniform(0.15, 0.3) * hw
            inside = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) < r
            out[i, ..., c] = np.where(inside, 2.0 + 0.1 * c, 0.0)
    return out


def test_beacon_bf16_map_samples_by_f32_scores():
    """BEACON's sampling on a bf16 seg map takes the k valid boundary
    pixels with the highest float32 scores, as the JAX package's float32
    ``jax.random.uniform`` draws do: sampling again with the chosen
    pixels' scores zeroed gives only lower-scored pixels.  Scores rounded
    to bf16 (8 significant bits) tie by the dozen among hundreds of
    boundary pixels, and top-k then picks among the tied ones."""
    n, hw, classes, k = 2, 96, 4, 64
    seg = torch.from_numpy(_discs(n, hw, classes, seed=0)).to(BF16)
    label = torch.zeros((n, classes - 1))
    label[:, :] = 1.0
    lab = attach_bg_channel(label)
    cfg = FieldLossConfig(num_classes=classes, k=k, step=3)
    draws = torch.rand((n, classes - 1, hw, hw), generator=torch.Generator().manual_seed(0))
    out1, in1, _, count, _ = boundary_samples(seg, lab, cfg, draws)
    assert int((count > 2 * k).sum()) >= 3, count  # pairs with hundreds of valid pixels
    flat = draws.flatten(2).flatten(0, 1)  # (P, HW)
    pix1 = (out1 + in1) // 2  # the boundary pixel between its two samples
    again = flat.clone()
    again.scatter_(1, pix1, 0.0)
    out2, in2, _, _, _ = boundary_samples(seg, lab, cfg, again.reshape(draws.shape))
    pix2 = (out2 + in2) // 2
    for p in torch.nonzero(count > 2 * k)[:, 0].tolist():
        first, second = flat[p, pix1[p]], flat[p, pix2[p]]
        assert float(first.min()) > float(second.max()), (p, float(first.min()),
                                                          float(second.max()))


class _Gate:
    """The SE gate of the reference's block, ``sigmoid(se) * x``, with the
    gate's cotangent summed over the pixels in float32 and rounded once,
    as torch's backward of the broadcasting product sums it.  XLA's CPU
    backend, run op by op, sums that broadcast's cotangent in bf16, one
    rounding per pixel (``test_xla_cpu_sums_a_bf16_broadcast_cotangent_in_bf16``);
    the block's other bf16 broadcasts (the SE convs' biases) sum two
    entries, where both orders round once."""

    def __init__(self, gate):
        self.gate = gate

    def __mul__(self, x):
        return _gate_mul(self.gate, x)


@jax.custom_vjp
def _gate_mul(gate, x):
    return gate * x


def _gate_fwd(gate, x):
    return gate * x, (gate, x)


def _gate_bwd(res, g):
    gate, x = res
    dgate = jnp.sum((g * x).astype(jnp.float32), axis=(1, 2), keepdims=True)
    return dgate.astype(gate.dtype), gate * g


_gate_mul.defvjp(_gate_fwd, _gate_bwd)


def test_xla_cpu_sums_a_bf16_broadcast_cotangent_in_bf16():
    """The evaluation detail ``_Gate`` sets aside: the cotangent of a
    bf16 (N, 1, 1, C) factor broadcast over (N, H, W, C) is the bf16
    products summed in bf16, one rounding per term, on XLA's CPU backend."""
    rng = np.random.default_rng(0)
    x, g = (jnp.asarray(rng.normal(size=(2, 8, 8, 4)), jnp.bfloat16) for _ in range(2))
    s = jnp.asarray(rng.normal(size=(2, 1, 1, 4)), jnp.bfloat16)
    got = np.asarray(jax.vjp(lambda s: s * x, s)[1](g)[0], np.float32)
    prods = np.asarray(g * x, np.float32)
    acc = np.zeros((2, 1, 1, 4), np.float32)
    for i in range(8):
        for j in range(8):
            acc = np.asarray(jnp.asarray(acc + prods[:, i:i + 1, j:j + 1], jnp.bfloat16),
                             np.float32)
    np.testing.assert_array_equal(got, acc)


def _t16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32))).to(BF16)


def _nchw(a) -> torch.Tensor:
    return _t16(a).permute(0, 3, 1, 2)


def _same_bits(got, want, what: str, share: float) -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    assert (g == w).mean() >= share, (what, float((g == w).mean()))


def _op_case(op: str, rng):
    """One layer of the train-mode block on bf16 inputs: (JAX function of
    (params, x), its params, x, the port's module or function of x, and
    the port's SE gate leaf for 'se_gate')."""
    import flax.linen as fnn

    from muscle_tpu_torch.models.efficientnet import BatchNorm2d
    from muscle_tpu_torch.models.layers import Conv2d

    x = jnp.asarray(rng.normal(size=(2, 19, 33, 48)), jnp.bfloat16)
    if op in ("conv1x1", "depthwise5", "se_conv"):
        k, groups, cout, bias = {"conv1x1": (1, 1, 96, False), "depthwise5": (5, 48, 48, False),
                                 "se_conv": (1, 1, 12, True)}[op]
        if op == "se_conv":
            x = jnp.mean(x, axis=(1, 2), keepdims=True)
        conv = fnn.Conv(cout, (k, k), padding="SAME", use_bias=bias, feature_group_count=groups,
                        dtype=jnp.bfloat16)
        params = conv.init(jax.random.key(0), jnp.asarray(x, jnp.float32))["params"]
        if bias:
            params = {**params, "bias": jnp.asarray(rng.normal(size=cout), jnp.float32)}
        port = Conv2d(48, cout, k, padding=k // 2, groups=groups, bias=bias)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(np.asarray(params["kernel"]).transpose(3, 2, 0, 1)))
            if bias:
                port.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
        return lambda p, x: conv.apply({"params": p}, x), params, x, port, None
    if op == "bn_train":
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3,
                           dtype=jnp.bfloat16)
        params = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 48), jnp.float32),
                  "bias": jnp.asarray(rng.uniform(-0.5, 0.5, 48), jnp.float32)}
        stats = {"mean": jnp.zeros(48), "var": jnp.ones(48)}
        port = BatchNorm2d(48, eps=1e-3, momentum=0.01).train()
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(np.asarray(params["scale"])))
            port.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
        return (lambda p, x: bn.apply({"params": p, "batch_stats": stats}, x,
                                      mutable=["batch_stats"])[0]), params, x, port, None
    gate = jnp.asarray(rng.uniform(0, 1, size=(2, 1, 1, 48)), jnp.bfloat16)
    fns = {"silu": (lambda p, x: flax.linen.silu(x), lambda t: torch.nn.functional.silu(t)),
           "se_mean": (lambda p, x: jnp.mean(x, axis=(1, 2), keepdims=True),
                       lambda t: t.mean(dim=(2, 3), keepdim=True)),
           "se_gate": (lambda p, x: _Gate(p["gate"]) * x,
                       lambda t: port_gate * t)}
    port_gate = _nchw(gate).requires_grad_(True)
    jf, tf = fns[op]
    return jf, {"gate": gate}, x, tf, port_gate


@pytest.mark.parametrize("op", ["conv1x1", "depthwise5", "se_conv", "bn_train", "silu",
                                "se_mean", "se_gate"])
def test_train_layers_round_where_flax_rounds(op):
    """Each layer of the train-mode MBConv block at bf16, given the same
    bf16 input and output cotangent, against Flax's applied op by op:
    the output and the input's cotangent bit-equal on OP_SAME_BITS of
    their entries, the parameters' cotangents too where a bf16 op makes
    them (a convolution's kernel and bias, the SE gate), a norm's float32
    scale and bias cotangents within 1e-6 of their largest (float32 sums
    in other orders).  One rounding
    placed elsewhere than Flax's flips a third or more of the entries:
    torch's single float32 batch norm, whose backward rounds the sum of
    the statistics' and the normalisation's cotangents once where JAX
    rounds each, flipped 28% of the input cotangent (``BatchNorm2d``
    keeps them apart)."""
    rng = np.random.default_rng(1)
    jf, params, x, port, port_gate = _op_case(op, rng)
    y, vjp = jax.vjp(jf, params, x)
    g = jnp.asarray(rng.normal(size=y.shape), jnp.bfloat16)
    jp, jx = vjp(g)
    tx = _nchw(x).requires_grad_(True)
    ty = port(tx)
    ty.backward(_nchw(g))
    _same_bits(ty.permute(0, 2, 3, 1), y, f"{op} output", OP_SAME_BITS)
    _same_bits(tx.grad.permute(0, 2, 3, 1), jx, f"{op} input cotangent", OP_SAME_BITS)
    if op == "se_gate":
        _same_bits(port_gate.grad.permute(0, 2, 3, 1), jp["gate"], "gate cotangent",
                   OP_SAME_BITS)
    elif isinstance(port, torch.nn.Module):
        for leaf, want in jp.items():
            got = port.get_parameter("weight" if leaf in ("kernel", "scale") else "bias").grad
            want = np.asarray(want, np.float32)
            if leaf == "kernel":
                want = want.transpose(3, 2, 0, 1)
            if op == "bn_train":  # float32 sums of bf16 cotangents, in other orders
                np.testing.assert_allclose(_np(got), want, rtol=0,
                                           atol=1e-6 * np.abs(want).max(), err_msg=leaf)
            else:
                _same_bits(got, want, f"{op} {leaf}", OP_SAME_BITS)


@pytest.mark.parametrize("case", ["k5_expand", "no_skip"])
def test_mbconv_block_train_bf16_matches_flax(case, monkeypatch):
    """One MBConv block in train mode at bf16 against Flax's, op by op:
    the output bit-equal on BLOCK_SAME_BITS of its entries (each BN's batch
    statistics, float32 sums in other orders, flip ~0.1% of its bf16
    outputs, and a 1x1 convolution over 144 channels spreads them to ~1%
    of its own), the updated running statistics within a few bf16 ulps of
    their change, and the gradients of a fixed projection of the output
    with respect to the input and every parameter held as the model's are
    (``excess``: JAX's own bf16-vs-f32 distance on each): a batch norm's
    backward sums its input's cotangent against the normalised values, so
    the forward's flips reach every gradient below it."""
    from muscle_tpu.models.efficientnet import MBConvBlock
    from test_torch_mbconv import CASES, _port_block

    args, h, w, _, seed = CASES[case]
    rng = np.random.default_rng(seed)
    x16 = jnp.asarray(rng.normal(size=(2, h, w, args.input_filters)).astype(np.float32) * 0.5,
                      jnp.bfloat16)
    v = MBConvBlock(args).init({"params": jax.random.key(seed)}, jnp.asarray(x16, jnp.float32))
    bs = jax.tree.map(lambda a: jnp.asarray(np.abs(rng.normal(size=a.shape, scale=0.3)) + 0.2,
                                            a.dtype), v["batch_stats"])
    proj = rng.normal(size=(2, h, w, args.output_filters)).astype(np.float32)
    sigmoid = jax.nn.sigmoid  # rounded once (_round_once)
    monkeypatch.setattr(jax.nn, "sigmoid", lambda z: _Gate(sigmoid(z)))

    def grads(dtype):
        jb = MBConvBlock(args, dtype=dtype)

        def loss(params, x):
            y, upd = jb.apply({"params": params, "batch_stats": bs}, x, train=True,
                              mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * proj), (y, upd["batch_stats"])

        return jax.grad(loss, argnums=(0, 1), has_aux=True)(v["params"], x16.astype(dtype))

    (g16, gx16), (jy, jstats) = grads(jnp.bfloat16)
    (g32, gx32), _ = grads(jnp.float32)

    block = _port_block(args, {"params": v["params"], "batch_stats": bs}).train()
    x = _t16(x16).requires_grad_(True)
    y = block(x)
    (y.float() * torch.from_numpy(proj)).sum().backward()
    assert y.dtype == BF16 and x.grad.dtype == BF16
    _same_bits(y, jy, "output", BLOCK_SAME_BITS)
    assert excess(x.grad, gx16, gx32) <= 1.0, "input gradient"
    for name, sub in g16.items():
        for leaf, want in sub.items():
            t = block.get_parameter(f"{name}.{'weight' if leaf in ('kernel', 'scale') else 'bias'}")
            assert t.grad.dtype == torch.float32
            tr = (lambda a: np.asarray(a, np.float32).transpose(3, 2, 0, 1)) if leaf == "kernel" \
                else (lambda a: np.asarray(a, np.float32))
            assert excess(t.grad, tr(want), tr(g32[name][leaf])) <= 1.0, f"{name}.{leaf}"
    for name, st in jstats.items():
        bn = block.get_submodule(name)
        for key, ours in (("mean", bn.running_mean), ("var", bn.running_var)):
            want, old = np.asarray(st[key]), np.asarray(bs[name][key])
            np.testing.assert_allclose(_np(ours), want, rtol=0,
                                       atol=FLOOR_ULPS * HALF_ULP * np.abs(want - old).max(),
                                       err_msg=f"{name}.{key}")
