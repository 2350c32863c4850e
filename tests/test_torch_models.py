"""The port's EfficientNet and MuSCLe (muscle_tpu_torch/models) against the
JAX package's Flax modules on the same weights (carried across by
muscle_tpu_torch.convert.state_dict_from_jax) and inputs, at b1 and small
sizes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from muscle_tpu.convert import flax_to_muscle_state_dict
from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu.models.efficientnet import EfficientNet as JEfficientNet
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.models import MuSCLe, init_weights

# f32 on both sides, 20+ chained convs summed in different orders
ATOL, RTOL = 1e-4, 1e-4
BACKBONE = "efficientnet-b1"


def _randomize_bn(variables, seed):
    """Batch norms near the identity with random scale, shift and
    statistics: identity norms let a random b1's activations decay to
    ~1e-7, where any comparison passes."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for k, sub in p.items():
            if "scale" in sub:
                n = sub["scale"].shape
                sub["scale"] = rng.uniform(0.75, 1.25, n).astype(np.float32)
                sub["bias"] = rng.uniform(-0.1, 0.1, n).astype(np.float32)
                s[k]["mean"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.0, n).astype(np.float32)
            elif "kernel" not in sub:
                walk(sub, s.setdefault(k, {}))

    walk(variables["params"], variables["batch_stats"])
    return variables


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def weights():
    model = JMuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False)
    v = model.init({"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)), mode="cam")
    return model, _randomize_bn(_plain(v), seed=0)


def _port(variables, fuse=0):
    m = MuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False, fuse_mbconv=fuse)
    m.load_state_dict(state_dict_from_jax(variables), strict=False)
    return m.eval()


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def _canvas(hw, sizes, seed):
    rng = np.random.default_rng(seed)
    if sizes is None:
        return rng.normal(size=(2, *hw, 3)).astype(np.float32), None
    x = np.zeros((len(sizes), *hw, 3), np.float32)
    for i, (h, w) in enumerate(sizes):
        x[i, :h, :w] = rng.normal(size=(h, w, 3))
    return x, np.asarray([[0, 0, h, w] for h, w in sizes], np.int32)


PYRAMID_CASES = {
    "64x64": ((64, 64), None),
    "57x43_odd": ((57, 43), None),  # the static-pad floor chain
    "64x64_windowed": ((64, 64), [(50, 40), (40, 56)]),
}


@pytest.fixture(scope="module")
def jax_pyramids(weights):
    _, v = weights
    net = JEfficientNet(model_name=BACKBONE, last_pooling=False)
    bv = {"params": v["params"]["backbone"], "batch_stats": v["batch_stats"]["backbone"]}
    out = {}
    for name, (hw, sizes) in PYRAMID_CASES.items():
        x, win = _canvas(hw, sizes, seed=1)
        feats = net.apply(bv, jnp.asarray(x),
                          valid_window=None if win is None else jnp.asarray(win))
        out[name] = (x, win, [np.asarray(f) for f in feats])
    return out


@pytest.mark.parametrize("fuse", [0, 384])
@pytest.mark.parametrize("case", sorted(PYRAMID_CASES))
def test_backbone_pyramid_matches_jax(weights, jax_pyramids, case, fuse):
    _, v = weights
    x, win, want = jax_pyramids[case]
    model = _port(v, fuse)
    with torch.inference_mode():
        got = model.backbone(torch.from_numpy(x),
                             valid_window=None if win is None else torch.from_numpy(win))
    assert len(got) == len(want) == 23
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w)


MODE_CASES = {
    "cam": ("cam", (64, 64), None, None),
    "cam_odd": ("cam", (57, 43), None, None),
    "logits": ("logits", (57, 43), None, None),
    "pix": ("pix", (64, 64), None, None),
    "cam_lowres_window": ("cam_lowres", (64, 64), [(50, 40), (40, 56)], "window"),
    "cam_valid_hw": ("cam", (64, 64), [(50, 40), (40, 56)], "hw"),
}


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_muscle_modes_match_jax(weights, case):
    jmodel, v = weights
    mode, hw, sizes, masking = MODE_CASES[case]
    x, win = _canvas(hw, sizes, seed=2)
    jkw, tkw = {}, {}
    if masking == "window":
        jkw["valid_window"], tkw["valid_window"] = jnp.asarray(win), torch.from_numpy(win)
    elif masking == "hw":
        jkw["valid_hw"], tkw["valid_hw"] = jnp.asarray(win[:, 2:]), torch.from_numpy(win[:, 2:])
    want = jmodel.apply(v, jnp.asarray(x), mode=mode, **jkw)
    model = _port(v, fuse=384)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), mode=mode, **tkw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w)


def test_converter_keys_match_jax_inverse(weights):
    _, v = weights
    sd = state_dict_from_jax(v)
    ref = flax_to_muscle_state_dict(v)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert tuple(sd[k].shape) == ref[k].shape, k
        np.testing.assert_array_equal(sd[k].numpy(), ref[k])
    # the port's module holds exactly those keys, plus the BN counters and
    # the decoder head the enc-mode JAX tree never creates
    own = {k: t for k, t in _port(v).state_dict().items() if "num_batches_tracked" not in k}
    assert sorted(set(own) - set(sd)) == ["fuse_dec.bias", "fuse_dec.weight"]
    assert set(sd) <= set(own)
    for k in sd:
        assert own[k].shape == sd[k].shape, k


def test_muscle_rejects_unported_modes():
    """An enc model refuses the dec (segmentation) modes and a dec model the
    enc ones; an unknown forward or model mode raises ValueError."""
    with pytest.raises(ValueError, match="unknown MuSCLe mode"):
        MuSCLe(backbone_name=BACKBONE, mode="decoder")
    enc = MuSCLe(backbone_name=BACKBONE, last_pooling=False).eval()
    dec = MuSCLe(backbone_name=BACKBONE, mode="dec", bifpn_layers=1).eval()
    x = torch.zeros((1, 32, 32, 3))
    with torch.inference_mode():
        for mode in ("seg", "seg_lowres", "vis"):
            with pytest.raises(ValueError, match="mode='dec'"):
                enc(x, mode=mode)
        for mode in ("cam", "logits"):
            with pytest.raises(ValueError, match="mode='enc'"):
                dec(x, mode=mode)
        for model in (enc, dec):
            with pytest.raises(ValueError, match="unknown mode"):
                model(x, mode="nope")


def test_init_weights_is_seeded():
    a = init_weights(MuSCLe(backbone_name=BACKBONE), torch.Generator().manual_seed(3))
    b = init_weights(MuSCLe(backbone_name=BACKBONE), torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k


def test_fused_blocks_match_b1_eligibility():
    """fuse_mbconv gates exactly the stride-1 blocks whose input width is
    within the limit (b1: every block but the stride-2 stage leads), in
    inference; with autograd on (the kernel has no backward) none."""
    from muscle_tpu_torch.models.efficientnet import efficientnet_config

    for name, n_stride1 in (("efficientnet-b1", 20), ("efficientnet-b3", 23)):
        blocks, _ = efficientnet_config(name, last_pooling=False)
        model = MuSCLe(backbone_name=name, last_pooling=False, fuse_mbconv=384).eval()
        with torch.inference_mode():
            fusable = [b.fusable() and a.input_filters <= 384
                       for a, b in zip(blocks, model.backbone._blocks)]
        assert sum(fusable) == n_stride1
        assert not any(b.fusable() for b in model.backbone._blocks)


def test_fused_blocks_match_b7_dec_eligibility():
    """The seg model, MuSCLe-b7 dec (last_pooling=True), at fuse_mbconv=384
    runs 48 of its 55 blocks through the MBConv kernel: every stride-1
    block (the widest takes 384 channels in)."""
    from muscle_tpu_torch.models.efficientnet import efficientnet_config

    blocks, _ = efficientnet_config("efficientnet-b7", last_pooling=True)
    model = MuSCLe(backbone_name="efficientnet-b7", mode="dec", last_pooling=True,
                   fuse_mbconv=384).eval()
    with torch.inference_mode():
        fusable = [b.fusable() and a.input_filters <= model.backbone.fuse_max_in_filters
                   for a, b in zip(blocks, model.backbone._blocks)]
    assert len(blocks) == 55 and sum(fusable) == 48
    assert max(a.input_filters for a, f in zip(blocks, fusable) if f) == 384
    assert sum(a.stride == 2 for a in blocks) == 4  # stages 2-4 and 6 lead with stride 2
