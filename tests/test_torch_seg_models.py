"""The port's MuSCLe in dec mode (muscle_tpu_torch/models/muscle.py: the b1
backbone, a one-layer BiFPN and the segmentation head) against the JAX
package's on the same weights and inputs, in the 'seg', 'seg_lowres' and
'vis' modes, with and without windows, and with the stride-1 MBConv
blocks plain or through the kernel wrapper (the JAX side runs its Pallas
kernel in interpret mode); and the dec converter against the JAX
package's inverse."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import muscle_tpu.ops.pallas.mbconv as PM
from muscle_tpu.convert import convert_muscle_state_dict, flax_to_muscle_state_dict
from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.data.transforms import color_norm
from muscle_tpu_torch.models import MuSCLe, calibrate_seg_head, init_weights

# f32 on both sides, 20+ chained convs and the BiFPN summed in different
# orders (the port's model bounds, test_torch_models.py)
ATOL, RTOL = 1e-4, 1e-4
BACKBONE = "efficientnet-b1"
MODES = ("seg", "seg_lowres", "vis")


def _dec(fuse=0):
    return MuSCLe(backbone_name=BACKBONE, mode="dec", bifpn_layers=1, fuse_mbconv=fuse)


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
    return np.stack(out)


@pytest.fixture(scope="module")
def weights():
    """A seeded random port model (batch norms near the identity, the head
    calibrated so the logits vary), its state dict, and the JAX package's
    tree of it."""
    model = init_weights(_dec(), torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode():
        calibrate_seg_head(model, torch.from_numpy(_ramps(2, (64, 64), seed=0)))
    sd = {k: t.numpy() for k, t in model.state_dict().items() if "num_batches_tracked" not in k}
    return sd, convert_muscle_state_dict(sd)


def test_dec_tree_is_the_jax_models_tree(weights):
    """The tree the tests feed the JAX model has the structure and shapes
    of the JAX model's own initialisation."""
    _, v = weights
    jm = JMuSCLe(backbone_name=BACKBONE, mode="dec", bifpn_layers=1)
    want = jax.eval_shape(lambda k: jm.init({"params": k}, jnp.zeros((1, 64, 64, 3)),
                                            mode="seg_lowres"), jax.random.key(0))
    flat_want = {k: s.shape for k, s in jax.tree_util.tree_leaves_with_path(want)}
    flat_got = {k: np.shape(a) for k, a in jax.tree_util.tree_leaves_with_path(v)}
    assert flat_got == flat_want


def test_dec_converter_keys_match_jax_inverse(weights):
    sd0, v = weights
    sd = state_dict_from_jax(v)
    ref = flax_to_muscle_state_dict(v)
    assert sorted(sd) == sorted(ref)
    assert any(k.startswith("BIFPN.BIFPN_Layers.0.") for k in sd)
    for k in ref:
        assert tuple(sd[k].shape) == ref[k].shape, k
        np.testing.assert_array_equal(sd[k].numpy(), ref[k])
        np.testing.assert_array_equal(sd[k].numpy(), sd0[k])
    # the port's module holds exactly those keys (and the BN counters)
    own = {k for k in _dec().state_dict() if "num_batches_tracked" not in k}
    assert own == set(sd)


SIZES = [(50, 40), (40, 56)]


def _inputs():
    x = np.zeros((2, 64, 64, 3), np.float32)
    imgs = _ramps(2, (64, 64), seed=1)
    for i, (h, w) in enumerate(SIZES):
        x[i, :h, :w] = imgs[i, :h, :w]
    win = np.asarray([[0, 0, h, w] for h, w in SIZES], np.int32)
    return x, win


@pytest.fixture(scope="module")
def jax_outputs(weights):
    """JAX outputs of every mode per (fuse, windowed), one jit each; with
    fuse 384 the Pallas MBConv kernel runs in interpret mode."""
    _, v = weights
    x, win = _inputs()
    cache = {}

    def get(fuse, windowed):
        if (fuse, windowed) not in cache:
            jm = JMuSCLe(backbone_name=BACKBONE, mode="dec", bifpn_layers=1, fuse_mbconv=fuse)

            def run(v, x, w):
                return {m: jm.apply(v, x, mode=m, valid_window=w) for m in MODES}

            orig = PM.fused_mbconv_stride1
            PM.fused_mbconv_stride1 = functools.partial(orig, interpret=True)
            try:
                out = jax.jit(run)(v, jnp.asarray(x), jnp.asarray(win) if windowed else None)
            finally:
                PM.fused_mbconv_stride1 = orig
            cache[(fuse, windowed)] = jax.tree.map(np.asarray, out)
        return cache[(fuse, windowed)]

    return get


@pytest.mark.parametrize("fuse", [0, 384])
@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_seg_modes_match_jax(weights, jax_outputs, mode, windowed, fuse):
    sd, _ = weights
    want = jax_outputs(fuse, windowed)[mode]
    x, win = _inputs()
    model = _dec(fuse)
    model.load_state_dict({k: torch.from_numpy(a) for k, a in sd.items()}, strict=False)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x), mode=mode,
                           valid_window=torch.from_numpy(win) if windowed else None)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)
    if mode == "seg":  # the maps vary: more than one class wins
        labels = got[0].argmax(-1).numpy()
        assert len(np.unique(labels[0, :SIZES[0][0], :SIZES[0][1]])) > 1
