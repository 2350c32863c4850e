"""The port's BiFPN pieces (muscle_tpu_torch/core/resize.py pooling helpers,
muscle_tpu_torch/models/bifpn.py) against the JAX package's, on the same
seeded inputs and weights (b1 pyramid widths, one or two BiFPN layers,
small grids)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import muscle_tpu.core.resize as JR
from muscle_tpu.models.bifpn import BiFPN as JBiFPN
import muscle_tpu_torch.core.resize as TR
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.models.bifpn import BiFPN

# pooling weights are exact (thirds); pooled maps are f32 contractions
POOL_ATOL = 1e-6
# the BiFPN: f32 on both sides, ~10 chained 1x1 convs and resizes summed in
# different orders (the port's model bounds, test_torch_models.py)
ATOL, RTOL = 1e-4, 1e-4
P_CHANNELS = (40, 80, 112, 192, 320)  # b1 p3..p7


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_avgpool3s2_weights_match_jax():
    src = np.array([17, 16, 1, 9], np.int32)
    off = np.array([0, 3, 5, 1], np.int32)
    want = jax.vmap(lambda s, o: JR.dynamic_avgpool3s2_weights(s, 24, 12, src_off=o))(
        jnp.asarray(src), jnp.asarray(off))
    got = TR.dynamic_avgpool3s2_weights(_t(src), 24, 12, src_off=_t(off))
    np.testing.assert_allclose(got.numpy(), want, atol=POOL_ATOL)
    one = TR.dynamic_avgpool3s2_weights(_t(src[0]), 24, 12)
    np.testing.assert_allclose(one.numpy(), JR.dynamic_avgpool3s2_weights(
        jnp.asarray(src[0]), 24, 12), atol=POOL_ATOL)


def test_batched_window_avgpool_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(3, 15, 22, 4)).astype(np.float32)
    win = np.array([[0, 0, 15, 22], [0, 0, 9, 13], [2, 1, 11, 20]], np.int32)
    want, want_win = JR.batched_window_avgpool_s2(jnp.asarray(src), jnp.asarray(win), (8, 11))
    got, got_win = TR.batched_window_avgpool_s2(_t(src), _t(win), (8, 11))
    np.testing.assert_allclose(got.numpy(), want, atol=POOL_ATOL)
    np.testing.assert_array_equal(got_win.numpy(), want_win)


@pytest.mark.parametrize("hw", [(16, 16), (15, 22), (1, 5)])
def test_avg_pool_3x3_s2_matches_jax(hw):
    x = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    want = JR.avg_pool_3x3_s2(jnp.asarray(x))
    got = TR.avg_pool_3x3_s2(_t(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=POOL_ATOL)


def _randomize_bn(params, stats, rng):
    """Batch norms near the identity with random scale, shift and
    statistics."""
    for k, sub in params.items():
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


@pytest.fixture(scope="module")
def models():
    """A JAX BiFPN with two layers (random biases, so the mids' swish(bias)
    outside the windows is non-zero) and the port's copy."""
    jb = JBiFPN(channels=32, num_layers=2)
    v = _plain(jb.init({"params": jax.random.key(0)}, [jnp.asarray(f) for f in _feats(0)]))
    rng = np.random.default_rng(0)
    _randomize_bn(v["params"], v["batch_stats"], rng)

    def walk(tree):
        for k, sub in tree.items():
            if k == "bias" and not isinstance(sub, dict):
                tree[k] = rng.uniform(-0.3, 0.3, sub.shape).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub)

    walk(v["params"])
    sd = state_dict_from_jax({"params": {"BIFPN": v["params"]},
                              "batch_stats": {"BIFPN": v["batch_stats"]}})
    tb = BiFPN(P_CHANNELS, channels=32, num_layers=2)
    own = {k for k in tb.state_dict() if "num_batches_tracked" not in k}
    assert {k.removeprefix("BIFPN.") for k in sd} == own
    tb.load_state_dict({k.removeprefix("BIFPN."): t for k, t in sd.items()}, strict=False)
    return jb, v, tb.eval()


# levels p3..p7 of a 128 x 96 canvas (strides 8, 16, 16, 32, 32)
LEVEL_HW = ((16, 12), (8, 6), (8, 6), (4, 3), (4, 3))


def _feats(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, h, w, c)).astype(np.float32)
            for (h, w), c in zip(LEVEL_HW, P_CHANNELS)]


@pytest.mark.parametrize("windowed", [False, True])
def test_bifpn_matches_jax(models, windowed):
    jb, v, tb = models
    feats = _feats(2)
    windows = None
    if windowed:
        # images of 100 x 70 and 61 x 96 on the canvas, through the ladder
        sizes = np.array([[100, 70], [61, 96]], np.int32)
        windows, w = [], np.concatenate([np.zeros_like(sizes), sizes], axis=-1)
        for stride in (8, 16, 16, 32, 32):
            windows.append(w // stride)
        for f, wn in zip(feats, windows):  # zero outside the windows, as the backbone leaves it
            for i in range(2):
                f[i, wn[i, 2]:] = 0.0
                f[i, :, wn[i, 3]:] = 0.0

    want = jax.jit(jb.apply)(v, [jnp.asarray(f) for f in feats],
                             windows=None if windows is None else [jnp.asarray(w) for w in windows])
    with torch.inference_mode():
        got = tb([_t(f) for f in feats],
                 windows=None if windows is None else [_t(w) for w in windows])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    if windowed:  # outputs are zero outside their windows
        for g, wn in zip(got, windows):
            assert not g[1, wn[1, 2]:].any() and not g[1, :, wn[1, 3]:].any()
