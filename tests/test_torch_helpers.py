"""The port's last public helpers against the JAX package's functions of
the same names on seeded numpy inputs: ``utils.metrics.topk_accuracy``,
``models.blocks.SELayer`` / ``SeparableConvBlock`` (weights carried across
from Flax variables), ``data.voc12.SBDImageDataset``,
``data.transforms.rot90_with_mask``, ``cli.common.save_score_dict``,
``ops.random_walk.affinity_to_dense`` / ``to_transition_matrix`` and
``utils.train_vis.denorm_uint8``.

Tolerances: the numpy and walk helpers 1e-6 (the transition matrix 1e-6
more for each squaring), the blocks 1e-5 (the same float32 products
summed in another order); the rest exact."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from muscle_tpu.cli.common import save_score_dict as j_save_score_dict
from muscle_tpu.data.transforms import rot90_with_mask as j_rot90
from muscle_tpu.data.voc12 import SBDImageDataset as JSBD
from muscle_tpu.models.blocks import SELayer as JSELayer
from muscle_tpu.models.blocks import SeparableConvBlock as JSeparable
from muscle_tpu.ops import random_walk as J
from muscle_tpu.utils.metrics import topk_accuracy as j_topk
from muscle_tpu.utils.train_vis import denorm_uint8 as j_denorm
from muscle_tpu_torch.cli.common import save_score_dict
from muscle_tpu_torch.data.transforms import rot90_with_mask
from muscle_tpu_torch.data.voc12 import SBDImageDataset
from muscle_tpu_torch.models.blocks import SELayer, SeparableConvBlock
from muscle_tpu_torch.ops import random_walk as P
from muscle_tpu_torch.utils import topk_accuracy
from muscle_tpu_torch.utils.train_vis import denorm_uint8

TOL, BLOCK_TOL = 1e-6, 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("topk", [(1, 2), (1, 5)])
def test_topk_accuracy_matches_jax(topk):
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(32, 20)).astype(np.float32)
    target = (rng.uniform(size=(32, 20)) < 0.15).astype(np.float32)
    got, want = topk_accuracy(scores, target, topk), j_topk(scores, target, topk)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert 0.0 < got[1] < 1.0


def test_rot90_with_mask_matches_jax():
    """Twenty seeds, which take every branch (p < 1/8, p > 7/8, neither)."""
    rng = np.random.default_rng(1)
    arr = rng.uniform(size=(6, 9, 3)).astype(np.float32)
    mask = rng.integers(0, 21, size=(6, 9)).astype(np.uint8)
    shapes = set()
    for seed in range(20):
        a, m = rot90_with_mask(arr, mask, np.random.default_rng(seed))
        ja, jm = j_rot90(arr, mask, np.random.default_rng(seed))
        np.testing.assert_allclose(a, ja, atol=TOL)
        np.testing.assert_array_equal(m, jm)
        shapes.add((a.shape, bool(np.array_equal(a, arr))))
    assert shapes == {((9, 6, 3), False), ((6, 9, 3), True)}


def test_affinity_to_dense_and_transition_match_jax():
    h, w, radius = 13, 18, 5
    hp, wp = h + radius, w + 2 * radius
    pi, jpi = P.PathIndex(radius, (hp, wp)), J.PathIndex(radius, (hp, wp))
    edge = np.random.default_rng(2).uniform(0, 1, size=(h, w)).astype(np.float32)
    edge_pad = np.pad(edge, ((0, radius), (radius, radius)), constant_values=1.0).reshape(-1)
    aff = P.edge_to_affinity(_t(edge_pad), pi)
    dense = P.affinity_to_dense(aff, pi)
    jdense = J.affinity_to_dense(J.edge_to_affinity(jnp.asarray(edge_pad), jpi), jpi)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), atol=TOL)
    np.testing.assert_array_equal(dense.numpy(), dense.numpy().T)
    # the transition on the image's vertices (the padded ones have no
    # affinity): beta 8, and squared twice; each squaring is a float32
    # product of 234-term sums in another order, 1e-6 more apart each
    keep = (np.arange(h)[:, None] * wp + radius + np.arange(w)[None, :]).reshape(-1)
    sub = dense[keep][:, keep]
    for times in (0, 2):
        got = P.to_transition_matrix(sub, 8, times)
        want = J.to_transition_matrix(jnp.asarray(sub.numpy()), 8, times)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL * (1 + times))


@pytest.mark.parametrize("reduction", [2, 4])
def test_se_layer_matches_flax(reduction):
    x = np.random.default_rng(3).normal(size=(2, 5, 7, 16)).astype(np.float32)
    jm = JSELayer(reduction=reduction)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    p = v["params"]
    mine = SELayer(16, reduction)
    mine.load_state_dict({"fc.0.weight": _t(p["fc1"]["kernel"]).t(),
                          "fc.2.weight": _t(p["fc2"]["kernel"]).t()})
    with torch.no_grad():
        got = mine(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=BLOCK_TOL)


@pytest.mark.parametrize("features,norm,activation", [(None, True, False), (24, True, True),
                                                      (24, False, True)])
def test_separable_conv_block_matches_flax(features, norm, activation):
    """Eval mode: the batch norm on random running statistics."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 11, 16)).astype(np.float32)
    jm = JSeparable(features=features, norm=norm, activation=activation)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, v)
    sd = {"depthwise_conv.weight": _t(v["params"]["depthwise"]["kernel"]).permute(3, 2, 0, 1),
          "pointwise_conv.weight": _t(v["params"]["pointwise"]["kernel"]).permute(3, 2, 0, 1),
          "pointwise_conv.bias": _t(rng.normal(size=v["params"]["pointwise"]["bias"].shape))}
    v["params"]["pointwise"]["bias"] = sd["pointwise_conv.bias"].numpy()
    if norm:
        out = features or 16
        stats = {"scale": rng.uniform(0.5, 1.5, out), "bias": rng.normal(size=out),
                 "mean": rng.normal(size=out), "var": rng.uniform(0.5, 2.0, out)}
        stats = {k: s.astype(np.float32) for k, s in stats.items()}
        v["params"]["bn"] = {"scale": stats["scale"], "bias": stats["bias"]}
        v["batch_stats"] = {"bn": {"mean": stats["mean"], "var": stats["var"]}}
        sd.update({"bn.weight": _t(stats["scale"]), "bn.bias": _t(stats["bias"]),
                   "bn.running_mean": _t(stats["mean"]), "bn.running_var": _t(stats["var"])})
    mine = SeparableConvBlock(16, features, norm=norm, activation=activation)
    mine.load_state_dict(sd, strict=False)
    assert set(mine.state_dict()) - set(sd) <= {"bn.num_batches_tracked"}
    with torch.no_grad():
        got = mine.eval()(_t(x)).numpy()
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 9, 11, features or 16)
    np.testing.assert_allclose(got, want, atol=BLOCK_TOL)


def test_sbd_image_dataset_matches_jax(tmp_path):
    """tests/test_data.py's SBD case: a name with subdirectories, unit 1
    and 8 (round(101 / 8) * 8, round(67 / 8) * 8 = 104 x 64)."""
    d = tmp_path / "img" / "benchmark"
    d.mkdir(parents=True)
    Image.new("RGB", (101, 67), (30, 60, 90)).save(d / "a_0001.jpg")
    names = ["img/benchmark/a_0001"]
    for unit, size in ((1, (101, 67)), (8, (104, 64))):
        mine, want = SBDImageDataset(names, str(tmp_path), unit), JSBD(names, str(tmp_path), unit)
        assert len(mine) == len(want) == 1
        assert mine.image(0).size == size
        np.testing.assert_array_equal(np.asarray(mine.image(0)), np.asarray(want.image(0)))


def test_save_score_dict_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    d = {3: rng.uniform(size=(7, 9)).astype(np.float16),
         11: rng.uniform(size=(7, 9)).astype(np.float16)}
    save_score_dict(str(tmp_path / "mine.npy"), d)
    j_save_score_dict(str(tmp_path / "jax.npy"), d)
    for name in ("mine.npy", "jax.npy"):
        back = np.load(tmp_path / name, allow_pickle=True).item()
        assert sorted(back) == [3, 11]
        for k, v in d.items():
            assert back[k].dtype == np.float16
            np.testing.assert_array_equal(back[k], v)


def test_denorm_uint8_matches_jax_exactly():
    x = np.random.default_rng(6).normal(size=(12, 10, 3)).astype(np.float32) * 1.5
    got, want = denorm_uint8(x), j_denorm(x)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == 255  # the clip engaged at both ends

