"""The port's Sobel machinery, BEACON field loss and its support functions
(muscle_tpu_torch/core/sobel.py, losses/beacon.py, losses/edge_support.py)
against the JAX package's on the same numpy-seeded inputs.

Tolerances: orientation bins exact (including angles a few ulp either side
of every 3.1416/8 edge and on the +-pi seam); Sobel fields and magnitudes
1e-5 (f32 convolution, summation order only); field_loss 1e-5 with JAX's
own draws fed in, and its gradient with respect to dense_ft 1e-5 of the
largest (seg_map and mask reach the loss only through stop-gradients, so
their gradients are 0 on both sides); edge_support 1e-5; the
straight-through argmax's gradient exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from muscle_tpu.core import sobel as jsobel
from muscle_tpu.losses import beacon as jbeacon
from muscle_tpu.losses import edge_support as jes
from muscle_tpu_torch.core import sobel
from muscle_tpu_torch.losses import beacon
from muscle_tpu_torch.losses import edge_support as es

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("orient", [True, False])
def test_sobel_edges_match_jax(size, orient):
    x = np.random.default_rng(size).normal(size=(2, 17, 23, 1)).astype(np.float32)
    np.testing.assert_array_equal(sobel.sobel_kernel(size), jsobel.sobel_kernel(size))
    got = sobel.sobel_edges(_t(x), size, orient).numpy()
    want = np.asarray(jsobel.sobel_edges(jnp.asarray(x), size, orient))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _edge_angles():
    """f32 angles at and 1-3 ulp either side of every k * 3.1416 / 8 edge
    (k = -8..8), and random ones."""
    div = 3.1416 / 8
    angles = []
    for k in range(-8, 9):
        a = np.float32(k * div)
        for step in range(-3, 4):
            angles.append(np.float32(a + step * np.spacing(a if a != 0 else np.float32(1e-7))))
    rand = np.random.default_rng(0).uniform(-np.pi, np.pi, 200).astype(np.float32)
    return np.concatenate([np.asarray(angles, np.float32), rand])


def test_orient_bins_exact_at_edges_and_seam():
    """The binning of an angle, exact against JAX's: JAX's own f32
    atan2 values of points at and a few ulp either side of every edge, on
    the +-pi seam (gy = +-0 with gx < 0) and the axes, binned by the port,
    give JAX's bins."""
    angles = _edge_angles()
    r = np.random.default_rng(1).uniform(0.5, 20, angles.shape).astype(np.float32)
    gx = (r * np.cos(angles.astype(np.float64))).astype(np.float32)
    gy = (r * np.sin(angles.astype(np.float64))).astype(np.float32)
    gx = np.concatenate([gx, np.float32([-1, -1, -3, 2, 0, 0, 1e-9])])
    gy = np.concatenate([gy, np.float32([0.0, -0.0, 0.0, 0, 2, -2, 0])])
    jmag, jbins = jsobel.orient_quantize_xy(jnp.asarray(gx), jnp.asarray(gy))
    jtheta = np.asarray(jnp.arctan2(gy, gx))
    np.testing.assert_array_equal(sobel.orient_bins(_t(jtheta)).numpy(), np.asarray(jbins))
    assert set(np.asarray(jbins).tolist()) == set(range(8))
    n = len(angles)
    assert np.asarray(jbins)[n:n + 3].tolist() == [3, 3, 3]  # +pi, -pi, +pi: the seam
    mag = sobel.orient_quantize(_t(np.stack([gx, gy], -1)))[0]
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), rtol=1e-6)


def test_orient_quantize_differs_only_within_atan2_rounding_of_an_edge():
    """End to end from (gx, gy): torch's f32 atan2 and XLA's differ by up
    to 2 ulp (neither is correctly rounded), so a bin can differ from
    JAX's only where the two angles straddle an edge.  Every differing bin
    is such a point, and no other bin differs."""
    angles = _edge_angles()
    r = np.random.default_rng(2).uniform(0.5, 20, angles.shape).astype(np.float32)
    gx = (r * np.cos(angles.astype(np.float64))).astype(np.float32)
    gy = (r * np.sin(angles.astype(np.float64))).astype(np.float32)
    theta = torch.atan2(_t(gy), _t(gx)).numpy()
    jtheta = np.asarray(jnp.arctan2(gy, gx))
    assert np.abs(theta.astype(np.float64) - jtheta).max() <= 2 * np.spacing(np.float32(np.pi))
    bins = sobel.orient_quantize_xy(_t(gx), _t(gy))[1].numpy()
    jbins = np.asarray(jsobel.orient_quantize_xy(jnp.asarray(gx), jnp.asarray(gy))[1])
    edges = np.float32([k * (3.1416 / 8) for k in range(-8, 9)])
    lo, hi = np.minimum(theta, jtheta), np.maximum(theta, jtheta)
    straddles = ((lo[:, None] < edges[None]) & (edges[None] <= hi[:, None])).any(axis=1)
    assert np.all(straddles[bins != jbins])
    np.testing.assert_array_equal(bins[~straddles], jbins[~straddles])


def _problem(n=2, h=40, w=44, c=21, f=24, seed=0):
    """Seg logits with one sharp square and one disc of two classes an
    image (plus noise), dense features, a soft mask and labels; image 1
    also carries a labelled class that is absent from its map."""
    rng = np.random.default_rng(seed)
    seg = rng.normal(0, 0.5, (n, h, w, c)).astype(np.float32)
    seg[..., 0] += 5.0
    yy, xx = np.mgrid[:h, :w]
    label = np.zeros((n, c), np.float32)
    label[:, 0] = 1
    for i in range(n):
        a, b = 1 + 3 * i, 2 + 5 * i
        sq = (yy >= 8 + i) & (yy < 30) & (xx >= 6) & (xx < 26 + i)
        disc = (yy - 22) ** 2 + (xx - 30 - i) ** 2 < 81
        seg[i][sq, a] += 12.0
        seg[i][disc & ~sq, b] += 12.0
        label[i, a] = label[i, b] = 1
    label[1, 17] = 1
    dense = rng.normal(size=(n, h, w, f)).astype(np.float32)
    mask = np.asarray(jax.nn.softmax(jnp.asarray(seg), axis=-1)) * 4.0
    return seg, dense, mask, label


def _jax_draws(key, n, nfg, h, w):
    keys = jax.random.split(key, n * nfg)
    return np.stack([np.asarray(jax.random.uniform(k, (h, w))) for k in keys]).reshape(
        n, nfg, h, w)


def test_class_edges_match_jax():
    seg, _, _, label = _problem()
    cfg = beacon.FieldLossConfig()
    gx, gy = beacon._class_edges(_t(seg), _t(label), cfg)
    jgx, jgy = jbeacon._class_edges(jnp.asarray(seg), jnp.asarray(label), jbeacon.FieldLossConfig())
    for got, want in ((gx, jgx), (gy, jgy)):
        want = np.moveaxis(np.asarray(want), -1, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
        assert np.abs(want).max() > 1.0
    assert np.all(gx.numpy()[:, [i for i in range(20) if label[0, i + 1] == 0 and
                                 label[1, i + 1] == 0]] == 0)


@pytest.mark.parametrize("k,engaged", [(16, True), (1000, False)])
def test_field_loss_value_and_gradients_match_jax(k, engaged):
    """Engaged (k 16: every labelled class present has more than k valid
    boundary pixels) and not engaged (k 1000, above every class's count:
    0 and no gradient), with JAX's own draws: loss, magnitude map, and the
    gradients with respect to dense_ft, seg_map and mask."""
    seg, dense, mask, label = _problem()
    n, h, w, c = seg.shape
    jcfg = jbeacon.FieldLossConfig(k=k, step=3)
    key = jax.random.key(3)

    def jloss(s, d, m):
        return jbeacon.field_loss(s, d, m, jnp.asarray(label), key, jcfg)[0]

    jval, jmag = jbeacon.field_loss(jnp.asarray(seg), jnp.asarray(dense), jnp.asarray(mask),
                                    jnp.asarray(label), key, jcfg)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(seg), jnp.asarray(dense),
                                               jnp.asarray(mask))
    draws = _t(_jax_draws(key, n, c - 1, h, w))
    s, d, m = (_t(a).clone().requires_grad_(True) for a in (seg, dense, mask))
    val, mag = beacon.field_loss(s, d, m, _t(label), beacon.FieldLossConfig(k=k, step=3),
                                 draws=draws)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), atol=1e-4, rtol=TOL)
    jg = np.asarray(jgrads[1])
    if engaged:
        assert float(jval) != 0.0 and np.abs(jg).max() > 0
        np.testing.assert_allclose(d.grad.numpy(), jg, atol=TOL * np.abs(jg).max(), rtol=0)
    else:
        assert float(val.detach()) == 0.0 and float(jval) == 0.0
        assert not d.grad.any() and not np.any(jg)
    for got, want in ((s.grad, jgrads[0]), (m.grad, jgrads[2])):
        assert got is None and not np.any(np.asarray(want))  # no path to the loss


def test_boundary_counts_straddle_the_two_ks():
    """The problem above engages k 16 and not k 1000: some class has more
    than 16 valid boundary pixels, none more than 1000."""
    seg, _, _, label = _problem()
    n, h, w, c = seg.shape
    draws = torch.rand((n, c - 1, h, w), generator=torch.Generator().manual_seed(0))
    _, _, _, count, _ = beacon.boundary_samples(_t(seg), _t(label),
                                                beacon.FieldLossConfig(k=16, step=3), draws)
    assert 16 < int(count.max()) <= 1000
    assert int((count > 16).sum()) >= 3


def test_field_loss_draws_from_generator():
    """Without draws: seeded by the generator (same seed, same loss), and a
    differentiable graph to dense_ft."""
    seg, dense, mask, label = _problem()
    cfg = beacon.FieldLossConfig(k=16, step=3)
    vals = []
    for _ in range(2):
        d = _t(dense).clone().requires_grad_(True)
        val, _ = beacon.field_loss(_t(seg), d, _t(mask), _t(label), cfg,
                                   generator=torch.Generator().manual_seed(0))
        val.backward()
        assert torch.isfinite(d.grad).all() and d.grad.abs().max() > 0
        vals.append(float(val))
    assert vals[0] == vals[1] != 0.0


def test_pair_loss_matches_jax_vmapped():
    """The batched FP/FN/TP/TN push-pull against JAX's per-pair one over 6
    random (k, k) pairs, both marginals."""
    rng = np.random.default_rng(5)
    sim = rng.uniform(0, 1, (6, 12, 12)).astype(np.float32)
    sm = rng.uniform(0, 1, (6, 12, 12)).astype(np.float32)
    for axis in (0, 1):
        want = jax.vmap(lambda a, b: jbeacon._pair_loss(a, b, axis))(jnp.asarray(sim),
                                                                     jnp.asarray(sm))
        got = beacon._pair_loss(_t(sim), _t(sm), axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("ksize", [3, 5])
def test_box_filter_matches_jax(ksize):
    x = np.random.default_rng(ksize).normal(size=(2, 9, 11, 1)).astype(np.float32)
    np.testing.assert_allclose(es.box_filter(_t(x), ksize).numpy(),
                               np.asarray(jes.box_filter(jnp.asarray(x), ksize)), atol=TOL)


def test_grayscale_edge_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 20, 24, 3)).astype(np.float32)
    got = es.grayscale_edge(_t(x)).numpy()
    want = np.asarray(jes.grayscale_edge(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 20, 24, 1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=1e-4)


def test_unit_vectors_and_field_masks_match_jax():
    orient = np.random.default_rng(0).integers(0, 8, (3, 5))
    np.testing.assert_array_equal(es.unit_vectors(_t(orient)).numpy(),
                                  np.asarray(jes.unit_vectors(jnp.asarray(orient))))
    for got, want in zip(es.field_masks(_t(orient)), jes.field_masks(jnp.asarray(orient))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_straight_through_argmax_gradient_matches_custom_vjp():
    x = np.random.default_rng(0).normal(size=(4, 6, 7)).astype(np.float32)
    up = np.random.default_rng(1).normal(size=(4, 6)).astype(np.float32)
    want_val = np.asarray(jes.straight_through_argmax(jnp.asarray(x)))
    want_grad = jax.grad(lambda a: jnp.sum(jes.straight_through_argmax(a) * up))(jnp.asarray(x))
    xt = _t(x).clone().requires_grad_(True)
    val = es.straight_through_argmax(xt)
    (val * _t(up)).sum().backward()
    np.testing.assert_array_equal(val.detach().numpy(), want_val)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_grad))
