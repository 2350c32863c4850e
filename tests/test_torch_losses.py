"""The port's CAM normalisers and training losses (muscle_tpu_torch/core,
losses, ops/exact_emd) against the JAX package's, value and gradient
(``jax.grad``) on the same numpy-seeded inputs.

Tolerance: 1e-5 relative (values, and gradients relative to their largest
entry), f32 summed in different orders; where a test states another, it
says why.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import muscle_tpu.core.cam_norm as jcn
import muscle_tpu.losses as jl
from muscle_tpu.ops.exact_emd import exact_emd as j_exact_emd
from muscle_tpu_torch.core import cam_norm as tcn
from muscle_tpu_torch import losses as tl
from muscle_tpu_torch.ops.exact_emd import exact_emd

RTOL = 1e-5


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _check(jfn, tfn, args, grad_argnums=(0,), rtol=RTOL):
    """Value and gradient of a scalar function of numpy ``args``, JAX vs
    the port."""
    jargs = [jnp.asarray(a) for a in args]
    want = jfn(*jargs)
    targs = [_t(a, i in grad_argnums) for i, a in enumerate(args)]
    got = tfn(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=1e-7)
    if not grad_argnums:
        return
    jg = jax.grad(lambda *xs: jnp.sum(jfn(*xs)), argnums=grad_argnums)(*jargs)
    got.sum().backward()
    for i, g in zip(grad_argnums, jg):
        g = np.asarray(g)
        scale = max(np.abs(g).max(), 1e-30)
        np.testing.assert_allclose(targs[i].grad.numpy(), g, atol=rtol * scale, rtol=0)


def _cams(seed, shape=(2, 8, 8, 21)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _labels(seed, n=4, c=20, p=0.2):
    lab = (np.random.default_rng(seed).random((n, c)) < p).astype(np.float32)
    lab[:, 0] = np.maximum(lab[:, 0], lab.sum(1) == 0)
    return lab


@pytest.mark.parametrize("name", ["cam_maxnorm", "cam_maxnorm_with_bg", "cam_softmaxnorm",
                                  "cam_softmaxnorm_relu", "gap2d", "gap2d_pos"])
def test_cam_normalisers_match_jax(name):
    x = _cams(1)
    if name == "cam_softmaxnorm_relu":
        _check(lambda a: jcn.cam_softmaxnorm(a, relu_first=True),
               lambda a: tcn.cam_softmaxnorm(a, relu_first=True), [x])
    else:
        _check(getattr(jcn, name), getattr(tcn, name), [x])


def test_attach_bg_channel_matches_jax():
    lab = _labels(0)
    for value in (1.0, 0.5):
        np.testing.assert_array_equal(tcn.attach_bg_channel(_t(lab), value).numpy(),
                                      np.asarray(jcn.attach_bg_channel(jnp.asarray(lab), value)))


def test_classification_losses_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(4, 20)).astype(np.float32) * 2
    lab = _labels(3)
    probs = 1 / (1 + np.exp(-logits))
    _check(jl.focal_loss, tl.focal_loss, [probs.astype(np.float32), lab])
    _check(jl.lsep_loss, tl.lsep_loss, [probs.astype(np.float32), lab])
    _check(jl.soft_margin_loss, tl.soft_margin_loss, [logits, lab])


@pytest.mark.parametrize("ties", [False, True])
def test_er_topk_loss_matches_jax(ties):
    """The 22-halving threshold search: the same threshold bit for bit, the
    same top-k mean and gradient; ``ties`` quantises the maps to 16 levels,
    so thousands of entries tie at the threshold."""
    rng = np.random.default_rng(4)
    cams = rng.random((2, 16, 16, 21)).astype(np.float32)
    sgcs = rng.random((2, 16, 16, 21)).astype(np.float32)
    if ties:
        cams, sgcs = np.round(cams * 16) / 16, np.round(sgcs * 16) / 16
    valid = np.asarray(3.0, np.float32)  # label sum over the whole batch

    def jfn(s):
        return jl.er_topk_loss(jnp.asarray(cams), s, jnp.asarray(valid))

    def tfn(s):
        return tl.er_topk_loss(_t(cams), s, _t(valid))

    _check(jfn, tfn, [sgcs])


@pytest.mark.parametrize("case", ["qualifying", "none_qualify"])
def test_image_level_contrast_matches_jax(case):
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(4, 16)).astype(np.float32)
    lab = np.zeros((4, 20), np.float32)
    if case == "qualifying":  # 0 ~ 1 equal; 2, 3 disjoint from them
        for i, c in enumerate((7, 7, 11, 14)):
            lab[i, c] = 1
    else:  # every pair overlaps without being equal: no positive, no negative
        lab[:, 3] = 1
        for i in range(4):
            lab[i, 10 + i] = 1
    want = float(jl.image_level_contrast(jnp.asarray(emb), jnp.asarray(lab)))
    assert (want > 0) == (case == "qualifying")
    _check(jl.image_level_contrast, tl.image_level_contrast, [emb, lab])


def test_info_nce_matches_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    pk = rng.normal(size=(3, 2, 8)).astype(np.float32)
    nk = rng.normal(size=(3, 5, 8)).astype(np.float32)
    _check(jl.info_nce, tl.info_nce, [q, pk, nk], grad_argnums=(0, 1, 2))


def _views(seed, n=3, hw=12, c=5):
    rng = np.random.default_rng(seed)
    fm1 = rng.random((n, hw, hw, c)).astype(np.float32)
    fm2 = rng.random((n, hw, hw, c)).astype(np.float32)
    coord1 = np.asarray([[0, 0, 12, 12], [3, 2, 9, 7], [5, 0, 7, 10]], np.int32)
    coord2 = np.asarray([[0, 0, 12, 12], [0, 4, 9, 7], [0, 1, 7, 10]], np.int32)
    return fm1, fm2, coord1, coord2


def test_pixpro_loss_matches_jax():
    _check(jl.pixpro_loss, tl.pixpro_loss, list(_views(7)))


def test_pixpro_loss_zero_pixel_gradient_is_finite():
    """A view-1 pixel that is zero in every channel: the port's gradient is
    finite (torch's norm backward is 0 at 0, as in the reference), where
    the JAX package's is NaN (its norm's gradient at 0 is 0 * inf)."""
    fm1, fm2, c1, c2 = _views(8)
    fm1[1, 4, 3] = 0.0  # inside sample 1's overlap window
    t = _t(fm1, True)
    tl.pixpro_loss(t, _t(fm2), _t(c1), _t(c2)).backward()
    assert torch.isfinite(t.grad).all()
    jg = jax.grad(jl.pixpro_loss)(jnp.asarray(fm1), jnp.asarray(fm2), jnp.asarray(c1),
                                  jnp.asarray(c2))
    assert np.isnan(np.asarray(jg)).any()


def test_sinkhorn_and_pair_helpers_match_jax():
    rng = np.random.default_rng(9)
    x = rng.random((6, 4)).astype(np.float32)
    y = rng.random((5, 4)).astype(np.float32)
    _check(jl.pairwise_cosine_cost, tl.pairwise_cosine_cost, [x, y], grad_argnums=(0, 1))
    _check(jl.crop_weight_vector, tl.crop_weight_vector, [x, y], grad_argnums=(0, 1))
    cost = rng.random((6, 5)).astype(np.float32)
    mu, nu = rng.random(6).astype(np.float32), rng.random(5).astype(np.float32)
    _check(jl.sinkhorn_emd, tl.sinkhorn_emd, [cost, mu, nu], grad_argnums=(0, 1, 2))


def _unit_maps(seed, n=4, hw=32, c=6):
    rng = np.random.default_rng(seed)
    m = rng.random((n, hw, hw, c)).astype(np.float32) + 0.05
    return m / np.linalg.norm(m, axis=-1, keepdims=True)


def test_static_matching_emd_matches_jax():
    vw1, vw2 = _unit_maps(10), _unit_maps(11)
    c1 = np.asarray([[0, 0, 20, 24], [4, 2, 28, 30], [3, 0, 12, 32], [0, 5, 32, 27]], np.int32)
    c2 = np.asarray([[12, 8, 20, 24], [0, 0, 28, 30], [0, 0, 12, 32], [0, 0, 32, 27]], np.int32)
    _check(jl.static_matching_emd, tl.static_matching_emd, [vw1, vw2, c1, c2])


def test_dynamic_matching_emd_matches_jax():
    """The JAX crop fractions (the uniform draws of each sample's key) fed
    in: the same crops, the same best pair, the same loss and gradient.
    Sample 2's overlap is 12 high: too small, it adds 0."""
    vw1, vw2 = _unit_maps(12), _unit_maps(13)
    c1 = np.asarray([[0, 0, 20, 24], [4, 2, 28, 30], [20, 0, 12, 32], [0, 5, 32, 27]], np.int32)
    c2 = np.asarray([[12, 8, 20, 24], [0, 0, 28, 30], [0, 0, 12, 32], [0, 0, 32, 27]], np.int32)
    key = jax.random.key(3)
    frac = np.asarray([[float(jax.random.uniform(k, (), minval=1 / 3, maxval=1 / 2))
                        for k in jax.random.split(kk)] for kk in jax.random.split(key, 4)],
                      np.float32)
    _check(lambda a, b, x, y: jl.dynamic_matching_emd(a, b, x, y, key),
           lambda a, b, x, y: tl.dynamic_matching_emd(a, b, x, y, crop_frac=_t(frac)),
           [vw1, vw2, c1, c2])
    # drawn from a generator: in [1/3, 1/2), and seeded
    f1 = tl.draw_crop_fractions(1000, torch.Generator().manual_seed(0))
    f2 = tl.draw_crop_fractions(1000, torch.Generator().manual_seed(0))
    assert torch.equal(f1, f2) and f1.min() >= 1 / 3 and f1.max() < 1 / 2


def test_exact_emd_matches_jax():
    """The native transportation simplex through each package's loader:
    cost and flow."""
    rng = np.random.default_rng(14)
    cost = rng.random((7, 5)).astype(np.float32)
    w1, w2 = rng.random(7).astype(np.float32), rng.random(5).astype(np.float32)
    got, flow = exact_emd(cost, w1, w2, return_flow=True)
    want, jflow = j_exact_emd(cost, w1, w2, return_flow=True)
    assert got == pytest.approx(want, rel=1e-6)
    np.testing.assert_allclose(flow, jflow, atol=1e-6)
    with pytest.raises(ValueError, match="do not match"):
        exact_emd(cost, w2, w1)
