"""The port's CRFs against the JAX package's: the mean-field CRF
(muscle_tpu_torch/ops/crf.py) against muscle_tpu/ops/crf.py, and the native
permutohedral CRF through the port's own loader (ops/native_lib.py,
ops/exact_crf.py) against the JAX package's, on seeded 40 x 48 images."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from muscle_tpu.ops import exact_crf as JX
from muscle_tpu.ops.crf import mean_field_crf as j_mean_field_crf
from muscle_tpu_torch.ops import exact_crf as TX
from muscle_tpu_torch.ops import native_lib
from muscle_tpu_torch.ops.crf import mean_field_crf

# f32 on both sides; the grid's splat and blurs sum in different orders,
# and t softmax iterations carry the difference on
ATOL = 1e-4
H, W, L = 40, 48, 21


def _problem(seed: int):
    """Two colour regions with noise, and class probabilities that favour
    one class per region, salted with flipped pixels for the CRF to clean."""
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W, 3), np.uint8)
    img[:, : W // 2] = [200, 40, 40]
    img[:, W // 2:] = [40, 40, 200]
    img = np.clip(img.astype(int) + rng.integers(-15, 15, img.shape), 0, 255).astype(np.uint8)
    probs = rng.uniform(0.0, 0.05, (H, W, L)).astype(np.float32)
    probs[:, : W // 2, 1] += 0.5
    probs[:, W // 2:, 2] += 0.5
    flip = rng.random((H, W)) < 0.1
    probs[flip] = probs[flip][:, ::-1]
    probs /= probs.sum(-1, keepdims=True)
    return img, probs


@pytest.mark.parametrize("kw", [dict(t=4), dict(t=2, scale_factor=1.0, confidence=1.0,
                                                 sxy_gaussian=3.0, compat_gaussian=3.0,
                                                 sxy_bilateral=50.0, srgb=5.0)],
                         ids=["infer_seg", "label_params"])
def test_mean_field_crf_matches_jax(kw):
    img, probs = _problem(0)
    want = np.asarray(j_mean_field_crf(jnp.asarray(probs), jnp.asarray(img), **kw))
    got = mean_field_crf(torch.from_numpy(probs), torch.from_numpy(img), **kw)
    assert got.dtype == torch.float32 and got.shape == (H, W, L)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_native_crf_is_the_jax_packages_bit_for_bit():
    img, probs = _problem(1)
    p = probs.transpose(2, 0, 1)
    np.testing.assert_array_equal(TX.dense_crf(img, p, t=4), JX.dense_crf(img, p, t=4))
    np.testing.assert_array_equal(TX.dense_crf_seam(img, p, t=3), JX.dense_crf_seam(img, p, t=3))
    labels = probs.argmax(-1).astype(np.uint8)
    np.testing.assert_array_equal(TX.dense_crf_label(img, labels, t=5),
                                  JX.dense_crf_label(img, labels, t=5))
    # built under build/native, not into native/
    assert native_lib._target().parent == native_lib.BUILD_DIR
    assert native_lib._target().exists()
