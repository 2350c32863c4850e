"""The port's RandomWalkRefiner (muscle_tpu_torch.inference.irn) against
the JAX package's on the same weights, images and CAM dicts (crop 64, the
JAX package's own refiner test inputs), on the CPU."""

import numpy as np
import pytest
import torch
from PIL import Image

from muscle_tpu.inference import RandomWalkRefiner as JRefiner
from muscle_tpu_torch.inference import RandomWalkRefiner
from test_torch_irn_models import CROP, make_irn, port_model

# parity path: f32 on both sides, the walk's summation order only (the
# 64-step walk and the /max amplify it to ~6e-5)
PARITY_ATOL = 1e-4
# fast IO scores: both sides download the walk output in float16
FAST_ATOL = 2e-3
# fast IO labels: argmax ties at class boundaries only
LABEL_AGREE = 0.99


def _imgs(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) for h, w in sizes]


@pytest.fixture(scope="module")
def setup():
    jm, variables, sd = make_irn()
    imgs = _imgs([(50, 44)]) + _imgs([(44, 50)], seed=4)
    rng = np.random.default_rng(0)
    dicts = [{3: rng.uniform(0, 1, (50, 44)).astype(np.float16)},
             {5: rng.uniform(0, 1, (44, 50)).astype(np.float16),
              7: rng.uniform(0, 1, (44, 50)).astype(np.float16)}]
    return jm, variables, port_model(sd), imgs, dicts


def _pair_up(setup, **kw):
    jm, variables, model, _, _ = setup
    jkw = dict(kw)
    if jkw.get("walk_method") == "banded":
        jkw["walk_method"] = "banded_interpret"  # the Pallas kernel in interpret mode
    return (JRefiner(jm, variables, crop_size=CROP, **jkw),
            RandomWalkRefiner(model, crop_size=CROP, device="cpu", **kw))


@pytest.mark.parametrize("walk", ["stencil", "vector", "banded"])
def test_parity_path_matches_jax(setup, walk):
    _, _, _, imgs, dicts = setup
    jr, pr = _pair_up(setup, walk_method=walk)
    want = jr.refine_batch(imgs, dicts)
    got = pr.refine_batch(imgs, dicts)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=PARITY_ATOL)
    if walk == "stencil":
        single = pr.refine_image(imgs[0], dicts[0])
        np.testing.assert_allclose(single, jr.refine_image(imgs[0], dicts[0]), atol=PARITY_ATOL)
        np.testing.assert_allclose(single, got[0], atol=1e-5)


def test_fast_scores_match_jax(setup):
    _, _, _, imgs, dicts = setup
    jr, pr = _pair_up(setup, fast_io=True)
    for g, w in zip(pr.refine_batch(imgs, dicts), jr.refine_batch(imgs, dicts)):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=FAST_ATOL)


def test_fast_labels_match_jax(setup):
    _, _, _, imgs, dicts = setup
    jr, pr = _pair_up(setup, fast_io=True, output="labels")
    for g, w, img in zip(pr.refine_batch(imgs, dicts), jr.refine_batch(imgs, dicts), imgs):
        wd, ht = img.size
        assert g.shape == (ht, wd) and g.dtype == np.uint8
        assert float((g == w).mean()) >= LABEL_AGREE
        assert pr.to_png_labels(g) is g


def test_refiner_output_contract(setup):
    jm, variables, model, imgs, dicts = setup
    pr = RandomWalkRefiner(model, crop_size=512, device="cpu")
    jr = JRefiner(jm, variables, crop_size=512)
    for h, w in [(50, 44), (130, 90), (375, 500), (500, 375), (257, 128)]:
        assert pr._crop_for(h, w) == jr._crop_for(h, w)
    pr = RandomWalkRefiner(model, crop_size=CROP, device="cpu")
    scores = pr.refine_image(imgs[1], dicts[1])
    assert scores.shape == (44, 50, 21) and scores.dtype == np.float32
    np.testing.assert_allclose(scores[..., 0], 0.35, atol=1e-6)
    for cls in range(20):  # only the labelled classes carry mass
        assert (scores[..., 1 + cls].max() > 0) == (cls in dicts[1])
    assert np.isfinite(scores).all() and 0 <= scores.min() and scores[..., 1:].max() <= 1 + 1e-6
    assert set(np.unique(pr.to_png_labels(scores))) <= {0, 6, 8}


def test_refiner_rejects_unsupported_options(setup):
    _, _, model, _, _ = setup
    # bf16 edge compute is served (test_torch_bf16_engines.py); any other
    # compute dtype still raises
    assert RandomWalkRefiner(model, device="cpu",
                             compute_dtype=torch.bfloat16).compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        RandomWalkRefiner(model, device="cpu", compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="fast_io"):
        RandomWalkRefiner(model, device="cpu", output="labels")
    with pytest.raises(ValueError, match="output"):
        RandomWalkRefiner(model, device="cpu", fast_io=True, output="probs")
