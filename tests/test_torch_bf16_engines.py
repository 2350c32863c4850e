"""The port's three engines at ``compute_dtype=torch.bfloat16`` against
the JAX package's at ``compute_dtype=jnp.bfloat16`` (its models at
``dtype=jnp.bfloat16``), on the same weights and synthetic images: the CAM
engine (b1, two scales, the f32 fusion and the JAX bench's fast IO), the
seg engine (b1 dec, one BiFPN layer, labels), the IRN refiner (the edge
model in bf16, the walk in f32), and ``infer_irn --bf16 1`` on the
mini-VOC of test_torch_cli_irn.py."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from muscle_tpu.inference import CamTTAEngine as JCamEngine
from muscle_tpu.inference import RandomWalkRefiner as JRefiner
from muscle_tpu.inference import SegTTAEngine as JSegEngine
from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu_torch.cli import infer_irn
from muscle_tpu_torch.inference import CamTTAEngine, RandomWalkRefiner, SegTTAEngine
from test_torch_cam import models  # noqa: F401  (fixture)
from test_torch_cli_irn import SIZES as VOC_SIZES
from test_torch_cli_irn import _args, _refiner_outputs, mini_voc  # noqa: F401  (fixture)
from test_torch_irn import setup  # noqa: F401  (fixture)
from test_torch_irn_models import CROP
from test_torch_seg import SIZES as SEG_SIZES
from test_torch_seg import _images as seg_images
from test_torch_seg import models as seg_models  # noqa: F401  (fixture)

BF16 = torch.bfloat16
# CAM scores and fused raw-CAM maps, IRN scores: the JAX package's own bf16
# bound (its refiner at bf16 against f32, test_inference.py).  A random
# net's fused SGC maps are ill-conditioned: the PCM's affinities flatten
# the raw map, and the min-max normalisation divides by a range near 0
# (values down to -1283 here), so bf16 noise moves JAX's own SGC maps from
# its f32 ones by up to 0.42 in the mean.  An SGC map is held to the larger
# of MEAN_TOL and REL_TOL times that distance (measured: the port within
# 0.5-1.1 of it).
MEAN_TOL, REL_TOL = 0.02, 2.0
# seg labels: where JAX's f32 top-two margin exceeds MARGIN, the labels
# agree on at least LABEL_AGREE of the pixels
MARGIN, LABEL_AGREE = 1e-2, 0.99


# ---- CAM ------------------------------------------------------------------------

CAM_SIZES = [(120, 96), (96, 128)]  # stride-16 maps of 3 x 3 to 8 x 6


def cam_images(seed):
    """Colour ramps with noise (test_torch_cam.py's, at CAM_SIZES)."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in CAM_SIZES:
        mix = rng.uniform(-1.0, 1.0, size=(2, 3))
        yy = np.linspace(0, 1, h)[:, None, None]
        xx = np.linspace(0, 1, w)[None, :, None]
        base = 127.5 + 100 * (yy * mix[0] + xx * mix[1]) + rng.normal(0, 8, size=(h, w, 3))
        out.append(Image.fromarray(np.clip(base, 0, 255).astype(np.uint8)))
    return out


def cam_labels():
    labels = [np.zeros(20, np.float32) for _ in CAM_SIZES]
    labels[0][[2, 7]] = 1
    labels[1][[0, 11, 19]] = 1
    return labels


CAM_CASES = {
    "fast0": dict(scales=(0.5, 1.0)),
    # the JAX bench's CAM configuration (lowres, K-class, stride-4 grid,
    # uint8 download, tight 4:2:0 upload)
    "bench": dict(scales=(0.5, 1.0), max_classes=4, return_cam=False, accum_stride=4,
                  download_dtype="uint8", tight_upload=True, upload_mode="ycbcr420"),
}


@pytest.mark.parametrize("case", sorted(CAM_CASES))
def test_cam_engine_bf16_matches_jax(models, case):
    jm, v, port = models
    kw = dict(out_side=128, max_side=128, **CAM_CASES[case])
    j16 = JMuSCLe(backbone_name=jm.backbone_name, mode="enc", last_pooling=False,
                  dtype=jnp.bfloat16)
    imgs, labels, names = cam_images(3), cam_labels(), ["a", "b"]
    want = JCamEngine(j16, v, compute_dtype=jnp.bfloat16, **kw).run_batch(imgs, names, labels)
    want32 = JCamEngine(jm, v, **kw).run_batch(imgs, names, labels)
    got = CamTTAEngine(port(384), compute_dtype=BF16, device="cpu", **kw).run_batch(
        [np.asarray(i) for i in imgs], names, labels)
    f32 = CamTTAEngine(port(384), device="cpu", **kw).run_batch(
        [np.asarray(i) for i in imgs], names, labels)
    moved = 0.0
    for g, w, w32, f, (h, wd) in zip(got, want, want32, f32, CAM_SIZES):
        assert g["name"] == w["name"]
        assert np.abs(g["score"] - w["score"]).mean() <= MEAN_TOL
        for key in ("sgc", "cam"):
            if key not in w:
                assert key not in g
                continue
            assert sorted(g[key]) == sorted(w[key])
            for c in w[key]:
                a, b = (np.asarray(r[key][c], np.float32) for r in (g, w))
                assert g[key][c].dtype == w[key][c].dtype and a.shape == (h, wd)
                err = np.abs(a - b).mean()
                tol = MEAN_TOL
                if key == "sgc":
                    own = np.abs(b - np.asarray(w32[key][c], np.float32)).mean()
                    tol = max(MEAN_TOL, REL_TOL * own)
                assert err <= tol, (case, key, c, float(err), tol)
                moved = max(moved, float(np.abs(a - np.asarray(f[key][c], np.float32)).max()))
    assert moved > 0  # bf16 really ran: the maps moved from the f32 engine's


# ---- seg --------------------------------------------------------------------------

def test_seg_engine_bf16_labels_match_jax(seg_models):
    model, jm, v = seg_models
    kw = dict(scales=(0.5, 1.0), out_side=64, max_side=60, upload_mode="rgb",
              tight_upload=False)
    j16 = JMuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1,
                  dtype=jnp.bfloat16)
    imgs, names = seg_images(3), ["a", "b"]
    # JAX's f32 probabilities give the margin; the labels at bf16 on both sides
    probs32 = JSegEngine(jm, v, **kw).run_batch(imgs, names)
    want = JSegEngine(j16, v, compute_dtype=jnp.bfloat16, output="labels", **kw).run_batch(
        imgs, names)
    got = SegTTAEngine(model, compute_dtype=BF16, output="labels", device="cpu", **kw).run_batch(
        [np.asarray(i) for i in imgs], names)
    for g, w, p, (h, wd) in zip(got, want, probs32, SEG_SIZES):
        assert g["name"] == w["name"]
        assert g["label"].shape == (h, wd) and g["label"].dtype == np.uint8
        top2 = np.sort(p["probs"], axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > MARGIN
        assert clear.mean() > 0.5
        agree = (g["label"] == w["label"])[clear].mean()
        assert agree >= LABEL_AGREE, (g["name"], float(agree))
    assert len(np.unique(np.concatenate([g["label"].ravel() for g in got]))) > 1


# ---- IRN --------------------------------------------------------------------------

def test_refiner_bf16_matches_jax_and_its_f32(setup):
    jm, variables, model, imgs, dicts = setup
    want = JRefiner(jm, variables, crop_size=CROP, compute_dtype=jnp.bfloat16).refine_batch(
        imgs, dicts)
    got = RandomWalkRefiner(model, crop_size=CROP, compute_dtype=BF16,
                            device="cpu").refine_batch(imgs, dicts)
    f32 = RandomWalkRefiner(model, crop_size=CROP, device="cpu").refine_batch(imgs, dicts)
    for g, w, f in zip(got, want, f32):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g[..., 0], 0.35, atol=1e-6)
        assert np.abs(g - w).mean() < MEAN_TOL
        assert np.abs(g - f).mean() < MEAN_TOL
    assert max(float(np.abs(g - f).max()) for g, f in zip(got, f32)) > 0  # bf16 ran


def test_infer_irn_bf16_runs_on_mini_voc(mini_voc, tmp_path):
    root, names, sd = mini_voc
    out = tmp_path / "rw"
    infer_irn.main(_args(root, out, "--bf16", "1"))
    # the CLI's labels are the bf16 refiner's on the same batches
    _, want = _refiner_outputs(root, names, sd, fast_io=True, output="labels",
                               compute_dtype=BF16)
    for n, (h, w) in zip(names, VOC_SIZES):
        got = np.asarray(Image.open(out.parent / (out.name + "_png") / f"{n}.png"))
        assert got.shape == (h, w)
        np.testing.assert_array_equal(got, want[n])
