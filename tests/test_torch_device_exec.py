"""``bench_device_exec`` of the three engines (the JAX engines' device-only
executor): the closure's buffer, unpacked as ``run_batch`` /
``refine_batch`` unpack the download, equals what they return for the
same batch, bit for bit on the CPU, on two calls of the closure; the host
prep runs once, when the closure is made; and the JAX engines' assert
conditions raise.  The CAM engine at b1 (test_torch_cam.py's weights),
the seg engine at b1 dec (test_torch_seg.py's), the refiner at
test_torch_irn.py's test model."""

import numpy as np
import pytest
import torch

from muscle_tpu_torch.inference import CamTTAEngine, RandomWalkRefiner, SegTTAEngine
from test_torch_cam import _images as cam_images
from test_torch_cam import _labels as cam_labels
from test_torch_cam import models  # noqa: F401  (fixture)
from test_torch_irn import _imgs as irn_images
from test_torch_irn import setup  # noqa: F401  (fixture)
from test_torch_irn_models import CROP
from test_torch_seg import BASE as SEG_BASE
from test_torch_seg import _images as seg_images
from test_torch_seg import models as seg_models  # noqa: F401  (fixture)


def _counting(obj, name: str) -> list:
    """Replace ``obj.name`` by a wrapper that records each call; returns
    the record."""
    calls, fn = [], getattr(obj, name)

    def wrapped(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    setattr(obj, name, wrapped)
    return calls


def _two_calls(run) -> list:
    """Two calls of an executor: device buffers, on the CPU here."""
    bufs = [run(), run()]
    for b in bufs:
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
    return [b.numpy() for b in bufs]


CAM_CASES = {
    "fast0": dict(scales=(0.5, 1.0), out_side=64, max_side=56),
    "fast1": dict(scales=(0.5, 1.0), out_side=64, max_side=56, accum_stride=4,
                  download_dtype="uint8", tight_upload=True, upload_mode="ycbcr420",
                  return_cam=False),
}


@pytest.mark.parametrize("case", sorted(CAM_CASES))
def test_cam_bench_device_exec_equals_run_batch(models, case):  # noqa: F811
    _, _, port = models
    engine = CamTTAEngine(port(384), device="cpu", **CAM_CASES[case])
    imgs, labels = [np.asarray(i) for i in cam_images(1)], cam_labels()
    names = [f"i{i}" for i in range(len(imgs))]
    want = engine.run_batch(imgs, names, labels)
    prep = engine._host_prep(imgs, names, labels)
    calls = _counting(engine, "_host_prep")
    run = engine.bench_device_exec(imgs, names, labels)
    assert len(calls) == 1
    for buf in _two_calls(run):
        got = engine._make_finalize(lambda b=buf: b, names, prep["orig_sizes"],
                                    prep["class_idx"], prep["counts"], engine.max_classes)()
        for g, w in zip(got, want):
            assert g["name"] == w["name"]
            np.testing.assert_array_equal(g["score"], w["score"])
            for key in ("sgc", "cam"):
                assert (key in g) == (key in w)
                for c in w.get(key, {}):
                    np.testing.assert_array_equal(g[key][c], w[key][c])
    assert len(calls) == 1  # no host prep in the calls


def _seg_exec_check(engine):
    """The seg closure's buffer, twice, against ``run_batch``."""
    imgs, names = [np.asarray(i) for i in seg_images(3)], ["a", "b"]
    want = engine.run_batch(imgs, names)
    sizes = engine._host_prep(imgs, names)["orig_sizes"]
    calls = _counting(engine, "_host_prep")
    run = engine.bench_device_exec(imgs, names)
    assert len(calls) == 1
    for buf in _two_calls(run):
        if engine.output == "labels":
            for i, w in enumerate(want):
                np.testing.assert_array_equal(buf[i, :sizes[i][0], :sizes[i][1]], w["label"])
        else:
            got = engine._make_finalize(lambda b=buf: b, names, sizes, None)()
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["probs"], w["probs"])
    assert len(calls) == 1


@pytest.mark.parametrize("output", ["probs", "labels"])
def test_seg_bench_device_exec_equals_run_batch(seg_models, output):  # noqa: F811
    model, _, _ = seg_models
    _seg_exec_check(SegTTAEngine(model, device="cpu", output=output, accum_stride=4,
                                 download_dtype="float16", **SEG_BASE))


def test_seg_bench_device_exec_switches_off_equals_run_batch(seg_models):  # noqa: F811
    """The full-resolution logits on the unwindowed canvas."""
    model, _, _ = seg_models
    _seg_exec_check(SegTTAEngine(model, device="cpu", output="labels", accum_stride=4,
                                 download_dtype="float16", lowres=False, window_exact=False,
                                 **SEG_BASE))


@pytest.mark.parametrize("output", ["scores", "labels"])
def test_refiner_bench_device_exec_equals_refine_batch(setup, output):  # noqa: F811
    """The closure's buffer against the buffer ``refine_batch`` downloads
    (the f16 walk scores before the host upsample, or the labels), and the
    labels against ``refine_batch``'s own maps."""
    _, _, model, imgs, dicts = setup
    refiner = RandomWalkRefiner(model, crop_size=CROP, fast_io=True, output=output,
                                device="cpu")
    fetched = []
    refine_fast = refiner._refine_fast
    refiner._refine_fast = lambda *a, **kw: fetched.append(refine_fast(*a, **kw)) or fetched[-1]
    want = refiner.refine_batch(imgs, dicts)
    assert len(fetched) == 1  # one size bucket, one device call
    calls = _counting(refiner, "_pack_fast")
    run = refiner.bench_device_exec(imgs, dicts)
    assert len(calls) == 1
    for buf in _two_calls(run):
        np.testing.assert_array_equal(buf, fetched[0].numpy())
        if output == "labels":
            for i, w in enumerate(want):
                np.testing.assert_array_equal(buf[i, :w.shape[0], :w.shape[1]], w)
    assert len(calls) == 1 and len(fetched) == 3


def test_bench_device_exec_raises_where_jax_asserts(models, seg_models, setup):  # noqa: F811
    """The JAX engines assert device_tta (fused dispatch) and, for the
    refiner, fast_io and a batch of one size bucket."""
    _, _, port = models
    imgs, labels = [np.asarray(i) for i in cam_images(1)], cam_labels()
    with pytest.raises(ValueError, match="device_tta"):
        CamTTAEngine(port(384), device="cpu", device_tta=False).bench_device_exec(
            imgs, ["a", "b", "c"], labels)
    model, _, _ = seg_models
    with pytest.raises(ValueError, match="device_tta"):
        SegTTAEngine(model, device="cpu", device_tta=False, upload_mode="rgb").bench_device_exec(
            [np.asarray(i) for i in seg_images(3)], ["a", "b"])
    _, _, irn, irn_imgs, dicts = setup
    with pytest.raises(ValueError, match="fast_io"):
        RandomWalkRefiner(irn, crop_size=CROP, device="cpu").bench_device_exec(irn_imgs, dicts)
    two_buckets = irn_images([(50, 44)]) + irn_images([(20, 24)], seed=5)
    refiner = RandomWalkRefiner(irn, crop_size=CROP, bucket=32, fast_io=True, device="cpu")
    with pytest.raises(ValueError, match="one size bucket"):
        refiner.bench_device_exec(two_buckets, [{3: np.zeros((50, 44), np.float16)},
                                                {3: np.zeros((20, 24), np.float16)}])
