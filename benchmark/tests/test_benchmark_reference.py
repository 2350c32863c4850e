"""The plain reference held to the program's plain path (``muscle_tpu_torch``
on the CPU, where the MBConv blocks run unfused) at small sizes: the model's
forwards, the CAM and seg TTA records, and one MCL step A with Adam.  The
reference imports nothing of the program; these tests import both."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import gen, harness, weights  # noqa: E402
from benchmark.drivers.serve import program_muscle  # noqa: E402
from benchmark.reference import mcl as ref_mcl  # noqa: E402
from benchmark.reference.tta import cam_batch, seg_batch  # noqa: E402

ENC = dict(harness.load("b3_cam_voc_f32")[2], backbone="efficientnet-b1")
DEC = dict(harness.load("b7_seg_voc_f32")[2], backbone="efficientnet-b1", bifpn_layers=1,
           bifpn_channels=32)
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def _threads():
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


def _pair(config, images=()):
    ref = weights.make(config, SEED, "cpu", images)
    return ref, program_muscle(config, ref.state_dict(), "cpu").eval()


def _close(a, b, rel):
    return float((a - b).abs().max()) <= rel * max(float(b.abs().max()), 1e-6)


@pytest.mark.parametrize("mode,config", [("cam_lowres", ENC), ("seg_lowres", DEC)])
def test_model_forward_on_windowed_canvases(mode, config):
    imgs = gen.image_pool(3, (64, 64), 2, "cpu")
    ref, prog = _pair(config, imgs)
    x = torch.randn((4, 96, 128, 3), generator=torch.Generator().manual_seed(0))
    win = torch.tensor([[0, 0, 96, 128], [0, 0, 96, 128], [0, 0, 75, 101], [0, 0, 75, 101]])
    with torch.no_grad():
        want = ref(x, mode=mode, valid_window=win)
        got = prog(x, mode=mode, valid_window=win)
    for g, w in zip(got, want):
        assert _close(g, w, 1e-5)


def _traffic(cell, **over):
    t = harness.load(cell)[3]
    t.update(over)
    return t


def test_cam_records_match_the_engines():
    from muscle_tpu_torch.inference import CamTTAEngine

    t = _traffic("b3_cam_voc_f32", sizes=[[60, 80], [80, 60]], pool_per_size=2, batch=2)
    tr = gen.ImageTraffic(t, SEED, "cpu")
    ref, prog = _pair(ENC)
    e = t["engine"]
    engine = CamTTAEngine(prog, scales=(0.5, 1.0), device="cpu", return_cam=False,
                          max_classes=e["max_classes"], accum_stride=e["accum_stride"],
                          download_dtype=e["download_dtype"], tight_upload=True,
                          upload_mode="ycbcr420")
    for i in (0, 1):  # both orientations
        images, names, labels = tr.batch(i)
        got = engine.run_batch(images, names, labels)
        want = cam_batch(ref, images, labels, (0.5, 1.0))
        for g, w in zip(got, want):
            assert sorted(g["sgc"]) == sorted(w["sgc"])
            assert np.abs(g["score"] - w["score"]).max() <= 1e-5
            for c in w["sgc"]:
                d = np.abs(g["sgc"][c].astype(np.float32) - w["sgc"][c].astype(np.float32))
                assert g["sgc"][c].shape == w["sgc"][c].shape == images[0].shape[:2]
                # one uint8 quantum where f32 noise crosses a rounding point
                assert d.max() <= 1 / 255 + 1e-3 and d.mean() <= 5e-3


def test_seg_labels_match_the_engines():
    from muscle_tpu_torch.inference import SegTTAEngine

    t = _traffic("b7_seg_voc_f32", sizes=[[96, 128], [128, 96]], pool_per_size=2, batch=2)
    tr = gen.ImageTraffic(t, SEED, "cpu")
    ref, prog = _pair(DEC, tr.pools[0][:2])
    engine = SegTTAEngine(prog, scales=(0.5, 1.0), device="cpu", accum_stride=4,
                          download_dtype="float16", tight_upload=True, upload_mode="ycbcr420",
                          output="labels")
    for i in (0, 1):
        images, names, _ = tr.batch(i)
        got = engine.run_batch(images, names)
        want = seg_batch(ref, images, (0.5, 1.0))
        for g, w in zip(got, want):
            assert g["label"].shape == w.shape == images[0].shape[:2]
            assert len(np.unique(w)) > 1  # the calibrated head labels more than one class
            # labels: f32 noise flips near-ties of a random head only
            assert (g["label"] != w).mean() <= 0.02


def test_mcl_step_matches_the_programs():
    from muscle_tpu_torch.training import MCLConfig, make_adam, mcl_train_step

    t = _traffic("b3_mcl_train_f32", batch=4, crop=64, pool_batches=2)
    tr = gen.TrainTraffic(t, SEED, "cpu")
    ref = weights.make(ENC, SEED, "cpu")
    prog = program_muscle(ENC, ref.state_dict(), "cpu")
    opt = make_adam(prog.trained_parameters(), t["lr"], t["weight_decay"])
    batch = tr.batch(0)
    metrics = mcl_train_step(prog, opt, {k: torch.from_numpy(v) for k, v in batch.items()},
                             MCLConfig(use_imc=True), torch.Generator().manual_seed(5))
    params = dict(ref.trained_parameters())
    ropt = ref_mcl.Adam(params.values(), t["lr"], t["weight_decay"])
    loss, taken = ref_mcl.step(ref, ropt, {k: torch.from_numpy(v) for k, v in batch.items()},
                               torch.Generator().manual_seed(5))
    assert abs(float(metrics["loss"]) - loss) <= 1e-5 * abs(loss)
    got = dict(prog.named_parameters())
    largest = max(float(g.abs().max()) for g in taken)
    for (name, p), g in zip(params.items(), taken):
        mine = opt.state[got[name]]["exp_avg"] / 0.1
        assert float((mine - g).abs().max()) <= 1e-4 * largest, name
        # Adam's first step moves an element by about lr whatever its
        # gradient, so a gradient near zero may step either way
        assert float((got[name] - p).abs().max()) <= 2 * t["lr"], name
    buffers = dict(prog.named_buffers())
    for name, b in ref.named_buffers():
        assert torch.allclose(buffers[name].float(), b.float(), rtol=1e-5, atol=1e-6), name
