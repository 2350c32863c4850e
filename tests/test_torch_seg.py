"""The port's SegTTAEngine (muscle_tpu_torch/inference/seg.py) against the
JAX package's on the same weights and synthetic images (b1, one BiFPN
layer, scales 0.5 and 1, 64-px canvases), in every output, upload and
accumulation mode, and under both parity switches (lowres, window_exact)."""

import inspect

import numpy as np
import pytest
import torch
from PIL import Image

from muscle_tpu.convert import convert_muscle_state_dict
from muscle_tpu.inference import SegTTAEngine as JEngine
from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu_torch.data.transforms import color_norm
from muscle_tpu_torch.inference import SegTTAEngine
from muscle_tpu_torch.models import MuSCLe, calibrate_seg_head, init_weights
from muscle_tpu_torch.parallel import make_mesh

# the JAX package's seg engine bounds (test_inference.py), tightened to what
# f32 on both sides gives: probabilities through the same resizes in f32,
# 1e-4; with the float16 download, half an f16 step at 1, 1e-3.  Labels:
# argmax of the same probabilities, so only near-ties may differ: 99.9% at
# stride 1; at stride 4 the final upsample differs too (PIL on the host vs
# the device's resize), 97%.
PROBS_ATOL, PROBS_F16_ATOL = 1e-4, 1e-3
LABELS_AGREE, LABELS_AGREE_S4 = 0.999, 0.97
SIZES = [(50, 40), (40, 56)]
BASE = dict(scales=(0.5, 1.0), out_side=64, max_side=60)


def _images(seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in sizes:
        mix = rng.uniform(-1.0, 1.0, size=(2, 3))
        yy = np.linspace(0, 1, h)[:, None, None]
        xx = np.linspace(0, 1, w)[None, :, None]
        base = 127.5 + 100 * (yy * mix[0] + xx * mix[1]) + rng.normal(0, 8, size=(h, w, 3))
        out.append(Image.fromarray(np.clip(base, 0, 255).astype(np.uint8)))
    return out


@pytest.fixture(scope="module")
def models():
    """A seeded random port model (head calibrated so labels vary), and the
    JAX model with the same weights."""
    model = init_weights(MuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1,
                                fuse_mbconv=384), torch.Generator().manual_seed(0)).eval()
    cal = np.stack([color_norm(np.asarray(im)[:40, :40]) for im in _images(9)])
    with torch.inference_mode():
        calibrate_seg_head(model, torch.from_numpy(cal))
    sd = {k: t.numpy() for k, t in model.state_dict().items() if "num_batches_tracked" not in k}
    jm = JMuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1)
    return model, jm, convert_muscle_state_dict(sd)


CASES = {
    # name: engine kwargs
    "host_prep": dict(device_tta=False, upload_mode="rgb"),
    "device_f32_rgb": dict(upload_mode="rgb", tight_upload=False),
    "fast": dict(accum_stride=4, download_dtype="float16", tight_upload=True,
                 upload_mode="ycbcr420"),
    "labels_stride1": dict(output="labels", upload_mode="rgb", tight_upload=False),
    "labels_stride4": dict(output="labels", accum_stride=4, download_dtype="float16",
                           tight_upload=True, upload_mode="ycbcr420"),
}


# the parity switches: the full-resolution 'seg' logits (lowres=False) and
# the top-left canvas without window masks (window_exact=False), alone and
# together, on a host, a device, the fast and a labels path; the image
# sizes are not multiples of 8, so the unwindowed low-resolution upsample's
# ceil boxes show
SWITCHES = {
    "full_res": dict(lowres=False),
    "unwindowed": dict(window_exact=False),
    "full_res_unwindowed": dict(lowres=False, window_exact=False),
}
SWITCH_PATHS = ("host_prep", "device_f32_rgb", "fast", "labels_stride4")
# the defaults keep the plain case names
ENGINE_CASES = ([pytest.param(case, None, id=case) for case in sorted(CASES)]
                + [pytest.param(case, sw, id=f"{case}-{sw}")
                   for case in SWITCH_PATHS for sw in SWITCHES])


@pytest.fixture(scope="module")
def engines(models):
    """(port, JAX) engine pairs by case and switches, made once (the JAX
    engines compile per instance)."""
    model, jm, v = models
    cache = {}

    def get(case, switches=None):
        if (case, switches) not in cache:
            kw = dict(BASE, **CASES[case], **SWITCHES.get(switches, {}))
            cache[case, switches] = (SegTTAEngine(model, device="cpu", **kw),
                                     JEngine(jm, v, **kw))
        return cache[case, switches]

    return get


def _assert_probs_close(got, want, atol, what):
    assert len(got) == len(want)
    for g, w, (h, wd) in zip(got, want, SIZES):
        assert g["name"] == w["name"]
        assert g["probs"].shape == (h, wd, 21) and g["probs"].dtype == np.float32
        np.testing.assert_allclose(g["probs"], w["probs"], atol=atol, err_msg=what)


def _assert_labels_agree(got, want, agree, what):
    assert len(got) == len(want)
    for g, w, (h, wd) in zip(got, want, SIZES):
        assert g["name"] == w["name"]
        assert g["label"].shape == (h, wd) and g["label"].dtype == np.uint8
        assert (g["label"] == w["label"]).mean() >= agree, what
    assert len(np.unique(np.concatenate([g["label"].ravel() for g in got]))) > 1


@pytest.mark.parametrize("case,switches", ENGINE_CASES)
def test_seg_engine_matches_jax(engines, case, switches):
    teng, jeng = engines(case, switches)
    imgs, names = _images(3), ["a", "b"]
    want = jeng.run_batch(imgs, names)
    # the port also takes HWC uint8 arrays
    got = teng.run_batch([np.asarray(i) for i in imgs], names)
    if case.startswith("labels"):
        _assert_labels_agree(got, want, LABELS_AGREE if case.endswith("1") else LABELS_AGREE_S4,
                             case)
    else:
        atol = PROBS_F16_ATOL if CASES[case].get("download_dtype") == "float16" else PROBS_ATOL
        _assert_probs_close(got, want, atol, case)
        for g in got:
            np.testing.assert_allclose(g["probs"].sum(-1), 1.0, atol=atol * 21)


def test_seg_engine_switches_take_jax_defaults():
    want = inspect.signature(JEngine).parameters
    got = inspect.signature(SegTTAEngine).parameters
    for name in ("lowres", "window_exact"):
        assert got[name].default is want[name].default is True


def test_seg_lowres_false_equals_lowres_true(engines):
    """The port's input-size 'seg' logits equal its stride-8 logits
    upsampled in the engine, window-exact, at the JAX package's bound
    (tests/test_inference.py)."""
    imgs, names = _images(6), ["a", "b"]
    low = engines("device_f32_rgb")[0].run_batch(imgs, names)
    full = engines("device_f32_rgb", "full_res")[0].run_batch(imgs, names)
    for lo, fu in zip(low, full):
        np.testing.assert_allclose(fu["probs"], lo["probs"], atol=2e-5)


def test_seg_engine_cls_gates_match_jax(engines):
    teng, jeng = engines("device_f32_rgb")
    imgs, names = _images(4), ["a", "b"]
    gates = [np.zeros(21, np.float32), None]
    gates[0][[0, 5, 9]] = 1.0
    want = jeng.run_batch(imgs, names, gates)
    got = teng.run_batch(imgs, names, gates)
    _assert_probs_close(got, want, PROBS_ATOL, "cls_gates")
    p = got[0]["probs"]
    assert not p[..., [c for c in range(1, 21) if c not in (5, 9)]].any()
    assert p[..., 0].any() and got[1]["probs"][..., 1:].any()


def test_seg_run_stream_matches_run_batch(models):
    model, _, _ = models
    engine = SegTTAEngine(model, device="cpu", **BASE, **CASES["fast"])
    lab = SegTTAEngine(model, device="cpu", **BASE, **CASES["labels_stride4"])

    def batch(i):
        return [np.asarray(im) for im in _images(10 + i)], [f"s{i}_0", f"s{i}_1"]

    for eng, key in ((engine, "probs"), (lab, "label")):
        want = [eng.run_batch(*batch(i)) for i in range(3)]
        got = list(eng.run_stream(batch(i) for i in range(3)))
        later = eng.run_batch_async(*batch(0))
        assert len(got) == 3
        for wb, gb in zip(want + want[:1], got + [later()]):
            for w, g in zip(wb, gb):
                assert w["name"] == g["name"]
                np.testing.assert_array_equal(w[key], g[key])


def test_seg_engine_rejects_unsupported_options(models):
    model, _, _ = models
    # bf16 is served (test_torch_bf16_engines.py); any other compute dtype
    # still raises
    assert SegTTAEngine(model, compute_dtype=torch.bfloat16,
                        device="cpu").compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        SegTTAEngine(model, compute_dtype=torch.float16, device="cpu")
    # shard_spatial without a mesh raises as the JAX engine does
    # (test_torch_spatial.py runs it on a mesh); a mesh without
    # shard_spatial is the data-parallel engine, one data row in one process
    # (test_torch_mesh_engines.py runs it on ranks)
    with pytest.raises(ValueError, match="requires a mesh"):
        SegTTAEngine(model, shard_spatial=True, device="cpu")
    one_row = SegTTAEngine(model, mesh=make_mesh(), device="cpu")
    assert one_row.stripes is None and one_row.mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        SegTTAEngine(model, output="labels", device_tta=False, device="cpu")
    with pytest.raises(ValueError):
        SegTTAEngine(model, download_dtype="uint8", device="cpu")
    engine = SegTTAEngine(model, device="cpu", **BASE, output="labels")
    with pytest.raises(ValueError, match="cls_gates"):
        engine.run_batch(_images(5), ["a", "b"], [np.ones(21), None])
    # bench_device_exec on the device_tta path only, as the JAX engine
    # asserts (test_torch_device_exec.py runs it)
    with pytest.raises(ValueError, match="device_tta"):
        SegTTAEngine(model, device="cpu", device_tta=False).bench_device_exec(
            _images(5), ["a", "b"])
