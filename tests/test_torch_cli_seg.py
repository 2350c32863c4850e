"""The port's segmentation CLIs on a synthetic miniature VOC tree:
infer_seg writes PNGs equal to the argmax of the port's SegTTAEngine (with
either CRF backend, class gating, or the fused labels output), and
cam_to_label equals the JAX package's cam_dict_to_label."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from muscle_tpu.cli.cam_to_label import cam_dict_to_label as j_cam_dict_to_label
from muscle_tpu_torch.cli import cam_to_label, infer_seg
from muscle_tpu_torch.data.transforms import color_norm
from muscle_tpu_torch.inference import SegTTAEngine
from muscle_tpu_torch.models import MuSCLe, calibrate_seg_head, init_weights
from muscle_tpu_torch.ops.crf import mean_field_crf
from muscle_tpu_torch.ops.exact_crf import dense_crf

CLS_OF = [0, 7, 11, 14]
# the mean-field CRF of the two packages differs by float summation order
# (test_torch_crf.py, 1e-4), which may flip near-tied labels
XLA_LABEL_AGREE = 0.99


def _ramp(h, w, rng):
    mix = rng.uniform(-1.0, 1.0, size=(2, 3))
    yy = np.linspace(0, 1, h)[:, None, None]
    xx = np.linspace(0, 1, w)[None, :, None]
    base = 127.5 + 100 * (yy * mix[0] + xx * mix[1]) + rng.normal(0, 8, size=(h, w, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory):
    """JPEGImages, a list, cls_labels, per-image class gates and SGC dicts;
    three landscape images and one portrait."""
    root = tmp_path_factory.mktemp("voc")
    for d in ("JPEGImages", "cls", "sgc"):
        os.makedirs(root / d)
    rng = np.random.default_rng(0)
    names = [f"2007_{i:06d}" for i in range(4)]
    labels = {}
    for i, n in enumerate(names):
        h, w = (60 + 4 * i, 80 - 4 * i) if i < 3 else (76, 52)
        Image.fromarray(_ramp(h, w, rng)).save(root / "JPEGImages" / f"{n}.jpg")
        lab = np.zeros(20, np.float32)
        lab[CLS_OF[i]] = 1
        labels[n] = lab
        np.save(root / "cls" / f"{n}.npy", np.concatenate([[1.0], lab])[None])
        yy, xx = np.mgrid[0:h, 0:w]
        bump = np.exp(-((yy - h / 2) ** 2 + (xx - w / 3) ** 2) / (2 * 12.0 ** 2))
        np.save(root / "sgc" / f"{n}.npy",
                {CLS_OF[i]: bump.astype(np.float16),
                 (CLS_OF[i] + 3) % 20: (0.6 * bump[:, ::-1]).astype(np.float16)})
    (root / "list.txt").write_text("\n".join(names) + "\n")
    # infer_seg's list: a landscape and a portrait image, one batch
    (root / "seg_list.txt").write_text(f"{names[0]}\n{names[3]}\n")
    np.save(root / "cls_labels.npy", labels)
    return root, names


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, mini_voc):
    """A reference-format .pth of a random b1 dec model with one BiFPN
    layer, its head calibrated so the labels vary."""
    root, names = mini_voc
    model = init_weights(MuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1),
                         torch.Generator().manual_seed(0)).eval()
    cal = np.stack([color_norm(np.asarray(_open(root, n))[:48, :48]) for n in names])
    with torch.inference_mode():
        calibrate_seg_head(model, torch.from_numpy(cal))
    path = tmp_path_factory.mktemp("ckpt") / "seg.pth"
    torch.save(model.state_dict(), path)
    return path, model.state_dict()


def _open(root, n):
    return Image.open(root / "JPEGImages" / f"{n}.jpg").convert("RGB")


CASES = {
    # name: (flags, engine kwargs, postprocess)
    "fast0": (["--fast", "0", "--crf", "0"], {}, None),
    "fast1_labels": (["--fast", "1", "--crf", "0"],
                     dict(accum_stride=4, download_dtype="float16", tight_upload=True,
                          upload_mode="ycbcr420", output="labels"), None),
    "fast1_gated": (["--fast", "1", "--crf", "0", "--cls_dir", "cls"],
                    dict(accum_stride=4, download_dtype="float16", tight_upload=True,
                         upload_mode="ycbcr420"), "gates"),
    "crf_native": (["--fast", "0", "--crf", "1", "--crf_backend", "native"], {}, "native"),
    "crf_xla": (["--fast", "0", "--crf", "1", "--crf_backend", "xla"], {}, "xla"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_infer_seg_writes_pngs_equal_to_engine(mini_voc, checkpoint, tmp_path, case):
    root, names = mini_voc
    ckpt, sd = checkpoint
    flags, kw, post = CASES[case]
    flags = [str(root / f) if f == "cls" else f for f in flags]
    out = tmp_path / "seg"
    infer_seg.main(["--weights", str(ckpt), "--infer_list", str(root / "seg_list.txt"),
                    "--voc12_root", str(root), "--cls_labels", str(root / "cls_labels.npy"),
                    "--out_seg", str(out), "--pretrained", "b1", "--bifpn", "1",
                    "--batch_size", "2", "--device", "cpu", *flags])

    # the engine on the CLI's batch (the list is already orientation-sorted)
    # with the same fused blocks
    model = MuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1, fuse_mbconv=384)
    model.load_state_dict(sd, strict=False)
    engine = SegTTAEngine(model, device="cpu", **kw)
    for chunk in ([names[0], names[3]],):
        imgs = [_open(root, n) for n in chunk]
        gates = None
        if post == "gates":
            gates = [np.load(root / "cls" / f"{n}.npy").squeeze() for n in chunk]
        for img, rec in zip(imgs, engine.run_batch(imgs, chunk, gates)):
            got = np.asarray(Image.open(out / f"{rec['name']}.png"))
            assert got.shape == (img.size[1], img.size[0]) and got.dtype == np.uint8
            if "label" in rec:
                np.testing.assert_array_equal(got, rec["label"])
                continue
            probs = rec["probs"]
            if post == "native":
                probs = dense_crf(np.asarray(img), probs.transpose(2, 0, 1), t=4)
                probs = probs.transpose(1, 2, 0)
            elif post == "xla":
                probs = mean_field_crf(torch.from_numpy(probs),
                                       torch.from_numpy(np.array(img)), t=4).numpy()
            np.testing.assert_array_equal(got, np.argmax(probs, axis=-1))
            if post == "gates":  # only the image's own class and background
                assert set(np.unique(got)) <= {0, CLS_OF[names.index(rec["name"])] + 1}


def test_infer_seg_rejects_spatial(mini_voc, checkpoint):
    """--spatial k > 1 needs a multiple of k ranks (torchrun): one process
    raises and never runs unsharded (test_torch_spatial.py runs it on 2
    ranks)."""
    root, _ = mini_voc
    ckpt, _ = checkpoint
    with pytest.raises(ValueError, match="not divisible by model axis 2"):
        infer_seg.main(["--weights", str(ckpt), "--infer_list", str(root / "list.txt"),
                        "--spatial", "2", "--device", "cpu"])


@pytest.mark.parametrize("backend", ["native", "xla"])
def test_cam_to_label_matches_jax(mini_voc, tmp_path, backend):
    root, names = mini_voc
    out = tmp_path / "png"
    cam_to_label.main(["--cam_dir", str(root / "sgc"), "--out_dir", str(out),
                       "--infer_list", str(root / "list.txt"), "--voc12_root", str(root),
                       "--crf_t", "4", "--crf_backend", backend, "--device", "cpu"])
    for n in names:
        img = np.asarray(_open(root, n))
        cams = np.load(root / "sgc" / f"{n}.npy", allow_pickle=True).item()
        want = j_cam_dict_to_label(img, cams, t=4, crf_backend=backend)
        got = np.asarray(Image.open(out / f"{n}.png"))
        assert got.shape == want.shape and got.dtype == np.uint8
        if backend == "native":  # the same C++
            np.testing.assert_array_equal(got, want)
        else:
            assert (got == want).mean() >= XLA_LABEL_AGREE
        assert {0, 255} & set(np.unique(got)) and len(np.unique(got)) > 1
