"""The port's segmentation and IRN training CLIs
(muscle_tpu_torch/cli/train_muscle.py, cli/train_irn.py) on the CPU over a
synthetic miniature VOC tree: one epoch of train_muscle at b1 with its
epoch-end eval (with the CRF), a resume into the next epoch, and one epoch
of train_irn whose checkpoint the IRN inference loader takes."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from muscle_tpu_torch.cli import train_irn, train_muscle
from muscle_tpu_torch.cli.infer_irn import load_irn_weights
from muscle_tpu_torch.models import EdgeDisplacement, IRNNet, init_weights

CLS_OF = [0, 7, 11, 14]


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory):
    """JPEGImages, SegmentationClass (also the IRN pseudo-labels), soft
    masks (background and the image's class), a list and cls_labels."""
    root = tmp_path_factory.mktemp("voc")
    for d in ("JPEGImages", "SegmentationClass", "masks"):
        os.makedirs(root / d)
    rng = np.random.default_rng(0)
    names = [f"2007_{i:06d}" for i in range(4)]
    labels = {}
    for i, n in enumerate(names):
        h, w = 60 + 4 * i, 80 - 4 * i
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        seg = np.zeros((h, w), np.uint8)
        seg[10:40, 10:44] = CLS_OF[i] + 1
        Image.fromarray(seg).save(root / "SegmentationClass" / f"{n}.png")
        m = np.zeros((h, w, 21), np.float16)
        m[..., 0] = rng.uniform(0, 0.6, (h, w))
        m[10:40, 10:44, CLS_OF[i] + 1] = rng.uniform(0.5, 1, (30, 34))
        np.save(root / "masks" / f"{n}.npy", m)
        lab = np.zeros(20, np.float32)
        lab[CLS_OF[i]] = 1
        labels[n] = lab
    (root / "list.txt").write_text("\n".join(names) + "\n")
    np.save(root / "cls_labels.npy", labels)
    return root, names


def _common(root):
    return ["--train_list", str(root / "list.txt"), "--voc12_root", str(root),
            "--cls_labels", str(root / "cls_labels.npy"), "--batch_size", "2",
            "--crop_size", "64", "--num_workers", "2", "--device", "cpu"]


def _seg_args(root, session, logs, *extra):
    return _common(root) + [
        "--eval_list", str(root / "list.txt"), "--mask_root", str(root / "masks"),
        "--session_name", str(session), "--log_dir", str(logs), "--pretrained", "b1",
        "--bifpn", "1", "--k", "8", "--step", "3", "--log_every", "1", "--crf", "1", *extra]


def _log(logs):
    return [json.loads(line) for line in (logs / "metrics.jsonl").read_text().splitlines()]


def test_train_muscle_epoch_and_resume(mini_voc, tmp_path):
    root, _ = mini_voc
    session, logs = tmp_path / "session", tmp_path / "logs"
    train_muscle.main(_seg_args(root, session, logs, "--max_epoches", "1"))
    assert (session / "model_0.pth").exists() and (session / "step_0.pt").exists()
    recs = _log(logs)
    assert [r["step"] for r in recs] == [1, 2]  # 4 images, batch 2
    for r in recs:
        assert r["loss_seg"] > 0 and np.isfinite(r["loss_beacon"]) and r["grad_norm"] > 0
        assert r["lr"] == pytest.approx(1e-5)
    assert list((logs / "vis").glob("step1_seg.png")), "no seg overlay"
    ev = list((logs / "tb").glob("events.out.tfevents.*"))
    assert ev and ev[0].stat().st_size > 0
    state0 = torch.load(session / "step_0.pt", weights_only=True)
    assert state0["step"] == 2 and state0["epoch"] == 0

    train_muscle.main(_seg_args(root, session, logs, "--max_epoches", "2",
                                "--resume_epoch", "0"))
    recs = _log(logs)[2:]
    assert [r["step"] for r in recs] == [3, 4]
    state1 = torch.load(session / "step_1.pt", weights_only=True)
    assert state1["step"] == 4 and state1["epoch"] == 1
    sd = torch.load(session / "model_1.pth", weights_only=True)
    for k in ("backbone._conv_stem.weight", "BIFPN.inp3.0.weight", "fuse_dec.weight"):
        assert not torch.equal(sd[k], state0["model"][k]), k
    # epoch 1 trained at the restored learning rate (the plateau rule acts after the save)
    assert state1["optimizer"]["param_groups"][0]["lr"] == pytest.approx(1e-5)


def test_train_muscle_refuses_bf16(mini_voc, tmp_path):
    """--bf16 1 on the card (the default device) where there is none
    raises: no fallback to the CPU unless --device cpu asks for it."""
    if torch.cuda.is_available():
        pytest.skip("a card is here: --device cuda would train on it")
    root, _ = mini_voc
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_muscle.main(_seg_args(root, tmp_path / "s", tmp_path / "l", "--bf16", "1",
                                    "--device", "cuda"))


def test_train_muscle_bf16_epoch(mini_voc, tmp_path, monkeypatch):
    """--bf16 1: an epoch at bf16 with its epoch-end eval, the seg engine
    in bf16 and the CRF on float32 probabilities; the checkpoint holds
    float32 tensors."""
    import muscle_tpu_torch.inference as inference
    import muscle_tpu_torch.ops.crf as crf

    seen = []
    engine, mean_field = inference.SegTTAEngine, crf.mean_field_crf

    def recording_engine(*a, **kw):
        seen.append(("engine", kw.get("compute_dtype")))
        return engine(*a, **kw)

    def recording_crf(probs, *a, **kw):
        seen.append(("crf", probs.dtype))
        return mean_field(probs, *a, **kw)

    monkeypatch.setattr(inference, "SegTTAEngine", recording_engine)
    monkeypatch.setattr(crf, "mean_field_crf", recording_crf)
    root, _ = mini_voc
    session, logs = tmp_path / "session", tmp_path / "logs"
    train_muscle.main(_seg_args(root, session, logs, "--max_epoches", "1", "--bf16", "1"))
    recs = _log(logs)
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert r["loss_seg"] > 0 and np.isfinite(r["loss_beacon"]) and r["grad_norm"] > 0
    state0 = torch.load(session / "step_0.pt", weights_only=True)
    assert state0["step"] == 2
    assert {t.dtype for t in state0["model"].values() if t.is_floating_point()} == {
        torch.float32}
    assert seen[0] == ("engine", torch.bfloat16)
    assert seen[1:] and all(s == ("crf", torch.float32) for s in seen[1:])


def test_train_irn_epoch_loads_into_the_refiner_net(mini_voc, tmp_path, capsys):
    """One epoch (2 steps) with the default bit-packed 4:2:0 batches: a
    checkpoint in the reference's IRN keys that the infer_irn loader takes,
    the heads moved, the backbone as initialised, the learning rate
    poly-decayed over the run's 2 steps."""
    root, _ = mini_voc
    session = tmp_path / "irn"
    train_irn.main(_common(root) + ["--pseudo_label_root", str(root / "SegmentationClass"),
                                    "--session_name", str(session), "--max_epoches", "1"])
    out = capsys.readouterr().out
    assert "ep 0 it 0 loss:" in out and "loss_dp_fg:" in out
    full = torch.load(session / "step_0.pt", weights_only=True)
    assert full["step"] == 2
    assert full["optimizer"]["param_groups"][0]["lr"] == pytest.approx(0.1 * 0.5 ** 0.9)
    net = EdgeDisplacement(crop_size=64)
    load_irn_weights(str(session / "model_0.pth"), net)
    init = init_weights(IRNNet(), torch.Generator().manual_seed(0)).state_dict()
    got = net.state_dict()
    assert all(torch.equal(got[k], init[k]) for k in init if k.startswith("resnet50."))
    assert not torch.equal(got["fc_edge6.weight"], init["fc_edge6.weight"])
    assert not torch.equal(got["fc_dp7.3.weight"], init["fc_dp7.3.weight"])
    with torch.inference_mode():
        x = torch.zeros((2, 64, 64, 3))
        edge, dp = net(x)
    assert torch.isfinite(edge).all() and torch.isfinite(dp).all()
