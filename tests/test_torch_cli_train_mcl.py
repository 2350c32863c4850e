"""The port's MCL training CLI (muscle_tpu_torch/cli/train_mcl.py) on the
CPU over a synthetic miniature VOC tree: one epoch at b1 (step A), then a
resume from that state renamed to epoch 11 into epoch 12, where IMC,
PixPro and EMD all run, and CAM generation (infer_mcl) from the
checkpoint it wrote."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from muscle_tpu_torch.cli import infer_mcl, train_mcl

CLS_OF = [0, 7, 11, 14]


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    for d in ("JPEGImages", "SegmentationClass"):
        os.makedirs(root / d)
    rng = np.random.default_rng(0)
    names = [f"2007_{i:06d}" for i in range(4)]
    labels = {}
    for i, n in enumerate(names):
        h, w = 60 + 4 * i, 80 - 4 * i
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        seg = np.zeros((h, w), np.uint8)
        seg[10:30, 10:30] = CLS_OF[i] + 1
        Image.fromarray(seg).save(root / "SegmentationClass" / f"{n}.png")
        lab = np.zeros(20, np.float32)
        lab[CLS_OF[i]] = 1
        labels[n] = lab
    (root / "list.txt").write_text("\n".join(names) + "\n")
    np.save(root / "cls_labels.npy", labels)
    return root, names


def _args(root, session, logs, *extra):
    return ["--train_list", str(root / "list.txt"), "--eval_list", str(root / "list.txt"),
            "--voc12_root", str(root), "--cls_labels", str(root / "cls_labels.npy"),
            "--session_name", str(session), "--log_dir", str(logs),
            "--backbone", "efficientnet-b1", "--batch_size", "2", "--crop_size", "64",
            "--num_workers", "2", "--log_every", "1", "--device", "cpu", *extra]


def _log(logs):
    return [json.loads(line) for line in (logs / "metrics.jsonl").read_text().splitlines()]


def test_train_mcl_epoch_resume_and_infer(mini_voc, tmp_path, monkeypatch):
    import muscle_tpu_torch.models.efficientnet as eff

    root, names = mini_voc
    session, logs = tmp_path / "session", tmp_path / "logs"
    # the epoch-end eval alone calls the MBConv kernel's wrapper (its plain
    # version on the CPU): every stride-1 block of b1, once a forward
    calls = []
    wrapper = eff.mbconv_stride1

    def counted(x, *a, **kw):
        assert not torch.is_grad_enabled()
        calls.append(x.shape[-1])
        return wrapper(x, *a, **kw)

    monkeypatch.setattr(eff, "mbconv_stride1", counted)
    train_mcl.main(_args(root, session, logs, "--max_epoches", "1"))
    blocks, _ = eff.efficientnet_config("efficientnet-b1", last_pooling=False)
    stride1 = [a.input_filters for a in blocks if a.stride == 1]
    forwards = len(calls) // len(stride1)
    assert forwards >= 1 and calls == stride1 * forwards
    assert (session / "model_0.pth").exists() and (session / "step_0.pt").exists()
    recs = _log(logs)
    assert [r["step"] for r in recs] == [1, 2]  # 4 images, batch 2: step A only
    assert all(r["loss_focal"] > 0 and r["loss_imc"] == 0 and "loss_pixpro" not in r
               for r in recs)
    assert list((logs / "vis").glob("step1_cls*_sgc.png")), "no overlay PNGs"
    ev = list((logs / "tb").glob("events.out.tfevents.*"))
    assert ev and ev[0].stat().st_size > 0
    assert len(list((session / "training_eval").glob("*.npy"))) == len(names)
    state0 = torch.load(session / "step_0.pt", weights_only=True)
    assert state0["step"] == 2 and state0["epoch"] == 0

    # the epoch-0 state as epoch 11: the next epoch is 12, the whole curriculum
    shutil.copy(session / "step_0.pt", session / "step_11.pt")
    train_mcl.main(_args(root, session, logs, "--max_epoches", "13", "--resume_epoch", "11"))
    recs = _log(logs)[2:]
    assert [r["step"] for r in recs] == [4, 6]  # steps A and B per iteration
    for r in recs:
        assert r["loss_imc"] >= 0 and r["loss_pixpro"] > 0 and "loss_emd" in r
    state12 = torch.load(session / "step_12.pt", weights_only=True)
    assert state12["step"] == 6 and state12["epoch"] == 12
    sd = torch.load(session / "model_12.pth", weights_only=True)
    moved = [k for k in sd if k.endswith(".weight") and not torch.equal(sd[k], state0["model"][k])]
    assert "fc.weight" in moved and "backbone._conv_stem.weight" in moved
    assert torch.equal(sd["fuse_dec.weight"], state0["model"]["fuse_dec.weight"])
    assert not any((session / f"model_{ep}.pth").exists() for ep in range(1, 12))

    out = tmp_path / "cams"
    infer_mcl.main(["--weights", str(session / "model_12.pth"),
                    "--infer_list", str(root / "list.txt"), "--voc12_root", str(root),
                    "--cls_labels", str(root / "cls_labels.npy"), "--out_npy", str(out),
                    "--backbone", "efficientnet-b1", "--scales", "1", "--device", "cpu",
                    "--num_workers", "1"])
    for i, n in enumerate(names):
        d = np.load(out.parent / (out.name + "_sgc") / f"{n}.npy", allow_pickle=True).item()
        assert list(d) == [CLS_OF[i]]
        assert np.isfinite(d[CLS_OF[i]].astype(np.float32)).all()


def test_train_mcl_refuses_bf16(mini_voc, tmp_path):
    """--bf16 1 on the card (the default device) where there is none
    raises: no fallback to the CPU unless --device cpu asks for it."""
    if torch.cuda.is_available():
        pytest.skip("a card is here: --device cuda would train on it")
    root, _ = mini_voc
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_mcl.main(_args(root, tmp_path / "s", tmp_path / "l", "--bf16", "1",
                             "--device", "cuda"))


def test_train_mcl_bf16_epoch_and_resume(mini_voc, tmp_path, monkeypatch):
    """--bf16 1: an epoch from a fresh bf16 classifier kernel, whose first
    Adam step leaves it float32 (as optax's does), with the epoch-end CAM
    engine in bf16; checkpoints of float32 tensors; a resume into epoch 12
    (steps A and B at bf16)."""
    import muscle_tpu_torch.inference as inference

    dtypes = []
    engine = inference.CamTTAEngine

    def recording(*a, **kw):
        dtypes.append(kw.get("compute_dtype"))
        return engine(*a, **kw)

    monkeypatch.setattr(inference, "CamTTAEngine", recording)
    root, names = mini_voc
    session, logs = tmp_path / "session", tmp_path / "logs"
    train_mcl.main(_args(root, session, logs, "--max_epoches", "1", "--bf16", "1"))
    recs = _log(logs)
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["loss_focal"] > 0 for r in recs)
    assert len(list((session / "training_eval").glob("*.npy"))) == len(names)
    state0 = torch.load(session / "step_0.pt", weights_only=True)
    assert {t.dtype for t in state0["model"].values() if t.is_floating_point()} == {
        torch.float32}
    moments = [t for st in state0["optimizer"]["state"].values()
               for k, t in st.items() if k.startswith("exp_avg")]
    assert moments and all(t.dtype == torch.float32 for t in moments)

    shutil.copy(session / "step_0.pt", session / "step_11.pt")
    train_mcl.main(_args(root, session, logs, "--max_epoches", "13", "--resume_epoch", "11",
                         "--bf16", "1"))
    recs = _log(logs)[2:]
    assert [r["step"] for r in recs] == [4, 6]
    assert all(r["loss_pixpro"] > 0 and np.isfinite(r["loss_emd"]) for r in recs)
    sd = torch.load(session / "model_12.pth", weights_only=True)
    assert not torch.equal(sd["fc.weight"], state0["model"]["fc.weight"])
    assert dtypes == [torch.bfloat16, torch.bfloat16]
