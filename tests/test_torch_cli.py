"""The port's CLIs (muscle_tpu_torch/cli) on a synthetic miniature VOC
tree: infer_mcl writes the reference's npy-dict contract and equals the
port's engine; evaluate equals the JAX package's evaluate_folder."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from muscle_tpu.evaluation import evaluate_folder as j_evaluate_folder
from muscle_tpu.evaluation import threshold_sweep as j_threshold_sweep
from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu_torch.cli import evaluate, infer_mcl
from muscle_tpu_torch.cli.common import load_model_state
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.evaluation import evaluate_folder, threshold_sweep
from muscle_tpu_torch.inference import CamTTAEngine
from muscle_tpu_torch.models import MuSCLe

CLS_OF = [0, 7, 11, 14]
CATS = ["aeroplane", "cat", "dog", "person"]


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory):
    """JPEGImages + SegmentationClass + list + cls_labels; one portrait."""
    root = tmp_path_factory.mktemp("voc")
    for d in ("JPEGImages", "SegmentationClass"):
        os.makedirs(root / d)
    rng = np.random.default_rng(0)
    names = [f"2007_{i:06d}" for i in range(4)]
    labels = {}
    for i, n in enumerate(names):
        h, w = (60 + 4 * i, 80 - 4 * i) if i < 3 else (76, 52)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        seg = np.zeros((h, w), np.uint8)
        seg[10:30, 10:30] = CLS_OF[i] + 1
        seg[0, :] = 255
        Image.fromarray(seg).save(root / "SegmentationClass" / f"{n}.png")
        lab = np.zeros(20, np.float32)
        lab[CLS_OF[i]] = 1
        labels[n] = lab
    (root / "list.txt").write_text("\n".join(names) + "\n")
    np.save(root / "cls_labels.npy", labels)
    return root, names


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A reference-format .pth of a random b1 (JAX init with batch norms
    near the identity, carried across), whose maps stay O(1)."""
    jm = JMuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False)
    v = jm.init({"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)), mode="cam")
    v = jax.tree.map(np.asarray, v)
    sd = state_dict_from_jax(v)
    rng = np.random.default_rng(0)
    for k in sd:
        if k.endswith("running_var"):
            n = sd[k].shape
            base = k[: -len("running_var")]
            sd[base + "weight"] = torch.tensor(rng.uniform(0.75, 1.25, n), dtype=torch.float32)
            sd[base + "bias"] = torch.tensor(rng.uniform(-0.1, 0.1, n), dtype=torch.float32)
            sd[base + "running_mean"] = torch.tensor(rng.uniform(-0.2, 0.2, n),
                                                     dtype=torch.float32)
            sd[k] = torch.tensor(rng.uniform(0.5, 1.0, n), dtype=torch.float32)
    path = tmp_path_factory.mktemp("ckpt") / "model.pth"
    torch.save(sd, path)
    return path, sd


def _cli_args(root, ckpt, out, *extra):
    return ["--weights", str(ckpt), "--infer_list", str(root / "list.txt"),
            "--voc12_root", str(root), "--cls_labels", str(root / "cls_labels.npy"),
            "--out_npy", str(out), "--backbone", "efficientnet-b1", "--scales", "0.5,1",
            "--batch_size", "2", "--device", "cpu", *extra]


@pytest.mark.parametrize("mode", ["fast1", "fast0", "exact"])
def test_infer_mcl_writes_npy_dicts_equal_to_engine(mini_voc, checkpoint, tmp_path, mode):
    root, names = mini_voc
    ckpt, sd = checkpoint
    flags = {"fast1": [], "fast0": ["--fast", "0"], "exact": ["--exact", "1"]}[mode]
    out = tmp_path / "cams"
    infer_mcl.main(_cli_args(root, ckpt, out, "--save_cam", "1", "--fuse_mbconv", "384",
                             *flags))

    # the engine on the CLI's batches (two images, orientation-sorted, which
    # this list already is) and the same fused blocks: the same computation
    model = MuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False,
                   fuse_mbconv=384)
    model.load_state_dict(sd, strict=False)
    fast = dict(accum_stride=4, download_dtype="uint8", tight_upload=True,
                upload_mode="ycbcr420") if mode == "fast1" else {}
    engine = CamTTAEngine(model, scales=(0.5, 1.0), device="cpu", **fast)
    imgs = [Image.open(root / "JPEGImages" / f"{n}.jpg").convert("RGB") for n in names]
    labels = np.load(root / "cls_labels.npy", allow_pickle=True).item()
    run = engine.run_batch_exact if mode == "exact" else engine.run_batch
    want = {}
    for lo in (0, 2):
        chunk = names[lo: lo + 2]
        for r in run(imgs[lo: lo + 2], chunk, [labels[n] for n in chunk]):
            want[r["name"]] = r
    for i, n in enumerate(names):
        for sub, key in ((str(out) + "_sgc", "sgc"), (str(out), "cam")):
            d = np.load(os.path.join(sub, n + ".npy"), allow_pickle=True).item()
            assert set(d) == {CLS_OF[i]}
            w, h = imgs[i].size
            m = d[CLS_OF[i]]
            assert m.shape == (h, w) and m.dtype == want[n][key][CLS_OF[i]].dtype
            np.testing.assert_array_equal(m, want[n][key][CLS_OF[i]])


def test_evaluate_matches_jax(mini_voc, tmp_path, capsys):
    root, names = mini_voc
    pred = tmp_path / "pred"
    os.makedirs(pred)
    rng = np.random.default_rng(1)
    for i, n in enumerate(names):
        h, w = np.asarray(Image.open(root / "SegmentationClass" / f"{n}.png")).shape
        np.save(pred / f"{n}.npy", {CLS_OF[i]: rng.uniform(0, 1, (h, w)).astype(np.float16)})
    gt = str(root / "SegmentationClass")
    got = evaluate_folder(str(pred), gt, names, 21, "npy", 0.4)
    want = j_evaluate_folder(str(pred), gt, names, 21, "npy", 0.4)
    assert got == want
    ths = np.arange(5) / 10.0
    assert threshold_sweep(str(pred), gt, names, ths) == j_threshold_sweep(str(pred), gt,
                                                                           names, ths)
    log = tmp_path / "log.txt"
    evaluate.main(["--list", str(root / "list.txt"), "--predict_dir", str(pred),
                   "--gt_dir", gt, "--logfile", str(log), "--comment", "port",
                   "--t", "0.4"])
    assert f"{want['mIoU']:7.3f}%" in capsys.readouterr().out
    assert "port" in log.read_text()


def test_load_model_state_rules(checkpoint, tmp_path):
    _, sd = checkpoint
    model = MuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False)
    before = model.fuse_dec.weight.clone()
    # Lightning-style wrapper, plus a key the model does not have
    wrapped = tmp_path / "wrapped.ckpt"
    torch.save({"state_dict": {**sd, "extra.weight": torch.zeros(1)}}, wrapped)
    load_model_state(str(wrapped), model)
    assert torch.equal(model.fc.weight, sd["fc.weight"])
    assert torch.equal(model.fuse_dec.weight, before)  # absent key keeps its init
    bad = tmp_path / "bad.pth"
    torch.save({"fc.weight": torch.zeros(3, 3)}, bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_model_state(str(bad), model)
    # the JAX package's model_<epoch>.msgpack: Flax's to_bytes of the same weights
    import flax.serialization

    from muscle_tpu.convert import convert_muscle_state_dict

    tree = convert_muscle_state_dict({k: v.numpy() for k, v in sd.items()})
    (tmp_path / "model_0.msgpack").write_bytes(flax.serialization.to_bytes(tree))
    fresh = MuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False)
    load_model_state(str(tmp_path / "model_0.msgpack"), fresh)
    for k, v in fresh.state_dict().items():
        if k in sd:
            assert torch.equal(v, sd[k]), k
    with pytest.raises(ValueError, match="unrecognised"):
        load_model_state(str(tmp_path / "model.bin"), model)


def test_infer_mcl_fuses_b3_stride1_blocks_by_default(mini_voc, tmp_path, monkeypatch):
    """At its default flags infer_mcl runs every stride-1 block of b3 (23
    of 26) through the MBConv kernel's wrapper (its plain version on the
    CPU), once per forward, and reports the run's forwards."""
    import muscle_tpu_torch.models.efficientnet as eff

    root, names = mini_voc
    calls = []
    wrapper = eff.mbconv_stride1

    def counted(x, *a, **kw):
        calls.append(x.shape[-1])
        return wrapper(x, *a, **kw)

    monkeypatch.setattr(eff, "mbconv_stride1", counted)
    empty = tmp_path / "random.pth"  # no keys: the model keeps its random init
    torch.save({}, empty)
    run = infer_mcl.main(["--weights", str(empty), "--infer_list", str(root / "list.txt"),
                          "--voc12_root", str(root), "--cls_labels",
                          str(root / "cls_labels.npy"), "--scales", "1", "--device", "cpu",
                          "--num_workers", "1"])
    blocks, _ = eff.efficientnet_config("efficientnet-b3", last_pooling=False)
    stride1 = [a.input_filters for a in blocks if a.stride == 1]
    assert len(blocks) == 26 and len(stride1) == 23
    assert run["images"] == len(names) and run["backbone_forwards"] == 1
    assert calls == stride1 * run["backbone_forwards"]
    assert run["mbconv_launches"] == 0  # the CPU runs the plain version: no launch


@pytest.mark.parametrize("spatial", [0, 1])
def test_infer_mcl_accepts_spatial_0_and_1(mini_voc, checkpoint, tmp_path, spatial):
    """--spatial 0 (the JAX CLI's default) and 1 run one engine, as the
    JAX CLI does below 2; the maps equal the run without the flag."""
    root, names = mini_voc
    ckpt, _ = checkpoint
    infer_mcl.main(_cli_args(root, ckpt, tmp_path / "plain"))
    infer_mcl.main(_cli_args(root, ckpt, tmp_path / "flag", "--spatial", str(spatial)))
    for n in names:
        a = np.load(tmp_path / "plain_sgc" / f"{n}.npy", allow_pickle=True).item()
        b = np.load(tmp_path / "flag_sgc" / f"{n}.npy", allow_pickle=True).item()
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_infer_mcl_rejects_spatial_above_1(mini_voc, checkpoint, tmp_path):
    root, _ = mini_voc
    ckpt, _ = checkpoint
    with pytest.raises(NotImplementedError, match="spatial"):
        infer_mcl.main(_cli_args(root, ckpt, tmp_path / "x", "--spatial", "2"))
