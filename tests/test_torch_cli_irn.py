"""The port's infer_irn CLI on a synthetic miniature VOC tree: its PNG and
soft npy outputs equal the port's refiner on the same inputs, and the PNG
palette is the JAX package's."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from muscle_tpu.core.palette import save_indexed_png as j_save_indexed_png
from muscle_tpu_torch.cli import infer_irn
from muscle_tpu_torch.core.palette import voc_color_map
from muscle_tpu_torch.inference import RandomWalkRefiner
from muscle_tpu_torch.models import EdgeDisplacement
from test_torch_irn_models import make_irn

SIZES = [(60, 80), (64, 76), (52, 68), (76, 52)]  # one portrait
CLASSES = [[0], [7, 11], [14], [3, 19]]


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory):
    """JPEGImages, a list, cls_labels and a CAM dict per image; and a
    reference-format IRN .pth (the JAX init carried across)."""
    root = tmp_path_factory.mktemp("voc")
    os.makedirs(root / "JPEGImages")
    os.makedirs(root / "cams")
    rng = np.random.default_rng(0)
    names = [f"2007_{i:06d}" for i in range(len(SIZES))]
    labels = {}
    for n, (h, w), cls in zip(names, SIZES, CLASSES):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        np.save(root / "cams" / f"{n}.npy",
                {c: rng.uniform(0, 1, (h, w)).astype(np.float16) for c in cls})
        lab = np.zeros(20, np.float32)
        lab[cls] = 1
        labels[n] = lab
    (root / "list.txt").write_text("\n".join(names) + "\n")
    np.save(root / "cls_labels.npy", labels)
    _, _, sd = make_irn(crop=128)
    torch.save(sd, root / "irn.pth")
    return root, names, sd


def _args(root, out, *extra):
    return ["--irn_weights_name", str(root / "irn.pth"), "--cam_dir", str(root / "cams"),
            "--sem_seg_out_dir", str(out), "--infer_list", str(root / "list.txt"),
            "--voc12_root", str(root), "--cls_labels", str(root / "cls_labels.npy"),
            "--batch_size", "2", "--device", "cpu", *extra]


def _refiner_outputs(root, names, sd, **kw):
    """The port's refiner on the CLI's batches of two."""
    model = EdgeDisplacement()
    model.load_state_dict(sd, strict=False)
    refiner = RandomWalkRefiner(model, device="cpu", **kw)
    out = {}
    for lo in range(0, len(names), 2):
        chunk = names[lo: lo + 2]
        imgs = [Image.open(root / "JPEGImages" / f"{n}.jpg").convert("RGB") for n in chunk]
        dicts = [np.load(root / "cams" / f"{n}.npy", allow_pickle=True).item() for n in chunk]
        out.update(zip(chunk, refiner.refine_batch(imgs, dicts)))
    return refiner, out


def test_infer_irn_png_labels(mini_voc, tmp_path):
    root, names, sd = mini_voc
    out = tmp_path / "rw"
    infer_irn.main(_args(root, out))  # --fast 1: labels fused on the device
    refiner, want = _refiner_outputs(root, names, sd, fast_io=True, output="labels")
    j_png = tmp_path / "jax.png"
    for n, (h, w) in zip(names, SIZES):
        png = Image.open(out.parent / "rw_png" / f"{n}.png")
        assert png.mode == "P"
        lab = np.asarray(png)
        assert lab.shape == (h, w)
        np.testing.assert_array_equal(lab, want[n])
        j_save_indexed_png(str(j_png), lab)
        j = Image.open(j_png)
        assert png.getpalette() == j.getpalette()
        np.testing.assert_array_equal(np.asarray(j), lab)
    assert not os.path.exists(out)  # soft outputs only with --soft_output 1
    assert png.getpalette()[:9] == voc_color_map()[:3].reshape(-1).tolist()


def test_infer_irn_soft_npy(mini_voc, tmp_path):
    root, names, sd = mini_voc
    out = tmp_path / "rw"
    infer_irn.main(_args(root, out, "--soft_output", "1"))
    _, want = _refiner_outputs(root, names, sd, fast_io=True, output="scores")
    for n, (h, w) in zip(names, SIZES):
        got = np.load(out / f"{n}.npy")
        assert got.shape == (h, w, 21) and got.dtype == np.float16
        np.testing.assert_array_equal(got, want[n].astype(np.float16))


def test_infer_irn_rejects_unsupported(mini_voc, tmp_path):
    root, _, sd = mini_voc
    with pytest.raises(NotImplementedError, match="bf16"):
        infer_irn.main(_args(root, tmp_path / "a", "--bf16", "1"))
    with pytest.raises(NotImplementedError, match="msgpack"):
        infer_irn.load_irn_weights(str(tmp_path / "irn_0.msgpack"), EdgeDisplacement())
    partial = tmp_path / "partial.pth"
    torch.save({k: v for k, v in sd.items() if not k.startswith("fc_edge6")}, partial)
    with pytest.raises(KeyError, match="fc_edge6"):
        infer_irn.load_irn_weights(str(partial), EdgeDisplacement())
