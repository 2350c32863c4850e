"""The port's gate harness (muscle_tpu_torch/gates.py) against the JAX
package's (muscle_tpu/gates.py): the synthetic tree byte for byte; gates
1 (exact and fast) and 7 (fast) on the same weights and the same stand-in
oracle, a small torch module with the reference's call signature over the
port's plain CPU model; gate 3's arithmetic with an injected oracle; and
gates 4, 5 and 6 in the port alone at a few steps on the CPU."""

import ast
import copy
import functools
import inspect
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import muscle_tpu.gates as JG
import muscle_tpu_torch.gates as G
from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.data.transforms import color_norm
from muscle_tpu_torch.data.voc12 import get_img_path
from muscle_tpu_torch.models import MuSCLe, calibrate_seg_head

# the small tier's tree (cli/gates.py without --full_size)
SIZES = [(48, 64), (64, 48), (42, 64), (64, 64)]
# the two packages' gate reports on the same weights and oracle: their
# engines agree to f32 noise (tests/test_torch_cam.py, test_torch_seg.py)
DELTA_ATOL, SCORE_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    names = G.build_synthetic_voc(root, sizes=SIZES)
    labels = np.load(os.path.join(root, "cls_labels.npy"), allow_pickle=True).item()
    return root, names, labels


def test_synthetic_voc_is_byte_identical_to_jax(tree, tmp_path):
    root, names, _ = tree
    want = str(tmp_path / "jax")
    assert JG.build_synthetic_voc(want, sizes=SIZES) == names
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), want)
                           for d, _, fs in os.walk(want) for f in fs)
    assert len(files) == 3 * len(SIZES) + 2  # jpg, png, xml each; list, labels
    for f in files:
        with open(os.path.join(root, f), "rb") as a, open(os.path.join(want, f), "rb") as b:
            assert a.read() == b.read(), f


# ---- the stand-in oracle ------------------------------------------------------

class StandIn(torch.nn.Module):
    """The reference MuSCLe's call signature (NCHW in, NCHW maps out) over
    the port's plain CPU model: ``(x, cam='cam') -> (cam, sgc, emb,
    score)``, ``(x, cam='seg') -> (seg, features)``."""

    def __init__(self, model):
        super().__init__()
        self.model = model.eval()

    def forward(self, x, cam="cam"):
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        out = self.model(x.permute(0, 2, 3, 1).contiguous(), mode=cam)
        if cam == "seg":
            return nchw(out[0]), nchw(out[1])
        cams, sgc, emb, logits = out
        return nchw(cams), nchw(sgc), emb, logits


def _draw(tree, rng):
    """numpy leaves for a tree of shapes: kernels lecun-normal (the JAX
    package's initialiser, untruncated), everything else zero."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _draw(v, rng)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = rng.normal(0, fan_in ** -0.5, v.shape).astype(np.float32)
        else:
            out[k] = np.zeros(v.shape, np.float32)
    return out


def _randomize_bn(tree, stats, rng):
    """Batch norms near the identity with random scale, shift and
    statistics, so a random b1's maps stay O(1)."""
    for k, sub in tree.items():
        if "scale" in sub:
            n = sub["scale"].shape
            sub["scale"] = rng.uniform(0.75, 1.25, n).astype(np.float32)
            sub["bias"] = rng.uniform(-0.1, 0.1, n).astype(np.float32)
            stats[k]["mean"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
            stats[k]["var"] = rng.uniform(0.5, 1.0, n).astype(np.float32)
        elif "kernel" not in sub:
            _randomize_bn(sub, stats.setdefault(k, {}), rng)


def _pair(mode: str, seed: int, calib: np.ndarray | None = None):
    """(JAX model, its variables, the port's model) with the same b1 weights,
    drawn with numpy from one seed into the JAX tree's shapes and carried
    across by ``state_dict_from_jax``.  An enc model's classifier rows are made
    orthogonal to its mean p7 feature on random inputs, as the reference
    oracle's calibration does (``make_oracle_muscle``), so its CAMs
    straddle zero and the fused maps are well-conditioned; a dec model's
    head is calibrated on ``calib`` (NHWC, normalised) so its labels vary
    over an image (``calibrate_seg_head``)."""
    kw = dict(mode="dec", bifpn_layers=1, last_pooling=True) if mode == "dec" else dict(
        mode="enc", last_pooling=False)
    jm = JMuSCLe(backbone_name="efficientnet-b1", **kw)
    shapes = jax.eval_shape(functools.partial(jm.init, mode="seg" if mode == "dec" else "cam"),
                            {"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(seed)
    v = _draw(shapes, rng)
    _randomize_bn(v["params"], v["batch_stats"], rng)
    model = MuSCLe(backbone_name="efficientnet-b1", **kw).eval()
    model.load_state_dict(state_dict_from_jax(v), strict=False)
    if mode == "enc":
        x = torch.from_numpy(rng.normal(0, 1, (4, 96, 96, 3)).astype(np.float32))
        with torch.no_grad():
            p_bar = model(x, mode="logits")[0].mean(dim=0).numpy()
        w = v["params"]["fc"]["kernel"].T
        v["params"]["fc"]["kernel"] = np.ascontiguousarray(
            (w - np.outer(w @ p_bar / (p_bar @ p_bar), p_bar)).T.astype(np.float32))
        model.load_state_dict(state_dict_from_jax(v), strict=False)
    else:
        with torch.no_grad():
            calibrate_seg_head(model, torch.from_numpy(calib))
        w = model.fuse_dec.weight.detach().numpy()[:, :, 0, 0]
        v["params"]["fuse_dec"]["kernel"] = np.ascontiguousarray(w.T[None, None])
        v["params"]["fuse_dec"]["bias"] = model.fuse_dec.bias.detach().numpy().copy()
    return jm, v, model


def _assert_rows_agree(got, want, keys, atol):
    assert set(want) <= set(got)
    assert got["passed"] == want["passed"]
    assert got["gate"] == want["gate"]
    for k in keys:
        assert abs(got[k] - want[k]) <= atol, (k, got[k], want[k])


@pytest.fixture(scope="module")
def enc():
    return _pair("enc", 0)


@pytest.mark.parametrize("engine_mode", ["exact", "fast"])
def test_gate1_matches_jax(tree, enc, engine_mode):
    root, names, labels = tree
    jm, v, model = enc
    oracle = StandIn(copy.deepcopy(model))
    img = Image.open(get_img_path(names[3], root)).convert("RGB")
    lab = labels[names[3]]
    scales = (0.5, 1.0)
    want = JG.gate1_cam_single(jm, v, oracle, img, lab, scales, 64, engine_mode=engine_mode)
    got = G.gate1_cam_single(model, oracle, img, lab, scales, 64, engine_mode=engine_mode,
                             device="cpu")
    assert got["channels_compared"] == want["channels_compared"] > 0
    assert got["channels_degenerate"] == want["channels_degenerate"]
    _assert_rows_agree(got, want, ("max_abs_delta", "mean_abs_delta", "max_raw_delta"),
                       DELTA_ATOL)
    assert abs(got["score_delta"] - want["score_delta"]) <= SCORE_ATOL


def test_gate7_fast_matches_jax(tree, tmp_path):
    root, names, _ = tree
    calib = np.stack([color_norm(np.asarray(Image.open(get_img_path(n, root)).convert("RGB"))
                                 [:40, :40]) for n in names])
    jm, v, model = _pair("dec", 1, calib)
    oracle = StandIn(copy.deepcopy(model))
    scales = (0.75, 1.0)
    want = JG.gate7_seg_tta(jm, v, oracle, root, names[:2], str(tmp_path), scales, 64, 64)
    got = G.gate7_seg_tta(model, oracle, root, names[:2], str(tmp_path), scales, 64, 64,
                          device="cpu")
    assert got["classes_predicted"] == want["classes_predicted"]
    _assert_rows_agree(got, want, ("mIoU_ours", "mIoU_delta", "pixel_agreement",
                                   "mean_map_delta", "labels_agreement",
                                   "labels_agreement_min"), DELTA_ATOL)


class _LabelRefiner:
    """A refiner whose labels are fixed per image (the gate's seam)."""

    def __init__(self, labels):
        self.labels = labels

    def refine_image(self, img, cam):
        return self.labels[img.size]

    def to_png_labels(self, scores):
        return scores


def test_gate3_arithmetic_with_injected_oracle(tree, tmp_path):
    """The report of gate 3 from the port's own refiner and an injected
    oracle: agreeing labels pass with delta 0; the oracle's all-background
    labels fail, with mIoUs and agreement the confusion arithmetic gives."""
    from muscle_tpu_torch.evaluation import confusion_matrix, iou_from_confusion
    from muscle_tpu_torch.inference import RandomWalkRefiner
    from muscle_tpu_torch.models import EdgeDisplacement

    root, names, labels = tree
    cam_dir = tmp_path / "cams"
    cam_dir.mkdir()
    gts = {}
    for n in names[:3]:  # the fourth has no npy: gate 2 skipped it
        gt = np.array(Image.open(os.path.join(root, "SegmentationClass", n + ".png")))
        gts[n] = gt
        cam = {int(c): (gt == c + 1).astype(np.float16) for c in np.nonzero(labels[n])[0]}
        np.save(cam_dir / f"{n}.npy", cam)
    torch.manual_seed(0)
    refiner = RandomWalkRefiner(EdgeDisplacement(crop_size=64), crop_size=64, device="cpu")

    def ours(img, cam):
        return refiner.to_png_labels(refiner.refine_image(img, cam))

    row = G.gate3_irn_refine(root, names, str(cam_dir), refiner, ours)
    assert row["passed"] and row["mIoU_delta"] == 0 and row["pixel_agreement"] == 1.0
    assert set(row) == {"gate", "mIoU_ours", "mIoU_oracle", "mIoU_delta", "pixel_agreement",
                        "tolerance", "passed", "seconds"}

    # a refiner that returns the ground truth against an all-background oracle
    exact = _LabelRefiner({Image.open(get_img_path(n, root)).size: gts[n] for n in gts})
    row = G.gate3_irn_refine(root, names, str(cam_dir), exact,
                             lambda img, cam: np.zeros(img.size[::-1], np.uint8),
                             tag="_trained")
    def miou(pred):
        return iou_from_confusion(sum(confusion_matrix(pred(g), g, 21)
                                      for g in gts.values()))["mIoU"]

    best, bg = miou(lambda g: g), miou(np.zeros_like)
    assert row["gate"] == "3_irn_refine_miou_trained"
    assert row["mIoU_ours"] == round(best, 4) and row["mIoU_oracle"] == round(bg, 4)
    assert row["mIoU_delta"] == round(best - bg, 4) > 0.3 and not row["passed"]
    agree = np.mean([(g == 0).mean() for g in gts.values()])
    assert 0 < agree < 1 and row["pixel_agreement"] == round(float(agree), 4)


# ---- gates 4, 5 and 6 in the port alone ----------------------------------------

def _jax_row(fn):
    """(keys, criterion expression or None) of the dict a JAX gate returns,
    read from its source."""
    ret = [n for n in ast.walk(ast.parse(inspect.getsource(fn)))
           if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)][-1].value
    keys = {k.value for k in ret.keys}
    crit = [v for k, v in zip(ret.keys, ret.values) if k.value == "criterion"]
    return keys, (compile(ast.Expression(crit[0]), "criterion", "eval") if crit else None)


def _finite(row):
    for k, v in row.items():
        if isinstance(v, float):
            assert np.isfinite(v), k
    for v in row.get("grad_norms", {}).values():
        assert np.isfinite(v)


@pytest.mark.parametrize("gate", ["4", "5", "6"])
def test_training_gates_run_in_the_port(tree, tmp_path, gate):
    root, names, _ = tree
    labels_path = os.path.join(root, "cls_labels.npy")
    out = str(tmp_path)
    if gate == "4":
        row = G.gate4_train_mcl(root, names, labels_path, out, steps=4, min_decrease=0.10,
                                quick=True, device="cpu")
        jfn, env = JG.gate4_train_mcl, dict(min_decrease=0.10, steps=4, lr=1e-3)
        ckpts = [os.path.join(out, "gate4_session", "model_0.pth")]
    elif gate == "5":
        row = G.gate5_train_muscle(root, names, labels_path, out, steps=4, min_decrease=0.15,
                                   quick=True, device="cpu")
        jfn, env = JG.gate5_train_muscle, {}
        ckpts = [os.path.join(out, "gate5_session", "model_0.pth")]
    else:
        row = G.gate6_convergence(root, names, labels_path, out, steps=3, quick=True,
                                  device="cpu")
        jfn, env = JG.gate6_convergence, dict(quick=True, fullsize=False)
        ckpts = [os.path.join(out, "gate6_enc.pth"), os.path.join(out, "gate6_dec.pth")]
    keys, crit = _jax_row(jfn)
    assert keys <= set(row), keys - set(row)
    _finite(row)
    assert row.get("checkpoint", True) and all(os.path.exists(c) for c in ckpts)
    if crit is not None:
        assert row["criterion"] == eval(crit, {}, env)
    assert row["mbconv_launches"] == ({"cam_eval": 0, "seg_eval": 0} if gate == "6" else 0)
    sd = torch.load(ckpts[0], weights_only=True)
    assert "backbone._conv_stem.weight" in sd  # the reference's key names


def test_quick_tree_all_background_miou(tree):
    """The quick tier's tree scores 3.974 mIoU for a prediction of
    background everywhere: the floor under gate 6's seg row."""
    from muscle_tpu_torch.evaluation import confusion_matrix, iou_from_confusion

    root, names, _ = tree
    conf = sum(confusion_matrix(np.zeros_like(g), g, 21) for g in (
        np.asarray(Image.open(os.path.join(root, "SegmentationClass", n + ".png")))
        for n in names))
    assert round(iou_from_confusion(conf)["mIoU"], 3) == 3.974


# ---- the oracle builders over a stand-in reference tree ------------------------

# the reference tree's src package as the oracle builders use it: MuSCLe's
# constructor and call signature (over the port's model, whose keys are
# the reference's), the third-party imports the loader stubs, and the
# pretrained-weight download it turns off
_STAND_IN_SRC = '''
import cv2
import qpth.qp
import scipy.misc
import skimage.transform
import torchvision.transforms

import torch

from muscle_tpu_torch.models import MuSCLe as _Port, init_weights

from .efficientnet_pytorch import model as _model


class MuSCLe(_Port):
    def __init__(self, num_classes, pretrained, layers, MemoryEfficient, last_pooling, mode):
        super().__init__(num_classes=num_classes, backbone_name=pretrained,
                         bifpn_layers=layers, mode=mode, last_pooling=last_pooling)
        init_weights(self, torch.default_generator)  # seeded by the oracle builder
        _model.load_pretrained_weights(self, pretrained)

    def forward(self, x, cam="cam"):
        out = super().forward(x.permute(0, 2, 3, 1).contiguous(), mode=cam)
        if cam == "logits":
            return out
        nchw = lambda t: t.permute(0, 3, 1, 2)
        if cam == "seg":
            return nchw(out[0]), nchw(out[1])
        cams, sgc, emb, logits = out
        return nchw(cams), nchw(sgc), emb, logits
'''
_DOWNLOAD = '''
def load_pretrained_weights(*args, **kwargs):
    raise RuntimeError("the pretrained weights are a download")
'''


@pytest.fixture
def reference_tree(tmp_path, monkeypatch):
    """A stand-in reference tree; the modules, stubs and path entries the
    loader adds are taken away again afterwards."""
    import sys

    import scipy

    src = tmp_path / "reference" / "src"
    (src / "efficientnet_pytorch").mkdir(parents=True)
    (src / "__init__.py").write_text(_STAND_IN_SRC)
    (src / "efficientnet_pytorch" / "__init__.py").write_text("")
    for f in ("model.py", "utils.py"):
        (src / "efficientnet_pytorch" / f).write_text(_DOWNLOAD)
    monkeypatch.setattr(sys, "path", list(sys.path))
    before, had_misc = dict(sys.modules), "misc" in vars(scipy)
    yield str(src.parent)
    for k in set(sys.modules) - set(before):
        del sys.modules[k]
    sys.modules.update(before)
    if not had_misc:
        vars(scipy).pop("misc", None)


def test_oracle_builders_over_a_stand_in_reference_tree(reference_tree, tmp_path):
    """load_reference imports the tree's src with its third-party imports
    stubbed and its download off; make_oracle_muscle calibrates the
    oracle's random init and hands the port model its state dict;
    make_oracle_from_model carries a port model's back."""
    with pytest.raises(FileNotFoundError, match="no PyTorch reference tree"):
        G.load_reference(str(tmp_path / "nowhere"))
    for mode in ("enc", "dec"):
        tmodel, model = G.make_oracle_muscle("efficientnet-b1", mode,
                                             reference_root=reference_tree)
        assert type(tmodel).__module__ == "src" and not tmodel.training
        sd = tmodel.state_dict()
        # the calibration's train-mode forwards moved the BN statistics
        assert not torch.equal(sd["backbone._bn0.running_var"],
                               torch.ones_like(sd["backbone._bn0.running_var"]))
        assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
        with torch.no_grad():
            model.backbone._conv_stem.weight.mul_(2)
        back = G.make_oracle_from_model("efficientnet-b1", mode, 1, model,
                                        reference_root=reference_tree)
        assert all(torch.equal(v, back.state_dict()[k]) for k, v in model.state_dict().items())


def test_cli_oracle_gates_over_a_stand_in_reference_tree(reference_tree, tmp_path):
    """cli.gates builds the oracle from --reference_root and runs gates 1,
    1f and 7 against it; the stand-in oracle carries the port model's
    weights, so each row passes."""
    from muscle_tpu_torch.cli import gates as cli

    report = cli.main(["--synthetic", "--gates", "1,1f,7", "--scales", "0.5,1.0",
                       "--seg_scales", "0.75,1.0", "--reference_root", reference_tree,
                       "--out_dir", str(tmp_path / "g"), "--device", "cpu"])
    assert [r["gate"] for r in report] == ["1_cam_single_exact", "1_cam_single_fast",
                                           "7_seg_tta_miou_fast"]
    assert all(r["passed"] for r in report), report
    assert report[0]["channels_compared"] > 0 and report[2]["classes_predicted"] >= 1
