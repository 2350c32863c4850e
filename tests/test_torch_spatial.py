"""Spatial sharding (one image's height split over the ranks of a model
group, ``parallel/spatial.py``) on 4 CPU ranks over gloo
(tests/torch_spatial_ranks.py, one launch for every case: a 1 x 4 and a
2 x 2 mesh) against the port in one process and the JAX package's
``shard_spatial`` engines on its 8-device virtual mesh; and
``infer_mcl`` / ``infer_seg --spatial 2`` under ``torchrun`` with 2 ranks.

Tolerances: the halo convs are exact (integer-valued inputs and weights,
so every sum is exact in any order); the MBConv block and the backbone's
pyramid 1e-5 (the SE and resize sums add the stripes' partial sums in
another order); the engines at the JAX package's own sharded-vs-single
bounds (test_sharding.py): scores 1e-4, SGC maps 2e-4 away from the
fusion's zeroing (test_torch_cam.py), seg probabilities 1e-4; against the
JAX engines test_torch_cam.py's SCORE_ATOL / SGC_ATOL; the CLIs at the
JAX CLI test's 5e-3 (test_datasets_cli.py, --fast 1's uint8 download), seg
labels on 99.9% of the pixels.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import muscle_tpu.parallel as jpar
from muscle_tpu.convert import convert_muscle_state_dict
from muscle_tpu.inference import CamTTAEngine as JCamEngine
from muscle_tpu.inference import SegTTAEngine as JSegEngine
from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu_torch.cli import infer_mcl, infer_seg
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.data.transforms import color_norm
from muscle_tpu_torch.inference import CamTTAEngine, SegTTAEngine
from muscle_tpu_torch.models import MuSCLe, calibrate_seg_head, init_weights
from muscle_tpu_torch.models.efficientnet import BlockArgs, MBConvBlock
from muscle_tpu_torch.ops.mbconv import mbconv_stride1_plain
from muscle_tpu_torch.parallel import make_mesh

import torch_dp_ranks
import torch_spatial_ranks as ranks
from test_torch_cam import SCORE_ATOL, SGC_ATOL, _plain, _randomize_bn

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
EXACT_TOL = 1e-5  # the block and the pyramid: summation order
SPATIAL_SCORE_ATOL, SPATIAL_SGC_ATOL = 1e-4, 2e-4  # the JAX package's sharded-vs-single
PROBS_ATOL = 1e-4
CLI_SGC_ATOL, CLI_LABEL_AGREE = 5e-3, 0.999
# the JAX package's spatial tests' configurations (test_sharding.py)
CAM_KW = dict(scales=(0.5, 1.0), out_side=64, max_side=62, device_tta=True)
SEG_KW = dict(scales=(0.5, 1.0), out_side=64, max_side=56, device_tta=True)


def _cam_inputs():
    rng = np.random.default_rng(23)
    images = [rng.integers(0, 255, (44 + 4 * i, 40, 3), dtype=np.uint8) for i in range(4)]
    labels = []
    for i in range(4):
        lab = np.zeros(20, np.float32)
        lab[(3 * i) % 20] = 1.0
        labels.append(lab)
    return images, [f"i{i}" for i in range(4)], labels


def _seg_inputs():
    rng = np.random.default_rng(24)
    return [rng.integers(0, 255, (50, 40, 3), dtype=np.uint8) for _ in range(2)], ["a", "b"]


@pytest.fixture(scope="module")
def spec():
    """Every case's weights and inputs: the CAM model is the JAX b1's
    initialisation (key 5) with random batch norms near the identity, the
    seg model a seeded port b1 dec (BiFPN 1 layer) with its head
    calibrated so the labels vary."""
    jm = JMuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False)
    v = _plain(jm.init({"params": jax.random.key(5)}, jnp.zeros((1, 32, 32, 3)), mode="cam"))
    _randomize_bn(v["params"], v["batch_stats"], np.random.default_rng(5))
    seg = init_weights(MuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1,
                              fuse_mbconv=384), torch.Generator().manual_seed(6)).eval()
    seg_images, seg_names = _seg_inputs()
    with torch.inference_mode():
        calibrate_seg_head(seg, torch.from_numpy(np.stack([color_norm(im[:40, :40])
                                                           for im in seg_images])))
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    block = init_weights(MBConvBlock(BlockArgs(5, 1, 40, 40, 6, 1)), gen).eval()
    with torch.inference_mode():
        weights = block.fused_weights()
    images, names, labels = _cam_inputs()
    return {
        "jax_cam": (jm, v),
        "cam_state": state_dict_from_jax(v),
        "seg_state": seg.state_dict(),
        "halo": {"x": torch.from_numpy(rng.integers(-3, 4, (2, 32, 12, 6)).astype(np.float32)),
                 "w": {k: torch.from_numpy(rng.integers(-2, 3, (6, 1, k, k)).astype(np.float32))
                       for k in (3, 5)}},
        "mbconv": {"x": torch.randn((4, 16, 12, 40), generator=gen), "weights": weights, "k": 5,
                   "win": torch.tensor([[0, 0, 16, 12], [0, 0, 13, 10], [0, 0, 9, 12],
                                        [0, 0, 16, 5]], dtype=torch.int32)},
        "pyramid": {"x": torch.randn((4, 64, 48, 3), generator=gen),
                    "win": torch.tensor([[0, 0, 64, 48], [0, 0, 50, 40], [0, 0, 44, 48],
                                         [0, 0, 64, 30]], dtype=torch.int32)},
        "cam": {"images": images, "names": names, "labels": labels, "kw": CAM_KW},
        "seg": {"images": seg_images, "names": seg_names, "kw": SEG_KW},
    }


@pytest.fixture(scope="module")
def outs(spec, tmp_path_factory):
    """Each of the 4 ranks' results (tests/torch_spatial_ranks.py)."""
    sent = {k: v for k, v in spec.items() if k != "jax_cam"}
    return torch_dp_ranks.launch(ranks.checks, WORLD, tmp_path_factory.mktemp("spatial"), sent)


def _stripes_of(outs, key, n):
    """The whole result of the n-stripe groups (every group's, checked
    equal), from each rank's stripe of ``key``."""
    groups = [outs[g * n: (g + 1) * n] for g in range(WORLD // n)]
    whole = [torch.cat([key(o) for o in grp], dim=1) for grp in groups]
    for w in whole[1:]:
        assert torch.equal(w, whole[0])
    return whole[0]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_halo_exchange_convs_equal_the_whole_image(spec, outs, n, stride, k):
    d = spec["halo"]
    want = ranks.halo_conv(d["x"], d["w"][k], stride)
    got = _stripes_of(outs, lambda o: o["halo"][(n, stride, k)], n)
    assert torch.equal(got, want)


def test_mbconv_plain_owned_rows_match_one_process(spec, outs):
    """b1's _blocks_6 shape (k 5, Cin 40, Cmid 240) with windows, 2 stripes
    of 8 rows: the stripes' SE sums added over the group."""
    d = spec["mbconv"]
    with torch.inference_mode():
        want = mbconv_stride1_plain(d["x"], d["weights"], d["win"], k=5, has_expand=True,
                                    has_skip=True)
    got = _stripes_of(outs, lambda o: o["mbconv"], 2)
    torch.testing.assert_close(got, want, atol=EXACT_TOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_mbconv_stages_on_stripes_in_one_process(spec, n):
    """The wrapper's two stages (``mbconv_stride1_begin`` / ``_end``, the
    plain version's on the CPU) on n stripes in one process, the SE
    partials summed by hand between them, as chip_smoke.py checks the
    kernel: the stripes' rows equal the whole block within 1e-5."""
    from test_torch_kernels_cuda import stripes_by_hand

    d = spec["mbconv"]
    kw = dict(k=5, has_expand=True, has_skip=True)
    with torch.inference_mode():
        want = mbconv_stride1_plain(d["x"], d["weights"], d["win"], **kw)
        got = stripes_by_hand(d["x"], d["weights"], d["win"], kw, n)
    torch.testing.assert_close(got, want, atol=EXACT_TOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fuse", [0, 384])
def test_backbone_pyramid_matches_one_process(spec, outs, n, fuse):
    """b1 enc with windows on a 64 x 48 canvas: every level whole or in
    stripes (on 4 ranks the stride-8 stripes hold 2 rows and the level is
    gathered before the next stride-2 conv); fuse 384 takes the MBConv
    block's plain version with the owned-row SE, fuse 0 the plain layers."""
    d = spec["pyramid"]
    with torch.inference_mode():
        want = ranks.cam_model(spec["cam_state"], fuse).backbone(d["x"], valid_window=d["win"])
    gathered = False
    for i, w in enumerate(want):
        got = [o["pyramid"][(n, fuse)][i] for o in outs]
        if got[0].shape == w.shape:  # whole on every rank
            gathered = True
            for g in got:
                torch.testing.assert_close(g, w, atol=EXACT_TOL, rtol=0)
        else:
            assert not gathered
            torch.testing.assert_close(_stripes_of(outs, lambda o: o["pyramid"][(n, fuse)][i],
                                                   n), w, atol=EXACT_TOL, rtol=0)
    assert gathered == (n == 4)


def _fused_close(got, want, atol, what, f16_step: bool = False):
    """test_torch_cam.py's rule at ``atol``: maps agree away from the
    fusion's pre-normalisation zeroing, which flips on at most 1% of the
    pixels, and the zeroed value within 1e-2 relative.  f16_step: a pixel
    may instead be one float16 step apart (4.9e-4 at [0.5, 1), above
    2e-4): the download rounds two float32 values within rounding noise of
    each other to neighbouring float16 values.  One process against itself
    on 1 and 4 CPU threads rounds 6.2% of the pixels of one of this test's
    maps apart so (its range is 0.39: ~3e-7 of float32 noise)."""
    zg, zw = got == got.min(), want == want.min()
    assert (zg != zw).mean() <= 0.01, what
    keep = ~(zg | zw)
    g, w = got[keep], want[keep]
    tol = np.full(g.shape, atol, np.float32)
    if f16_step:
        step = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float16))
        tol = np.maximum(tol, step.astype(np.float32))
    np.testing.assert_array_less(np.abs(g - w), tol * 1.001, err_msg=what)
    np.testing.assert_allclose(got.min(), want.min(), rtol=1e-2, atol=atol, err_msg=what)


def _assert_cam_close(got, want, score_atol, sgc_atol, what, f16_step=False):
    assert [g["name"] for g in got] == [w["name"] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["score"], w["score"], atol=score_atol, err_msg=what)
        assert sorted(g["sgc"]) == sorted(w["sgc"]) and len(g["sgc"]) == 1
        for c in w["sgc"]:
            a, b = (np.asarray(m[c], np.float32) for m in (g["sgc"], w["sgc"]))
            assert a.shape == b.shape and np.isfinite(a).all()
            _fused_close(a, b, sgc_atol, f"{what} {g['name']} class {c}", f16_step)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_cam_engine_spatial_matches_one_process(spec, outs, mesh):
    """JAX's test_cam_engine_spatial_sharded_matches_single's configuration
    (b1 enc, 4 images of 44-56 x 40, scales 0.5 and 1), every rank given
    the whole batch: every rank returns the whole batch's records (on the
    2 x 2 mesh each data row ran its half and the halves were gathered),
    held to one process on the same rows."""
    d = spec["cam"]
    one = CamTTAEngine(ranks.cam_model(spec["cam_state"]), device="cpu", **CAM_KW)
    if mesh == "1x4":
        want = one.run_batch(d["images"], d["names"], d["labels"])
    else:
        want = one.run_batch(d["images"][:2], d["names"][:2], d["labels"][:2]) + \
            one.run_batch(d["images"][2:], d["names"][2:], d["labels"][2:])
    recs = [o[f"cam_{mesh}"] for o in outs]
    for r in recs[1:]:  # every rank holds the same records
        _assert_cam_close(r, recs[0], 1e-6, 1e-6, f"{mesh} ranks")
    _assert_cam_close(recs[0], want, SPATIAL_SCORE_ATOL, SPATIAL_SGC_ATOL, mesh, f16_step=True)
    stats = outs[0]["cam_1x4_stats"]
    assert stats["halo"]["calls"] > 0 and stats["sum"]["calls"] > 0


def test_cam_engine_spatial_matches_jax(spec, outs):
    """The 1 x 4 run against the JAX package's CamTTAEngine(mesh=
    make_mesh(model_axis=4), shard_spatial=True) on its 2 x 4 virtual mesh."""
    jm, v = spec["jax_cam"]
    d = spec["cam"]
    want = JCamEngine(jm, v, mesh=jpar.make_mesh(model_axis=4), shard_spatial=True,
                      **CAM_KW).run_batch([Image.fromarray(im) for im in d["images"]],
                                          d["names"], d["labels"])
    _assert_cam_close(outs[0]["cam_1x4"], want, SCORE_ATOL, SGC_ATOL, "vs JAX")


def test_seg_engine_spatial_matches_one_process_and_jax(spec, outs):
    """JAX's test_seg_engine_spatial_sharded_matches_single's configuration
    (b1 dec, BiFPN 1 layer, 2 images of 50 x 40, scales 0.5 and 1) on the
    1 x 4 mesh: the stride-32 level's stripes would hold 1 row, so the
    stride-16 level is gathered; held to one process and to the JAX
    package's sharded engine."""
    d = spec["seg"]
    model = ranks.seg_model(spec["seg_state"])
    one = SegTTAEngine(model, device="cpu", **SEG_KW).run_batch(d["images"], d["names"])
    jm = JMuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1)
    v = convert_muscle_state_dict({k: t.numpy() for k, t in spec["seg_state"].items()
                                   if "num_batches_tracked" not in k})
    jx = JSegEngine(jm, v, mesh=jpar.make_mesh(model_axis=4), shard_spatial=True,
                    **SEG_KW).run_batch([Image.fromarray(im) for im in d["images"]], d["names"])
    for o in outs:
        for g, w, j in zip(o["seg_1x4"], one, jx):
            assert g["name"] == w["name"] == j["name"]
            assert g["probs"].shape == (50, 40, 21)
            np.testing.assert_allclose(g["probs"], w["probs"], atol=PROBS_ATOL)
            np.testing.assert_allclose(g["probs"], j["probs"], atol=PROBS_ATOL)
    labels = np.concatenate([g["probs"].argmax(-1).ravel() for g in outs[0]["seg_1x4"]])
    assert len(np.unique(labels)) > 1


def test_spatial_errors(spec, outs):
    """The JAX engines' errors (test_shard_spatial_requires_model_axis), what
    the port does not run under shard_spatial, and what builds as JAX's
    engines do: bf16 under shard_spatial (stripes), a mesh alone (no
    stripes: the in-process data-parallel engine)."""
    model = ranks.cam_model(spec["cam_state"])
    with pytest.raises(ValueError, match="requires a mesh"):
        CamTTAEngine(model, shard_spatial=True, device="cpu")
    with pytest.raises(ValueError, match="model_axis>1"):
        CamTTAEngine(model, mesh=make_mesh(), shard_spatial=True, device="cpu")
    with pytest.raises(ValueError, match="not divisible by model axis 2"):
        make_mesh(model_axis=2)  # one process
    with pytest.raises(ValueError, match="requires a mesh"):
        SegTTAEngine(ranks.seg_model(spec["seg_state"]), shard_spatial=True, device="cpu")
    assert outs[0]["built"] == {"bf16": (torch.bfloat16, True),
                                "data_mesh": (torch.float32, False)}
    errors = outs[0]["errors"]
    assert set(errors) == {"exact", "host"}
    assert errors["exact"][0] == errors["host"][0] == "ValueError"
    assert [o["coords"] for o in outs] == [{4: (0, r), 2: (r // 2, r % 2)} for r in range(4)]


# ---- the CLIs under torchrun ------------------------------------------------------


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory, spec):
    """Four images (three landscape, one portrait), cls_labels, and the CAM
    (enc) and seg (dec) checkpoints of ``spec``."""
    root = tmp_path_factory.mktemp("voc")
    os.makedirs(root / "JPEGImages")
    rng = np.random.default_rng(0)
    names = [f"2007_{i:06d}" for i in range(4)]
    labels = {}
    for i, n in enumerate(names):
        h, w = (60 + 4 * i, 80 - 4 * i) if i < 3 else (76, 52)
        yy, xx = np.linspace(0, 1, h)[:, None, None], np.linspace(0, 1, w)[None, :, None]
        mix = rng.uniform(-1, 1, (2, 3))
        img = 127.5 + 100 * (yy * mix[0] + xx * mix[1]) + rng.normal(0, 8, (h, w, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        lab = np.zeros(20, np.float32)
        lab[[0, 7, 11, 14][i]] = 1
        labels[n] = lab
    (root / "list.txt").write_text("\n".join(names) + "\n")
    np.save(root / "cls_labels.npy", labels)
    torch.save(spec["cam_state"], root / "cam.pth")
    torch.save(spec["seg_state"], root / "seg.pth")
    return root, names


def _torchrun(module: str, args: list, cwd, nproc: int = 2) -> str:
    """``torchrun --standalone --nproc_per_node <nproc> -m <module> <args>``;
    returns its stdout."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(nproc), "-m", module, *args], cwd=str(cwd), env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_infer_mcl_spatial_2_writes_the_one_process_files(mini_voc, tmp_path):
    """``infer_mcl --spatial 2`` (its defaults: --fast 1) on 2 ranks, one
    model group: rank 0 writes the SGC dicts, which are one process's
    within the JAX CLI test's 5e-3; each rank reports its exchanges."""
    root, names = mini_voc
    args = ["--weights", str(root / "cam.pth"), "--infer_list", str(root / "list.txt"),
            "--voc12_root", str(root), "--cls_labels", str(root / "cls_labels.npy"),
            "--backbone", "efficientnet-b1", "--scales", "0.5,1", "--batch_size", "4",
            "--device", "cpu", "--num_workers", "1"]
    infer_mcl.main(args + ["--out_npy", str(tmp_path / "one")])
    stdout = _torchrun("muscle_tpu_torch.cli.infer_mcl",
                       args + ["--out_npy", str(tmp_path / "two"), "--spatial", "2"], tmp_path)
    assert stdout.count('"mesh": {"data": 1, "model": 2}') == 2
    for n in names:
        a = np.load(tmp_path / "one_sgc" / f"{n}.npy", allow_pickle=True).item()
        b = np.load(tmp_path / "two_sgc" / f"{n}.npy", allow_pickle=True).item()
        assert sorted(a) == sorted(b)
        for c in a:
            _fused_close(b[c].astype(np.float32), a[c].astype(np.float32), CLI_SGC_ATOL, n)


def test_infer_seg_spatial_2_writes_the_one_process_pngs(mini_voc, tmp_path):
    """``infer_seg --spatial 2 --crf 0`` (--fast 1: labels on the device) on
    2 ranks: rank 0 writes the PNGs, equal to one process's on 99.9% of
    each image's pixels."""
    root, names = mini_voc
    args = ["--weights", str(root / "seg.pth"), "--infer_list", str(root / "list.txt"),
            "--voc12_root", str(root), "--cls_labels", str(root / "cls_labels.npy"),
            "--pretrained", "b1", "--bifpn", "1", "--crf", "0", "--batch_size", "2",
            "--device", "cpu", "--num_workers", "1"]
    infer_seg.main(args + ["--out_seg", str(tmp_path / "one")])
    _torchrun("muscle_tpu_torch.cli.infer_seg",
              args + ["--out_seg", str(tmp_path / "two"), "--spatial", "2"], tmp_path)
    seen = set()
    for n in names:
        a = np.asarray(Image.open(tmp_path / "one" / f"{n}.png"))
        b = np.asarray(Image.open(tmp_path / "two" / f"{n}.png"))
        assert a.shape == b.shape
        assert (a == b).mean() >= CLI_LABEL_AGREE, n
        seen |= set(np.unique(a).tolist())
    assert len(seen) > 1
