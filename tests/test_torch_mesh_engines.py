"""The engines' ``mesh=`` as the JAX engines take it, on CPU ranks over gloo
(tests/torch_mesh_ranks.py: one launch of 2 ranks, one of 4), against the
port in one process and the JAX package's engines on its 8-device virtual
mesh:

* the in-process data-parallel engine (``make_mesh()``): every rank passes
  the same global batch and returns the whole batch's records, the same
  on every rank bit for bit, for batches the data rows divide (each row
  runs its share) and do not (every rank runs it whole, as JAX
  replicates); held to one process (f32) and to JAX's
  ``CamTTAEngine`` / ``SegTTAEngine(mesh=make_mesh())`` on
  tests/test_sharding.py's configurations;
* bf16 under ``shard_spatial`` on 2 and 4 stripes (1 x 2, 1 x 4, 2 x 2):
  held to the one-process bf16 engine and to JAX's sharded bf16 engines
  by PERF.md's bf16 rules; the owned-row plain bf16 MBConv block on 2 and
  4 stripes against the whole block;
* the f32 2 x 2 mesh (data rows and stripes) against one process and JAX's
  2 x 4 (the CLIs on it: test_torch_cli_mesh.py);
* the seg engine at lowres=False, window_exact=False on the data mesh and
  under shard_spatial on 1 x 2, 1 x 4 and 2 x 2, and at each switch alone
  on 1 x 2, against one process at the same switches; at
  window_exact=False, a batch of landscape and portrait images on the data
  mesh (device and host paths) and the 2 x 2, against one process on the
  whole batch.

Tolerances: one process vs the data mesh, f32: equal to one process on
each data row's share (the whole batch where every rank ran it), and to
one process on the whole batch within test_torch_spatial.py's bounds
(scores 1e-4, SGC maps 2e-4 away from the fusion's zeroing or one float16
step; probabilities test_sharding.py's 1e-5);
against JAX test_torch_cam.py's SCORE_ATOL / SGC_ATOL and 1e-4 for
probabilities; the striped f32 records test_torch_spatial.py's bounds.
bf16 (PERF.md section 2): scores within 1e-2, each SGC map's mean |diff|
within 5e-3 or twice its own bf16-vs-f32 distance, seg labels on 99% of
the pixels whose f32 top-two margin exceeds 1e-2 or disagreeing there on
at most twice the reference's own bf16-vs-f32 share; the owned-row block
within 2^-7 of its output's largest value."""

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
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.data.transforms import color_norm
from muscle_tpu_torch.inference import CamTTAEngine, SegTTAEngine
from muscle_tpu_torch.models import MuSCLe, calibrate_seg_head, init_weights
from muscle_tpu_torch.models.efficientnet import BlockArgs, MBConvBlock
from muscle_tpu_torch.ops.mbconv import mbconv_stride1_plain

import torch_dp_ranks
import torch_mesh_ranks as ranks
import torch_spatial_ranks
from test_torch_cam import SCORE_ATOL, SGC_ATOL, _plain, _randomize_bn
from test_torch_kernels_cuda import stripes_by_hand
from test_torch_spatial import PROBS_ATOL as SPATIAL_PROBS_ATOL
from test_torch_spatial import SPATIAL_SCORE_ATOL, SPATIAL_SGC_ATOL, _fused_close

BF16 = torch.bfloat16
DP_PROBS_ATOL = 1e-5  # test_sharding.py's
JAX_PROBS_ATOL = 1e-4
# PERF.md section 2's bf16 rules
BF16_SCORE_TOL, BF16_SGC_TOL, BF16_SGC_REL = 1e-2, 5e-3, 2.0
BF16_MARGIN, BF16_LABEL_AGREE, BF16_REL = 1e-2, 0.99, 2.0 ** -7
# tests/test_sharding.py's engine configurations
CAM_KW = dict(scales=(0.5, 1.0), out_side=64, max_side=62, device_tta=True)
SEG_KW = dict(scales=(0.5, 1.0), out_side=64, max_side=56, device_tta=True)
# the mixed seg batch: two landscape images then two portrait ones, so each
# data row's own canvas at scale 1 (64 x 128, 128 x 64) is not the whole
# batch's (128 x 128)
SEG_MIXED_KW = dict(SEG_KW, out_side=128, max_side=72)
SEG_MIXED_SIZES = [(40, 72), (44, 70), (72, 40), (70, 44)]


@pytest.fixture(scope="module")
def spec():
    """The CAM model: the JAX b1 enc's initialisation (key 3, test_sharding.py's)
    with random batch norms near the identity; the seg model: a seeded port
    b1 dec (BiFPN 1) with its head calibrated so labels vary; the batches of
    test_sharding.py's mesh tests (8 CAM images of 48-62 x 40, seg images
    of 50 x 40), of which the tests take the first 3 or 4 (CAM), 2 or 3
    (seg); the mixed seg batch of SEG_MIXED_SIZES."""
    jm = JMuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False)
    v = _plain(jm.init({"params": jax.random.key(3)}, jnp.zeros((1, 32, 32, 3)), mode="cam"))
    _randomize_bn(v["params"], v["batch_stats"], np.random.default_rng(3))
    rng = np.random.default_rng(21)
    cam_images = [rng.integers(0, 255, (48 + 2 * i, 40, 3), dtype=np.uint8) for i in range(8)]
    labels = []
    for i in range(8):
        lab = np.zeros(20, np.float32)
        lab[i % 20] = 1.0
        labels.append(lab)
    rng = np.random.default_rng(22)
    seg_images = [rng.integers(0, 255, (50, 40, 3), dtype=np.uint8) for _ in range(3)]
    mixed = [rng.integers(0, 255, hw + (3,), dtype=np.uint8) for hw in SEG_MIXED_SIZES]
    seg = init_weights(MuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1,
                              fuse_mbconv=384), torch.Generator().manual_seed(6)).eval()
    with torch.inference_mode():
        calibrate_seg_head(seg, torch.from_numpy(np.stack([color_norm(im[:40, :40])
                                                           for im in seg_images])))
    return {"jax_cam": (jm, v), "cam_state": state_dict_from_jax(v),
            "seg_state": seg.state_dict(), "cam_kw": CAM_KW, "seg_kw": SEG_KW,
            "cam": {"images": cam_images, "names": [f"i{i}" for i in range(8)],
                    "labels": labels},
            "seg": {"images": seg_images, "names": ["a", "b", "c"]},
            "seg_mixed": {"images": mixed, "names": ["l0", "l1", "p0", "p1"]},
            "seg_mixed_kw": SEG_MIXED_KW}


def _sent(spec):
    return {k: v for k, v in spec.items() if k != "jax_cam"}


@pytest.fixture(scope="module")
def outs2(spec, tmp_path_factory):
    return torch_dp_ranks.launch(ranks.checks2, 2, tmp_path_factory.mktemp("mesh2"), _sent(spec))


@pytest.fixture(scope="module")
def outs4(spec, tmp_path_factory):
    return torch_dp_ranks.launch(ranks.checks4, 4, tmp_path_factory.mktemp("mesh4"), _sent(spec))


def _one(spec, compute_dtype=torch.float32):
    """The one-process CAM and seg engines."""
    return (CamTTAEngine(torch_spatial_ranks.cam_model(spec["cam_state"]), device="cpu",
                         compute_dtype=compute_dtype, **CAM_KW),
            SegTTAEngine(torch_spatial_ranks.seg_model(spec["seg_state"]), device="cpu",
                         compute_dtype=compute_dtype, **SEG_KW))


def _jax(spec, dtype=jnp.float32, **kw):
    """The JAX package's CAM and seg engines on the same weights."""
    jm, v = spec["jax_cam"]
    jcam = JMuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False, dtype=dtype)
    jseg = JMuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1, dtype=dtype)
    sv = convert_muscle_state_dict({k: t.numpy() for k, t in spec["seg_state"].items()
                                    if "num_batches_tracked" not in k})
    return (JCamEngine(jcam, v, compute_dtype=dtype, **CAM_KW, **kw),
            JSegEngine(jseg, sv, compute_dtype=dtype, **SEG_KW, **kw))


def _cam_batch(spec, n):
    d = spec["cam"]
    return d["images"][:n], d["names"][:n], d["labels"][:n]


def _seg_batch(spec, n):
    d = spec["seg"]
    return d["images"][:n], d["names"][:n]


def _pil(batch):
    return ([Image.fromarray(im) for im in batch[0]],) + tuple(batch[1:])


def _identical(recs: list, key: str) -> None:
    """Every rank's records equal rank 0's, bit for bit."""
    for r in recs[1:]:
        assert [g["name"] for g in r] == [w["name"] for w in recs[0]]
        for g, w in zip(r, recs[0]):
            if key == "sgc":
                np.testing.assert_array_equal(g["score"], w["score"])
                assert sorted(g["sgc"]) == sorted(w["sgc"])
                for c in w["sgc"]:
                    np.testing.assert_array_equal(g["sgc"][c], w["sgc"][c])
            else:
                np.testing.assert_array_equal(g[key], w[key])


def _cam_close(got, want, score_atol, sgc_atol, what, f16_step=False):
    assert [g["name"] for g in got] == [w["name"] for w in want], what
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["score"], w["score"], atol=score_atol, err_msg=what)
        assert sorted(g["sgc"]) == sorted(w["sgc"]), what
        for c in w["sgc"]:
            a, b = (np.asarray(m[c], np.float32) for m in (g["sgc"], w["sgc"]))
            assert a.shape == b.shape and np.isfinite(a).all(), what
            _fused_close(a, b, sgc_atol, f"{what} {g['name']} class {c}", f16_step)


# ---- the data-parallel mesh (2 ranks, make_mesh()) ------------------------------------


@pytest.mark.parametrize("n", [4, 3])
def test_data_mesh_cam_matches_one_process_and_jax(spec, outs2, n):
    """A batch of 4 splits 2 + 2 over the data rows, a batch of 3 runs whole
    on both ranks; every rank returns the 4 (3) records."""
    recs = [o["cam"][n] for o in outs2]
    _identical(recs, "sgc")
    one, _ = _one(spec)
    batch = _cam_batch(spec, n)
    want = one.run_batch(*batch)
    if n == 3:  # every rank ran one process's batch
        _identical([want, recs[0]], "sgc")
    else:  # each data row ran one process's half of it
        halves = one.run_batch(*[p[:2] for p in batch]) + one.run_batch(*[p[2:] for p in batch])
        _identical([halves, recs[0]], "sgc")
    # a half batch runs other CPU convolution kernels than the whole: float32
    # noise, which the fusion's min-max normalisation amplifies and which can
    # round a map's float16 download one step apart (test_torch_spatial.py)
    _cam_close(recs[0], want, SPATIAL_SCORE_ATOL, SPATIAL_SGC_ATOL, f"data mesh, batch {n}",
               f16_step=True)
    jcam, _ = _jax(spec, mesh=jpar.make_mesh())
    _cam_close(recs[0], jcam.run_batch(*_pil(_cam_batch(spec, n))), SCORE_ATOL, SGC_ATOL,
               f"data mesh vs JAX, batch {n}")
    assert [o["coords"] for o in outs2] == [[(0, 0), (0, 0)], [(1, 0), (0, 1)]]


@pytest.mark.parametrize("n", [2, 3])
def test_data_mesh_seg_matches_one_process_and_jax(spec, outs2, n):
    recs = [o["seg"][n] for o in outs2]
    _identical(recs, "probs")
    _, one = _one(spec)
    want = one.run_batch(*_seg_batch(spec, n))
    _, jseg = _jax(spec, mesh=jpar.make_mesh())
    jwant = jseg.run_batch(*_pil(_seg_batch(spec, n)))
    labels = set()
    for g, w, j in zip(recs[0], want, jwant):
        assert g["name"] == w["name"] == j["name"] and g["probs"].shape == (50, 40, 21)
        if n == 3:
            np.testing.assert_array_equal(g["probs"], w["probs"])
        np.testing.assert_allclose(g["probs"], w["probs"], atol=DP_PROBS_ATOL)
        np.testing.assert_allclose(g["probs"], j["probs"], atol=JAX_PROBS_ATOL)
        labels |= set(np.unique(g["probs"].argmax(-1)).tolist())
    assert len(labels) > 1


def test_data_mesh_stream_and_async_gather_every_batch(outs2):
    """run_stream over the batches of 4 and 3, and run_batch_async on the
    batch of 4, return what run_batch returns, on every rank."""
    for o in outs2:
        for got, want in zip(o["cam_stream"] + [o["cam_async"]],
                             [o["cam"][4], o["cam"][3], o["cam"][4]]):
            _identical([want, got], "sgc")
        for got, want in zip(o["seg_stream"], [o["seg"][2], o["seg"][3]]):
            _identical([want, got], "probs")


@pytest.mark.parametrize("case", ["data-both_off", "1x2-both_off", "1x4-both_off",
                                  "2x2-both_off", "1x2-lowres_off", "1x2-window_off"])
def test_seg_switches_off_on_meshes_match_one_process(spec, outs2, outs4, case):
    """The seg switches away from their defaults on the data mesh (each row
    runs one image) and under shard_spatial on 1 x 2 (each switch), 1 x 4
    and 2 x 2 (each rank a stripe; without windows the whole canvas is the
    window): every rank returns the whole batch's probabilities, held to
    one process's engine at the same switches; window_exact=False moved
    them from the default engine's."""
    mesh, switches = case.split("-")
    outs = outs2 if mesh in ("data", "1x2") else outs4
    recs = [o["seg_switches"][case] for o in outs]
    _identical(recs, "probs")
    one = SegTTAEngine(torch_spatial_ranks.seg_model(spec["seg_state"]), device="cpu",
                       **ranks.SWITCHES[switches], **SEG_KW)
    want = one.run_batch(*_seg_batch(spec, 2))
    atol = DP_PROBS_ATOL if mesh == "data" else SPATIAL_PROBS_ATOL
    for g, w, d in zip(recs[0], want, outs2[0]["seg"][2]):
        assert g["name"] == w["name"] and g["probs"].shape == (50, 40, 21)
        np.testing.assert_allclose(g["probs"], w["probs"], atol=atol)
        if switches != "lowres_off":
            assert np.abs(g["probs"] - d["probs"]).max() > 1e-3


@pytest.mark.parametrize("case", ["data", "data_host", "2x2"])
def test_seg_unwindowed_mesh_rows_share_the_batch_canvas(spec, outs2, outs4, case):
    """window_exact=False on the mixed batch (landscape images on data row
    0, portrait on row 1) on the data mesh, through the device and the host
    paths, and on the 2 x 2 under shard_spatial: every row runs on the
    whole batch's canvases, so each rank's probabilities equal one
    process's on the whole batch (1e-5; the stripes' bound on the 2 x 2).
    A row's share run alone, on its own canvases, moves them by more than
    twice that bound, so the check sees a row that sized its own."""
    outs = outs4 if case == "2x2" else outs2
    recs = [o["seg_mixed"][case] for o in outs]
    _identical(recs, "probs")
    kw = dict(SEG_MIXED_KW, window_exact=False, device_tta=case != "data_host")
    one = SegTTAEngine(torch_spatial_ranks.seg_model(spec["seg_state"]), device="cpu", **kw)
    d = spec["seg_mixed"]
    want = one.run_batch(d["images"], d["names"])
    alone = (one.run_batch(d["images"][:2], d["names"][:2])
             + one.run_batch(d["images"][2:], d["names"][2:]))
    atol = SPATIAL_PROBS_ATOL if case == "2x2" else DP_PROBS_ATOL
    for g, w, a, hw in zip(recs[0], want, alone, SEG_MIXED_SIZES):
        assert g["name"] == w["name"] and g["probs"].shape == hw + (21,)
        np.testing.assert_allclose(g["probs"], w["probs"], atol=atol)
        assert np.abs(a["probs"] - w["probs"]).max() > 2 * atol, g["name"]


# ---- bf16 under shard_spatial --------------------------------------------------------


def _bf16_cam_check(got, want16, want32, what):
    """PERF.md's bf16 CAM rule: scores within 1e-2; each SGC map's mean
    |diff| away from the fusion's zeroing within 5e-3 or twice the
    reference's own bf16-vs-f32 distance on that map."""
    assert [g["name"] for g in got] == [w["name"] for w in want16]
    for g, w, w32 in zip(got, want16, want32):
        assert np.abs(g["score"] - w["score"]).max() <= BF16_SCORE_TOL, what
        assert sorted(g["sgc"]) == sorted(w["sgc"])
        for c in w["sgc"]:
            a, b, f = (np.asarray(m["sgc"][c], np.float32) for m in (g, w, w32))
            assert a.shape == b.shape and np.isfinite(a).all()
            keep = ~((a == a.min()) | (b == b.min()))
            # a map with no pixel above its minimum (a class the random
            # net never activates) is held whole
            err = float(np.abs((a - b)[keep] if keep.any() else a - b).mean())
            own = float(np.abs(b - f).mean())
            assert err <= max(BF16_SGC_TOL, BF16_SGC_REL * own), (what, g["name"], c, err, own)


def _bf16_seg_check(got, want16, want32, what):
    """PERF.md's bf16 seg rule, as the card's bf16 phase holds it: on the
    pixels whose f32 top-two probability margin exceeds 1e-2 the labels
    agree on 99%, or disagree on at most twice what the reference's bf16
    labels disagree with its f32 ones there (a random net on noise images:
    JAX's own bf16 labels differ from its f32 ones on 2-6% of them)."""
    for g, w, p in zip(got, want16, want32):
        assert g["name"] == w["name"] and g["probs"].shape == w["probs"].shape
        assert np.isfinite(g["probs"]).all()
        top2 = np.sort(p["probs"], axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > BF16_MARGIN
        assert clear.mean() > 0.5
        lab, wlab, flab = (r["probs"].argmax(-1) for r in (g, w, p))
        agree, own = ((a == b)[clear].mean() for a, b in ((lab, wlab), (wlab, flab)))
        floor = 1 - max(1 - BF16_LABEL_AGREE, BF16_SGC_REL * (1 - own))
        assert agree >= floor, (what, g["name"], float(agree), float(own))


@pytest.fixture(scope="module")
def one_bf16(spec):
    """One process's f32 and bf16 records of the CAM batch of 4 and the seg
    batch of 2."""
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", BF16)):
        cam, seg = _one(spec, dtype)
        out[name] = {"cam": cam.run_batch(*_cam_batch(spec, 4)),
                     "seg": seg.run_batch(*_seg_batch(spec, 2))}
    return out


@pytest.mark.parametrize("mesh", ["1x2", "1x4", "2x2"])
def test_bf16_spatial_matches_one_process(one_bf16, outs2, outs4, mesh):
    """Every rank returns the whole batch's bf16 records, the same on every
    rank, held to one process's bf16 engine by the bf16 rules; the bf16 run
    moved from f32 (bf16 really ran)."""
    outs = outs2 if mesh == "1x2" else outs4
    recs = [o[f"bf16_{mesh}"] for o in outs]
    _identical([r["cam"] for r in recs], "sgc")
    _identical([r["seg"] for r in recs], "probs")
    _bf16_cam_check(recs[0]["cam"], one_bf16["bf16"]["cam"], one_bf16["f32"]["cam"], mesh)
    _bf16_seg_check(recs[0]["seg"], one_bf16["bf16"]["seg"], one_bf16["f32"]["seg"], mesh)
    moved = max(float(np.abs(g["probs"] - w["probs"]).max())
                for g, w in zip(recs[0]["seg"], one_bf16["f32"]["seg"]))
    assert moved > 1e-3


def test_bf16_spatial_matches_jax(spec, outs4):
    """The 1 x 4 bf16 records against the JAX package's
    ``CamTTAEngine`` / ``SegTTAEngine(compute_dtype=jnp.bfloat16,
    mesh=make_mesh(model_axis=4), shard_spatial=True)`` on its 2 x 4
    virtual mesh, each map's own distance JAX's sharded bf16 from its f32."""
    got = outs4[0]["bf16_1x4"]
    kw = dict(mesh=jpar.make_mesh(model_axis=4), shard_spatial=True)
    jcam16, jseg16 = _jax(spec, jnp.bfloat16, **kw)
    jcam32, jseg32 = _jax(spec, **kw)
    cam, seg = _pil(_cam_batch(spec, 4)), _pil(_seg_batch(spec, 2))
    _bf16_cam_check(got["cam"], jcam16.run_batch(*cam), jcam32.run_batch(*cam), "vs JAX")
    _bf16_seg_check(got["seg"], jseg16.run_batch(*seg), jseg32.run_batch(*seg), "vs JAX")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("block", ["b1_blocks_6", "b1_blocks_1"])
def test_bf16_owned_rows_plain_block(n, block):
    """The plain bf16 block in two stages on n stripes of a windowed image
    (each with its k//2 halo rows, the SE partials of its own rows, summed
    over the stripes in f32 between the stages: ``stripes_by_hand``)
    against ``mbconv_stride1_plain`` at bf16 on the whole image."""
    (k, cin, cout, expand), shape = {"b1_blocks_6": ((5, 40, 40, 6), (4, 16, 12)),
                                     "b1_blocks_1": ((3, 16, 16, 1), (2, 32, 20))}[block]
    gen = torch.Generator().manual_seed(0)
    wd = init_weights(MBConvBlock(BlockArgs(k, 1, cin, cout, expand, 1)), gen).eval()
    x = torch.randn((*shape, cin), generator=gen).to(BF16)
    b, h, w = shape
    win = torch.tensor([[0, 0, h, w], [0, 0, h - 3, w - 2], [0, 0, h // 2, w],
                        [0, 0, h, w // 3]][:b], dtype=torch.int32)
    kw = dict(k=k, has_expand=expand != 1, has_skip=cin == cout)
    with torch.inference_mode():
        weights = wd.fused_weights(BF16)
        want = mbconv_stride1_plain(x, weights, win, **kw)
        got = stripes_by_hand(x, weights, win, kw, n)
    assert got.dtype == BF16 and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= BF16_REL * float(want.float().abs().max()), err


# ---- the f32 2 x 2 mesh ---------------------------------------------------------------


def test_f32_2x2_matches_one_process_and_jax(spec, outs4):
    """Each data row ran its half of the batch on 2 stripes; every rank
    returns the whole batch's records, held to one process on the same
    halves and to JAX's (2 data x 4 model) sharded engines."""
    recs = [o["f32_2x2"] for o in outs4]
    _identical([r["cam"] for r in recs], "sgc")
    _identical([r["seg"] for r in recs], "probs")
    cam, seg = _one(spec)
    want = (cam.run_batch(*[p[:2] for p in _cam_batch(spec, 4)])
            + cam.run_batch(*[p[2:] for p in _cam_batch(spec, 4)]))
    _cam_close(recs[0]["cam"], want, SPATIAL_SCORE_ATOL, SPATIAL_SGC_ATOL, "2x2 vs one process",
               f16_step=True)
    kw = dict(mesh=jpar.make_mesh(model_axis=4), shard_spatial=True)
    jcam, jseg = _jax(spec, **kw)
    _cam_close(recs[0]["cam"], jcam.run_batch(*_pil(_cam_batch(spec, 4))), SCORE_ATOL, SGC_ATOL,
               "2x2 vs JAX 2x4")
    want = seg.run_batch(*_seg_batch(spec, 2))
    jwant = jseg.run_batch(*_pil(_seg_batch(spec, 2)))
    for g, w, j in zip(recs[0]["seg"], want, jwant):
        np.testing.assert_allclose(g["probs"], w["probs"], atol=JAX_PROBS_ATOL)
        np.testing.assert_allclose(g["probs"], j["probs"], atol=JAX_PROBS_ATOL)
    assert [o["coords"] for o in outs4] == [{"1x4": (0, r), "2x2": (r // 2, r % 2)}
                                            for r in range(4)]
