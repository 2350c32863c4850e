"""The port's segmentation training (muscle_tpu_torch/training/seg.py,
data/voc12.py VOC12SegDataset) against the JAX package's on the same
weights and batch: MuSCLe-b1 dec, BiFPN 1 x 64, crop 64, batch 2, k 16,
step 3, drop-connect off on both sides, BEACON's draws JAX's own.  Also
the batch decode, the dataset draw for draw, and a fused model through a
train -> eval -> train sequence.

Tolerances: loss terms and the gradient norm 1e-4 relative; gradients
(after clipping) 1e-4 of each tensor's largest, and below 1e-5 of the
model's largest where a tensor's gradient is zero in exact arithmetic (a
bias feeding a train-mode BN).  Adam's first step
moves each entry by lr * g / (|g| + eps), g = grad + wd w, about lr *
sign(g), so the updated parameters agree to 1% of lr where |g| stands
above 1e-3 of its tensor's largest and above 100 eps (the clipped
gradients come near Adam's eps = 1e-8, where the update follows |g|);
elsewhere f32 noise may flip the sign of at most 0.1% of the entries; and
every parameter is within 1e-4 of its tensor's largest, or within such a
flip's 2 lr in a tensor whose entries are of the size of one step (the
biases that start at 0).  BN statistics 1e-5, or 1e-4 relative: at crop
64 the BiFPN's p6 and p7 maps are 1 x 1, so their batch variance is over
2 values and its rounding shows at ~4e-5 of the variance.  The decode and the dataset are exact.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import muscle_tpu.models.efficientnet as jeff
from muscle_tpu.convert import convert_muscle_state_dict
from muscle_tpu.data import VOC12SegDataset as JSegDataset
from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu.training import SegConfig as JSegConfig
from muscle_tpu.training import create_train_state
from muscle_tpu.training import seg_train_step as j_seg_train_step
from muscle_tpu.training.seg import _dequant_batch as j_dequant_batch
from muscle_tpu.training.seg import cross_entropy as j_cross_entropy
from muscle_tpu.training.state import make_adam as j_make_adam
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.core.ycbcr import rgb_to_ycbcr420
from muscle_tpu_torch.data.voc12 import VOC12SegDataset
from muscle_tpu_torch.inference import SegTTAEngine
from muscle_tpu_torch.models import MuSCLe, calibrate_seg_head, init_weights
from muscle_tpu_torch.training import (
    SegConfig,
    batch_stats_train,
    make_adam,
    seg_term_grad_norms,
    seg_train_step,
)
from muscle_tpu_torch.training.seg import _dequant_batch, cross_entropy

BACKBONE = "efficientnet-b1"
N, CROP, K_PACK = 2, 64, 3
LR, WD = 1e-5, 1e-5
CFG = dict(k=16, step=3, clip_norm=1.0)  # a clip below the gradient norm: clipping acts
RTOL, STAT_TOL = 1e-4, 1e-5
ADAM_EPS = 1e-8


def _dec(fuse=0):
    return MuSCLe(backbone_name=BACKBONE, mode="dec", bifpn_layers=1, bifpn_channels=64,
                  fuse_mbconv=fuse)


def _planes(rng, n, side):
    """Smooth random RGB images as the dataset's 4:2:0 planes."""
    lo = rng.uniform(0, 255, (n, side // 8, side // 8, 3))
    rgb = np.kron(lo, np.ones((1, 8, 8, 1))) + rng.normal(0, 10, (n, side, side, 3))
    ys, cs = zip(*(rgb_to_ycbcr420(np.clip(im, 0, 255).astype(np.uint8)) for im in rgb))
    return np.stack(ys), np.stack(cs)


def _calibrated_train_forward(model, batch):
    """Calibrate the head on the batch's images in train mode (BNs on the
    batch statistics, updating nothing) and return that mode's seg_map."""
    with batch_stats_train(model), torch.no_grad():
        img = _dequant_batch({k: torch.from_numpy(v) for k, v in batch.items()})["img"]
        calibrate_seg_head(model, img)
        return model(img, mode="seg")[0]


@pytest.fixture(scope="module")
def problem():
    """A seeded random port model with its head calibrated on the batch in
    train mode, the batch (4:2:0 planes, a packed uint8 soft mask of the
    background and two classes, one pad slot in image 0), labelled with
    the two foreground classes the model's map covers most (BEACON then
    finds their boundaries), and the JAX tree of the same weights."""
    rng = np.random.default_rng(0)
    model = init_weights(_dec(), torch.Generator().manual_seed(0))
    model.backbone.drop_connect_rate = 0.0
    batch = {}
    batch["img_y"], batch["img_c"] = _planes(rng, N, CROP)
    seg = _calibrated_train_forward(model, {**batch, "mask": np.zeros((N, 1, 1, 1), np.float32),
                                      "label": np.zeros((N, 20), np.float32)})
    area = torch.nn.functional.one_hot(seg.argmax(-1), 21).sum(dim=(1, 2))[:, 1:]
    top = area.argsort(dim=1, descending=True, stable=True)[:, :2].numpy() + 1
    label = np.zeros((N, 20), np.float32)
    mask_idx = np.zeros((N, K_PACK), np.int32)
    packed = np.zeros((N, CROP, CROP, K_PACK), np.uint8)
    for i in range(N):
        label[i, top[i] - 1] = 1
        ids = [0, *top[i]] if i else [0, top[i][0]]  # image 0: one class and a pad slot
        mask_idx[i, :len(ids)] = ids
        packed[i, ..., :len(ids)] = rng.integers(0, 256, (CROP, CROP, len(ids)))
    batch.update(mask=packed, mask_idx=mask_idx, label=label)
    sd = {k: t.numpy() for k, t in model.state_dict().items() if "num_batches_tracked" not in k}
    return sd, convert_muscle_state_dict(sd), batch


def _port(sd):
    m = _dec()
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    m.backbone.drop_connect_rate = 0.0
    return m


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


def _jax_draws(key, n, nfg, h, w):
    keys = jax.random.split(key, n * nfg)
    return np.stack([np.asarray(jax.random.uniform(k, (h, w))) for k in keys]).reshape(
        n, nfg, h, w)


@pytest.fixture(scope="module")
def jax_step(problem):
    """One JAX seg_train_step with drop-connect the identity."""
    _, variables, batch = problem
    jmodel = JMuSCLe(backbone_name=BACKBONE, mode="dec", bifpn_layers=1, bifpn_channels=64)
    mp = pytest.MonkeyPatch()
    mp.setattr(jeff, "drop_connect", lambda x, rate, key: x)
    try:
        tx = j_make_adam(LR, WD)
        state = create_train_state(jax.tree.map(jnp.asarray, variables), tx)
        rng = jax.random.key(7)
        new, metrics = j_seg_train_step(jmodel, tx, state,
                                        {k: jnp.asarray(v) for k, v in batch.items()}, rng,
                                        JSegConfig(**CFG))
        metrics = {k: float(v) for k, v in metrics.items()}
    finally:
        mp.undo()
    draws = _jax_draws(rng, N, 20, CROP, CROP)
    return new, metrics, draws


def test_seg_step_matches_jax(problem, jax_step):
    """Loss terms, the gradient norm before clipping, the clipped gradients,
    BN statistics and the Adam step, with BEACON engaged."""
    sd, _, batch = problem
    jnew, jmet, draws = jax_step
    model = _port(sd)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    opt = make_adam(model.trained_parameters(), LR, WD)
    got = seg_train_step(model, opt, {k: torch.from_numpy(v) for k, v in batch.items()},
                         SegConfig(**CFG), draws=torch.from_numpy(draws))
    assert jmet["loss_beacon"] != 0 and jmet["grad_norm"] > CFG["clip_norm"]
    assert sorted(got) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(got[k]), jmet[k], rtol=RTOL, atol=1e-7, err_msg=k)

    names = {id(p): n for n, p in model.named_parameters()}
    j_after = state_dict_from_jax({"params": _plain(jnew.params),
                                   "batch_stats": _plain(jnew.batch_stats)})
    j_mu = state_dict_from_jax({"params": _plain(jnew.opt_state.inner_state[1].mu)})
    jgrads = {names[id(p)]: j_mu[names[id(p)]].numpy() / 0.1 - WD * before[names[id(p)]].numpy()
              for p in model.trained_parameters()}
    noise = 1e-5 * max(np.abs(g).max() for g in jgrads.values())
    flips = total = 0
    for p in model.trained_parameters():
        k = names[id(p)]
        w0, jg, g = before[k].numpy(), jgrads[k], p.grad.numpy()
        scale = np.abs(jg).max()
        strong = np.zeros(g.shape, bool)
        if scale < noise:  # a zero gradient in exact arithmetic
            assert np.abs(g).max() < noise, k
        else:
            np.testing.assert_allclose(g, jg, atol=1e-4 * scale, rtol=0, err_msg=k)
            gd = jg + WD * w0
            strong = np.abs(gd) > max(1e-3 * np.abs(gd).max(), 100 * ADAM_EPS)
        du, dj = p.detach().numpy() - w0, j_after[k].numpy() - w0
        np.testing.assert_allclose(du[strong], dj[strong], atol=1e-2 * LR, rtol=0, err_msg=k)
        flips += int(np.sum(np.sign(du[~strong]) != np.sign(dj[~strong])))
        total += du.size
        np.testing.assert_allclose(p.detach().numpy(), j_after[k].numpy(), rtol=0,
                                   atol=max(1e-4 * np.abs(j_after[k].numpy()).max(), 2 * LR))
    assert flips <= 1e-3 * total, (flips, total)
    sd_after = model.state_dict()
    for k in j_after:
        if k.endswith("running_mean") or k.endswith("running_var"):
            np.testing.assert_allclose(sd_after[k].numpy(), j_after[k].numpy(), atol=STAT_TOL,
                                       rtol=RTOL, err_msg=k)
            assert not np.array_equal(sd_after[k].numpy(), before[k].numpy()), k


def test_seg_term_grad_norms_both_live(problem, jax_step):
    """Both terms reach the parameters, with the step's values; the model's
    weights, statistics and mode are left as they were."""
    sd, _, batch = problem
    _, jmet, draws = jax_step
    model = _port(sd).eval()
    state = {k: t.clone() for k, t in model.state_dict().items()}
    norms, values = seg_term_grad_norms(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, SegConfig(**CFG),
        draws=torch.from_numpy(draws), return_values=True)
    assert sorted(norms) == ["beacon", "seg"] and all(v > 0 for v in norms.values()), norms
    np.testing.assert_allclose(values["seg"], jmet["loss_seg"], rtol=RTOL)
    np.testing.assert_allclose(values["beacon"], jmet["loss_beacon"], rtol=RTOL)
    assert not model.training
    for k, t in model.state_dict().items():
        assert torch.equal(t, state[k]), k


@pytest.mark.parametrize("packed", [True, False])
def test_dequant_batch_exact(packed):
    """The decode of a uint8 batch equals JAX's bit for bit: the mask / 255
    and, packed, added back into 21 channels (pad slots with id 0 add
    zeros to the background); the image within f32 rounding."""
    rng = np.random.default_rng(1)
    y, c = _planes(rng, 2, 16)
    label = np.zeros((2, 20), np.float32)
    label[0, 3] = label[1, [5, 8]] = 1
    if packed:
        mask = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
        mask[0, ..., 2] = 0  # image 0's pad slot
        idx = np.asarray([[0, 4, 0], [0, 6, 9]], np.int32)
        b = {"img_y": y, "img_c": c, "mask": mask, "mask_idx": idx, "label": label}
    else:
        b = {"img_y": y, "img_c": c, "label": label,
             "mask": rng.integers(0, 256, (2, 16, 16, 21), dtype=np.uint8)}
    got = _dequant_batch({k: torch.from_numpy(v) for k, v in b.items()}, 21)
    want = j_dequant_batch({k: jnp.asarray(v) for k, v in b.items()}, 21)
    assert sorted(got) == sorted(want) == ["img", "label", "mask"]
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    np.testing.assert_allclose(got["img"].numpy(), np.asarray(want["img"]), atol=1e-5)
    if packed:  # the pad slot left image 0's background as it was
        np.testing.assert_array_equal(got["mask"][0, ..., 0].numpy(),
                                      mask[0, ..., 0].astype(np.float32) / 255.0)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (2, 9, 11, 21)).astype(np.float32)
    hard = rng.integers(0, 21, (2, 9, 11))
    np.testing.assert_allclose(float(cross_entropy(torch.from_numpy(logits),
                                                   torch.from_numpy(hard))),
                               float(j_cross_entropy(jnp.asarray(logits), jnp.asarray(hard))),
                               rtol=1e-6)


def test_fused_model_train_eval_train(problem):
    """A fused model (fuse_mbconv=384) trains (plain blocks under autograd),
    evaluates through the engine with its stride-1 blocks on the kernel
    wrapper (here its plain version), trains, evaluates again: each eval
    equals an unfused model's on the same weights, so the folded-weight
    cache sees every step, and the second step runs after an eval."""
    sd, _, batch = problem
    fused = _dec(384)
    fused.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    imgs = [np.random.default_rng(s).integers(0, 256, (40, 56, 3), dtype=np.uint8)
            for s in range(2)]
    opt = make_adam(fused.trained_parameters(), 1e-3, WD)
    gen = torch.Generator().manual_seed(0)

    def eval_both():
        plain = _dec(0)
        plain.load_state_dict(fused.state_dict())
        got = SegTTAEngine(fused, scales=(1.0,), device="cpu").run_batch(imgs, ["a", "b"])
        want = SegTTAEngine(plain, scales=(1.0,), device="cpu").run_batch(imgs, ["a", "b"])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["probs"], w["probs"], atol=1e-5)
        return got[0]["probs"]

    p0 = eval_both()
    for _ in range(2):
        m = seg_train_step(fused, opt, tb, SegConfig(**CFG), gen)
        assert fused.training and np.isfinite(float(m["loss"]))
        p1 = eval_both()
        assert np.abs(p1 - p0).max() > 1e-4  # the step moved the eval
        p0 = p1


# ---- the dataset -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory):
    """JPEGImages + a soft-mask folder (background and the image's class
    nonzero, as the walk's pseudo-masks) + labels."""
    root = tmp_path_factory.mktemp("voc_seg")
    os.makedirs(root / "JPEGImages")
    os.makedirs(root / "masks")
    rng = np.random.default_rng(0)
    names = [f"2007_{i:06d}" for i in range(3)]
    labels = {}
    for i, n in enumerate(names):
        h, w = 60 + 4 * i, 80 - 4 * i
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        m = np.zeros((h, w, 21), np.float16)
        m[..., 0] = rng.uniform(0, 0.5, (h, w))
        m[..., 2 + i] = rng.uniform(0, 1, (h, w))
        np.save(root / "masks" / f"{n}.npy", m)
        lab = np.zeros(20, np.float32)
        lab[1 + i] = 1
        labels[n] = lab
    return root, names, labels


SEG_MODES = {"f32": dict(), "u8": dict(device_norm=True, upload="rgb"),
             "u8_packed_ycbcr": dict(device_norm=True, upload="ycbcr420", pack_mask=-1)}


@pytest.mark.parametrize("mode", sorted(SEG_MODES))
def test_seg_dataset_matches_jax(mini_voc, mode):
    """The same arrays as the JAX dataset from one seed, in each upload."""
    root, names, labels = mini_voc
    args = (names, str(root), labels, str(root / "masks"))
    ds = VOC12SegDataset(*args, crop_size=48, **SEG_MODES[mode])
    jds = JSegDataset(*args, crop_size=48, **SEG_MODES[mode])
    for idx in range(3):
        a = ds.get(idx, np.random.default_rng(11 + idx))
        b = jds.get(idx, np.random.default_rng(11 + idx))
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if "pack_mask" in SEG_MODES[mode]:
        assert ds.pack_mask == 2 and a["mask"].shape == (48, 48, 2)


def test_seg_dataset_pack_overflow_raises(mini_voc):
    root, names, labels = mini_voc
    ds = VOC12SegDataset(names, str(root), labels, str(root / "masks"), crop_size=48,
                         device_norm=True, pack_mask=1)
    with pytest.raises(ValueError, match="pack_mask=1"):
        ds.get(0, np.random.default_rng(0))
    with pytest.raises(ValueError, match="device_norm"):
        VOC12SegDataset(names, str(root), labels, str(root / "masks"), upload="ycbcr420")


def test_batch_stats_train_updates_nothing_and_restores():
    """Inside: train mode, normalised by the batch (not the running
    statistics), no statistic or count moved; after: the mode and each
    norm's setting as they were."""
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1), torch.nn.BatchNorm2d(4),
                                torch.nn.BatchNorm2d(4, track_running_stats=False)).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.from_numpy(np.random.default_rng(0).normal(3.0, 2.0, (2, 3, 5, 5))
                         .astype(np.float32))
    with batch_stats_train(model):
        assert model.training
        y = model[:2](x)
    np.testing.assert_allclose(y.mean(dim=(0, 2, 3)).detach().numpy(), model[1].bias.detach(),
                               atol=1e-5)
    assert not model.training
    assert [m.track_running_stats for m in model[1:]] == [True, False]
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
