"""The port's IRN training (muscle_tpu_torch/training/irn.py, models/irn.py
IRNNet, ops/affinity_labels.py, core/bitpack.py, data/voc12.py
VOC12AffinityDataset) against the JAX package's.

The JAX step runs with an optimizer built as the recipe says: SGD with
momentum 0.9, L2 decay on the heads, the learning rate poly-decayed, the
backbone untouched (``optax.multi_transform``); the JAX package's own CLI
builds a different one (its learning rate is fixed at 1 and its decay
shrinks the frozen backbone, ROADMAP Queue C), which
``test_jax_cli_optimizer_ignores_its_learning_rate`` records.

Tolerances: the datasets, the bit unpack, the pair enumerations and the
affinity labels exact; loss terms 1e-4 relative; head parameters after
two steps within 1e-4 of each tensor's largest; the port's frozen
backbone bit-identical.
"""

import os

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from muscle_tpu.convert.torch_to_flax import convert_irn_state_dict
from muscle_tpu.core.bitpack import packbits_last as j_packbits_last
from muscle_tpu.core.bitpack import unpackbits_last as j_unpackbits_last
from muscle_tpu.data.voc12 import VOC12AffinityDataset as JAffinityDataset
from muscle_tpu.models import IRNNet as JIRNNet
from muscle_tpu.ops import affinity_labels as jal
from muscle_tpu.ops.random_walk import PathIndex as JPathIndex
from muscle_tpu.training import create_train_state
from muscle_tpu.training.irn import IRNTrainConfig as JIRNTrainConfig
from muscle_tpu.training.irn import irn_losses as j_irn_losses
from muscle_tpu.training.irn import irn_train_step as j_irn_train_step
from muscle_tpu_torch.convert import irn_state_dict_from_jax
from muscle_tpu_torch.core.bitpack import packbits_last, unpackbits_last
from muscle_tpu_torch.core.ycbcr import rgb_to_ycbcr420
from muscle_tpu_torch.data.voc12 import VOC12AffinityDataset
from muscle_tpu_torch.models import EdgeDisplacement, IRNNet, init_weights
from muscle_tpu_torch.ops import affinity_labels as al
from muscle_tpu_torch.ops.random_walk import PathIndex
from muscle_tpu_torch.training import (
    IRNTrainConfig,
    irn_losses,
    irn_train_step,
    make_irn_sgd,
    poly_schedule,
    set_learning_rate,
)
from muscle_tpu_torch.training.irn import _grid_path_index

CROP, N = 64, 2
LR, WD, STEPS_TOTAL = 0.1, 1e-4, 4
RTOL = 1e-4


def test_unpackbits_matches_jax():
    m = (np.random.default_rng(0).random((3, 7, 96)) < 0.3).astype(np.float32)
    p = packbits_last(m)
    np.testing.assert_array_equal(p, j_packbits_last(m))
    got = unpackbits_last(torch.from_numpy(p), 96)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_unpackbits_last(jnp.asarray(p), 96)))
    np.testing.assert_array_equal(got.numpy(), m)
    with pytest.raises(ValueError):
        packbits_last(np.zeros((4, 12)))
    with pytest.raises(ValueError):
        unpackbits_last(torch.from_numpy(p), 128)


@pytest.mark.parametrize("radius,size", [(5, (16, 16)), (5, (128, 128)), (3, (20, 31))])
def test_path_index_and_pairs_match_jax(radius, size):
    pi, jpi = PathIndex(radius, size), JPathIndex(radius, size)
    np.testing.assert_array_equal(pi.search_dst, jpi.search_dst)
    assert pi.search_dst.shape == (pi.dst_indices.shape[0], 2)
    for got, want in zip(al.get_indices_of_pairs(radius, size),
                         jal.get_indices_of_pairs(radius, size)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(al.get_indices_of_pairs_raster(radius, size, orient=True),
                         jal.get_indices_of_pairs_raster(radius, size, orient=True)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(al.get_indices_of_pairs_circle(radius, size),
                         jal.get_indices_of_pairs_circle(radius, size)):
        np.testing.assert_array_equal(got, want)


def test_affinity_labels_match_jax():
    size = (16, 20)
    lab = np.random.default_rng(0).choice([0, 0, 3, 7, 255], size=size[0] * size[1])
    pi, jpi = PathIndex(5, size), JPathIndex(5, size)
    got = al.affinity_labels_from_indices(torch.from_numpy(lab), pi)
    want = jal.affinity_labels_from_indices(jnp.asarray(lab), jpi)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == pi.dst_indices.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(float(g.sum()) > 0 for g in got)


# ---- the step ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """A seeded random IRNNet (batch and group norms with random affines and
    statistics) as the port's state dict and the JAX package's IRNNet
    variables of it."""
    model = init_weights(IRNNet(), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.copy_(torch.from_numpy(rng.uniform(0.75, 1.25, m.num_channels)))
                m.bias.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, m.num_channels)))
        model.mean_shift.running_mean.copy_(torch.tensor([0.05, -0.03]))
    sd = {k: t.numpy().copy() for k, t in model.state_dict().items()
          if "num_batches_tracked" not in k}
    v = convert_irn_state_dict(sd)
    return sd, {"params": v["params"]["net"], "batch_stats": v["batch_stats"]["net"]}


def _batch(seed):
    """uint8 4:2:0 planes and disjoint random bit-packed 0/1 masks over the
    crop-64 pair grid."""
    pi = _grid_path_index(IRNTrainConfig(crop_size=CROP))
    d, p = pi.dst_indices.shape
    rng = np.random.default_rng(seed)
    rgb = np.clip(np.kron(rng.uniform(0, 255, (N, 8, 8, 3)), np.ones((1, 8, 8, 1)))
                  + rng.normal(0, 10, (N, CROP, CROP, 3)), 0, 255).astype(np.uint8)
    ys, cs = zip(*(rgb_to_ycbcr420(im) for im in rgb))
    r = rng.random((N, d, p))
    bg, fg, ng = r < 0.3, (r >= 0.3) & (r < 0.5), (r >= 0.5) & (r < 0.7)
    return {"img_y": np.stack(ys), "img_c": np.stack(cs), "bg_pos": packbits_last(bg),
            "fg_pos": packbits_last(fg), "neg": packbits_last(ng)}


def _recipe_tx(params):
    """The stated recipe in optax: heads decayed and trained with poly SGD
    + momentum, the backbone's updates zero."""
    sched = optax.polynomial_schedule(LR, 0.0, 0.9, STEPS_TOTAL)
    heads = optax.chain(optax.add_decayed_weights(WD),
                        optax.sgd(learning_rate=sched, momentum=0.9))
    labels = {k: "frozen" if k == "resnet50" else "heads" for k in params}
    return optax.multi_transform({"heads": heads, "frozen": optax.set_to_zero()}, labels)


@pytest.fixture(scope="module")
def jax_steps(weights):
    _, variables = weights
    tx = _recipe_tx(variables["params"])
    state = create_train_state(jax.tree.map(jnp.asarray, variables), tx)
    metrics = []
    for seed in (1, 2):
        state, m = j_irn_train_step(JIRNNet(), tx, state,
                                    {k: jnp.asarray(v) for k, v in _batch(seed).items()},
                                    JIRNTrainConfig(crop_size=CROP))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def test_irn_steps_match_jax(weights, jax_steps):
    """Two steps (the second with momentum and the decayed learning rate):
    loss terms and head parameters as JAX's with the recipe's optimizer;
    the backbone bit-identical; every head parameter moved."""
    sd, _ = weights
    jstate, jmets = jax_steps
    model = IRNNet()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    opt = make_irn_sgd(model, LR, WD)
    lr_at = poly_schedule(LR, STEPS_TOTAL, 0.9)
    for step, (seed, jm) in enumerate(zip((1, 2), jmets)):
        set_learning_rate(opt, lr_at(step))
        got = irn_train_step(model, opt, {k: torch.from_numpy(v) for k, v in _batch(seed).items()},
                             IRNTrainConfig(crop_size=CROP))
        assert sorted(got) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(got[k]), jm[k], rtol=RTOL, err_msg=k)
    assert opt.param_groups[0]["lr"] == pytest.approx(LR * 0.75 ** 0.9)
    j_sd = irn_state_dict_from_jax({"params": {"net": jax.tree.map(np.asarray, jstate.params)},
                                    "batch_stats": {"net": jax.tree.map(
                                        np.asarray, jstate.batch_stats)}})
    after = model.state_dict()
    for k, v in sd.items():
        if k.startswith("resnet50."):
            assert np.array_equal(after[k].numpy(), v), k
            continue
        want = j_sd[k].numpy()
        np.testing.assert_allclose(after[k].numpy(), want, atol=1e-4 * np.abs(want).max(),
                                   rtol=0, err_msg=k)
        if k != "mean_shift.running_mean":
            assert not np.array_equal(after[k].numpy(), v), k


def test_irn_losses_and_gradients_match_jax():
    """The loss terms and their gradients with respect to the edge logits
    and the displacement field, on random outputs and masks."""
    cfg = IRNTrainConfig(crop_size=CROP)
    pi = _grid_path_index(cfg)
    d, p = pi.dst_indices.shape
    rng = np.random.default_rng(3)
    v = cfg.grid ** 2
    edge = rng.normal(0, 2, (N, v)).astype(np.float32)
    dp = rng.normal(0, 3, (N, v, 2)).astype(np.float32)
    r = rng.random((N, d, p))
    masks = [(r < 0.3), (r >= 0.3) & (r < 0.5), (r >= 0.5) & (r < 0.7)]
    masks = [m.astype(np.float32) for m in masks]
    jpi = JPathIndex(cfg.radius, (cfg.grid, cfg.grid))

    def jtotal(e, q):
        return j_irn_losses(e, q, *map(jnp.asarray, masks), jpi)

    (jt, jm), jg = jax.value_and_grad(jtotal, argnums=(0, 1), has_aux=True)(jnp.asarray(edge),
                                                                          jnp.asarray(dp))
    e, q = (torch.from_numpy(a).requires_grad_(True) for a in (edge, dp))
    total, m = irn_losses(e, q, *map(torch.from_numpy, masks), pi)
    total.backward()
    for k in jm:
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), rtol=1e-5, err_msg=k)
    for got, want in ((e.grad, jg[0]), (q.grad, jg[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_irnnet_shares_edge_displacement_keys_and_outputs(weights):
    """IRNNet's state dict loads into EdgeDisplacement (the refiner's net)
    and their edge logits agree; the backbone runs without autograd."""
    sd, _ = weights
    net, wrapper = IRNNet(), EdgeDisplacement(crop_size=CROP)
    assert list(net.state_dict()) == list(wrapper.state_dict())
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    wrapper.load_state_dict(net.state_dict())
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, CROP, CROP, 3))
                         .astype(np.float32))
    edge, dp = net(x)
    assert edge.shape == (2, 16, 16, 1) and dp.shape == (2, 16, 16, 2)
    assert edge.requires_grad and dp.requires_grad
    with torch.inference_mode():
        fused, _ = wrapper(x)
    want = torch.sigmoid(edge[0, ..., 0].detach() / 2 + edge[1, ..., 0].detach().flip(-1) / 2)
    np.testing.assert_allclose(fused.numpy(), want.numpy(), atol=1e-6)
    names = {n for n, _ in net.named_parameters()}
    heads = {id(p) for p in net.head_parameters()}
    assert all(n.startswith("resnet50.") for n, p in net.named_parameters() if id(p) not in heads)
    assert len(heads) == len([n for n in names if not n.startswith("resnet50.")])


def test_jax_cli_optimizer_ignores_its_learning_rate():
    """Records the JAX package's fault that the port does not copy
    (ROADMAP Queue C): cli/train_irn.py's ``inject_hyperparams`` factory
    ignores its learning_rate, so with --lr 0.1 its first update is
    -(g + wd p), not -0.1 (g + wd p), and its decay also reaches the
    backbone.  (The optimizer built as in that file, on a tiny tree.)"""
    wd = 1e-4
    tx = optax.inject_hyperparams(
        lambda learning_rate: optax.chain(optax.add_decayed_weights(wd),
                                          optax.sgd(learning_rate=1.0, momentum=0.9))
    )(learning_rate=optax.polynomial_schedule(0.1, 0.0, 0.9, 10))
    params = {"resnet50": jnp.ones(3), "head": jnp.full(3, 2.0)}
    grads = {"resnet50": jnp.zeros(3), "head": jnp.full(3, 0.5)}
    updates, _ = tx.update(grads, tx.init(params), params)
    np.testing.assert_allclose(np.asarray(updates["head"]), -(0.5 + wd * 2.0), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(updates["resnet50"]), -wd, rtol=1e-6)


# ---- the dataset -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory):
    """JPEGImages + pseudo-label PNGs (a square of the image's class, a
    void border) + labels."""
    root = tmp_path_factory.mktemp("voc_irn")
    os.makedirs(root / "JPEGImages")
    os.makedirs(root / "pseudo")
    rng = np.random.default_rng(0)
    names = [f"2007_{i:06d}" for i in range(3)]
    labels = {}
    for i, n in enumerate(names):
        h, w = 60 + 4 * i, 80 - 4 * i
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        seg = np.zeros((h, w), np.uint8)
        seg[10:40, 12:50] = i + 1
        seg[:, :3] = 255
        Image.fromarray(seg).save(root / "pseudo" / f"{n}.png")
        lab = np.zeros(20, np.float32)
        lab[i] = 1
        labels[n] = lab
    return root, names, labels


AFF_MODES = {"f32": dict(), "u8": dict(device_norm=True),
             "u8_packed_ycbcr": dict(device_norm=True, upload="ycbcr420", pack_bits=True)}


@pytest.mark.parametrize("mode", sorted(AFF_MODES))
def test_affinity_dataset_matches_jax(mini_voc, mode):
    root, names, labels = mini_voc
    args = (names, str(root), labels, str(root / "pseudo"))
    ds = VOC12AffinityDataset(*args, crop_size=64, **AFF_MODES[mode])
    jds = JAffinityDataset(*args, crop_size=64, **AFF_MODES[mode])
    seen = np.zeros(3)
    for idx in range(3):
        a = ds.get(idx, np.random.default_rng(5 + idx))
        b = jds.get(idx, np.random.default_rng(5 + idx))
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if mode == "f32":
            seen += [a[k].sum() for k in ("bg_pos", "fg_pos", "neg")]
    if mode == "f32":
        assert np.all(seen > 0)
    if mode == "u8_packed_ycbcr":
        assert a["bg_pos"].shape == (34, 96 // 8)


def test_affinity_dataset_rejects_packing_without_device_norm(mini_voc):
    root, names, labels = mini_voc
    with pytest.raises(ValueError, match="device_norm"):
        VOC12AffinityDataset(names, str(root), labels, str(root / "pseudo"), crop_size=64,
                             pack_bits=True)
    with pytest.raises(ValueError, match="P="):
        VOC12AffinityDataset(names, str(root), labels, str(root / "pseudo"), crop_size=56,
                             device_norm=True, pack_bits=True)
