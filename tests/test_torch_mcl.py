"""The port's MCL training steps (muscle_tpu_torch/training) against the JAX
package's ``mcl_train_step`` / ``mcl_views_step`` on the same weights
(carried across by ``state_dict_from_jax``) and batch: MuSCLe-b1 enc, crop
64, views 32, batch 4, drop-connect off on both sides.  Also the train-mode
BatchNorm against Flax's, drop-connect's statistics, the MBConv gate under
autograd, ``term_liveness`` against the JAX package's, and the schedules.

Tolerances: metrics 1e-4 relative; BN running statistics 1e-5; step A's
gradients 1e-4 of each tensor's largest.  Step B's gradients 1e-3: its
maps pass through ``cam_maxnorm``, which divides by each channel's spatial
range, and a random net's SGC varies by ~3% of its size over a view (the
PCM averages), so the forward's ~1e-6 differences reach the gradient
amplified ~40x (the loss alone matches JAX's gradient to 1e-6,
test_torch_losses.py).  Some tensors have a zero gradient in exact
arithmetic: in step A a bias that feeds a train-mode BN (the ``_bn2.bias``
of blocks whose output the next block's expand conv and BN take), in step
B the last block's, which shifts p7 per channel and the maxnorm removes
it.  Both sides compute rounding noise there, below 1e-5 (step A) or 1e-3
(step B) of the model's largest gradient, and that is what is checked for
such a tensor.  Parameter updates: Adam's first
step moves each entry by lr * g / (|g| + eps) with g = grad + wd * w, i.e.
by about lr * sign(g), so the updates agree (to 1% of lr) where |g| stands
above 1e-3 of its tensor's largest (in a tensor with a gradient), and
elsewhere flip sign on at most 0.1% of the entries, where f32 noise
decides the sign.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import muscle_tpu.losses.contrastive as jcon
import muscle_tpu.models.efficientnet as jeff
from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu.training import MCLConfig as JMCLConfig
from muscle_tpu.training import create_train_state
from muscle_tpu.training import mcl_train_step as j_train_step
from muscle_tpu.training import mcl_views_step as j_views_step
from muscle_tpu.training.liveness import term_liveness as j_term_liveness
from muscle_tpu.training.schedule import ReduceLROnPlateau as JPlateau
from muscle_tpu.training.schedule import poly_schedule as j_poly
from muscle_tpu.training.state import make_adam as j_make_adam
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.models import MuSCLe
from muscle_tpu_torch.models.efficientnet import BatchNorm2d, drop_connect
from muscle_tpu_torch.training import (
    MCLConfig,
    ReduceLROnPlateau,
    make_adam,
    mcl_term_grad_norms,
    mcl_train_step,
    mcl_views_step,
    poly_schedule,
    term_liveness,
)

BACKBONE = "efficientnet-b1"
N, CROP, VIEW = 4, 64, 32
LR, WD = 1e-4, 5e-5
METRIC_RTOL, STAT_TOL = 1e-4, 1e-5


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


def _randomize_bn(variables, seed):
    """BNs near the identity with random scale, shift and statistics (the
    port's init_weights): identity statistics flatten a random net's
    eval-mode maps, and PixPro/EMD then have no gradient to compare."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for k, sub in p.items():
            if "scale" in sub:
                n = sub["scale"].shape
                sub["scale"] = rng.uniform(0.75, 1.25, n).astype(np.float32)
                sub["bias"] = rng.uniform(-0.1, 0.1, n).astype(np.float32)
                s[k]["mean"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.0, n).astype(np.float32)
            elif "kernel" not in sub:
                walk(sub, s.setdefault(k, {}))

    walk(variables["params"], variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def weights():
    model = JMuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False)
    v = model.init({"params": jax.random.key(0)}, jnp.zeros((1, CROP, CROP, 3)), mode="cam")
    return model, _randomize_bn(_plain(v), seed=0)


def _batch(seed=0):
    """A batch in the dataset's default upload (uint8 4:2:0 planes), with
    labels that give IMC qualifying pairs and overlaps of which one is too
    small for EMD."""
    rng = np.random.default_rng(seed)
    b = {}
    for key, side in (("img", CROP), ("view1", VIEW), ("view2", VIEW)):
        b[key + "_y"] = rng.integers(0, 256, (N, side, side), dtype=np.uint8)
        b[key + "_c"] = rng.integers(0, 256, (N, side // 2, side // 2, 2), dtype=np.uint8)
    label = np.zeros((N, 20), np.float32)
    for i, c in enumerate((7, 7, 11, 14)):
        label[i, c] = 1.0
    label[3, 4] = 1.0
    b["label"] = label
    # (row, col, h, w) of the overlap in each view; sample 2's is 12 high
    b["coord1"] = np.asarray([[0, 0, 20, 24], [4, 2, 28, 30], [20, 0, 12, 32], [0, 5, 32, 27]],
                             np.int32)
    b["coord2"] = np.asarray([[12, 8, 20, 24], [0, 0, 28, 30], [0, 0, 12, 32], [0, 0, 32, 27]],
                             np.int32)
    return b


def _port(variables):
    m = MuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False)
    m.load_state_dict(state_dict_from_jax(variables), strict=False)
    m.backbone.drop_connect_rate = 0.0
    return m


def _names(model):
    return {id(p): n for n, p in model.named_parameters()}


def _jax_step(monkeypatch, step_fn, jmodel, variables, batch, rng, cfg):
    """One JAX step with drop-connect replaced by the identity (no torch
    generator can draw JAX's masks), traced afresh: a new optimizer is a
    new static argument."""
    monkeypatch.setattr(jeff, "drop_connect", lambda x, rate, key: x)
    tx = j_make_adam(LR, WD)
    state = create_train_state(jax.tree.map(jnp.asarray, variables), tx)
    new, metrics = step_fn(jmodel, tx, state, {k: jnp.asarray(v) for k, v in batch.items()},
                           rng, cfg)
    mu = new.opt_state.inner_state[1].mu  # chain(decay, adam, lr): adam's first moment
    return new, {k: float(v) for k, v in metrics.items()}, mu


def _compare_step(model, opt, before, jnew, jmu, moved_stats: bool, grad_tol: float,
                  zero_frac: float):
    """Gradients, BN statistics and updates of one port step against the
    JAX step's, on the JAX tree carried to the port's names."""
    names = _names(model)
    j_after = state_dict_from_jax(
        {"params": _plain(jnew.params), "batch_stats": _plain(jnew.batch_stats)})
    j_mu = state_dict_from_jax({"params": _plain(jmu)})
    grads = {}
    for p in opt.param_groups[0]["params"]:
        k = names[id(p)]
        w0 = before[k].numpy().astype(np.float64)
        # JAX's gradient from Adam's first moment: mu = (1 - b1)(g + wd w)
        grads[k] = (p, w0, j_mu[k].numpy() / 0.1 - WD * w0)
    noise = zero_frac * max(np.abs(jg).max() for _, _, jg in grads.values())
    flips = total = 0
    for k, (p, w0, jg) in grads.items():
        g = p.grad.numpy()
        scale = np.abs(jg).max()
        gd = jg + WD * w0
        strong = np.zeros(gd.shape, bool)
        if scale < noise:  # a zero gradient in exact arithmetic
            assert np.abs(g).max() < noise, k
        else:
            np.testing.assert_allclose(g, jg, atol=grad_tol * scale, rtol=0, err_msg=k)
            strong = np.abs(gd) > 1e-3 * np.abs(gd).max()
        du = p.detach().numpy() - w0
        dj = j_after[k].numpy() - w0
        np.testing.assert_allclose(du[strong], dj[strong], atol=1e-2 * LR, rtol=0, err_msg=k)
        flips += int(np.sum(np.sign(du[~strong]) != np.sign(dj[~strong])))
        total += du.size
    assert flips <= 1e-3 * total, (flips, total)
    sd = model.state_dict()
    for k in j_after:
        if k.endswith("running_mean") or k.endswith("running_var"):
            np.testing.assert_allclose(sd[k].numpy(), j_after[k].numpy(), atol=STAT_TOL,
                                       rtol=0, err_msg=k)
            if not moved_stats:
                np.testing.assert_array_equal(sd[k].numpy(), before[k].numpy())


def _metrics_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=k)


def test_step_a_matches_jax(weights, monkeypatch):
    """Step A at epoch >= 4 (IMC on), train mode: metrics, gradients,
    updated BN statistics (biased-variance update) and the Adam step."""
    jmodel, v = weights
    batch = _batch(0)
    jnew, jmet, jmu = _jax_step(monkeypatch, j_train_step, jmodel, v, batch,
                                jax.random.key(1), JMCLConfig(use_imc=True))
    model = _port(v)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    opt = make_adam(model.trained_parameters(), LR, WD)
    got = mcl_train_step(model, opt, {k: torch.from_numpy(a) for k, a in batch.items()},
                         MCLConfig(use_imc=True))
    assert model.training
    assert jmet["loss_imc"] > 0 and jmet["loss_er"] > 0
    _metrics_close(got, jmet)
    _compare_step(model, opt, before, jnew, jmu, moved_stats=True, grad_tol=1e-4, zero_frac=1e-5)


def _live_labels(model, batch, k=2):
    """The batch labelled, per sample, with the k classes whose view-1 CAM
    varies most: a random classifier's rectified CAM is all zero for about
    half the classes, and a label there gives PixPro and EMD nothing to
    differentiate."""
    from muscle_tpu_torch.training import decode_image

    with torch.no_grad():
        cams, _ = model.eval()(decode_image({k: torch.from_numpy(a) for k, a in batch.items()},
                                            "view1"), mode="pix")
    spread = (cams.amax(dim=(1, 2)) - cams.amin(dim=(1, 2)))[:, 1:]
    label = np.zeros_like(batch["label"])
    np.put_along_axis(label, spread.argsort(dim=1, descending=True)[:, :k].numpy(), 1.0, 1)
    return dict(batch, label=label)


def safe_norm(x, axis=-1):
    """jnp.linalg.norm with torch's gradient at the zero vector (0), where
    JAX's is NaN (0 * inf)."""
    s = jnp.sum(x * x, axis=axis)
    return jnp.where(s > 0, jnp.sqrt(jnp.where(s > 0, s, 1.0)), 0.0)


def masked_overlap_cos_safe(fm1, fm2, coord1, coord2):
    """The JAX package's ``_masked_overlap_cos`` with ``safe_norm``: equal
    to it wherever its gradient is defined.  A view-1 pixel whose maxnormed
    map is zero in every labelled channel (at these sizes there always is
    one: each channel's spatial minimum maps to 0) makes the JAX package's
    step B gradient NaN everywhere; the port, like the reference, gives 0
    there."""
    hv, wv, _ = fm1.shape
    pad = ((0, hv), (0, wv), (0, 0))
    f1 = jax.lax.dynamic_slice(jnp.pad(fm1, pad), (coord1[0], coord1[1], 0),
                               (hv, wv, fm1.shape[-1]))
    f2 = jax.lax.dynamic_slice(jnp.pad(fm2, pad), (coord2[0], coord2[1], 0),
                               (hv, wv, fm2.shape[-1]))
    valid = (jnp.arange(hv)[:, None] < coord1[2]) & (jnp.arange(wv)[None, :] < coord1[3])
    cos = jnp.sum(f1 * f2, axis=-1) / jnp.maximum(safe_norm(f1) * safe_norm(f2), 1e-8)
    return jnp.sum(jnp.where(valid, cos, 0.0)) / jnp.maximum(jnp.sum(valid), 1)


def test_step_b_matches_jax(weights, monkeypatch):
    """Step B at epoch >= 12 (PixPro + EMD), eval mode with gradients for
    view 1, EMD's crop fractions fed in from JAX's key: metrics, gradients,
    the Adam step, and BN statistics unmoved.  JAX's PixPro runs with a
    norm whose gradient is defined at 0 (``masked_overlap_cos_safe``)."""
    jmodel, v = weights
    batch = _live_labels(_port(v), _batch(1))
    rng = jax.random.key(2)
    monkeypatch.setattr(jcon, "_masked_overlap_cos", masked_overlap_cos_safe)
    jnew, jmet, jmu = _jax_step(monkeypatch, j_views_step, jmodel, v, batch, rng,
                                JMCLConfig(True, True, True))
    frac = np.asarray([[float(jax.random.uniform(k, (), minval=1 / 3, maxval=1 / 2))
                        for k in jax.random.split(key)] for key in jax.random.split(rng, N)],
                      np.float32)
    model = _port(v)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    opt = make_adam(model.trained_parameters(), LR, WD)
    got = mcl_views_step(model, opt, {k: torch.from_numpy(a) for k, a in batch.items()},
                         MCLConfig(True, True, True), crop_frac=torch.from_numpy(frac))
    assert not model.training
    assert jmet["loss_pixpro"] > 0 and jmet["loss_emd"] > 0
    _metrics_close(got, jmet)
    _compare_step(model, opt, before, jnew, jmu, moved_stats=False, grad_tol=1e-3,
                  zero_frac=1e-3)


@pytest.mark.parametrize("eps,flax_momentum", [(1e-3, 0.99), (1e-5, 0.9)])
def test_batchnorm_train_step_matches_flax(eps, flax_momentum):
    """One train-mode BatchNorm step (the backbone's and the BiFPN's
    settings) against Flax's nn.BatchNorm: output, and running statistics
    updated with the biased batch variance (torch's own would be off by
    n / (n - 1) = 32 / 31 in the update)."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (2, 4, 4, 8)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 8).astype(np.float32)
    mean0 = rng.uniform(-0.2, 0.2, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.0, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=flax_momentum, epsilon=eps)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    m = BatchNorm2d(8, eps=eps, momentum=1.0 - flax_momentum)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    m.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = m(xt)
    got.sum().backward()  # autograd keeps the statistics it saved intact
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), upd["batch_stats"]["mean"], atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(), upd["batch_stats"]["var"], atol=1e-6)
    assert int(m.num_batches_tracked) == 1
    unbiased = (1 - m.momentum) * var0 + m.momentum * x.reshape(-1, 8).var(0, ddof=1)
    assert np.abs(unbiased - np.asarray(upd["batch_stats"]["var"])).max() > 1e-4


def test_drop_connect_statistics():
    """Per-sample: each sample is kept whole with probability 1 - rate and
    scaled by 1 / (1 - rate), so the mean is kept; seeded by the
    generator."""
    rate, n = 0.3, 20000
    x = torch.ones((n, 2, 2, 3))
    out = drop_connect(x, rate, torch.Generator().manual_seed(0))
    per = out.reshape(n, -1)
    assert torch.all((per == 0).all(dim=1) | (per == per[:, :1]).all(dim=1))
    dropped = float((per[:, 0] == 0).float().mean())
    assert abs(dropped - rate) < 0.015
    assert abs(float(out.mean()) - 1.0) < 0.03
    np.testing.assert_allclose(per[per[:, 0] > 0].numpy(), 1.0 / (1.0 - rate), rtol=1e-6)
    again = drop_connect(x, rate, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_drop_connect_runs_in_training_only(weights):
    """Train mode with the default rate drops some residuals (the output
    differs from rate 0); eval mode never does."""
    _, v = weights
    model = _port(v)
    model.backbone.drop_connect_rate = 0.2
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 32, 32, 3)).astype(np.float32))
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    with torch.no_grad():
        model.train()
        with_drop = model(x, mode="logits", generator=gen())[1]
        model.backbone.drop_connect_rate = 0.0
        model.load_state_dict(_port(v).state_dict())  # undo the statistics update
        model.train()
        no_drop = model(x, mode="logits", generator=gen())[1]
        model.eval()
        model.backbone.drop_connect_rate = 0.2
        ev1 = model(x, mode="logits", generator=gen())[1]
        model.backbone.drop_connect_rate = 0.0
        ev0 = model(x, mode="logits")[1]
    assert not torch.allclose(with_drop, no_drop)
    assert torch.equal(ev1, ev0)


def test_fused_model_under_grad_runs_the_plain_blocks(weights):
    """An eval-mode model built with fuse_mbconv=384 under autograd (step
    B's view 1) runs the plain blocks: no raise from the inference-only
    kernel, and the gradients of fuse_mbconv=0."""
    _, v = weights
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32))
    grads = []
    for fuse in (0, 384):
        m = MuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False, fuse_mbconv=fuse)
        m.load_state_dict(state_dict_from_jax(v), strict=False)
        m.eval()
        _, sgc = m(x, mode="pix")
        sgc.square().sum().backward()
        grads.append([p.grad.clone() for p in m.backbone.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_resize_cached_in_inference_serves_autograd():
    """A resize matrix first built under inference mode (the epoch-end
    eval's engine) serves a later training forward with autograd."""
    from muscle_tpu_torch.core.resize import resize_bilinear

    with torch.inference_mode():
        resize_bilinear(torch.ones((1, 3, 5, 2)), (37, 41))
    x = torch.ones((1, 3, 5, 2), requires_grad=True)
    resize_bilinear(x, (37, 41)).sum().backward()
    assert torch.isfinite(x.grad).all()


def _liveness_problem():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}

    def stacked(p, lib):
        return lib.stack([(p["a"] ** 2).sum(), lib.sin(p["b"]).sum() * p["a"].sum(),
                          0.0 * p["b"].sum() + 1.5])

    return params, stacked


@pytest.mark.parametrize("method", ["jacrev", "jvp"])
def test_term_liveness_matches_jax(method):
    """Values and per-term liveness (gradient norms, or |directional
    derivatives| along JAX's own tangents) of a stacked function with a
    dead third term."""
    params, stacked = _liveness_problem()
    jv, jl = j_term_liveness(lambda p: stacked(p, jnp), 3,
                             {k: jnp.asarray(a) for k, a in params.items()}, method)
    tangents = None
    if method == "jvp":  # the JAX package's tangents: fold_in(key(0), leaf index)
        key = jax.random.key(0)
        tangents = {k: torch.from_numpy(np.asarray(
            jax.random.normal(jax.random.fold_in(key, i), params[k].shape)))
            for i, k in enumerate(sorted(params))}
    tv, tl = term_liveness(lambda p: stacked(p, torch), 3,
                           {k: torch.from_numpy(a) for k, a in params.items()}, method,
                           tangents)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)  # f32 sin
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    assert float(tl[2]) == 0.0 and float(tl[0]) > 0 and float(tl[1]) > 0


@pytest.mark.parametrize("method", ["jacrev", "jvp"])
def test_mcl_term_grad_norms_all_terms_live(weights, method):
    """Every MCL loss term reaches the parameters, in step A (train mode)
    and step B (eval mode, random BN statistics); the model's parameters,
    statistics and mode are left as they were."""
    _, v = weights
    model = _port(v).eval()
    batch = {k: torch.from_numpy(a) for k, a in _batch(2).items()}
    sd = {k: t.clone() for k, t in model.state_dict().items()}
    norms = mcl_term_grad_norms(model, batch, torch.Generator().manual_seed(0), method=method)
    assert sorted(norms) == ["emd", "er", "focal", "imc", "pair", "pixpro", "softmargin"]
    assert all(n > 0 for n in norms.values()), norms
    assert not model.training
    for k, t in model.state_dict().items():
        assert torch.equal(t, sd[k]), k


def test_plateau_and_poly_schedules_match_jax():
    seq = [0.30, 0.31, 0.31, 0.305, 0.40, 0.40, 0.399, 0.41]
    a, b = ReduceLROnPlateau(1e-4, min_lr=1e-5), JPlateau(1e-4, min_lr=1e-5)
    assert [a.step(m) for m in seq] == [b.step(m) for m in seq]
    p, q = poly_schedule(0.01, 100), j_poly(0.01, 100)
    for t in (0, 1, 50, 99, 100, 150):
        np.testing.assert_allclose(p(t), float(q(t)), rtol=1e-6)
