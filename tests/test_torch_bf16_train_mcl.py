"""The port's MCL training steps at bfloat16 against the JAX package's
``mcl_train_step`` / ``mcl_views_step`` on ``MuSCLe(dtype=jnp.bfloat16)``,
from the same weights (carried across by ``state_dict_from_jax``) and
batch: MuSCLe-b1 enc, crop 64, views 32, batch 4, drop-connect off on
both sides, as tests/test_torch_mcl.py does at float32.

Step A starts from a fresh bf16 init's classifier kernel (bfloat16, as
the JAX package's ``init`` makes it), so its logits and CAMs are bf16 and
Adam's first step promotes the kernel to float32 while its moments stay
bf16 (optax's dtypes, pinned in ``test_classifier_kernel_dtypes``).  Step
B runs where training reaches it, with a float32 kernel.

bf16 makes absolute limits meaningless: two bf16 programs that round at
different points (the JAX step is jitted, and XLA keeps fused elementwise
chains in float32; the two sides sum in other orders) differ by about as
much as either differs from float32.  So every quantity is held to JAX's
own bf16-vs-f32 distance on it (``excess``): for each loss term, each
parameter's gradient, each parameter's Adam update and each BN
statistic's change,

    mean |port - jax16| <= MEAN_FACTOR * mean |jax16 - jax32| + floor
    max  |port - jax16| <= MAX_FACTOR  * max  |jax16 - jax32| + floor

with floor = FLOOR_ULPS bf16 half-ulps (2^-8) of the quantity's largest
JAX value, and for gradients at least ZERO_SHARE of the model's largest
gradient (a bias feeding a train-mode BN has a zero gradient in exact
arithmetic; both sides compute rounding noise there).  The updates of
Adam's first step are about lr * sign(g), so their mean distance counts
the entries whose sign the two sides decide differently.  The control
that bf16 ran: the port's losses and gradients are farther from JAX's f32
step than RAN_FACTOR of JAX's own bf16-vs-f32 distance.

The reference's silu and sigmoid are taken in f32 and rounded once
(``_round_once``, test_torch_bf16_mbconv.py says why)."""

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
from muscle_tpu.training.state import make_adam as j_make_adam
from muscle_tpu_torch.convert import load_into, state_dict_from_jax
from muscle_tpu_torch.models import MuSCLe, classifier_as
from muscle_tpu_torch.training import (
    MCLConfig,
    make_adam,
    mcl_train_step,
    mcl_views_step,
    minimize,
)
from test_torch_bf16_mbconv import _round_once  # noqa: F401  (autouse)
from test_torch_mcl import (
    _batch,
    _live_labels,
    _plain,
    _randomize_bn,
    masked_overlap_cos_safe,
)

BACKBONE = "efficientnet-b1"
N, CROP = 4, 64
LR, WD = 1e-4, 5e-5
BF16 = torch.bfloat16
# limits in units of JAX's own bf16-vs-f32 distance (module docstring)
MEAN_FACTOR, MAX_FACTOR, FLOOR_ULPS, ZERO_SHARE, RAN_FACTOR = 2.0, 3.0, 4.0, 2e-2, 0.5
HALF_ULP = 2.0 ** -8
LOSS_BATCHES = 4  # batches whose loss terms are compared
UPDATE_TOL, FLIP_FLOOR = 2e-2, 1e-3  # Adam's step: of lr; of all entries
SATURATED = 1e-6  # |g + wd w| above 100 Adam eps: the first step is lr * sign


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def excess(port, j16, j32, floor: float = 0.0) -> float:
    """The larger of the mean and max distances of ``port`` from ``j16``
    over their limits (module docstring): <= 1 passes."""
    p, a, b = _np(port), _np(j16), _np(j32)
    assert p.shape == a.shape == b.shape
    d, ref = np.abs(p - a), np.abs(a - b)
    floor = max(floor, FLOOR_ULPS * HALF_ULP * np.abs(a).max())
    if floor == 0.0 and d.max() == 0.0:
        return 0.0
    return max(d.mean() / (MEAN_FACTOR * ref.mean() + floor),
               d.max() / (MAX_FACTOR * ref.max() + floor))


def _ran(port: dict, j16: dict, j32: dict) -> None:
    """bf16 ran on the port: its values stand off JAX's f32 ones."""
    far = np.mean([np.abs(_np(port[k]) - _np(j32[k])).mean() for k in j16])
    own = np.mean([np.abs(_np(j16[k]) - _np(j32[k])).mean() for k in j16])
    assert far >= RAN_FACTOR * own, (far, own)


@pytest.fixture(scope="module")
def weights():
    """A bf16 init (its classifier kernel bf16, JAX's own) with random BN
    statistics, as numpy."""
    jm = JMuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False, dtype=jnp.bfloat16)
    v = jm.init({"params": jax.random.key(0)}, jnp.zeros((1, CROP, CROP, 3)), mode="cam")
    return _randomize_bn(_plain(v), seed=0)


def _as_f32(v):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), v)


def _with_f32_kernel(v):
    """The tree with its classifier kernel float32: a checkpoint's."""
    return {**v, "params": {**v["params"], "fc": {"kernel": np.asarray(
        v["params"]["fc"]["kernel"], np.float32)}}}


def _port(v):
    m = MuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False)
    classifier_as(m, BF16)
    load_into(m, state_dict_from_jax(v))
    m.backbone.drop_connect_rate = 0.0
    return m


def _jax_runs(monkeypatch, fn, v, batches, rng, cfg):
    """JAX's step on the bf16 model and on the f32 model from the same
    values, once per batch, each from the initial state: per dtype a list
    of (new state, float metrics, Adam's first moment).  One optimizer per
    dtype, so each dtype compiles once; drop-connect is the identity."""
    monkeypatch.setattr(jeff, "drop_connect", lambda x, rate, key: x)
    out = []
    for dtype, tree in ((jnp.bfloat16, v), (jnp.float32, _as_f32(v))):
        jm = JMuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False, dtype=dtype)
        tx = j_make_adam(LR, WD)
        runs = []
        for b in batches:
            state = create_train_state(jax.tree.map(jnp.asarray, tree), tx)
            new, metrics = fn(jm, tx, state, {k: jnp.asarray(a) for k, a in b.items()}, rng,
                              cfg)
            runs.append((new, {k: float(m) for k, m in metrics.items()},
                         new.opt_state.inner_state[1].mu))
        out.append(runs)
    return out


def _jax_sd(new, mu, before, names):
    """JAX's updated parameters and statistics, and its gradients from
    Adam's first moment (mu = (1 - b1)(g + wd w)), in the port's names."""
    after = state_dict_from_jax({"params": _plain(new.params),
                                 "batch_stats": _plain(new.batch_stats)})
    j_mu = state_dict_from_jax({"params": _plain(mu)})
    grads = {k: _np(j_mu[k]) / 0.1 - WD * _np(before[k]) for k in names}
    return after, grads


def _check_step(model, opt, before, j16, j32, moved_stats: bool) -> dict:
    """Every parameter's gradient and every BN statistic's change against
    JAX's pair (``excess``), and the Adam step: the entries whose update
    the port moves the other way than JAX's bf16 step, at most
    MEAN_FACTOR times those where JAX's f32 and bf16 steps differ (plus
    FLIP_FLOOR of all entries), and the others, where both steps
    saturate, within UPDATE_TOL of lr of JAX's.  Returns the worst
    readings."""
    names = {id(p): n for n, p in model.named_parameters()}
    keys = [names[id(p)] for p in opt.param_groups[0]["params"]]
    (new16, _, mu16), (new32, _, mu32) = j16, j32
    a16, g16 = _jax_sd(new16, mu16, before, keys)
    a32, g32 = _jax_sd(new32, mu32, before, keys)
    port = dict(model.named_parameters())
    zero = ZERO_SHARE * max(np.abs(g).max() for g in g16.values())
    worst = {"grad": (0.0, ""), "stat": (0.0, ""), "update_same_sign": (0.0, "")}

    def note(kind, value, k):
        if value >= worst[kind][0]:
            worst[kind] = (float(value), k)

    flips = own = total = 0
    for k in keys:
        p = port[k]
        note("grad", excess(p.grad, g16[k], g32[k], zero), k)
        w0 = _np(before[k])
        du, d16, d32 = _np(p) - w0, _np(a16[k]) - w0, _np(a32[k]) - w0
        same = np.sign(du) == np.sign(d16)
        flips += int((~same).sum())
        own += int((np.sign(d32) != np.sign(d16)).sum())
        total += du.size
        # where both sides' g + wd w stand well above Adam's eps the step
        # saturates at lr: the same step on both sides
        sat = same & (np.abs(_np(p.grad) + WD * w0) > SATURATED) & (
            np.abs(g16[k] + WD * w0) > SATURATED)
        if sat.any():
            note("update_same_sign", np.abs(du - d16)[sat].max() / (UPDATE_TOL * LR), k)
    worst["flips"] = (flips / (MEAN_FACTOR * own + FLIP_FLOOR * total), f"{flips}/{own}/{total}")
    sd = model.state_dict()
    for k in a16:
        if k.endswith("running_mean") or k.endswith("running_var"):
            s0 = _np(before[k])
            if moved_stats:
                note("stat", excess(_np(sd[k]) - s0, _np(a16[k]) - s0, _np(a32[k]) - s0), k)
            else:
                assert torch.equal(sd[k], before[k]), k
    _ran({k: port[k].grad for k in keys}, g16, g32)
    return worst


def _check_metrics(got: list, j16: list, j32: list) -> dict:
    """Each loss term over the batches: mean |port - jax16| within
    MEAN_FACTOR mean |jax16 - jax32| plus the floor (FLOOR_ULPS half-ulps
    of its largest value).  One scalar's distance is too noisy a yardstick
    (IMC's temperature of 0.1 amplifies a bf16 rounding of its logits
    tenfold), a few batches' mean is not.  Returns each term's ratio."""
    for g, w in zip(got, j16):
        assert sorted(g) == sorted(w)
        assert all(v.dtype == torch.float32 for v in g.values())
    ratios = {}
    for k in j16[0]:
        p = np.asarray([float(g[k]) for g in got])
        a = np.asarray([w[k] for w in j16])
        b = np.asarray([w[k] for w in j32])
        floor = FLOOR_ULPS * HALF_ULP * np.abs(a).max()
        ratios[k] = float(np.abs(p - a).mean() / (MEAN_FACTOR * np.abs(a - b).mean() + floor))
    return ratios


def _port_runs(step, v, batches, **kw):
    """The port's step from the same initial model on each batch: the
    metrics of each, and the first run's (model, optimizer, initial
    state)."""
    metrics, first = [], None
    for b in batches:
        model = _port(v)
        before = {k: t.clone() for k, t in model.state_dict().items()}
        opt = make_adam(model.trained_parameters(), LR, WD)
        metrics.append(step(model, opt, {k: torch.from_numpy(a) for k, a in b.items()},
                            compute_dtype=BF16, **kw))
        first = first or (model, opt, before)
    return metrics, first


def test_step_a_matches_jax_bf16(weights, monkeypatch):
    """Step A at epoch >= 4 (IMC on), train mode, from the bf16 kernel:
    loss terms over LOSS_BATCHES batches; on the first, gradients, the Adam
    step (the kernel promoted to float32, its moments bf16) and the BN
    statistics."""
    batches = [_batch(s) for s in range(LOSS_BATCHES)]
    cfg = MCLConfig(use_imc=True)
    j16, j32 = _jax_runs(monkeypatch, j_train_step, weights, batches, jax.random.key(1),
                         JMCLConfig(use_imc=True))
    assert j16[0][0].params["fc"]["kernel"].dtype == jnp.float32
    assert j16[0][0].opt_state.inner_state[1].mu["fc"]["kernel"].dtype == jnp.bfloat16
    assert _port(weights).fc.weight.dtype == BF16
    got, (model, opt, before) = _port_runs(lambda m, o, b, **kw: mcl_train_step(m, o, b, cfg,
                                                                              **kw),
                                           weights, batches)
    assert model.fc.weight.dtype == torch.float32
    assert opt.state[model.fc.weight]["exp_avg"].dtype == BF16
    assert all(r[1]["loss_imc"] > 0 and r[1]["loss_er"] > 0 for r in j16)
    ratios = _check_metrics(got, [r[1] for r in j16], [r[1] for r in j32])
    _ran(got[0], j16[0][1], j32[0][1])
    worst = _check_step(model, opt, before, j16[0], j32[0], moved_stats=True)
    assert all(r <= 1.0 for r in ratios.values()), ratios
    assert all(v <= 1.0 for v, _ in worst.values()), worst


def test_step_b_matches_jax_bf16(weights, monkeypatch):
    """Step B at epoch >= 12 (PixPro + EMD), eval mode with gradients for
    view 1, a float32 classifier kernel, EMD's crop fractions from JAX's
    key: loss terms over LOSS_BATCHES batches; on the first, gradients,
    the Adam step, BN statistics unmoved.  JAX's PixPro runs with
    ``masked_overlap_cos_safe`` (test_torch_mcl.py says why)."""
    v = _with_f32_kernel(weights)
    batches = [_live_labels(_port(v), _batch(s)) for s in range(1, 1 + LOSS_BATCHES)]
    rng = jax.random.key(2)
    monkeypatch.setattr(jcon, "_masked_overlap_cos", masked_overlap_cos_safe)
    j16, j32 = _jax_runs(monkeypatch, j_views_step, v, batches, rng,
                         JMCLConfig(True, True, True))
    frac = np.asarray([[float(jax.random.uniform(k, (), minval=1 / 3, maxval=1 / 2))
                        for k in jax.random.split(key)] for key in jax.random.split(rng, N)],
                      np.float32)
    cfg = MCLConfig(True, True, True)
    got, (model, opt, before) = _port_runs(
        lambda m, o, b, **kw: mcl_views_step(m, o, b, cfg, crop_frac=torch.from_numpy(frac),
                                             **kw), v, batches)
    assert model.fc.weight.dtype == torch.float32
    assert all(r[1]["loss_pixpro"] > 0 and r[1]["loss_emd"] > 0 for r in j16)
    ratios = _check_metrics(got, [r[1] for r in j16], [r[1] for r in j32])
    worst = _check_step(model, opt, before, j16[0], j32[0], moved_stats=False)
    assert all(r <= 1.0 for r in ratios.values()), ratios
    assert all(v <= 1.0 for v, _ in worst.values()), worst


def test_train_mode_output_and_loss_dtypes_match_jax(weights):
    """Every train-mode output of modes 'cam' and 'pix', and every loss
    term of steps A and B, has JAX's dtype at bf16 (the JAX side traced,
    not compiled), with a bf16 classifier kernel (a fresh init) and with a
    float32 one (a checkpoint's)."""
    import functools

    from muscle_tpu_torch.training.mcl import _terms_a, _terms_b, decode_image

    batch = _batch(0)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    cfg = MCLConfig(True, True, True)
    jm = JMuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False, dtype=jnp.bfloat16)
    tx = j_make_adam(LR, WD)

    def names(tree):
        return [str(a.dtype).split(".")[-1] for a in tree]

    for v in (weights, _with_f32_kernel(weights)):
        model = _port(v).train()
        state = create_train_state(jax.tree.map(jnp.asarray, v), tx)
        x = decode_image(tb, "img")
        for mode in ("cam", "pix"):
            want = jax.eval_shape(lambda s, x: jm.apply(
                s.variables(), x, mode=mode, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.key(0)})[0], state, jnp.asarray(x.numpy()))
            with torch.no_grad():
                got = model(x.to(BF16), mode=mode)
            assert names(got) == names(want), (mode, names(got), names(want))
        with torch.no_grad():
            terms = _terms_a(model, x.to(BF16), tb["label"], cfg, None)
            terms.update(_terms_b(model.eval(), decode_image(tb, "view1").to(BF16),
                                  decode_image(tb, "view2").to(BF16), tb, cfg, None, None))
        _, ja = jax.eval_shape(functools.partial(j_train_step, jm, tx,
                                                 cfg=JMCLConfig(use_imc=True)),
                               state, jb, jax.random.key(0))
        _, jv = jax.eval_shape(functools.partial(j_views_step, jm, tx,
                                                 cfg=JMCLConfig(True, True, True)),
                               state, jb, jax.random.key(0))
        want = {k[len("loss_"):]: m for k, m in {**ja, **jv}.items() if k != "loss"}
        assert sorted(terms) == sorted(want)
        for k in terms:
            assert names([terms[k]]) == names([want[k]]), (k, terms[k].dtype, want[k].dtype)


def test_classifier_kernel_dtypes():
    """The JAX package's behaviour the port follows: a bf16 model's fresh
    classifier kernel is bf16 and every other parameter float32; optax's
    first Adam step keeps the kernel's moments bf16 and, its learning rate
    being a float32 array, leaves the kernel float32; the second step's
    float32 gradient promotes the moments.  The port: ``classifier_as``
    gives the bf16 kernel, a checkpoint's float32 ``fc.weight`` replaces it
    in float32, and ``minimize`` steps it as optax does."""
    jm = JMuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0)},
                                            jnp.zeros((1, 32, 32, 3)), mode="cam"))
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    low = [jax.tree_util.keystr(p) for p, a in leaves if a.dtype != jnp.float32]
    assert low == ["['fc']['kernel']"], low

    tx = j_make_adam(LR, WD)
    params = {"a": jnp.ones((3,)), "fc": jnp.full((2, 3), 0.5, jnp.bfloat16)}
    state = tx.init(params)
    dtypes = []
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.3, p.dtype), params)
        updates, state = tx.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)  # the package's update
        mu = state.inner_state[1].mu["fc"]
        dtypes.append((params["fc"].dtype, mu.dtype))
    assert dtypes == [(jnp.float32, jnp.bfloat16), (jnp.float32, jnp.float32)], dtypes

    model = MuSCLe(backbone_name=BACKBONE, mode="enc", last_pooling=False)
    classifier_as(model, BF16)
    assert model.fc.weight.dtype == BF16
    assert {p.dtype for n, p in model.named_parameters() if n != "fc.weight"} == {torch.float32}
    w = torch.randn(21, 320)
    param = model.fc.weight
    load_into(model, {"fc.weight": w})
    assert model.fc.weight is param and model.fc.weight.dtype == torch.float32
    assert torch.equal(model.fc.weight, w)

    classifier_as(model, BF16)
    opt = make_adam([model.fc.weight], LR, WD)
    seen = []
    for _ in range(2):
        w0 = model.fc.weight.detach().float().clone()
        minimize(opt, (model.fc.weight * 0.3).sum())
        seen.append((model.fc.weight.dtype, opt.state[model.fc.weight]["exp_avg"].dtype))
        # every entry moved by about lr (Adam's early steps: ~lr * sign(g));
        # torch's own bf16 step would round the move away
        step = (model.fc.weight.detach() - w0).abs()
        assert torch.allclose(step, torch.full_like(step, LR), rtol=2e-2), step.max()
    assert seen == [(torch.float32, BF16), (torch.float32, torch.float32)], seen


@pytest.mark.parametrize("method", ["jacrev", "jvp"])
def test_mcl_term_grad_norms_bf16_all_terms_live(weights, method):
    """Every MCL loss term reaches the parameters at bf16, by gradient
    norms and by directional derivatives (under ``torch.func.jvp`` the
    batch norms take one float32 batch norm and the convolutions record
    their casts); the model's parameters, statistics and mode are left as
    they were."""
    from muscle_tpu_torch.training import mcl_term_grad_norms

    model = _port(weights).eval()
    batch = {k: torch.from_numpy(a) for k, a in _batch(2).items()}
    sd = {k: t.clone() for k, t in model.state_dict().items()}
    norms = mcl_term_grad_norms(model, batch, torch.Generator().manual_seed(0),
                                views_train_mode=True, method=method, compute_dtype=BF16)
    assert sorted(norms) == ["emd", "er", "focal", "imc", "pair", "pixpro", "softmargin"]
    assert all(n > 0 for n in norms.values()), norms
    assert not model.training
    for k, t in model.state_dict().items():
        assert torch.equal(t, sd[k]), k
