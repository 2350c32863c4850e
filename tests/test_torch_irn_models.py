"""The port's ResNet-50 and IRN EdgeDisplacement (muscle_tpu_torch.models)
against the JAX package's Flax modules on the same weights, and the IRN
weight converter against the JAX package's (crop 64)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from muscle_tpu.convert.torch_to_flax import convert_irn_state_dict
from muscle_tpu.models import EdgeDisplacement as JEdgeDisplacement
from muscle_tpu.models.resnet50 import ResNet50 as JResNet50
from muscle_tpu_torch.convert import irn_state_dict_from_jax
from muscle_tpu_torch.models import EdgeDisplacement

# f32 on both sides through 50+ chained convolutions: summation order only
ATOL, RTOL = 1e-4, 1e-4
CROP = 64


def make_irn(seed: int = 2, crop: int = CROP):
    """(Flax module, its variables, the port's state dict) holding the same
    weights: the JAX init, carried across by the port's converter, with
    random affine parameters and running statistics for every norm (the
    init's identity norms would leave FixedBatchNorm's statistics untested)
    and a random MeanShift, carried back by the JAX package's converter."""
    jm = JEdgeDisplacement(crop_size=crop)
    v = jax.jit(jm.init)({"params": jax.random.key(seed)}, jnp.zeros((2, crop, crop, 3)))
    sd = irn_state_dict_from_jax(jax.tree.map(np.asarray, v))
    rng = np.random.default_rng(seed)

    def uniform(lo, hi, n):
        return torch.tensor(rng.uniform(lo, hi, n), dtype=torch.float32)

    for k in list(sd):
        n = sd[k].shape
        if k.endswith("running_var"):
            base = k[: -len("running_var")]
            sd[base + "running_mean"] = uniform(-0.2, 0.2, n)
            sd[k] = uniform(0.5, 1.0, n)
        if (k.endswith(".weight") and sd[k].ndim == 1):  # batch and group norm scales
            sd[k] = uniform(0.75, 1.25, n)
            sd[k[: -len("weight")] + "bias"] = uniform(-0.1, 0.1, n)
    sd["mean_shift.running_mean"] = uniform(-0.1, 0.1, 2)
    variables = convert_irn_state_dict({k: t.numpy() for k, t in sd.items()})
    return jm, variables, sd


def port_model(sd, crop: int = CROP) -> EdgeDisplacement:
    m = EdgeDisplacement(crop_size=crop)
    missing, unexpected = m.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return m.eval()


@pytest.fixture(scope="module")
def irn():
    jm, variables, sd = make_irn()
    return jm, variables, port_model(sd)


def _pair(h, w, seed):
    x = np.random.default_rng(seed).normal(size=(h, w, 3)).astype(np.float32)
    return np.stack([x, x[:, ::-1]])


@pytest.mark.parametrize("hw", [(50, 44), (44, 50)])
def test_resnet50_stages_match_flax(irn, hw):
    jm, variables, model = irn
    x = np.zeros((2, CROP, CROP, 3), np.float32)
    x[:, : hw[0], : hw[1]] = _pair(*hw, seed=1)
    sub = {"params": variables["params"]["net"]["resnet50"],
           "batch_stats": variables["batch_stats"]["net"]["resnet50"]}
    want = JResNet50(strides=(2, 2, 2, 1)).apply(sub, jnp.asarray(x))
    with torch.inference_mode():
        got = model.resnet50(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("hw", [(50, 44), (44, 50)])
def test_edge_displacement_matches_flax(irn, hw, valid):
    jm, variables, model = irn
    x = _pair(*hw, seed=2)
    vh = None
    if valid:  # the pair top-left in a canvas, valid (h, w) smaller than it
        vh = np.array([hw[0] - 13, hw[1] - 7], np.int32)
        x[:, vh[0]:] = 0
        x[:, :, vh[1]:] = 0
    je, jd = jm.apply(variables, jnp.asarray(x), valid_hw=None if vh is None else jnp.asarray(vh))
    with torch.inference_mode():
        te, td = model(torch.from_numpy(x), valid_hw=None if vh is None else torch.from_numpy(vh))
        edge_only = model.edge(torch.from_numpy(x),
                               valid_hw=None if vh is None else torch.from_numpy(vh))
    fh, fw = (hw[0] - 1) // 4 + 1, (hw[1] - 1) // 4 + 1
    assert te.shape == (fh, fw) and td.shape == (2, fh, fw)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=RTOL)
    assert torch.equal(edge_only, te)


def test_batched_pairs_equal_single_pairs(irn):
    _, _, model = irn
    xs = np.stack([_pair(48, 40, seed=3), _pair(48, 40, seed=4)])
    vh = np.array([[48, 40], [33, 29]], np.int64)
    with torch.inference_mode():
        be, bd = model(torch.from_numpy(xs), valid_hw=torch.from_numpy(vh))
        for i in range(2):
            e, d = model(torch.from_numpy(xs[i]), valid_hw=torch.from_numpy(vh[i]))
            torch.testing.assert_close(be[i], e, atol=1e-6, rtol=1e-5)
            torch.testing.assert_close(bd[i], d, atol=1e-6, rtol=1e-5)


def test_irn_converter_round_trip(irn):
    """The port's converter is the exact inverse of the JAX package's, and
    its keys are the port module's (the reference's) state-dict keys."""
    _, variables, model = irn
    sd = irn_state_dict_from_jax(jax.tree.map(np.asarray, variables))
    own = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == own
    back = convert_irn_state_dict({k: t.numpy() for k, t in sd.items()})
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), path
