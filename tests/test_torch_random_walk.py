"""The port's random walk (muscle_tpu_torch.ops.random_walk and the plain
versions of its two CUDA kernels) against the JAX package's, including
the Pallas kernels run in interpret mode, on the shapes of the JAX
package's own walk tests."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from muscle_tpu.ops import random_walk as J
from muscle_tpu.ops.pallas import banded_random_walk
from muscle_tpu_torch.ops import random_walk as P
from muscle_tpu_torch.ops.banded_walk import banded_walk, walk_band
from muscle_tpu_torch.ops.stencil_walk import stencil_walk

# The JAX package's bounds (tests/test_random_walk.py, test_banded_walk.py):
# the stencil and the vector walk differ from JAX only in summation order;
# the power walk squares T six times and the banded walk sums per column
# block, which compound float error over the steps.
TOL = {"stencil": (2e-4, 1e-6), "vector": (2e-4, 1e-6), "power": (2e-3, 1e-5),
       "banded": (2e-3, 1e-5)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(seed, c, h, w, edge_max):
    rng = np.random.default_rng(seed)
    cam = rng.uniform(0, 1, size=(c, h, w)).astype(np.float32)
    edge = rng.uniform(0, edge_max, size=(h, w)).astype(np.float32)
    return cam, edge


@pytest.mark.parametrize("size", [(17, 22), (13, 18)])
def test_path_index_matches_jax(size):
    mine, want = P.PathIndex(5, size), J.PathIndex(5, size)
    assert len(mine.path_indices) == len(want.path_indices) == len(mine.search_paths)
    for a, b in zip(mine.path_indices, want.path_indices):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mine.search_paths, want.search_paths):
        np.testing.assert_array_equal(a, b)
    for name in ("src_indices", "dst_indices"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(want, name))
    assert mine.n_vertices == want.n_vertices
    for r in (3, 5):
        assert P._direction_tables(r) == J._direction_tables(r)


def test_affinity_and_transition_match_jax():
    """The port's affinities equal JAX's exactly, and its transition matrix
    builder (the one every walk uses) matches the JAX package's reference
    formulation: dense affinity on the padded grid, crop to the image's
    vertices, beta power, column normalisation."""
    h, w, radius, beta = 13, 18, 5, 8
    hp, wp = h + radius, w + 2 * radius
    pi, jpi = P.PathIndex(radius, (hp, wp)), J.PathIndex(radius, (hp, wp))
    edge = np.random.default_rng(0).uniform(0, 1, size=(h, w)).astype(np.float32)
    edge_pad = np.pad(edge, ((0, radius), (radius, radius)), constant_values=1.0).reshape(-1)
    aff = P.edge_to_affinity(_t(edge_pad), pi)
    jaff = J.edge_to_affinity(jnp.asarray(edge_pad), jpi)
    np.testing.assert_array_equal(aff.numpy(), np.asarray(jaff))
    keep = (np.arange(h)[:, None] * wp + radius + np.arange(w)[None, :]).reshape(-1)
    dense = np.asarray(J.affinity_to_dense(jaff, jpi))[np.ix_(keep, keep)]
    want = np.asarray(J.to_transition_matrix(jnp.asarray(dense), beta, 0))
    got = P.transition_matrices(_t(edge)[None], radius, beta)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got.sum(0).numpy(), np.ones(h * w), rtol=1e-5)


# (method, seed, classes, h, w, edge max, exp_times): the JAX tests' inputs
CASES = [("vector", 1, 3, 10, 10, 0.5, 3), ("power", 1, 3, 10, 10, 0.5, 3),
         ("stencil", 7, 3, 12, 9, 0.7, 4), ("vector", 7, 3, 12, 9, 0.7, 4),
         ("banded", 1, 3, 12, 12, 0.5, 3)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[3]}x{c[4]}")
def test_propagate_matches_jax(case):
    method, seed, c, h, w, emax, exp_times = case
    cam, edge = _inputs(seed, c, h, w, emax)
    jmethod = "banded_interpret" if method == "banded" else method  # Pallas in interpret mode
    want = J.propagate_to_edge(jnp.asarray(cam), jnp.asarray(edge), exp_times=exp_times,
                               method=jmethod)
    got = P.propagate_to_edge(_t(cam), _t(edge), exp_times=exp_times, method=method)
    rtol, atol = TOL[method]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("pallas", [True, False])
def test_stencil_plain_matches_jax_stencil_walk(pallas):
    """The port's plain stencil walk (the CUDA kernel's CPU path) against
    the JAX stencil walk, with the Pallas kernel in interpret mode and with
    the XLA loop."""
    cam, edge = _inputs(9, 3, 12, 9, 0.7)
    want = J.propagate_to_edge_stencil(jnp.asarray(cam), jnp.asarray(edge), exp_times=4,
                                       pallas=pallas, interpret=True)
    got = P.propagate_to_edge_stencil(_t(cam)[None], _t(edge)[None], exp_times=4)[0]
    rtol, atol = TOL["stencil"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _banded_matrix(rng, v, band):
    """Random banded column-stochastic (V, V) matrix."""
    t = np.zeros((v, v), np.float32)
    for j in range(v):
        lo, hi = max(0, j - band), min(v, j + band + 1)
        col = rng.uniform(0, 1, hi - lo)
        t[lo:hi, j] = col / col.sum()
    return t


def test_banded_plain_matches_jax_kernel():
    """The port's plain banded walk (the CUDA kernel's CPU path) against
    the Pallas kernel in interpret mode and the dense iteration."""
    rng = np.random.default_rng(0)
    v, c, band, steps = 600, 5, 37, 8
    t = _banded_matrix(rng, v, band)
    x = rng.uniform(0, 1, (c, v)).astype(np.float32)
    want = banded_random_walk(jnp.asarray(x), jnp.asarray(t), steps=steps, band=band,
                              block_cols=128, interpret=True)
    got = banded_walk(_t(x)[None], _t(t)[None], steps=steps, band=band)[0]
    rtol, atol = TOL["banded"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)
    dense = x
    for _ in range(steps):
        dense = dense @ t
    np.testing.assert_allclose(got.numpy(), dense, rtol=rtol, atol=atol)


@pytest.mark.parametrize("method", ["stencil", "vector"])
def test_padding_with_walls_is_exact(method):
    """edge = 1 padding isolates pad vertices: the walk on a padded grid
    equals the walk on the bare grid (the refiner's canvas)."""
    cam, edge = _inputs(3, 2, 9, 9, 0.4)
    pad = 4
    cam_p = np.zeros((2, 9 + pad, 9 + pad), np.float32)
    cam_p[:, :9, :9] = cam
    edge_p = np.ones((9 + pad, 9 + pad), np.float32)
    edge_p[:9, :9] = edge
    base = P.propagate_to_edge(_t(cam), _t(edge), exp_times=3, method=method)
    padded = P.propagate_to_edge(_t(cam_p), _t(edge_p), exp_times=3, method=method)
    np.testing.assert_allclose(padded[:, :9, :9].numpy(), base.numpy(), rtol=1e-3, atol=1e-5)
    assert float(padded[:, 9:].abs().max()) == 0 and float(padded[..., 9:].abs().max()) == 0


@pytest.mark.parametrize("method", ["stencil", "banded", "vector"])
def test_batched_walk_equals_per_image(method):
    rng = np.random.default_rng(4)
    cams = rng.uniform(0, 1, size=(3, 2, 11, 8)).astype(np.float32)
    edges = rng.uniform(0, 0.6, size=(3, 11, 8)).astype(np.float32)
    batched = P.propagate_to_edge(_t(cams), _t(edges), exp_times=3, method=method)
    assert batched.shape == cams.shape
    for i in range(3):
        one = P.propagate_to_edge(_t(cams[i]), _t(edges[i]), exp_times=3, method=method)
        np.testing.assert_allclose(batched[i].numpy(), one.numpy(), rtol=1e-5, atol=1e-7)


def test_kernel_wrappers_do_not_launch_on_cpu():
    """On CPU tensors both wrappers run their plain versions: the launch
    counters stay where they were, and kernel=False gives the same walk."""
    before = (stencil_walk.launches, banded_walk.launches)
    cam, edge = _inputs(5, 2, 10, 7, 0.5)
    for method in ("stencil", "banded"):
        a = P.propagate_to_edge(_t(cam), _t(edge), exp_times=2, method=method)
        b = P.propagate_to_edge(_t(cam), _t(edge), exp_times=2, method=method, kernel=False)
        assert torch.equal(a, b)
    assert (stencil_walk.launches, banded_walk.launches) == before
    assert walk_band(128, radius=5) == 4 * 128 + 4


def test_walk_wrappers_reject_bad_input():
    x = torch.zeros((1, 2, 6, 5))
    vs = torch.zeros((1, 34, 6, 5))
    dirs = tuple((dy, dx) for dy, dx, _ in P._direction_tables(5))
    with pytest.raises(ValueError, match="shapes"):
        stencil_walk(x, vs[:, :33], torch.ones((1, 6, 5)), dirs=dirs, steps=1)
    with pytest.raises(ValueError, match="float32"):
        stencil_walk(x.double(), vs, torch.ones((1, 6, 5)), dirs=dirs, steps=1)
    with pytest.raises(RuntimeError, match="inference-only"):
        stencil_walk(x.requires_grad_(), vs, torch.ones((1, 6, 5)), dirs=dirs, steps=1)
    with pytest.raises(ValueError, match="shapes"):
        banded_walk(torch.zeros((1, 2, 30)), torch.zeros((1, 30, 29)), steps=1, band=3)
    with pytest.raises(ValueError, match="32 classes"):
        banded_walk(torch.zeros((1, 33, 30)), torch.zeros((1, 30, 30)), steps=1, band=3)
    with pytest.raises(ValueError, match="unknown method"):
        P.propagate_to_edge(torch.zeros((2, 6, 5)), torch.zeros((6, 5)), method="dense")
