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
from muscle_tpu_torch.ops import banded_walk as BW
from muscle_tpu_torch.ops import stencil_walk as S
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
    # any class count: 33 classes (more than one kernel chunk) walk on the
    # CPU and match the Pallas kernel in interpret mode
    rng = np.random.default_rng(33)
    t = _banded_matrix(rng, 30, 3)
    x33 = rng.uniform(0, 1, (33, 30)).astype(np.float32)
    got = banded_walk(_t(x33)[None], _t(t)[None], steps=4, band=3)[0]
    want = banded_random_walk(jnp.asarray(x33), jnp.asarray(t), steps=4, band=3, block_cols=128,
                              interpret=True)
    rtol, atol = TOL["banded"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)
    with pytest.raises(ValueError, match="unknown method"):
        P.propagate_to_edge(torch.zeros((2, 6, 5)), torch.zeros((6, 5)), method="dense")


def test_transition_csr_matches_dense():
    """The stencil kernel's library yardstick: the CSR builder holds the
    transposes of the dense ``transition_matrices`` (held to the JAX
    package above), block-diagonal over the batch, and one sparse product
    is one walk step."""
    rng = np.random.default_rng(6)
    edge = _t(rng.uniform(0, 0.7, size=(3, 9, 11)).astype(np.float32))
    csr = P.transition_csr(edge)
    dense = P.transition_matrices(edge)
    assert csr.layout == torch.sparse_csr and csr.shape == (3 * 99, 3 * 99)
    assert csr._nnz() <= 3 * 99 * 69
    torch.testing.assert_close(csr.to_dense(), torch.block_diag(*dense.transpose(1, 2)),
                               rtol=0, atol=0)
    x = _t(rng.uniform(0, 1, size=(3, 4, 99)).astype(np.float32))
    step = torch.sparse.mm(csr, x.transpose(1, 2).reshape(-1, 4)).reshape(3, 99, 4)
    torch.testing.assert_close(step.transpose(1, 2), x @ dense, rtol=1e-5, atol=1e-7)


# (B, C, H, W) -> (cc, ng, passes, buffers, padded width, grid)
STENCIL_PLANS = {
    (8, 20, 128, 128): (10, 2, 1, 1, 128, (4, 8, 8)),
    (8, 20, 96, 96): (10, 2, 1, 1, 96, (3, 6, 8)),
    (8, 20, 64, 64): (10, 2, 1, 1, 64, (2, 4, 8)),
    (8, 20, 94, 125): (10, 2, 1, 1, 128, (4, 6, 8)),
    (8, 5, 128, 128): (5, 1, 1, 1, 128, (4, 8, 8)),
    (1, 1, 1, 50): (1, 1, 1, 1, 52, (2, 1, 1)),
    (2, 3, 5, 3): (3, 1, 1, 1, 4, (1, 1, 2)),
    (1, 13, 40, 40): (8, 2, 1, 1, 40, (2, 3, 1)),
    (2, 33, 19, 35): (5, 2, 4, 2, 36, (2, 2, 2)),
    (1, 120, 17, 33): (5, 2, 12, 2, 36, (2, 2, 1)),
}


@pytest.mark.parametrize("shape", sorted(STENCIL_PLANS), ids=str)
def test_stencil_plan(shape):
    """The stencil kernel's tiling: 32 x 16 pixel tiles, class chunks that
    cover every class, and shared memory within a CTA's limit."""
    plan = S.stencil_plan(*shape)
    b, c, h, w = shape
    assert (plan.cc, plan.ng, plan.passes, plan.buffers, plan.width, plan.grid) == \
        STENCIL_PLANS[shape]
    assert plan.cc in S.CLASS_CHUNKS and plan.threads == plan.ng * S.GROUP_THREADS
    assert plan.passes * plan.ng * plan.cc >= c > (plan.passes - 1) * plan.ng * plan.cc
    assert plan.width % 4 == 0 and plan.width - 4 < w <= plan.width
    assert plan.grid[0] * S.TILE_W >= plan.width and plan.grid[1] * S.TILE_H >= h
    vtile = 34 * (S.TILE_H + 4) * (S.TILE_W + 8)  # vs with its top and side halo
    xtile = plan.buffers * plan.ng * plan.cc * (S.TILE_H + 8) * (S.TILE_W + 8)
    assert plan.smem == 128 + 4 * (vtile + xtile) + 24 <= S.SMEM_LIMIT


def test_stencil_width_padding_is_exact():
    """The kernel's operands padded to a multiple of 4 columns with zeros
    walk exactly as the bare grid, and the padding stays zero."""
    rng = np.random.default_rng(8)
    cam = _t(rng.uniform(0, 1, size=(2, 3, 9, 7)).astype(np.float32))
    edge = _t(rng.uniform(0, 0.6, size=(2, 9, 7)).astype(np.float32))
    vs, inv, dirs = P.stencil_operands(edge)
    x = cam * (1.0 - edge)[:, None]
    base = S.stencil_walk_plain(x, vs, inv, dirs=dirs, steps=5)
    xp, vsp, invp = (S.pad_width(t, 8) for t in (x, vs, inv))
    assert xp.shape[-1] == vsp.shape[-1] == invp.shape[-1] == 8 and xp.is_contiguous()
    assert S.pad_width(xp, 8) is xp
    padded = S.stencil_walk_plain(xp, vsp, invp, dirs=dirs, steps=5)
    torch.testing.assert_close(padded[..., :7], base, rtol=1e-6, atol=1e-7)
    assert float(padded[..., 7:].abs().max()) == 0


@pytest.mark.parametrize("c", [1, 4, 5, 20, 21, 33, 120])
def test_banded_class_chunks_round_trip(c):
    """The banded kernel's iterate layout (B, chunks, V, CPC): as few chunks
    of at most 20 classes as hold c, each a multiple of 4, zero-padded."""
    chunks, cpc = BW.class_chunks(c)
    assert chunks == -(-c // 20) and cpc % 4 == 0 and cpc <= 20
    assert chunks * cpc >= c > chunks * cpc - 4 * chunks
    x = _t(np.random.default_rng(c).uniform(0, 1, size=(2, c, 37)).astype(np.float32))
    packed = BW.to_chunks(x, chunks, cpc)
    assert packed.shape == (2, chunks, 37, cpc) and packed.is_contiguous()
    assert torch.equal(packed[0, 0, 5, 0], x[0, 0, 5])
    assert float(packed.abs().sum()) == pytest.approx(float(x.abs().sum()), rel=1e-6)
    assert torch.equal(BW.from_chunks(packed, c), x)
