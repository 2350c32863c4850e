"""The port's data parallelism (muscle_tpu_torch/parallel) module by module
against the JAX package on the global batch: two CPU ranks over gloo (one
launch for the file, the rank bodies in tests/torch_dp_ranks.py) run the
cross-rank batch norm at float32 and bfloat16, IMC, the ER top-k loss, the
IRN losses and the column-sharded random walk on their halves of a global
batch; their shares summed and their rows concatenated are held to the
JAX function on the whole batch (the walk to JAX's on a 2-device mesh).
Also ``local_batch_slice``, the loader's rank slices, and the helpers'
one-process identities.

Tolerances: the batch norm's output and input gradient 1e-5 (f32; the
statistics combined from the ranks' means and squared deviations, float32
sums in another order), its scale and bias gradients and running
statistics 1e-6 of their largest; at bf16, bit-equal on 99.9% of the
entries as the one-process BN against Flax (test_torch_bf16_train_seg.py).
Losses 1e-5 relative, their input gradients 1e-5 of the largest
(test_torch_losses.py, test_torch_train_irn.py); the walk at
test_sharding.py's rtol 2e-3, atol 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import muscle_tpu.parallel.mesh as jmesh
from muscle_tpu.losses import er_topk_loss as j_er
from muscle_tpu.losses import image_level_contrast as j_imc
from muscle_tpu.ops import propagate_to_edge_sharded as j_walk_sharded
from muscle_tpu.ops.random_walk import PathIndex as JPathIndex
from muscle_tpu.training.irn import irn_losses as j_irn_losses
from muscle_tpu_torch import parallel
from muscle_tpu_torch.data.loader import PrefetchLoader
from muscle_tpu_torch.ops.random_walk import PathIndex

import torch_dp_ranks

WORLD = 2
BN_N, BN_HW, BN_C = 4, 5, 16
IRN_GRID = 16


def _spec():
    rng = np.random.default_rng(0)
    bn = {"x": rng.normal(1.0, 2.0, (BN_N, BN_HW, BN_HW + 2, BN_C)).astype(np.float32),
          "g": rng.normal(size=(BN_N, BN_HW, BN_HW + 2, BN_C)).astype(np.float32),
          "scale": rng.uniform(0.5, 1.5, BN_C).astype(np.float32),
          "bias": rng.uniform(-0.5, 0.5, BN_C).astype(np.float32),
          "mean": rng.uniform(-0.2, 0.2, BN_C).astype(np.float32),
          "var": rng.uniform(0.5, 1.0, BN_C).astype(np.float32)}
    # bf16-representable inputs: both dtypes see the same numbers
    for k in ("x", "g"):
        bn[k] = torch.from_numpy(bn[k]).to(torch.bfloat16).float().numpy()
    imc_label = np.zeros((8, 20), np.float32)
    for i, c in enumerate((3, 3, 5, 3, 9, 5, 3, 12)):  # positives and negatives across ranks
        imc_label[i, c] = 1.0
    imc_label[7, 5] = 1.0
    er_label = np.zeros((4, 20), np.float32)
    er_label[[0, 1, 1, 2, 3], [2, 4, 7, 7, 19]] = 1.0
    pi = PathIndex(5, (IRN_GRID, IRN_GRID))
    d, p = pi.dst_indices.shape
    r = rng.random((4, d, p))
    return {
        "bn": bn,
        "imc": {"emb": rng.normal(size=(8, 24)).astype(np.float32), "label": imc_label},
        "er": {"cams": rng.uniform(0, 1, (4, 12, 10, 21)).astype(np.float32),
               "sgcs": rng.uniform(0, 1, (4, 12, 10, 21)).astype(np.float32),
               "label": er_label},
        "irn": {"grid": IRN_GRID,
                "edge": rng.normal(0, 2, (4, IRN_GRID ** 2)).astype(np.float32),
                "dp": rng.normal(0, 3, (4, IRN_GRID ** 2, 2)).astype(np.float32),
                "bg": (r < 0.3).astype(np.float32),
                "fg": ((r >= 0.3) & (r < 0.5)).astype(np.float32),
                "neg": ((r >= 0.5) & (r < 0.7)).astype(np.float32)},
        "walk": {"cam": rng.uniform(0, 1, (3, 8, 16)).astype(np.float32),
                 "edge": rng.uniform(0, 0.5, (8, 16)).astype(np.float32), "exp_times": 3},
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    spec = _spec()
    return spec, torch_dp_ranks.launch(torch_dp_ranks.module_checks, WORLD,
                                       tmp_path_factory.mktemp("ranks"), spec)


def _cat(res, *keys):
    parts = []
    for r in res:
        for k in keys:
            r = r[k]
        parts.append(r.float().numpy())
    return np.concatenate(parts)


def _flax_bn(spec, dtype):
    d = spec["bn"]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3, dtype=dtype)
    params = {"scale": jnp.asarray(d["scale"]), "bias": jnp.asarray(d["bias"])}
    stats = {"mean": jnp.asarray(d["mean"]), "var": jnp.asarray(d["var"])}

    def f(p, x):
        return bn.apply({"params": p, "batch_stats": stats}, x, mutable=["batch_stats"])

    x = jnp.asarray(d["x"], dtype)
    (y, upd), vjp = jax.vjp(f, params, x)
    dp, dx = vjp((jnp.asarray(d["g"], dtype), jax.tree.map(jnp.zeros_like, upd)))
    return y, dx, dp, upd["batch_stats"]


def _same_bits_share(got, want):
    return float((np.asarray(got, np.float32) == np.asarray(want, np.float32)).mean())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_rank_batch_norm_matches_flax_on_the_global_batch(ranks, dtype):
    spec, res = ranks
    jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
    y, dx, dp, stats = _flax_bn(spec, jdtype)
    tag = "bn_" + dtype
    got_y, got_dx = _cat(res, tag, "y"), _cat(res, tag, "dx")
    if dtype == "f32":
        np.testing.assert_allclose(got_y, np.asarray(y), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got_dx, np.asarray(dx), atol=1e-5 * np.abs(dx).max(), rtol=0)
    else:
        assert _same_bits_share(got_y, y) >= 0.999
        assert _same_bits_share(got_dx, dx) >= 0.999
    for leaf, key in (("scale", "dscale"), ("bias", "dbias")):  # each rank's share
        want = np.asarray(dp[leaf], np.float32)
        got = sum(r[tag][key].numpy() for r in res)
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
    for r in res:  # every rank's running statistics are the global batch's
        assert r[tag]["count"] == 1
        for k in ("mean", "var"):
            want = np.asarray(stats[k])
            np.testing.assert_allclose(r[tag][k].numpy(), want, atol=1e-6 * np.abs(want).max(),
                                       rtol=0, err_msg=k)


def test_imc_on_ranks_matches_jax(ranks):
    spec, res = ranks
    d = spec["imc"]
    loss, grad = jax.value_and_grad(j_imc)(jnp.asarray(d["emb"]), jnp.asarray(d["label"]))
    assert float(loss) > 0
    np.testing.assert_allclose(sum(float(r["imc"]["loss"]) for r in res), float(loss),
                               rtol=1e-5)
    np.testing.assert_allclose(_cat(res, "imc", "grad"), np.asarray(grad),
                               atol=1e-5 * np.abs(grad).max(), rtol=0)


def test_er_topk_on_ranks_matches_jax(ranks):
    spec, res = ranks
    d = spec["er"]

    def f(s):
        return j_er(jnp.asarray(d["cams"]), s, jnp.sum(jnp.asarray(d["label"])))

    loss, grad = jax.value_and_grad(f)(jnp.asarray(d["sgcs"]))
    np.testing.assert_allclose(sum(float(r["er"]["loss"]) for r in res), float(loss), rtol=1e-5)
    np.testing.assert_allclose(_cat(res, "er", "grad"), np.asarray(grad),
                               atol=1e-5 * np.abs(grad).max(), rtol=0)


def test_irn_losses_on_ranks_match_jax(ranks):
    spec, res = ranks
    d = spec["irn"]
    jpi = JPathIndex(5, (IRN_GRID, IRN_GRID))

    def f(e, q):
        return j_irn_losses(e, q, *(jnp.asarray(d[k]) for k in ("bg", "fg", "neg")), jpi)

    (_, jm), jg = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(d["edge"]), jnp.asarray(d["dp"]))
    for k in jm:
        np.testing.assert_allclose(sum(float(r["irn"]["metrics"][k]) for r in res), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    for key, want in (("edge_grad", jg[0]), ("dp_grad", jg[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(_cat(res, "irn", key), want, atol=1e-5 * np.abs(want).max(),
                                   rtol=0, err_msg=key)


def test_sharded_walk_on_ranks_matches_jax_mesh(ranks):
    """Each rank's V / 2 columns of T, the (C, V) iterate all-gathered per
    step, against JAX's walk with T column-sharded over a 2-device mesh
    (and against the one-process dense walk)."""
    from muscle_tpu_torch.ops.random_walk import propagate_to_edge

    spec, res = ranks
    d = spec["walk"]
    want = np.asarray(j_walk_sharded(jnp.asarray(d["cam"]), jnp.asarray(d["edge"]),
                                     jmesh.make_mesh(WORLD), exp_times=d["exp_times"]))
    for r in res:
        np.testing.assert_allclose(r["walk"].numpy(), want, rtol=2e-3, atol=1e-5)
    dense = propagate_to_edge(torch.from_numpy(d["cam"]), torch.from_numpy(d["edge"]),
                              exp_times=d["exp_times"], method="vector")
    np.testing.assert_allclose(res[0]["walk"].numpy(), dense.numpy(), rtol=1e-5, atol=1e-7)


def test_sharded_walk_refuses_indivisible_vertices(ranks):
    """JAX's ValueError when the ranks do not divide V, here with a stand-in
    group of 3 ranks."""
    from muscle_tpu_torch.ops import random_walk

    class _Three:
        pass

    orig = random_walk.world
    random_walk.world = lambda g: 3 if isinstance(g, _Three) else orig(g)
    try:
        with pytest.raises(ValueError, match="not divisible"):
            random_walk.propagate_to_edge_sharded(torch.zeros(2, 4, 4), torch.zeros(4, 4),
                                                  _Three())
    finally:
        random_walk.world = orig


@pytest.mark.parametrize("gb,pi,pc", [(32, 1, 4), (8, 0, 2), (8, 1, 2), (6, 2, 3), (5, 0, 1)])
def test_local_batch_slice_matches_jax(gb, pi, pc):
    assert parallel.local_batch_slice(gb, pi, pc) == jmesh.local_batch_slice(gb, pi, pc)


def test_local_batch_slice_refuses_indivisible():
    with pytest.raises(ValueError):
        jmesh.local_batch_slice(30, 0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.local_batch_slice(30, 0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        PrefetchLoader([], 6, rank=(0, 4))


class _Samples:
    def __len__(self):
        return 22

    def get(self, idx, rng):
        return {"idx": np.asarray(idx), "draw": rng.random(3)}


@pytest.mark.parametrize("world", [2, 4])
def test_loader_rank_slices_make_the_one_process_batches(world):
    """The ranks' batches, concatenated in rank order, are the one-process
    batches: the same samples with the same per-sample generators (the
    draws equal), every epoch."""
    for epoch in (0, 3):
        full = list(PrefetchLoader(_Samples(), 8, seed=5, num_threads=2).epoch(epoch))
        parts = [list(PrefetchLoader(_Samples(), 8, seed=5, num_threads=2,
                                     rank=(r, world)).epoch(epoch)) for r in range(world)]
        assert len(full) == 2 and all(len(p) == 2 for p in parts)
        for b, f in enumerate(full):
            for k in ("idx", "draw"):
                got = np.concatenate([p[b][k] for p in parts])
                np.testing.assert_array_equal(got, f[k])
            assert all(len(p[b]["idx"]) == 8 // world for p in parts)


def test_one_process_helpers_are_identities():
    """Without a group every helper computes what the code computed before
    data parallelism: no collective, the same draws and means."""
    x = torch.arange(12.0).reshape(3, 4)
    assert parallel.rank(None) == 0 and parallel.world(None) == 1
    assert parallel.all_gather(x, None) is x and parallel.reduced(x, None) is x
    assert parallel.all_reduce_sum(x, None) is x
    assert torch.equal(parallel.batch_mean(x, None), x.mean())
    assert parallel.per_rank_batch(6, None) == 6
    assert parallel.rank_rows(7, None) == slice(0, 7)
    a = parallel.draw_rows((4, 2), torch.Generator().manual_seed(1))
    assert torch.equal(a, torch.rand((4, 2), generator=torch.Generator().manual_seed(1)))
    m = torch.nn.Linear(2, 2)
    assert parallel.replicate(m, None) is m
    assert parallel.broadcast_object({"a": 1}, None) == {"a": 1}


def test_per_rank_batch_refuses_indivisible_batches(monkeypatch):
    """A launched rank cannot idle as the JAX package's devices do: a batch
    the ranks do not divide raises."""
    monkeypatch.setattr(parallel.mesh, "world", lambda g: 4 if g == "four" else 1)
    assert parallel.per_rank_batch(16, "four") == 4
    with pytest.raises(ValueError, match="not divisible by the 4 ranks"):
        parallel.per_rank_batch(6, "four")


def test_rank_rows_split_every_batch():
    """Serving's split: contiguous, covering, local_batch_slice where it
    divides."""
    monkey = {"r": 0}
    orig_rank, orig_world = parallel.mesh.rank, parallel.mesh.world
    try:
        parallel.mesh.world = lambda g: 3
        parallel.mesh.rank = lambda g: monkey["r"]
        for n in (0, 1, 2, 3, 7, 9):
            cuts = []
            for r in range(3):
                monkey["r"] = r
                cuts.append(parallel.rank_rows(n, "g"))
            assert [i for s in cuts for i in range(n)[s]] == list(range(n))
            if n % 3 == 0:
                assert cuts == [parallel.local_batch_slice(n, r, 3) for r in range(3)]
    finally:
        parallel.mesh.rank, parallel.mesh.world = orig_rank, orig_world


def test_torchrun_rank_without_a_card_raises(monkeypatch):
    """A rank whose LOCAL_RANK has no card raises rather than sharing
    cuda:0 or falling back to the CPU; an explicit card index is refused
    under torchrun; one rank is one process, as before."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no card of its own"):
        parallel.init_from_env("cuda")
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        parallel.init_from_env("cuda:0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert parallel.init_from_env("cpu") == (None, torch.device("cpu"))
    monkeypatch.delenv("WORLD_SIZE")
    assert parallel.init_from_env("cpu") == (None, torch.device("cpu"))
    assert not torch.distributed.is_initialized()


def test_kernel_build_waits_on_the_lock(tmp_path, monkeypatch):
    """A process that finds another building a kernel waits on its lock
    and then loads that build instead of running nvcc again."""
    import fcntl
    import threading
    import time

    from muscle_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    target = build._target("mbconv")
    lock = open(tmp_path / "mbconv.lock", "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    result = {}
    t = threading.Thread(target=lambda: result.setdefault("started", build._start("mbconv")))
    t.start()
    time.sleep(0.3)
    assert t.is_alive()  # waiting on the other builder
    target.write_bytes(b"built elsewhere")
    lock.close()  # the other builder is done
    t.join(timeout=10)
    assert not t.is_alive()
    assert result["started"] == (target, None)  # nothing to build: it loads that library
    assert not os.path.exists(target.with_suffix(".log"))
