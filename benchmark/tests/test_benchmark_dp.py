"""The data-parallel training cell on CPU ranks over gloo, at small sizes:
the reference's step over two ranks equals its one-process step on the
global batch, and a whole run is correct, and not correct with the
program's gradient exchange left out."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, ranks  # noqa: E402

CELL = "b3_mcl_train_dp4"
SMALL = {"config": {"backbone": "efficientnet-b1"},
         "traffic": {"batch": 4, "crop": 64, "pool_batches": 2, "log_every": 2,
                     "trace_steps": 1}}
SEED = 2 ** 31 + 17


def _reference_steps(group, out_dir: str | None):
    """A reference step on the small global batch, over ``group``'s ranks
    (this rank's rows) or in one process; rank 0 saves the loss, the
    gradients as Adam took them, the parameters after and the BN
    statistics."""
    from benchmark import gen, weights
    from benchmark.reference import mcl

    torch.set_num_threads(1)
    _, _, config, traffic = harness.load(CELL)
    config.update(SMALL["config"])
    traffic.update(SMALL["traffic"])
    r, w = (0, 1) if group is None else (group.rank(), group.size())
    n = traffic["batch"] // w
    tr = gen.TrainTraffic(traffic, SEED, "cpu")
    model = weights.make(config, SEED, "cpu")
    params = dict(model.trained_parameters())
    opt = mcl.Adam(params.values(), traffic["lr"], traffic["weight_decay"])
    g = torch.Generator().manual_seed(5)
    out = {}
    batch = {k: torch.from_numpy(v[r * n:(r + 1) * n]) for k, v in tr.batch(0).items()}
    loss, taken = mcl.step(model, opt, batch, g, group)
    out["loss"] = np.float64(loss)
    out.update({f"g:{k}": t.numpy().copy() for k, t in zip(params, taken)})
    out.update({f"p:{k}": p.detach().numpy().copy() for k, p in params.items()})
    out.update({f"b:{k}": b.numpy().copy() for k, b in model.named_buffers()})
    if r == 0 and out_dir is not None:
        np.savez(Path(out_dir) / ("ranks.npz" if group is not None else "one.npz"), **out)
    return out


def _reference_rank(rank, group, device, out_dir):
    _reference_steps(group, out_dir)


def test_reference_over_ranks_is_the_global_batch(tmp_path):
    ranks.spawn(_reference_rank, 2, "cpu", str(tmp_path))
    _reference_steps(None, str(tmp_path))
    got, want = np.load(tmp_path / "ranks.npz"), np.load(tmp_path / "one.npz")
    assert set(got.files) == set(want.files)
    # a gradient against the step's largest: leaves near zero are f32 noise;
    # Adam moves a parameter by about lr whatever its gradient's size
    largest = max(np.abs(want[k]).max() for k in want.files if k.startswith("g:"))
    lr = harness.load(CELL)[3]["lr"]
    for k in want.files:
        a, b = got[k], want[k]
        tol = {"g": 1e-4 * largest, "p": 2 * lr}.get(k[0], 1e-5 * max(np.abs(b).max(), 1e-6))
        assert np.abs(a - b).max() <= tol, k


def _run_rank(rank, group, device, fault, out_dir):
    torch.set_num_threads(1)
    if fault == "no_exchange":
        import muscle_tpu_torch.training.state as state

        state.all_reduce_flat = lambda tensors, group=None: None
    over = {k: dict(v) for k, v in SMALL.items()}
    r = harness.run_cell(CELL, SEED, 1.0, False, time.time(), device, group=group,
                         overrides=over)
    if rank == 0:
        (Path(out_dir) / f"{fault}.json").write_text(json.dumps(r))


def test_a_run_over_ranks_and_without_its_exchange(tmp_path):
    for fault in ("none", "no_exchange"):
        ranks.spawn(_run_rank, 2, "cpu", fault, str(tmp_path))
    sound = json.loads((tmp_path / "none.json").read_text())
    broken = json.loads((tmp_path / "no_exchange.json").read_text())
    assert sound["correct"], sound["checks"]
    assert sound["attempted"] % SMALL["traffic"]["batch"] == 0 and sound["failed"] == 0
    assert not broken["correct"], broken["checks"]
