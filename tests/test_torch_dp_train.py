"""Data-parallel training steps and CLIs of the port on two CPU ranks over
gloo (tests/torch_dp_ranks.py: one launch for the steps) against the
one-process port step on the same global batch, and step A against the
JAX package's ``mcl_train_step`` under a 2-device data mesh.

Sizes: MCL b1 enc, crop 64, views 32, batch 4 (2 a rank;
test_torch_mcl.py's batch), drop-connect on (the ranks draw its global
mask); seg b1 dec, BiFPN 1 x 64, crop 64, batch 2 (1 a rank), k 16,
clip 1 (test_torch_train_seg.py's, BEACON engaged, drawn from the
generator); IRN crop 64, batch 2 (test_torch_train_irn.py's).

Tolerances, W ranks against one process: loss terms 1e-5 relative; BN
running statistics 1e-5, or 1e-4 relative (test_torch_train_seg.py: the
BiFPN's 1 x 1 maps); every gradient within 1e-4 of its tensor's largest,
or below 1e-5 of the model's largest where a tensor's is zero in exact
arithmetic (step B 1e-3 and 1e-3: its maxnorm amplifies the forward's
rounding ~40x); the updates by test_torch_mcl.py's rule; the ranks' own
parameters bit-identical.  The gradient bound is test_torch_mcl.py's and
not tighter because the one-process step itself moves by up to 7.8e-5
(step A) and 1.5e-4 (step B) of a tensor's largest gradient between 1 and
8 CPU threads: summation order, which W ranks change too.  Against JAX:
test_torch_mcl.py's tolerances.  The negative control, local statistics and local IMC with
gradients averaged as DistributedDataParallel does, must miss the
one-process step by more than 100x the tolerance.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import muscle_tpu.models.efficientnet as jeff
import muscle_tpu.parallel as jpar
from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu.training import MCLConfig as JMCLConfig
from muscle_tpu.training import create_train_state
from muscle_tpu.training import mcl_train_step as j_train_step
from muscle_tpu.training.state import make_adam as j_make_adam
from muscle_tpu_torch.cli import infer_mcl, train_mcl
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.models import IRNNet, init_weights
from muscle_tpu_torch.training import make_adam

import test_torch_train_irn as irn_case
import torch_dp_ranks
from test_torch_cam import _assert_fused_close
from test_torch_mcl import _batch as mcl_batch
from test_torch_mcl import _compare_step, _live_labels, _metrics_close, _plain, _port, _randomize_bn
from test_torch_train_seg import problem  # noqa: F401  (the seg step's fixture)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
TOL = 1e-5
# (gradient tolerance, zero share): test_torch_mcl.py's; the one-process
# step itself moves by up to 7.8e-5 (step A) and 1.5e-4 (step B) of a
# tensor's largest gradient between 1 and 8 CPU threads
GRAD_TOLS = {"mcl_b": (1e-3, 1e-3)}
GRAD_TOL = (1e-4, 1e-5)
MCL_LR, MCL_WD = 1e-4, 5e-5
ADAM_EPS = 1e-8


@pytest.fixture(scope="module")
def mcl_weights():
    jmodel = JMuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False)
    v = jmodel.init({"params": jax.random.key(0)}, jnp.zeros((1, 64, 64, 3)), mode="cam")
    return jmodel, _randomize_bn(_plain(v), seed=0)


def _torch_state(sd):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def steps(mcl_weights, problem, tmp_path_factory):  # noqa: F811
    """Every case on 2 ranks (one launch) and in one process."""
    _, v = mcl_weights
    mcl_sd = _torch_state(state_dict_from_jax(v))
    seg_sd, _, seg_batch = problem
    irn = init_weights(IRNNet(), torch.Generator().manual_seed(0))
    mcl = dict(state=mcl_sd, batch=mcl_batch(0), lr=MCL_LR, wd=MCL_WD)
    cases = {
        "mcl_a": dict(mcl, kind="mcl_a", seed=1),
        "mcl_a_nodrop": dict(mcl, kind="mcl_a", seed=1, drop_connect=False),
        "mcl_b": dict(mcl, kind="mcl_b", seed=2, batch=_live_labels(_port(v), mcl_batch(1))),
        "seg": dict(kind="seg", state=_torch_state(seg_sd), batch=seg_batch, seed=3, lr=1e-5,
                    wd=1e-5, seg_cfg=dict(k=16, step=3, clip_norm=1.0)),
        "irn": dict(kind="irn", state=irn.state_dict(), batch=irn_case._batch(1),
                    lr=irn_case.LR, wd=irn_case.WD, crop=irn_case.CROP, seed=0),
    }
    spec = {"cases": cases, "control": cases["mcl_a_nodrop"]}
    ranks = torch_dp_ranks.launch(torch_dp_ranks.train_checks, WORLD,
                                  tmp_path_factory.mktemp("dp_steps"), spec)
    one = {name: torch_dp_ranks.run_step(case, None) for name, case in cases.items()}
    return cases, ranks, one


def _max_rel(got: dict, want: dict, floor_share: float = 0.0) -> tuple[float, str]:
    """The largest |got - want| over the tensors, each over its tensor's
    largest |want| (at least floor_share of the largest over all)."""
    top = max(float(w.abs().max()) for w in want.values())
    worst, where = 0.0, ""
    for k, w in want.items():
        scale = max(float(w.abs().max()), floor_share * top, 1e-30)
        e = float((got[k] - w).abs().max()) / scale
        if e > worst:
            worst, where = e, k
    return worst, where


def _updates_close(case, got, one, zero_share):
    """The update of every parameter (after - before) against one
    process's, by test_torch_mcl.py's rule: Adam's first step moves an
    entry by about lr sign(g + wd w), so the updates agree to 1% of lr
    (and an ulp of the parameter, whose float32 sum w + u both sides round)
    where |g + wd w| stands above 1e-3 of its tensor's largest and above
    100 eps (in a tensor with a gradient above the zero floor; the seg
    step's clipped gradients come near eps, where the update follows |g|:
    test_torch_train_seg.py), and elsewhere rounding may flip
    the sign of at most 0.1% of the entries (SGD's updates agree
    everywhere)."""
    top = max(float(g.abs().max()) for g in one["grads"].values())
    flips = total = 0
    for k, w in one["params"].items():
        w0 = case["state"][k].to(torch.float32)
        g = one["grads"][k] + case["wd"] * w0
        du, dw = got[k] - w0, w - w0
        strong = torch.zeros_like(g, dtype=torch.bool)
        if float(one["grads"][k].abs().max()) >= zero_share * top:
            strong = (g.abs() > 1e-3 * g.abs().max()) & (g.abs() > 100 * ADAM_EPS)
        # plus an ulp of the stored parameter: both sides round w + u to float32
        bad = ((du - dw).abs() > 1e-2 * case["lr"] + 2.0 ** -23 * w0.abs()) & strong
        assert not bool(bad.any()), (k, du[bad][:3], dw[bad][:3])
        flips += int((torch.sign(du[~strong]) != torch.sign(dw[~strong])).sum())
        total += du.numel()
    assert flips <= 1e-3 * total, (flips, total)


@pytest.mark.parametrize("name", ["mcl_a", "mcl_a_nodrop", "mcl_b", "seg", "irn"])
def test_step_on_ranks_matches_one_process(steps, name):
    """Loss terms, gradients, BN running statistics and the parameters after
    the update of the 2-rank step equal the one-process step's; every rank
    holds the same parameters."""
    cases, ranks, one = steps
    got, want = ranks[0][name], one[name]
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=TOL, atol=1e-7, err_msg=k)
    grad_tol, zero_share = GRAD_TOLS.get(name, GRAD_TOL)
    err, where = _max_rel(got["grads"], want["grads"], floor_share=zero_share / grad_tol)
    assert err <= grad_tol, (where, err)
    for k, w in want["stats"].items():  # test_torch_train_seg.py's rule (1 x 1 BiFPN maps)
        assert bool(((got["stats"][k] - w).abs() <= torch.clamp(1e-4 * w.abs(), min=TOL)).all()), k
    _updates_close(cases[name], got["params"], want, zero_share)
    assert all(r[name]["rank_param_diff"] == 0.0 for r in ranks)


@pytest.mark.parametrize("name", ["mcl_a", "mcl_b", "seg", "irn"])
def test_mesh_stats_count_the_step_exchanges(steps, name):
    """``parallel.mesh.stats`` over ``replicate`` and a 2-rank step counts
    the all-reduces, all-gathers and broadcasts that reached
    ``torch.distributed``, call for call and byte for byte: one broadcast
    a dtype of the state (the state's bytes), the gradient sum's flat
    buffer among the all-reduces, a cross-rank BN's all-gather in every
    train-mode step; one process counts none."""
    _, ranks, one = steps
    ex = ranks[0][name]["exchanges"]
    assert ex["counted"] == ex["issued"], ex
    c = ex["counted"]
    assert c["broadcast"]["bytes"] == ex["state_bytes"]
    assert 1 <= c["broadcast"]["calls"] <= 2  # float32 and, with BN counts, int64
    assert c["all_reduce"]["bytes"] >= ex["grad_bytes"]
    if name in ("mcl_a", "seg"):  # train-mode BNs, each gathering its statistics
        assert c["all_gather"]["calls"] >= ex["bn"] > 0
    assert all(v == {"calls": 0, "bytes": 0} for v in one[name]["exchanges"]["counted"].values())


def test_drawn_terms_engaged(steps):
    """The parity cases exercise what couples the batch: IMC and ER nonzero,
    BEACON engaged, drop-connect's and EMD's global draws in use (the two
    step-A cases differ)."""
    _, ranks, one = steps
    m = one["mcl_a"]["metrics"]
    assert m["loss_imc"] > 0 and m["loss_er"] > 0
    assert one["seg"]["metrics"]["loss_beacon"] != 0.0
    assert one["mcl_b"]["metrics"]["loss_emd"] > 0
    assert m["loss"] != one["mcl_a_nodrop"]["metrics"]["loss"]


def test_negative_control_misses_the_global_step(steps):
    """Ranks with local BN statistics and local IMC, their gradients
    averaged (DistributedDataParallel's recipe), miss the one-process step
    on the global batch by far more than the tolerance: the tests above can
    see that fault."""
    _, ranks, one = steps
    got, want = ranks[0]["control"], one["mcl_a_nodrop"]
    assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) > 100 * TOL * abs(
        want["metrics"]["loss"])
    grad_tol, zero_share = GRAD_TOL
    err, _ = _max_rel(got["grads"], want["grads"], floor_share=zero_share / grad_tol)
    assert err > 100 * grad_tol, err
    err, _ = _max_rel(got["stats"], want["stats"])
    assert err > 100 * TOL, err


def test_step_a_on_ranks_matches_jax_data_mesh(steps, mcl_weights, monkeypatch):
    """Step A (IMC on) on 2 ranks against JAX's ``mcl_train_step`` with the
    state replicated and the batch sharded over a 2-device data mesh (the
    JAX CLI's data parallelism), drop-connect off on both sides: metrics,
    gradients, BN statistics and the Adam step at test_torch_mcl.py's
    tolerances."""
    cases, ranks, _ = steps
    jmodel, v = mcl_weights
    monkeypatch.setattr(jeff, "drop_connect", lambda x, rate, key: x)
    mesh = jpar.make_data_mesh_for_batch(4, jax.devices()[:WORLD])
    assert mesh.shape["data"] == WORLD
    tx = j_make_adam(MCL_LR, MCL_WD)
    with mesh:
        state = jpar.replicate(mesh, create_train_state(jax.tree.map(jnp.asarray, v), tx))
        batch = jpar.shard_batch(mesh, cases["mcl_a_nodrop"]["batch"])
        jnew, jmet = j_train_step(jmodel, tx, state, batch, jax.random.key(1),
                                  JMCLConfig(use_imc=True))
    jmu = jnew.opt_state.inner_state[1].mu
    got = ranks[0]["mcl_a_nodrop"]
    model = torch_dp_ranks.build_model("enc", cases["mcl_a_nodrop"]["state"])
    before = {k: t.clone() for k, t in model.state_dict().items()}
    model.load_state_dict({**got["params"], **got["stats"]}, strict=False)
    opt = make_adam(model.trained_parameters(), MCL_LR, MCL_WD)
    names = {id(p): n for n, p in model.named_parameters()}
    for p in opt.param_groups[0]["params"]:
        p.grad = got["grads"][names[id(p)]]
    _metrics_close(got["metrics"], {k: float(x) for k, x in jmet.items()})
    _compare_step(model, opt, before, jnew, jmu, moved_stats=True, grad_tol=1e-4,
                  zero_frac=1e-5)


# ---- the CLIs ----------------------------------------------------------------------------

CLS_OF = [0, 7, 11, 14, 7, 3, 0, 11]


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    for d in ("JPEGImages", "SegmentationClass"):
        os.makedirs(root / d)
    rng = np.random.default_rng(0)
    names = [f"2007_{i:06d}" for i in range(len(CLS_OF))]
    labels = {}
    for i, n in enumerate(names):
        h, w = 60 + 4 * (i % 4), 80 - 4 * (i % 3)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        seg = np.zeros((h, w), np.uint8)
        seg[10:30, 10:30] = CLS_OF[i] + 1
        Image.fromarray(seg).save(root / "SegmentationClass" / f"{n}.png")
        lab = np.zeros(20, np.float32)
        lab[CLS_OF[i]] = 1
        labels[n] = lab
    (root / "list.txt").write_text("\n".join(names) + "\n")
    np.save(root / "cls_labels.npy", labels)
    init = init_weights(train_mcl_model(), torch.Generator().manual_seed(0))
    torch.save(init.state_dict(), root / "init.pth")
    return root, names


def train_mcl_model():
    from muscle_tpu_torch.models import MuSCLe

    return MuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False)


def _torchrun(module: str, args: list, tmp_path) -> None:
    """``torchrun --standalone --nproc_per_node 2 -m <module> <args>`` (the
    users' launch; its rendezvous picks a free localhost port)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(WORLD), "-m", module, *args],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


def _train_args(root, session, logs):
    return ["--train_list", str(root / "list.txt"), "--eval_list", str(root / "list.txt"),
            "--voc12_root", str(root), "--cls_labels", str(root / "cls_labels.npy"),
            "--session_name", str(session), "--log_dir", str(logs), "--weights",
            str(root / "init.pth"), "--backbone", "efficientnet-b1", "--batch_size", "4",
            "--crop_size", "64", "--num_workers", "2", "--log_every", "1", "--max_epoches", "1",
            "--vis_every", "0", "--tb", "0", "--device", "cpu"]


def test_train_mcl_on_two_ranks_writes_the_one_process_checkpoint(mini_voc, tmp_path):
    """``torchrun`` with 2 ranks: 2 steps of global batch 4; rank 0 writes
    the checkpoint, the log and the eval; the checkpoint is one process's
    within 1e-5 of each tensor's largest, but for at most 1% of the
    entries, within Adam's two steps' sign flips (2 lr each) where a
    gradient is rounding noise (test_torch_mcl.py).  The one-process CLI
    itself, run with 1 and with 8 CPU threads, differs so on 0.26% of the
    entries, by at most 3.3e-4."""
    root, names = mini_voc
    train_mcl.main(_train_args(root, tmp_path / "one", tmp_path / "one_logs"))
    _torchrun("muscle_tpu_torch.cli.train_mcl",
              _train_args(root, tmp_path / "two", tmp_path / "two_logs"), tmp_path)
    one = torch.load(tmp_path / "one" / "model_0.pth", weights_only=True)
    two = torch.load(tmp_path / "two" / "model_0.pth", weights_only=True)
    assert sorted(one) == sorted(two)
    init = torch.load(root / "init.pth", weights_only=True)
    moved = off = total = 0
    for k, w in one.items():
        if not w.is_floating_point():
            assert torch.equal(two[k], w), k
            continue
        err = (two[k] - w).abs()
        far = err > TOL * w.abs().max()
        # Adam's sign flips where a gradient is rounding noise, 2 lr a step
        assert bool((err[far] <= 2 * 2 * MCL_LR).all()), k
        off += int(far.sum())
        total += w.numel()
        moved += not torch.equal(w, init[k])
    assert off <= 1e-2 * total, (off, total)
    assert moved > 100
    steps1 = [line for line in (tmp_path / "one_logs" / "metrics.jsonl").read_text().splitlines()]
    steps2 = [line for line in (tmp_path / "two_logs" / "metrics.jsonl").read_text().splitlines()]
    assert len(steps1) == len(steps2) == 2
    assert len(list((tmp_path / "two" / "training_eval").glob("*.npy"))) == len(names)


def test_infer_mcl_on_two_ranks_writes_the_one_process_files(mini_voc, tmp_path):
    """``torchrun`` with 2 ranks over 8 images in batches of 3 (a rank's
    share 1 or 2 images): each rank writes its images' SGC dicts, which are
    one process's within the CAM rule (5e-3 away from the fusion's zeroing,
    test_torch_cam.py).  --fast 0: the fast path's maps depend on the
    batch's composition in one process too (a random b1 map moved 0.024
    between --batch_size 3 and 1), so a rank's smaller batch could not be
    held to that rule there."""
    root, names = mini_voc
    args = ["--weights", str(root / "init.pth"), "--infer_list", str(root / "list.txt"),
            "--voc12_root", str(root), "--cls_labels", str(root / "cls_labels.npy"),
            "--backbone", "efficientnet-b1", "--scales", "0.5,1", "--batch_size", "3",
            "--fast", "0", "--device", "cpu", "--num_workers", "1"]
    infer_mcl.main(args + ["--out_npy", str(tmp_path / "one")])
    _torchrun("muscle_tpu_torch.cli.infer_mcl", args + ["--out_npy", str(tmp_path / "two")],
              tmp_path)
    for n in names:
        a = np.load(tmp_path / "one_sgc" / f"{n}.npy", allow_pickle=True).item()
        b = np.load(tmp_path / "two_sgc" / f"{n}.npy", allow_pickle=True).item()
        assert sorted(a) == sorted(b)
        for c in a:
            _assert_fused_close(b[c].astype(np.float32), a[c].astype(np.float32), n)
