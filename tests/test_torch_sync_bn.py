"""The cross-rank batch norm's plain stages (``ops/sync_bn.py``) on a fake
W-way split of one batch, against one-process batch norm on the whole
batch (the port's ``BatchNorm2d`` with one rank: ``F.batch_norm`` at
float32, ``_LowpBatchStatsNorm`` at bfloat16).  The gather is simulated by
stacking each chunk's local row, the all-reduce by summing the chunks'
rows; the ranks' real exchanges over gloo are test_torch_parallel.py's
and test_torch_dp_train.py's.

Tolerances, W chunks against one process: float32 outputs and input
gradients 1e-5 of their largest and the statistics 1e-6 relative
(test_torch_parallel.py's: float32 sums in another order); at bfloat16 y
within one bf16 ulp of each entry, the input gradient within one ulp of
its largest (two paths rounded apart, each may straddle a rounding
boundary), and bit for bit the two-path rounding of the stages' own
float32 values.
"""

import pytest
import torch

from chip_smoke import sync_bn_bytes
from muscle_tpu_torch.models.efficientnet import BatchNorm2d
from muscle_tpu_torch.ops import sync_bn as S

N, C, H, W = 8, 6, 5, 7
EPS, MOMENTUM = 1e-3, 0.01
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most this share of a value


def _problem(dtype, seed: int = 0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    shape = (N, H, W, C)
    x = (torch.randn(shape, generator=gen) * 3 + 1).to(dtype).permute(0, 3, 1, 2)
    return {"x": x, "g": torch.randn(shape, generator=gen).to(dtype).permute(0, 3, 1, 2),
            "weight": torch.rand(C, generator=gen) + 0.5,
            "bias": torch.randn(C, generator=gen),
            "running_mean": torch.randn(C, generator=gen),
            "running_var": torch.rand(C, generator=gen) + 0.5}


def _one_process(p: dict) -> dict:
    bn = BatchNorm2d(C, eps=EPS, momentum=MOMENTUM)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(p[k])
    bn.train()
    x = p["x"].clone().requires_grad_(True)
    y = bn(x)
    y.backward(p["g"])
    mean_var = torch.var_mean(p["x"].float(), dim=(0, 2, 3), unbiased=False)
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "mean": mean_var[1], "invstd": torch.rsqrt(mean_var[0] + EPS),
            "running_mean": bn.running_mean, "running_var": bn.running_var,
            "batches": int(bn.num_batches_tracked)}


def _split(p: dict, world: int) -> dict:
    """The stages on ``world`` chunks of the batch, each with its own copy
    of the running statistics."""
    xs, gs = p["x"].chunk(world), p["g"].chunk(world)
    stats = torch.empty((world, 1 + 2 * C))
    for r, x in enumerate(xs):
        S.local_stats_plain(x, stats[r])
    ys, saved, running = [], [], []
    for x in xs:
        run = (p["running_mean"].clone(), p["running_var"].clone(),
               torch.zeros((), dtype=torch.long), MOMENTUM)
        y, s = S.normalize_plain(x, stats, p["weight"], p["bias"], EPS, run)
        ys.append(y)
        saved.append(s)
        running.append(run)
    parts = [S.backward_reduce_plain(g, x, s) for g, x, s in zip(gs, xs, saved)]
    red = sum(part[0] for part in parts)
    dxs = [S.backward_dx_plain(g, x, s, p["weight"], red) for g, x, s in zip(gs, xs, saved)]
    return {"y": torch.cat(ys), "dx": torch.cat(dxs), "dw": sum(part[1] for part in parts),
            "db": sum(part[2] for part in parts), "saved": saved, "running": running,
            "red": red, "xs": xs, "gs": gs}


def _close(got, want, share: float, what: str) -> None:
    err = float((got.float() - want.float()).abs().max())
    assert err <= share * float(want.float().abs().max()), (what, err)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_stages_on_a_split_batch_match_one_process(world, dtype):
    """y, the global mean and biased variance (``saved``), the running
    statistics, dx and the summed dw and db of the W chunks equal one
    process's batch norm on the whole batch."""
    p = _problem(dtype, seed=world)
    want, got = _one_process(p), _split(p, world)
    for s in got["saved"]:
        _close(s[:C], want["mean"], 1e-6, "mean")
        _close(s[C: 2 * C], want["invstd"], 1e-6, "invstd")
        assert float(s[2 * C]) == N * H * W
    for run_mean, run_var, batches, _ in got["running"]:
        _close(run_mean, want["running_mean"], 1e-6, "running_mean")
        _close(run_var, want["running_var"], 1e-6, "running_var")
        assert int(batches) == want["batches"] == 1
    _close(got["dw"], want["dw"], 1e-6, "dw")
    _close(got["db"], want["db"], 1e-6, "db")
    assert got["y"].dtype == got["dx"].dtype == dtype
    if dtype == torch.float32:
        _close(got["y"], want["y"], 1e-5, "y")
        _close(got["dx"], want["dx"], 1e-5, "dx")
    else:
        diff = (got["y"].float() - want["y"].float()).abs()
        assert bool((diff <= BF16_ULP * want["y"].float().abs()).all())
        _close(got["dx"], want["dx"], BF16_ULP, "dx")


@pytest.mark.parametrize("world", [2, 4])
def test_plain_bf16_input_gradient_rounds_two_paths(world):
    """At bfloat16 each chunk's dx is the direct path g * invstd * w and
    the rest, each rounded to bf16, summed in bf16: bit for bit that
    rounding of the stage's own float32 values, and not one rounding of
    their float32 sum (which moves a share of the entries by an ulp)."""
    p = _problem(torch.bfloat16, seed=10 + world)
    got = _split(p, world)
    once = changed = 0
    for r, (g, x, s) in enumerate(zip(got["gs"], got["xs"], got["saved"])):
        dx = S.backward_dx_plain(g, x, s, p["weight"], got["red"])
        full = S.backward_dx_plain(g.float(), x.float(), s, p["weight"], got["red"])
        direct = g.float() * (s[C: 2 * C] * p["weight"])[:, None, None]
        two = direct.to(torch.bfloat16) + (full - direct).to(torch.bfloat16)
        assert torch.equal(dx, two), r
        once += dx.numel()
        changed += int((dx != full.to(torch.bfloat16)).sum())
    assert 0 < changed < once


def test_stages_dispatch_on_the_device_and_count_no_cpu_launch():
    """A CPU tensor takes the plain stages and the kernels' launch counters
    do not move; another device type raises."""
    before = (S.sync_bn.launches, S.sync_bn.launches_backward)
    assert S.stages(torch.zeros(1, 2, 1, 1)) is S.PLAIN
    p = _problem(torch.float32)
    _split(p, 2)
    assert (S.sync_bn.launches, S.sync_bn.launches_backward) == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        S.stages(torch.zeros(1, 2, 1, 1, device="meta"))


def test_stage_bytes_count_each_map_once():
    """The bound's bytes at the stem's shape (``chip_smoke.py``'s
    ``sync_bn_bytes``): x once for the statistics, x and y for the
    normalise, g and x for the reduce, g, x and dx for the input gradient,
    plus the float32 vectors (under 100 KB)."""
    p, c = 16 * 224 * 224, 40
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        m = p * c * size
        b = sync_bn_bytes(p, c, 4, size)
        for stage, maps in (("stats", 1), ("normalize", 2), ("reduce", 2), ("dx", 3)):
            assert maps * m < b[stage] < maps * m + 1e5, (dtype, stage)
