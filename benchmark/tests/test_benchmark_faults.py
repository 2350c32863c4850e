"""Whole runs of each cell with the timed path broken underneath, on the
CPU at small sizes (the harness's look for a card skipped): ``correct``
has to come out false for every fault the cell can have, and true for the
unbroken program.  The limits are the cells' own."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

SMALL = {
    "b3_cam_voc_f32": {
        "config": {"backbone": "efficientnet-b1"},
        "traffic": {"sizes": [[60, 80], [80, 60]], "pool_per_size": 3, "batch": 2,
                    "check_batches": 2, "trace_batches": 1}},
    "b7_seg_voc_f32": {
        "config": {"backbone": "efficientnet-b1", "bifpn_layers": 1, "bifpn_channels": 64},
        "traffic": {"sizes": [[160, 224], [224, 160]], "pool_per_size": 3, "batch": 2,
                    "check_batches": 2, "trace_batches": 1}},
    "b3_mcl_train_f32": {
        "config": {"backbone": "efficientnet-b1"},
        "traffic": {"batch": 4, "crop": 64, "pool_batches": 4, "trace_steps": 2}},
}


@pytest.fixture(autouse=True)
def _threads():
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


def run(cell: str, trace: bool = False) -> dict:
    over = {k: dict(v) for k, v in SMALL[cell].items()}
    if "engine" in harness.load(cell)[3]:
        engine = dict(harness.load(cell)[3]["engine"], scales=[0.5, 1.0])
        over["traffic"]["engine"] = engine
    return harness.run_cell(cell, 2 ** 31 + 3, 1.0, trace, time.time(), "cpu", overrides=over)


@pytest.mark.parametrize("cell", list(SMALL))
def test_unbroken_program_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert "setup_s" in r["metrics"]


def _altered_cam(monkeypatch):
    from muscle_tpu_torch.inference import CamTTAEngine

    made = CamTTAEngine._make_finalize

    def broken(self, *args, **kwargs):
        finalize = made(self, *args, **kwargs)

        def altered():
            recs = finalize()
            c = next(iter(recs[0]["sgc"]))
            recs[0]["sgc"][c] = (1.0 - recs[0]["sgc"][c].astype(np.float32)).astype(np.float16)
            return recs

        return altered

    monkeypatch.setattr(CamTTAEngine, "_make_finalize", broken)


def _altered_seg(monkeypatch):
    from muscle_tpu_torch.inference import SegTTAEngine

    made = SegTTAEngine._dispatch_prepped

    def broken(self, prep):
        finalize = made(self, prep)

        def altered():
            recs = finalize()
            recs[0]["label"] = ((recs[0]["label"].astype(np.int64) + 1) % 21).astype(np.uint8)
            return recs

        return altered

    monkeypatch.setattr(SegTTAEngine, "_dispatch_prepped", broken)


def _state_unchanged(monkeypatch):
    import muscle_tpu_torch.training.mcl as mcl

    def no_update(opt, loss, clip_norm=None, group=None):
        opt.zero_grad(set_to_none=True)

    monkeypatch.setattr(mcl, "minimize", no_update)


def _half_batch(monkeypatch):
    import muscle_tpu_torch.training as training

    step = training.mcl_train_step

    def halved(model, opt, batch, cfg, *args, **kwargs):
        n = batch["label"].shape[0] // 2
        return step(model, opt, {k: v[:n] for k, v in batch.items()}, cfg, *args, **kwargs)

    monkeypatch.setattr(training, "mcl_train_step", halved)


FAULTS = [("b3_cam_voc_f32", _altered_cam), ("b7_seg_voc_f32", _altered_seg),
          ("b3_mcl_train_f32", _state_unchanged), ("b3_mcl_train_f32", _half_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f.__name__.strip("_") for _, f in FAULTS])
def test_a_broken_program_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run(cell)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_a_traced_run_reports_no_device_numbers_on_the_cpu():
    """A CPU run has no device trace: the readers of device metrics find
    nothing and their metrics are left out of the line."""
    r = run("b3_mcl_train_f32", trace=True)
    assert r["device"]["busy_s"] == 0.0 and r["metrics"] == {}
    assert list(r)[-2:] == ["breakdown", "checks"]
