"""One run of one cell: set-up, the measured window, with ``trace`` a
profiled stretch, the peak memory, then the program's state freed and the
reference's check.  Everything a cell needs is found by name:

* the cell in ``BENCHMARK.json`` (its configuration, traffic and chips);
* ``benchmark/configs/<config>.json``: the model's sizes and precision;
* ``benchmark/traffic/<traffic>.json``: the mix, whose ``kind`` names its
  driver, ``benchmark/drivers/<kind>.py``;
* ``benchmark/limits/<cell>.json``: the limit of each number compared;
* ``benchmark/metrics/<metric>.py``: one reader per metric, ``read(ctx)``,
  which returns None where it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
# torch's intra-op threads a process: with all of a card machine's cores the
# engines' own threads contend with them, and a serving cell's rate spread
# by ~10% between runs of one seed (three runs read 45.6-50.2 images/s with
# the default, 48.59-48.62 with 4)
HOST_THREADS = 4
METRICS = HERE / "metrics"


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load(cell_name: str, bench: dict | None = None) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic) of ``cell_name``; KeyError
    if BENCHMARK.json has no such cell."""
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[cell_name]
    config = _json(HERE / "configs" / f"{cell['config']}.json")
    traffic = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def driver_class(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}").Driver


def reader(name: str, directory: Path = METRICS):
    """The ``read`` of ``metrics/<name>.py`` (a metric's name may hold dots)."""
    path = directory / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number at or under its
    limit, and the run's answers whole (all there, the right shapes)."""
    checks = {name: {"value": readings[name], "limit": lim} for name, lim in limits.items()}
    ok = bool(readings.get("whole")) and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def set_precision(precision: str) -> None:
    """Float32 with TF32 off, as the configurations state it."""
    if precision != "f32":
        raise ValueError(f"no cell states precision {precision!r} yet")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _gathered(value, group) -> list:
    """``value`` of every rank (``[value]`` for one process)."""
    if group is None:
        return [value]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, value, group=group)
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device, group=None, bench: dict | None = None,
             overrides: dict | None = None) -> dict | None:
    """One run; the result line's object (on rank 0 of a ``group``, None on
    the others).  ``t_start``: the process's start, ``time.time()``.
    ``overrides`` replaces (configuration, traffic, limits) entries, for
    tests at small sizes."""
    bench, cell, config, traffic = load(cell_name, bench)
    limits = _json(HERE / "limits" / f"{cell_name}.json")["limits"]
    for part, over in (overrides or {}).items():
        {"config": config, "traffic": traffic, "limits": limits}[part].update(over)
    device = torch.device(device)
    set_precision(config["precision"])
    torch.set_num_threads(HOST_THREADS)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    driver = driver_class(traffic["kind"])(cell, config, traffic, seed, device, group)
    t_setup = time.time()
    driver.setup()
    setup_s = time.time() - t_start
    lead = group is None or dist.get_rank(group) == 0
    if lead:
        print("setup phases (s): " + ", ".join(
            [f"before the cell {t_setup - t_start:.2f}"]
            + [f"{k} {v:.2f}" for k, v in driver.phases.items()]), file=sys.stderr)
    window = driver.window(seconds)
    summary = driver.stretch() if trace else None
    peak = max(_gathered(torch.cuda.max_memory_allocated(device) if cuda else 0, group))
    # the device's busy and traced seconds, averaged over the cards
    busy = _gathered(None if summary is None else (summary.busy_s, summary.window_s), group)
    driver.free()
    readings = driver.check()[0]
    if not lead:
        return None
    correct, checks = judge(readings, limits)
    ctx = {"setup_s": setup_s, "window": window, "trace": summary, "driver": driver,
           "config": config, "traffic": traffic, "chips": cell["chips"], "cuda": cuda}
    metrics = {}
    for m in metrics_of(bench, cell_name, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # every end-to-end reader that finds something in this window (a traced
    # line carries none, and a cell's line only its own), for standard error
    window_line = {m["name"]: reader(m["name"])(ctx) for m in bench["end_to_end"]}
    print("window: " + ", ".join(f"{k} {v!r}" for k, v in window_line.items() if v is not None),
          file=sys.stderr)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if summary is not None:
        dev.update(busy_s=sum(b for b, _ in busy) / len(busy),
                   window_s=sum(w for _, w in busy) / len(busy))
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["attempted"] - window["images"], "metrics": metrics,
              "device": dev}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    return result
