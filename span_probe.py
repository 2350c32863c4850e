#!/usr/bin/env python3
"""Run one benchmark cell with the port's span recorder open
(``muscle_tpu_torch/utils/timers.py``): which host stage holds a serving
stream, what a training step's host work and exchanges cost.  On the
card's machine, from the root of a checkout:

    python3 span_probe.py --workload b3_cam_voc_f32 --seed 7 --seconds 30
    python3 span_probe.py --cost       # what a span costs the host

A cell: the benchmark's set-up (``benchmark/harness.py``'s), then its
measured window and its traced stretch (``benchmark/trace.py``), each
under a recording, with ``parallel.mesh.stats`` read around the window.
Prints a ``spans:`` table (name, count, total and own ms in the window)
on standard error and one JSON line on standard output (rank 0 of a
several-card cell):

* per image (serving): ``prep``, ``dispatch``, ``finalize``'s own time and
  ``mbconv``'s own time over the images the window's ``dispatch`` spans
  counted; ``idle_dispatching_share`` / ``idle_waiting_share``: per cent
  of the stretch in which the card idled while the dispatching thread was
  inside ``dispatch`` / in ``wait_prep`` or ``wait_result``;
* per step (training): the mean ``step`` duration over the window, and
  the exchanges ``mesh.stats`` counted over the window's steps;
* ``idle_by_host``: the stretch's idle seconds by the innermost span open
  on the dispatching (or training) thread, ``(none)`` where none is;
* the window's rate with the recorder open, beside the cell's end-to-end
  metric (compare with ``benchmark/run.py --trace 0`` on the same seed).

The check against the reference is not run: ``benchmark/run.py`` does it.
``--cost``: ns a ``span`` call costs with no recording open and with one
open, over a million calls each.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SERVING_WAITS = ("wait_prep", "wait_result")
TOP = 10  # idle_by_host's entries


def cost(calls: int = 1_000_000) -> dict:
    """ns a ``with span(...)`` costs the host, less an empty loop's."""
    from muscle_tpu_torch.utils.timers import recording, span

    def loop(with_span: bool) -> float:
        t0 = time.perf_counter_ns()
        if with_span:
            for k in range(calls):
                with span("dispatch", batch=k, images=8):
                    pass
        else:
            for k in range(calls):
                pass
        return (time.perf_counter_ns() - t0) / calls

    bare = min(loop(False) for _ in range(3))
    off = min(loop(True) for _ in range(3)) - bare
    with recording() as recs:
        on = loop(True) - bare
    return {"span_ns_off": off, "span_ns_on": on, "recorded": len(recs), "calls": calls}


def _gaps(events, lo: int, hi: int) -> list[tuple[int, int]]:
    """The idle (start ns, end ns) intervals of the stretch [lo, hi] on the
    device's clock: where no operation of ``events`` (clipped) runs."""
    out, cur = [], lo
    for a, b, _ in sorted(events):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def _thread_of(records, name: str) -> str | None:
    threads = {r.thread for r in records if r.name == name}
    return threads.pop() if len(threads) == 1 else None


def reduce(win, stretch, events, window: dict, units: str, exchanged: dict) -> dict:
    """The probe's numbers from the window's and the stretch's records and
    the stretch's device events (``trace.device_events``)."""
    from benchmark import trace
    from muscle_tpu_torch.utils import timers

    totals = timers.totals(win)
    out: dict = {"spans": {name: [n, total / 1e6, own / 1e6]
                           for name, (n, total, own) in sorted(totals.items())}}
    if units == "images":
        images = sum(r.attrs["images"] for r in win if r.name == "dispatch")
        out["window_images"], out["dispatch_images"] = window["images"], images
        # (name, whole or own time) a metric reads
        for key, name, part in (("prep_ms_per_image", "prep", 1),
                                ("dispatch_ms_per_image", "dispatch", 1),
                                ("finalize_ms_per_image", "finalize", 2),
                                ("mbconv_host_ms_per_image", "mbconv", 2)):
            out[key] = totals[name][part] / 1e6 / images if name in totals else None
        thread = _thread_of(stretch, "dispatch")
    else:
        steps = [r for r in win if r.name == "step"]
        out["host_ms_per_step"] = sum(r.ns for r in steps) / 1e6 / len(steps)
        out["window_steps"] = window["steps"]
        out["collectives_per_step"] = sum(v["calls"] for v in exchanged.values()) / len(steps)
        out["exchange_mb_per_step"] = sum(v["bytes"] for v in exchanged.values()) / 1e6 / len(
            steps)
        out["exchanges"] = exchanged
        thread = _thread_of(stretch, "step")
    if events is None or thread is None:
        return out
    lo, hi, inside = trace.stretch_bounds(events)
    gaps = _gaps(inside, lo, hi)
    span_s = (hi - lo) / 1e9
    idle = timers.attribute(gaps, timers.timeline(stretch, thread))
    out["stretch_s"], out["idle_share"] = span_s, 100.0 * sum(b - a for a, b in gaps) / (hi - lo)
    out["idle_by_host"] = [[name, ns / 1e9] for name, ns in
                           sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]
    if units == "images":
        # the top-level stage of the dispatching thread, nested spans folded in
        stages = [r for r in stretch if r.thread == thread
                  and r.name in ("dispatch",) + SERVING_WAITS]
        by_stage = timers.attribute(gaps, timers.timeline(stages, thread))
        out["idle_dispatching_share"] = 100.0 * by_stage.get("dispatch", 0) / (hi - lo)
        out["idle_waiting_share"] = 100.0 * sum(by_stage.get(w, 0)
                                                for w in SERVING_WAITS) / (hi - lo)
    return out


def run_cell(cell_name: str, seed: int, seconds: float, device, group=None,
             overrides: dict | None = None) -> dict | None:
    """The cell's set-up, window and stretch under recordings; the probe's
    line (rank 0), None on the other ranks.  ``overrides``: as
    ``harness.run_cell``'s, for small rehearsals on the CPU."""
    import torch
    import torch.distributed as dist

    from benchmark import harness, trace
    from muscle_tpu_torch.parallel import mesh
    from muscle_tpu_torch.utils.timers import recording

    bench, cell, config, traffic = harness.load(cell_name)
    for part, over in (overrides or {}).items():
        {"config": config, "traffic": traffic}[part].update(over)
    device = torch.device(device)
    harness.set_precision(config["precision"])
    torch.set_num_threads(harness.HOST_THREADS)
    driver = harness.driver_class(traffic["kind"])(cell, config, traffic, seed, device, group)
    driver.setup()
    before = copy.deepcopy(mesh.stats)
    with recording() as win:
        window = driver.window(seconds)
    exchanged = {k: {n: mesh.stats[k][n] - before[k][n] for n in v} for k, v in before.items()}
    caught = {}
    real = trace.device_events

    def keep(prof):
        caught["events"] = real(prof)
        return caught["events"]

    trace.device_events = keep
    try:
        with recording() as stretch:
            summary = driver.stretch()
    finally:
        trace.device_events = real
    if group is not None and dist.get_rank(group) != 0:
        return None
    out = reduce(win, stretch, caught.get("events"), window, driver.units, exchanged)
    rate = window["images"] / window["seconds"]
    out.update(workload=cell_name, seed=seed, rate_recording=rate, window_s=window["seconds"],
               summary_idle_share=100.0 * (1.0 - summary.busy_s / summary.window_s),
               launches_per_unit=summary.launches / summary.units)
    return out


def _print(out: dict) -> None:
    for name, (n, total, mine) in out.pop("spans").items():
        print(f"spans: {name} {n} {total:.3f} ms {mine:.3f} ms own", file=sys.stderr)
    print(json.dumps(out), flush=True)


def _rank(rank: int, group, device, cell_name: str, seed: int, seconds: float,
          overrides: dict | None = None) -> None:
    out = run_cell(cell_name, seed, seconds, device, group, overrides)
    if rank == 0:
        _print(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--cost", action="store_true")
    args = p.parse_args(argv)
    if args.cost:
        print(json.dumps(cost()), flush=True)
        return 0
    from benchmark import harness

    _, cell, _, _ = harness.load(args.workload)
    if cell["chips"] == 1:
        _print(run_cell(args.workload, args.seed, args.seconds, "cuda"))
        return 0
    from benchmark import ranks

    ranks.spawn(_rank, cell["chips"], "cuda", args.workload, args.seed, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
