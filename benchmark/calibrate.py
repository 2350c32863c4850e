"""The readings that a cell's limits are set from, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3 [--device cuda]

For each seed: the cell's set-up, a short window at its own load, then
the numbers compared for the program against the reference (the lower
readings), for the control (the reference computed at TF32, the precision
below the stated float32) against the reference (the upper readings), and
for a training cell also for a fault planted in the reference (each batch's
second half left out).  One JSON line a seed, then the largest program
reading and the smallest control reading of each number.  Not run by the
benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from benchmark import harness, ranks

    cell = harness.load(args.workload)[1]
    seeds = [int(s) for s in args.seeds.split(",")]
    if cell["chips"] == 1:
        calibrate(0, None, args.device, args.workload, seeds, args.seconds)
    else:
        ranks.spawn(calibrate, cell["chips"], args.device, args.workload, seeds, args.seconds)
    return 0


def calibrate(rank: int, group, device, cell_name: str, seeds, seconds: float) -> None:
    """Every seed's readings on this rank; rank 0 prints them."""
    import torch

    from benchmark import harness

    _, cell, config, traffic = harness.load(cell_name)
    harness.set_precision(config["precision"])
    lows: dict[str, float] = {}
    highs: dict[str, float] = {}
    for seed in seeds:
        t0 = time.perf_counter()
        driver = harness.driver_class(traffic["kind"])(cell, config, traffic, seed, device, group)
        driver.setup()
        driver.window(seconds)
        driver.free()
        got, planted = driver.check(control=True)
        if rank == 0:
            print(json.dumps({"seed": seed, "program": got, **planted,
                              "seconds": time.perf_counter() - t0}), flush=True)
        for k, v in got.items():
            if isinstance(v, float):
                lows[k] = max(lows.get(k, 0.0), v)
                highs[k] = min(highs.get(k, float("inf")), planted["control"][k])
        del driver
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if rank == 0:
        print(json.dumps({"lower_readings": lows, "control_least": highs}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
