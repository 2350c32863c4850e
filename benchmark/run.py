"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Loads and warms up (``setup_s``), measures for
``--seconds``, with ``--trace 1`` profiles a bounded stretch after the
window, then checks what the window produced against the plain reference
in ``benchmark/reference/``.  Prints the numbers compared beside their
limits as the last lines of standard error, and one JSON object as the last
line of standard output.  A cell on several cards starts one process a
card over NCCL (``benchmark/ranks.py``); rank 0 prints.  Exits non-zero,
printing no result, without the card(s) the cell asks for, or if JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()  # wall clock: the ranks of a multi-card cell share it

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "muscle_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``muscle_tpu_torch`` is not ``muscle_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    try:
        import muscle_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"the program is not here: {e}", file=sys.stderr)
        return 5

    try:
        _, cell, _, _ = harness.load(args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run = (args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    if cell["chips"] == 1:
        return report(harness.run_cell(*run, device="cuda"))
    from benchmark import ranks

    ranks.spawn(run_rank, cell["chips"], "cuda", *run)
    return 0


def run_rank(rank: int, group, device, *run) -> None:
    """One rank of a multi-card cell; rank 0 reports."""
    from benchmark import harness

    result = harness.run_cell(*run, device=device, group=group)
    if rank == 0 and report(result):
        raise SystemExit(4)


def report(result: dict) -> int:
    """Print the numbers compared on standard error and the result line on
    standard output; 4, and nothing printed, if JAX was loaded."""
    leaked = forbidden_modules()
    if leaked:
        print(f"loaded in this process: {', '.join(leaked)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
