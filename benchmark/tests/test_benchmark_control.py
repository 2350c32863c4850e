"""On the card(s), at each cell's own size: the program's readings pass the
cell's limits and the control's fail them.  The control is the reference
put in the program's place at TF32, the precision below the stated
float32; a training cell's planted faults (half of each batch left out;
on several cards, each rank's rows alone) fail them too.  Run on a card
machine with

    python -m pytest benchmark/tests/test_benchmark_control.py -q

and skipped where there are not the cards a cell asks for."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, ranks  # noqa: E402

CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _control(rank, group, device, cell_name: str, out: str) -> None:
    """The program's and the planted readings of one seed, judged on rank 0."""
    _, cell, config, traffic = harness.load(cell_name)
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell_name}.json").read_text())
    harness.set_precision(config["precision"])
    driver = harness.driver_class(traffic["kind"])(cell, config, traffic, 2 ** 31 + 101,
                                                   device, group)
    driver.setup()
    driver.window(2.0)
    driver.free()
    got, planted = driver.check(control=True)
    if rank == 0:
        verdicts = {name: harness.judge(r, limits["limits"])[0]
                    for name, r in {"program": got, **planted}.items()}
        Path(out).write_text(json.dumps({"verdicts": verdicts, "program": got, **planted}))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, tmp_path):
    chips = harness.load(cell)[1]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    out = tmp_path / "readings.json"
    if chips == 1:
        _control(0, None, "cuda", cell, str(out))
    else:
        ranks.spawn(_control, chips, "cuda", cell, str(out))
    verdicts = json.loads(out.read_text())["verdicts"]
    assert verdicts.pop("program"), out.read_text()
    assert not any(verdicts.values()), out.read_text()
