"""What the benchmark imports, and that its data files resolve by name.

Nothing the benchmark runs imports JAX, Flax or the JAX package
(``muscle_tpu``), and the reference imports nothing of the program
(``muscle_tpu_torch``).  Imports are compared by their top-level name, the
part before the first dot, whole: ``muscle_tpu_torch`` begins with
``muscle_tpu`` and is not it.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

JAX_SIDE = {"jax", "jaxlib", "flax", "muscle_tpu"}
RUN_FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def top_level_imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports, anywhere in it
    (relative imports count as the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", RUN_FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "contextlib", "dataclasses", "functools", "math", "numpy",
               "torch", "PIL", "benchmark"}
    names = top_level_imports(path)
    assert "muscle_tpu_torch" not in names and names <= allowed, names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(
                "benchmark."):
            assert node.module.startswith("benchmark.reference"), node.module


def test_top_level_names_compare_whole():
    src = "import muscle_tpu_torch.models\nfrom muscle_tpu_torch import training\n"
    tree = ast.parse(src)
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    assert names == {"muscle_tpu_torch"} and not names & JAX_SIDE


def test_loaded_modules_in_a_fresh_process():
    """Importing every module a run loads, the program's included, loads no
    JAX-side module, and the run's own guard names none."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run as run, benchmark.harness, benchmark.calibrate\n"
        "import benchmark.drivers.cam_stream, benchmark.drivers.seg_stream\n"
        "import benchmark.drivers.mcl_train, benchmark.counts.flops, benchmark.ranks\n"
        "import muscle_tpu_torch.inference, muscle_tpu_torch.training, muscle_tpu_torch.models\n"
        "from benchmark import harness\n"
        "[harness.reader(p.stem) for p in harness.METRICS.glob('*.py') if p.stem[0] != '_']\n"
        "print(','.join(run.forbidden_modules()))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


# ---- the layout: every name resolves to its file ------------------------------------

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("path", sorted((BENCH / "traffic").glob("*.json")),
                         ids=lambda p: p.name)
def test_traffic_files_parse(path):
    t = json.loads(path.read_text())
    if "kind" in t:  # a mix; the others are data a mix names
        assert (BENCH / "drivers" / f"{t['kind']}.py").exists()
        assert (BENCH / "traffic" / t["labels"]).exists()


@pytest.mark.parametrize("cell", [c["name"] for c in BENCHMARK["workloads"]])
def test_cells_resolve(cell):
    _, c, config, traffic = harness.load(cell)
    assert harness.driver_class(traffic["kind"]) is not None
    assert config["reduced"] == [] and c["chips"] in (1, 4)
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())["limits"]
    assert limits and all(v > 0 for v in limits.values())
    for trace in (False, True):
        for m in harness.metrics_of(BENCHMARK, cell, trace):
            assert callable(harness.reader(m["name"]))
    # every cell reports set-up, another end-to-end metric and a per-layer one
    e2e = [m["name"] for m in harness.metrics_of(BENCHMARK, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    moved = {m["moves"] for m in harness.metrics_of(BENCHMARK, cell, True)}
    assert moved and moved <= set(e2e)


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    """A cell added to BENCHMARK.json with files of its own, and a metric
    with its own reader, need no edit of the harness."""
    bench = json.loads(json.dumps(BENCHMARK))
    bench["workloads"].append({"name": "b3_cam_voc_f32_again", "config": "muscle_b3",
                               "traffic": "cam_voc_f32", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "a_new.metric", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "kernel",
                               "moves": "infer_images_per_s",
                               "workloads": ["b3_cam_voc_f32_again"]})
    _, cell, config, traffic = harness.load("b3_cam_voc_f32_again", bench)
    assert config["backbone"] == "efficientnet-b3" and traffic["kind"] == "cam_stream"
    names = [m["name"] for m in harness.metrics_of(bench, "b3_cam_voc_f32_again", True)]
    assert "a_new.metric" in names and "mbconv_roofline" not in names
    (tmp_path / "a_new.metric.py").write_text("def read(ctx):\n    return ctx.get('x')\n")
    read = harness.reader("a_new.metric", tmp_path)
    assert read({"x": 2.5}) == 2.5 and read({}) is None
    with pytest.raises(KeyError):
        harness.load("no_such_cell", bench)
