"""The PyTorch port stands alone: no module of muscle_tpu_torch, nor
chip_smoke.py, imports JAX, Flax or the JAX package, and the package
imports where Pillow is absent."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "muscle_tpu", "jaxlib")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    import muscle_tpu_torch

    return sorted(["muscle_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(muscle_tpu_torch.__path__, "muscle_tpu_torch.")])


def test_no_forbidden_import_statements():
    files = sorted((REPO / "muscle_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(REPO)}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("block_pil", [False, True])
def test_importing_every_module_loads_no_jax(block_pil):
    """A fresh interpreter imports every module of the package; afterwards
    neither jax nor muscle_tpu is loaded (and, with Pillow made
    unimportable, the imports still succeed)."""
    mods = _modules()
    for m in ("inference.cam", "cli.infer_mcl", "inference.irn", "cli.infer_irn",
              "inference.seg", "cli.infer_seg", "cli.cam_to_label", "ops.crf",
              "ops.exact_crf", "models.bifpn", "core.cam_norm", "core.ycbcr",
              "data.loader", "data.voc12", "losses.classification", "losses.contrastive",
              "losses.emd", "ops.exact_emd", "training.state", "training.schedule",
              "training.liveness", "training.mcl", "utils.timers", "utils.logging",
              "utils.tb_events", "utils.visualize", "utils.train_vis", "cli.train_mcl",
              "core.sobel", "core.bitpack", "losses.beacon", "losses.edge_support",
              "data.transforms", "training.seg", "training.irn", "ops.affinity_labels",
              "ops.random_walk", "models.irn", "cli.train_muscle", "cli.train_irn"):
        assert "muscle_tpu_torch." + m in mods
    code = "\n".join([
        "import sys, importlib",
        "if %r:" % block_pil,
        "    sys.modules['PIL'] = None",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r})]",
        "assert not bad, bad",
        "print('ok', len(sys.modules))",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    # -S: no site customisation, which on some hosts imports jax at start-up
    site = subprocess.run([sys.executable, "-c", "import site; print(site.getsitepackages()[0])"],
                          capture_output=True, text=True, check=True).stdout.strip()
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), site])
    res = subprocess.run([sys.executable, "-S", "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
