"""The PyTorch port stands alone: no module of muscle_tpu_torch, nor
chip_smoke.py, imports JAX, Flax or the JAX package, and the package
imports where Pillow is absent.  Its packages export the names the JAX
packages' ``__init__`` files export (read with ``ast``)."""

import ast
import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "muscle_tpu", "jaxlib")


# names a JAX package's __init__ exports that have no torch meaning, each with
# the dotted paths of the port's counterparts
JAX_ONLY = {
    # GSPMD sharding objects: the port splits the batch over
    # torch.distributed ranks and the canvases over a model group
    "muscle_tpu.parallel.make_data_mesh_for_batch": ("muscle_tpu_torch.parallel.make_mesh",
                                                    "muscle_tpu_torch.parallel.per_rank_batch"),
    "muscle_tpu.parallel.data_sharding": ("muscle_tpu_torch.parallel.make_mesh",
                                          "muscle_tpu_torch.parallel.data_share"),
    "muscle_tpu.parallel.spatial_sharding": ("muscle_tpu_torch.parallel.make_mesh",
                                             "muscle_tpu_torch.inference.cam.spatial_stripes"),
    "muscle_tpu.parallel.replicated_sharding": ("muscle_tpu_torch.parallel.replicate",),
    "muscle_tpu.parallel.shard_batch": ("muscle_tpu_torch.parallel.data_share",
                                        "muscle_tpu_torch.parallel.per_rank_batch"),
    # Flax's functional train state: a torch module and its optimizer
    "muscle_tpu.training.TrainState": ("torch.nn.Module", "muscle_tpu_torch.training.make_adam"),
    "muscle_tpu.training.create_train_state": ("muscle_tpu_torch.training.make_adam",),
    "muscle_tpu.training.load_model_msgpack": ("muscle_tpu_torch.convert.read_flax_msgpack",
                                               "muscle_tpu_torch.convert.load_into"),
    # XLA's compile cache: the kernels' libraries, cached by source hash
    "muscle_tpu.utils.enable_compile_cache": ("muscle_tpu_torch.ops.build.library_path",),
    # .pth -> Flax conversion: the port loads the reference's .pth natively
    "muscle_tpu.convert.convert_muscle_state_dict": (
        "muscle_tpu_torch.convert.load_reference_state_dict", "muscle_tpu_torch.convert.load_into"),
    "muscle_tpu.convert.convert_irn_state_dict": (
        "muscle_tpu_torch.convert.load_reference_state_dict", "muscle_tpu_torch.convert.load_into"),
    "muscle_tpu.convert.flax_to_muscle_state_dict": ("muscle_tpu_torch.convert.state_dict_from_jax",),
    "muscle_tpu.convert.load_torch_checkpoint": (
        "muscle_tpu_torch.convert.load_reference_state_dict",),
    # the Pallas kernels: the CUDA kernels' wrappers
    "muscle_tpu.ops.pallas.banded_random_walk": ("muscle_tpu_torch.ops.banded_walk.banded_walk",),
    "muscle_tpu.ops.pallas.walk_band": ("muscle_tpu_torch.ops.banded_walk.walk_band",),
}


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _run_fresh(code: str) -> None:
    """Run ``code`` in a fresh interpreter on the repo; it prints 'ok'."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    # -S: no site customisation, which on some hosts imports jax at start-up
    site = subprocess.run([sys.executable, "-c", "import site; print(site.getsitepackages()[0])"],
                          capture_output=True, text=True, check=True).stdout.strip()
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), site])
    res = subprocess.run([sys.executable, "-S", "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


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
              "ops.random_walk", "models.irn", "cli.train_muscle", "cli.train_irn",
              "parallel", "parallel.mesh", "gates", "cli.gates", "cli.real_run"):
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
    _run_fresh(code)


def _jax_exports() -> dict[str, list[str]]:
    """{JAX package: the names its __init__ imports}, parsed, not imported."""
    out = {}
    for path in sorted((REPO / "muscle_tpu").rglob("__init__.py")):
        pkg = ".".join(path.parent.relative_to(REPO).parts)
        out[pkg] = [a.asname or a.name for node in ast.parse(path.read_text()).body
                    if isinstance(node, ast.ImportFrom) for a in node.names]
    return out


def _resolve(dotted: str):
    """The object at a dotted path: the longest importable module prefix,
    then attributes."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for name in parts[i:]:
            obj = getattr(obj, name)
        return obj
    raise ImportError(dotted)


def test_port_packages_export_the_jax_packages_names():
    """Every name a muscle_tpu package's __init__ exports is an attribute of
    the port's counterpart package (the top level, core, data, ops, losses,
    utils, ...), or is JAX-only with its port counterparts resolvable."""
    exports = _jax_exports()
    assert {"muscle_tpu", "muscle_tpu.core", "muscle_tpu.data", "muscle_tpu.ops"} <= set(exports)
    checked, missing = 0, []
    for pkg, names in exports.items():
        for name in names:
            full = f"{pkg}.{name}"
            if full in JAX_ONLY:
                for counterpart in JAX_ONLY[full]:
                    assert _resolve(counterpart) is not None, counterpart
                continue
            port = importlib.import_module(pkg.replace("muscle_tpu", "muscle_tpu_torch", 1))
            if not hasattr(port, name):
                missing.append(full)
            checked += 1
    assert not missing, missing
    assert checked > 100
    exported = {f"{pkg}.{n}" for pkg, names in exports.items() for n in names}
    assert set(JAX_ONLY) <= exported, set(JAX_ONLY) - exported  # no stale entry


def test_module_constants_match_jax():
    from muscle_tpu.data import transforms as JT
    from muscle_tpu.data.tta import MSF_BUCKETS as J_BUCKETS
    from muscle_tpu_torch.data import MSF_BUCKETS
    from muscle_tpu_torch.data import transforms as T

    assert MSF_BUCKETS == J_BUCKETS
    assert (T.BICUBIC, T.BILINEAR) == (JT.BICUBIC, JT.BILINEAR)


def test_importing_every_subpackage_loads_no_jax_and_no_pil():
    """A fresh interpreter imports the package and each subpackage (with
    their package-level names): neither jax nor PIL is loaded."""
    import muscle_tpu_torch

    pkgs = ["muscle_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(muscle_tpu_torch.__path__, "muscle_tpu_torch.")
        if m.ispkg)
    assert {"muscle_tpu_torch.core", "muscle_tpu_torch.data", "muscle_tpu_torch.ops"} <= set(pkgs)
    code = "\n".join([
        "import sys, importlib",
        f"for m in {pkgs!r}:",
        "    importlib.import_module(m)",
        "bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN + ('PIL',)!r})]",
        "assert not bad, bad",
        "print('ok', len(sys.modules))",
    ])
    _run_fresh(code)
