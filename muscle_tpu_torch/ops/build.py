"""Build and load the port's CUDA kernels (``muscle_tpu_torch/csrc/*.cu``:
``mbconv``, ``stencil_walk``, ``banded_walk``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ctypes.  Libraries land in
``build/kernels/`` at the repository root (listed in ``.gitignore``), named
by the hash of their source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.  ``cuTensorMapEncodeTiled`` (TMA) is found through the runtime's
driver entry point, so nothing links against libcuda.  Nothing is built
when a module is imported: the first launch builds, or ``build_all``
builds every source in parallel.

Processes that build at once (the ranks of a data-parallel launch) build
each library once: a process holds an exclusive ``flock`` on
``build/kernels/<name>.lock`` while its nvcc runs, and the others wait on
it and then load what it built.  The kernel releases the lock if the
builder dies, so no stale lock is left behind.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library is built (for reading its SASS)."""
    return _target(name)


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library is built (by
    this process or by another that held the lock); returns (target,
    (process, tmp, lock) or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lock = open(BUILD_DIR / f"{name}.lock", "w")
    fcntl.flock(lock, fcntl.LOCK_EX)  # waits while another process builds it
    if target.exists():
        lock.close()
        return target, None
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except BaseException:
        lock.close()
        raise
    return target, (proc, tmp, lock)


def _finish(name: str, target: Path, pending) -> None:
    if pending is None:
        return
    proc, tmp, lock = pending
    with lock:  # closing the file releases the flock
        out, _ = proc.communicate()
        target.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
        os.replace(tmp, target)


def build_all(names) -> dict[str, str]:
    """Compile every named source at once (one nvcc each, in parallel);
    returns {name: nvcc's log} (register and shared-memory use per kernel
    from ``-Xptxas -v``)."""
    started = {n: _start(n) for n in names}
    for n, (target, pending) in started.items():
        _finish(n, target, pending)
    logs = {}
    for n, (target, _) in started.items():
        log = target.with_suffix(".log")
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            target, pending = _start(name)
            _finish(name, target, pending)
            _libs[name] = ctypes.CDLL(str(target))
        return _libs[name]
