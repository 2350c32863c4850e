"""The port's ctypes loader of the repository's native C++ library (port of
``muscle_tpu/ops/native_lib.py``).

``native/densecrf.cpp`` and ``native/exact_emd.cpp`` are compiled with g++
(the flags of ``native/Makefile``) into ``build/native/`` at the
repository root, on first use, under a name that hashes the sources and
the flags; nothing is written into ``native/``.  A build goes to a
temporary file first and is renamed into place, so processes that build
at once do not see each other's half-written library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NATIVE = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
SOURCES = ("densecrf.cpp", "exact_emd.cpp")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for src in SOURCES:
        h.update(src.encode() + (NATIVE / src).read_bytes())
    return BUILD_DIR / f"libmuscle_native-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    so = _target()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXXFLAGS, "-o", str(tmp),
               *(str(NATIVE / s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the native library failed:\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.muscle_dense_crf.argtypes = [
        f32p, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, f32p,
    ]
    lib.muscle_dense_crf.restype = None
    lib.muscle_exact_emd.argtypes = [f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.muscle_exact_emd.restype = ctypes.c_float
    return lib
