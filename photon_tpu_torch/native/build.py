"""Build and load the port's host C++ library.

Counterpart of ``photon_tpu/native/build.py`` for the one entry point the
port needs so far: ``clos_edge_color`` (``src/clos_route.cpp``, a copy of
the JAX package's source), the edge coloring behind the ``xchg`` route's
host router (``ops/clos.py``).  ``g++`` compiles every ``src/*.cpp`` at the
first call into the git-ignored ``photon_tpu_torch/_build/``, under a name
that carries a hash of the sources and flags, so a stale library is never
loaded; the library is bound with :mod:`ctypes`.  No CUDA toolkit is
needed, so routes build on any host, the CPU test machine included.  A
failed build is remembered for the process: :func:`get_lib` then returns
``None`` and the router refuses routes too large for its Python walk.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "src")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed: Optional[str] = None
# Seconds the last build took (0.0 when the library was already built).
build_seconds: float = 0.0


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cpp")))


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libphoton_native_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    t0 = time.monotonic()
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", tmp, *_sources()],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    build_seconds = time.monotonic() - t0


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.clos_edge_color.restype = c.c_int32
    lib.clos_edge_color.argtypes = [
        c.c_int64, c.c_int32, c.c_int32, c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
    ]


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it at the first call; ``None`` when it
    cannot be built (no ``g++``, or a compile error: see :func:`build_error`)."""
    global _lib, _failed
    with _LOCK:
        if _lib is None and _failed is None:
            path = lib_path()
            try:
                if not os.path.exists(path):
                    _compile(path)
                lib = ctypes.CDLL(path)
                _declare(lib)
                _lib = lib
            except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
                _failed = str(exc)
        return _lib


def build_error() -> Optional[str]:
    """Why the last :func:`get_lib` returned ``None``."""
    return _failed
