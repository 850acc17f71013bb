"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through :mod:`ctypes` (no PyTorch
headers, so a build takes seconds, not minutes).  All sources build at the
first CUDA use, one ``nvcc`` process per source, started together.  The
libraries land in ``photon_tpu_torch/_build/`` (git-ignored) under names
that carry a hash of their source and flags, so a stale library is never
loaded.  Importing this module needs no ``nvcc``; building does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# Seconds the last build took and the ptxas resource report of each source.
build_seconds: float = 0.0
build_logs: dict[str, str] = {}


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every source that has no up-to-date library; returns
    ``{name: library path}``.  Raises with nvcc's output on failure."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: _lib_path(name) for name in sources()}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = _nvcc()
    t0 = time.monotonic()
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, todo[name])
    build_seconds = time.monotonic() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``ops/csrc/<name>.cu``, building all sources at
    the first call."""
    with _LOCK:
        if name not in _LIBS:
            for n, path in build_all().items():
                if n not in _LIBS:
                    _LIBS[n] = ctypes.CDLL(path)
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with CUDA error {err}")
