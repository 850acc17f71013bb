"""Build and load the port's host C++ library.

Counterpart of ``photon_tpu/native/build.py``.  The sources under ``src/``
are copies of the JAX package's: ``clos_route.cpp`` (``clos_edge_color``,
the edge coloring behind the ``xchg`` route's host router, ``ops/clos.py``),
``libsvm_parser.cpp`` (the multi-threaded mmap LIBSVM parser,
``native/libsvm_native.py``) and ``avro_game.cpp`` (the columnar GAME Avro
decoder, ``native/avro_native.py``).  ``g++`` compiles every ``src/*.cpp``
at the first call into one library in the git-ignored
``photon_tpu_torch/_build/``, under a name that carries a hash of the
sources and flags, so a stale library is never loaded; the library is bound
with :mod:`ctypes`.  No CUDA toolkit is needed, so it builds on any host,
the CPU test machine included.  A failed build is remembered for the
process: :func:`get_lib` then returns ``None``, the router refuses routes
too large for its Python walk and the readers take their Python paths.
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


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cpp")))


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libphoton_native_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    t0 = time.monotonic()
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", tmp, *sources()],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    build_seconds = time.monotonic() - t0


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.svm_open.restype = c.c_void_p
    lib.svm_open.argtypes = [c.c_char_p]
    lib.svm_rows.restype = c.c_int64
    lib.svm_rows.argtypes = [c.c_void_p]
    lib.svm_total_nnz.restype = c.c_int64
    lib.svm_total_nnz.argtypes = [c.c_void_p]
    lib.svm_row_nnz.restype = None
    lib.svm_row_nnz.argtypes = [c.c_void_p, c.POINTER(c.c_int64)]
    lib.svm_parse.restype = c.c_int64
    lib.svm_parse.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.POINTER(c.c_float),
        c.POINTER(c.c_int32), c.POINTER(c.c_float), c.c_int,
    ]
    lib.svm_close.restype = None
    lib.svm_close.argtypes = [c.c_void_p]

    lib.gav_open.restype = c.c_void_p
    lib.gav_open.argtypes = [c.c_char_p, c.c_int64, c.c_char_p, c.c_char_p, c.c_int64]
    lib.gav_decode.restype = c.c_int64
    lib.gav_decode.argtypes = [c.c_void_p]
    lib.gav_error.restype = c.c_char_p
    lib.gav_error.argtypes = [c.c_void_p]
    for name, args in (
        ("gav_doubles", [c.c_void_p, c.c_int32, c.POINTER(c.c_double)]),
        ("gav_string_ids", [c.c_void_p, c.c_int32, c.POINTER(c.c_int32)]),
        ("gav_string_vocab", [c.c_void_p, c.c_int32, c.POINTER(c.c_int32), c.c_char_p]),
        ("gav_bag_nnz", [c.c_void_p, c.c_int32, c.POINTER(c.c_int32)]),
        ("gav_bag_pairs", [c.c_void_p, c.c_int32, c.POINTER(c.c_int32)]),
        ("gav_bag_vals", [c.c_void_p, c.c_int32, c.POINTER(c.c_float)]),
        ("gav_pair_vocab", [c.c_void_p, c.c_int32, c.POINTER(c.c_int32), c.c_char_p]),
    ):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = args
    for name in ("gav_string_vocab_size", "gav_string_vocab_bytes",
                 "gav_bag_entries", "gav_pair_vocab_size", "gav_pair_vocab_bytes"):
        fn = getattr(lib, name)
        fn.restype = c.c_int64
        fn.argtypes = [c.c_void_p, c.c_int32]
    lib.gav_close.restype = None
    lib.gav_close.argtypes = [c.c_void_p]

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
