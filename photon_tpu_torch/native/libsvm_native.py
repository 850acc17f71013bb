"""ctypes binding for the native LIBSVM parser (``src/libsvm_parser.cpp``).

Counterpart of ``photon_tpu/native/libsvm_native.py`` for its flat-CSR
parse (``parse_file_csr``): one C++ pass into flat labels, row offsets,
ids and values, the rows that :mod:`photon_tpu_torch.data.libsvm` pads
vectorized; and its metadata scan (``scan_meta``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from photon_tpu_torch.native.build import get_lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _open_indexed(path: str):
    """Shared prologue: open + line-index a file natively.

    Returns ``(lib, handle, n, nnz)`` — the caller owns ``svm_close`` —
    or None when the native library is unavailable or the open fails
    (IO error / empty file: the Python path reports those).  ``nnz`` is
    None for 0-row files.
    """
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.svm_open(path.encode())
    if not handle:
        return None
    try:
        n = lib.svm_rows(handle)
        if n == 0:
            return lib, handle, 0, None
        nnz = np.empty(n, np.int64)
        lib.svm_row_nnz(handle, _ptr(nnz, ctypes.c_int64))
        return lib, handle, int(n), nnz
    except BaseException:
        # The caller only owns svm_close after a successful return; an
        # allocation failure here must not leak the mmap + fd.
        lib.svm_close(handle)
        raise


def scan_meta(path: str) -> Optional[tuple[int, int]]:
    """(row count, max nnz per row) from the native line indexer alone, no
    value parsing: the metadata pass of a streamed source with a known
    feature dimension; None when the native library is unavailable."""
    opened = _open_indexed(path)
    if opened is None:
        return None
    lib, handle, n, nnz = opened
    try:
        return (n, int(nnz.max())) if n else (0, 0)
    finally:
        lib.svm_close(handle)


def parse_file_csr(path: str, zero_based: bool = False) -> Optional[tuple]:
    """Flat-CSR parse: ``(labels, row_ptr, ids, vals, dim)`` — no per-row
    materialization (building n per-row numpy views costs more than the C++
    parse itself); None when the native library is unavailable.  Raises
    ValueError on malformed input.
    """
    opened = _open_indexed(path)
    if opened is None:
        return None
    lib, handle, n, nnz = opened
    try:
        if n == 0:
            return (np.zeros(0, np.float32), np.zeros(1, np.int64),
                    np.zeros(0, np.int32), np.zeros(0, np.float32), 0)
        row_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(nnz, out=row_ptr[1:])
        total = int(row_ptr[-1])
        labels = np.empty(n, np.float32)
        ids = np.empty(total, np.int32)
        vals = np.empty(total, np.float32)
        max_id = lib.svm_parse(
            handle,
            _ptr(row_ptr, ctypes.c_int64),
            _ptr(labels, ctypes.c_float),
            _ptr(ids, ctypes.c_int32),
            _ptr(vals, ctypes.c_float),
            1 if zero_based else 0,
        )
        if max_id == -2:
            raise ValueError(f"{path}: malformed LIBSVM input")
        return labels, row_ptr, ids, vals, int(max_id) + 1
    finally:
        lib.svm_close(handle)
