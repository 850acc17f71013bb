"""LIBSVM text format reader.

Counterpart of ``photon_tpu/data/libsvm.py``: the native C++ parser
(``native/libsvm_native.py``, a multi-threaded mmap parse into flat CSR
arrays) when the host library builds, the pure-Python parser otherwise;
both give byte-identical batches.  A malformed file raises from either,
never falling back.  ``last_reader`` names the parser of the last
:func:`load_sparse_batch` (``"native"`` or ``"python"``).

Format per line: ``<label> <id>:<val> <id>:<val> ...`` with 1-based feature
ids; a trailing ``# comment`` is ignored.  Output is a :class:`SparseBatch`
with 0-based ids and, optionally, an intercept feature appended at index
``dim``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.data.batch import (
    SparseBatch,
    pad_row_capacity,
    sparse_batch_from_rows,
)
from photon_tpu_torch.device import resolve_device


@dataclasses.dataclass
class LibsvmData:
    """Parsed LIBSVM file: ragged rows + labels, before padding/batching."""

    rows: list  # list[(np.ndarray ids, np.ndarray vals)]
    labels: np.ndarray
    dim: int  # number of features (0-based ids < dim), excluding intercept

    @property
    def num_examples(self) -> int:
        return len(self.rows)


last_reader: str | None = None


def parse_libsvm(path: str, zero_based: bool = False) -> LibsvmData:
    """The pure-Python parse, for a host without the native library."""
    rows = []
    labels = []
    max_id = -1
    off = 0 if zero_based else 1
    with open(path, "rb") as f:
        for raw in f:
            line = raw.split(b"#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            ids = np.empty(len(parts) - 1, np.int32)
            vals = np.empty(len(parts) - 1, np.float32)
            for j, tok in enumerate(parts[1:]):
                k, v = tok.split(b":")
                fid = int(k) - off
                if fid < 0 or fid > np.iinfo(np.int32).max:
                    raise ValueError(
                        f"{path}: feature id {int(k)} out of int32 range "
                        f"(or below the {'0' if zero_based else '1'}-based minimum)"
                    )
                ids[j] = fid
                vals[j] = float(v)
            if len(ids):
                max_id = max(max_id, int(ids.max()))
            rows.append((ids, vals))
    return LibsvmData(rows=rows, labels=np.asarray(labels, np.float32), dim=max_id + 1)


def normalize_binary_labels(labels: np.ndarray) -> np.ndarray:
    """Map {-1,+1} (LIBSVM convention) or {0,1} labels to {0,1}."""
    out = labels.copy()
    out[out < 0] = 0.0
    return out


def parse_csr_or_none(path: str):
    """The native flat-CSR parse ``(labels, row_ptr, ids, vals, dim)``, or
    None when the host library is not built; a malformed file raises."""
    from photon_tpu_torch.native import libsvm_native

    return libsvm_native.parse_file_csr(path)


def load_sparse_batch(
    path: str,
    dim: int | None = None,
    intercept: bool = True,
    capacity: int | None = None,
    binary_labels: bool = True,
    max_feature_dim: int | None = None,
    device=None,
) -> tuple[SparseBatch, int, int]:
    """Parse + pad one LIBSVM file: ``(batch, total_dim, raw_dim)``.

    ``dim`` is the feature dimension before the intercept column (default:
    the file's); ``raw_dim`` is the file's own.  ``max_feature_dim`` rejects
    a file whose dimension exceeds it before any padding.  The native CSR
    parse is padded vectorized; the Python parse row by row."""
    global last_reader

    def _check(raw_dim: int) -> None:
        if max_feature_dim is not None and raw_dim > max_feature_dim:
            raise ValueError(
                f"{path}: feature id {raw_dim - 1} >= dim {max_feature_dim}"
            )

    csr = parse_csr_or_none(path)
    if csr is not None:
        last_reader = "native"
        labels, row_ptr, flat_ids, flat_vals, raw_dim = csr
        _check(raw_dim)
        batch, total_dim = csr_to_sparse_batch(
            labels, row_ptr, flat_ids, flat_vals,
            dim=raw_dim if dim is None else dim, intercept=intercept,
            capacity=capacity, binary_labels=binary_labels, device=device,
        )
        return batch, total_dim, raw_dim
    last_reader = "python"
    data = parse_libsvm(path)
    _check(data.dim)
    d = dim if dim is not None else data.dim
    rows = data.rows
    if intercept:
        rows = [
            (np.append(ids, np.int32(d)), np.append(vals, np.float32(1.0)))
            for ids, vals in rows
        ]
    labels = normalize_binary_labels(data.labels) if binary_labels else data.labels
    batch = sparse_batch_from_rows(rows, labels, capacity=capacity, device=device)
    return batch, d + (1 if intercept else 0), data.dim


def csr_to_sparse_batch(
    labels: np.ndarray,
    row_ptr: np.ndarray,
    flat_ids: np.ndarray,
    flat_vals: np.ndarray,
    dim: int | None = None,
    intercept: bool = True,
    capacity: int | None = None,
    binary_labels: bool = True,
    device=None,
) -> tuple[SparseBatch, int]:
    """Flat CSR -> padded SparseBatch, vectorized; the same batch
    :func:`sparse_batch_from_rows` builds from the rows.  ``dim`` is the
    feature dimension before the intercept column; ``capacity`` counts the
    intercept slot."""
    n = int(row_ptr.shape[0]) - 1
    d = int(dim) if dim is not None else (
        int(flat_ids.max()) + 1 if flat_ids.size else 0
    )
    nnz = np.diff(row_ptr)
    k_row = nnz + (1 if intercept else 0)
    k = capacity if capacity is not None else pad_row_capacity(k_row)
    if n and int(k_row.max()) > k:
        raise ValueError(
            f"row with {int(k_row.max())} nonzeros exceeds capacity {k}; "
            f"raise `capacity` instead of truncating features"
        )
    ids = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k), dtype=np.float32)
    if flat_ids.size:
        row_of = np.repeat(np.arange(n, dtype=np.int64), nnz)
        within = np.arange(flat_ids.size, dtype=np.int64) - np.repeat(row_ptr[:-1], nnz)
        ids[row_of, within] = flat_ids
        vals[row_of, within] = flat_vals
    if intercept and n:
        rows_idx = np.arange(n, dtype=np.int64)
        ids[rows_idx, nnz] = d
        vals[rows_idx, nnz] = 1.0
    out_labels = normalize_binary_labels(labels) if binary_labels else labels
    dev = resolve_device(device)
    batch = SparseBatch(
        ids=torch.as_tensor(ids, device=dev),
        vals=torch.as_tensor(vals, device=dev),
        label=torch.as_tensor(np.asarray(out_labels, np.float32), device=dev),
        offset=torch.zeros(n, dtype=torch.float32, device=dev),
        weight=torch.ones(n, dtype=torch.float32, device=dev),
    )
    return batch, d + (1 if intercept else 0)
