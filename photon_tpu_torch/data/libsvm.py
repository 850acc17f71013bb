"""LIBSVM text format reader.

Counterpart of ``photon_tpu/data/libsvm.py`` with its pure-Python parser
(the native C++ parser waits in ROADMAP.md queue 1, item 4).

Format per line: ``<label> <id>:<val> <id>:<val> ...`` with 1-based feature
ids; a trailing ``# comment`` is ignored.  Output is a :class:`SparseBatch`
with 0-based ids and, optionally, an intercept feature appended at index
``dim``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from photon_tpu_torch.data.batch import SparseBatch, sparse_batch_from_rows


@dataclasses.dataclass
class LibsvmData:
    """Parsed LIBSVM file: ragged rows + labels, before padding/batching."""

    rows: list  # list[(np.ndarray ids, np.ndarray vals)]
    labels: np.ndarray
    dim: int  # number of features (0-based ids < dim), excluding intercept

    @property
    def num_examples(self) -> int:
        return len(self.rows)


def parse_libsvm(path: str, zero_based: bool = False) -> LibsvmData:
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
    a file whose dimension exceeds it before any padding."""
    data = parse_libsvm(path)
    if max_feature_dim is not None and data.dim > max_feature_dim:
        raise ValueError(
            f"{path}: feature id {data.dim - 1} >= dim {max_feature_dim}"
        )
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
