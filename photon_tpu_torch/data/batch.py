"""Static-shape training batches on tensors.

Counterpart of ``photon_tpu/data/batch.py``.  Two layouts:

- :class:`DenseBatch` — ``x: [n, d]`` feature matrix.
- :class:`SparseBatch` — padded COO per row, ``ids/vals: [n, k]`` with a
  fixed per-row capacity ``k``; pad entries are ``id=0, val=0`` and so add
  ``w[0] * 0 = 0`` to margins and nothing to gradients, with no masks.

Both carry ``label``, ``offset`` and ``weight`` per row.  A sparse batch can
also carry static layouts built once on the host and used by every
objective evaluation: the feature-major sort (``fm``, for the ``fm`` route)
and the slab-aligned layouts (``al`` for the gradient, ``al_t`` for the
margins, for the ``pallas`` route — ``ops/slab_reduce.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from photon_tpu_torch.device import resolve_device

Tensor = torch.Tensor


class FeatureMajorAux(NamedTuple):
    """The batch's entries sorted by feature id (a stable host argsort), so
    the gradient is a sum over runs of equal ids instead of an unsorted
    scatter: ``ids`` (non-decreasing), ``rows`` (source row of each entry)
    and ``vals`` (0 for pad entries), each ``[n * k]``."""

    ids: Tensor
    rows: Tensor
    vals: Tensor


class DenseBatch(NamedTuple):
    """A batch of examples with dense features."""

    x: Tensor  # [n, d] float32
    label: Tensor  # [n]
    offset: Tensor  # [n]
    weight: Tensor  # [n]

    @property
    def num_examples(self) -> int:
        return int(self.x.shape[0])

    @property
    def dim(self) -> int:
        return int(self.x.shape[1])

    def to(self, device) -> "DenseBatch":
        return DenseBatch(*(t.to(device) for t in self))


class SparseBatch(NamedTuple):
    """A batch of examples with padded sparse features.

    ``ids[i, j]`` / ``vals[i, j]`` give the j-th nonzero of example i; rows
    with fewer than ``k`` nonzeros are padded with ``(0, 0.0)``.
    """

    ids: Tensor  # [n, k] int32
    vals: Tensor  # [n, k] float32
    label: Tensor  # [n] float32
    offset: Tensor  # [n] float32
    weight: Tensor  # [n] float32
    fm: Optional[FeatureMajorAux] = None
    al: Optional[object] = None  # ops.slab_reduce.AlignedLayoutDev
    al_t: Optional[object] = None  # transposed (row-dictionary) layout

    @property
    def num_examples(self) -> int:
        return int(self.ids.shape[0])

    @property
    def device(self) -> torch.device:
        return self.ids.device

    def to(self, device) -> "SparseBatch":
        """The batch, layouts included, on ``device``."""
        fm = None if self.fm is None else FeatureMajorAux(
            *(t.to(device) for t in self.fm)
        )
        return SparseBatch(
            *(t.to(device) for t in self[:5]),
            fm=fm,
            al=None if self.al is None else self.al.to(device),
            al_t=None if self.al_t is None else self.al_t.to(device),
        )


Batch = Union[DenseBatch, SparseBatch]


def gather_dot(u: Tensor, ids: Tensor, vals: Tensor) -> Tensor:
    """Per-row ``sum_j u[ids_ij] * vals_ij`` (the row-major gather)."""
    return (u.index_select(0, ids.reshape(-1)).view(ids.shape) * vals).sum(-1)


def margins(w: Tensor, batch: Batch) -> Tensor:
    """Per-example margins ``w . x_i + offset_i``."""
    if isinstance(batch, DenseBatch):
        return batch.x @ w + batch.offset
    return gather_dot(w, batch.ids, batch.vals) + batch.offset


def _column(values, n: int, fill: float, device) -> Tensor:
    if values is None:
        return torch.full((n,), fill, dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def dense_batch(x, label, offset=None, weight=None, device=None) -> DenseBatch:
    dev = resolve_device(device)
    n = len(x)
    return DenseBatch(
        x=torch.as_tensor(np.asarray(x, np.float32), device=dev),
        label=_column(label, n, 0.0, dev),
        offset=_column(offset, n, 0.0, dev),
        weight=_column(weight, n, 1.0, dev),
    )


def pad_row_capacity(nnz_per_row: np.ndarray) -> int:
    """The padded per-row capacity k: the smallest power of two >= the
    largest row's nonzero count."""
    max_nnz = int(nnz_per_row.max()) if len(nnz_per_row) else 1
    k = 1
    while k < max_nnz:
        k *= 2
    return k


def sparse_batch_from_rows(
    rows: list[tuple[np.ndarray, np.ndarray]],
    label: np.ndarray,
    offset: np.ndarray | None = None,
    weight: np.ndarray | None = None,
    capacity: int | None = None,
    device=None,
) -> SparseBatch:
    """Build a SparseBatch from per-row (ids, vals) arrays, padding to a fixed
    capacity (power-of-two bucket by default).  Raises if a row has more
    nonzeros than the capacity rather than drop features."""
    dev = resolve_device(device)
    n = len(rows)
    nnz = np.array([len(ids) for ids, _ in rows], dtype=np.int64)
    k = capacity if capacity is not None else pad_row_capacity(nnz)
    if len(nnz) and int(nnz.max()) > k:
        raise ValueError(
            f"row with {int(nnz.max())} nonzeros exceeds capacity {k}; "
            f"raise `capacity` instead of truncating features"
        )
    ids = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k), dtype=np.float32)
    for i, (r_ids, r_vals) in enumerate(rows):
        m = len(r_ids)
        ids[i, :m] = r_ids
        vals[i, :m] = r_vals
    return SparseBatch(
        ids=torch.as_tensor(ids, device=dev),
        vals=torch.as_tensor(vals, device=dev),
        label=_column(label, n, 0.0, dev),
        offset=_column(offset, n, 0.0, dev),
        weight=_column(weight, n, 1.0, dev),
    )


def attach_feature_major(
    batch: SparseBatch,
    aligned_dim: int | None = None,
    aligned_forward: bool = True,
) -> SparseBatch:
    """Attach the static layouts, built on the host once per dataset.

    Always the feature-major sort (:class:`FeatureMajorAux`).  With
    ``aligned_dim`` (the coefficient dimension) also the slab-aligned
    gradient layout ``al`` and, unless ``aligned_forward`` is False, the
    transposed layout ``al_t`` whose position-reduce yields the margins —
    the inputs of the ``pallas`` route.  Single-device batches only.
    """
    if not isinstance(batch, SparseBatch) or batch.ids.ndim != 2:
        raise ValueError("feature-major layout requires a 2-D SparseBatch")
    dev = batch.device
    n, k = batch.ids.shape
    ids = batch.ids.cpu().numpy().reshape(-1)
    vals = batch.vals.cpu().numpy().reshape(-1)
    rows = np.repeat(np.arange(n, dtype=np.int32), k)
    order = np.argsort(ids, kind="stable")
    batch = batch._replace(fm=FeatureMajorAux(
        ids=torch.as_tensor(ids[order], device=dev),
        rows=torch.as_tensor(rows[order], device=dev),
        vals=torch.as_tensor(vals[order], device=dev),
    ))
    if aligned_dim is not None:
        from photon_tpu_torch.ops.slab_reduce import (
            build_aligned_layout,
            build_row_aligned_layout,
            device_layout,
        )

        ids2 = ids.reshape(n, k)
        vals2 = vals.reshape(n, k)
        batch = batch._replace(
            al=device_layout(build_aligned_layout(ids2, vals2, aligned_dim), dev)
        )
        if aligned_forward:
            batch = batch._replace(
                al_t=device_layout(build_row_aligned_layout(ids2, vals2), dev)
            )
    return batch
