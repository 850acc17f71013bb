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
margins, for the ``pallas`` route — ``ops/slab_reduce.py``), the
exchange route of the ``xchg`` route (``xchg``, ``ops/vperm.py``) and the
Clos routes of the ``benes`` route (``benes``, ``ops/benes.py``).

Feature values may be stored in bfloat16 (:func:`batch_astype`, the
reference's storage option): only the value streams narrow — labels,
offsets, weights, coefficients and every reduction stay float32 — and
every route widens a value where it reads it, as JAX promotes it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from photon_tpu_torch.device import resolve_device

Tensor = torch.Tensor


class FeatureMajorAux(NamedTuple):
    """The batch's entries sorted by feature id (a stable host argsort), so
    the gradient is a sum over runs of equal ids instead of an unsorted
    scatter: ``ids`` (non-decreasing), ``rows`` (source row of each entry)
    and ``vals`` (0 for pad entries; the batch's value dtype), each
    ``[n * k]``."""

    ids: Tensor
    rows: Tensor
    vals: Tensor


class DenseBatch(NamedTuple):
    """A batch of examples with dense features."""

    x: Tensor  # [n, d] float32 (or bfloat16: batch_astype)
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
    vals: Tensor  # [n, k] float32 (or bfloat16: batch_astype)
    label: Tensor  # [n] float32
    offset: Tensor  # [n] float32
    weight: Tensor  # [n] float32
    fm: Optional[FeatureMajorAux] = None
    al: Optional[object] = None  # ops.slab_reduce.AlignedLayoutDev
    al_t: Optional[object] = None  # transposed (row-dictionary) layout
    xchg: Optional[object] = None  # ops.vperm.XchgAux, into al's slot order
    benes: Optional[object] = None  # ops.benes.BenesAux, al's slots <-> rows

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
            xchg=None if self.xchg is None else self.xchg.to(device),
            benes=None if self.benes is None else self.benes.to(device),
        )


Batch = Union[DenseBatch, SparseBatch]


def gather_dot(u: Tensor, ids: Tensor, vals: Tensor) -> Tensor:
    """Per-row ``sum_j u[ids_ij] * vals_ij`` (the row-major gather; bfloat16
    ``vals`` widen in the multiply, the result has ``u``'s dtype)."""
    return (u.index_select(0, ids.reshape(-1)).view(ids.shape) * vals).sum(-1)


def scatter_sum(index: Tensor, values: Tensor, dim: int) -> Tensor:
    """``out[f] = sum of values[e] over index[e] == f`` (``[dim]`` float32),
    the transpose of a gather.  The sums accumulate in float64 and round
    once: on the card ``index_add_`` adds with atomics in another order each
    run, and a float32 sum of a hot key's millions of terms moves by about
    1e-4 relative from one order to the next, which TRON's inner solves
    amplify; in float64 the order hardly ever shows after the rounding."""
    out = torch.zeros(dim, dtype=torch.float64, device=values.device)
    return out.index_add_(0, index, values.double()).float()


def margins(w: Tensor, batch: Batch) -> Tensor:
    """Per-example margins ``w . x_i + offset_i`` (float32 whatever the
    value dtype: bfloat16 features widen before the product)."""
    if isinstance(batch, DenseBatch):
        return batch.x.to(w.dtype) @ w + batch.offset
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
    the inputs of the ``pallas`` route.  When the ``xchg`` route is wanted
    (forced with ``PHOTON_SPARSE_GRAD=xchg``, or ``auto`` on the card at or
    above its floor: ``ops/sparse_grad_select.xchg_route_wanted``) also the
    exchange route with the values baked in — into ``al``'s slot order, or
    under ``PHOTON_XCHG_REDUCE=cumsum`` into the feature-sorted stream —
    and ``al_t`` whatever
    ``aligned_forward`` says: the route exists to remove the per-step
    gathers, and row-major margins would bring one back.  When the
    ``benes`` route is forced (``PHOTON_SPARSE_GRAD=benes``) also its Clos
    routes between the row-major stream and ``al``'s slots, and no
    ``al_t``: that route's forward reads ``al``.  Single-device batches
    only.
    """
    if not isinstance(batch, SparseBatch) or batch.ids.ndim != 2:
        raise ValueError("feature-major layout requires a 2-D SparseBatch")
    dev = batch.device
    n, k = batch.ids.shape
    ids = batch.ids.cpu().numpy().reshape(-1)
    # The host builders read float32 (a bfloat16 value widens exactly); the
    # sorted values keep the batch's dtype and the slab layouts and baked
    # values take float32, as the reference's builders cast them.
    vals = batch.vals.float().cpu().numpy().reshape(-1)
    rows = np.repeat(np.arange(n, dtype=np.int32), k)
    order = np.argsort(ids, kind="stable")
    batch = batch._replace(fm=FeatureMajorAux(
        ids=torch.as_tensor(ids[order], device=dev),
        rows=torch.as_tensor(rows[order], device=dev),
        vals=torch.as_tensor(vals[order], device=dev).to(batch.vals.dtype),
    ))
    if aligned_dim is not None:
        from photon_tpu_torch.ops.slab_reduce import (
            build_aligned_layout,
            build_row_aligned_layout,
            device_layout,
        )
        from photon_tpu_torch.ops.sparse_grad_select import (
            benes_route_wanted,
            xchg_route_wanted,
        )

        ids2 = ids.reshape(n, k)
        vals2 = vals.reshape(n, k)
        want_xchg = xchg_route_wanted(n * k, dev)
        want_benes = benes_route_wanted()
        layout = build_aligned_layout(ids2, vals2, aligned_dim)
        batch = batch._replace(al=device_layout(layout, dev))
        if want_xchg or (aligned_forward and not want_benes):
            batch = batch._replace(
                al_t=device_layout(build_row_aligned_layout(ids2, vals2), dev)
            )
        if want_xchg:
            from photon_tpu_torch.ops.vperm import build_xchg_aux

            # The route follows PHOTON_XCHG_REDUCE: the aligned mode needs
            # the host layout's slot sources (``src``), which the device
            # layout does not carry; the cumsum mode the stable argsort the
            # fm layout already paid for.
            batch = batch._replace(
                xchg=build_xchg_aux(layout, ids2, vals=vals2, device=dev,
                                    dim=aligned_dim, order=order)
            )
        if want_benes:
            from photon_tpu_torch.ops.benes import build_benes_aux

            batch = batch._replace(benes=build_benes_aux(layout, n, k, device=dev))
    return batch


def value_dtype(dtype) -> torch.dtype:
    """The feature-value storage dtype named by ``dtype`` (a torch dtype, or
    ``"float32"`` / ``"bfloat16"``); anything else raises."""
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    out = names.get(dtype) if isinstance(dtype, str) else dtype
    if out not in names.values():
        raise ValueError(f"feature values are stored as float32 or bfloat16, not {dtype!r}")
    return out


def batch_astype(batch: Batch, dtype) -> Batch:
    """Re-store the batch's FEATURE VALUES in ``dtype`` (``torch.bfloat16``
    or ``"bfloat16"``; float32 leaves them as they are), on their device.

    Counterpart of the reference's ``batch_astype``: only the value streams
    shrink — ``x``, or ``vals``, ``fm.vals``, the aligned layouts' ``vals``
    and the baked ``xchg.vals_dest`` — and labels, offsets, weights,
    coefficients and every reduction stay float32.  No layout or route is
    rebuilt: the conversion is one pass over each value stream.  The baked
    stream converts in place so that the margins and the gradient read one
    value stream: the cast is elementwise, so it commutes with the static
    permutation that baked it (pads stay zero), and the baked values' guard
    takes bf16-rounded values within its tolerance.  The conversion rounds
    to nearest even, as ``ml_dtypes`` does for the reference.
    """
    dtype = value_dtype(dtype)
    if isinstance(batch, DenseBatch):
        return batch._replace(x=batch.x.to(dtype))
    out = batch._replace(vals=batch.vals.to(dtype))
    if out.fm is not None:
        out = out._replace(fm=out.fm._replace(vals=out.fm.vals.to(dtype)))
    for aux in ("al", "al_t"):
        lay = getattr(out, aux)
        if lay is not None:
            out = out._replace(**{aux: dataclasses.replace(lay, vals=lay.vals.to(dtype))})
    if out.xchg is not None and out.xchg.vals_dest is not None:
        out = out._replace(xchg=dataclasses.replace(
            out.xchg, vals_dest=out.xchg.vals_dest.to(dtype)))
    return out


def pad_batch(batch: Batch, target_n: int) -> Batch:
    """Pad a batch to ``target_n`` examples with zero-weight rows (so padded
    rows contribute nothing to any weighted objective or evaluator).

    The feature-major, aligned and routing layouts depend on the row count
    and the block structure, and padding them leaf by leaf would corrupt
    them (the exchange's index planes most of all): they are stripped, and
    the caller attaches again at the final row count (padded rows carry
    only zero-value entries, so a layout rebuilt after padding is
    equivalent)."""
    n = batch.num_examples
    if n == target_n:
        return batch
    if n > target_n:
        raise ValueError(f"batch has {n} rows > target {target_n}")
    pad = target_n - n

    def _pad(t: Tensor) -> Tensor:
        return torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])

    if isinstance(batch, DenseBatch):
        return DenseBatch(*(_pad(t) for t in batch))
    return SparseBatch(*(_pad(t) for t in batch[:5]))
