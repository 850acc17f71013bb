"""The ``benes`` route: value, gradient and Hv through the slab layout with
no random access to the entry stream.

Counterpart of ``photon_tpu/ops/benes.py``.  Both halves reach the entries
through one static permutation between the row-major entry stream
(``n * k``, zero-padded) and the aligned layout's slots (``al``), routed
once on the host as a three-stage Clos network (``ops/clos.py``):

- forward (margins and ``X v``): the dictionary gather ``u[dup_map]``, the
  slab gather kernel (``ops/slab_reduce.aligned_gather_products``, K3) for
  the per-slot products, the permutation ``to_rows`` into row-major order,
  and a per-row sum;
- reduce (gradient and Hv): the row-major products ``per_row * vals``, the
  permutation ``to_slots`` into slot order, and the aligned reduce (the
  position-reduce kernel, K2, and its epilogue).

``to_rows`` is ``to_slots`` inverted row by row, so one edge coloring
serves both directions.  The attach builds the routes only when
``PHOTON_SPARSE_GRAD=benes`` is forced (``data/batch.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from photon_tpu_torch.ops.clos import (
    ClosRouteDev,
    apply_clos_grid,
    default_grid,
    device_route,
    invert_route,
    route_permutation,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BenesAux:
    """The batch's exchange for the ``benes`` route: ``to_slots`` permutes
    the zero-padded row-major entry stream (``a * b`` long) into the aligned
    layout's slot order, ``to_rows`` is its inverse.  ``n_rowmajor = n * k``
    and ``n_slots = total_sub * 128`` are the real prefixes on each side."""

    to_slots: ClosRouteDev
    to_rows: ClosRouteDev
    n_rowmajor: int
    n_slots: int

    @property
    def grid(self) -> int:
        return self.to_slots.a * self.to_slots.b

    def to(self, device) -> "BenesAux":
        return dataclasses.replace(
            self, to_slots=self.to_slots.to(device), to_rows=self.to_rows.to(device)
        )


def build_benes_aux(layout, n: int, k: int, *, a: int | None = None,
                    b: int | None = None, device=None) -> BenesAux:
    """Route the row-major <-> slot exchange of one batch's gradient layout
    (the host :class:`~photon_tpu_torch.ops.slab_reduce.AlignedLayout`,
    which carries each slot's source entry ``src``).  Host cost: one edge
    coloring of the grid (``native/src/clos_route.cpp``), once per dataset."""
    from photon_tpu_torch.ops.vperm import full_bijection

    n_rowmajor = n * k
    slots_src = layout.src.reshape(-1)
    n_slots = int(slots_src.size)
    need = max(n_rowmajor, n_slots)
    if a is None or b is None:
        a, b = default_grid(need)
    if a * b < need:
        raise ValueError(f"grid {a}x{b} < required {need}")
    # Slot t takes its entry's row-major position; pad slots and the grid's
    # tail take the unused positions (pad entries, the zero tail), which
    # only ever carry zeros.
    to_slots = route_permutation(full_bijection(slots_src, n_rowmajor, a * b), a, b)
    return BenesAux(
        to_slots=device_route(to_slots, device),
        to_rows=device_route(invert_route(to_slots), device),
        n_rowmajor=n_rowmajor, n_slots=n_slots,
    )


def _pad_to_grid(x: Tensor, aux: BenesAux) -> Tensor:
    return torch.cat([x, x.new_zeros(aux.grid - x.shape[0])])


def benes_xu_product(u: Tensor, al, aux: BenesAux, n: int, k: int) -> Tensor:
    """Per-row ``X u`` (margins without offset): the dictionary gather, the
    slab gather kernel, the permutation into row order, a per-row sum."""
    from photon_tpu_torch.ops.slab_reduce import LANES, aligned_gather_products

    u2d = u.index_select(0, al.dup_map).view(-1, LANES)
    pw = aligned_gather_products(u2d, al.slab_of_tile, al.lo, al.vals)
    rowmajor = apply_clos_grid(_pad_to_grid(pw.view(-1), aux), aux.to_rows)
    return rowmajor[:aux.n_rowmajor].view(n, k).sum(dim=1)


def benes_slot_products(per_row: Tensor, vals_rowmajor: Tensor,
                        aux: BenesAux) -> Tensor:
    """The slot stream ``per_row[row_s] * val_s`` (``[n_slots]``): the
    row-major products permuted into slot order, bit for bit what the
    ``pallas`` route forms as ``per_row[rows] * vals``."""
    pv_row = (per_row[:, None] * vals_rowmajor).reshape(-1)
    return apply_clos_grid(_pad_to_grid(pv_row, aux), aux.to_slots)[:aux.n_slots]


def benes_segment_grad(per_row: Tensor, vals_rowmajor: Tensor, al,
                       aux: BenesAux, dim: int) -> Tensor:
    """``g[f] = sum_e per_row[row_e] * val_e``: the slot products folded by
    the aligned reduce over the gradient layout ``al``."""
    from photon_tpu_torch.ops.slab_reduce import aligned_reduce

    pv = benes_slot_products(per_row, vals_rowmajor, aux)
    return aligned_reduce(pv.view(al.lo.shape), al, dim)
