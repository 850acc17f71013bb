"""Choice of the sparse value-and-gradient route.

Counterpart of ``photon_tpu/ops/sparse_grad_select.py``, reading the same
``PHOTON_SPARSE_GRAD`` variable:

- ``fused`` — the fused kernel (``ops/fused_sparse.py``): margins, loss and
  gradient scatter in one pass over the row-major batch.  It stands for the
  reference's opt-in ``PHOTON_TPU_PALLAS=1`` route, and is what ``auto``
  picks: on the card the scatter is native float atomics.
- ``pallas`` — the slab position-reduce (``ops/slab_reduce.py``): gradient
  over the batch's aligned layout ``al``, margins over its transposed layout
  ``al_t`` when present.  Needs ``attach_feature_major(..., aligned_dim=d)``.
- ``fm`` — feature-major sorted sum over the batch's ``fm`` layout (torch
  ops only).
- ``autodiff`` — the row-major unsorted scatter that differentiating the
  margin gather lowers to (torch ops only).

``fm`` and ``autodiff`` are taken only when forced.  The reference picks
among its routes by timing them once on the live device (``_measure``);
the port's ``auto`` waits for that probe until the card's times of both
kernels are on record, and picks ``fused``.
"""

from __future__ import annotations

import os

ROUTES = ("fused", "pallas", "fm", "autodiff")


def select_kernel(has_fm: bool = False, has_aligned: bool = False) -> str:
    """The route for a batch carrying the given layouts."""
    mode = os.environ.get("PHOTON_SPARSE_GRAD", "auto")
    if mode in ("xchg", "benes"):
        raise NotImplementedError(
            f"PHOTON_SPARSE_GRAD={mode}: its kernels wait in ROADMAP.md "
            f"queue 2 (TPU kernels still to port)"
        )
    if mode not in ROUTES + ("auto",):
        raise ValueError(
            f"PHOTON_SPARSE_GRAD={mode!r}; the port supports "
            f"{', '.join(ROUTES)} or auto"
        )
    if mode == "pallas":
        return "pallas" if has_aligned else ("fm" if has_fm else "fused")
    if mode == "fm":
        return "fm" if has_fm else "autodiff"
    if mode == "autodiff":
        return "autodiff"
    return "fused"


def aligned_layout_wanted() -> bool:
    """Should batch builders pay the host-side aligned-layout build?  Only
    when the ``pallas`` route is forced."""
    return os.environ.get("PHOTON_SPARSE_GRAD", "auto") == "pallas"
