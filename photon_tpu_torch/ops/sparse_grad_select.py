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
- ``xchg`` — the ``pallas`` route with the per-step ``per_row[rows]`` gather
  replaced by a static exchange routed once on the host (``ops/vperm.py``):
  gradient through the batch's ``xchg`` route and ``al``, margins over
  ``al_t``.  The attach builds the route only when this route is forced.
- ``fm`` — feature-major sorted sum over the batch's ``fm`` layout (torch
  ops only).
- ``autodiff`` — the row-major unsorted scatter that differentiating the
  margin gather lowers to (torch ops only).

``pallas``, ``xchg``, ``fm`` and ``autodiff`` are taken only when forced.
The reference picks among its routes by timing them once on the live device
(``_measure``); the port's ``auto`` waits for that probe until the card's
times of the kernels are on record, and picks ``fused``.  ``benes`` (the
reference's refuted research route) is not ported.
"""

from __future__ import annotations

import os

ROUTES = ("fused", "pallas", "xchg", "fm", "autodiff")


def _mode() -> str:
    return os.environ.get("PHOTON_SPARSE_GRAD", "auto")


def select_kernel(has_fm: bool = False, has_aligned: bool = False,
                  has_xchg: bool = False) -> str:
    """The route for a batch carrying the given layouts (``has_xchg``: an
    exchange route and the aligned layout it reduces over)."""
    mode = _mode()
    if mode == "benes":
        raise NotImplementedError(
            "PHOTON_SPARSE_GRAD=benes: its slab gather kernel waits in "
            "ROADMAP.md queue 2 (TPU kernels still to port)"
        )
    if mode not in ROUTES + ("auto",):
        raise ValueError(
            f"PHOTON_SPARSE_GRAD={mode!r}; the port supports "
            f"{', '.join(ROUTES)} or auto"
        )
    if mode == "xchg" and has_xchg:
        return "xchg"
    if mode in ("pallas", "xchg"):
        return "pallas" if has_aligned else ("fm" if has_fm else "fused")
    if mode == "fm":
        return "fm" if has_fm else "autodiff"
    if mode == "autodiff":
        return "autodiff"
    return "fused"


def aligned_layout_wanted() -> bool:
    """Should batch builders pay the host-side aligned-layout build?  Only
    when the ``pallas`` or ``xchg`` route is forced."""
    return _mode() in ("pallas", "xchg")


def xchg_route_wanted() -> bool:
    """Should batch builders pay the exchange route's host build (edge
    colorings, the costliest layout build)?  Only when ``xchg`` is forced,
    as on every backend but the TPU in the reference."""
    return _mode() == "xchg"
