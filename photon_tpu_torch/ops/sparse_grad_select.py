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
- ``benes`` — the ``pallas`` reduce fed by a static Clos permutation of
  the row-major products into slot order, and a forward that gathers from
  the slab dictionary (the slab gather kernel, ``ops/slab_reduce.py``) and
  permutes the products back to row order (``ops/benes.py``); it reads no
  ``al_t``.  The attach routes it only when this route is forced.
- ``fm`` — feature-major sorted sum over the batch's ``fm`` layout (torch
  ops only).
- ``autodiff`` — the row-major unsorted scatter that differentiating the
  margin gather lowers to (torch ops only).

``pallas``, ``xchg``, ``benes``, ``fm`` and ``autodiff`` are taken only
when forced; a forced route whose layouts the batch lacks falls back as the
reference's does (``xchg`` and ``benes`` to ``pallas``, then ``fm``).  The
reference picks among the others by timing them once on the live device
(``_measure``; ``benes`` never enters it); the port's ``auto`` waits for
that probe and picks ``fused``.
"""

from __future__ import annotations

import os

ROUTES = ("fused", "pallas", "xchg", "benes", "fm", "autodiff")


def _mode() -> str:
    return os.environ.get("PHOTON_SPARSE_GRAD", "auto")


def select_kernel(has_fm: bool = False, has_aligned: bool = False,
                  has_xchg: bool = False, has_benes: bool = False) -> str:
    """The route for a batch carrying the given layouts (``has_xchg`` /
    ``has_benes``: an exchange route and the aligned layout it reduces
    over)."""
    mode = _mode()
    if mode not in ROUTES + ("auto",):
        raise ValueError(
            f"PHOTON_SPARSE_GRAD={mode!r}; the port supports "
            f"{', '.join(ROUTES)} or auto"
        )
    if mode == "xchg" and has_xchg:
        return "xchg"
    if mode == "benes" and has_benes:
        return "benes"
    if mode in ("pallas", "xchg", "benes"):
        return "pallas" if has_aligned else ("fm" if has_fm else "fused")
    if mode == "fm":
        return "fm" if has_fm else "autodiff"
    if mode == "autodiff":
        return "autodiff"
    return "fused"


def aligned_layout_wanted() -> bool:
    """Should batch builders pay the host-side aligned-layout build?  Only
    when the ``pallas``, ``xchg`` or ``benes`` route is forced."""
    return _mode() in ("pallas", "xchg", "benes")


def xchg_route_wanted() -> bool:
    """Should batch builders pay the exchange route's host build (edge
    colorings, the costliest layout build)?  Only when ``xchg`` is forced,
    as on every backend but the TPU in the reference."""
    return _mode() == "xchg"


def benes_route_wanted() -> bool:
    """Should batch builders pay the Clos routing of the ``benes`` route
    (one edge coloring of the whole entry stream)?  Only when ``benes`` is
    forced, as in the reference: ``auto`` never pays it speculatively."""
    return _mode() == "benes"
