"""Static-permutation routing on the host: an arbitrary permutation of an
``[A, B]`` grid as row-local shuffles and transposes.

Counterpart of the host half of ``photon_tpu/ops/clos.py``; the ``xchg``
route builders (``ops/vperm.py``) factor every stage through it.  Viewing
``x`` as an ``[A, B]`` grid,

    y = x[perm]   ==   P3_rows( T( P2_rows( T( P1_rows(x) ) ) ) )

where T is a transpose and each ``P*_rows`` applies an independent
permutation per row (the Clos / Slepian-Duguid 3-stage factorization).  The
factorization is a proper B-edge-coloring of a bipartite multigraph, which
``clos_edge_color`` (``native/src/clos_route.cpp``) computes by Euler
splitting; :func:`_edge_color_python` is the same algorithm in Python, the
test oracle and the path for grids under ``PYTHON_ROUTE_CAP`` elements when
the native library cannot be built.  Larger grids refuse rather than run an
hours-long Python walk.

Routing is numpy on the host, one-time work per dataset layout.  The
``xchg`` route re-factors the stage arrays (``ops/vperm.py``) before any of
them reaches a device; the ``benes`` route (``ops/benes.py``) applies them
as they are: :func:`device_route` puts a route's stages on a device and
:func:`apply_clos_grid` runs the three row-local stages as ``torch.gather``
with transposes between them, as the reference runs them in XLA
(``take_along_axis``).  ``torch.gather`` takes int64 indices only, so the
device stages are stored int64: at a 2^26-element grid that is 512 MB a
stage, about 3.2 GB for the two directions of one exchange, against
widening three int32 stages on every call.  :func:`invert_route` inverts
a route row by row on the host, so one coloring serves both directions.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

# Grids at or above this many elements need the native router.
PYTHON_ROUTE_CAP = 1 << 18


@dataclasses.dataclass(frozen=True)
class ClosRoute:
    """Host routing for one static permutation ``y = x[perm]``.

    ``p1`` [A, B], ``p2`` [B, A], ``p3`` [A, B] are int32 within-row gather
    indices: stage k computes ``x = take_along_axis(x, pk, axis=1)`` with
    transposes between stages.  ``n`` is the unpadded element count; the
    grid holds ``A * B >= n`` with an identity tail.
    """

    n: int
    a: int
    b: int
    p1: np.ndarray
    p2: np.ndarray
    p3: np.ndarray


def default_grid(n: int) -> tuple[int, int]:
    """Most-square power-of-two (A, B) grid covering ``n`` elements (B must
    be a power of two for the Euler-split coloring)."""
    bits = max(1, int(np.ceil(np.log2(max(n, 2)))))
    a = 1 << ((bits + 1) // 2)
    b = 1 << (bits - (bits + 1) // 2)
    return a, b


def _edge_color_native(l: np.ndarray, r: np.ndarray, a: int,
                       b: int) -> Optional[np.ndarray]:
    """The native coloring, or ``None`` when the library cannot be built."""
    from photon_tpu_torch.native import build as native_build

    lib = native_build.get_lib()
    if lib is None:
        return None
    color = np.empty(l.size, dtype=np.int32)
    rc = lib.clos_edge_color(
        np.int64(l.size), np.int32(a), np.int32(b),
        l.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        color.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc == -3:
        raise ValueError(
            f"permutation too large for the native router ({l.size:,} "
            f"edges > INT32_MAX/2 — head prefix sums reach 2E); shard "
            f"the layout before routing"
        )
    if rc != 0:
        raise RuntimeError(f"clos_edge_color failed: rc={rc}")
    return color


def _edge_color_python(l: np.ndarray, r: np.ndarray, a: int,
                       b: int) -> np.ndarray:
    """Pure-Python Euler-split coloring (test oracle and small-grid path):
    the native algorithm, far too slow for production sizes."""
    if b & (b - 1):
        raise ValueError(f"B must be a power of two, got {b}")
    color = np.empty(l.size, dtype=np.int32)

    def split(edges: np.ndarray, base: int, span: int) -> None:
        if span == 1:
            color[edges] = base
            return
        # Adjacency over 2a vertices: vertex -> list of edges.
        adj: list[list[int]] = [[] for _ in range(2 * a)]
        for e in edges:
            adj[l[e]].append(int(e))
            adj[a + r[e]].append(int(e))
        cursor = [0] * (2 * a)
        used = set()
        halves: tuple[list[int], list[int]] = ([], [])
        for v0 in range(2 * a):
            while cursor[v0] < len(adj[v0]):
                if adj[v0][cursor[v0]] in used:
                    cursor[v0] += 1
                    continue
                circuit: list[int] = []
                vstack = [v0]
                estack: list[int] = [-1]
                while vstack:
                    v = vstack[-1]
                    while (cursor[v] < len(adj[v])
                           and adj[v][cursor[v]] in used):
                        cursor[v] += 1
                    if cursor[v] < len(adj[v]):
                        e = adj[v][cursor[v]]
                        used.add(e)
                        other = (a + r[e]) if v == l[e] else l[e]
                        vstack.append(other)
                        estack.append(e)
                    else:
                        e = estack.pop()
                        vstack.pop()
                        if e >= 0:
                            circuit.append(e)
                for i, e in enumerate(circuit):
                    halves[i % 2].append(e)
        assert len(halves[0]) == len(halves[1]) == edges.size // 2
        split(np.asarray(halves[0]), base, span // 2)
        split(np.asarray(halves[1]), base + span // 2, span // 2)

    split(np.arange(l.size, dtype=np.int64), 0, b)
    return color


def route_permutation(perm: np.ndarray, a: Optional[int] = None,
                      b: Optional[int] = None, *,
                      use_native: bool = True) -> ClosRoute:
    """Factor ``y = x[perm]`` into the 3-stage row-local form (host numpy).

    ``a``/``b`` default to :func:`default_grid`; a grid larger than
    ``len(perm)`` gets an identity tail.
    """
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    n = perm.size
    if a is None or b is None:
        a, b = default_grid(n)
    total = a * b
    if total < n:
        raise ValueError(f"grid {a}x{b} smaller than permutation ({n})")
    if perm.size and (
        perm.min() < 0 or perm.max() >= n
        or np.bincount(perm, minlength=n).max() != 1
    ):
        raise ValueError("perm is not a permutation of [0, n)")
    full = np.arange(total, dtype=np.int64)
    full[:n] = perm

    src_row = (full // b).astype(np.int32)   # source row of each destination
    dst_row = (np.arange(total, dtype=np.int64) // b).astype(np.int32)
    src_col = (full % b).astype(np.int32)
    dst_col = (np.arange(total, dtype=np.int64) % b).astype(np.int32)

    color = _edge_color_native(src_row, dst_row, a, b) if use_native else None
    if color is None:
        if total >= PYTHON_ROUTE_CAP:
            from photon_tpu_torch.native.build import build_error

            raise RuntimeError(
                f"native clos_edge_color unavailable ({build_error()}) and "
                f"the permutation ({total:,} elements) is too large for the "
                f"Python router; build the native library (g++)"
            )
        color = _edge_color_python(src_row, dst_row, a, b)

    # Stage index arrays (see clos_route.cpp for the derivation):
    #   P1[a_s, c]   = b_s   (source-row shuffle into color columns)
    #   P2[c, a_d]   = a_s   (middle-row shuffle routing to dest rows)
    #   P3[a_d, b_d] = c     (dest-row shuffle into final columns)
    p1 = np.empty((a, b), dtype=np.int32)
    p2 = np.empty((b, a), dtype=np.int32)
    p3 = np.empty((a, b), dtype=np.int32)
    p1[src_row, color] = src_col
    p2[color, dst_row] = src_row
    p3[dst_row, dst_col] = color
    return ClosRoute(n=n, a=a, b=b, p1=p1, p2=p2, p3=p3)


@dataclasses.dataclass(frozen=True)
class ClosRouteDev:
    """A :class:`ClosRoute` on a device: ``p1`` [A, B], ``p2`` [B, A] and
    ``p3`` [A, B] int64 within-row gather indices."""

    n: int
    a: int
    b: int
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor

    def to(self, device) -> "ClosRouteDev":
        return dataclasses.replace(
            self, p1=self.p1.to(device), p2=self.p2.to(device),
            p3=self.p3.to(device),
        )


def device_route(route: ClosRoute, device) -> ClosRouteDev:
    """Put a host route's stage arrays on ``device`` (int64, see above)."""

    def put(p: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(p.astype(np.int64), device=device)

    return ClosRouteDev(n=route.n, a=route.a, b=route.b,
                        p1=put(route.p1), p2=put(route.p2), p3=put(route.p3))


def invert_route(route: ClosRoute, n: Optional[int] = None) -> ClosRoute:
    """The inverse permutation's route, from the same routing (host).

    ``(P1 . T . P2 . T . P3)^-1 = P3^-1 . T . P2^-1 . T . P1^-1``: the same
    three-stage form with each stage's rows inverted.  Every row is a
    permutation, so its inverse (what the reference takes as its
    ``argsort``) is one scatter of the column numbers.  ``n`` sets the
    unpadded length of the inverse (defaults to the forward's)."""

    def inv_rows(p: np.ndarray) -> np.ndarray:
        inv = np.empty_like(p)
        cols = np.broadcast_to(np.arange(p.shape[1], dtype=p.dtype), p.shape)
        np.put_along_axis(inv, p.astype(np.int64), cols, axis=1)
        return inv

    return ClosRoute(
        n=route.n if n is None else n, a=route.a, b=route.b,
        p1=inv_rows(route.p3), p2=inv_rows(route.p2), p3=inv_rows(route.p1),
    )


def apply_clos_grid(x: torch.Tensor, route: ClosRouteDev) -> torch.Tensor:
    """Apply a routed permutation to a full-grid flat tensor (``a * b``
    elements in and out): three row-local gathers, two transposes."""
    g = x.view(route.a, route.b)
    g = torch.gather(g, 1, route.p1)
    g = torch.gather(g.T.contiguous(), 1, route.p2)
    g = torch.gather(g.T.contiguous(), 1, route.p3)
    return g.view(-1)


def apply_clos(x: torch.Tensor, route: ClosRouteDev) -> torch.Tensor:
    """``x[perm]`` for the routed ``perm`` over a flat ``[route.n]`` tensor:
    zero-padded to the grid, permuted, cut back to ``route.n``."""
    if x.shape != (route.n,):
        raise ValueError(f"shape {tuple(x.shape)} != routed n ({route.n},)")
    total = route.a * route.b
    if total > route.n:
        x = torch.cat([x, x.new_zeros(total - route.n)])
    return apply_clos_grid(x, route)[:route.n]
