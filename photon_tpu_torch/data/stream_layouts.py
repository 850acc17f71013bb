"""Fast-route layouts for streamed chunks, built once per file and cached.

Counterpart of ``photon_tpu/data/stream_layouts.py``.  The streamed fit
(``data/streaming.py``) re-parses every part file on every objective
evaluation, so a layout or exchange route built per pass would cost far more
host time than the parse.  But a chunk's layout and route are functions of
its FILE alone, the same on every pass, so they are built on first touch,
saved, and re-attached to each freshly parsed chunk at the cost of one
``stat`` and one ``npz`` load:

- **Cache key = file identity (abspath, size, mtime) + parse parameters**
  (feature dimension, row capacity, route, reduce mode), not content: a
  rewritten file misses and rebuilds.
- **Pow2-bucketed geometry**: each file's aligned layout pads its slabs and
  tiles up to powers of two and its balanced route's block census up to a
  power of two, so the chunks of equal shape (every full part file of a
  dataset) share one geometry; the short last file takes its own bucket.
- **No value baking**: a streamed chunk is evaluated once per pass, so
  permuting its values into destination order would cost an exchange per
  evaluation instead of amortizing; the route moves the product stream.

Select with ``PHOTON_STREAM_KERNEL=autodiff|fm|pallas|xchg`` (default: a
forced ``PHOTON_SPARSE_GRAD`` among ``fm|pallas|xchg``, else ``autodiff``).
``xchg`` follows ``PHOTON_XCHG_REDUCE`` as the resident attach does.

The cache lives under ``<root>/torch/`` of the stream-layout root
(``utils/caches.resolve_cache_dir("PHOTON_STREAM_LAYOUT_CACHE", "stream")``;
``PHOTON_STREAM_LAYOUT_CACHE=0`` or ``PHOTON_ROUTE_CACHE=0`` disables it), a
directory of its own: the JAX package never loads a layout or route built
for the port, nor the port one built for the JAX package.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Optional

import numpy as np

from photon_tpu_torch.data.batch import SparseBatch

_VERSION = 1
_LOG = logging.getLogger("photon_tpu_torch.stream_layouts")

_KERNELS = ("autodiff", "fm", "pallas", "xchg")
# Layout builds (cache misses, with their host seconds) and cache loads since
# the process started; chunks load on several threads, hence the lock.
build_stats = {"builds": 0, "seconds": 0.0, "loads": 0}
_STATS_LOCK = threading.Lock()


def _count(key: str, amount=1) -> None:
    with _STATS_LOCK:
        build_stats[key] += amount


def stream_kernel() -> str:
    """The route streamed chunks carry layouts for: ``PHOTON_STREAM_KERNEL``,
    else a forced ``PHOTON_SPARSE_GRAD`` among ``fm|pallas|xchg``, else
    ``autodiff``.  The layouts only make a chunk eligible; under
    ``PHOTON_SPARSE_GRAD=auto`` the measured selection still arbitrates."""
    k = os.environ.get("PHOTON_STREAM_KERNEL")
    if k is None:
        forced = os.environ.get("PHOTON_SPARSE_GRAD", "auto")
        k = forced if forced in ("fm", "pallas", "xchg") else "autodiff"
    if k not in _KERNELS:
        raise ValueError(f"PHOTON_STREAM_KERNEL={k!r}; valid: {'|'.join(_KERNELS)}")
    return k


def stream_kernel_why(kernel: str) -> str:
    """One line of provenance for the driver's summary."""
    if kernel == "autodiff":
        return ("default: streamed passes are bound by the host parse; set "
                "PHOTON_STREAM_KERNEL (or force PHOTON_SPARSE_GRAD) to attach "
                "cached fast-route layouts per chunk")
    return (f"PHOTON_STREAM_KERNEL={kernel}: per-file layouts and routes built "
            "once and cached (pow2-bucketed geometry), re-attached per pass at "
            "stat + load cost")


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _cache_root() -> Optional[str]:
    from photon_tpu_torch.utils.caches import resolve_cache_dir

    root = resolve_cache_dir("PHOTON_STREAM_LAYOUT_CACHE", "stream")
    return None if root is None else os.path.join(root, "torch")


def _aux_cache_path(file_path: str, dim: int, kernel: str, mode: str,
                    capacity: int) -> Optional[str]:
    root = _cache_root()
    if root is None:
        return None
    try:
        st = os.stat(file_path)
    except OSError:
        return None
    ident = (os.path.abspath(file_path), st.st_size, int(st.st_mtime_ns))
    h = hashlib.sha256()
    h.update(repr(ident).encode())
    h.update(f"|{dim}|{capacity}|{kernel}|{mode}|v{_VERSION}".encode())
    return os.path.join(root, "aux_" + h.hexdigest()[:32] + ".npz")


def _needs_layout(kernel: str, mode: str) -> bool:
    return kernel == "pallas" or (kernel == "xchg" and mode == "aligned")


def _build_padded_layout(ids_np: np.ndarray, vals_np: np.ndarray, dim: int):
    """The gradient layout padded to pow2 (slabs, tiles)."""
    from photon_tpu_torch.ops.slab_reduce import build_aligned_layout, pad_aligned_layout

    lay = build_aligned_layout(ids_np, vals_np, dim)
    s2 = _pow2(lay.n_slabs)
    t2 = _pow2(lay.n_tiles + (s2 - lay.n_slabs))
    return pad_aligned_layout(lay, s2, t2)


def _build_aux(ids_np: np.ndarray, vals_np: np.ndarray, dim: int, kernel: str,
               mode: str):
    """``(layout | None, XchgAux | None)`` with pow2-bucketed geometry, host
    side (CPU tensors).  Calls the route builders directly with an explicit
    mode, so no environment is read or written on the (threaded) chunk
    load path."""
    from photon_tpu_torch.ops.vperm import (
        XchgAux,
        balanced_blk_census,
        build_balanced_aligned_route,
        build_balanced_sorted_route,
        build_xchg_route,
        build_xchg_sorted_route,
    )

    layout = (_build_padded_layout(ids_np, vals_np, dim)
              if _needs_layout(kernel, mode) else None)
    if kernel == "pallas":
        return layout, None
    n, k = ids_np.shape
    e = ids_np.size
    flat = ids_np.reshape(-1).astype(np.int64)
    if mode == "cumsum":
        order = np.argsort(flat, kind="stable")
        census = balanced_blk_census(order, e, k)
        built = (build_balanced_sorted_route(ids_np, dim, order,
                                             blk_override=_pow2(census), device="cpu")
                 if census is not None else None)
        if built is not None:
            return layout, XchgAux(route=built[0], bounds=built[1])
        return layout, build_xchg_sorted_route(ids_np, dim, order=order, device="cpu")
    census = balanced_blk_census(layout.src.reshape(-1), e, k)
    built = (build_balanced_aligned_route(layout, ids_np, device="cpu",
                                          blk_override=_pow2(census))
             if census is not None else None)
    if built is not None:
        return layout, XchgAux(route=built)
    return layout, XchgAux(route=build_xchg_route(layout, n, k, device="cpu"))


_LAYOUT_FIELDS = ("lo", "vals", "rows", "slab_of_tile", "dup_map")


def _save_aux(path: str, layout, aux) -> None:
    """Best-effort atomic write of the cache file (a failure only logs)."""
    from photon_tpu_torch.ops.vperm import _aux_to_npz

    out = {}
    if layout is not None:
        for name in _LAYOUT_FIELDS:
            out["lay_" + name] = np.asarray(getattr(layout, name))
        out["lay_n_entries"] = np.int64(layout.n_entries)
    if aux is not None:
        for key, val in _aux_to_npz(aux).items():
            out["aux_" + key] = val
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + f".tmp{os.getpid()}.{id(out) & 0xffff:x}"
        with open(tmp, "wb") as f:
            np.savez(f, **out)
        os.replace(tmp, path)
    except Exception as exc:  # noqa: BLE001 — a cache write is best effort
        _LOG.warning("stream layout cache write failed (%s)", exc)


def _load_aux(path: str):
    """``(layout | None, XchgAux | None)`` from a cache file (host side), or
    None on any read failure (the caller rebuilds)."""
    from photon_tpu_torch.ops.slab_reduce import AlignedLayout
    from photon_tpu_torch.ops.vperm import _aux_from_npz

    try:
        with np.load(path) as z:
            layout = None
            if "lay_lo" in z:
                lo = z["lay_lo"]
                layout = AlignedLayout(
                    **{name: z["lay_" + name] for name in _LAYOUT_FIELDS},
                    # The slot sources serve the route build only.
                    src=np.full(lo.shape, -1, np.int64),
                    n_entries=int(z["lay_n_entries"]),
                )
            aux = None
            if "aux_kind" in z:
                aux = _aux_from_npz(
                    {key[4:]: z[key] for key in z.files if key.startswith("aux_")},
                    device="cpu",
                )
            return layout, aux
    except Exception as exc:  # noqa: BLE001 — a corrupt cache file rebuilds
        _LOG.warning("stream layout cache read failed (%s); rebuilding", exc)
        return None


def attach_stream_aux(batch: SparseBatch, dim: int, file_path: str) -> SparseBatch:
    """Attach the ``PHOTON_STREAM_KERNEL`` layouts to a freshly parsed host
    chunk (CPU tensors), building them on first touch and loading them from
    the stream cache afterwards; the caller moves the chunk to its device.
    The chunk then reaches the fast routes through the ordinary selection
    (``core/objective.GlmObjective._sparse_kernel``)."""
    kernel = stream_kernel()
    if kernel == "autodiff" or not (
        isinstance(batch, SparseBatch) and batch.ids.ndim == 2
    ):
        return batch
    if batch.device.type != "cpu":
        raise ValueError("attach_stream_aux takes a host chunk (CPU tensors)")
    from photon_tpu_torch.data.batch import attach_feature_major

    if kernel == "fm":
        # One argsort, cheap beside the parse: rebuilt every pass.
        return attach_feature_major(batch)
    from photon_tpu_torch.ops.vperm import xchg_reduce_mode

    mode = xchg_reduce_mode() if kernel == "xchg" else "aligned"
    path = _aux_cache_path(file_path, dim, kernel, mode, int(batch.ids.shape[1]))
    layout = aux = None
    if path is not None and os.path.exists(path):
        loaded = _load_aux(path)
        if loaded is not None:
            layout, aux = loaded
            _count("loads")
    if layout is None and aux is None:
        ids_np = batch.ids.numpy()
        vals_np = batch.vals.numpy().astype(np.float32, copy=False)
        _LOG.warning(
            "building the %s stream layout for %s (%d entries, mode=%s): "
            "one-time host work, cached for every later pass%s",
            kernel, os.path.basename(file_path), ids_np.size, mode,
            "" if path is not None else
            " (caching disabled by PHOTON_STREAM_LAYOUT_CACHE=0)",
        )
        t0 = time.monotonic()
        layout, aux = _build_aux(ids_np, vals_np, dim, kernel, mode)
        _count("builds")
        _count("seconds", time.monotonic() - t0)
        if path is not None:
            _save_aux(path, layout, aux)
    if layout is not None:
        from photon_tpu_torch.ops.slab_reduce import device_layout

        batch = batch._replace(al=device_layout(layout, "cpu"))
    if aux is not None:
        batch = batch._replace(xchg=aux)
    return batch
