"""Fused sparse GLM value-and-gradient, and the fused route's row scatter.

:func:`fused_value_and_grad` is the counterpart of
``photon_tpu/ops/pallas_sparse.py`` (the Pallas kernel ``_kernel`` launched
by ``fused_value_and_grad``).  One pass over a padded COO batch computes the
margins, the weighted loss sum and the gradient scatter, without the L2 term
(callers add it analytically).  :func:`row_scatter` is the same scatter with
the per-row coefficient given, ``g[ids_ij] += r_i * vals_ij``: the ``X^T r``
of the ``fused`` route's Hessian-vector product, which the JAX package
leaves to an XLA scatter.  On a CUDA tensor each is a kernel of
``ops/csrc/fused_sparse.cu`` (one warp per row; hot features summed in
per-warp slices in shared memory, cold ones by atomics; a deterministic loss
sum); on a CPU tensor each is its plain version.  ``fused`` is the default
route of the port's objective on the card (``ops/sparse_grad_select.py``).
Both raise ``IndexError`` on an id outside ``[0, d)``.

Per ``ids`` tensor the wrapper keeps two things.  The hot set
(:func:`build_hot_set`), built on the device at the first call on the tensor
and again after it is changed in place.  And whether the kernel found every
id inside ``[0, d)``: the kernel flags bad ids, and the wrapper reads the
flag, and with it the hot set's size, in one host sync at the first call on
each tensor (an optimizer evaluates one batch many times).  Once the size
is known to be 0 the kernels launch in the form without the hot table.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Optional

import torch

from photon_tpu_torch.core.losses import PointwiseLoss
from photon_tpu_torch.data.batch import gather_dot, scatter_sum

Tensor = torch.Tensor

# Hot slots a block holds in shared memory (fused_sparse.cu kHot).
HOT_SLOTS = 1024
# A feature is hot when it holds at least 1/HOT_SHARE of the batch's
# entries.  On uniform ids over the headline d = 2^18 every feature holds
# about 1/d of them, a sixteenth of the threshold, so the set is empty: the
# table costs uniform ids time and saves them nothing.  On its zipf(1.3)
# draw 605 features pass (chip_smoke.py), and more slots cut K1's time there
# until the share reaches about 1/16384.
HOT_SHARE = 16384
# A block's 8 warps take a row each: the grid takes at most one block per 8
# rows.
_ROWS_PER_BLOCK = 8
_ROW_SCATTER = -1  # photon_fused_grid's code for the row scatter
# ids tensors whose every id the kernel has found inside [0, d):
# id(tensor) -> (weak reference, tensor version, d).
_CHECKED_IDS: dict[int, tuple[weakref.ref, int, int]] = {}
# id(tensor) -> (weak reference, tensor version, d, HotSet).
_HOT_SETS: dict[int, tuple] = {}
# (kernel code, hot form, device index) -> the most blocks the card holds.
_MAX_BLOCKS: dict[tuple[int, bool, int], int] = {}


def _ids_checked(ids: Tensor, d: int) -> bool:
    seen = _CHECKED_IDS.get(id(ids))
    return (seen is not None and seen[0]() is ids
            and seen[1:] == (ids._version, d))


def _mark_ids_checked(ids: Tensor, d: int) -> None:
    key = id(ids)
    ref = weakref.ref(ids, lambda _, key=key: _CHECKED_IDS.pop(key, None))
    _CHECKED_IDS[key] = (ref, ids._version, d)


def build_hot_set(ids: Tensor, vals: Tensor, d: int) -> Tensor:
    """The hot set of ``ids`` over ``d`` features, on their device and with
    no host sync: ``[HOT_SLOTS + 1]`` int32, the hot ids by count (largest
    first, the lower id first among equal counts), ``-1`` past the last,
    then their number.  Counted: the entries the kernels scatter, those
    with an id inside ``[0, d)`` and a non-zero value (so the pad slots, id
    0 and value 0, make no feature hot).  Hot: among the ``HOT_SLOTS`` most
    frequent ids, with at least ``ceil(ids.numel() / HOT_SHARE)`` entries
    (at least 1)."""
    flat = ids.reshape(-1).long()
    counted = (flat >= 0) & (flat < d) & (vals.reshape(-1) != 0)
    counts = torch.zeros(d + 1, dtype=torch.int32, device=ids.device)
    counts.index_add_(0, torch.where(counted, flat, d),
                      torch.ones_like(flat, dtype=torch.int32))
    top = torch.sort(counts[:d], descending=True, stable=True)
    h = min(HOT_SLOTS, d)
    threshold = max(1, -(-flat.numel() // HOT_SHARE))
    hot = top.values[:h] >= threshold
    out = torch.full((HOT_SLOTS + 1,), -1, dtype=torch.int32, device=ids.device)
    out[:h] = torch.where(hot, top.indices[:h], -1).int()
    out[HOT_SLOTS] = hot.sum()
    return out


@dataclasses.dataclass
class HotSet:
    ids: Tensor  # build_hot_set's [HOT_SLOTS + 1] int32
    n_hot: Optional[int] = None  # the host's copy of ids[HOT_SLOTS], once read


def hot_set(ids: Tensor, vals: Tensor, d: int) -> HotSet:
    """The cached hot set of ``ids`` over ``d`` features, built anew for a
    new ids tensor, another ``d`` or after an in-place change of the ids.
    A change of ``vals`` alone keeps the set: a stale set costs speed
    only."""
    key = id(ids)
    seen = _HOT_SETS.get(key)
    if seen is not None and seen[0]() is ids and seen[1:3] == (ids._version, d):
        return seen[3]
    hot = HotSet(build_hot_set(ids, vals, d))
    ref = weakref.ref(ids, lambda _, key=key: _HOT_SETS.pop(key, None))
    _HOT_SETS[key] = (ref, ids._version, d, hot)
    return hot


class _Launch:
    """What both kernels' launches share: the library, the hot set of the
    ids, the persistent grid and its scratch, the bad-id flag."""

    def __init__(self, name: str, kernel: int, ids: Tensor, vals: Tensor, d: int):
        from photon_tpu_torch.ops import _build

        self.lib = _build.load("fused_sparse")
        dev = ids.device
        self.name, self.ids, self.d = name, ids, d
        self.hot = hot_set(ids, vals, d)
        use_hot = self.hot.n_hot != 0  # unknown before the first read: take it
        key = (kernel, use_hot, dev.index)
        if key not in _MAX_BLOCKS:
            fn = self.lib.photon_fused_grid
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            blocks = ctypes.c_int(0)
            with torch.cuda.device(dev):
                _build.check(fn(kernel, int(use_hot), ctypes.byref(blocks)),
                             f"{name} grid")
            _MAX_BLOCKS[key] = blocks.value
        n = ids.shape[0]
        self.blocks = min(_MAX_BLOCKS[key], -(-n // _ROWS_PER_BLOCK))
        self.hot_ptr = self.hot.ids.data_ptr() if use_hot else None
        self.hot_partials = (
            torch.empty((self.blocks, HOT_SLOTS), dtype=torch.float64, device=dev)
            if use_hot else None
        )
        self.hot_partials_ptr = (None if self.hot_partials is None
                                 else self.hot_partials.data_ptr())
        self.bad_ids = torch.zeros((), dtype=torch.int32, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def finish(self) -> None:
        """At the first call on the ids: read the bad-id flag and the hot
        set's size in one sync; raise on a bad id."""
        if _ids_checked(self.ids, self.d) and self.hot.n_hot is not None:
            return
        bad, n_hot = torch.stack((self.bad_ids, self.hot.ids[HOT_SLOTS])).tolist()
        if bad:
            raise IndexError(f"{self.name}: ids outside [0, {self.d})")
        _mark_ids_checked(self.ids, self.d)
        self.hot.n_hot = n_hot


def fused_value_and_grad_plain(
    loss: PointwiseLoss, w: Tensor, ids: Tensor, vals: Tensor,
    label: Tensor, offset: Tensor, weight: Tensor,
) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of the fused kernel (same arithmetic)."""
    z = gather_dot(w, ids, vals) + offset
    value = torch.sum(weight * loss.value(z, label))
    coeff = weight * loss.d1(z, label)
    grad = torch.zeros_like(w)
    grad.index_add_(0, ids.reshape(-1), (coeff[:, None] * vals).reshape(-1))
    return value, grad


def fused_value_and_grad(
    loss: PointwiseLoss, w: Tensor, ids: Tensor, vals: Tensor,
    label: Tensor, offset: Tensor, weight: Tensor,
) -> tuple[Tensor, Tensor]:
    """``(sum_i weight_i * loss(margin_i, y_i), d/dw of the same)`` in one
    fused pass; rows with weight 0 contribute nothing.  Raises
    ``IndexError`` when an id lies outside ``[0, d)``."""
    n, k = ids.shape
    d = w.shape[0]
    if w.ndim != 1 or vals.shape != ids.shape or any(
        t.shape != (n,) for t in (label, offset, weight)
    ):
        raise ValueError("expected w [d], ids/vals [n, k], label/offset/weight [n]")
    floats = (w, vals, label, offset, weight)
    if ids.dtype != torch.int32 or any(t.dtype != torch.float32 for t in floats):
        raise TypeError("ids must be int32 and every other input float32")
    if any(t.device != ids.device for t in floats):
        raise ValueError("all inputs must share one device")
    if n == 0:
        return torch.zeros((), device=w.device), torch.zeros_like(w)
    if ids.device.type == "cpu":
        return fused_value_and_grad_plain(loss, w, ids, vals, label, offset, weight)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    if not all(t.is_contiguous() for t in (ids, *floats)):
        raise ValueError("the fused kernel takes contiguous tensors only")
    from photon_tpu_torch.ops import _build

    run = _Launch("fused_sparse", loss.code, ids, vals, d)
    fn = run.lib.photon_fused_value_grad
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5
    )
    fn.restype = ctypes.c_int
    grad = torch.zeros(d, dtype=torch.float32, device=w.device)
    partials = torch.empty(run.blocks, dtype=torch.float32, device=w.device)
    value = torch.empty((), dtype=torch.float32, device=w.device)
    fused_value_and_grad.launches += 1
    _build.check(
        fn(loss.code, w.data_ptr(), ids.data_ptr(), vals.data_ptr(),
           label.data_ptr(), offset.data_ptr(), weight.data_ptr(), n, k, d,
           grad.data_ptr(), partials.data_ptr(), run.blocks, value.data_ptr(),
           run.bad_ids.data_ptr(), run.hot_ptr, run.hot_partials_ptr, run.stream),
        "fused_sparse",
    )
    run.finish()
    return value, grad


fused_value_and_grad.launches = 0


def row_scatter_plain(per_row: Tensor, ids: Tensor, vals: Tensor, dim: int) -> Tensor:
    """Plain PyTorch version of the row scatter kernel:
    ``g[ids_ij] += per_row_i * vals_ij``, the unsorted row-major scatter,
    summed in float64 and rounded once (``scatter_sum``)."""
    return scatter_sum(ids.reshape(-1), (per_row[:, None] * vals).reshape(-1), dim)


def row_scatter(per_row: Tensor, ids: Tensor, vals: Tensor, dim: int) -> Tensor:
    """``g[f] = sum of per_row_i * vals_ij over ids_ij == f`` (``[dim]``
    float32, summed in float64 and rounded once).  Raises ``IndexError``
    when an id lies outside ``[0, dim)``."""
    n, k = ids.shape
    if vals.shape != ids.shape or per_row.shape != (n,):
        raise ValueError("expected ids/vals [n, k] and per_row [n]")
    if per_row.device != ids.device or vals.device != ids.device:
        raise ValueError("all inputs must share one device")
    if ids.device.type == "cpu":
        return row_scatter_plain(per_row, ids, vals, dim)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    if ids.dtype != torch.int32 or any(t.dtype != torch.float32 for t in (per_row, vals)):
        raise TypeError("ids must be int32 and per_row and vals float32")
    if not all(t.is_contiguous() for t in (per_row, ids, vals)):
        raise ValueError("the row scatter kernel takes contiguous tensors only")
    if n == 0 or k == 0:
        return torch.zeros(dim, dtype=torch.float32, device=ids.device)
    from photon_tpu_torch.ops import _build

    run = _Launch("row_scatter", _ROW_SCATTER, ids, vals, dim)
    fn = run.lib.photon_row_scatter
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    out64 = torch.zeros(dim, dtype=torch.float64, device=ids.device)
    out = torch.empty(dim, dtype=torch.float32, device=ids.device)
    row_scatter.launches += 1
    _build.check(
        fn(per_row.data_ptr(), ids.data_ptr(), vals.data_ptr(), n, k, dim,
           out64.data_ptr(), out.data_ptr(), run.blocks, run.bad_ids.data_ptr(),
           run.hot_ptr, run.hot_partials_ptr, run.stream),
        "row_scatter",
    )
    run.finish()
    return out


row_scatter.launches = 0
