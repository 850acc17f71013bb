"""Fused sparse GLM value-and-gradient.

Counterpart of ``photon_tpu/ops/pallas_sparse.py`` (the Pallas kernel
``_kernel`` launched by ``fused_value_and_grad``).  One pass over a padded
COO batch computes the margins, the weighted loss sum and the gradient
scatter, without the L2 term (callers add it analytically).  On a CUDA
tensor this is the ``fused_sparse`` kernel (``ops/csrc/fused_sparse.cu``,
one warp per row, float atomics into the gradient, a deterministic two-pass
loss sum); on a CPU tensor it is :func:`fused_value_and_grad_plain`.  It is
the default route of the port's objective on the card
(``ops/sparse_grad_select.py``).  Both raise ``IndexError`` on an id outside
``[0, d)``.  On the card the kernel flags such ids and the wrapper reads
the flag, a host sync, only at the first call on each ``ids`` tensor (and
again after the tensor is changed in place): an optimizer evaluates one
batch many times.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from photon_tpu_torch.core.losses import PointwiseLoss
from photon_tpu_torch.data.batch import gather_dot

Tensor = torch.Tensor

# Scratch for the per-block loss partials; also the kernel's grid cap.
_PARTIALS = 4096
# ids tensors whose every id the kernel has found inside [0, d):
# id(tensor) -> (weak reference, tensor version, d).
_CHECKED_IDS: dict[int, tuple[weakref.ref, int, int]] = {}


def _ids_checked(ids: Tensor, d: int) -> bool:
    seen = _CHECKED_IDS.get(id(ids))
    return (seen is not None and seen[0]() is ids
            and seen[1:] == (ids._version, d))


def _mark_ids_checked(ids: Tensor, d: int) -> None:
    key = id(ids)
    ref = weakref.ref(ids, lambda _, key=key: _CHECKED_IDS.pop(key, None))
    _CHECKED_IDS[key] = (ref, ids._version, d)


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

    lib = _build.load("fused_sparse")
    fn = lib.photon_fused_value_grad
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    )
    fn.restype = ctypes.c_int
    grad = torch.zeros(d, dtype=torch.float32, device=w.device)
    partials = torch.empty(_PARTIALS, dtype=torch.float32, device=w.device)
    value = torch.empty((), dtype=torch.float32, device=w.device)
    bad_ids = torch.zeros((), dtype=torch.int32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    fused_value_and_grad.launches += 1
    _build.check(
        fn(loss.code, w.data_ptr(), ids.data_ptr(), vals.data_ptr(),
           label.data_ptr(), offset.data_ptr(), weight.data_ptr(), n, k, d,
           grad.data_ptr(), partials.data_ptr(), _PARTIALS, value.data_ptr(),
           bad_ids.data_ptr(), stream),
        "fused_sparse",
    )
    if not _ids_checked(ids, d):
        if bad_ids.item():
            raise IndexError(f"fused_sparse: ids outside [0, {d})")
        _mark_ids_checked(ids, d)
    return value, grad


fused_value_and_grad.launches = 0
