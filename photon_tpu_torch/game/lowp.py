"""Low-precision storage codecs and per-codec parity bounds.

Counterpart of ``photon_tpu/game/lowp.py``: the ONE place the precision
tiers live — the storage dtypes (``f32 | bf16 | int8``), the host-side row
codecs, and the parity tolerances the serving canary and the tests assert
against.  Storage narrows; every multiply-accumulate stays float32.

int8 is symmetric per-row absmax quantization: beside each int8 row rides
one f32 scale (``absmax / 127``), and a decode is ``q * scale`` in f32.  An
all-zero row stores scale 0 and decodes to exactly 0, so the serving zero
row (the cold-entity fallback) survives quantization bit for bit.

bf16 goes through ``torch.bfloat16`` (the reference uses ``ml_dtypes``,
which the port does not depend on).  Both round to nearest even, so the
bits equal the reference's; numpy has no bf16 type, so the host form of a
bf16 array is its ``uint16`` bit pattern.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

TABLE_DTYPES = ("f32", "bf16", "int8")

# Serve-time parity bounds against the f32 host oracle (worst |delta| per
# request), per table dtype: the reference's measured bounds with ~4x
# headroom (bf16 lands ~1e-2 worst case, int8 ~3e-2 on unit-scale data).
PARITY_TOL = {"f32": 1e-3, "bf16": 5e-2, "int8": 2e-1}


def check_dtype(dtype) -> str:
    """Validate and normalize a table-dtype token (None -> ``"f32"``)."""
    if dtype is None:
        return "f32"
    dtype = str(dtype)
    if dtype not in TABLE_DTYPES:
        raise ValueError(
            f"unknown table dtype {dtype!r}; expected one of {TABLE_DTYPES}"
        )
    return dtype


def parity_tol_for(dtype) -> float:
    """The serve-time canary parity bound for one table dtype."""
    return PARITY_TOL[check_dtype(dtype)]


# -- int8 rows ----------------------------------------------------------------


def quantize_int8_table(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving table's int8 form on the table's own device: ``(q int8
    [rows, dim], scale f32 [rows])``, in float32 arithmetic exactly as the
    reference's device encoder (per-row absmax, ``torch.round`` half to
    even as ``jnp.round``, clipped to +-127)."""
    table = table.to(torch.float32)
    absmax = table.abs().amax(dim=-1)
    scale = absmax / 127.0
    divisor = torch.where(absmax > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(table / divisor[:, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def quantize_int8_rows(arr) -> Tuple[np.ndarray, np.ndarray]:
    """Host codec: symmetric per-row absmax int8, ``(q int8 of arr.shape,
    scale f32 of arr.shape[:-1])``.  The scale arithmetic runs in float64,
    so ``absmax / 127`` rounds to f32 once; rows of absmax 0 store scale 0
    and decode to exactly 0."""
    x = np.asarray(arr, np.float32)
    x64 = x.astype(np.float64)
    absmax = np.max(np.abs(x64), axis=-1)
    scale = (absmax / 127.0).astype(np.float32)
    div = np.where(absmax > 0.0, absmax / 127.0, 1.0)
    q = np.clip(
        np.rint(x64 / div[..., None]), -127.0, 127.0
    ).astype(np.int8)
    return q, scale


def dequantize_int8_rows(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """f32 decode of :func:`quantize_int8_rows` output: ``q * scale``."""
    return np.asarray(q, np.float32) * np.asarray(
        scale, np.float32
    )[..., None]


def quantize_int8_canonical(
    arr, max_rounds: int = 4
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """``(q, scale, converged)`` at a quantization fixed point: re-encoding
    the decoded array reproduces the same bytes.  Only the stored scale can
    move (by one ulp) through the decode -> absmax -> scale cycle, and
    iterating lands it; a non-converging array returns ``converged=False``."""
    q, scale = quantize_int8_rows(arr)
    for _ in range(max_rounds):
        q2, scale2 = quantize_int8_rows(dequantize_int8_rows(q, scale))
        if (q2.tobytes() == q.tobytes()
                and scale2.tobytes() == scale.tobytes()):
            return q2, scale2, True
        q, scale = q2, scale2
    return q, scale, False


# -- bf16 ---------------------------------------------------------------------


def encode_bf16(arr) -> np.ndarray:
    """bf16 storage form of a float array as its ``uint16`` bit pattern
    (round to nearest even; a bf16 -> f32 -> bf16 round trip is exact)."""
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def decode_bf16(raw: np.ndarray) -> np.ndarray:
    """f32 decode of :func:`encode_bf16` output (exact widening)."""
    bits = torch.from_numpy(np.ascontiguousarray(raw, np.uint16).view(np.int16))
    return bits.view(torch.bfloat16).to(torch.float32).numpy()
