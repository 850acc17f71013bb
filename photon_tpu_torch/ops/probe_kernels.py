"""The primitive probes' kernels: data movement at the building blocks of a
static permutation.

Counterpart of the Pallas kernel bodies of ``tools/probe_permute.py``,
``tools/probe_tiles.py`` and ``tools/probe_blocklocal.py`` (the JAX
package's probe tools).  Seven kernels in ``ops/csrc/probes.cu``, each
behind a wrapper here with a launch counter (``<wrapper>.launches``) and a
plain PyTorch version:

- PK1 :func:`window_gather` — ``out[f] = x[w0 + (idx[f] & (W - 1))]`` within
  windows of ``W`` consecutive elements (the rows of 128 lanes, or the
  2048-wide windows of a transposed view);
- PK2 :func:`lane_swap` — the reversal of each row's four 32-lane blocks
  that the Pallas "swap stage" computes, optionally masked;
- PK3 :func:`copy_scale` — ``x * 1.0000001``, over tiles of ``h`` rows;
- PK4 :func:`tile_transpose` — ``[CH, 128]`` tiles to ``[128, CH]``;
- PK5 :func:`fused_chunk` — the fused 5-stage chunk permutation, in the
  form :func:`fused_chunk_form` picks from the shape;
- PK6 :func:`sublane_gather` — a gather along the rows of ``[8, 128]``
  groups;
- PK7 :func:`lane_repeat` — each element repeated ``k`` times along the
  lanes.

A CUDA tensor launches the kernel (building ``probes.cu`` at the first
use) or raises; a CPU tensor takes the plain version.  Every kernel equals
its plain version bit for bit: they move data, and PK3 is one rounded f32
multiply.  Indices are masked to their window (PK1, PK5, PK6) in both, so
no input reads outside its array.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

Tensor = torch.Tensor

LANES = 128
# PK3's factor: the float32 nearest 1.0000001 (1 + 2^-23), exact as a float.
SCALE = float(np.float32(1.0000001))
MAX_WINDOW = 2048  # PK1's shared-memory stage: a block's whole windows
SMEM_BLOCK = 232_448  # shared memory a block may use on sm_90 (227 KB)


def _on_card(*ts: Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for contiguous
    CUDA tensors on one device; raises otherwise."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all inputs must share one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the probe kernels take contiguous tensors only")
    return True


def _entry(name: str, argtypes: list):
    """``photon_probe_<name>`` of the loaded library (built at the first
    use), its argument types set at its first call only."""
    from photon_tpu_torch.ops import _build

    fn = getattr(_build.load("probes"), f"photon_probe_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, argtypes: list, x: Tensor, *args) -> None:
    """Launch ``photon_probe_<name>(*args, stream)`` on the current stream
    of ``x``'s device."""
    from photon_tpu_torch.ops import _build

    fn = _entry(name, argtypes + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(*args, stream), f"probes.{name}")


def _check(t: Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def _aligned(*ts: Tensor) -> None:
    """The float4/int4 kernels (PK2, PK3, PK5; PK7's output) read and write
    16 bytes a lane."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the kernel takes 16-byte aligned tensors only")


def _rows128(x: Tensor, what: str = "x") -> int:
    if x.ndim != 2 or x.shape[1] != LANES:
        raise ValueError(f"{what} must be [rows, {LANES}], got {tuple(x.shape)}")
    return int(x.shape[0])


# -- PK1 ------------------------------------------------------------------------

def window_gather_plain(x: Tensor, idx: Tensor, window: int) -> Tensor:
    """Plain PyTorch PK1."""
    xw = x.reshape(-1, window)
    iw = (idx.reshape(-1, window) & (window - 1)).long()
    return torch.gather(xw, 1, iw).view(x.shape)


def window_gather(x: Tensor, idx: Tensor, window: int) -> Tensor:
    """PK1: ``out = take_along(x, idx)`` within each window of ``window``
    consecutive elements of the row-major ``x`` (float32) by ``idx`` (int32,
    same shape, masked to the window).  ``window`` is a power of two up to
    2048 that divides the last dimension of ``x``: 128 for a lane gather
    within rows of 128, 2048 for the windows of a ``[128, E / 128]`` view."""
    if idx.shape != x.shape or x.ndim < 1:
        raise ValueError(f"x and idx must share one shape, got {tuple(x.shape)} "
                         f"and {tuple(idx.shape)}")
    if not _pow2(window) or window > MAX_WINDOW or x.shape[-1] % window:
        raise ValueError(f"window {window} must be a power of two <= {MAX_WINDOW} "
                         f"dividing the last dimension {x.shape[-1]}")
    _check(x, torch.float32, "x")
    _check(idx, torch.int32, "idx")
    if not _on_card(x, idx):
        return window_gather_plain(x, idx, window)
    out = torch.empty_like(x)
    window_gather.launches += 1
    _launch("window_gather",
            [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int],
            x, x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.numel(), window)
    return out


window_gather.launches = 0


# -- PK2 ------------------------------------------------------------------------

def lane_swap_plain(x: Tensor, mask: Tensor | None = None, h: int = 512) -> Tensor:
    """Plain PyTorch PK2 (``h``, the reference's tile height, changes
    nothing).  The Pallas swap stage (``pltpu.roll`` by 32 and by 96,
    selected by ``(lane // 32) % 2``) takes each output lane from the
    mirrored 32-lane block."""
    lane = torch.arange(LANES, device=x.device)
    swapped = x.index_select(1, (3 - lane // 32) * 32 + lane % 32)
    return swapped if mask is None else torch.where(mask > 0, swapped, x)


def lane_swap(x: Tensor, mask: Tensor | None = None, h: int = 512) -> Tensor:
    """PK2: each row of ``x`` (``[rows, 128]`` float32) with its four 32-lane
    blocks reversed, ``out[r, l] = x[r, (3 - l // 32) * 32 + l % 32]``; with
    ``mask`` (float32, same shape), only where ``mask > 0``, else ``x``.
    ``h``, the tile height of the reference, is validated only: a block
    takes 8 rows, so the launch is the same at every ``h``."""
    rows = _rows128(x)
    if not 1 <= h < 2 ** 31:
        raise ValueError(f"h must be a positive int32, got {h}")
    _check(x, torch.float32, "x")
    ts = (x,)
    if mask is not None:
        if mask.shape != x.shape:
            raise ValueError("mask must have the shape of x")
        _check(mask, torch.float32, "mask")
        ts = (x, mask)
    if not _on_card(*ts):
        return lane_swap_plain(x, mask, h)
    out = torch.empty_like(x)
    _aligned(*ts, out)
    lane_swap.launches += 1
    _launch("lane_swap",
            [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int],
            x, x.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), rows, h)
    return out


lane_swap.launches = 0


# -- PK3 ------------------------------------------------------------------------

def copy_scale_plain(x: Tensor, h: int = 512) -> Tensor:
    """Plain PyTorch PK3 (``h`` only cuts the kernel's work into tiles)."""
    return x * SCALE


def copy_scale(x: Tensor, h: int = 512) -> Tensor:
    """PK3: ``x * 1.0000001`` (float32 ``[rows, 128]``).  ``h``, the tile
    height of the reference, is validated only: a block takes 8 rows, so
    the launch is the same at every ``h`` and fills the card."""
    rows = _rows128(x)
    if not 1 <= h < 2 ** 31:
        raise ValueError(f"h must be a positive int32, got {h}")
    _check(x, torch.float32, "x")
    if not _on_card(x):
        return copy_scale_plain(x, h)
    out = torch.empty_like(x)
    _aligned(x, out)
    copy_scale.launches += 1
    _launch("copy_scale",
            [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int],
            x, x.data_ptr(), out.data_ptr(), rows, h)
    return out


copy_scale.launches = 0


# -- PK4 ------------------------------------------------------------------------

def tile_transpose_plain(x: Tensor, ch: int) -> Tensor:
    """Plain PyTorch PK4."""
    n_tiles = x.shape[0] // ch
    return x.view(n_tiles, ch, LANES).permute(0, 2, 1).reshape(n_tiles * LANES, ch)


def tile_transpose(x: Tensor, ch: int) -> Tensor:
    """PK4: each ``[ch, 128]`` tile of ``x`` (``[n_tiles * ch, 128]``
    float32) transposed, ``out[t * 128 + l, r] = x[t * ch + r, l]``
    (``[n_tiles * 128, ch]``); ``ch`` a multiple of 32."""
    rows = _rows128(x)
    if ch < 32 or ch % 32 or rows % ch:
        raise ValueError(f"ch {ch} must be a multiple of 32 dividing {rows} rows")
    _check(x, torch.float32, "x")
    if not _on_card(x):
        return tile_transpose_plain(x, ch)
    n_tiles = rows // ch
    out = torch.empty(n_tiles * LANES, ch, dtype=torch.float32, device=x.device)
    tile_transpose.launches += 1
    _launch("tile_transpose",
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2,
            x, x.data_ptr(), out.data_ptr(), n_tiles, ch)
    return out


tile_transpose.launches = 0


# -- PK5 ------------------------------------------------------------------------

GROUP_ROWS = 64  # the block form takes whole chunks, at least this many rows a block
FUSED_CLUSTERS = (2, 4, 8, 16)  # 16 is a non-portable cluster size
FUSED_PASSES = (1, 2, 4, 8)
# Two blocks an SM: each may use half of the SM's 233,472 bytes less the
# 1 KB the card reserves per block.
SMEM_HALF_SM = (233_472 - 2 * 1024) // 2
TILE_ROWS, TILE_PITCH = 32, LANES + 4  # the cluster form's stage-1 tile


def fused_block_smem(ch: int, g: int) -> int:
    """Shared memory of PK5's block form at ``g`` chunks of ``ch`` rows a
    block: their y1 rows (f32) and i2 tiles (int16, pitch ``ch + 2``);
    ``fused_block_smem`` in ``csrc/probes.cu``."""
    return g * ch * LANES * 4 + g * LANES * (ch + 2) * 2


def fused_cluster_smem(ch: int, cl: int, passes: int) -> int:
    """Shared memory of a block of PK5's cluster form: A, its ``128 / cl``
    columns over the chunk's ``ch`` rows (f32), and B, ``128 x pitch`` f32
    for one pass of ``ch / cl / passes`` rows (the pitch rounded up to 32),
    which also holds the 32-row stage-1 tile; ``fused_cluster_smem`` in
    ``csrc/probes.cu``."""
    rpp = ch // cl // passes
    pitch = -(-rpp // 32) * 32
    return 4 * (LANES // cl * ch + max(LANES * pitch, TILE_ROWS * TILE_PITCH))


def _cluster_fits(ch: int, cl: int, passes: int, budget: int) -> bool:
    return (ch % (cl * TILE_ROWS) == 0 and (ch // cl) % (passes * 4) == 0
            and fused_cluster_smem(ch, cl, passes) <= budget)


def fused_chunk_form(nc: int, ch: int) -> tuple[str, int, int]:
    """The shape rule of PK5: ``(form, arg, passes)``.

    - ``("block", g, 1)`` where one block holds whole chunks (``ch <=
      256``): ``g`` chunks a block, at least :data:`GROUP_ROWS` rows;
    - ``("cluster", cl, passes)`` where a cluster of ``cl`` blocks holds a
      chunk: first the smallest cluster whose blocks fit two to an SM (the
      fewest passes at that size), else the smallest that fits at all;
    - ``("global", 0, 0)``, one thread an element, where no cluster holds
      the chunk (``ch >= 8192``).

    ``ch`` is a power of two.  Raises on a shape that no form takes."""
    if nc < 1 or ch < 1 or ch & (ch - 1) or ch > 1 << 24:
        raise ValueError(f"no PK5 form takes nc={nc}, ch={ch} "
                         "(ch a power of two up to 2^24, nc >= 1)")
    g = max(1, GROUP_ROWS // ch)
    if fused_block_smem(ch, g) <= SMEM_BLOCK:
        return ("block", g, 1)
    for budget in (SMEM_HALF_SM, SMEM_BLOCK):
        for cl in FUSED_CLUSTERS:
            for passes in FUSED_PASSES:
                if _cluster_fits(ch, cl, passes, budget):
                    return ("cluster", cl, passes)
    return ("global", 0, 0)


def fused_chunk_clusters(ch: int, cl: int, passes: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of PK5's cluster form: how many
    clusters of ``cl`` blocks at chunk height ``ch`` the card runs at once
    (needs the card)."""
    from photon_tpu_torch.ops import _build

    n = _entry("fused_chunk_clusters", [ctypes.c_int] * 3)(ch, cl, passes)
    if n < 0:
        _build.check(-n, "probes.fused_chunk_clusters")
    return n


def fused_chunk_source(i1: Tensor, i2: Tensor, i3: Tensor, ch: int) -> Tensor:
    """The flat source index of each output element of PK5 (int64,
    ``[n_tiles * ch, 128]``): ``c = i3[r, l]``, ``r2 = i2[t * 128 + c, r]``,
    source ``(t * ch + r2, i1[t * ch + r2, c])`` for row ``r`` of chunk
    ``t``, each index masked to its range."""
    rows = i1.shape[0]
    row = torch.arange(rows, device=i1.device)[:, None]
    chunk = row // ch
    c = (i3 & (LANES - 1)).long()
    r2 = (i2.reshape(-1)[(chunk * LANES + c) * ch + (row - chunk * ch)]
          & (ch - 1)).long()
    src_row = chunk * ch + r2
    lane = (i1.reshape(-1)[src_row * LANES + c] & (LANES - 1)).long()
    return src_row * LANES + lane


def fused_chunk_plain(x: Tensor, i1: Tensor, i2: Tensor, i3: Tensor,
                      ch: int) -> Tensor:
    """Plain PyTorch PK5: the composed source index, then one gather."""
    return x.reshape(-1)[fused_chunk_source(i1, i2, i3, ch)]


_FORM_CODES = {"global": 0, "block": 1, "cluster": 2}


def fused_chunk(x: Tensor, i1: Tensor, i2: Tensor, i3: Tensor, ch: int) -> Tensor:
    """PK5: the Pallas body's three gathers and two transposes within each
    ``[ch, 128]`` chunk, composed: ``out[r, l] = x[r2, i1[r2, c]]`` with
    ``c = i3[r, l]`` and ``r2 = i2[t * 128 + c, r]`` (chunk-local rows).
    ``x``, ``i1``, ``i3``: ``[n_tiles * ch, 128]``; ``i2``: ``[n_tiles *
    128, ch]`` (the transposed view, one tile a chunk); int32 indices;
    ``ch`` a power of two.  Launches the form :func:`fused_chunk_form`
    picks, counted in ``fused_chunk.form_launches``."""
    rows = _rows128(x)
    if not _pow2(ch) or rows % ch:
        raise ValueError(f"ch {ch} must be a power of two dividing {rows} rows")
    if i1.shape != x.shape or i3.shape != x.shape or (
            i2.shape != (rows // ch * LANES, ch)):
        raise ValueError(
            f"expected i1/i3 {tuple(x.shape)} and i2 [{rows // ch * LANES}, {ch}]; "
            f"got {tuple(i1.shape)}, {tuple(i3.shape)}, {tuple(i2.shape)}")
    _check(x, torch.float32, "x")
    for name, t in (("i1", i1), ("i2", i2), ("i3", i3)):
        _check(t, torch.int32, name)
    if not _on_card(x, i1, i2, i3):
        return fused_chunk_plain(x, i1, i2, i3, ch)
    nc = rows // ch
    form, arg, passes = fused_chunk_form(nc, ch)
    out = torch.empty_like(x)
    _aligned(x, i1, i2, i3, out)
    fused_chunk.launches += 1
    fused_chunk.form_launches[form] += 1
    _launch("fused_chunk",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5,
            x, x.data_ptr(), i1.data_ptr(), i2.data_ptr(), i3.data_ptr(),
            out.data_ptr(), nc, ch, _FORM_CODES[form], arg, passes)
    return out


fused_chunk.launches = 0
fused_chunk.form_launches = {"block": 0, "cluster": 0, "global": 0}


# -- PK6 ------------------------------------------------------------------------

def sublane_gather_plain(x: Tensor, idx: Tensor) -> Tensor:
    """Plain PyTorch PK6."""
    g = x.view(-1, 8, LANES)
    return torch.take_along_dim(g, (idx.view(-1, 8, LANES) & 7).long(), dim=1).view(
        x.shape)


def sublane_gather(x: Tensor, idx: Tensor) -> Tensor:
    """PK6: ``out[8g + s, l] = x[8g + idx[8g + s, l], l]`` over ``[rows,
    128]`` float32 ``x`` and int32 ``idx`` in ``[0, 8)``; rows a multiple
    of 8."""
    rows = _rows128(x)
    if rows % 8 or idx.shape != x.shape:
        raise ValueError("x and idx must be [8 * groups, 128]")
    _check(x, torch.float32, "x")
    _check(idx, torch.int32, "idx")
    if not _on_card(x, idx):
        return sublane_gather_plain(x, idx)
    out = torch.empty_like(x)
    sublane_gather.launches += 1
    _launch("sublane_gather",
            [ctypes.c_void_p] * 3 + [ctypes.c_int64],
            x, x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows)
    return out


sublane_gather.launches = 0


# -- PK7 ------------------------------------------------------------------------

def lane_repeat_plain(x: Tensor, k: int) -> Tensor:
    """Plain PyTorch PK7."""
    return x.index_select(1, torch.arange(LANES, device=x.device) // k)


def lane_repeat(x: Tensor, k: int) -> Tensor:
    """PK7: ``out[r, l] = x[r, l // k]``, ``[rows, 128 / k]`` float32 to
    ``[rows, 128]``; ``k`` a power of two dividing 128.  The kernel reads
    ``x`` by 4-byte loads (any float32 view) and stores ``out``, its own
    allocation, 16 bytes at a time."""
    if not _pow2(k) or k > LANES:
        raise ValueError(f"k {k} must be a power of two dividing {LANES}")
    if x.ndim != 2 or x.shape[1] != LANES // k:
        raise ValueError(f"x must be [rows, {LANES // k}], got {tuple(x.shape)}")
    _check(x, torch.float32, "x")
    if not _on_card(x):
        return lane_repeat_plain(x, k)
    rows = int(x.shape[0])
    out = torch.empty(rows, LANES, dtype=torch.float32, device=x.device)
    _aligned(out)
    lane_repeat.launches += 1
    _launch("lane_repeat",
            [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int],
            x, x.data_ptr(), out.data_ptr(), rows, k)
    return out


lane_repeat.launches = 0

KERNELS = (window_gather, lane_swap, copy_scale, tile_transpose, fused_chunk,
           sublane_gather, lane_repeat)
