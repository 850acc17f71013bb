"""Slab-aligned sparse reduction: host layout builders, the position-reduce
kernel and the slab gather kernel.

Counterpart of ``photon_tpu/ops/pallas_gather.py`` for the parts the
``pallas`` and ``benes`` routes run: the numpy layout builders (copied
unchanged, so both packages build bit-identical layouts), the
position-reduce kernel (``_position_reduce_kernel`` there,
``ops/csrc/position_reduce.cu`` here) and the two functions around it,
:func:`aligned_reduce` and :func:`aligned_segment_grad`, and the slab gather
kernel (``_gather_kernel`` there, ``ops/csrc/slab_gather.cu`` here) behind
:func:`aligned_gather_products`, the ``benes`` forward.

The layout: entries sit in tiles of ``128 x 128`` slots; every tile reads one
*slab* of ``8 x 128`` dictionary positions, and each slot holds its entry's
value and the 3-bit position (``lo``) of its key in that slab.  A slab is a
virtual dictionary: ``dup_map`` names the key at each (slab, position, lane),
and a hot key is split into chunks spread over many lanes, so a skewed key
distribution does not inflate the padding.  The gradient layout keys entries
by feature and carries the row as payload; the transposed layout keys by row
and carries the feature, so the same reduction yields per-row margins.

``aligned_segment_grad`` computes ``g[key] = sum_e per_row[payload_e] *
val_e`` in three stages: a gather ``pv = per_row[rows] * vals``, the
position-reduce into one partial sum per dictionary slot (``n_slabs * 1024``
values, far fewer than the entries), and an epilogue that permutes the slots
into key order and sums them into ``dim`` outputs.  Only the middle stage is a
hand-written kernel; the gather and the epilogue are torch ops.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

LANES = 128
SUBLANES = 8
SLAB_POSITIONS = LANES * SUBLANES  # 1024 dictionary positions per slab
TILE_SUBLANES = 128  # entry sublanes per tile (16384 entries)
CHUNK_CAP = SUBLANES * LANES  # max entries of one key chunk


@dataclasses.dataclass(frozen=True)
class AlignedLayout:
    """Static, host-built slab-aligned entry layout for one sparse batch.

    Arrays (all ``[total_sublanes, 128]`` unless noted):

    - ``lo``: int32 slab position (0..7) of each entry's key; 0 for pad slots.
    - ``vals``: float32 entry values; 0.0 for pad slots.
    - ``rows``: int32 payload index of each entry (the row, in the gradient
      layout); 0 for pad slots (safe with val=0).
    - ``slab_of_tile`` ``[n_tiles]``: int32 slab read by each tile,
      non-decreasing.
    - ``dup_map`` ``[n_slabs * 1024]``: int32 key stored at each slab
      position (0 for unused positions, which only ever sum pad zeros).
    - ``src``: int64 original flat entry index (row-major ``r * k + j``) each
      slot was filled from; -1 for pad slots.  Host only.
    - ``n_entries``: real (unpadded) entry count.
    """

    lo: np.ndarray
    vals: np.ndarray
    rows: np.ndarray
    slab_of_tile: np.ndarray
    dup_map: np.ndarray
    src: np.ndarray
    n_entries: int

    @property
    def n_tiles(self) -> int:
        return int(self.slab_of_tile.shape[0])

    @property
    def n_slabs(self) -> int:
        return int(self.dup_map.shape[0]) // SLAB_POSITIONS

    @property
    def padded_entries(self) -> int:
        return int(self.lo.shape[0] * LANES)

    @property
    def padding_factor(self) -> float:
        """Padded-to-real entry ratio; the layout's skew-robustness metric."""
        return self.padded_entries / max(self.n_entries, 1)


def build_aligned_layout(ids: np.ndarray, vals: np.ndarray, dim: int) -> AlignedLayout:
    """The gradient layout (key = feature, payload = row) of a padded-COO
    ``[n, k]`` batch; pad entries (val == 0) are dropped.  One argsort over
    the nonzeros plus vectorized bin-packing, run once per dataset."""
    n, k = ids.shape
    flat_f = ids.reshape(-1).astype(np.int64)
    flat_v = vals.reshape(-1).astype(np.float32)
    flat_r = np.repeat(np.arange(n, dtype=np.int64), k)
    return _build_aligned_from_flat(flat_f, flat_r, flat_v, dim)


def build_row_aligned_layout(
    ids: np.ndarray, vals: np.ndarray
) -> AlignedLayout:
    """The transposed layout (key = row, payload = feature): with it
    ``aligned_segment_grad(w, layout, n)`` yields per-row sums
    ``sum_e w[f_e] * val_e`` (margins minus offset)."""
    n, k = ids.shape
    flat_f = ids.reshape(-1).astype(np.int64)
    flat_v = vals.reshape(-1).astype(np.float32)
    flat_r = np.repeat(np.arange(n, dtype=np.int64), k)
    return _build_aligned_from_flat(flat_r, flat_f, flat_v, n, key_role="row")


def _build_aligned_from_flat(
    flat_key: np.ndarray,
    flat_payload: np.ndarray,
    flat_v: np.ndarray,
    dim: int,
    key_role: str = "feature",
) -> AlignedLayout:
    """Core bin-packing builder over flat entry streams.

    ``flat_key`` is the id each entry reduces into (stored in ``dup_map``);
    ``flat_payload`` is the id whose vector element the entry multiplies
    (stored in ``rows``).  Pad entries (val == 0) are dropped.
    """
    keep = flat_v != 0.0
    orig = np.flatnonzero(keep)  # original flat (row-major) entry index
    flat_f, flat_v, flat_r = flat_key[keep], flat_v[keep], flat_payload[keep]
    if flat_f.size and (flat_f.min() < 0 or flat_f.max() >= dim):
        raise ValueError(f"{key_role} id out of range for dim {dim}")
    e_total = int(flat_f.size)
    if e_total == 0:
        return AlignedLayout(
            lo=np.zeros((TILE_SUBLANES, LANES), np.int32),
            vals=np.zeros((TILE_SUBLANES, LANES), np.float32),
            rows=np.zeros((TILE_SUBLANES, LANES), np.int32),
            slab_of_tile=np.zeros(1, np.int32),
            dup_map=np.zeros(SLAB_POSITIONS, np.int32),
            src=np.full((TILE_SUBLANES, LANES), -1, np.int64),
            n_entries=0,
        )

    # Key-sorted entry order: each key's entries are contiguous.
    order = np.argsort(flat_f, kind="stable")
    f_s, v_s, r_s = flat_f[order], flat_v[order], flat_r[order]
    orig_s = orig[order]
    counts = np.bincount(f_s, minlength=dim)
    present = np.flatnonzero(counts)
    feat_start = np.concatenate(([0], np.cumsum(counts)))[present]
    cnt = counts[present]

    # Chunk keys into pieces of <= CHUNK_CAP entries.
    pieces = (cnt + CHUNK_CAP - 1) // CHUNK_CAP
    chunk_feat = np.repeat(present, pieces)
    chunk_piece = np.arange(int(pieces.sum()), dtype=np.int64) - np.repeat(
        np.concatenate(([0], np.cumsum(pieces)))[:-1], pieces
    )
    chunk_src = np.repeat(feat_start, pieces) + chunk_piece * CHUNK_CAP
    chunk_size = np.minimum(
        np.repeat(cnt, pieces) - chunk_piece * CHUNK_CAP, CHUNK_CAP
    )

    # Sorted snake placement over S slabs x 128 lanes x 8 positions.
    desc = np.argsort(-chunk_size, kind="stable")
    chunk_feat, chunk_src, chunk_size = (
        chunk_feat[desc], chunk_src[desc], chunk_size[desc]
    )
    n_chunks = chunk_size.size
    s_pos = (n_chunks + SLAB_POSITIONS - 1) // SLAB_POSITIONS
    s_ent = (e_total + TILE_SUBLANES * SLAB_POSITIONS - 1) // (
        TILE_SUBLANES * SLAB_POSITIONS
    )
    n_slabs = int(max(s_pos, s_ent, 1))
    lanes_total = n_slabs * LANES
    j = np.arange(n_chunks, dtype=np.int64)
    pos = j // lanes_total  # 0..7 by construction of n_slabs
    lane_in_pass = j % lanes_total
    lane_global = np.where(pos % 2 == 0, lane_in_pass, lanes_total - 1 - lane_in_pass)
    slab = lane_global // LANES
    lane = lane_global % LANES

    # Variable slab heights: tiles per slab from its max lane load.
    load = np.zeros((n_slabs, LANES), np.int64)
    np.add.at(load, (slab, lane), chunk_size)
    tiles_per_slab = np.maximum(
        (load.max(axis=1) + TILE_SUBLANES - 1) // TILE_SUBLANES, 1
    )
    sub_base = np.zeros(n_slabs + 1, np.int64)
    np.cumsum(tiles_per_slab * TILE_SUBLANES, out=sub_base[1:])
    total_sub = int(sub_base[-1])

    # Chunk offsets within their (slab, lane): exclusive cumsum per cell.
    cell = slab * LANES + lane
    cell_order = np.argsort(cell, kind="stable")
    sizes_o = chunk_size[cell_order]
    cell_o = cell[cell_order]
    csum = np.cumsum(sizes_o) - sizes_o
    first = np.empty(n_chunks, bool)
    first[0] = True
    np.not_equal(cell_o[1:], cell_o[:-1], out=first[1:])
    run_ids = np.cumsum(first) - 1
    off_o = csum - csum[np.flatnonzero(first)][run_ids]

    # Scatter entries into the tile arrays.
    lo_arr = np.zeros((total_sub, LANES), np.int32)
    val_arr = np.zeros((total_sub, LANES), np.float32)
    row_arr = np.zeros((total_sub, LANES), np.int32)
    rep = np.repeat  # entries expanded chunk-by-chunk (in cell_order)
    idx_in_chunk = np.arange(int(sizes_o.sum()), dtype=np.int64) - rep(csum, sizes_o)
    src = rep(chunk_src[cell_order], sizes_o) + idx_in_chunk
    dst_sub = rep(sub_base[slab[cell_order]] + off_o, sizes_o) + idx_in_chunk
    dst_lane = rep(lane[cell_order], sizes_o)
    lo_arr[dst_sub, dst_lane] = rep(pos[cell_order], sizes_o).astype(np.int32)
    val_arr[dst_sub, dst_lane] = v_s[src]
    row_arr[dst_sub, dst_lane] = r_s[src].astype(np.int32)
    src_arr = np.full((total_sub, LANES), -1, np.int64)
    src_arr[dst_sub, dst_lane] = orig_s[src]

    dup_map = np.zeros(n_slabs * SLAB_POSITIONS, np.int32)
    dup_map[slab * SLAB_POSITIONS + pos * LANES + lane] = chunk_feat.astype(np.int32)
    slab_of_tile = np.repeat(
        np.arange(n_slabs, dtype=np.int32), tiles_per_slab
    )
    return AlignedLayout(
        lo=lo_arr, vals=val_arr, rows=row_arr,
        slab_of_tile=slab_of_tile, dup_map=dup_map, src=src_arr,
        n_entries=e_total,
    )


def pad_aligned_layout(
    layout: AlignedLayout, n_slabs: int, n_tiles: int
) -> AlignedLayout:
    """Pad a layout to a common (``n_slabs``, ``n_tiles``) geometry.

    Pad tiles carry only zero values and get slab ids that keep
    ``slab_of_tile`` non-decreasing, with at least one tile for every pad
    slab; pad dictionary positions hold key 0 and sum exact zeros.
    """
    s0, t0 = layout.n_slabs, layout.n_tiles
    if n_slabs < s0 or n_tiles < t0:
        raise ValueError(
            f"target geometry ({n_slabs} slabs, {n_tiles} tiles) smaller "
            f"than the layout's ({s0}, {t0})"
        )
    pad_slabs = n_slabs - s0
    pad_tiles = n_tiles - t0
    if pad_tiles < pad_slabs:
        raise ValueError(
            f"{pad_slabs} pad slabs need at least as many pad tiles "
            f"(got {pad_tiles}); choose n_tiles >= n_tiles_i + "
            f"(n_slabs - n_slabs_i) per shard"
        )
    if pad_slabs == 0 and pad_tiles == 0:
        return layout
    pad_rows = pad_tiles * TILE_SUBLANES
    # One tile per new pad slab (ascending), then the remainder on the last
    # slab of the padded set.
    new_slab_ids = np.arange(s0, n_slabs, dtype=np.int32)
    tail = np.full(pad_tiles - pad_slabs, max(n_slabs - 1, 0), np.int32)
    if pad_slabs == 0 and t0 == 0:
        raise ValueError("cannot pad an empty layout with zero slabs")
    return AlignedLayout(
        lo=np.concatenate(
            [layout.lo, np.zeros((pad_rows, LANES), np.int32)]
        ),
        vals=np.concatenate(
            [layout.vals, np.zeros((pad_rows, LANES), np.float32)]
        ),
        rows=np.concatenate(
            [layout.rows, np.zeros((pad_rows, LANES), np.int32)]
        ),
        slab_of_tile=np.concatenate(
            [layout.slab_of_tile, new_slab_ids, tail]
        ),
        dup_map=np.concatenate([
            layout.dup_map,
            np.zeros(pad_slabs * SLAB_POSITIONS, np.int32),
        ]),
        src=np.concatenate(
            [layout.src, np.full((pad_rows, LANES), -1, np.int64)]
        ),
        n_entries=layout.n_entries,
    )


@dataclasses.dataclass(frozen=True)
class AlignedLayoutDev:
    """An :class:`AlignedLayout` on a device, plus the epilogue statics:
    ``grad_perm`` (stable argsort of ``dup_map``) and ``sorted_feats``
    (``dup_map[grad_perm]``), so the per-slot partial sums reduce into keys
    in sorted order."""

    lo: Tensor  # [total_sub, 128] int32
    vals: Tensor  # [total_sub, 128] float32
    rows: Tensor  # [total_sub, 128] int32
    slab_of_tile: Tensor  # [n_tiles] int32, non-decreasing
    dup_map: Tensor  # [n_slabs * 1024] int32
    grad_perm: Tensor  # [n_slabs * 1024] int32
    sorted_feats: Tensor  # [n_slabs * 1024] int32

    @property
    def n_slabs(self) -> int:
        return int(self.dup_map.shape[0]) // SLAB_POSITIONS

    def to(self, device) -> "AlignedLayoutDev":
        return AlignedLayoutDev(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def device_layout(layout: AlignedLayout, device) -> AlignedLayoutDev:
    """Put an :class:`AlignedLayout` on ``device`` with the epilogue statics."""
    perm = np.argsort(layout.dup_map, kind="stable").astype(np.int32)

    def put(a: np.ndarray) -> Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return AlignedLayoutDev(
        lo=put(layout.lo),
        vals=put(layout.vals),
        rows=put(layout.rows),
        slab_of_tile=put(layout.slab_of_tile),
        dup_map=put(layout.dup_map),
        grad_perm=put(perm),
        sorted_feats=put(layout.dup_map[perm]),
    )


def position_partial_sums_plain(
    slab_of_tile: Tensor, pv: Tensor, lo: Tensor, n_slabs: int
) -> Tensor:
    """Plain PyTorch position-reduce: an 8-way masked sum over each tile's
    sublanes, then a sum of each slab's tiles.  ``[n_slabs * 8, 128]``."""
    n_tiles = slab_of_tile.shape[0]
    pv3 = pv.view(n_tiles, TILE_SUBLANES, LANES)
    lo3 = lo.view(n_tiles, TILE_SUBLANES, LANES)
    per_tile = torch.stack(
        [torch.where(lo3 == p, pv3, 0.0).sum(1) for p in range(SUBLANES)], 1
    )  # [n_tiles, 8, 128]
    out = torch.zeros(
        n_slabs, SUBLANES, LANES, dtype=torch.float32, device=pv.device
    )
    out.index_add_(0, slab_of_tile, per_tile)
    return out.view(n_slabs * SUBLANES, LANES)


def position_partial_sums(
    slab_of_tile: Tensor, pv: Tensor, lo: Tensor, n_slabs: int
) -> Tensor:
    """``out[s * 8 + p, l] = sum of pv[t * 128 + r, l]`` over the tiles ``t``
    of slab ``s`` and the sublanes ``r`` with ``lo[t * 128 + r, l] == p``.

    CUDA tensors launch the ``position_reduce`` kernel; CPU tensors take
    :func:`position_partial_sums_plain`.
    """
    n_tiles = int(slab_of_tile.shape[0])
    if pv.shape != (n_tiles * TILE_SUBLANES, LANES) or lo.shape != pv.shape:
        raise ValueError(
            f"pv/lo must be [{n_tiles * TILE_SUBLANES}, {LANES}], got "
            f"{tuple(pv.shape)} and {tuple(lo.shape)}"
        )
    if pv.dtype != torch.float32 or lo.dtype != torch.int32 or (
        slab_of_tile.dtype != torch.int32
    ):
        raise TypeError("pv must be float32; lo and slab_of_tile int32")
    if not (pv.device == lo.device == slab_of_tile.device):
        raise ValueError("pv, lo and slab_of_tile must share one device")
    if pv.device.type == "cpu":
        return position_partial_sums_plain(slab_of_tile, pv, lo, n_slabs)
    if pv.device.type != "cuda":
        raise ValueError(f"unsupported device {pv.device}")
    if not all(t.is_contiguous() for t in (pv, lo, slab_of_tile)):
        raise ValueError("the position-reduce kernel takes contiguous tensors only")
    from photon_tpu_torch.ops import _build

    lib = _build.load("position_reduce")
    fn = lib.photon_position_reduce
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    tile_out = torch.empty(
        max(n_tiles, 1) * SLAB_POSITIONS, dtype=torch.float32, device=pv.device
    )
    out = torch.empty(
        n_slabs * SUBLANES, LANES, dtype=torch.float32, device=pv.device
    )
    stream = torch.cuda.current_stream(pv.device).cuda_stream
    position_partial_sums.launches += 1
    _build.check(
        fn(slab_of_tile.data_ptr(), pv.data_ptr(), lo.data_ptr(), n_tiles,
           n_slabs, tile_out.data_ptr(), out.data_ptr(), stream),
        "position_reduce",
    )
    return out


position_partial_sums.launches = 0


def aligned_reduce(pv: Tensor, al: AlignedLayoutDev, dim: int) -> Tensor:
    """Fold per-slot products ``pv`` (``[total_sub, 128]``, zeros in pad
    slots) into ``dim`` key sums: the position-reduce, then the slots in
    key order summed into their keys (``scatter_sum``: a hot key split over
    thousands of slots sums in float64)."""
    from photon_tpu_torch.data.batch import scatter_sum

    partial = position_partial_sums(al.slab_of_tile, pv, al.lo, al.n_slabs)
    flat = partial.view(-1).index_select(0, al.grad_perm)
    return scatter_sum(al.sorted_feats, flat, dim)


def aligned_segment_grad(per_row: Tensor, al: AlignedLayoutDev, dim: int) -> Tensor:
    """``g[key] = sum_e per_row[rows_e] * val_e`` over the aligned layout:
    the gradient (``per_row`` = dz over the gradient layout) or the margins
    (``per_row`` = w over the transposed layout)."""
    pv = per_row.index_select(0, al.rows.view(-1)).view(al.rows.shape) * al.vals
    return aligned_reduce(pv, al, dim)


def aligned_gather_products_plain(
    w2d: Tensor, slab_of_tile: Tensor, lo: Tensor, vals: Tensor
) -> Tensor:
    """Plain PyTorch slab gather: each tile's ``[8, 128]`` slab block, then
    a gather along its positions by ``lo``, times ``vals``."""
    n_tiles = slab_of_tile.shape[0]
    slabs = w2d.view(-1, SUBLANES, LANES).index_select(0, slab_of_tile)
    picked = torch.take_along_dim(
        slabs, lo.view(n_tiles, TILE_SUBLANES, LANES).long(), dim=1
    )
    return (picked * vals.view(n_tiles, TILE_SUBLANES, LANES)).view(lo.shape)


def aligned_gather_products(
    w2d: Tensor, slab_of_tile: Tensor, lo: Tensor, vals: Tensor
) -> Tensor:
    """Per-slot ``w[f] * val`` over a slab-aligned layout:
    ``out[t * 128 + s, l] = w2d[slab_of_tile[t] * 8 + lo[t * 128 + s, l], l]
    * vals[t * 128 + s, l]``, with ``w2d = w[dup_map].view(-1, 128)`` (see
    :func:`gather_products`).  ``[total_sub, 128]`` float32, 0.0 in pad
    slots.

    CUDA tensors launch the ``slab_gather`` kernel; CPU tensors take
    :func:`aligned_gather_products_plain`.
    """
    n_tiles = int(slab_of_tile.shape[0])
    shape = (n_tiles * TILE_SUBLANES, LANES)
    if lo.shape != shape or vals.shape != shape:
        raise ValueError(
            f"lo/vals must be [{shape[0]}, {LANES}], got {tuple(lo.shape)} "
            f"and {tuple(vals.shape)}"
        )
    if w2d.ndim != 2 or w2d.shape[1] != LANES or w2d.shape[0] % SUBLANES:
        raise ValueError(
            f"w2d must be [n_slabs * {SUBLANES}, {LANES}], got {tuple(w2d.shape)}"
        )
    if w2d.dtype != torch.float32 or vals.dtype != torch.float32 or (
        lo.dtype != torch.int32 or slab_of_tile.dtype != torch.int32
    ):
        raise TypeError("w2d and vals must be float32; lo and slab_of_tile int32")
    if not (w2d.device == slab_of_tile.device == lo.device == vals.device):
        raise ValueError("w2d, slab_of_tile, lo and vals must share one device")
    if w2d.device.type == "cpu":
        return aligned_gather_products_plain(w2d, slab_of_tile, lo, vals)
    if w2d.device.type != "cuda":
        raise ValueError(f"unsupported device {w2d.device}")
    if not all(t.is_contiguous() for t in (w2d, slab_of_tile, lo, vals)):
        raise ValueError("the slab gather kernel takes contiguous tensors only")
    from photon_tpu_torch.ops import _build

    fn = _build.load("slab_gather").photon_slab_gather
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    out = torch.empty(shape, dtype=torch.float32, device=w2d.device)
    stream = torch.cuda.current_stream(w2d.device).cuda_stream
    aligned_gather_products.launches += 1
    _build.check(
        fn(w2d.data_ptr(), slab_of_tile.data_ptr(), lo.data_ptr(),
           vals.data_ptr(), n_tiles, out.data_ptr(), stream),
        "slab_gather",
    )
    return out


aligned_gather_products.launches = 0


def gather_products(w: Tensor, layout) -> Tensor:
    """The dictionary gather ``w[dup_map]`` (an ``index_select``, as in
    the reference), then the slab gather over ``layout`` (an
    :class:`AlignedLayout` or :class:`AlignedLayoutDev`; a host layout is
    put on ``w``'s device)."""
    if isinstance(layout, AlignedLayout):
        layout = device_layout(layout, w.device)
    w2d = w.index_select(0, layout.dup_map).view(-1, LANES)
    return aligned_gather_products(w2d, layout.slab_of_tile, layout.lo, layout.vals)


def gather_products_reference(w: np.ndarray, layout: AlignedLayout) -> np.ndarray:
    """NumPy reference: resolve each slot's feature through ``dup_map``."""
    n_sub = layout.lo.shape[0]
    s = layout.slab_of_tile[np.arange(n_sub) // TILE_SUBLANES]
    f = layout.dup_map[
        s[:, None] * SLAB_POSITIONS + layout.lo * LANES + np.arange(LANES)[None, :]
    ]
    return w[f] * layout.vals
