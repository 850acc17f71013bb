"""vperm: static permutations of the sparse GLM's entry stream, routed once on
the host and applied by three permutation kernels; the ``xchg`` route.

Counterpart of ``photon_tpu/ops/vperm.py`` in both reduce modes
(``PHOTON_XCHG_REDUCE``, read when the route is built):

- ``aligned`` (the default): the ``xchg`` gradient ``g[f] = sum_e
  per_row[row_e] * val_e`` reduces slot products over the batch's
  slab-aligned layout through the position-reduce (K2,
  ``ops/slab_reduce.py``), as the ``pallas`` route does; where the
  ``pallas`` route gathers ``per_row[rows]`` for every slot at every step,
  ``xchg`` carries the row-major stream into slot order through a
  permutation routed once on the host.
- ``cumsum``: the route carries the stream into the COMPACT feature-sorted
  order instead (:func:`build_xchg_sorted_route`,
  :func:`build_balanced_sorted_route`) and the reduce is a compensated
  prefix scan (:func:`compensated_scan`, the hand-written kernel CS) read at
  the ``[d + 1]`` feature boundaries ``bounds``: ``g[f]`` is the difference
  of the scan's ``(hi, lo)`` pair across feature f's segment, differenced as
  a pair before the two halves are added.  No aligned layout is read.

Two route kinds (:func:`build_xchg_aux` picks):

- **balanced** (:class:`BalancedRoute`): the stream is cut into NC source
  windows and NC destination windows; stage A permutes within each source
  chunk so that the entries bound for destination window j form block j, a
  block transpose ``[NC, NC, B] -> [NC, NC, B]`` (a torch copy) swaps the
  blocks, and stage B permutes within each destination chunk.  When k
  divides 128, stage A reads the ``[n]`` dz vector and repeats each value k
  times inside the kernel (K6), so no E-element stream is ever written; the
  values were permuted into slot order once (``vals_dest``) and multiply
  after stage B.  No edge coloring is needed at the macro level.
- **colored** (:class:`VpermRoute`): a two-level Clos network over
  ``[NC, CS]``: a chunk pass R1, a transpose, a lane-packed pass over the
  per-column NC-permutations, a transpose back, a chunk pass R2.  It is the
  fallback when the data defeats the balanced block census.

Each chunk pass is the 5-stage micro-Clos of the JAX kernel (lane gather by
``i1``, transpose, gather along CH by ``i2``, transpose, lane gather by
``i3``), whose three index planes come from two edge colorings per chunk
(``ops/clos.py``).  The kernels (``ops/csrc/vperm.cu``, whose note has the
details):

- K4 :func:`chunk_pass` (``_chunk_kernel``, ``photon_tpu/ops/vperm.py``):
  R1 and R2, stages A (for the value bake) and B;
- K5 :func:`lane_pass` (``_lane_kernel``): the colored route's middle stage;
- K6 :func:`chunk_expand_pass` (``_chunk_expand_kernel``): stage A with the
  dz repeat.

What bounds K4 and K6 is device-memory bytes at 3.35 TB/s (12 and 8 bytes a
slot); only their middle stage reads across a 1-4 MB chunk.  Each has two
forms, picked before the launch by :func:`chunk_form` from the shape alone:

- the cluster form keeps the chunk's state in shared memory (227 KB a
  block), so no random read reaches L2: K4 in a cluster of 16 blocks that
  trade y1 by columns and y2 by rows through distributed shared memory
  (:func:`exchange_passes`), K6 in one block holding the chunk's dz rows
  and packed lane selectors (48 bytes a row at k = 32);
- the global form, the first version of both, composes the stages into one
  read an element through L2, and takes chunks that no cluster holds (K4
  above 5320 rows; the builders allow 8192).

Each launches on CUDA tensors (a refused launch raises) and takes its plain
PyTorch version on CPU tensors; all are pure data movement and equal bit for
bit.  Index planes are int8 (lanes) and int16 (chunk rows) tensors on the
route's device.  Each kernel moves float32 or bfloat16 elements, a form
each (the bf16 forms' launches counted apart in ``bf16_launches``).

The half-width payload (``PHOTON_XCHG_DTYPE=bfloat16``, read at the bake
and at each evaluation, as the reference reads it): the baked values are
stored in bf16, and each evaluation casts the moving stream to bf16 before
the passes (dz before K6; the products, or dz repeated, before K4/K5), then
widens both the moved stream and the baked values before their multiply, so
the reduce (K2 or CS) reads float32.

Routes serialize to ``npz`` (:func:`_aux_to_npz`, :func:`_aux_from_npz`,
the reference's keys) for the streamed chunks' layout cache
(``data/stream_layouts.py``).

Not ported (``ROADMAP.md`` queue 2): the resident route disk cache
(``_route_cache_path``) and the sharded, stacked routes are not carried
(:func:`balanced_blk_census` and ``blk_override`` are, for the streamed
chunks' pow2-padded geometry).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import logging
import math
import os
import time
import weakref
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.ops.clos import route_permutation

Tensor = torch.Tensor

LANES = 128
SUBLANES_PAD = 8             # balanced chunk heights are multiples of lcm(nc, 8)
CH_SMALL = 2048              # chunk rows (1 MB f32 chunks)
CH_LARGE = 4096              # for domains past 128 small chunks
MAX_N = 128 * CH_LARGE * LANES   # 2^26: the lane stage holds NC <= 128
CH_MAX = 8192                # balanced chunk-height cap (int16 i2/b2 planes)

# Host seconds of the last build_xchg_aux route build.
route_build_seconds: float = 0.0


# -- routes -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VpermRoute:
    """The colored route of one static bijection over ``total`` padded
    elements, applied as ``y[:n_out] = x_padded[perm][:n_out]`` with ``x``
    of length ``n_in``.

    ``i1/i3`` and ``i4/i6``: ``[NC*CH, 128]`` int8 lane indices of the two
    chunk stages' outer lane gathers.  ``i2``/``i5``: ``[NC*128, CH]`` int16
    row-gather indices on the transposed ``[128, CH]`` chunk view.  ``c``:
    ``[total/128, 128]`` int8 lane-packed middle-stage indices (``None``
    when NC == 1: the middle stage is the identity and R2 is skipped).
    """

    n_in: int
    n_out: int
    nc: int
    ch: int
    i1: Tensor
    i2: Tensor
    i3: Tensor
    c: Optional[Tensor]
    i4: Optional[Tensor]
    i5: Optional[Tensor]
    i6: Optional[Tensor]

    @property
    def cs(self) -> int:
        return self.ch * LANES

    @property
    def total(self) -> int:
        return self.nc * self.cs

    def to(self, device) -> "VpermRoute":
        return _move(self, device)


@dataclasses.dataclass(frozen=True)
class BalancedRoute:
    """The coloring-free balanced exchange (see the module docstring).

    ``a1/a2/a3``: stage-A micro-Clos planes (``[NC*CH, 128]`` int8,
    ``[NC*128, CH]`` int16, ``[NC*CH, 128]`` int8); ``b1/b2/b3``: stage B
    (identity planes when NC == 1, where stage B is skipped).  ``n_in`` real
    sources; ``cs_win`` row-major entries per source window (each physical
    chunk is one window front-packed plus a pad tail); ``ds_win`` real
    destination entries per chunk front; ``blk`` slots per block; the flat
    output has ``NC * CS`` elements.  ``k_expand`` is k when stage A can
    rebuild the row-major stream from a dz tile (k divides 128), else 0.
    """

    n_in: int
    n_out: int
    nc: int
    ch: int
    blk: int
    cs_win: int
    ds_win: int
    k_expand: int
    a1: Tensor
    a2: Tensor
    a3: Tensor
    b1: Tensor
    b2: Tensor
    b3: Tensor

    @property
    def cs(self) -> int:
        return self.ch * LANES

    @property
    def total(self) -> int:
        return self.nc * self.cs

    def to(self, device) -> "BalancedRoute":
        return _move(self, device)


@dataclasses.dataclass(frozen=True)
class XchgAux:
    """The batch's exchange: ``route`` carries the row-major per-entry stream
    into the reduce's order — the aligned layout's slot order, or with
    ``bounds`` (the ``cumsum`` mode, ``[dim + 1]`` int32) the compact
    feature-sorted order, where feature f's entries lie in
    ``[bounds[f], bounds[f + 1])`` of the moved stream.  With baked values
    (a balanced route, or any ``cumsum`` route), ``vals_dest`` is the static
    value stream already in that order (baked at attach, one exchange), so
    each evaluation moves only dz, and ``vals_fp`` a strided sample of the
    row-major values it was baked from, which :func:`xchg_segment_grad`
    holds the caller's values to."""

    route: Union[VpermRoute, BalancedRoute]
    bounds: Optional[Tensor] = None
    vals_dest: Optional[Tensor] = None
    vals_fp: Optional[np.ndarray] = None

    def to(self, device) -> "XchgAux":
        return dataclasses.replace(
            self, route=self.route.to(device),
            bounds=None if self.bounds is None else self.bounds.to(device),
            vals_dest=None if self.vals_dest is None else self.vals_dest.to(device),
        )


def _move(route, device):
    return dataclasses.replace(route, **{
        f.name: getattr(route, f.name).to(device)
        for f in dataclasses.fields(route)
        if isinstance(getattr(route, f.name), Tensor)
    })


# -- host routing -------------------------------------------------------------

def _chunk_stage_arrays(rows: np.ndarray, ch: int):
    """Factor per-chunk CS-permutations into the 5-stage micro-Clos planes.

    ``rows`` is ``[NC, CS]`` int64: row i is the permutation applied within
    chunk i (``y_chunk = x_chunk[rows[i]]``).  Returns (i1 ``[NC*CH, 128]``
    int8, i2 ``[NC*128, CH]`` int16, i3 ``[NC*CH, 128]`` int8).
    """
    nc = rows.shape[0]
    i1 = np.empty((nc * ch, LANES), np.int8)
    i2 = np.empty((nc * LANES, ch), np.int16)
    i3 = np.empty((nc * ch, LANES), np.int8)

    def one(i: int) -> None:
        r = route_permutation(rows[i], a=ch, b=LANES)
        # Stages on [CH, 128]: lane gather by p1, transpose, row gather by
        # p2 on [128, CH], transpose, lane gather by p3.
        i1[i * ch:(i + 1) * ch] = r.p1.astype(np.int8)
        i2[i * LANES:(i + 1) * LANES] = r.p2.astype(np.int16)
        i3[i * ch:(i + 1) * ch] = r.p3.astype(np.int8)

    # The native coloring releases the GIL and is reentrant, so chunks
    # color concurrently; past 8 workers the walk is memory-bound.
    workers = min(os.cpu_count() or 1, 8, nc)
    if workers == 1:
        for i in range(nc):
            one(i)
    else:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            list(pool.map(one, range(nc)))  # surfaces the first failure
    return i1, i2, i3


def _pack_middle(cidx: np.ndarray, nc: int) -> np.ndarray:
    """Lane-pack the ``[CS, NC]`` per-row middle permutations into
    ``[total/128, 128]``: NC divides 128, so each packed row holds 128/NC
    logical rows, and the packed lane index of flat position p*128+l is
    ``(l // NC) * NC + cidx[s, l % NC]`` with ``s = (p*128 + l) // NC``."""
    cs = cidx.shape[0]
    total = cs * nc
    flat = np.arange(total, dtype=np.int64)
    s = flat // nc
    c = flat % nc
    packed = ((flat % 128) // nc * nc + cidx[s, c]).astype(np.int8)
    return packed.reshape(total // LANES, LANES)


def pick_geometry(need: int) -> tuple[int, int]:
    """(ch, nc) covering ``need`` elements: the smaller chunk height when it
    fits in 128 chunks, NC a power of two so it divides 128."""
    if need > MAX_N:
        raise ValueError(
            f"vperm supports up to {MAX_N:,} elements single-device "
            f"(got {need:,}); shard the layout across devices first"
        )
    ch = CH_SMALL if need <= 128 * CH_SMALL * LANES else CH_LARGE
    nc = max(1, -(-need // (ch * LANES)))
    if nc & (nc - 1):
        nc = 1 << nc.bit_length()
    return ch, nc


def _put(a: np.ndarray, device) -> Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def route_vperm_full(perm: np.ndarray, n_in: int, n_out: int, ch: int,
                     device=None) -> VpermRoute:
    """Route a full-domain bijection (``len(perm)`` = NC*CS exactly) onto
    ``device``.  ``perm[d]`` is the padded source feeding padded destination
    ``d``; callers guarantee that destinations below ``n_out`` read real
    sources and pad destinations read pad (zero) sources."""
    dev = resolve_device(device)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    total = perm.size
    cs = ch * LANES
    nc = total // cs
    if nc * cs != total or (nc & (nc - 1)) or nc > 128:
        raise ValueError(f"total {total} is not a valid NC*CS geometry")
    if perm.size and (
        perm.min() < 0 or perm.max() >= total
        or np.bincount(perm, minlength=total).max() != 1
    ):
        raise ValueError("perm is not a permutation of [0, total)")

    c = i4 = i5 = i6 = None
    if nc == 1:
        i1, i2, i3 = _chunk_stage_arrays(perm[None, :], ch)
    else:
        r = route_permutation(perm, a=nc, b=cs)
        i1, i2, i3 = _chunk_stage_arrays(r.p1.astype(np.int64), ch)
        c = _put(_pack_middle(r.p2.astype(np.int64), nc), dev)
        i4, i5, i6 = (
            _put(p, dev)
            for p in _chunk_stage_arrays(r.p3.astype(np.int64), ch)
        )
    return VpermRoute(
        n_in=n_in, n_out=n_out, nc=nc, ch=ch,
        i1=_put(i1, dev), i2=_put(i2, dev), i3=_put(i3, dev),
        c=c, i4=i4, i5=i5, i6=i6,
    )


def route_vperm(perm: np.ndarray, device=None) -> VpermRoute:
    """Route ``y = x[perm]`` (a square n-element permutation, n <= MAX_N).
    The domain pads to whole chunks; pad slots map to themselves."""
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    n = perm.size
    if n and (perm.min() < 0 or perm.max() >= n
              or np.bincount(perm, minlength=n).max() != 1):
        raise ValueError("perm is not a permutation of [0, n)")
    ch, nc = pick_geometry(n)
    full = np.arange(nc * ch * LANES, dtype=np.int64)
    full[:n] = perm
    return route_vperm_full(full, n, n, ch, device)


def full_bijection(dest_src: np.ndarray, n_sources: int,
                   total: int) -> np.ndarray:
    """Extend an injective dest -> source map to a full-domain bijection.

    ``dest_src[d]`` is the real source of destination ``d`` (< 0 for pad
    destinations); real sources lie in [0, n_sources).  The unused sources
    (real pads plus the [n_sources, total) tail) fill the pad destinations
    and the tail in ascending order: they only ever carry zeros.
    """
    n_dest = dest_src.size
    if n_dest > total or n_sources > total:
        raise ValueError("total smaller than the streams it must cover")
    perm = np.empty(total, dtype=np.int64)
    real = dest_src >= 0
    perm[:n_dest][real] = dest_src[real]
    used = np.zeros(total, dtype=bool)
    used[dest_src[real]] = True
    unused = np.flatnonzero(~used)
    n_pad = int((~real).sum())
    if unused.size != n_pad + (total - n_dest):
        raise ValueError("dest_src is not injective into the source stream")
    perm[:n_dest][~real] = unused[:n_pad]
    perm[n_dest:] = unused[n_pad:]
    return perm


def invert_vperm(route: VpermRoute) -> VpermRoute:
    """The inverse bijection's route, with no second coloring: the pipeline
    runs backwards with each stage's rows inverted (each plane row is a
    permutation, so its argsort is its inverse); ``n_in`` and ``n_out``
    swap."""

    def inv(p: Tensor) -> Tensor:
        return torch.argsort(p.long(), dim=1).to(p.dtype)

    if route.nc == 1:
        return VpermRoute(
            n_in=route.n_out, n_out=route.n_in, nc=1, ch=route.ch,
            i1=inv(route.i3), i2=inv(route.i2), i3=inv(route.i1),
            c=None, i4=None, i5=None, i6=None,
        )
    return VpermRoute(
        n_in=route.n_out, n_out=route.n_in, nc=route.nc, ch=route.ch,
        i1=inv(route.i6), i2=inv(route.i5), i3=inv(route.i4), c=inv(route.c),
        i4=inv(route.i3), i5=inv(route.i2), i6=inv(route.i1),
    )


def apply_vperm_reference(x: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """NumPy oracle for tests."""
    return np.asarray(x)[np.asarray(perm)]


def build_xchg_route(layout, n: int, k: int, device=None) -> VpermRoute:
    """The colored route of the row-major entry stream (``n * k``) into the
    slot order of ``layout`` (a host ``AlignedLayout`` with ``src``): pad
    slots read zero-valued sources."""
    n_rm = n * k
    slots_src = layout.src.reshape(-1)
    ch, nc = pick_geometry(max(n_rm, int(slots_src.size)))
    total = nc * ch * LANES
    perm = full_bijection(slots_src, n_rm, total)
    return route_vperm_full(perm, n_rm, int(slots_src.size), ch, device)


def _complete_chunk_local(dest_src: np.ndarray, nc: int,
                          cs: int) -> np.ndarray:
    """Fill pad destinations (< 0) with each chunk's own unused sources
    (ascending), so every row of the ``[nc, cs]`` result is a within-chunk
    permutation: real slots and real sources tally per chunk by
    construction."""
    grid = dest_src.reshape(nc, cs)
    out = grid % cs  # real slots: chunk-local source offset
    for i in range(nc):
        row = grid[i]
        real = row >= 0
        used = np.zeros(cs, bool)
        used[row[real] % cs] = True
        out[i, ~real] = np.flatnonzero(~used)
    return out


def _balanced_windows(dest_src: np.ndarray, n_src_stream: int, k: int):
    """Window partition and per-(source, destination)-window block census of
    the balanced exchange: ``(nc, cs_win, ds_win, k_expand, d_real, src_of,
    src_win, dest_win, blk)``, or None when the streams exceed the
    geometry limits."""
    n_dest = dest_src.size
    d_real = np.flatnonzero(dest_src >= 0)
    src_of = dest_src[d_real]
    if max(n_src_stream, n_dest) > MAX_N:
        return None
    if d_real.size and (src_of.min() < 0 or src_of.max() >= n_src_stream):
        return None
    nc = min(
        128, max(1, -(-max(n_src_stream, n_dest) // (CH_SMALL * LANES)))
    )
    ds_win = -(-n_dest // nc)  # destination window j = [j*ds_win, ...)
    dest_win = np.minimum(d_real // ds_win, nc - 1)
    # Source windows are cs_win raw row-major entries; each physical chunk
    # is one window front-packed plus a pad tail.  When k divides 128 the
    # window rounds to whole rows, so no chunk splits a row and stage A can
    # rebuild the stream from a [ch, 128/k] dz tile (apply_balanced_dz).
    k_expand = k if (k and LANES % k == 0) else 0
    cs_base = -(-n_src_stream // nc)
    cs_win = k * (-(-cs_base // k)) if k_expand else cs_base
    src_win = np.minimum(src_of // cs_win, nc - 1)
    counts = np.bincount(
        src_win * nc + dest_win, minlength=nc * nc
    ).reshape(nc, nc)
    blk = int(counts.max())
    return nc, cs_win, ds_win, k_expand, d_real, src_of, src_win, dest_win, blk


def _build_balanced_core(dest_src: np.ndarray, n_src_stream: int, k: int,
                         device, blk_override: Optional[int] = None
                         ) -> Optional[BalancedRoute]:
    """Factor an exchange into the balanced form, for a destination stream
    that tolerates zero pads between real entries.

    ``dest_src[d]`` is the row-major source index feeding destination ``d``
    (< 0 for pad destinations; each source at most once); ``n_src_stream``
    is the full row-major stream length (n * k).  ``blk_override`` forces a
    block capacity at least the natural census (:func:`balanced_blk_census`),
    so that chunks of one shape share one geometry.  Returns None when the
    data defeats the balance assumption or the geometry limits (the caller
    falls back to the colored route).
    """
    win = _balanced_windows(dest_src, n_src_stream, k)
    if win is None:
        return None
    nc, cs_win, ds_win, k_expand, d_real, src_of, src_win, dest_win, blk = win
    if blk_override is not None:
        if blk_override < blk:
            raise ValueError(f"blk_override {blk_override} < the natural block "
                             f"census {blk}")
        blk = blk_override
    e = d_real.size
    cs_base = -(-n_src_stream // nc)
    # Quantum 128 * lcm(nc, 8): the block stride cs_pad / nc is whole and
    # ch = cs_pad / 128 is a multiple of 8 (the JAX kernel's f32 sublane
    # tile; kept so both packages build the same geometry).
    quantum = LANES * math.lcm(nc, SUBLANES_PAD)
    cs_pad = -(-max(nc * blk, cs_win, ds_win) // quantum) * quantum
    if nc > 1 and cs_pad > 2 * max(cs_base, ds_win):
        return None  # pathological source/destination correlation
    ch = cs_pad // LANES
    if ch > CH_MAX:
        return None
    blk_slots = cs_pad // nc
    total = nc * cs_pad

    # Stage-A slot of each entry: source chunk src_win, block dest_win,
    # ranked by destination order within the (source, destination) pair.
    # With one chunk the transpose and stage B are skipped, so stage A
    # places entries at their final positions.
    seq = np.arange(e, dtype=np.int64)
    if nc == 1:
        mid_slot = d_real.astype(np.int64)
    else:
        pair = src_win * nc + dest_win
        pair_order = np.argsort(pair, kind="stable")
        sizes = np.bincount(pair, minlength=nc * nc)
        starts = np.concatenate(([0], np.cumsum(sizes)))[:-1]
        rank_in_block = np.zeros(e, dtype=np.int64)
        rank_in_block[pair_order] = seq - np.repeat(starts, sizes)
        mid_slot = src_win * cs_pad + dest_win * blk_slots + rank_in_block

    # Stage A: within-chunk permutations; source coordinates are in the
    # padded stream (windows front-pack their chunks).
    dest_src_a = np.full(total, -1, np.int64)
    dest_src_a[mid_slot] = src_win * cs_pad + (src_of % cs_win)
    a1, a2, a3 = _chunk_stage_arrays(
        _complete_chunk_local(dest_src_a, nc, cs_pad), ch
    )

    if nc == 1:
        # Stage B is skipped at apply time; identity planes keep the shape.
        ident = np.arange(cs_pad, dtype=np.int64)[None, :]
        b1, b2, b3 = _chunk_stage_arrays(ident, ch)
    else:
        # Block transpose [nc, nc, blk_slots]: (src, dest, b) -> (dest, src, b).
        post_t = dest_win * cs_pad + src_win * blk_slots + rank_in_block
        # Stage B: destination d front-packs into destination chunk dest_win.
        final = dest_win * cs_pad + (d_real - dest_win * ds_win)
        dest_src_b = np.full(total, -1, np.int64)
        dest_src_b[final] = post_t
        b1, b2, b3 = _chunk_stage_arrays(
            _complete_chunk_local(dest_src_b, nc, cs_pad), ch
        )

    return BalancedRoute(
        n_in=n_src_stream, n_out=dest_src.size, nc=nc, ch=ch, blk=blk_slots,
        cs_win=cs_win, ds_win=ds_win, k_expand=k_expand,
        **{name: _put(p, device) for name, p in
           zip(("a1", "a2", "a3", "b1", "b2", "b3"), (a1, a2, a3, b1, b2, b3))},
    )


def build_balanced_aligned_route(layout, ids: np.ndarray, device=None,
                                 blk_override: Optional[int] = None
                                 ) -> Optional[BalancedRoute]:
    """The balanced route of the row-major stream into ``layout``'s slot
    order (slot pads pair with zero-valued unused sources by chunk-local
    completion); None -> the colored route."""
    k = int(ids.shape[-1]) if ids.ndim == 2 else 0
    slots_src = np.ascontiguousarray(layout.src.reshape(-1), dtype=np.int64)
    return _build_balanced_core(
        slots_src, int(ids.size), k, resolve_device(device),
        blk_override=blk_override,
    )


def _sorted_order(flat: np.ndarray, order: Optional[np.ndarray]) -> np.ndarray:
    """The stable argsort of the flat id stream (``order`` when the caller
    already holds it)."""
    if order is None:
        return np.argsort(flat, kind="stable")
    return np.ascontiguousarray(order, dtype=np.int64)


def build_xchg_sorted_route(ids: np.ndarray, dim: int,
                            order: Optional[np.ndarray] = None,
                            device=None) -> XchgAux:
    """The colored route of the row-major entries (``[n, k]`` ``ids``) into
    the COMPACT feature-sorted stream, with its ``[dim + 1]`` feature
    boundaries.  Pads (id 0, value 0) land in feature 0's segment and add
    zero.  The destination is as long as the source, so the only padding is
    the chunk-multiple tail, which maps to itself.  ``order`` is the stable
    argsort of the flat ids when the caller already holds it."""
    dev = resolve_device(device)
    flat = ids.reshape(-1).astype(np.int64)
    order = _sorted_order(flat, order)
    n_rm = flat.size
    ch, nc = pick_geometry(n_rm)
    total = nc * ch * LANES
    perm = np.arange(total, dtype=np.int64)
    perm[:n_rm] = order
    route = route_vperm_full(perm, n_rm, n_rm, ch, dev)
    bounds = np.searchsorted(flat[order], np.arange(dim + 1, dtype=np.int64))
    return XchgAux(route=route, bounds=_put(bounds.astype(np.int32), dev))


def build_balanced_sorted_route(ids: np.ndarray, dim: int,
                                order: Optional[np.ndarray] = None,
                                blk_override: Optional[int] = None,
                                device=None):
    """``(BalancedRoute, bounds)`` of the row-major stream into the
    feature-sorted stream, or None when the data defeats the balance
    assumption.  The sorted destination rank r lies in destination window
    ``r // ds_win``, front-packed in its chunk, so ``bounds`` are ranks
    mapped into the padded ``[NC * CS]`` stream (the pads between chunk
    fronts carry zeros, which a prefix scan skips)."""
    dev = resolve_device(device)
    flat = ids.reshape(-1).astype(np.int64)
    k = int(ids.shape[-1]) if ids.ndim == 2 else 0
    order = _sorted_order(flat, order)
    route = _build_balanced_core(order, flat.size, k, dev,
                                 blk_override=blk_override)
    if route is None:
        return None
    rank = np.searchsorted(flat[order], np.arange(dim + 1, dtype=np.int64))
    bw = np.minimum(rank // route.ds_win, route.nc - 1)
    bounds = bw * route.cs + (rank - bw * route.ds_win)
    return route, _put(bounds.astype(np.int32), dev)


def balanced_blk_census(dest_src: np.ndarray, n_src_stream: int,
                        k: int) -> Optional[int]:
    """The natural per-(source, destination)-window block census of a
    balanced exchange, or None when its streams exceed the balanced
    geometry limits; a caller rounds it up (``blk_override``) to give
    chunks of one shape one geometry."""
    win = _balanced_windows(
        np.ascontiguousarray(dest_src, dtype=np.int64), n_src_stream, k
    )
    return None if win is None else win[-1]


def xchg_reduce_mode() -> str:
    """``PHOTON_XCHG_REDUCE`` (``aligned`` or ``cumsum``)."""
    mode = os.environ.get("PHOTON_XCHG_REDUCE", "aligned")
    if mode not in ("aligned", "cumsum"):
        raise ValueError(
            f"PHOTON_XCHG_REDUCE={mode!r}; the port supports aligned or cumsum")
    return mode


def xchg_payload_dtype() -> torch.dtype:
    """``PHOTON_XCHG_DTYPE``: the dtype the exchange moves (``float32``, or
    ``bfloat16`` for the half-width payload); anything else raises."""
    dtype = os.environ.get("PHOTON_XCHG_DTYPE", "float32")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"PHOTON_XCHG_DTYPE={dtype!r}; the port supports float32 or bfloat16")
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _check_xchg_env() -> None:
    """Refuse the xchg variants the JAX package does not have."""
    xchg_reduce_mode()
    xchg_payload_dtype()


def build_xchg_aux(layout, ids: np.ndarray, vals: Optional[np.ndarray] = None,
                   force_colored: bool = False, device=None,
                   dim: Optional[int] = None,
                   order: Optional[np.ndarray] = None) -> XchgAux:
    """The exchange of a batch with ``[n, k]`` host ``ids``, on ``device``,
    for the reduce mode ``PHOTON_XCHG_REDUCE`` selects: into the slot order
    of its gradient layout ``layout`` (host ``AlignedLayout``; ``aligned``)
    or into the feature-sorted stream of ``dim`` features (``cumsum``; no
    layout needed, ``order`` the stable argsort of the flat ids when the
    caller holds it).  The balanced route when the data permits it (unless
    ``force_colored``), else the colored route.  With ``vals``, a balanced
    or ``cumsum`` route also carries the values in destination order
    (:func:`bake_vals_dest`).  One-time host work: tens of seconds at 2^25
    entries."""
    global route_build_seconds
    _check_xchg_env()
    mode = xchg_reduce_mode()
    dev = resolve_device(device)
    ids = np.asarray(ids)
    n, k = ids.shape
    logging.getLogger("photon_tpu_torch.vperm").info(
        "building the xchg exchange route for %d entries (mode=%s)", ids.size, mode
    )
    t0 = time.monotonic()
    if mode == "cumsum":
        if dim is None:
            raise ValueError("the cumsum reduce needs dim (its feature bounds)")
        built = None if force_colored else build_balanced_sorted_route(
            ids, dim, order=order, device=dev)
        aux = (XchgAux(route=built[0], bounds=built[1]) if built is not None
               else build_xchg_sorted_route(ids, dim, order=order, device=dev))
    else:
        built = None if force_colored else build_balanced_aligned_route(
            layout, ids, dev
        )
        aux = XchgAux(route=built if built is not None
                      else build_xchg_route(layout, n, k, dev))
    route_build_seconds = time.monotonic() - t0
    if vals is not None:
        aux = bake_vals_dest(aux, vals)
    return aux


# Sample cap of the values fingerprint: the guard's host copy stays O(1).
_VALS_FP_SAMPLES = 65536


def _vals_fp_stride(size: int) -> int:
    """Stride spreading ``_VALS_FP_SAMPLES`` samples over the whole stream
    (ceil division, so a capped sample never covers only a prefix)."""
    return max(1, -(-size // _VALS_FP_SAMPLES))


def bake_vals_dest(aux: XchgAux, vals: np.ndarray) -> XchgAux:
    """Permute the static value stream into destination order once (the
    route's own passes) and attach it with its fingerprint; stored in the
    exchange's payload dtype (:func:`xchg_payload_dtype`), as the reference
    stores it.  A no-op on a colored ``aligned`` route, whose evaluation
    multiplies the row-major values before the exchange."""
    balanced = isinstance(aux.route, BalancedRoute)
    if not (balanced or aux.bounds is not None):
        return aux
    flat = np.ascontiguousarray(np.asarray(vals, np.float32).reshape(-1))
    x = _put(flat, aux.route.a1.device if balanced else aux.route.i1.device)
    vd = apply_balanced(x, aux.route) if balanced else apply_vperm(x, aux.route)
    vd = vd.to(xchg_payload_dtype())
    # A copy: on the CPU ``vals`` may share memory with the batch's tensor.
    fp = flat[::_vals_fp_stride(flat.size)].copy()
    return dataclasses.replace(aux, vals_dest=vd, vals_fp=fp)


def _aux_to_npz(aux: XchgAux) -> dict:
    """The route (and ``bounds``) as host arrays under the JAX package's
    keys: ``kind`` (2 balanced, 1 colored), ``meta`` and the index planes.
    Baked values are not stored (they follow the values, not the ids)."""
    out = {}
    r = aux.route
    if isinstance(r, BalancedRoute):
        out["kind"] = np.int64(2)
        out["meta"] = np.asarray([r.n_in, r.n_out, r.nc, r.ch, r.blk, r.cs_win,
                                  r.ds_win, r.k_expand], np.int64)
        names = ("a1", "a2", "a3", "b1", "b2", "b3")
    else:
        out["kind"] = np.int64(1)
        out["meta"] = np.asarray([r.n_in, r.n_out, r.nc, r.ch], np.int64)
        names = ("i1", "i2", "i3", "c", "i4", "i5", "i6")
    for name in names:
        v = getattr(r, name)
        if v is not None:
            out[name] = v.cpu().numpy()
    if aux.bounds is not None:
        out["bounds"] = aux.bounds.cpu().numpy()
    return out


def _aux_from_npz(z, device=None) -> XchgAux:
    """:func:`_aux_to_npz`'s inverse, on ``device``."""
    dev = resolve_device(device)

    def put(name):
        # A copy: the arrays may be read-only views (an npz member, a host
        # view of another package's array).
        return _put(np.array(z[name]), dev) if name in z else None

    if int(z["kind"]) == 2:
        n_in, n_out, nc, ch, blk, cs_win, ds_win, k_expand = (
            int(v) for v in z["meta"])
        route = BalancedRoute(
            n_in=n_in, n_out=n_out, nc=nc, ch=ch, blk=blk, cs_win=cs_win,
            ds_win=ds_win, k_expand=k_expand,
            **{name: put(name) for name in ("a1", "a2", "a3", "b1", "b2", "b3")},
        )
    else:
        n_in, n_out, nc, ch = (int(v) for v in z["meta"])
        route = VpermRoute(
            n_in=n_in, n_out=n_out, nc=nc, ch=ch,
            **{name: put(name) for name in ("i1", "i2", "i3", "c", "i4", "i5", "i6")},
        )
    return XchgAux(route=route, bounds=put("bounds"))


# -- the kernels --------------------------------------------------------------

# The element types the kernels move (a 4-byte and a 2-byte form each).
PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)


def _check_chunk_args(src: Tensor, i1: Tensor, i2: Tensor, i3: Tensor,
                      nc: int, ch: int, width: int) -> None:
    rows = nc * ch
    if src.shape != (rows, width) or i1.shape != (rows, LANES) or (
        i3.shape != (rows, LANES) or i2.shape != (nc * LANES, ch)
    ):
        raise ValueError(
            f"expected src [{rows}, {width}], i1/i3 [{rows}, {LANES}], i2 "
            f"[{nc * LANES}, {ch}]; got {tuple(src.shape)}, {tuple(i1.shape)}, "
            f"{tuple(i2.shape)}, {tuple(i3.shape)}"
        )
    if src.dtype not in PAYLOAD_DTYPES or i1.dtype != torch.int8 or (
        i3.dtype != torch.int8 or i2.dtype != torch.int16
    ):
        raise TypeError("src must be float32 or bfloat16, i1/i3 int8 and i2 int16")
    if not (src.device == i1.device == i2.device == i3.device):
        raise ValueError("inputs and index planes must share one device")


def _launch(name: str, fn_name: str, argtypes: list, *args) -> None:
    from photon_tpu_torch.ops import _build

    fn = getattr(_build.load("vperm"), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _build.check(fn(*args), name)


def _cuda_tensors(*ts: Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for contiguous
    CUDA tensors; raises otherwise."""
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the vperm kernels take contiguous tensors only")
    return True


# -- the two forms of K4 and K6 -------------------------------------------------

SMEM_BLOCK = 232_448         # shared memory a block may use on sm_90 (227 KB)
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is a non-portable cluster size
CH_LIMIT = 32767             # int16 i2 planes
# Scratch of a cluster-form block (csrc/vperm.cu): K4's 32 x 132 f32 y1
# tile; K6's barriers, ring of four 64 x 128 int8 slots and 64 x 130 int16
# i2 tile.
EXCHANGE_TILE = 32 * (LANES + 4) * 4
EXPAND_SCRATCH = 64 + 4 * 64 * LANES + 64 * (LANES + 2) * 2


def exchange_passes(ch: int, cl: int) -> int:
    """Passes of K4's exchange form at ``cl`` blocks a chunk: the fewest of
    1, 2, 4, 8 whose block holds two barriers, the stage-1 y1 tile (whose
    room then holds a pass's i3, ``rpp x 128`` int8), its ``128 / cl``
    columns of y1 over the chunk's ``ch`` rows (A, f32), and for one pass of
    ``rpp`` rows (its rows over ``passes``, rounded up to 8) their y2 (B,
    ``128 x pitch`` f32, the pitch ``rpp`` rounded up to 32) and the i2 of
    its columns over every block's pass rows (``128 x rpp`` int16); 0 when
    none fits."""
    for passes in (1, 2, 4, 8):
        q = 8 * passes
        rpp = -(-(-(-ch // cl)) // q) * q // passes
        pitch = -(-rpp // 32) * 32
        smem = (32 + max(EXCHANGE_TILE, rpp * LANES) + LANES // cl * ch * 4
                + LANES * pitch * 4 + LANES * rpp * 2)
        if smem <= SMEM_BLOCK:
            return passes
    return 0


def _selector_bits(width: int) -> int:
    """Bits a packed K6 lane selector ``i1 >> log2 k`` takes in the dz-tile
    form: log2(width) rounded up to 0, 1, 2, 4 or 8."""
    need = width.bit_length() - 1
    return need if need <= 2 else 4 if need <= 4 else 8


def cluster_fits(ch: int, width: int, cl: int) -> bool:
    """Whether the cluster form takes a chunk of ``ch`` rows (a multiple of
    8) at ``cl`` blocks: K4's exchange form for a 128-wide source (K4, and
    K6 at k = 1), else K6's dz-tile form, one block holding the chunk's dz
    rows and packed selectors (``4 * width + 16 * bits`` bytes a row)."""
    if ch % 8 or ch > CH_LIMIT:
        return False
    if width == LANES:
        return exchange_passes(ch, cl) > 0
    row = 4 * width + 16 * _selector_bits(width)
    return cl == 1 and EXPAND_SCRATCH + ch * row <= SMEM_BLOCK


def chunk_form(nc: int, ch: int, width: int) -> tuple[str, int]:
    """The shape rule between the two forms of K4 (``width`` 128) and K6
    (``width`` 128/k): ``("cluster", CL)``, else ``("global", 0)`` for a
    chunk that no cluster holds.  K4 takes the smallest CL of
    :data:`CLUSTER_SIZES` whose exchange runs in one pass, else the
    smallest that fits at all (2 MB chunks: 16 blocks, four passes); K6 one
    block when it holds the chunk's dz rows and selectors (the headline
    shape).  ch is a multiple of 8 on every route; the cluster form needs
    it.  Raises on a shape neither form takes."""
    if nc < 1 or ch < 1 or ch > CH_LIMIT:
        raise ValueError(f"no chunk form takes nc={nc}, ch={ch} (1 <= ch <= {CH_LIMIT})")
    if width < 1 or LANES % width or width & (width - 1):
        raise ValueError(f"src width {width} must be a power of two dividing {LANES}")
    if width == LANES:
        for cl in CLUSTER_SIZES:
            if ch % 8 == 0 and exchange_passes(ch, cl) == 1:
                return ("cluster", cl)
    for cl in CLUSTER_SIZES:
        if cluster_fits(ch, width, cl):
            return ("cluster", cl)
    return ("global", 0)


def max_active_clusters(ch: int, width: int, cl: int, bf16: bool = False) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster form (its 2-byte
    form with ``bf16``) at chunk height ``ch`` and cluster size ``cl``: how
    many such clusters the card runs at once (needs the card)."""
    from photon_tpu_torch.ops import _build

    fn = _build.load("vperm").photon_vperm_max_active_clusters
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    n = fn(0 if width == LANES else LANES // width, ch, cl, int(bf16))
    if n < 0:
        _build.check(-n, "vperm max_active_clusters")
    return n


def _aligned(*ts: Tensor) -> None:
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the cluster form takes 16-byte aligned tensors only")


def run_chunk_form(wrapper, form: tuple[str, int], src: Tensor, i1: Tensor,
                   i2: Tensor, i3: Tensor, nc: int, ch: int) -> Tensor:
    """Launch ``form`` (``("cluster", CL)`` or ``("global", 0)``) of the
    kernel behind ``wrapper`` (:func:`chunk_pass`: K4; :func:`chunk_expand_pass`:
    K6) on CUDA tensors, in the element type of ``src`` (float32, or
    bfloat16: the 2-byte form of the same geometry); counts the launch on
    the wrapper, in total, per form and (bf16) in ``bf16_launches``.
    :func:`chunk_form` picks the form a wrapper launches; this entry also
    lets a check run the other form.  Raises on CPU tensors."""
    kind, cl = form
    expand = wrapper is chunk_expand_pass
    if kind not in ("cluster", "global") or (kind == "cluster") != (cl in CLUSTER_SIZES):
        raise ValueError(f"unknown chunk form {form!r}")
    _check_chunk_args(src, i1, i2, i3, nc, ch, src.shape[1] if src.ndim == 2 else 0)
    if not expand and src.shape[1] != LANES:
        raise ValueError(f"K4 takes a [rows, {LANES}] source")
    if not _cuda_tensors(src, i1, i2, i3):
        raise ValueError("run_chunk_form launches a kernel: it takes CUDA tensors")
    out = torch.empty(nc * ch, LANES, dtype=src.dtype, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    ptrs = [t.data_ptr() for t in (src, i1, i2, i3, out)]
    k = LANES // src.shape[1]
    name = "vperm_chunk_expand" if expand else "vperm_chunk"
    fn = "photon_" + name + ("_cluster" if kind == "cluster" else "")
    bf16 = src.dtype == torch.bfloat16
    extra = (([k] if expand else []) + ([cl] if kind == "cluster" else [])
             + [int(bf16)])
    if kind == "cluster":
        _aligned(src, i1, i2, i3, out)
    wrapper.launches += 1
    wrapper.form_launches[kind] += 1
    wrapper.bf16_launches += bf16
    _launch(f"{name} ({kind} form)", fn,
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * (2 + len(extra)) + [ctypes.c_void_p],
            *ptrs, nc, ch, *extra, stream)
    return out


def chunk_pass_plain(x2d: Tensor, i1: Tensor, i2: Tensor, i3: Tensor,
                     nc: int, ch: int) -> Tensor:
    """Plain PyTorch K4: the JAX kernel's five stages, batched over the
    ``[nc, ch, 128]`` chunk view."""
    y = torch.take_along_dim(x2d.reshape(nc, ch, LANES),
                             i1.view(nc, ch, LANES).long(), dim=2)
    y = torch.take_along_dim(y.transpose(1, 2),
                             i2.view(nc, LANES, ch).long(), dim=2)
    y = torch.take_along_dim(y.transpose(1, 2),
                             i3.view(nc, ch, LANES).long(), dim=2)
    return y.reshape(nc * ch, LANES)


def chunk_pass(x2d: Tensor, i1: Tensor, i2: Tensor, i3: Tensor, nc: int,
               ch: int) -> Tensor:
    """K4: the micro-Clos within each ``[ch, 128]`` chunk of ``x2d``
    (``[nc * ch, 128]`` float32 or bfloat16): ``out[r, l] = x[r2, i1[r2, c]]`` with
    ``c = i3[r, l]`` and ``r2 = i2[c, r]``, all chunk-local.  Launches the
    form :func:`chunk_form` picks."""
    _check_chunk_args(x2d, i1, i2, i3, nc, ch, LANES)
    if not _cuda_tensors(x2d, i1, i2, i3):
        return chunk_pass_plain(x2d, i1, i2, i3, nc, ch)
    return run_chunk_form(chunk_pass, chunk_form(nc, ch, LANES),
                          x2d, i1, i2, i3, nc, ch)


chunk_pass.launches = 0
chunk_pass.form_launches = {"cluster": 0, "global": 0}
chunk_pass.bf16_launches = 0  # of launches, the 2-byte form's


def chunk_expand_pass_plain(dz2d: Tensor, i1: Tensor, i2: Tensor, i3: Tensor,
                            nc: int, ch: int) -> Tensor:
    """Plain PyTorch K6: the lane repeat, then :func:`chunk_pass_plain`."""
    k = LANES // dz2d.shape[1]
    return chunk_pass_plain(dz2d.repeat_interleave(k, dim=1), i1, i2, i3, nc, ch)


def chunk_expand_pass(dz2d: Tensor, i1: Tensor, i2: Tensor, i3: Tensor,
                      nc: int, ch: int) -> Tensor:
    """K6: :func:`chunk_pass` over the ``[nc * ch, 128]`` stream that repeats
    each element of ``dz2d`` (``[nc * ch, 128 / k]`` float32 or bfloat16) k times along
    the lanes, without writing that stream.  Launches the form
    :func:`chunk_form` picks."""
    width = dz2d.shape[1] if dz2d.ndim == 2 else 0
    if width < 1 or LANES % width or (width & (width - 1)):
        raise ValueError(f"dz tile width {width} must be a power of two dividing 128")
    _check_chunk_args(dz2d, i1, i2, i3, nc, ch, width)
    if not _cuda_tensors(dz2d, i1, i2, i3):
        return chunk_expand_pass_plain(dz2d, i1, i2, i3, nc, ch)
    return run_chunk_form(chunk_expand_pass, chunk_form(nc, ch, width),
                          dz2d, i1, i2, i3, nc, ch)


chunk_expand_pass.launches = 0
chunk_expand_pass.form_launches = {"cluster": 0, "global": 0}
chunk_expand_pass.bf16_launches = 0  # of launches, the 2-byte form's


def lane_pass_plain(x2d: Tensor, c: Tensor) -> Tensor:
    """Plain PyTorch K5."""
    return torch.take_along_dim(x2d, c.long(), dim=1)


def lane_pass(x2d: Tensor, c: Tensor) -> Tensor:
    """K5: ``out[r, l] = x[r, c[r, l]]`` over ``[rows, 128]`` (float32 or
    bfloat16 ``x2d``, int8 ``c``)."""
    if x2d.ndim != 2 or x2d.shape[1] != LANES or c.shape != x2d.shape:
        raise ValueError(
            f"x2d and c must be [rows, {LANES}], got {tuple(x2d.shape)} and "
            f"{tuple(c.shape)}"
        )
    if x2d.dtype not in PAYLOAD_DTYPES or c.dtype != torch.int8:
        raise TypeError("x2d must be float32 or bfloat16 and c int8")
    if x2d.device != c.device:
        raise ValueError("x2d and c must share one device")
    if not _cuda_tensors(x2d, c):
        return lane_pass_plain(x2d, c)
    out = torch.empty_like(x2d)
    bf16 = x2d.dtype == torch.bfloat16
    lane_pass.launches += 1
    lane_pass.bf16_launches += bf16
    _launch(
        "vperm_lane", "photon_vperm_lane",
        [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
        x2d.data_ptr(), c.data_ptr(), out.data_ptr(), x2d.shape[0], int(bf16),
        torch.cuda.current_stream(x2d.device).cuda_stream,
    )
    return out


lane_pass.launches = 0
lane_pass.bf16_launches = 0  # of launches, the 2-byte form's


# -- applying routes ----------------------------------------------------------

def apply_vperm(x: Tensor, route: VpermRoute) -> Tensor:
    """Apply a colored route to a flat ``[n_in]`` float32 or bfloat16 tensor: chunk pass
    R1, transpose ``[NC, CS] -> [CS, NC]``, the lane-packed middle pass,
    transpose back, chunk pass R2; ``[n_out]`` out.  NC == 1 runs R1 only."""
    nc, ch, cs, total = route.nc, route.ch, route.cs, route.total
    if x.shape != (route.n_in,):
        raise ValueError(f"shape {tuple(x.shape)} != routed n_in ({route.n_in},)")
    if total > route.n_in:
        x = torch.cat([x, x.new_zeros(total - route.n_in)])
    g = chunk_pass(x.reshape(nc * ch, LANES), route.i1, route.i2, route.i3,
                   nc, ch)
    if nc > 1:
        # The flat order of the [CS, NC] view is the packed [total/128, 128]
        # layout that _pack_middle indexed.
        t = g.view(nc, cs).T.contiguous().view(nc * ch, LANES)
        t = lane_pass(t, route.c)
        g = t.view(cs, nc).T.contiguous().view(nc * ch, LANES)
        g = chunk_pass(g, route.i4, route.i5, route.i6, nc, ch)
    return g.view(total)[:route.n_out]


def _balanced_tail(g: Tensor, route: BalancedRoute) -> Tensor:
    """The block transpose and stage B (K4), shared by both stage-A
    variants; ``[total]`` out."""
    nc, ch = route.nc, route.ch
    if nc > 1:
        g = g.view(nc, nc, route.blk).transpose(0, 1).contiguous()
        g = chunk_pass(g.view(nc * ch, LANES), route.b1, route.b2, route.b3,
                       nc, ch)
    return g.view(route.total)


def apply_balanced(x: Tensor, route: BalancedRoute) -> Tensor:
    """Row-major stream ``[n_in]`` -> padded slot-ordered stream ``[total]``
    (pads carry 0): each chunk is one source window front-packed plus a
    zero tail, then stage A (K4) and :func:`_balanced_tail`."""
    nc, ch, cs, cs_win = route.nc, route.ch, route.cs, route.cs_win
    if x.shape != (route.n_in,):
        raise ValueError(f"shape {tuple(x.shape)} != routed n_in ({route.n_in},)")
    if nc * cs_win > route.n_in:
        x = torch.cat([x, x.new_zeros(nc * cs_win - route.n_in)])
    g = F.pad(x.view(nc, cs_win), (0, cs - cs_win)).view(nc * ch, LANES)
    g = chunk_pass(g, route.a1, route.a2, route.a3, nc, ch)
    return _balanced_tail(g, route)


def apply_balanced_dz(dz: Tensor, route: BalancedRoute) -> Tensor:
    """The per-evaluation exchange with the dz expansion inside stage A
    (K6): moves the ``[n]`` dz vector instead of an E-element stream.  Needs
    ``route.k_expand``."""
    nc, ch, cs, k = route.nc, route.ch, route.cs, route.k_expand
    if not k:
        raise ValueError("route was built without k_expand")
    rows_win = route.cs_win // k
    if dz.shape[0] * k != route.n_in:
        raise ValueError(f"dz length {dz.shape[0]} != n_in / {k}")
    if nc * rows_win > dz.shape[0]:
        dz = torch.cat([dz, dz.new_zeros(nc * rows_win - dz.shape[0])])
    dz2d = F.pad(dz.view(nc, rows_win), (0, cs // k - rows_win))
    g = chunk_expand_pass(dz2d.view(nc * ch, LANES // k), route.a1, route.a2,
                          route.a3, nc, ch)
    return _balanced_tail(g, route)


# -- the xchg gradient --------------------------------------------------------

# vals tensors already held to an aux's fingerprint:
# id(vals) -> (weak reference, tensor version, the fingerprint array).
_CHECKED_VALS: dict[int, tuple[weakref.ref, int, np.ndarray]] = {}


def _check_baked_vals(aux: XchgAux, vals: Tensor) -> None:
    """Raise when ``vals`` is not the value array ``aux`` was baked from.

    The strided sample is compared element by element (a collapsed norm
    would miss swapped values), within the reference's ``rtol=1e-2,
    atol=1e-6``: ``batch_astype`` may have re-stored the values in bf16
    after the attach (its rounding is ~2^-9 relative), while the
    fingerprint keeps the float32 values the attach saw.  The sample costs
    a device-to-host copy, so it is taken at the first call on each
    ``vals`` tensor and again after the tensor is changed in place; an
    optimizer evaluates one batch many times."""
    key = id(vals)
    seen = _CHECKED_VALS.get(key)
    if (seen is not None and seen[0]() is vals and seen[1] == vals._version
            and seen[2] is aux.vals_fp):
        return
    flat = vals.reshape(-1)
    sample = flat[::_vals_fp_stride(flat.shape[0])].float().cpu().numpy()
    if sample.shape != aux.vals_fp.shape or not np.allclose(
            sample, aux.vals_fp, rtol=1e-2, atol=1e-6):
        raise ValueError(
            "xchg aux has values BAKED at attach time (vals_dest), but the "
            "vals passed here differ from what the attach saw; re-attach "
            "(build_xchg_aux(..., vals=...)) after re-weighting values"
        )
    ref = weakref.ref(vals, lambda _, key=key: _CHECKED_VALS.pop(key, None))
    _CHECKED_VALS[key] = (ref, vals._version, aux.vals_fp)


def _exchange(per_row: Tensor, vals_rowmajor: Tensor, aux: XchgAux) -> Tensor:
    """The per-entry products ``per_row[row_e] * val_e`` carried into the
    route's destination order, before any repack: ``[total]`` on a balanced
    route (chunk fronts and zero tails), ``[n_out]`` on a colored one.

    On a balanced route with baked values and k dividing 128: K6 expands dz
    inside stage A, the block transpose, K4 (stage B), the multiply by
    ``vals_dest``.  Otherwise the row-major stream (products, or dz repeated
    when the values are baked) rides the route's passes.  With baked values,
    ``vals_rowmajor`` must be the value array the attach saw (checked).

    The stream moves in :func:`xchg_payload_dtype`, as in
    ``photon_tpu/ops/vperm.py:1258-1310``: dz or the stream is cast to it before the
    passes, and the moved stream and the baked values both widen to
    float32 before their multiply (a bf16 product of two rounded operands
    would round a third time).  The result is float32."""
    _check_xchg_env()
    payload = xchg_payload_dtype()
    baked = aux.vals_dest is not None
    if baked:
        _check_baked_vals(aux, vals_rowmajor)
    route = aux.route
    balanced = isinstance(route, BalancedRoute)
    if balanced and route.k_expand and baked:
        moved = apply_balanced_dz(per_row.float().to(payload), route)
    else:
        if baked:
            stream = per_row.float().repeat_interleave(vals_rowmajor.shape[1])
        else:
            stream = (per_row[:, None] * vals_rowmajor).float().reshape(-1)
        stream = stream.to(payload)
        moved = (apply_balanced(stream, route) if balanced
                 else apply_vperm(stream, route))
    if baked:
        # The baked values widen inside the multiply (type promotion).
        return moved.float() * aux.vals_dest
    return moved.float()


def xchg_slot_products(per_row: Tensor, vals_rowmajor: Tensor,
                       aux: XchgAux) -> Tensor:
    """The slot stream ``per_row[row_s] * val_s`` of the aligned layout the
    route was built for (``[n_slots]``, zeros in pad slots), without a
    gather: exactly what the ``pallas`` route forms as ``per_row[rows] *
    vals``, bit for bit (:func:`_exchange`, then on a balanced route the
    repack of the chunk fronts into the contiguous slot stream).  An
    ``aligned`` route only."""
    if aux.bounds is not None:
        raise ValueError("a cumsum route carries no slot stream")
    moved = _exchange(per_row, vals_rowmajor, aux)
    route = aux.route
    if isinstance(route, BalancedRoute):
        moved = (moved.view(route.nc, route.cs)[:, :route.ds_win]
                 .reshape(-1)[:route.n_out])
    return moved


def xchg_segment_grad(per_row: Tensor, vals_rowmajor: Tensor, al,
                      aux: XchgAux, dim: int) -> Tensor:
    """``g[f] = sum_e per_row[row_e] * val_e``, the ``xchg`` backward.

    ``aligned`` route: the slot products of :func:`xchg_slot_products`
    folded by the aligned reduce (K2 and the epilogue) over the gradient
    layout ``al`` (``AlignedLayoutDev``).  ``cumsum`` route (``aux.bounds``
    set; ``al`` unused, may be None): the sorted stream's compensated
    prefix scan (:func:`compensated_scan`, CS) with a zero prepended, read
    at ``bounds``; each feature's ``hi`` and ``lo`` differences are formed
    before they are added, so a small gradient is not lost in the rounding
    of a large running sum."""
    if aux.bounds is None:
        from photon_tpu_torch.ops.slab_reduce import aligned_reduce

        pv = xchg_slot_products(per_row, vals_rowmajor, aux)
        return aligned_reduce(pv.reshape(al.lo.shape), al, dim)
    if aux.bounds.shape != (dim + 1,):
        raise ValueError(f"bounds {tuple(aux.bounds.shape)} != ({dim + 1},)")
    moved = _exchange(per_row, vals_rowmajor, aux)
    hi, lo = compensated_scan(moved)
    zero = hi.new_zeros(1)
    bounds = aux.bounds.long()
    bh = torch.cat([zero, hi]).index_select(0, bounds)
    bl = torch.cat([zero, lo]).index_select(0, bounds)
    return (bh[1:] - bh[:-1]) + (bl[1:] - bl[:-1])


# -- the compensated scan -----------------------------------------------------

def compensated_cumsum(x: Tensor) -> tuple[Tensor, Tensor]:
    """Inclusive prefix sum of a flat float32 ``x`` as a ``(hi, lo)`` pair of
    float32 tensors whose sum carries about 48 bits: the error of the running
    sum stays bounded by the pair's precision instead of growing with the
    prefix magnitude.

    Counterpart of ``_compensated_cumsum`` (an ``associative_scan`` with the
    same two-sum combine, Dekker/Knuth) in ``photon_tpu/ops/vperm.py``, the
    scan of the ``cumsum`` reduce mode: a log-step (Hillis-Steele) scan in
    torch ops, ceil(log2 n) passes over the stream.  It is the plain version
    of the CS kernel (:func:`compensated_scan`).  The scans combine in
    different orders, so they agree to the pair's precision, not bit for
    bit."""
    if x.ndim != 1 or x.dtype != torch.float32:
        raise ValueError("compensated_cumsum takes a flat float32 tensor")
    hi, lo = x, torch.zeros_like(x)
    step = 1
    while step < x.numel():
        a_hi, a_lo = hi[:-step], lo[:-step]  # the prefix ending `step` earlier
        b_hi, b_lo = hi[step:], lo[step:]
        s = a_hi + b_hi
        z = s - a_hi
        err = (a_hi - (s - z)) + (b_hi - z)
        hi = torch.cat([hi[:step], s])
        lo = torch.cat([lo[:step], err + a_lo + b_lo])
        step *= 2
    return hi, lo


SCAN_THREADS = 256       # CS: threads a block
SCAN_ITEMS = 16          # CS: consecutive elements a thread
SCAN_TILE = SCAN_THREADS * SCAN_ITEMS


def compensated_scan(x: Tensor) -> tuple[Tensor, Tensor]:
    """CS: the inclusive compensated prefix sum of a flat float32 ``x`` as a
    ``(hi, lo)`` pair (the combine of :func:`compensated_cumsum`).

    CUDA tensors launch ``csrc/compensated_scan.cu`` (three passes: tile
    aggregates, one block scanning them, each tile rescanned from its
    prefix); CPU tensors take :func:`compensated_cumsum`.  The two combine
    in different orders and agree to the pair's precision, not bit for
    bit."""
    if x.ndim != 1 or x.dtype != torch.float32:
        raise ValueError("compensated_scan takes a flat float32 tensor")
    if not _cuda_tensors(x):
        return compensated_cumsum(x)
    from photon_tpu_torch.ops import _build

    n = x.shape[0]
    hi = torch.empty_like(x)
    lo = torch.empty_like(x)
    if n == 0:
        return hi, lo
    tiles = -(-n // SCAN_TILE)
    scratch = torch.empty(4 * tiles, dtype=torch.float32, device=x.device)
    fn = _build.load("compensated_scan").photon_compensated_scan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    compensated_scan.launches += 1
    _build.check(
        fn(x.data_ptr(), n, hi.data_ptr(), lo.data_ptr(), scratch.data_ptr(),
           torch.cuda.current_stream(x.device).cuda_stream),
        "compensated_scan",
    )
    return hi, lo


compensated_scan.launches = 0
