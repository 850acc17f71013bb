"""vperm: static permutations of the sparse GLM's entry stream, routed once on
the host and applied by three permutation kernels; the ``xchg`` route.

Counterpart of ``photon_tpu/ops/vperm.py`` in the reduce mode the JAX package
takes by default (``PHOTON_XCHG_REDUCE=aligned``).  The ``xchg`` gradient
``g[f] = sum_e per_row[row_e] * val_e`` reduces slot products over the
batch's slab-aligned layout through the position-reduce (K2,
``ops/slab_reduce.py``), as the ``pallas`` route does; where the ``pallas``
route gathers ``per_row[rows]`` for every slot at every step, ``xchg``
carries the row-major stream into slot order through a permutation routed
once on the host.

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
(``ops/clos.py``).  The kernels (``ops/csrc/vperm.cu``):

- K4 :func:`chunk_pass` (``_chunk_kernel``): R1 and R2, stages A (for the
  value bake) and B;
- K5 :func:`lane_pass` (``_lane_kernel``): the colored route's middle stage;
- K6 :func:`chunk_expand_pass` (``_chunk_expand_kernel``): stage A with the
  dz repeat.

Each launches on CUDA tensors and takes its plain PyTorch version on CPU
tensors; both are pure data movement and equal bit for bit.  Index planes are
int8 (lanes) and int16 (chunk rows) tensors on the route's device.

Not ported (``ROADMAP.md`` queue 2): the ``cumsum`` reduce mode
(``PHOTON_XCHG_REDUCE=cumsum``, the compensated prefix scan over the
feature-sorted stream) and the bf16 payload (``PHOTON_XCHG_DTYPE=bfloat16``)
raise ``NotImplementedError``; the route disk cache and the sharded,
stacked routes (``balanced_blk_census``) are not carried.
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
_QUEUE = "ROADMAP.md queue 2 (xchg follow-ups)"

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
    into the aligned layout's slot order.  On a balanced route,
    ``vals_dest`` is the static value stream already in slot order (baked
    at attach, one K4 pass), so each evaluation moves only dz, and
    ``vals_fp`` a strided sample of the row-major values it was baked from,
    which :func:`xchg_segment_grad` holds the caller's values to."""

    route: Union[VpermRoute, BalancedRoute]
    vals_dest: Optional[Tensor] = None
    vals_fp: Optional[np.ndarray] = None

    def to(self, device) -> "XchgAux":
        return dataclasses.replace(
            self, route=self.route.to(device),
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
                         device) -> Optional[BalancedRoute]:
    """Factor an exchange into the balanced form, for a destination stream
    that tolerates zero pads between real entries.

    ``dest_src[d]`` is the row-major source index feeding destination ``d``
    (< 0 for pad destinations; each source at most once); ``n_src_stream``
    is the full row-major stream length (n * k).  Returns None when the
    data defeats the balance assumption or the geometry limits (the caller
    falls back to the colored route).
    """
    win = _balanced_windows(dest_src, n_src_stream, k)
    if win is None:
        return None
    nc, cs_win, ds_win, k_expand, d_real, src_of, src_win, dest_win, blk = win
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


def build_balanced_aligned_route(layout, ids: np.ndarray,
                                 device=None) -> Optional[BalancedRoute]:
    """The balanced route of the row-major stream into ``layout``'s slot
    order (slot pads pair with zero-valued unused sources by chunk-local
    completion); None -> the colored route."""
    k = int(ids.shape[-1]) if ids.ndim == 2 else 0
    slots_src = np.ascontiguousarray(layout.src.reshape(-1), dtype=np.int64)
    return _build_balanced_core(
        slots_src, int(ids.size), k, resolve_device(device)
    )


def _check_xchg_env() -> None:
    """Refuse the JAX package's xchg variants the port does not carry."""
    mode = os.environ.get("PHOTON_XCHG_REDUCE", "aligned")
    if mode == "cumsum":
        raise NotImplementedError(
            "PHOTON_XCHG_REDUCE=cumsum (the compensated prefix-scan reduce) "
            f"is not ported; it waits in {_QUEUE}"
        )
    if mode != "aligned":
        raise ValueError(f"PHOTON_XCHG_REDUCE={mode!r}; the port supports aligned")
    dtype = os.environ.get("PHOTON_XCHG_DTYPE", "float32")
    if dtype == "bfloat16":
        raise NotImplementedError(
            "PHOTON_XCHG_DTYPE=bfloat16 (the half-width exchange payload) "
            f"is not ported; it waits in {_QUEUE}"
        )
    if dtype != "float32":
        raise ValueError(f"PHOTON_XCHG_DTYPE={dtype!r}; the port supports float32")


def build_xchg_aux(layout, ids: np.ndarray, vals: Optional[np.ndarray] = None,
                   force_colored: bool = False, device=None) -> XchgAux:
    """The exchange of a batch with ``[n, k]`` host ``ids`` into the slot
    order of its gradient layout ``layout`` (host ``AlignedLayout``), on
    ``device``: the balanced route when the data permits it (unless
    ``force_colored``), else the colored route.  With ``vals``, a balanced
    route also carries the values in slot order (:func:`bake_vals_dest`).
    One-time host work: tens of seconds at 2^25 entries."""
    global route_build_seconds
    _check_xchg_env()
    dev = resolve_device(device)
    n, k = ids.shape
    logging.getLogger("photon_tpu_torch.vperm").info(
        "building the xchg exchange route for %d entries", ids.size
    )
    t0 = time.monotonic()
    built = None if force_colored else build_balanced_aligned_route(
        layout, np.asarray(ids), dev
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
    """Permute the static value stream into slot order once (K4 through
    stage A, the block transpose and stage B) and attach it with its
    fingerprint.  A no-op on a colored route, whose evaluation multiplies
    the row-major values before the exchange."""
    if not isinstance(aux.route, BalancedRoute):
        return aux
    flat = np.ascontiguousarray(np.asarray(vals, np.float32).reshape(-1))
    vd = apply_balanced(_put(flat, aux.route.a1.device), aux.route)
    # A copy: on the CPU ``vals`` may share memory with the batch's tensor.
    fp = flat[::_vals_fp_stride(flat.size)].copy()
    return dataclasses.replace(aux, vals_dest=vd, vals_fp=fp)


# -- the kernels --------------------------------------------------------------

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
    if src.dtype != torch.float32 or i1.dtype != torch.int8 or (
        i3.dtype != torch.int8 or i2.dtype != torch.int16
    ):
        raise TypeError("src must be float32, i1/i3 int8 and i2 int16")
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
    (``[nc * ch, 128]`` float32): ``out[r, l] = x[r2, i1[r2, c]]`` with
    ``c = i3[r, l]`` and ``r2 = i2[c, r]``, all chunk-local."""
    _check_chunk_args(x2d, i1, i2, i3, nc, ch, LANES)
    if not _cuda_tensors(x2d, i1, i2, i3):
        return chunk_pass_plain(x2d, i1, i2, i3, nc, ch)
    out = torch.empty_like(x2d)
    chunk_pass.launches += 1
    _launch(
        "vperm_chunk", "photon_vperm_chunk",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        x2d.data_ptr(), i1.data_ptr(), i2.data_ptr(), i3.data_ptr(),
        out.data_ptr(), nc, ch, torch.cuda.current_stream(x2d.device).cuda_stream,
    )
    return out


chunk_pass.launches = 0


def chunk_expand_pass_plain(dz2d: Tensor, i1: Tensor, i2: Tensor, i3: Tensor,
                            nc: int, ch: int) -> Tensor:
    """Plain PyTorch K6: the lane repeat, then :func:`chunk_pass_plain`."""
    k = LANES // dz2d.shape[1]
    return chunk_pass_plain(dz2d.repeat_interleave(k, dim=1), i1, i2, i3, nc, ch)


def chunk_expand_pass(dz2d: Tensor, i1: Tensor, i2: Tensor, i3: Tensor,
                      nc: int, ch: int) -> Tensor:
    """K6: :func:`chunk_pass` over the ``[nc * ch, 128]`` stream that repeats
    each element of ``dz2d`` (``[nc * ch, 128 / k]`` float32) k times along
    the lanes, without writing that stream."""
    width = dz2d.shape[1] if dz2d.ndim == 2 else 0
    if width < 1 or LANES % width or (width & (width - 1)):
        raise ValueError(f"dz tile width {width} must be a power of two dividing 128")
    _check_chunk_args(dz2d, i1, i2, i3, nc, ch, width)
    if not _cuda_tensors(dz2d, i1, i2, i3):
        return chunk_expand_pass_plain(dz2d, i1, i2, i3, nc, ch)
    out = torch.empty(nc * ch, LANES, dtype=torch.float32, device=dz2d.device)
    chunk_expand_pass.launches += 1
    _launch(
        "vperm_chunk_expand", "photon_vperm_chunk_expand",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        dz2d.data_ptr(), i1.data_ptr(), i2.data_ptr(), i3.data_ptr(),
        out.data_ptr(), nc, ch, LANES // width,
        torch.cuda.current_stream(dz2d.device).cuda_stream,
    )
    return out


chunk_expand_pass.launches = 0


def lane_pass_plain(x2d: Tensor, c: Tensor) -> Tensor:
    """Plain PyTorch K5."""
    return torch.take_along_dim(x2d, c.long(), dim=1)


def lane_pass(x2d: Tensor, c: Tensor) -> Tensor:
    """K5: ``out[r, l] = x[r, c[r, l]]`` over ``[rows, 128]`` (float32
    ``x2d``, int8 ``c``)."""
    if x2d.ndim != 2 or x2d.shape[1] != LANES or c.shape != x2d.shape:
        raise ValueError(
            f"x2d and c must be [rows, {LANES}], got {tuple(x2d.shape)} and "
            f"{tuple(c.shape)}"
        )
    if x2d.dtype != torch.float32 or c.dtype != torch.int8:
        raise TypeError("x2d must be float32 and c int8")
    if x2d.device != c.device:
        raise ValueError("x2d and c must share one device")
    if not _cuda_tensors(x2d, c):
        return lane_pass_plain(x2d, c)
    out = torch.empty_like(x2d)
    lane_pass.launches += 1
    _launch(
        "vperm_lane", "photon_vperm_lane",
        [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p],
        x2d.data_ptr(), c.data_ptr(), out.data_ptr(), x2d.shape[0],
        torch.cuda.current_stream(x2d.device).cuda_stream,
    )
    return out


lane_pass.launches = 0


# -- applying routes ----------------------------------------------------------

def apply_vperm(x: Tensor, route: VpermRoute) -> Tensor:
    """Apply a colored route to a flat ``[n_in]`` float32 tensor: chunk pass
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
    would miss swapped values) and exactly: the port stores values in
    float32 only.  The sample costs a device-to-host copy, so it is taken
    at the first call on each ``vals`` tensor and again after the tensor is
    changed in place; an optimizer evaluates one batch many times."""
    key = id(vals)
    seen = _CHECKED_VALS.get(key)
    if (seen is not None and seen[0]() is vals and seen[1] == vals._version
            and seen[2] is aux.vals_fp):
        return
    flat = vals.reshape(-1)
    sample = flat[::_vals_fp_stride(flat.shape[0])].float().cpu().numpy()
    if not np.array_equal(sample, aux.vals_fp):
        raise ValueError(
            "xchg aux has values BAKED at attach time (vals_dest), but the "
            "vals passed here differ from what the attach saw; re-attach "
            "(build_xchg_aux(..., vals=...)) after re-weighting values"
        )
    ref = weakref.ref(vals, lambda _, key=key: _CHECKED_VALS.pop(key, None))
    _CHECKED_VALS[key] = (ref, vals._version, aux.vals_fp)


def xchg_slot_products(per_row: Tensor, vals_rowmajor: Tensor,
                       aux: XchgAux) -> Tensor:
    """The slot stream ``per_row[row_s] * val_s`` of the aligned layout the
    route was built for (``[n_slots]``, zeros in pad slots), without a
    gather: exactly what the ``pallas`` route forms as ``per_row[rows] *
    vals``, bit for bit.

    On a balanced route with baked values and k dividing 128: K6 expands
    dz inside stage A, the block transpose, K4 (stage B), the repack of the
    chunk fronts, the multiply by ``vals_dest``.  Otherwise the row-major
    stream (products, or dz repeated when the values are baked) rides the
    route's passes.  With baked values, ``vals_rowmajor`` must be the value
    array the attach saw (checked).
    """
    _check_xchg_env()
    baked = aux.vals_dest is not None
    if baked:
        _check_baked_vals(aux, vals_rowmajor)
    route = aux.route
    balanced = isinstance(route, BalancedRoute)
    if balanced and route.k_expand and baked:
        moved = apply_balanced_dz(per_row, route)
    else:
        if baked:
            stream = per_row.repeat_interleave(vals_rowmajor.shape[1])
        else:
            stream = (per_row[:, None] * vals_rowmajor).reshape(-1)
        moved = (apply_balanced(stream, route) if balanced
                 else apply_vperm(stream, route))
    if baked:
        moved = moved * aux.vals_dest
    if balanced:
        # Repack the chunk fronts into the contiguous slot stream.
        moved = (moved.view(route.nc, route.cs)[:, :route.ds_win]
                 .reshape(-1)[:route.n_out])
    return moved


def xchg_segment_grad(per_row: Tensor, vals_rowmajor: Tensor, al,
                      aux: XchgAux, dim: int) -> Tensor:
    """``g[f] = sum_e per_row[row_e] * val_e``, the ``xchg`` backward: the
    slot products of :func:`xchg_slot_products` folded by the aligned
    reduce (K2 and the epilogue) over the gradient layout ``al``
    (``AlignedLayoutDev``)."""
    from photon_tpu_torch.ops.slab_reduce import aligned_reduce

    pv = xchg_slot_products(per_row, vals_rowmajor, aux)
    return aligned_reduce(pv.reshape(al.lo.shape), al, dim)
