"""Tiled score tables and the chunk streamer (out-of-core GAME, host tier).

Counterpart of the host-tier half of ``photon_tpu/game/tiles.py``.  The
resident engines (``game/residuals.py``) hold one stacked ``[C, n]`` score
table on the device; this module is its out-of-core form.  Rows are cut
into fixed-size **chunks**, the score table becomes per-chunk ``[C,
rows_k]`` **tiles** in host memory, and per-chunk Neumaier partials
``(total_k, comp_k)`` concatenate to exactly the global compensated total
the resident engine keeps: the Neumaier scan runs over the coordinate axis
row by row, so the chunk partition cannot change a value.  The host
arithmetic (partials, digests, the float64 cross-chunk accumulator) is the
reference's numpy code, so the tile digests of either package hash the
same bytes and a checkpoint written by one passes the other's check.

:class:`ChunkStreamer` is the transport, an adapter over the streamed
GLM's ``data/streaming.stream_chunks``.  Chunk ``k+1``'s host slice is made
into tensors (pinned when the target is a card) on the host-IO pool, then
copied ``non_blocking`` on a side CUDA stream while chunk ``k``'s kernels
run (one event wait a chunk on the compute stream, ``record_stream`` on
every copied tensor).  A ``DeviceWindow`` holds the card to the
``(PREFETCH_DEPTH + 1)``-chunk bound the budget helpers divide by; the
read-ahead beyond it lives in pinned host memory.
``stream.stall_s{tier=h2d}`` is the consumer's wall time blocked waiting
for a chunk, ``stream.prefetch_overlap_s{tier=h2d}`` the load time hidden
behind compute.

The disk tier (``game/tile_store.py`` part files): a budgeted LRU
:class:`HostTileCache` between the store and the streamer
(``--max-host-mb``), :func:`spill_dataset` writing the feature chunks once,
a :class:`SpilledChunkSource` whose disk reads run ahead of the chunk
pipeline on the ``tile-prefetch`` pool, and :class:`SpilledScoreTable`
tiles written back to the store once a sweep.  A spilled chunk's arrays
enter the same pinned path as a host-resident one, and the three-chunk
device window is unchanged: the cache's budget counts its own numpy
entries, not the pinned buffers or the window.  ``stream.stall_s`` and
``stream.prefetch_overlap_s`` carry ``tier=disk`` for the disk stage.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.game import lowp
from photon_tpu_torch.game.tile_store import FEATURES as FEAT_KIND
from photon_tpu_torch.game.tile_store import TILES as TILE_KIND
from photon_tpu_torch.game.tile_store import codec_roundtrip
from photon_tpu_torch.telemetry import NULL_SESSION

# The residual table's part files (``tile-residuals-NNNNNN.pt``): the table's
# telemetry path is in the file name, so two spilled tables sharing a store
# never overwrite each other's tiles.
RESIDUAL_TILE_KIND = f"{TILE_KIND}-residuals"

# Chunks the reference keeps in flight beyond the one being consumed.  The
# device-memory bound every budget computation uses is (PREFETCH_DEPTH + 1)
# chunks: the port holds the consumed chunk, the one staged behind it and
# the one being copied, and reads further ahead in host memory.
PREFETCH_DEPTH = 2


# ---------------------------------------------------------------------------
# Chunk plan + memory budget
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Fixed-size row partition: chunk ``k`` covers rows
    ``[k * chunk_rows, min(n, (k+1) * chunk_rows))``.  The last chunk may be
    partial; a ``chunk_rows >= n`` plan degenerates to one chunk."""

    n: int
    chunk_rows: int

    def __post_init__(self):
        if self.n < 0:
            raise ValueError(f"negative row count {self.n}")
        if self.chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {self.chunk_rows}")

    @property
    def num_chunks(self) -> int:
        return max(1, -(-self.n // self.chunk_rows))

    def bounds(self, k: int) -> tuple[int, int]:
        if not 0 <= k < self.num_chunks:
            raise IndexError(f"chunk {k} out of range [0, {self.num_chunks})")
        lo = k * self.chunk_rows
        return lo, min(self.n, lo + self.chunk_rows)

    def rows(self, k: int) -> int:
        lo, hi = self.bounds(k)
        return hi - lo


def per_row_bytes(data) -> int:
    """Bytes one dataset row occupies across every feature shard plus the
    per-row scalars: the unit the chunk budget divides by."""
    from photon_tpu_torch.game.data import DenseShard

    total = 12  # label + offset + weight (f32 each)
    for shard in data.shards.values():
        if isinstance(shard, DenseShard):
            total += shard.x.dtype.itemsize * shard.x.shape[1]
        else:
            total += (
                shard.ids.dtype.itemsize + shard.vals.dtype.itemsize
            ) * shard.ids.shape[1]
    return total


def resident_bytes_estimate(data, n_coordinates: int = 2) -> int:
    """Device bytes a resident GAME fit would hold for this dataset: the
    training feature blocks, the scoring copy, and the two stacked ``[C,
    n]`` float32 score tables (residual and validation).  A lower bound
    (bin padding and solver workspace ride on top), the right direction
    for ``--max-resident-mb``: an estimate over the budget always streams."""
    n = data.num_examples
    return 2 * per_row_bytes(data) * n + 2 * max(1, n_coordinates) * n * 4


def stream_host_bytes_estimate(data, n_coordinates: int = 2) -> int:
    """Host bytes the streamed fit pins: the feature chunks (the dataset
    rows) plus the ``[C, rows]`` float32 residual tiles."""
    n = data.num_examples
    return per_row_bytes(data) * n + max(1, n_coordinates) * n * 4


def chunk_rows_for_budget(data, max_resident_mb: float) -> int:
    """Chunk size whose in-flight window (``PREFETCH_DEPTH + 1`` chunks)
    fits the device budget."""
    if max_resident_mb <= 0:
        raise ValueError(f"max_resident_mb must be > 0, got {max_resident_mb}")
    budget = int(max_resident_mb * (1 << 20))
    rows = budget // ((PREFETCH_DEPTH + 1) * max(1, per_row_bytes(data)))
    return max(1, min(int(rows), max(1, data.num_examples)))


def slice_rows(data, lo: int, hi: int):
    """Contiguous row window ``[lo, hi)`` of a GameDataset as numpy views."""
    from photon_tpu_torch.game.data import DenseShard, GameDataset, SparseShard

    def cut(shard):
        if isinstance(shard, DenseShard):
            return DenseShard(shard.x[lo:hi])
        return SparseShard(shard.ids[lo:hi], shard.vals[lo:hi], shard.dim_)

    return GameDataset(
        label=data.label[lo:hi],
        offset=data.offset[lo:hi],
        weight=data.weight[lo:hi],
        shards={name: cut(s) for name, s in data.shards.items()},
        id_columns={name: c[lo:hi] for name, c in data.id_columns.items()},
    )


class ResidentChunkSource:
    """Chunk features as numpy views over the host-resident dataset."""

    tier = "host"

    def __init__(self, data, plan: ChunkPlan):
        self.data = data
        self.plan = plan

    def chunk(self, k: int):
        lo, hi = self.plan.bounds(k)
        return slice_rows(self.data, lo, hi)


# ---------------------------------------------------------------------------
# The chunk streamer
# ---------------------------------------------------------------------------


def host_tensors(payload, pin: bool):
    """A host payload (tuples, named tuples and lists of numpy arrays) as CPU
    tensors, copied into pinned memory when the target is a card (so the
    upload can run beside the compute).  bf16 feature bits
    (``game/lowp.py``) become ``torch.bfloat16`` tensors, 2 bytes a value."""
    if isinstance(payload, np.ndarray):
        if lowp.is_bf16_bits(payload):
            t = lowp.feature_tensor(payload)
        else:
            t = torch.from_numpy(np.require(payload, requirements=["C", "W"]))
        return t.pin_memory() if pin else t
    if isinstance(payload, tuple):
        items = [host_tensors(v, pin) for v in payload]
        return type(payload)(*items) if hasattr(payload, "_fields") else tuple(items)
    if isinstance(payload, list):
        return [host_tensors(v, pin) for v in payload]
    return payload


class HostBuffer:
    """A float32 host buffer that device results are copied into
    ``non_blocking`` (``buf[...].copy_(t, non_blocking=True)``, pinned on a
    card) and read once, after a pass: a streamed pass's one wait."""

    def __init__(self, shape, device: torch.device):
        self.device = device
        self.buf = torch.empty(shape, dtype=torch.float32,
                               pin_memory=device.type == "cuda")

    def read(self) -> np.ndarray:
        if self.device.type == "cuda":
            # host-sync: the pass's one wait, for its results copied into
            # the pinned buffer.
            torch.cuda.current_stream(self.device).synchronize()
        # host-sync: a CPU view of the synchronized host buffer.
        return self.buf.numpy()


class ChunkStreamer:
    """Ordered chunk iteration for the streamed descent: a thin adapter over
    :func:`~photon_tpu_torch.data.streaming.stream_chunks`.

    ``stream(load_chunk, num_chunks)`` yields ``load_chunk(k)``'s payload
    (a tuple, named tuple or list of numpy arrays) on ``device`` in order.
    ``load_chunk`` runs on the host-IO pool, at most ``prefetch`` chunks
    ahead of the consumer; its arrays become tensors there (pinned for a
    card).  On a card each chunk is copied on a side stream while the
    chunk before it computes, and a :class:`~photon_tpu_torch.data.
    streaming.DeviceWindow` holds the card to ``PREFETCH_DEPTH + 1``
    chunks: the read-ahead beyond them waits in pinned host memory.

    Telemetry, shared across every pass this streamer drives:
    ``stream.stall_s{tier=h2d}`` (consumer wall time blocked waiting for a
    chunk), ``stream.prefetch_overlap_s{tier=h2d}`` (load seconds hidden
    behind compute), ``stream.chunks`` (chunks delivered), and
    ``peak_in_flight_bytes``, the high-water device residency of chunks (on
    a card the window's, measured from its events; on the CPU the chunk
    being consumed).  The descent exports it as the
    ``residuals.device_bytes`` gauge."""

    def __init__(self, telemetry=None, prefetch: Optional[int] = None,
                 device=None):
        from photon_tpu_torch.data.streaming import DeviceWindow
        from photon_tpu_torch.utils.io_pool import io_threads

        self.telemetry = telemetry or NULL_SESSION
        self.device = torch.device("cpu") if device is None else torch.device(device)
        # The host-side read-ahead: the streamed GLM's window (the host-IO
        # width, at least 2), held in pinned memory.
        self.prefetch = max(1, int(prefetch if prefetch is not None
                                   else max(PREFETCH_DEPTH, io_threads())))
        self._window = DeviceWindow(PREFETCH_DEPTH + 1) if self.on_card else None
        self._host_peak = 0

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    @property
    def peak_in_flight_bytes(self) -> int:
        return self._window.peak_bytes if self.on_card else self._host_peak

    def stream(self, load_chunk: Callable[[int], object],
               num_chunks: int) -> Iterator[object]:
        from photon_tpu_torch.data.streaming import batch_tensors, stream_chunks

        tel = self.telemetry
        stall_c = tel.counter("stream.stall_s", tier="h2d")
        overlap_c = tel.counter("stream.prefetch_overlap_s", tier="h2d")
        chunks_c = tel.counter("stream.chunks")
        pin = self.on_card

        def timed_load(k: int):
            t0 = time.monotonic()
            host = host_tensors(load_chunk(k), pin)
            return host, time.monotonic() - t0

        chunks = stream_chunks(timed_load, num_chunks, self.prefetch,
                               self.device, window=self._window)
        try:
            while True:
                t_wait = time.monotonic()
                try:
                    chunk, load_s = next(chunks)
                except StopIteration:
                    return
                stall = time.monotonic() - t_wait
                stall_c.inc(stall)
                overlap_c.inc(max(0.0, load_s - stall))
                chunks_c.inc()
                if not self.on_card:
                    self._host_peak = max(self._host_peak,
                                          sum(t.nbytes for t in batch_tensors(chunk)))
                yield chunk
                del chunk
        finally:
            chunks.close()


# ---------------------------------------------------------------------------
# The host tier: an LRU cache over the disk-backed tile store
# ---------------------------------------------------------------------------


def _entry_nbytes(value) -> int:
    """Host bytes of a cached entry: arrays, or any dict, tuple or list nest
    of them (a feature payload is the store's ``(arrays, meta)`` pair)."""
    if isinstance(value, dict):
        return sum(_entry_nbytes(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return sum(_entry_nbytes(v) for v in value)
    return int(getattr(value, "nbytes", 0))


@dataclasses.dataclass
class _CacheEntry:
    value: object
    nbytes: int
    load_s: float
    consumed: bool = False


class HostTileCache:
    """A budgeted LRU host cache keyed by ``(kind, chunk, ...)`` between the
    tile store and the chunk streamer: the ``--max-host-mb`` budget, in
    bytes of its own numpy entries.

    Thread-safe, with single-flight loads: concurrent misses of one key (a
    prefetch racing the chunk worker) share one disk read.  An insert
    evicts least-recently-used entries until the budget holds; the entry
    just inserted stays even when it alone exceeds the budget (the caller
    needs it), until the next insert.  Listeners registered with
    :meth:`add_evict_listener` run after an eviction, outside the lock.

    Telemetry: ``tiles.cache_hits``, ``tiles.cache_misses``,
    ``tiles.cache_evictions`` and the ``tiles.host_cache_bytes`` gauge;
    :attr:`peak_bytes` is the gauge's high water after eviction passes."""

    def __init__(self, max_bytes: Optional[int] = None, telemetry=None):
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        self.max_bytes = max_bytes
        self.telemetry = telemetry or NULL_SESSION
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _CacheEntry]" = OrderedDict()
        self._inflight: Dict[tuple, Future] = {}
        self._bytes = 0
        self.peak_bytes = 0
        self.largest_entry_bytes = 0
        self._evict_listeners: List[Callable[[tuple, object], None]] = []
        self._hits = self.telemetry.counter("tiles.cache_hits")
        self._misses = self.telemetry.counter("tiles.cache_misses")
        self._evictions = self.telemetry.counter("tiles.cache_evictions")
        self._gauge = self.telemetry.gauge("tiles.host_cache_bytes")

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def add_evict_listener(self, fn: Callable[[tuple, object], None]) -> None:
        """Run ``fn(key, value)`` after each LRU eviction, outside the cache
        lock (``fn`` may do IO or use the cache).  Deliberate drops
        (:meth:`invalidate`, :meth:`clear`) do not notify."""
        self._evict_listeners.append(fn)

    def _notify_evicted(self, evicted) -> None:
        for key, entry in evicted:
            for fn in self._evict_listeners:
                fn(key, entry.value)

    def _evict_locked(self) -> list:
        # The entry just inserted is at the MRU end: the `> 1` bound keeps
        # it, the one-oversized-entry allowance.
        evicted = []
        while (self.max_bytes is not None and self._bytes > self.max_bytes
               and len(self._entries) > 1):
            key, entry = self._entries.popitem(last=False)
            self._bytes -= entry.nbytes
            self._evictions.inc()
            evicted.append((key, entry))
        self.peak_bytes = max(self.peak_bytes, self._bytes)
        self._gauge.set(self._bytes)
        return evicted

    def _insert_locked(self, key: tuple, entry: _CacheEntry) -> list:
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= old.nbytes
        self._entries[key] = entry
        self._bytes += entry.nbytes
        self.largest_entry_bytes = max(self.largest_entry_bytes, entry.nbytes)
        return self._evict_locked()

    def put(self, key: tuple, value) -> None:
        """Insert or replace (a tile just written back is the hottest
        entry)."""
        with self._lock:
            evicted = self._insert_locked(
                key, _CacheEntry(value, _entry_nbytes(value), 0.0, True))
        self._notify_evicted(evicted)

    def invalidate(self, key: tuple) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._bytes -= entry.nbytes
            self._gauge.set(self._bytes)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._gauge.set(0)

    def _do_load(self, key, fut: Future, loader, consumed: bool):
        """The single-flight load: load, insert, resolve the waiters.
        ``consumed=False`` marks a prefetch, whose read time the first real
        consumer reports as hidden."""
        try:
            t0 = time.monotonic()
            value = loader()
            load_s = time.monotonic() - t0
        except BaseException as e:
            with self._lock:
                self._inflight.pop(key, None)
            fut.set_exception(e)
            raise
        with self._lock:
            evicted = self._insert_locked(
                key, _CacheEntry(value, _entry_nbytes(value), load_s, consumed))
            self._inflight.pop(key, None)
        self._misses.inc()
        fut.set_result(value)
        self._notify_evicted(evicted)
        return value, load_s

    def get(self, key: tuple, loader: Callable[[], object]):
        """``(value, hidden_load_s)``: the cached value (``loader()`` on a
        miss) and, at the first consumption of an entry a prefetch loaded,
        the read seconds that consumption hid; 0.0 otherwise."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self._hits.inc()
                hidden = 0.0 if entry.consumed else entry.load_s
                entry.consumed = True
                return entry.value, hidden
            fut = self._inflight.get(key)
            owner = fut is None
            if owner:
                fut = self._inflight[key] = Future()
        if not owner:
            # A prefetch or another worker is reading it: share that read.
            # The wait is the caller's stall; the entry counts as consumed.
            value = fut.result()
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    entry.consumed = True
            self._hits.inc()
            return value, 0.0
        value, _ = self._do_load(key, fut, loader, consumed=True)
        return value, 0.0

    def prefetch(self, key: tuple, loader: Callable[[], object]) -> None:
        """Warm ``key`` on the ``tile-prefetch`` pool of ``utils/io_pool``
        (a pool of its own: a streamed pass's chunk loads use another)."""
        from photon_tpu_torch.utils.io_pool import submit

        with self._lock:
            if key in self._entries or key in self._inflight:
                return

        def warm():
            with self._lock:
                if key in self._entries or key in self._inflight:
                    return
                fut = self._inflight[key] = Future()
            try:
                self._do_load(key, fut, loader, consumed=False)
            except Exception:
                # The future carries it to a waiter; a later consumer's own
                # (retried) read raises its own.
                pass

        try:
            submit(warm, pool="tile-prefetch")
        except RuntimeError:
            pass  # the interpreter is shutting down: prefetch is optional


# ---------------------------------------------------------------------------
# The spilled dataset and its chunk source
# ---------------------------------------------------------------------------


def _dtype_str(values: np.ndarray) -> str:
    """A dense shard's dtype identity, the reference's ``dtype.str``: its
    bfloat16 is the opaque ``'<V2'``, the port's bf16 bits are uint16."""
    return "<V2" if lowp.is_bf16_bits(values) else values.dtype.str


def _shard_schema(data) -> dict:
    from photon_tpu_torch.game.data import DenseShard

    out = {}
    for name, shard in data.shards.items():
        if isinstance(shard, DenseShard):
            out[name] = {"kind": "dense", "dtype": _dtype_str(shard.x)}
        else:
            out[name] = {"kind": "sparse", "dim": int(shard.dim_)}
    return out


def dataset_fingerprint(data, chunk_rows: int, tile_dtype: str = "f32") -> dict:
    """The identity of (dataset, chunk plan, storage codec) a spill
    directory is reused under: the row count, the shard schema, a hash of
    the per-row scalar columns (features are not hashed) and the tile
    dtype (another tier must not train on this tier's blocks).  The
    reference's, key for key."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(data.label, np.float32).tobytes())
    h.update(np.ascontiguousarray(data.weight, np.float32).tobytes())
    h.update(np.ascontiguousarray(data.offset, np.float32).tobytes())
    return {
        "n": int(data.num_examples),
        "chunk_rows": int(chunk_rows),
        "shards": _shard_schema(data),
        "scalar_sha256": h.hexdigest(),
        "tile_dtype": str(tile_dtype),
    }


def spill_dataset(store, data, plan: ChunkPlan, telemetry=None) -> int:
    """Write every chunk's feature block into ``store``, skipping chunks a
    run over the same dataset and plan already published (the store's
    ``dataset.json``; any other identity resets the store).  Returns the
    chunks written."""
    from photon_tpu_torch.game.data import DenseShard

    tel = telemetry or NULL_SESSION
    fp = dataset_fingerprint(data, plan.chunk_rows, store.tile_dtype)
    if store.read_dataset_meta() != fp:
        # The identity is written last: a kill mid-spill leaves none, and
        # the next run spills afresh.
        store.reset_all()
    written = 0
    with tel.span("tiles.spill", chunks=plan.num_chunks):
        for k in range(plan.num_chunks):
            if store.has(FEAT_KIND, k):
                continue
            lo, hi = plan.bounds(k)
            arrays = {"label": data.label[lo:hi], "offset": data.offset[lo:hi],
                      "weight": data.weight[lo:hi]}
            # Only feature values take the lossy tier: ids are indices, and
            # the scalars feed the objective and the fingerprint.
            lossy = []
            for name, shard in data.shards.items():
                if isinstance(shard, DenseShard):
                    arrays[f"s:{name}:x"] = shard.x[lo:hi]
                    lossy.append(f"s:{name}:x")
                else:
                    arrays[f"s:{name}:ids"] = shard.ids[lo:hi]
                    arrays[f"s:{name}:vals"] = shard.vals[lo:hi]
                    lossy.append(f"s:{name}:vals")
            store.write(FEAT_KIND, k, arrays,
                        meta={"chunk": k, "rows": hi - lo, "shards": _shard_schema(data)},
                        codecs=store.lossy_codecs(lossy))
            written += 1
    if store.read_dataset_meta() != fp:
        store.write_dataset_meta(fp)
    tel.counter("tiles.chunks_spilled").inc(written)
    return written


class SpilledChunkSource:
    """Feature chunks from the disk tier through the host cache.  When a
    chunk worker asks for chunk ``k``, chunks ``k+1 .. k+stage_ahead`` are
    warmed on the ``tile-prefetch`` pool first, so in steady state a
    chunk's disk read ends while the chunks before it upload and compute.
    It returns a host ``GameDataset`` of the chunk, as
    :class:`ResidentChunkSource` does, so the chunk takes the same pinned
    path to the card.

    ``stream.stall_s{tier=disk}`` is the time a chunk load waited on an
    uncached read, ``stream.prefetch_overlap_s{tier=disk}`` the read
    seconds prefetches hid."""

    tier = "disk"

    def __init__(self, store, plan: ChunkPlan, cache: HostTileCache, telemetry=None,
                 stage_ahead: int = PREFETCH_DEPTH + 1):
        self.store = store
        self.plan = plan
        self.cache = cache
        self.telemetry = telemetry or NULL_SESSION
        self.stage_ahead = max(1, int(stage_ahead))
        self._stall_c = self.telemetry.counter("stream.stall_s", tier="disk")
        self._overlap_c = self.telemetry.counter("stream.prefetch_overlap_s",
                                                 tier="disk")

    def _loader(self, k: int):
        return lambda: self.store.read(FEAT_KIND, k)

    @staticmethod
    def _rebuild(payload):
        from photon_tpu_torch.game.data import DenseShard, GameDataset, SparseShard

        arrays, meta = payload
        shards = {}
        for name, schema in meta["shards"].items():
            if schema["kind"] == "dense":
                shards[name] = DenseShard(arrays[f"s:{name}:x"])
            else:
                shards[name] = SparseShard(arrays[f"s:{name}:ids"],
                                           arrays[f"s:{name}:vals"], schema["dim"])
        return GameDataset(label=arrays["label"], offset=arrays["offset"],
                           weight=arrays["weight"], shards=shards, id_columns={})

    def chunk(self, k: int):
        # Warm the successors first: the disk stage runs ahead even when
        # this chunk is about to stall.
        for j in range(k + 1, min(k + 1 + self.stage_ahead, self.plan.num_chunks)):
            self.cache.prefetch((FEAT_KIND, j), self._loader(j))
        t0 = time.monotonic()
        payload, hidden_s = self.cache.get((FEAT_KIND, k), self._loader(k))
        wait = time.monotonic() - t0
        self._stall_c.inc(wait)
        self._overlap_c.inc(max(0.0, hidden_s - wait))
        return self._rebuild(payload)


@dataclasses.dataclass
class SpillContext:
    """The disk tier of one spilled streamed fit: the store, the budgeted
    host cache and the chunk source reading through them, built once an
    estimator and passed to the descent and every streamed coordinate."""

    store: object
    cache: HostTileCache
    source: SpilledChunkSource


# ---------------------------------------------------------------------------
# Compensated cross-chunk accumulator
# ---------------------------------------------------------------------------


class NeumaierAccumulator:
    """Neumaier-compensated float64 accumulator for the streamed fixed
    effect's cross-chunk value and gradient reduce: the per-chunk terms are
    float32 results, and the compensated float64 sum makes the cross-chunk
    error independent of the chunk count (a 1-chunk and a 1000-chunk pass
    reduce to the same total up to the per-chunk float32 inputs)."""

    def __init__(self, dim: int):
        self._v = 0.0
        self._vc = 0.0
        self._g = np.zeros(dim, np.float64)
        self._gc = np.zeros(dim, np.float64)

    def add(self, value: float, grad: np.ndarray) -> None:
        v = float(value)
        t = self._v + v
        if abs(self._v) >= abs(v):
            self._vc += (self._v - t) + v
        else:
            self._vc += (v - t) + self._v
        self._v = t
        g = np.asarray(grad, np.float64)
        t = self._g + g
        self._gc += np.where(
            np.abs(self._g) >= np.abs(g),
            (self._g - t) + g,
            (g - t) + self._g,
        )
        self._g = t

    @property
    def value(self) -> float:
        return self._v + self._vc

    @property
    def grad(self) -> np.ndarray:
        return self._g + self._gc


# ---------------------------------------------------------------------------
# Tiled score tables
# ---------------------------------------------------------------------------


def _neumaier_rows_np(tile: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Neumaier-compensated column-wise sum of one ``[C, rows]`` tile in
    float32 numpy: the resident engine's ``_neumaier_rows`` arithmetic in
    the same order, so per-chunk partials concatenate to its total."""
    total = np.zeros(tile.shape[1], np.float32)
    comp = np.zeros(tile.shape[1], np.float32)
    for row in tile:
        t = total + row
        lost = np.where(
            np.abs(total) >= np.abs(row),
            (total - t) + row,
            (row - t) + total,
        )
        comp = comp + lost
        total = t
    return total, comp


class TiledScoreTable:
    """Host-resident per-chunk score tiles with maintained compensated
    partials: the out-of-core form of the resident score table.

    ``tiles[k]`` is chunk ``k``'s ``[C, rows_k]`` float32 tile (row ``c``
    is coordinate ``c``'s scores over the chunk's rows); ``totals[k]`` and
    ``comps[k]`` its Neumaier partials, recomputed from the tile on every
    update.  Training offsets and composite margins come out per chunk.

    A non-finite score vector is rejected at update (a host check: the
    tiles are host data) and the previous row kept; the guard flags drain
    through the engines' ``drain_guard_flags`` / ``poll_quarantined``
    contract."""

    _PATH = "residuals"

    def __init__(self, base_offset: np.ndarray, names: Sequence[str],
                 plan: ChunkPlan, telemetry=None):
        if not names:
            raise ValueError(f"{type(self).__name__} needs at least one coordinate")
        self.names = list(names)
        self._row = {name: i for i, name in enumerate(self.names)}
        if len(self._row) != len(self.names):
            raise ValueError(f"duplicate coordinate names in {self.names}")
        if len(base_offset) != plan.n:
            raise ValueError(
                f"base offset has {len(base_offset)} rows, plan covers {plan.n}")
        self.plan = plan
        self.telemetry = telemetry or NULL_SESSION
        self.n = plan.n
        self.base = np.asarray(base_offset, np.float32)
        self.totals: List[np.ndarray] = [
            np.zeros(plan.rows(k), np.float32) for k in range(plan.num_chunks)]
        self.comps: List[np.ndarray] = [
            np.zeros(plan.rows(k), np.float32) for k in range(plan.num_chunks)]
        self._pending_guard: list = []
        self.updates = 0
        self._init_tiles()
        self.telemetry.gauge(f"{self._PATH}.tile_chunks").set(plan.num_chunks)

    # -- tile residency (the spilled subclass overrides these) ----------------
    def _init_tiles(self) -> None:
        c = len(self.names)
        self.tiles: List[np.ndarray] = [
            np.zeros((c, self.plan.rows(k)), np.float32)
            for k in range(self.plan.num_chunks)]

    def tile(self, k: int) -> np.ndarray:
        """Chunk ``k``'s ``[C, rows_k]`` score tile (host float32)."""
        return self.tiles[k]

    def _writable_tile(self, k: int) -> np.ndarray:
        """The tile an update changes in place before publishing it."""
        return self.tile(k)

    def _publish_tile(self, k: int, tile: np.ndarray) -> None:
        """Land a changed tile and recompute its chunk's partials."""
        self.tiles[k] = tile
        self.totals[k], self.comps[k] = _neumaier_rows_np(tile)

    @property
    def num_chunks(self) -> int:
        return self.plan.num_chunks

    def row(self, name: str) -> int:
        return self._row[name]

    def update(self, name: str, new_scores) -> None:
        """Replace ``name``'s score row across every tile (a host float32
        vector of length ``n``) and refresh the partials."""
        host = np.asarray(new_scores, np.float32)
        if host.shape != (self.n,):
            raise ValueError(
                f"score vector for {name!r} has shape {host.shape}, want ({self.n},)")
        ok = bool(np.isfinite(host).all())
        self._pending_guard.append((name, ok))
        if ok:
            c = self._row[name]
            for k in range(self.num_chunks):
                lo, hi = self.plan.bounds(k)
                tile = self._writable_tile(k)
                tile[c] = host[lo:hi]
                self._publish_tile(k, tile)
        self.updates += 1
        self.telemetry.counter(f"{self._PATH}.updates", coordinate=name).inc()

    # -- per-chunk reads ------------------------------------------------------
    def offsets_chunk(self, name: str, k: int) -> np.ndarray:
        """Chunk ``k``'s training offsets for ``name``: ``base_k + (total_k -
        tile_k[c]) + comp_k``, the resident offsets formula and order."""
        lo, hi = self.plan.bounds(k)
        c = self._row[name]
        return self.base[lo:hi] + ((self.totals[k] - self.tile(k)[c]) + self.comps[k])

    def offsets_full(self, name: str) -> np.ndarray:
        """Every chunk's offsets concatenated (``[n]`` float32)."""
        return np.concatenate(
            [self.offsets_chunk(name, k) for k in range(self.num_chunks)])

    def composite_chunk(self, k: int) -> np.ndarray:
        """Chunk ``k``'s composite margin ``base_k + (total_k + comp_k)``."""
        lo, hi = self.plan.bounds(k)
        return self.base[lo:hi] + (self.totals[k] + self.comps[k])

    def composite_full(self) -> np.ndarray:
        return np.concatenate([self.composite_chunk(k) for k in range(self.num_chunks)])

    def scores_for(self, name: str) -> np.ndarray:
        """Coordinate ``name``'s current score vector (host, ``[n]``)."""
        c = self._row[name]
        return np.concatenate([self.tile(k)[c] for k in range(self.num_chunks)])

    # -- guard / snapshot contract --------------------------------------------
    def drain_guard_flags(self) -> list:
        pending, self._pending_guard = self._pending_guard, []
        return pending

    def record_rejected(self, bad: Sequence[str]) -> None:
        for name in bad:
            self.telemetry.counter(f"{self._PATH}.nonfinite_rows", coordinate=name).inc()

    def poll_quarantined(self) -> list:
        bad = [name for name, ok in self.drain_guard_flags() if not ok]
        self.record_rejected(bad)
        return bad

    def snapshot_rows(self) -> dict:
        """Every score row as host float32 ``{name: [n]}`` (the checkpoint
        snapshot; already host, so staging is a copy)."""
        return {name: self.scores_for(name).copy() for name in self.names}

    def load_rows(self, rows: dict) -> None:
        """Rebuild the tiles from checkpointed rows (resume).  Stored
        directly: the rows were guarded when written."""
        loaded = {}
        for name, row in rows.items():
            if name not in self._row:
                continue
            host = np.asarray(row, np.float32)
            if host.shape != (self.n,):
                raise ValueError(
                    f"checkpointed row for {name!r} has shape {host.shape}, "
                    f"want ({self.n},)")
            loaded[self._row[name]] = host
        # Chunk-outer: one publish a tile.
        for k in range(self.num_chunks):
            lo, hi = self.plan.bounds(k)
            tile = self._writable_tile(k)
            for c, host in loaded.items():
                tile[c] = host[lo:hi]
            self._publish_tile(k, tile)

    def clear(self) -> None:
        """Zero every tile (the rebuild's reset on resume)."""
        for k in range(self.num_chunks):
            tile = self._writable_tile(k)
            tile[:] = 0.0
            self._publish_tile(k, tile)

    def tile_digest(self, k: int) -> str:
        """Chunk ``k``'s tile digest: sha256/16 of the raw tile bytes, the
        reference's checkpoint digest."""
        return hashlib.sha256(self.tile(k).tobytes()).hexdigest()[:16]

    def tile_digests(self) -> List[str]:
        """Per-chunk digests of the score tiles, stamped into mid-epoch
        checkpoints so a resume can check its rebuilt tiles chunk by
        chunk."""
        return [self.tile_digest(k) for k in range(self.num_chunks)]


class TiledResidualTable(TiledScoreTable):
    """Training-side tiled score table (the ``residuals`` telemetry path)."""


class TiledValidationTable(TiledScoreTable):
    """Validation-side tiled score table: per-coordinate re-scoring and the
    composite margin from the same per-chunk partials."""

    _PATH = "validation"


class SpilledScoreTable(TiledScoreTable):
    """Score tiles at the disk tier: every read goes through the host
    cache, and a publish marks the tile dirty; :meth:`flush` writes each
    dirty tile to the store once (one atomic publish a tile a sweep,
    however many coordinate rows changed), and an eviction listener writes
    a dirty tile whose cached copy is displaced, so the dirty set never
    pins more than the cache does.  The descent flushes at the end of each
    sweep and before every checkpoint.

    At the exact tier the store round trip is lossless and a spilled fit
    equals the host-resident streamed fit bit for bit.  At a lossy tier a
    publish rounds the tile through the codec first, so the partials, the
    digests and the cached copy describe the bytes a reader decodes.

    An update changes a copy of the cached tile (the reference changes the
    cached array in place): a dirty entry is never changed after it was
    captured, and a per-table write lock with an identity check keeps a
    displaced entry's write from landing after a newer one's.

    Checkpoints: :meth:`snapshot_rows` is ``{}`` (the tiles on disk are
    referenced by the checkpoint's digests), :meth:`attach_resume` adopts
    them at resume (digest-checked: corruption raises
    ``CorruptTileError``), and the descent rebuilds from the checkpointed
    models when they are stale."""

    def __init__(self, base_offset: np.ndarray, names: Sequence[str], plan: ChunkPlan,
                 store, cache: HostTileCache, telemetry=None):
        self._store = store
        self._cache = cache
        self._dirty_lock = threading.Lock()
        self._write_lock = threading.Lock()
        # k -> (tile, totals, comps, full sha256): one publish's arrays.
        self._dirty: Dict[int, tuple] = {}
        self._publishes_since_flush = 0
        super().__init__(base_offset, names, plan, telemetry=telemetry)
        cache.add_evict_listener(self._on_cache_evict)
        self.telemetry.gauge(f"{self._PATH}.tiles_spilled").set(1)

    # -- residency ------------------------------------------------------------
    def _init_tiles(self) -> None:
        # No host tiles: a None digest marks the implicit zero tile.
        self._digests: List[Optional[str]] = [None] * self.plan.num_chunks

    @property
    def _tile_kind(self) -> str:
        return f"{TILE_KIND}-{self._PATH}"

    def _key(self, k: int) -> tuple:
        return (TILE_KIND, self._PATH, k)

    def _zero_tile(self, k: int) -> np.ndarray:
        return np.zeros((len(self.names), self.plan.rows(k)), np.float32)

    def tile(self, k: int) -> np.ndarray:
        def load():
            # The dirty set first: a displaced dirty tile may not be on disk
            # yet.
            with self._dirty_lock:
                entry = self._dirty.get(k)
            if entry is not None:
                return entry[0]
            if not self._store.has(self._tile_kind, k):
                return self._zero_tile(k)
            arrays, _ = self._store.read(self._tile_kind, k)
            return arrays["tile"]

        tile, _ = self._cache.get(self._key(k), load)
        return tile

    def _writable_tile(self, k: int) -> np.ndarray:
        return self.tile(k).copy()

    def _publish_tile(self, k: int, tile: np.ndarray) -> None:
        # The codec round trip first (the identity at f32).
        tile = codec_roundtrip(tile, self._store.tile_dtype)
        totals, comps = _neumaier_rows_np(tile)
        self.totals[k], self.comps[k] = totals, comps
        # One hash for both uses: the full sha256 goes in the part file's
        # header, its 16-character prefix is the checkpoint digest.
        full = hashlib.sha256(tile.tobytes()).hexdigest()
        self._digests[k] = full[:16]
        with self._dirty_lock:
            self._dirty[k] = (tile, totals, comps, full)
            self._publishes_since_flush += 1
        self._cache.put(self._key(k), tile)

    def _write_entry(self, k: int, entry: tuple) -> bool:
        """Publish one dirty entry if it is still chunk ``k``'s newest;
        returns whether it wrote."""
        with self._write_lock:
            with self._dirty_lock:
                if self._dirty.get(k) is not entry:
                    return False
            tile, totals, comps, full = entry
            self._store.write(
                self._tile_kind, k, {"tile": tile, "total": totals, "comp": comps},
                meta={"chunk": k, "path": self._PATH, "tile_digest": full[:16]},
                digests={"tile": full}, codecs=self._store.lossy_codecs(("tile",)))
            with self._dirty_lock:
                if self._dirty.get(k) is entry:
                    del self._dirty[k]
        return True

    def _on_cache_evict(self, key: tuple, value) -> None:
        if key[:2] != (TILE_KIND, self._PATH):
            return
        k = key[2]
        with self._dirty_lock:
            entry = self._dirty.get(k)
        if entry is not None and self._write_entry(k, entry):
            self.telemetry.counter("tiles.writeback_evict_flushes", path=self._PATH).inc()

    def flush(self) -> int:
        """Write every dirty tile to the store, once each; returns how many.
        Its seconds add up in ``tiles.writeback_flush_s``."""
        t0 = time.monotonic()
        with self._dirty_lock:
            pending = dict(self._dirty)
            publishes = self._publishes_since_flush
            self._publishes_since_flush = 0
        for k in sorted(pending):
            self._write_entry(k, pending[k])
        if pending:
            self.telemetry.counter("tiles.writeback_flushes", path=self._PATH).inc()
            self.telemetry.counter("tiles.writeback_coalesced", path=self._PATH).inc(
                max(0, publishes - len(pending)))
        self.telemetry.counter("tiles.writeback_flush_s", path=self._PATH).inc(
            time.monotonic() - t0)
        return len(pending)

    # -- digests and checkpoints ------------------------------------------------
    def tile_digest(self, k: int) -> str:
        d = self._digests[k]
        if d is None:
            # The implicit zero tile: the digest of all-zero float32 bytes.
            nbytes = 4 * len(self.names) * self.plan.rows(k)
            d = self._digests[k] = hashlib.sha256(b"\x00" * nbytes).hexdigest()[:16]
        return d

    def snapshot_rows(self) -> dict:
        """Empty: a spilled checkpoint references the tiles on disk by the
        digests in its stream payload."""
        return {}

    def reset_store(self) -> None:
        """Drop this table's part files and cached tiles (a fresh fit, or
        the rebuild of stale tiles)."""
        with self._dirty_lock:
            self._dirty.clear()
            self._publishes_since_flush = 0
        self._store.reset_tiles(self.num_chunks, kind=self._tile_kind)
        for k in range(self.num_chunks):
            self._cache.invalidate(self._key(k))
        self._init_tiles()
        for k in range(self.num_chunks):
            self.totals[k][:] = 0.0
            self.comps[k][:] = 0.0

    def attach_resume(self) -> List[int]:
        """Adopt the tiles on disk: each published tile's partials and
        header digest (the payload read digest-checked; corruption raises
        ``CorruptTileError``).  Returns the chunks with no published tile
        (the implicit zero; the descent's digest compare decides whether
        that is the true state or a stale store)."""
        missing: List[int] = []
        for k in range(self.num_chunks):
            if not self._store.has(self._tile_kind, k):
                self._digests[k] = None
                self.totals[k][:] = 0.0
                self.comps[k][:] = 0.0
                missing.append(k)
                continue
            # The partials alone: the tile loads when training first reads
            # it.
            arrays, meta = self._store.read(self._tile_kind, k, names=("total", "comp"))
            digest = meta.get("tile_digest")
            if digest is None:
                # A part file without the header digest: one full read.
                full, _ = self._store.read(self._tile_kind, k)
                digest = hashlib.sha256(full["tile"].tobytes()).hexdigest()[:16]
                self._cache.put(self._key(k), full["tile"])
            self.totals[k] = np.ascontiguousarray(arrays["total"], np.float32)
            self.comps[k] = np.ascontiguousarray(arrays["comp"], np.float32)
            self._digests[k] = digest
        self.telemetry.counter(f"{self._PATH}.tiles_attached").inc(
            self.num_chunks - len(missing))
        return missing


class SpilledResidualTable(SpilledScoreTable):
    """Training-side spilled score table (the ``residuals`` path; its part
    files are :data:`RESIDUAL_TILE_KIND`)."""


# ---------------------------------------------------------------------------
# Chunked model scoring (training re-score and validation)
# ---------------------------------------------------------------------------


def score_model_chunks(model, data, plan: ChunkPlan, streamer: ChunkStreamer,
                       entity_idx: Optional[np.ndarray] = None,
                       source=None) -> np.ndarray:
    """One coordinate model's margins over ``data``, chunk by chunk: each
    chunk's features upload through the streamer, the margins compute on
    the device and copy ``non_blocking`` into one host buffer (pinned on a
    card), read once at the end of the pass.  ``entity_idx`` (random
    models) is the per-row entity index against the model's vocabulary;
    ``source`` is where the chunks' features come from (the spilled disk
    tier), host slices of ``data`` by default."""
    from photon_tpu_torch.game.data import DenseShard, entity_index_for
    from photon_tpu_torch.game.model import FixedEffectModel, RandomEffectModel

    dense = isinstance(data.shard(model.shard_name), DenseShard)
    is_random = isinstance(model, RandomEffectModel)
    if not is_random and not isinstance(model, FixedEffectModel):
        raise TypeError(f"cannot chunk-score a {type(model).__name__}")
    if is_random and entity_idx is None:
        entity_idx = entity_index_for(data.id_columns[model.entity_column],
                                      np.asarray(model.keys))
    src = source or ResidentChunkSource(data, plan)

    def load(k: int):
        shard = src.chunk(k).shard(model.shard_name)
        feats = (shard.x,) if dense else (shard.ids, shard.vals)
        if is_random:
            lo, hi = plan.bounds(k)
            return feats, entity_idx[lo:hi]
        return feats, None

    out = HostBuffer(plan.n, streamer.device)
    pos = 0
    for feats, idx in streamer.stream(load, plan.num_chunks):
        if is_random:
            margins = model.margins_device(idx, feats, dense)
        else:
            margins = model.margins_device(feats, dense)
        rows = int(margins.shape[0])
        out.buf[pos: pos + rows].copy_(margins, non_blocking=True)
        pos += rows
    scores = out.read()
    streamer.telemetry.counter("descent.host_transfer_bytes", direction="d2h",
                               path="stream_score").inc(scores.nbytes)
    return scores


def entity_index_cache() -> Dict:
    """A small per-descent cache of ``(column, keys object) -> entity_idx``
    joins for :func:`score_model_chunks` callers."""
    return {}


def cached_entity_index(cache: Dict, data, column: str, keys) -> np.ndarray:
    from photon_tpu_torch.game.data import entity_index_for, keys_match

    hit = cache.get(column)
    if hit is not None and keys_match(keys, hit[0], hit[1]):
        return hit[2]
    arr = np.asarray(keys)
    idx = entity_index_for(data.id_columns[column], arr)
    cache[column] = (keys, arr, idx)
    return idx


# The exported kind and the table's own (``_tile_kind``) must agree: readers
# outside the table look its part files up by RESIDUAL_TILE_KIND.
assert RESIDUAL_TILE_KIND == f"{TILE_KIND}-{SpilledResidualTable._PATH}"
