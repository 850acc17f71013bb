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

Not carried here: the disk tier (``HostTileCache``, ``spill_dataset``,
``SpilledChunkSource``, ``SpillContext``, ``SpilledScoreTable``) and bf16
tiles, which wait in ROADMAP.md queue 1, item 9.3.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.game import lowp
from photon_tpu_torch.telemetry import NULL_SESSION

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
        c = len(self.names)
        self.tiles: List[np.ndarray] = [
            np.zeros((c, plan.rows(k)), np.float32) for k in range(plan.num_chunks)]
        self.telemetry.gauge(f"{self._PATH}.tile_chunks").set(plan.num_chunks)

    def tile(self, k: int) -> np.ndarray:
        """Chunk ``k``'s ``[C, rows_k]`` score tile (host float32)."""
        return self.tiles[k]

    def _publish_tile(self, k: int, tile: np.ndarray) -> None:
        """Land a changed tile and recompute its chunk's partials."""
        self.tiles[k] = tile
        self.totals[k], self.comps[k] = _neumaier_rows_np(tile)

    @property
    def num_chunks(self) -> int:
        return self.plan.num_chunks

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
                tile = self.tile(k)
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
        for k in range(self.num_chunks):
            lo, hi = self.plan.bounds(k)
            tile = self.tile(k)
            for c, host in loaded.items():
                tile[c] = host[lo:hi]
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


# ---------------------------------------------------------------------------
# Chunked model scoring (training re-score and validation)
# ---------------------------------------------------------------------------


def score_model_chunks(model, data, plan: ChunkPlan, streamer: ChunkStreamer,
                       entity_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """One coordinate model's margins over ``data``, chunk by chunk: each
    chunk's features upload through the streamer, the margins compute on
    the device and copy ``non_blocking`` into one host buffer (pinned on a
    card), read once at the end of the pass.  ``entity_idx`` (random
    models) is the per-row entity index against the model's vocabulary."""
    from photon_tpu_torch.game.data import DenseShard, entity_index_for
    from photon_tpu_torch.game.model import FixedEffectModel, RandomEffectModel

    dense = isinstance(data.shard(model.shard_name), DenseShard)
    is_random = isinstance(model, RandomEffectModel)
    if not is_random and not isinstance(model, FixedEffectModel):
        raise TypeError(f"cannot chunk-score a {type(model).__name__}")
    if is_random and entity_idx is None:
        entity_idx = entity_index_for(data.id_columns[model.entity_column],
                                      np.asarray(model.keys))
    src = ResidentChunkSource(data, plan)

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
