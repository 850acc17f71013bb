"""The disk tier's store and host cache in the port against the JAX package.

Holds ``photon_tpu_torch/game/tile_store.py`` and the cache and spill half
of ``photon_tpu_torch/game/tiles.py`` to ``tests/test_tile_store.py``'s
contracts and ``tests/test_lowp.py``'s tile-store cases:

- the lossless encodings round-trip bit for bit, compression shrinks a
  smooth stream and the ``PHOTON_TILE_COMPRESS`` gate reads as the
  reference's; the lossy codecs decode to ``codec_roundtrip``, re-encode
  their own decode to the same bytes and fall back to exact storage on
  NaN or infinity;
- a corrupt payload, a torn header, a corrupt compressed stream and a
  corrupt int8 scale row raise ``CorruptTileError``, and none is retried;
  a kill inside the publish keeps the previous part file; injected
  ``tile:read`` / ``tile:write`` faults retry to a clean result and
  exhaust to the real error;
- the host cache's LRU order, counters and budget, one shared read for
  concurrent misses, prefetched reads reported as hidden seconds;
- ``spill_dataset`` and ``SpilledChunkSource`` give the resident slices
  back, the spill is idempotent and resets on another plan; the spilled
  score table equals the host-resident one bit for bit, flushes each dirty
  tile once and re-attaches exactly, at every codec; the Neumaier
  accumulator against ``math.fsum``;
- across the packages: a part file written by either package reads back
  bit for bit in the other, and the two write the same bytes, under
  ``raw``, ``dsz``, ``bf16``, ``int8`` and a ``name:bfloat16`` feature
  block; ``spill_dataset`` writes the reference's store.
"""

from __future__ import annotations

import json
import math
import os
import struct
import threading
import time

import ml_dtypes
import numpy as np
import pytest

from photon_tpu.data.synthetic import make_game_dataset as jax_make_game_dataset
from photon_tpu.game import tile_store as jstore
from photon_tpu.game import tiles as jtiles
from photon_tpu.game.data import dataset_astype as jax_dataset_astype
from photon_tpu_torch.data.synthetic import make_game_dataset
from photon_tpu_torch.fault.injection import FaultPlan, set_plan
from photon_tpu_torch.game.data import dataset_astype
from photon_tpu_torch.game.lowp import TILE_METRIC_TOL, check_dtype, tile_metric_tol_for
from photon_tpu_torch.game.tile_store import (
    FEATURES,
    TILES,
    CorruptTileError,
    TileStore,
    _decode,
    _encode,
    codec_roundtrip,
    compress_enabled,
)
from photon_tpu_torch.game.tiles import (
    ChunkPlan,
    HostTileCache,
    NeumaierAccumulator,
    ResidentChunkSource,
    SpilledChunkSource,
    SpilledResidualTable,
    TiledResidualTable,
    dataset_fingerprint,
    spill_dataset,
)
from photon_tpu_torch.telemetry import TelemetrySession

LOSSY = ("bf16", "int8")


@pytest.fixture(autouse=True)
def _fast_retries(monkeypatch):
    monkeypatch.setenv("PHOTON_IO_RETRY_BASE_S", "0")
    set_plan(None)
    yield
    set_plan(None)


def _counters(session):
    return {(m["name"], tuple(sorted(m["labels"].items()))): m["value"]
            for m in session.registry.snapshot()["counters"]}


def _flip(path: str, pos: int) -> None:
    blob = bytearray(open(path, "rb").read())
    blob[pos] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))


# -- codecs ------------------------------------------------------------------


_RNG = np.random.default_rng(0)
CODEC_CASES = {
    "f32": _RNG.standard_normal((3, 41)).astype(np.float32),
    "i32": (_RNG.random(100) * 1000).astype(np.int32),
    "i64": np.arange(17, dtype=np.int64),
    "f64": _RNG.standard_normal(5).astype(np.float64),
    "u8": np.frombuffer(b"photon", dtype=np.uint8),
    "empty": np.array([], dtype=np.float32),
    "specials": np.array([np.nan, np.inf, -0.0, 1e-38], dtype=np.float32),
    "bf16_bits": _RNG.integers(0, 2**16, (4, 9)).astype(np.uint16),
}


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_roundtrip_bit_exact(case, compress):
    arr = CODEC_CASES[case]
    buf, encoding = _encode(arr, compress)
    back = _decode(buf, arr.dtype, arr.shape, encoding)
    assert back.dtype == arr.dtype and back.flags.writeable
    assert arr.tobytes() == back.tobytes()
    assert (buf, encoding) == jstore._encode(arr, compress)


@pytest.mark.parametrize("compress", [False, True])
def test_store_roundtrips_bf16_bits_under_the_reference_token(tmp_path, compress):
    """The port's host bf16 (uint16 bits) is written as ``name:bfloat16``
    and read back as the same bits."""
    bits = np.arange(6, dtype=ml_dtypes.bfloat16).reshape(2, 3).view(np.uint16)
    store = TileStore(str(tmp_path), compress=compress)
    store.write(FEATURES, 0, {"x": bits})
    back, _ = store.read(FEATURES, 0)
    assert back["x"].dtype == np.uint16 and back["x"].tobytes() == bits.tobytes()
    with open(store.path(FEATURES, 0), "rb") as f:
        assert jstore._read_header(f)["arrays"][0]["dtype"] == "name:bfloat16"


def test_codec_compresses_smooth_streams():
    arr = np.linspace(0, 1, 4096, dtype=np.float32)
    buf, encoding = _encode(arr, True)
    assert encoding == "dsz" and len(buf) < arr.nbytes
    np.testing.assert_array_equal(_decode(buf, arr.dtype, arr.shape, encoding), arr)


def test_compress_env_gate(monkeypatch):
    monkeypatch.delenv("PHOTON_TILE_COMPRESS", raising=False)
    assert compress_enabled() is False
    for value, want in (("1", True), ("shuffle", True), ("off", False), ("", False)):
        monkeypatch.setenv("PHOTON_TILE_COMPRESS", value)
        assert compress_enabled() is want is jstore.compress_enabled()
    monkeypatch.setenv("PHOTON_TILE_COMPRESS", "1")
    assert compress_enabled(False) is False


def test_tile_dtypes_and_tolerances():
    assert TILE_METRIC_TOL == {"f32": 1e-6, "bf16": 5e-2, "int8": 2e-1}
    for dtype in ("f32", "bf16", "int8"):
        assert tile_metric_tol_for(dtype) == TILE_METRIC_TOL[dtype]
    assert check_dtype(None) == "f32" and check_dtype("int8") == "int8"
    with pytest.raises(ValueError, match="tile dtype"):
        tile_metric_tol_for("int4")
    with pytest.raises(ValueError, match="table dtype"):
        check_dtype("int4")


@pytest.mark.parametrize("dtype", LOSSY)
def test_tile_store_lossy_roundtrip(tmp_path, dtype):
    rng = np.random.default_rng(5)
    tile = (rng.standard_normal((3, 41))
            * 10.0 ** rng.integers(-2, 3, (3, 1))).astype(np.float32)
    store = TileStore(str(tmp_path), tile_dtype=dtype)
    store.write(TILES, 0, {"tile": tile}, codecs=store.lossy_codecs(("tile",)))
    got = store.read(TILES, 0)[0]["tile"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, codec_roundtrip(tile, dtype))
    np.testing.assert_array_equal(got, jstore.codec_roundtrip(tile, dtype))
    # The decode re-encodes to the same payload.
    store.write(TILES, 1, {"tile": got}, codecs=store.lossy_codecs(("tile",)))
    np.testing.assert_array_equal(store.read(TILES, 1)[0]["tile"], got)
    with open(store.path(TILES, 0), "rb") as a, open(store.path(TILES, 1), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("dtype", LOSSY)
def test_tile_store_nan_inf_falls_back_lossless(tmp_path, dtype):
    tile = np.array([[1.0, np.nan, 3.0], [np.inf, 5.0, -np.inf]], np.float32)
    store = TileStore(str(tmp_path), tile_dtype=dtype)
    store.write(TILES, 0, {"tile": tile}, codecs=store.lossy_codecs(("tile",)))
    assert store.read(TILES, 0)[0]["tile"].tobytes() == tile.tobytes()


# -- part files ----------------------------------------------------------------


def test_store_roundtrip_and_accounting(tmp_path):
    session = TelemetrySession("t-store")
    store = TileStore(str(tmp_path), telemetry=session)
    tile = np.arange(12, dtype=np.float32).reshape(3, 4)
    store.write(TILES, 0, {"tile": tile}, meta={"tile_digest": "abc"})
    arrays, meta = store.read(TILES, 0)
    np.testing.assert_array_equal(arrays["tile"], tile)
    assert meta["tile_digest"] == "abc" and store.read_meta(TILES, 0) == meta
    assert store.has(TILES, 0) and not store.has(TILES, 1)
    gauges = {m["name"]: m["value"] for m in session.registry.snapshot()["gauges"]}
    assert gauges["tiles.disk_bytes"] == store.disk_bytes > 0
    store.delete(TILES, 0)
    assert store.disk_bytes == 0
    store.write(TILES, 1, {"a": tile})
    assert TileStore(str(tmp_path)).disk_bytes == store.disk_bytes > 0


def test_store_compressed_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_TILE_COMPRESS", "1")
    store = TileStore(str(tmp_path))
    assert store.compress
    rng = np.random.default_rng(1)
    arrays = {"tile": rng.standard_normal((2, 57)).astype(np.float32),
              "ids": np.sort(rng.integers(0, 100, (57, 4))).astype(np.int32)}
    store.write(TILES, 3, arrays)
    back, _ = store.read(TILES, 3)
    for name, arr in arrays.items():
        assert arr.tobytes() == back[name].tobytes()


def _int8_scale_pos(path: str) -> int:
    blob = open(path, "rb").read()
    (hlen,) = struct.unpack("<Q", blob[8:16])
    entry = json.loads(blob[16:16 + hlen])["arrays"][0]
    assert entry["codec"] == "int8"
    return 16 + hlen + entry["offset"] + 2  # inside the first scale value


@pytest.mark.parametrize("case", ["payload", "header", "compressed", "int8_scale"])
def test_corruption_refused_and_not_retried(tmp_path, monkeypatch, case):
    """A flipped payload byte, a torn header, a flipped byte of a
    compressed stream and a flipped byte of an int8 scale row all raise
    ``CorruptTileError``, and the retry budget is not spent on them."""
    session = TelemetrySession("t-corrupt")
    if case == "compressed":
        monkeypatch.setenv("PHOTON_TILE_COMPRESS", "1")
    store = TileStore(str(tmp_path), telemetry=session,
                      tile_dtype="int8" if case == "int8_scale" else None, compress=(
                          None if case == "compressed" else False))
    if case == "compressed":
        arrays = {"ids": np.sort(np.random.default_rng(2).integers(
            0, 100, (257, 4))).astype(np.int32)}
    else:
        arrays = {"tile": np.random.default_rng(6).standard_normal((3, 41)).astype(
            np.float32)}
    store.write(TILES, 0, arrays, codecs=store.lossy_codecs(("tile",)))
    path = store.path(TILES, 0)
    if case == "header":
        with open(path, "wb") as f:
            f.write(b"garbage!")
    elif case == "compressed":
        assert b'"dsz"' in open(path, "rb").read()
        _flip(path, -9)
    elif case == "int8_scale":
        _flip(path, _int8_scale_pos(path))
    else:
        _flip(path, -3)
    with pytest.raises(CorruptTileError):
        store.read(TILES, 0)
    assert not isinstance(CorruptTileError("x"), OSError)
    assert ("io.retries", (("site", "tile:read"),)) not in _counters(session)


def test_torn_publish_keeps_previous_tile(tmp_path, monkeypatch):
    store = TileStore(str(tmp_path))
    old = np.full(16, 7.0, np.float32)
    store.write(TILES, 0, {"tile": old})
    real_replace = os.replace
    calls = {"n": 0}

    def torn_replace(src, dst):
        if dst.endswith("tile-000000.pt"):
            calls["n"] += 1
            raise KeyboardInterrupt("a kill inside the publish")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", torn_replace)
    with pytest.raises(KeyboardInterrupt):
        store.write(TILES, 0, {"tile": np.zeros(16, np.float32)})
    monkeypatch.setattr(os, "replace", real_replace)
    assert calls["n"] == 1
    np.testing.assert_array_equal(store.read(TILES, 0)[0]["tile"], old)
    assert [n for n in os.listdir(tmp_path) if not n.endswith(".pt")] == []


def test_injected_tile_faults_retry_to_clean(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_IO_RETRIES", "8")
    session = TelemetrySession("t-faults")
    store = TileStore(str(tmp_path), telemetry=session)
    tile = np.arange(32, dtype=np.float32)
    set_plan(FaultPlan.parse("tile:write:p=0.5,tile:read:p=0.5", seed=3))
    for k in range(8):
        store.write(TILES, k, {"tile": tile + k})
    for k in range(8):
        np.testing.assert_array_equal(store.read(TILES, k)[0]["tile"], tile + k)
    set_plan(None)
    retries = {labels: v for (name, labels), v in _counters(session).items()
               if name == "io.retries"}
    assert retries[(("site", "tile:read"),)] > 0
    assert retries[(("site", "tile:write"),)] > 0


def test_injected_tile_fault_exhaustion_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_IO_RETRIES", "2")
    store = TileStore(str(tmp_path))
    store.write(TILES, 0, {"tile": np.ones(4, np.float32)})
    set_plan(FaultPlan.parse("tile:read:p=1.0", seed=0))
    with pytest.raises(OSError):
        store.read(TILES, 0)


# -- the host cache ------------------------------------------------------------


def test_cache_hits_misses_and_lru_eviction():
    session = TelemetrySession("t-cache")
    one_kb = np.zeros(256, np.float32)
    cache = HostTileCache(max_bytes=3 * 1024, telemetry=session)
    for k in range(3):
        cache.get(("feat", k), lambda: one_kb)
    assert cache.nbytes == 3 * 1024
    cache.get(("feat", 0), lambda: one_kb)  # 1 is now the LRU entry
    cache.get(("feat", 3), lambda: one_kb)  # evicts 1
    counters = _counters(session)
    assert counters[("tiles.cache_misses", ())] == 4
    assert counters[("tiles.cache_evictions", ())] == 1
    assert counters[("tiles.cache_hits", ())] == 1
    seen = []
    cache.get(("feat", 1), lambda: seen.append(1) or one_kb)
    cache.get(("feat", 0), lambda: seen.append(0) or one_kb)
    assert seen == [1]
    gauges = {m["name"]: m["value"] for m in session.registry.snapshot()["gauges"]}
    assert 0 < gauges["tiles.host_cache_bytes"] <= 3 * 1024
    assert cache.peak_bytes == 3 * 1024
    # One entry over the budget stays until the next insert.
    cache.put(("feat", 9), np.zeros(2048, np.float32))
    assert cache.nbytes == 8192 == cache.largest_entry_bytes
    with pytest.raises(ValueError):
        HostTileCache(max_bytes=0)


def test_cache_single_flight_under_concurrency():
    cache = HostTileCache()
    loads = []
    gate = threading.Event()

    def loader():
        gate.wait(2)
        loads.append(1)
        return np.zeros(4, np.float32)

    results = []
    threads = [threading.Thread(target=lambda: results.append(
        cache.get(("feat", 0), loader)[0])) for _ in range(4)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join()
    assert len(loads) == 1 and len(results) == 4


def test_cache_prefetch_counts_hidden_overlap():
    cache = HostTileCache(telemetry=TelemetrySession("t-prefetch"))

    def slow_loader():
        time.sleep(0.01)
        return np.zeros(4, np.float32)

    cache.prefetch(("feat", 9), slow_loader)
    deadline = time.monotonic() + 2.0
    while ("feat", 9) not in cache._entries:
        assert time.monotonic() < deadline, "the prefetch never landed"
        time.sleep(0.002)
    assert cache.get(("feat", 9), slow_loader)[1] >= 0.01
    assert cache.get(("feat", 9), slow_loader)[1] == 0.0


def test_evict_listener_runs_outside_the_lock():
    """A listener may use the cache (a write-back during a prefetch's insert
    must not deadlock)."""
    cache = HostTileCache(max_bytes=1024)
    seen = []
    cache.add_evict_listener(lambda key, value: seen.append((key, cache.nbytes)))
    for k in range(3):
        cache.put(("tile", k), np.zeros(256, np.float32))
    assert [key for key, _ in seen] == [("tile", 0), ("tile", 1)]


# -- the spilled dataset and tables -------------------------------------------


@pytest.fixture(scope="module")
def spill_fixture(tmp_path_factory):
    data, _ = make_game_dataset(60, 4, 6, 3, seed=0, n_random_coords=1)
    plan = ChunkPlan(data.num_examples, 23)
    store = TileStore(str(tmp_path_factory.mktemp("store")))
    assert spill_dataset(store, data, plan) == plan.num_chunks
    return data, plan, store


def test_spilled_chunks_match_resident_slices(spill_fixture):
    data, plan, store = spill_fixture
    src, resident = SpilledChunkSource(store, plan, HostTileCache()), ResidentChunkSource(
        data, plan)
    for k in range(plan.num_chunks):
        a, b = src.chunk(k), resident.chunk(k)
        for col in ("label", "weight", "offset"):
            np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
        for name in data.shards:
            sa, sb = a.shard(name), b.shard(name)
            for field in sa._fields:
                np.testing.assert_array_equal(getattr(sa, field), getattr(sb, field))


def test_spill_is_idempotent_and_resets_on_foreign_data(spill_fixture):
    data, plan, store = spill_fixture
    assert spill_dataset(store, data, plan) == 0
    other = ChunkPlan(data.num_examples, 31)
    assert spill_dataset(store, data, other) == other.num_chunks
    assert spill_dataset(store, data, plan) == plan.num_chunks


@pytest.mark.parametrize("dtype", ["f32", *LOSSY])
def test_spilled_table_against_host_resident_and_reattached(tmp_path, dtype):
    """At f32 the spilled table equals the host-resident one bit for bit; at
    every tier the three coordinates' updates of a tile flush once, and a
    second table adopts the flushed tiles exactly."""
    rng = np.random.default_rng(7)
    n, names = 101, ["a", "b", "c"]
    base = rng.standard_normal(n).astype(np.float32)
    plan = ChunkPlan(n, 17)
    store = TileStore(str(tmp_path), tile_dtype=dtype)
    spilled = SpilledResidualTable(base, names, plan, store, HostTileCache())
    resident = TiledResidualTable(base, names, plan)
    ref = jtiles.SpilledResidualTable(base, names, jtiles.ChunkPlan(n, 17),
                                      jstore.TileStore(str(tmp_path / "jax"),
                                                       tile_dtype=dtype),
                                      jtiles.HostTileCache())
    for name in names:
        scores = rng.standard_normal(n).astype(np.float32) * 10
        for table in (spilled, resident, ref):
            table.update(name, scores)
    assert spilled.tile_digests() == ref.tile_digests()
    if dtype == "f32":
        for name in names:
            np.testing.assert_array_equal(spilled.offsets_full(name),
                                          resident.offsets_full(name))
        np.testing.assert_array_equal(spilled.composite_full(), resident.composite_full())
        assert spilled.tile_digests() == resident.tile_digests()
    assert spilled.snapshot_rows() == {}
    assert spilled.flush() == plan.num_chunks
    assert spilled.flush() == 0
    attached = SpilledResidualTable(base, names, plan, store, HostTileCache())
    assert attached.attach_resume() == []
    assert attached.tile_digests() == spilled.tile_digests()
    for name in names:
        np.testing.assert_array_equal(attached.scores_for(name), spilled.scores_for(name))
    np.testing.assert_array_equal(attached.composite_full(), spilled.composite_full())
    attached.reset_store()
    assert attached.attach_resume() == list(range(plan.num_chunks))
    np.testing.assert_array_equal(attached.scores_for("a"), np.zeros(n, np.float32))


def test_dirty_tiles_write_back_on_eviction(tmp_path):
    """A budget of one tile: each update displaces dirty tiles, which are
    written as they go; the store then holds every tile's newest state."""
    rng = np.random.default_rng(8)
    n, names = 90, ["a", "b"]
    plan = ChunkPlan(n, 30)
    session = TelemetrySession("t-evict")
    store = TileStore(str(tmp_path))
    spilled = SpilledResidualTable(np.zeros(n, np.float32), names, plan, store,
                                   HostTileCache(max_bytes=2 * 30 * 4), telemetry=session)
    for name in names:
        spilled.update(name, rng.standard_normal(n).astype(np.float32))
    spilled.flush()
    flushes = _counters(session)[("tiles.writeback_evict_flushes",
                                  (("path", "residuals"),))]
    assert flushes > 0
    fresh = SpilledResidualTable(np.zeros(n, np.float32), names, plan, store,
                                 HostTileCache())
    fresh.attach_resume()
    for name in names:
        np.testing.assert_array_equal(fresh.scores_for(name), spilled.scores_for(name))


def _stress(workers, seconds=20.0):
    """Run the ``workers`` callables on threads at a short switch interval;
    every thread must finish in time."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def guarded(fn):
        try:
            fn()
        except BaseException as e:  # recorded and re-raised in the test
            errors.append(e)

    try:
        threads = [threading.Thread(target=guarded, args=(fn,)) for fn in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    if errors:
        raise errors[0]


def test_cache_accounting_under_concurrent_load():
    """16 threads (more than the cores) getting, prefetching, putting and
    invalidating 24 keys under a budget of 4 entries: the byte count stays
    the sum of the entries, every get returns its key's value, and at most
    one entry rides over the budget."""
    cache = HostTileCache(max_bytes=4 * 4096)
    evicted = []
    cache.add_evict_listener(lambda key, value: evicted.append(key))

    def value(k):
        return np.full(1024, k, np.float32)

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            k = int(rng.integers(24))
            op = rng.integers(4)
            if op == 0:
                cache.prefetch(("feat", k), lambda k=k: value(k))
            elif op == 1:
                cache.put(("feat", k), value(k))
            elif op == 2:
                cache.invalidate(("feat", k))
            got, _ = cache.get(("feat", k), lambda k=k: value(k))
            assert got[0] == k

    _stress([lambda s=s: worker(s) for s in range(16)])
    with cache._lock:
        assert cache._bytes == sum(e.nbytes for e in cache._entries.values())
    assert cache.nbytes <= max(cache.max_bytes, cache.largest_entry_bytes)
    assert evicted


def test_spilled_table_write_back_under_concurrent_evictions(tmp_path):
    """One thread updates a spilled table while 12 others load feature
    entries into the same small cache, so its dirty tiles are written back
    from their threads mid-update: no part file is torn, and after a flush
    the store holds the table's last state."""
    n, names = 120, ["a", "b", "c"]
    plan = ChunkPlan(n, 20)
    cache = HostTileCache(max_bytes=3 * 3 * 20 * 4)
    store = TileStore(str(tmp_path))
    table = SpilledResidualTable(np.zeros(n, np.float32), names, plan, store, cache)
    done = threading.Event()

    def updater():
        rng = np.random.default_rng(0)
        try:
            for i in range(60):
                table.update(names[i % 3], rng.standard_normal(n).astype(np.float32))
        finally:
            done.set()

    def loader(seed):
        rng = np.random.default_rng(seed)
        while not done.is_set():
            k = int(rng.integers(40))
            cache.get(("feat", k), lambda: np.zeros(60, np.float32))

    _stress([updater, *[lambda s=s: loader(s) for s in range(1, 13)]])
    table.flush()
    fresh = SpilledResidualTable(np.zeros(n, np.float32), names, plan, store,
                                 HostTileCache())
    assert fresh.attach_resume() == []
    assert fresh.tile_digests() == table.tile_digests()
    for name in names:
        np.testing.assert_array_equal(fresh.scores_for(name), table.scores_for(name))


def test_neumaier_accumulator_matches_fsum():
    rng = np.random.default_rng(0)
    values = (rng.standard_normal(500) * 10.0 ** rng.integers(-6, 7, 500)).astype(
        np.float64)
    grads = rng.standard_normal((500, 3)) * values[:, None]
    acc = NeumaierAccumulator(3)
    for v, g in zip(values, grads):
        acc.add(float(v), g)
    assert acc.value == pytest.approx(math.fsum(values), abs=0.0, rel=1e-15)
    for j in range(3):
        want = math.fsum(grads[:, j])
        assert acc.grad[j] == pytest.approx(want, abs=1e-12 * max(1.0, abs(want)))


# -- across the packages ---------------------------------------------------------


def _cross_case(case):
    """(arrays as the port holds them, as the JAX package does, codecs,
    compress)."""
    rng = np.random.default_rng(11)
    tile = rng.standard_normal((3, 57)).astype(np.float32)
    ids = np.sort(rng.integers(0, 100, (57, 4))).astype(np.int32)
    if case == "bf16_feature_block":
        jvals = rng.standard_normal((57, 4)).astype(ml_dtypes.bfloat16)
        return ({"ids": ids, "vals": jvals.view(np.uint16)}, {"ids": ids, "vals": jvals},
                {}, False)
    arrays = {"tile": tile, "ids": ids, "ramp": np.linspace(0, 1, 512, dtype=np.float32)}
    codecs = {"raw": {}, "dsz": {}, "bf16": {"tile": "bf16"}, "int8": {"tile": "int8"}}
    return arrays, arrays, codecs[case], case == "dsz"


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("case", ["raw", "dsz", "bf16", "int8", "bf16_feature_block"])
def test_part_files_cross_between_packages(tmp_path, writer, case):
    ours, theirs, codecs, compress = _cross_case(case)
    port = TileStore(str(tmp_path / "torch"), compress=compress)
    ref = jstore.TileStore(str(tmp_path / "jax"), compress=compress)
    meta = {"chunk": 4, "case": case}
    port.write(TILES, 4, ours, meta=meta, codecs=codecs)
    ref.write(TILES, 4, theirs, meta=meta, codecs=codecs)
    with open(port.path(TILES, 4), "rb") as a, open(ref.path(TILES, 4), "rb") as b:
        assert a.read() == b.read()  # the same file, byte for byte
    if writer == "jax":
        got, got_meta = TileStore(str(tmp_path / "jax")).read(TILES, 4)
        want = {name: (ref.read(TILES, 4)[0][name].view(np.uint16)
                       if theirs[name].dtype == ml_dtypes.bfloat16
                       else jstore.codec_roundtrip(arr, codecs.get(name)))
                for name, arr in theirs.items()}
    else:
        got, got_meta = jstore.TileStore(str(tmp_path / "torch")).read(TILES, 4)
        want = {name: codec_roundtrip(arr, codecs.get(name)) for name, arr in ours.items()}
        got = {name: (arr.view(np.uint16) if arr.dtype == ml_dtypes.bfloat16 else arr)
               for name, arr in got.items()}
    assert got_meta == meta
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].tobytes() == want[name].tobytes(), name


@pytest.mark.parametrize("tier", ["f32", "bf16_dense", "int8"])
def test_spill_dataset_writes_the_reference_store(tmp_path, tier):
    """The same dataset spilled by both packages: the same part files and
    ``dataset.json`` byte for byte (a bf16 dense shard under the reference's
    ``'<V2'`` schema), and each package's chunk source reads the other's."""
    jdata, _ = jax_make_game_dataset(40, 4, 6, 3, seed=2, n_random_coords=1)
    data, _ = make_game_dataset(40, 4, 6, 3, seed=2, n_random_coords=1)
    tile_dtype = "int8" if tier == "int8" else "f32"
    if tier == "bf16_dense":
        jdata, data = jax_dataset_astype(jdata, "bfloat16"), dataset_astype(data, "bfloat16")
    plan, jplan = ChunkPlan(data.num_examples, 29), jtiles.ChunkPlan(jdata.num_examples, 29)
    port = TileStore(str(tmp_path / "torch"), tile_dtype=tile_dtype)
    ref = jstore.TileStore(str(tmp_path / "jax"), tile_dtype=tile_dtype)
    assert spill_dataset(port, data, plan) == jtiles.spill_dataset(ref, jdata, jplan)
    assert dataset_fingerprint(data, 29, tile_dtype) == jtiles.dataset_fingerprint(
        jdata, 29, tile_dtype)
    for name in sorted(os.listdir(tmp_path / "jax")):
        with open(tmp_path / "torch" / name, "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
    ours = SpilledChunkSource(TileStore(str(tmp_path / "jax")), plan, HostTileCache())
    theirs = jtiles.SpilledChunkSource(jstore.TileStore(str(tmp_path / "torch")), jplan,
                                       jtiles.HostTileCache())
    for k in range(plan.num_chunks):
        a, b = ours.chunk(k), theirs.chunk(k)
        np.testing.assert_array_equal(a.label, b.label)
        for name in data.shards:
            for field in a.shard(name)._fields:
                x, y = getattr(a.shard(name), field), getattr(b.shard(name), field)
                if isinstance(x, np.ndarray):
                    y = np.asarray(y)
                    assert x.tobytes() == y.tobytes(), (k, name, field)
