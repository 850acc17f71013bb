"""Streamed (out-of-core) GAME training in the port against the JAX package.

Holds ``photon_tpu_torch/game/{tiles,stream_descent}.py``, the estimator's
``stream_chunks`` mode and ``train_game --stream-chunks`` /
``--max-resident-mb`` to ``tests/test_ooc_game.py``'s contracts, on its
fixture (``make_game_dataset(100, 5, 6, 3, seed=0, n_random_coords=1)``,
split 0.25) with ``CHUNK = 37`` (a partial last chunk):

- the chunk plan, the budget helpers, the tiled partials against the
  unchunked totals, the table guard and snapshot, the streamer's order and
  telemetry; the tiles' partials and digests equal the JAX package's bit
  for bit for the same updates;
- the port's streamed fit against the JAX package's streamed fit under the
  reference's pins (linear RMS <= 1e-4, max <= 5e-4, metrics <= 1e-4;
  logistic max <= 1e-3), and against the port's resident fits;
- one bin solved in one block and in several gives the same table bit for
  bit on every entity route;
- a mid-epoch kill resumes exactly, a checkpoint of another chunk size is
  refused, the solve-quarantine count survives the kill, and mid-epoch
  checkpoints cross between the packages both ways;
- device bytes bounded by the chunk window, the mode gates, the driver.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxOpt
from photon_tpu.core.problem import ProblemConfig as JaxProblem
from photon_tpu.data.synthetic import make_game_dataset as jax_make_game_dataset
from photon_tpu.fault.checkpoint import DescentCheckpointer as JaxCheckpointer
from photon_tpu.fault.injection import FaultPlan as JaxFaultPlan
from photon_tpu.fault.injection import InjectedKillError as JaxKillError
from photon_tpu.fault.injection import set_plan as jax_set_plan
from photon_tpu.game import coordinate as jcoord
from photon_tpu.game import tiles as jtiles
from photon_tpu.game.data import split_game_dataset as jax_split
from photon_tpu.game.estimator import GameEstimator as JaxEstimator
from photon_tpu.game.estimator import GameOptimizationConfiguration as JaxConfig
from photon_tpu_torch.core.objective import RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.data.streaming import DeviceWindow
from photon_tpu_torch.fault.checkpoint import CheckpointError, DescentCheckpointer
from photon_tpu_torch.fault.injection import FaultPlan, InjectedKillError, set_plan
from photon_tpu_torch.game import tiles
from photon_tpu_torch.game.coordinate import (
    FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.data import (
    DenseShard,
    GameDataset,
    SparseShard,
    pad_bucket_entities,
)
from photon_tpu_torch.game.estimator import GameEstimator, GameOptimizationConfiguration
from photon_tpu_torch.game.stream_descent import (
    StreamedRandomEffectCoordinate,
    StreamedRandomEffectHostData,
)
from photon_tpu_torch.game.tiles import (
    PREFETCH_DEPTH,
    ChunkPlan,
    ChunkStreamer,
    TiledResidualTable,
    chunk_rows_for_budget,
    per_row_bytes,
    resident_bytes_estimate,
)
from photon_tpu_torch.telemetry import TelemetrySession

CHUNK = 37  # not a divisor of the row count: a partial last chunk
RMS_TOL, MAX_TOL, METRIC_TOL = 1e-4, 5e-4, 1e-4  # tests/test_ooc_game.py:224-243
LOGISTIC_MAX_TOL = 1e-3  # tests/test_ooc_game.py:245-267
PLAN_TOL = 1e-4  # tests/test_ooc_game.py:269-291


@pytest.fixture(autouse=True)
def _fault_hygiene():
    for reset in (set_plan, jax_set_plan):
        reset(None)
    yield
    for reset in (set_plan, jax_set_plan):
        reset(None)


def _problem(lam, max_iters=80):
    # Tight tolerances, the reference's: two solvers agree the tighter both
    # converge.
    return ProblemConfig(regularization=RegularizationContext("l2", lam),
                         optimizer_config=OptimizerConfig(
                             max_iterations=max_iters, tolerance=1e-11,
                             gradient_tolerance=1e-8))


def _config(iters=2):
    return GameOptimizationConfiguration(coordinates={
        "fixed": FixedEffectCoordinateConfig("global", _problem(1.0)),
        "re0": RandomEffectCoordinateConfig("re0", "re0", _problem(1.0)),
    }, descent_iterations=iters, name="ooc")


def _jax_config(iters=2):
    def problem(lam):
        return JaxProblem(regularization=JaxReg("l2", lam),
                          optimizer_config=JaxOpt(max_iterations=80, tolerance=1e-11,
                                                  gradient_tolerance=1e-8))

    return JaxConfig(coordinates={
        "fixed": jcoord.FixedEffectCoordinateConfig("global", problem(1.0)),
        "re0": jcoord.RandomEffectCoordinateConfig("re0", "re0", problem(1.0)),
    }, descent_iterations=iters, name="ooc")


def _to_port(data) -> GameDataset:
    def shard(s):
        if hasattr(s, "x"):
            return DenseShard(np.asarray(s.x))
        return SparseShard(np.asarray(s.ids), np.asarray(s.vals), s.dim_)

    return GameDataset(np.asarray(data.label), np.asarray(data.offset),
                       np.asarray(data.weight),
                       {n: shard(s) for n, s in data.shards.items()},
                       {n: np.asarray(c) for n, c in data.id_columns.items()})


def _sparse(data: GameDataset) -> GameDataset:
    """The same rows with every dense shard stored padded-sparse."""
    def shard(s):
        n, d = s.x.shape
        return SparseShard(np.tile(np.arange(d, dtype=np.int32), (n, 1)), s.x.copy(), d)

    return GameDataset(data.label, data.offset, data.weight,
                       {n: shard(s) for n, s in data.shards.items()}, data.id_columns)


@pytest.fixture(scope="module")
def jax_data():
    data, _ = jax_make_game_dataset(100, 5, 6, 3, seed=0, n_random_coords=1)
    return jax_split(data, 0.25, seed=1)


@pytest.fixture(scope="module")
def game_data(jax_data):
    return tuple(_to_port(d) for d in jax_data)


def _estimator(train, val, task="linear_regression", **kw):
    return GameEstimator(task, train, validation_data=val, device="cpu", **kw)


def _score(model, data) -> np.ndarray:
    return np.asarray(model.score(data))


@pytest.fixture(scope="module")
def fits(game_data):
    """One linear fit per mode: resident device and host, streamed."""
    train, val = game_data
    return {mode: _estimator(train, val, **kw).fit([_config()])[0]
            for mode, kw in (("device", {"residual_mode": "device"}),
                             ("host", {"residual_mode": "host"}),
                             ("stream", {"stream_chunks": CHUNK}))}


@pytest.fixture(scope="module")
def jax_fits(jax_data):
    """The JAX package's streamed fits, linear and logistic."""
    train, val = jax_data
    return {task: JaxEstimator(task, train, validation_data=val,
                               stream_chunks=CHUNK).fit([_jax_config()])[0]
            for task in ("linear_regression", "logistic_regression")}


def _counters(session, labelled=False) -> dict:
    snap = session.registry.snapshot()
    return {m["name"]: m["value"] for m in snap["counters"]
            if labelled or not m["labels"]}


# -- chunk plan, budget helpers, tiled tables, streamer ----------------------


def test_chunk_plan_partial_and_degenerate():
    plan = ChunkPlan(100, 37)
    assert plan.num_chunks == 3
    assert [plan.bounds(k) for k in range(3)] == [(0, 37), (37, 74), (74, 100)]
    assert plan.rows(2) == 26
    exact = ChunkPlan(100, 25)
    assert exact.num_chunks == 4 and exact.rows(3) == 25
    one = ChunkPlan(100, 1000)
    assert one.num_chunks == 1 and one.bounds(0) == (0, 100)
    for n, rows in ((100, 37), (100, 25), (100, 1000), (0, 5), (1, 1)):
        ours, ref = ChunkPlan(n, rows), jtiles.ChunkPlan(n, rows)
        assert ours.num_chunks == ref.num_chunks
        assert [ours.bounds(k) for k in range(ours.num_chunks)] == [
            ref.bounds(k) for k in range(ref.num_chunks)]
    with pytest.raises(IndexError):
        plan.bounds(3)
    with pytest.raises(ValueError):
        ChunkPlan(10, 0)


def test_budget_helpers(game_data, jax_data):
    train, _ = game_data
    rb = per_row_bytes(train)
    n = train.num_examples
    assert rb == jtiles.per_row_bytes(jax_data[0]) > 0
    assert resident_bytes_estimate(train) == 2 * rb * n + 2 * 2 * n * 4
    assert resident_bytes_estimate(train, n_coordinates=3) == 2 * rb * n + 2 * 3 * n * 4
    assert tiles.stream_host_bytes_estimate(train, 3) == jtiles.stream_host_bytes_estimate(
        jax_data[0], 3)
    rows = chunk_rows_for_budget(train, 0.01)
    assert (PREFETCH_DEPTH + 1) * rows * rb <= 0.01 * (1 << 20) or rows == 1
    for mb in (1e-4, 0.01, 0.05, 1e9):
        assert chunk_rows_for_budget(train, mb) == jtiles.chunk_rows_for_budget(
            jax_data[0], mb)
    assert chunk_rows_for_budget(train, 1e9) == train.num_examples
    with pytest.raises(ValueError):
        chunk_rows_for_budget(train, 0)


def test_tiled_partials_match_unchunked_totals_and_the_jax_tiles():
    """The per-chunk partials concatenate to the single-chunk table's
    offsets and composite, and equal the JAX package's tiles bit for bit
    (partials, offsets, digests) for the same updates."""
    rng = np.random.default_rng(0)
    n = 101
    base = rng.standard_normal(n).astype(np.float32)
    scores = {"a": rng.standard_normal(n).astype(np.float32) * 100,
              "b": rng.standard_normal(n).astype(np.float32),
              "c": rng.standard_normal(n).astype(np.float32) * 0.01}
    tiled = TiledResidualTable(base, list(scores), ChunkPlan(n, 17))
    whole = TiledResidualTable(base, list(scores), ChunkPlan(n, n))
    ref = jtiles.TiledResidualTable(base, list(scores), jtiles.ChunkPlan(n, 17))
    for name, s in scores.items():
        for table in (tiled, whole, ref):
            table.update(name, s)
    for name in scores:
        np.testing.assert_array_equal(tiled.offsets_full(name), whole.offsets_full(name))
        np.testing.assert_array_equal(tiled.offsets_full(name), ref.offsets_full(name))
    np.testing.assert_array_equal(tiled.composite_full(), whole.composite_full())
    for k in range(tiled.num_chunks):
        np.testing.assert_array_equal(tiled.totals[k], ref.totals[k])
        np.testing.assert_array_equal(tiled.comps[k], ref.comps[k])
        np.testing.assert_array_equal(tiled.composite_chunk(k), ref.composite_chunk(k))
    assert tiled.tile_digests() == ref.tile_digests()
    want = base.astype(np.float64) + sum(s.astype(np.float64) for s in scores.values())
    np.testing.assert_allclose(tiled.composite_full(), want, rtol=1e-6, atol=1e-5)
    # The float64 cross-chunk accumulator is the reference's to the bit.
    acc, jacc = tiles.NeumaierAccumulator(4), jtiles.NeumaierAccumulator(4)
    for _ in range(9):
        v, g = float(rng.standard_normal() * 1e4), rng.standard_normal(4).astype(np.float32)
        acc.add(v, g)
        jacc.add(v, g)
    assert acc.value == jacc.value
    np.testing.assert_array_equal(acc.grad, jacc.grad)


def test_tiled_table_guard_and_snapshot_roundtrip():
    base = np.zeros(10, np.float32)
    table = TiledResidualTable(base, ["a", "b"], ChunkPlan(10, 4))
    good = np.arange(10, dtype=np.float32)
    table.update("a", good)
    bad = good.copy()
    bad[3] = np.nan
    table.update("b", bad)
    assert table.poll_quarantined() == ["b"]
    np.testing.assert_array_equal(table.scores_for("b"), np.zeros(10))
    snap = table.snapshot_rows()
    restored = TiledResidualTable(base, ["a", "b"], ChunkPlan(10, 4))
    restored.load_rows(snap)
    np.testing.assert_array_equal(restored.scores_for("a"), good)
    assert restored.tile_digests() == table.tile_digests()
    ref = jtiles.TiledResidualTable(base, ["a", "b"], jtiles.ChunkPlan(10, 4))
    ref.load_rows(snap)
    assert ref.tile_digests() == table.tile_digests()
    before = table.tile_digests()
    table.update("a", good + 1)
    assert all(x != y for x, y in zip(table.tile_digests(), before))


def test_chunk_streamer_orders_and_measures():
    session = TelemetrySession("t-streamer")
    streamer = ChunkStreamer(session, prefetch=2)

    def load(k):
        time.sleep(0.002)
        return (np.full(8, k, np.float32),)

    out = list(streamer.stream(load, 7))
    assert [int(a[0][0]) for a in out] == list(range(7))
    assert all(isinstance(a[0], torch.Tensor) for a in out)
    counters = _counters(session)
    tiered = {(m["name"], m["labels"].get("tier")): m["value"]
              for m in session.registry.snapshot()["counters"] if "tier" in m["labels"]}
    assert counters["stream.chunks"] == 7
    assert tiered[("stream.stall_s", "h2d")] >= 0
    # Two workers prefetching 2 ms loads: some load time hides.
    assert tiered[("stream.prefetch_overlap_s", "h2d")] > 0
    # On the CPU the chunks are host tensors: the one being consumed.
    assert streamer.peak_in_flight_bytes == 32
    # An abandoned pass stops cleanly, and the next pass is whole.
    for _ in streamer.stream(load, 7):
        break
    assert len(list(streamer.stream(load, 3))) == 3


def test_device_window_bounds_and_measures_the_card_residency(monkeypatch):
    """The window's accounting as ``stream_chunks`` drives it on a card,
    with stand-in events: a chunk is released at the consumer's return from
    the chunk after it, the host waits only when the window is full, and
    the peak counts what the events have not released."""
    waits = []

    class Event:
        def __init__(self):
            self.done = False

        def record(self, stream):
            pass

        def query(self):
            return self.done

        def synchronize(self):
            waits.append(self)
            self.done = True

    monkeypatch.setattr(torch.cuda, "Event", Event)
    with pytest.raises(ValueError):
        DeviceWindow(2)

    def drive(window, chunks, card_keeps_up):
        # stream_chunks: admit chunk j, then hand out chunk j-1; from the
        # second handed chunk on, the consumer's return releases the one
        # before it.
        released = []
        for j in range(chunks):
            window.admit(10)
            if j >= 2:
                window.release(None)
                released.append(window._live[0][1])
                if card_keeps_up:
                    released[-1].done = True
        window.release(None, every=True)
        return released

    bounded = DeviceWindow(3)
    drive(bounded, 8, card_keeps_up=False)
    # Chunks j-2 (consumed), j-1 (staged) and j (new): the host waited for
    # the card before each copy from the fourth on.
    assert bounded.peak_bytes == 30 and len(waits) == bounded.waits == 5
    waits.clear()
    fast = DeviceWindow(3)
    drive(fast, 8, card_keeps_up=True)
    assert fast.peak_bytes == 30 and not waits
    # A window wider than the pass: nothing waits, and the peak is every
    # chunk the card has not released (a host running ahead shows).
    wide = DeviceWindow(16)
    drive(wide, 8, card_keeps_up=False)
    assert wide.peak_bytes == 80 and not waits
    # The pass's end releases what it held; the next pass starts clean.
    for event in {id(e[1]): e[1] for e in wide._live}.values():
        event.done = True
    wide.admit(10)
    assert len(wide._live) == 1


# -- fits against the JAX package and against the resident port ---------------


@pytest.mark.parametrize("task", ["linear_regression", "logistic_regression"])
def test_streamed_fit_matches_the_jax_streamed_fit(game_data, jax_data, jax_fits, fits,
                                                   task):
    train, val = game_data
    ref = jax_fits[task]
    ours = (fits["stream"] if task == "linear_regression"
            else _estimator(train, val, task, stream_chunks=CHUNK).fit([_config()])[0])
    diff = _score(ours.model, val) - np.asarray(ref.model.score(jax_data[1]))
    if task == "linear_regression":
        assert float(np.sqrt(np.mean(diff * diff))) <= RMS_TOL
        assert np.abs(diff).max() <= MAX_TOL
        for name, value in ref.metrics.items():
            assert abs(value - ours.metrics[name]) <= METRIC_TOL, name
    else:
        assert np.abs(diff).max() <= LOGISTIC_MAX_TOL


def test_streamed_fit_matches_resident_both_modes(fits, game_data):
    _, val = game_data
    stream = _score(fits["stream"].model, val)
    for mode in ("device", "host"):
        diff = _score(fits[mode].model, val) - stream
        assert float(np.sqrt(np.mean(diff * diff))) <= RMS_TOL, mode
        assert np.abs(diff).max() <= MAX_TOL, mode
        for name, value in fits[mode].metrics.items():
            assert abs(value - fits["stream"].metrics[name]) <= METRIC_TOL, (mode, name)


def test_single_chunk_and_divisible_plans_match_partial_chunk_fit(game_data, fits):
    train, val = game_data
    partial = _score(fits["stream"].model, val)
    for rows in (train.num_examples + 10, 25):  # one chunk; an exact divisor
        other = _score(_estimator(train, val, stream_chunks=rows).fit(
            [_config()])[0].model, val)
        assert np.abs(partial - other).max() <= PLAN_TOL, rows


def test_sparse_shards_stream_like_resident(game_data):
    """The sparse chunk path (padded ids and values, the ``autodiff``
    route) against the resident fit of the same rows."""
    train, val = (_sparse(d) for d in game_data)
    config = _config(iters=1)
    resident = _estimator(train, val, residual_mode="device").fit([config])[0]
    streamed = _estimator(train, val, stream_chunks=CHUNK).fit([config])[0]
    diff = _score(resident.model, val) - _score(streamed.model, val)
    assert float(np.sqrt(np.mean(diff * diff))) <= RMS_TOL
    assert np.abs(diff).max() <= MAX_TOL


@pytest.mark.parametrize("route,env", [
    ("newton", {}),
    ("vmapped", {"PHOTON_SOLVE_NEWTON": "off"}),
    ("newton_cg", {"PHOTON_NEWTON_MAX_DIM": "0"}),
])
def test_block_split_moves_no_entity(game_data, monkeypatch, route, env):
    """One bin solved in one block and in several (the last padded to the
    block shape) gives the same table bit for bit: no solve couples lanes.
    The blocks hold multiples of 32 lanes, as torch's CPU elementwise
    kernels round ``exp``/``log1p`` differently in a SIMD group's tail."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    train, _ = game_data
    config = RandomEffectCoordinateConfig("re0", "re0", _problem(1.0, 20))
    host = StreamedRandomEffectHostData(train, config)
    # The widest bin (61 entities of 8 rows), padded to 96 lanes by weight-0
    # dummies, in one block of 96 and in blocks of 64 (64 real, then 32 of
    # which 29 are padding).
    bucket = max(host.bins, key=lambda b: b.num_entities)
    host.bins = [pad_bucket_entities(bucket, 96, host.dataset.num_entities)]
    offsets = np.random.default_rng(3).standard_normal(train.num_examples).astype(
        np.float32)

    class _Offsets:
        @staticmethod
        def full():
            return offsets

    tables, blocks = [], []
    for block_entities in (96, 64):
        coord = StreamedRandomEffectCoordinate(
            train, config, "logistic_regression",
            ChunkPlan(train.num_examples, train.num_examples), ChunkStreamer(),
            host_data=host)
        coord.block_budget = block_entities * host.entity_bytes(host.bins[0])
        assert set(coord.routes) == {route}
        model, stats = coord.train(_Offsets())
        tables.append(model.table.numpy())
        blocks.append(coord.bin_blocks())
        assert stats["entities"] == bucket.num_entities
    assert blocks == [[(0, 0, 96, 96)], [(0, 0, 64, 64), (0, 64, 96, 64)]]
    assert np.abs(tables[0]).sum(axis=1).astype(bool).sum() == bucket.num_entities
    np.testing.assert_array_equal(tables[0], tables[1])


def test_streamed_warm_start_with_a_locked_coordinate(game_data, fits):
    """A warm start from a saved-model vocabulary (a foreign keys object,
    joined by key) with the fixed effect locked: the locked coefficients
    stay as given, and the streamed fit tracks the resident one."""
    import dataclasses

    from photon_tpu_torch.game.model import GameModel

    train, val = game_data
    start = fits["device"].model
    re0 = start.coordinates["re0"]
    foreign = dataclasses.replace(re0, keys=np.array(re0.keys, copy=True))
    initial = GameModel({"fixed": start.coordinates["fixed"], "re0": foreign},
                        start.task_type)
    results = {mode: _estimator(train, val, **kw).fit(
        [_config(iters=1)], initial_model=initial, locked_coordinates=["fixed"])[0]
        for mode, kw in (("device", {"residual_mode": "device"}),
                         ("stream", {"stream_chunks": CHUNK}))}
    np.testing.assert_array_equal(
        results["stream"].model.coordinates["fixed"].coefficients.means.numpy(),
        start.coordinates["fixed"].coefficients.means.numpy())
    diff = _score(results["stream"].model, val) - _score(results["device"].model, val)
    assert np.abs(diff).max() <= MAX_TOL


# -- mid-epoch kill and resume -------------------------------------------------


def _kill(plan: str, fit):
    set_plan(FaultPlan.parse(plan))
    try:
        with pytest.raises(InjectedKillError):
            fit()
    finally:
        set_plan(None)


def test_mid_epoch_kill_then_resume_exact(game_data, fits, tmp_path):
    train, val = game_data
    baseline = fits["stream"]
    ck = str(tmp_path / "ck")
    # Before coordinate re0 of iteration 1: the fixed effect of iteration 1
    # has trained and checkpointed.
    _kill("descent:kill:iter=1:coord=re0", lambda: _estimator(
        train, val, stream_chunks=CHUNK).fit([_config()], checkpoint_dir=ck,
                                              resume="auto"))
    state = DescentCheckpointer(os.path.join(ck, "cfg-000")).load("latest", device="cpu")
    assert state.stream["cursor"] == 1 and state.stream["chunk_rows"] == CHUNK
    assert len(state.stream["tile_digests"]) == ChunkPlan(train.num_examples,
                                                          CHUNK).num_chunks
    assert not state.completed
    resumed = _estimator(train, val, stream_chunks=CHUNK).fit(
        [_config()], checkpoint_dir=ck, resume="auto")[0]
    for data in (val, train):
        np.testing.assert_array_equal(_score(baseline.model, data),
                                      _score(resumed.model, data))
    assert baseline.metrics == resumed.metrics


def test_stream_checkpoint_refuses_other_chunk_size_and_torn_tiles(game_data, tmp_path):
    train, val = game_data
    ck = str(tmp_path / "ck")
    _kill("descent:kill:iter=1", lambda: _estimator(
        train, val, stream_chunks=CHUNK).fit([_config()], checkpoint_dir=ck,
                                              resume="auto"))
    with pytest.raises(CheckpointError, match="fingerprint"):
        _estimator(train, val, stream_chunks=CHUNK + 5).fit(
            [_config()], checkpoint_dir=ck, resume="auto")
    # A checkpoint whose tile digests do not describe its rows is refused.
    path = DescentCheckpointer(os.path.join(ck, "cfg-000")).latest_path()
    state_path = os.path.join(path, "state.json")
    with open(state_path) as f:
        payload = json.load(f)
    payload["stream"]["tile_digests"][0] = "0" * 16
    with open(state_path, "w") as f:
        json.dump(payload, f)
    os.remove(os.path.join(path, "manifest.json"))
    from photon_tpu_torch.fault.atomic import write_manifest

    write_manifest(path, extra={"iteration": payload["iteration"]})
    with pytest.raises(CheckpointError, match="digests"):
        _estimator(train, val, stream_chunks=CHUNK).fit(
            [_config()], checkpoint_dir=ck, resume="auto")


def test_mid_epoch_checkpoint_carries_solve_quarantine(game_data, tmp_path):
    train, val = game_data
    ck = str(tmp_path / "ck")
    set_plan(FaultPlan.parse("solve:nan:coord=re0"))
    try:
        result = _estimator(train, val, stream_chunks=CHUNK).fit(
            [_config(iters=1)], checkpoint_dir=ck, resume="auto")[0]
    finally:
        set_plan(None)
    state = DescentCheckpointer(os.path.join(ck, "cfg-000")).load("latest", device="cpu")
    assert state.quarantined >= 1
    assert np.isfinite(np.asarray(result.model.coordinates["re0"].table)).all()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mid_epoch_checkpoints_resume_across_packages(game_data, jax_data, tmp_path,
                                                      writer):
    """A mid-epoch checkpoint one package writes passes the other's digest
    check and resumes there; both resumes agree under the parity pins."""
    train, val = game_data
    jtrain, jval = jax_data
    ck = str(tmp_path / "written")
    if writer == "jax":
        jax_set_plan(JaxFaultPlan.parse("descent:kill:iter=1:coord=re0"))
        try:
            with pytest.raises(JaxKillError):
                JaxEstimator("linear_regression", jtrain, validation_data=jval,
                             stream_chunks=CHUNK).fit([_jax_config()], checkpoint_dir=ck,
                                                      resume="auto")
        finally:
            jax_set_plan(None)
    else:
        _kill("descent:kill:iter=1:coord=re0", lambda: _estimator(
            train, val, stream_chunks=CHUNK).fit([_config()], checkpoint_dir=ck,
                                                  resume="auto"))
    for name in ("jax", "torch"):
        shutil.copytree(ck, str(tmp_path / name))
    state = JaxCheckpointer(os.path.join(ck, "cfg-000")).load("latest")
    assert state.stream["cursor"] == 1
    by_port = _estimator(train, val, stream_chunks=CHUNK).fit(
        [_config()], checkpoint_dir=str(tmp_path / "torch"), resume="latest")[0]
    by_jax = JaxEstimator("linear_regression", jtrain, validation_data=jval,
                          stream_chunks=CHUNK).fit(
        [_jax_config()], checkpoint_dir=str(tmp_path / "jax"), resume="latest")[0]
    assert [h["iteration"] for h in by_port.descent.history] == [0, 1]
    diff = _score(by_port.model, val) - np.asarray(by_jax.model.score(jval))
    assert float(np.sqrt(np.mean(diff * diff))) <= RMS_TOL
    assert np.abs(diff).max() <= MAX_TOL
    for name, value in by_jax.metrics.items():
        assert abs(value - by_port.metrics[name]) <= METRIC_TOL, name


def test_streamed_preemption_exits_75_and_resumes_exactly(tmp_path):
    """A preemption at the top of descent iteration 2 of ``train_game
    --stream-chunks`` exits 75 with iteration 1 published; ``--resume
    latest`` ends at the uninterrupted model.  (The streamed fixed effect's
    L-BFGS reads the ``preempt`` site at its own iterations too, as the
    reference's does: two iterations keep it below 2.)"""
    from photon_tpu_torch.drivers import train_game
    from photon_tpu_torch.fault.preemption import clear_preemption
    from photon_tpu_torch.game.model_io import load_game_model

    args = [*DRIVER_ARGS, "--descent-iterations", "3", "--stream-chunks", "40"]
    args[args.index("fixed:type=fixed,shard=global,max_iters=25")] = (
        "fixed:type=fixed,shard=global,max_iters=2")

    def main(out, *extra):
        try:
            train_game.main([*args, "--output-dir", str(tmp_path / out), *extra])
        except SystemExit as e:
            return e.code
        return 0

    assert main("plain") == 0
    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    try:
        assert main("stopped", *ck, "--faults", "preempt:iter=2") == 75
    finally:
        clear_preemption()
    assert main("resumed", *ck, "--resume", "latest") == 0
    plain, resumed = (load_game_model(str(tmp_path / n / "best_model"), device="cpu")[0]
                      for n in ("plain", "resumed"))
    for name, model in plain.coordinates.items():
        got = resumed.coordinates[name]
        want, have = ((model.coefficients.means, got.coefficients.means)
                      if hasattr(model, "coefficients") else (model.table, got.table))
        np.testing.assert_array_equal(want.numpy(), have.numpy())


# -- residency bound, gates, drivers --------------------------------------------


def test_streamed_device_bytes_bounded_by_chunk_window(game_data):
    train, val = game_data
    session = TelemetrySession("t-ooc")
    estimator = _estimator(train, val, stream_chunks=CHUNK, telemetry=session)
    estimator.fit([_config(iters=1)])
    snap = session.registry.snapshot()
    gauges = {m["name"]: m["value"] for m in snap["gauges"] if not m["labels"]}
    tiered = {(m["name"], m["labels"].get("tier")) for m in snap["counters"]
              if "tier" in m["labels"]}
    assert _counters(session)["stream.chunks"] > 0
    assert {("stream.stall_s", "h2d"), ("stream.prefetch_overlap_s", "h2d")} <= tiered
    # The window bound; entity sub-blocks are sized by the same budget.
    bound = (PREFETCH_DEPTH + 1) * CHUNK * per_row_bytes(train)
    assert 0 < gauges["residuals.device_bytes"] <= bound
    assert estimator._streamer.peak_in_flight_bytes == gauges["residuals.device_bytes"]


def test_stream_mode_gates(game_data):
    train, val = game_data
    for chunks in (-1, 0):
        with pytest.raises(ValueError, match="stream_chunks"):
            GameEstimator("linear_regression", train, device="cpu", stream_chunks=chunks)
    with pytest.raises(ValueError, match="residual"):
        GameEstimator("linear_regression", train, device="cpu", residual_mode="host",
                      stream_chunks=CHUNK)
    # The disk tier (ported): spill_dir with streaming, refused without it.
    spilled = GameEstimator("linear_regression", train, device="cpu", stream_chunks=CHUNK,
                            spill_dir="x")
    assert spilled.spill_dir == "x" and spilled.tile_dtype == "f32"
    with pytest.raises(ValueError, match="stream_chunks"):
        GameEstimator("linear_regression", train, device="cpu", spill_dir="x")
    from photon_tpu_torch.game.coordinate import FactoredRandomEffectCoordinateConfig

    cases = [
        ({"fixed": FixedEffectCoordinateConfig("global", _problem(0.1),
                                               downsampling_rate=0.5)}, "downsampling"),
        ({"fixed": FixedEffectCoordinateConfig("global", ProblemConfig(
            optimizer="tron", regularization=RegularizationContext("l2", 0.1)))}, "lbfgs"),
        ({"re0": RandomEffectCoordinateConfig("re0", "re0", _problem(1.0),
                                              projection="random", projected_dim=2)},
         "projection"),
        ({"fixed": FixedEffectCoordinateConfig("global", ProblemConfig(
            regularization=RegularizationContext("l2", 0.1),
            variance_computation="simple"))}, "variance"),
        ({"f": FactoredRandomEffectCoordinateConfig("re0", "re0")}, "factored"),
    ]
    for coords, match in cases:
        with pytest.raises(ValueError, match=match):
            _estimator(train, val, stream_chunks=CHUNK).fit([GameOptimizationConfiguration(
                coordinates=coords, descent_iterations=1, name="bad")])


DRIVER_ARGS = ["--input", "synthetic-game:60:4:6:3", "--task", "linear_regression",
               "--coordinate", "fixed:type=fixed,shard=global,max_iters=25",
               "--coordinate", "re0:type=random,shard=re0,entity=re0,max_iters=25",
               "--descent-iterations", "1", "--validation-split", "0.25",
               "--backend", "cpu"]


def _run_report(out) -> dict:
    with open(os.path.join(out, "telemetry", "run_report.json")) as f:
        return json.load(f)["metrics"]


def test_train_game_stream_chunks_driver(tmp_path):
    from photon_tpu_torch.drivers import train_game

    out = tmp_path / "out"
    summary = train_game.run(train_game.build_parser().parse_args(
        [*DRIVER_ARGS, "--stream-chunks", "53", "--residuals", "host",
         "--output-dir", str(out)]))
    assert summary["best_metrics"] and summary["stream_chunks"] == 53
    assert (out / "best_model").is_dir()
    assert {"stream.chunks"} <= {m["name"] for m in _run_report(out)["counters"]}
    with pytest.raises(ValueError, match="stream-chunks"):
        train_game.run(train_game.build_parser().parse_args(
            [*DRIVER_ARGS, "--stream-chunks", "0", "--output-dir", str(tmp_path / "b")]))
    # A host budget the data exceeds spills to <output-dir>/tile_store.
    train_game.run(train_game.build_parser().parse_args(
        [*DRIVER_ARGS, "--stream-chunks", "53", "--max-host-mb", "0.001",
         "--output-dir", str(tmp_path / "c")]))
    assert (tmp_path / "c" / "tile_store" / "dataset.json").is_file()


def test_train_game_max_resident_mb_auto_enables(tmp_path):
    """A budget the dataset exceeds streams with a fitted chunk size; a
    generous one keeps the resident path."""
    from photon_tpu_torch.drivers import train_game

    def run(budget_mb, out):
        return train_game.run(train_game.build_parser().parse_args(
            [*DRIVER_ARGS, "--max-resident-mb", str(budget_mb), "--output-dir", str(out)]))

    small = run(0.01, tmp_path / "small")
    gauges = {m["name"]: m["value"] for m in _run_report(tmp_path / "small")["gauges"]}
    assert gauges["stream.chunk_rows"] == small["stream_chunks"] >= 1
    assert gauges["stream.resident_estimate_bytes"] > 0.01 * (1 << 20)
    assert "stream.chunks" in {m["name"] for m in _run_report(tmp_path / "small")["counters"]}
    big = run(10_000, tmp_path / "big")
    gauges = {m["name"]: m["value"] for m in _run_report(tmp_path / "big")["gauges"]}
    assert "stream.chunk_rows" not in gauges and big["stream_chunks"] is None
