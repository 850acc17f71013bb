"""Spilled (disk-tier) streamed GAME training in the port against the JAX
package.

Holds the estimator's ``spill_dir`` / ``max_host_mb`` / ``tile_dtype`` and
``train_game --spill-dir / --max-host-mb / --tile-dtype`` to
``tests/test_ooc_game.py:592-948``'s and ``tests/test_lowp.py``'s spilled
contracts, on ``tests/test_torch_ooc_game.py``'s fixture
(``make_game_dataset(100, 5, 6, 3, seed=0, n_random_coords=1)``, split
0.25, chunks of 37 rows):

- a spilled fit under a host budget of 1.5 chunks equals the
  host-resident streamed fit bit for bit, the tiles on disk equal a
  recomputation from its models, and the cache evicts within its budget;
- a mid-epoch kill resumes exactly (adopting the flushed tiles), a corrupt
  tile is refused, stale tiles are rebuilt and the fit stays exact, at
  ``f32`` and at a lossy tier;
- injected ``tile:read`` and ``tile:write`` faults retry to the same fit,
  compression changes no bit, the lossy tiers stay within
  ``tile_metric_tol_for`` of the f32 fit;
- the estimator's and the driver's gates, ``--max-host-mb`` turning
  spilling on;
- the port's spilled fit against the JAX package's under the streamed
  pins, and spilled checkpoints with their stores resumed across the
  packages both ways.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxOpt
from photon_tpu.core.problem import ProblemConfig as JaxProblem
from photon_tpu.data.synthetic import make_game_dataset as jax_make_game_dataset
from photon_tpu.fault.injection import FaultPlan as JaxFaultPlan
from photon_tpu.fault.injection import InjectedKillError as JaxKillError
from photon_tpu.fault.injection import set_plan as jax_set_plan
from photon_tpu.game import coordinate as jcoord
from photon_tpu.game.data import split_game_dataset as jax_split
from photon_tpu.game.estimator import GameEstimator as JaxEstimator
from photon_tpu.game.estimator import GameOptimizationConfiguration as JaxConfig
from photon_tpu.telemetry import TelemetrySession as JaxSession
from photon_tpu_torch.core.objective import RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.fault.checkpoint import DescentCheckpointer
from photon_tpu_torch.fault.injection import FaultPlan, InjectedKillError, set_plan
from photon_tpu_torch.game.coordinate import (
    FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.data import DenseShard, GameDataset, SparseShard
from photon_tpu_torch.game.estimator import GameEstimator, GameOptimizationConfiguration
from photon_tpu_torch.game.lowp import tile_metric_tol_for
from photon_tpu_torch.game.tile_store import CorruptTileError, TileStore
from photon_tpu_torch.game.tiles import (
    RESIDUAL_TILE_KIND,
    ChunkPlan,
    ChunkStreamer,
    per_row_bytes,
    score_model_chunks,
)
from photon_tpu_torch.telemetry import TelemetrySession

CHUNK = 37
RMS_TOL, MAX_TOL, METRIC_TOL = 1e-4, 5e-4, 1e-4  # tests/test_torch_ooc_game.py
KILL = "descent:kill:iter=1:coord=re0"


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    monkeypatch.setenv("PHOTON_IO_RETRY_BASE_S", "0")
    monkeypatch.delenv("PHOTON_TILE_COMPRESS", raising=False)
    for reset in (set_plan, jax_set_plan):
        reset(None)
    yield
    for reset in (set_plan, jax_set_plan):
        reset(None)


def _problem(lam):
    return ProblemConfig(regularization=RegularizationContext("l2", lam),
                         optimizer_config=OptimizerConfig(
                             max_iterations=80, tolerance=1e-11, gradient_tolerance=1e-8))


def _config(iters=2):
    return GameOptimizationConfiguration(coordinates={
        "fixed": FixedEffectCoordinateConfig("global", _problem(1.0)),
        "re0": RandomEffectCoordinateConfig("re0", "re0", _problem(1.0)),
    }, descent_iterations=iters, name="spill")


def _jax_config(iters=2):
    def problem(lam):
        return JaxProblem(regularization=JaxReg("l2", lam),
                          optimizer_config=JaxOpt(max_iterations=80, tolerance=1e-11,
                                                  gradient_tolerance=1e-8))

    return JaxConfig(coordinates={
        "fixed": jcoord.FixedEffectCoordinateConfig("global", problem(1.0)),
        "re0": jcoord.RandomEffectCoordinateConfig("re0", "re0", problem(1.0)),
    }, descent_iterations=iters, name="spill")


def _to_port(data) -> GameDataset:
    def shard(s):
        if hasattr(s, "x"):
            return DenseShard(np.asarray(s.x))
        return SparseShard(np.asarray(s.ids), np.asarray(s.vals), s.dim_)

    return GameDataset(np.asarray(data.label), np.asarray(data.offset),
                       np.asarray(data.weight),
                       {n: shard(s) for n, s in data.shards.items()},
                       {n: np.asarray(c) for n, c in data.id_columns.items()})


@pytest.fixture(scope="module")
def jax_data():
    data, _ = jax_make_game_dataset(100, 5, 6, 3, seed=0, n_random_coords=1)
    return jax_split(data, 0.25, seed=1)


@pytest.fixture(scope="module")
def game_data(jax_data):
    return tuple(_to_port(d) for d in jax_data)


def _estimator(train, val, spill_dir=None, **kw):
    if spill_dir is not None:
        kw["spill_dir"] = str(spill_dir)
    return GameEstimator("linear_regression", train, validation_data=val, device="cpu",
                         stream_chunks=CHUNK, **kw)


def _score(model, data) -> np.ndarray:
    return np.asarray(model.score(data))


def _weights(model) -> dict:
    return {name: (m.table if hasattr(m, "table") else m.coefficients.means).numpy()
            for name, m in model.coordinates.items()}


def _assert_same_fit(a, b, data):
    for name, w in _weights(a.model).items():
        np.testing.assert_array_equal(w, _weights(b.model)[name], err_msg=name)
    np.testing.assert_array_equal(_score(a.model, data), _score(b.model, data))
    assert a.metrics == b.metrics


def _counters(session, labelled=False) -> dict:
    return {m["name"]: m["value"] for m in session.registry.snapshot()["counters"]
            if labelled or not m["labels"]}


@pytest.fixture(scope="module")
def streamed_fit(game_data):
    """The host-resident streamed fit, the spilled fits' reference."""
    return _estimator(*game_data).fit([_config()])[0]


@pytest.fixture(scope="module")
def spilled_fit(game_data, tmp_path_factory):
    """One spilled fit under a host budget of 1.5 feature chunks: every
    entry fits it, and every pass must evict."""
    train, val = game_data
    spill_dir = tmp_path_factory.mktemp("tile_store")
    session = TelemetrySession("t-spilled-fit")
    budget = int(1.5 * CHUNK * per_row_bytes(train))
    estimator = _estimator(train, val, spill_dir, max_host_mb=budget / (1 << 20),
                           telemetry=session)
    result = estimator.fit([_config()])[0]
    return result, session, spill_dir, budget, estimator


def _killed(fit, jax=False):
    if jax:
        jax_set_plan(JaxFaultPlan.parse(KILL))
        try:
            with pytest.raises(JaxKillError):
                fit()
        finally:
            jax_set_plan(None)
        return
    set_plan(FaultPlan.parse(KILL))
    try:
        with pytest.raises(InjectedKillError):
            fit()
    finally:
        set_plan(None)


# -- the spilled fit -------------------------------------------------------------


def test_spilled_fit_matches_host_resident_streamed_bitwise(spilled_fit, streamed_fit,
                                                            game_data):
    _assert_same_fit(spilled_fit[0], streamed_fit, game_data[1])


def test_spilled_tiles_on_disk_match_recomputation(spilled_fit, game_data):
    train, _ = game_data
    result, _, spill_dir, _, _ = spilled_fit
    plan = ChunkPlan(train.num_examples, CHUNK)
    store = TileStore(str(spill_dir))
    last = result.descent.last_model.coordinates
    rows = {name: score_model_chunks(model, train, plan, ChunkStreamer())
            for name, model in last.items()}
    for k in range(plan.num_chunks):
        arrays, meta = store.read(RESIDUAL_TILE_KIND, k)
        lo, hi = plan.bounds(k)
        np.testing.assert_array_equal(arrays["tile"],
                                      np.stack([rows[n][lo:hi] for n in last]))
        assert len(meta["tile_digest"]) == 16


def test_spilled_eviction_respects_host_budget(spilled_fit):
    _, session, _, budget, estimator = spilled_fit
    snap = session.registry.snapshot()
    counters = _counters(session)
    gauges = {m["name"]: m["value"] for m in snap["gauges"] if not m["labels"]}
    assert counters["tiles.cache_evictions"] > 0 and counters["tiles.cache_misses"] > 0
    assert 0 < gauges["tiles.host_cache_bytes"] <= budget
    cache = estimator._spill.cache
    assert cache.largest_entry_bytes <= budget and cache.peak_bytes <= budget
    assert gauges["tiles.disk_bytes"] == estimator._spill.store.disk_bytes > 0
    tiered = {(m["name"], m["labels"].get("tier")) for m in snap["counters"]
              if "tier" in m["labels"]}
    assert {("stream.stall_s", "disk"), ("stream.stall_s", "h2d"),
            ("stream.prefetch_overlap_s", "disk")} <= tiered
    labelled = {(m["name"], m["labels"].get("path")): m["value"]
                for m in snap["counters"] if "path" in m["labels"]}
    # Each sweep wrote back once; three coordinates' updates of a tile coalesce.
    assert labelled[("tiles.writeback_flushes", "residuals")] >= 2
    assert labelled[("tiles.writeback_flush_s", "residuals")] >= 0


# -- kill, resume, corruption, stale tiles ------------------------------------------


@pytest.mark.parametrize("tier", ["f32", "int8"])
def test_spilled_kill_resume_corrupt_and_stale(game_data, tmp_path, tier):
    """A mid-epoch kill leaves a spilled checkpoint (no rows, the digests of
    the flushed tiles): resumed it adopts them and ends at the
    uninterrupted fit exactly; with a tile byte flipped the resume raises
    ``CorruptTileError``; with a tile gone it rebuilds (``tiles.rebuilt``
    1) and still ends exactly."""
    train, val = game_data
    kw = {} if tier == "f32" else {"tile_dtype": tier}
    baseline = _estimator(train, val, tmp_path / "base", **kw).fit([_config()])[0]
    _killed(lambda: _estimator(train, val, tmp_path / "store", **kw).fit(
        [_config()], checkpoint_dir=str(tmp_path / "ck"), resume="auto"))
    state = DescentCheckpointer(str(tmp_path / "ck" / "cfg-000")).load("latest",
                                                                      device="cpu")
    assert state.stream["cursor"] == 1 and state.stream["spilled"] is True
    assert state.residual_rows == {}
    assert len(state.stream["tile_digests"]) == ChunkPlan(train.num_examples,
                                                          CHUNK).num_chunks
    for name in ("corrupt", "stale"):
        shutil.copytree(tmp_path / "ck", tmp_path / f"ck_{name}")
        shutil.copytree(tmp_path / "store", tmp_path / f"store_{name}")
    session = TelemetrySession("t-adopt")
    resumed = _estimator(train, val, tmp_path / "store", telemetry=session, **kw).fit(
        [_config()], checkpoint_dir=str(tmp_path / "ck"), resume="auto")[0]
    _assert_same_fit(resumed, baseline, val)
    np.testing.assert_array_equal(_score(resumed.model, train),
                                  _score(baseline.model, train))
    assert _counters(session).get("tiles.rebuilt", 0) == 0
    assert _counters(session)["residuals.tiles_attached"] > 0

    store = TileStore(str(tmp_path / "store_corrupt"))
    path = store.path(RESIDUAL_TILE_KIND, 0)
    blob = bytearray(open(path, "rb").read())
    blob[-5] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(CorruptTileError):
        _estimator(train, val, tmp_path / "store_corrupt", **kw).fit(
            [_config()], checkpoint_dir=str(tmp_path / "ck_corrupt"), resume="auto")

    TileStore(str(tmp_path / "store_stale")).delete(RESIDUAL_TILE_KIND, 1)
    session = TelemetrySession("t-rebuild")
    rebuilt = _estimator(train, val, tmp_path / "store_stale", telemetry=session,
                         **kw).fit([_config()], checkpoint_dir=str(tmp_path / "ck_stale"),
                                   resume="auto")[0]
    assert _counters(session)["tiles.rebuilt"] == 1
    assert "tiles.rebuilt_unverified" not in _counters(session)
    _assert_same_fit(rebuilt, baseline, val)


# -- faults, compression, lossy tiers ------------------------------------------


def test_spilled_fit_with_injected_tile_faults(game_data, tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_IO_RETRIES", "8")
    train, val = game_data
    clean = _estimator(train, val, tmp_path / "clean").fit([_config(iters=1)])[0]
    session = TelemetrySession("t-tile-faults")
    set_plan(FaultPlan.parse("tile:read:p=0.5,tile:write:p=0.3", seed=7))
    faulted = _estimator(train, val, tmp_path / "faulted", telemetry=session).fit(
        [_config(iters=1)])[0]
    set_plan(None)
    _assert_same_fit(faulted, clean, val)
    retries = {m["labels"].get("site"): m["value"]
               for m in session.registry.snapshot()["counters"]
               if m["name"] == "io.retries"}
    assert retries.get("tile:read", 0) > 0 and retries.get("tile:write", 0) > 0


def test_spilled_fit_with_compression_bit_identical(game_data, tmp_path, monkeypatch,
                                                    streamed_fit):
    monkeypatch.setenv("PHOTON_TILE_COMPRESS", "1")
    train, val = game_data
    compressed = _estimator(train, val, tmp_path / "store").fit([_config()])[0]
    assert TileStore(str(tmp_path / "store")).compress
    _assert_same_fit(compressed, streamed_fit, val)


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_spilled_fit_metric_parity_per_codec(game_data, tmp_path, streamed_fit, tier):
    train, val = game_data
    result = _estimator(train, val, tmp_path, tile_dtype=tier).fit([_config()])[0]
    tol = tile_metric_tol_for(tier)
    for name, value in streamed_fit.metrics.items():
        assert abs(value - result.metrics[name]) <= tol, (name, value, result.metrics)


# -- gates and the driver ----------------------------------------------------------


def test_spill_estimator_gates(game_data):
    train, _ = game_data
    cases = [
        (dict(spill_dir="x"), "stream_chunks"),
        (dict(stream_chunks=CHUNK, spill_dir="x", max_host_mb=0), "max_host_mb"),
        (dict(stream_chunks=CHUNK, max_host_mb=1.0), "spill_dir"),
        (dict(stream_chunks=CHUNK, tile_dtype="bf16"), "spill_dir"),
        (dict(stream_chunks=CHUNK, spill_dir="x", tile_dtype="int4"), "tile dtype"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            GameEstimator("linear_regression", train, device="cpu", **kw)


DRIVER = ["--input", "synthetic-game:60:4:6:3", "--task", "linear_regression",
          "--coordinate", "fixed:type=fixed,shard=global,max_iters=25",
          "--coordinate", "re0:type=random,shard=re0,entity=re0,max_iters=25",
          "--descent-iterations", "1", "--validation-split", "0.25", "--backend", "cpu"]


def _report_gauges(out) -> dict:
    with open(os.path.join(out, "telemetry", "run_report.json")) as f:
        return {m["name"]: m["value"] for m in json.load(f)["metrics"]["gauges"]
                if not m["labels"]}


def test_train_game_spill_flags(tmp_path):
    """``--stream-chunks --spill-dir --tile-dtype`` train spilled;
    ``--max-host-mb`` alone turns streaming and spilling on under
    ``<output-dir>/tile_store``; a generous budget keeps the host tiles;
    ``--spill-dir`` without streaming and ``--tile-dtype`` without a store
    are refused."""
    from photon_tpu_torch.drivers import train_game

    def run(out, *extra):
        return train_game.run(train_game.build_parser().parse_args(
            [*DRIVER, "--output-dir", str(tmp_path / out), *extra]))

    summary = run("explicit", "--stream-chunks", "53", "--spill-dir",
                  str(tmp_path / "store"), "--tile-dtype", "bf16")
    assert summary["best_metrics"] and summary["stream_chunks"] == 53
    with open(TileStore(str(tmp_path / "store")).path("feat", 0), "rb") as f:
        from photon_tpu_torch.game.tile_store import _read_header

        codecs = {e["name"]: e["codec"] for e in _read_header(f)["arrays"]}
    assert codecs["s:global:x"] == "bf16" and codecs["label"] == "f32"
    gauges = _report_gauges(tmp_path / "explicit")
    assert gauges["stream.spilled"] == 1 and gauges["tiles.disk_bytes"] > 0

    run("auto", "--max-host-mb", "0.001")
    assert (tmp_path / "auto" / "tile_store").is_dir()
    gauges = _report_gauges(tmp_path / "auto")
    assert gauges["stream.spilled"] == 1 and gauges["stream.chunk_rows"] >= 1
    assert gauges["stream.host_estimate_bytes"] > 0.001 * (1 << 20)
    assert gauges["tiles.disk_bytes"] > 0
    # The report's streaming section shows both tiers and the cache and store.
    from photon_tpu_torch.telemetry.report import render_markdown

    with open(tmp_path / "auto" / "telemetry" / "run_report.json") as f:
        text = render_markdown(json.load(f))
    section = text[text.index("## Streaming tiers"):]
    for line in ("| disk |", "| h2d |", "**tiles.cache_misses**",
                 "**tiles.cache_evictions**", "**tiles.host_cache_bytes**",
                 "**tiles.disk_bytes**"):
        assert line in section, line

    run("generous", "--stream-chunks", "53", "--max-host-mb", "10000")
    assert not (tmp_path / "generous" / "tile_store").exists()
    assert "stream.spilled" not in _report_gauges(tmp_path / "generous")

    with pytest.raises(ValueError, match="streamed mode"):
        run("no_stream", "--spill-dir", str(tmp_path / "s2"))
    with pytest.raises(ValueError, match="max-host-mb"):
        run("zero", "--max-host-mb", "0")
    with pytest.raises(ValueError, match="spill_dir"):
        run("tile_dtype", "--stream-chunks", "53", "--tile-dtype", "int8")


# -- across the packages ----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_spilled_fit(jax_data, tmp_path_factory):
    train, val = jax_data
    return JaxEstimator("linear_regression", train, validation_data=val,
                        stream_chunks=CHUNK,
                        spill_dir=str(tmp_path_factory.mktemp("jax_store"))).fit(
        [_jax_config()])[0]


def _parity(ours, theirs, val, jval):
    diff = _score(ours.model, val) - np.asarray(theirs.model.score(jval))
    assert float(np.sqrt(np.mean(diff * diff))) <= RMS_TOL
    assert np.abs(diff).max() <= MAX_TOL
    for name, value in theirs.metrics.items():
        assert abs(value - ours.metrics[name]) <= METRIC_TOL, name


def test_spilled_fit_matches_the_jax_spilled_fit(spilled_fit, jax_spilled_fit, game_data,
                                                 jax_data):
    _parity(spilled_fit[0], jax_spilled_fit, game_data[1], jax_data[1])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spilled_checkpoints_resume_across_packages(game_data, jax_data, tmp_path,
                                                    writer):
    """A spilled mid-epoch checkpoint and its store, written by one package,
    resume in both.  The port flushes before every checkpoint, so the JAX
    package adopts its tiles; the reference does not flush before a
    mid-epoch checkpoint, so the port rebuilds the reference's."""
    train, val = game_data
    jtrain, jval = jax_data
    ck, store = str(tmp_path / "ck"), str(tmp_path / "store")
    if writer == "jax":
        _killed(lambda: JaxEstimator("linear_regression", jtrain, validation_data=jval,
                                     stream_chunks=CHUNK, spill_dir=store).fit(
            [_jax_config()], checkpoint_dir=ck, resume="auto"), jax=True)
    else:
        _killed(lambda: _estimator(train, val, store).fit(
            [_config()], checkpoint_dir=ck, resume="auto"))
    for name in ("jax", "torch"):
        shutil.copytree(ck, str(tmp_path / f"ck_{name}"))
        shutil.copytree(store, str(tmp_path / f"store_{name}"))
    session, jsession = TelemetrySession("t-port"), JaxSession("t-jax")
    by_port = _estimator(train, val, tmp_path / "store_torch", telemetry=session).fit(
        [_config()], checkpoint_dir=str(tmp_path / "ck_torch"), resume="latest")[0]
    by_jax = JaxEstimator("linear_regression", jtrain, validation_data=jval,
                          stream_chunks=CHUNK, spill_dir=str(tmp_path / "store_jax"),
                          telemetry=jsession).fit(
        [_jax_config()], checkpoint_dir=str(tmp_path / "ck_jax"), resume="latest")[0]
    assert [h["iteration"] for h in by_port.descent.history] == [0, 1]
    _parity(by_port, by_jax, val, jval)
    counts = {(pkg, name): _counters(sess).get(name, 0)
              for pkg, sess in (("torch", session), ("jax", jsession))
              for name in ("tiles.rebuilt", "tiles.rebuilt_unverified")}
    # The port's rebuild of the reference's tiles differs in last bits from
    # the reference's own: kept, and counted.
    want = ({("torch", "tiles.rebuilt"): 1, ("torch", "tiles.rebuilt_unverified"): 1,
             ("jax", "tiles.rebuilt"): 1, ("jax", "tiles.rebuilt_unverified"): 0}
            if writer == "jax" else dict.fromkeys(counts, 0))
    assert counts == want
