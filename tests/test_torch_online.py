"""Online GAME learning in the port: onboarding, the feeds, the delta, the
refresh service, its fleet publish and the ``online_game`` driver.

The contracts of the reference's ``test_online.py`` and
``test_online_growth.py``, held by the port on the CPU and against the JAX
package on the same numpy data (``make_game_data``, a few hundred rows):

- onboarding grows a random-effect layout in place to the JAX package's
  grown layout exactly (bins, slots, rows, weights), and the fit on it
  matches a full rebuild within the reference's 1e-5
  (``test_online_growth.py:89,121,139,289``); the estimator's grown fit
  matches the JAX package's within the GAME tolerance of
  ``test_torch_game_drivers.py`` (rtol = atol = 1e-3);
- ``merge_append`` and ``compute_delta`` give the reference's output;
- one refresh round's model matches the JAX package's refresh (metrics and
  coefficients within the GAME tolerance), and the bench fixture's
  in-bench checks (``bench.py:2834-2925``) hold: the refreshed model within
  1e-4 of a full retrain on the merged data, no random-effect layout
  rebuilt, rows grown in place, no new capture in serving.
"""

import json
import os
import time

import numpy as np
import pytest

from photon_tpu.data.synthetic import make_game_data
from photon_tpu.game import coordinate as jcoord
from photon_tpu.game import data as jdata
from photon_tpu.game.estimator import GameEstimator as JaxEstimator
from photon_tpu.game.estimator import GameOptimizationConfiguration as JaxConfig
from photon_tpu import online as jonline
from photon_tpu_torch import online
from photon_tpu_torch.core.objective import RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.drivers import online_game
from photon_tpu_torch.fault.injection import FaultPlan, InjectedKillError, set_plan
from photon_tpu_torch.game.coordinate import (
    FixedEffectCoordinateConfig,
    RandomEffectCoordinate,
    RandomEffectCoordinateConfig,
    RandomEffectDeviceData,
)
from photon_tpu_torch.game.data import DenseShard, GameDataset
from photon_tpu_torch.game.estimator import (
    GameEstimator,
    GameOptimizationConfiguration,
)
from photon_tpu_torch.game.model import GameModel
from photon_tpu_torch.serving import ServingFleet, build_requests
from photon_tpu_torch.serving.scorer import request_spec_for_dataset
from photon_tpu_torch.telemetry import TelemetrySession

GROWTH_ATOL = 1e-5  # tests/test_online_growth.py
COEF_TOL = 1e-3  # tests/test_torch_game_drivers.py
METRIC_TOL = 1e-4
RETRAIN_TOL = 1e-4  # bench.py's in-bench parity with a full retrain
TASK = "linear_regression"


@pytest.fixture(autouse=True)
def _fault_hygiene(monkeypatch):
    monkeypatch.setenv("PHOTON_IO_RETRY_BASE_S", "0")
    set_plan(None)
    yield
    set_plan(None)


def _counter(session, name, **labels) -> float:
    return sum(m["value"] for m in session.registry.snapshot()["counters"]
               if m["name"] == name and all((m.get("labels") or {}).get(k) == v
                                            for k, v in labels.items()))


def _both(label, shards: dict, id_columns: dict):
    """The same numpy rows as a port and a JAX dataset."""
    port = GameDataset.create(label, {n: DenseShard(x) for n, x in shards.items()},
                              id_columns=dict(id_columns))
    ref = jdata.GameDataset.create(label, {n: jdata.DenseShard(x) for n, x in shards.items()},
                                   id_columns=dict(id_columns))
    return port, ref


# -- onboarding: in place, against a rebuild and the JAX package -------------


def _growth_case(case: str):
    """``(base, grown)`` raw arrays of ``test_online_growth.py``'s cases."""
    raw = make_game_data(30, 4, 5, 4, seed=11, n_random_coords=1)
    base = {"label": raw["label"], "x": raw["x_random"]["re0"],
            "uid": raw["entity_ids"]["re0"]}

    def grow(prev, seed, existing_below=10, new_from=35, n_source=40):
        extra = make_game_data(n_source, 3, 5, 4, seed=seed, n_random_coords=1)
        ids = extra["entity_ids"]["re0"]
        keep = (ids < existing_below) | (ids >= new_from)
        return {"label": np.concatenate([prev["label"], extra["label"][keep]]),
                "x": np.concatenate([prev["x"], extra["x_random"]["re0"][keep]]),
                "uid": np.concatenate([prev["uid"], ids[keep]])}

    if case == "migrate":  # one entity gets more rows than any bin holds
        rng = np.random.default_rng(7)
        n_new = 64
        steps = [{"label": np.concatenate([base["label"], (rng.random(n_new) < 0.5)
                                           .astype(np.float32)]),
                  "x": np.concatenate([base["x"], rng.normal(size=(n_new, 4))
                                       .astype(np.float32)]),
                  "uid": np.concatenate([base["uid"],
                                         np.full(n_new, base["uid"][0], np.int64)])}]
    else:
        steps = [grow(base, 12)]
        if case == "repeated":
            steps.append(grow(steps[0], 13, existing_below=15, new_from=38, n_source=45))
    return base, steps


def _datasets(arrays):
    return _both(arrays["label"], {"pe": arrays["x"]}, {"uid": arrays["uid"]})


def _problem(lam=1.0, iters=30, tolerance=1e-7):
    return ProblemConfig(regularization=RegularizationContext("l2", lam),
                         optimizer_config=OptimizerConfig(max_iterations=iters,
                                                          tolerance=tolerance))


def _jax_problem(lam=1.0, iters=30, tolerance=1e-7):
    from photon_tpu.core.objective import RegularizationContext as JR
    from photon_tpu.core.optimizers import OptimizerConfig as JO
    from photon_tpu.core.problem import ProblemConfig as JP

    return JP(regularization=JR("l2", lam),
              optimizer_config=JO(max_iterations=iters, tolerance=tolerance))


@pytest.mark.parametrize("case,projection", [
    ("existing", "none"), ("repeated", "none"), ("migrate", "none"),
    ("existing", "index_map"),
])
def test_onboarding_grows_in_place_like_the_reference(case, projection):
    base, steps = _growth_case(case)
    port_base, ref_base = _datasets(base)
    config = RandomEffectCoordinateConfig("pe", "uid", _problem(), projection=projection)
    ref_config = jcoord.RandomEffectCoordinateConfig("pe", "uid", _jax_problem(),
                                                     projection=projection)
    session = TelemetrySession("grow")
    dd = RandomEffectDeviceData(port_base, config, device="cpu")
    ref_dd = jcoord.RandomEffectDeviceData(ref_base, ref_config)
    n_bins = len(dd.buckets)
    for step in steps:
        grown, ref_grown = _datasets(step)
        dd.onboard(grown, telemetry=session)
        ref_dd.onboard(ref_grown)
    # The grown layout is the reference's, slot for slot.
    assert len(dd.buckets) == len(ref_dd.buckets) >= n_bins
    for b, rb in zip(dd.buckets, ref_dd.buckets):
        for field in ("entity_index", "row_index", "row_weight", "label"):
            np.testing.assert_array_equal(getattr(b, field), getattr(rb, field))
        np.testing.assert_array_equal(b.features.x, rb.features.x)
    np.testing.assert_array_equal(dd.dataset.entity_idx_per_row,
                                  ref_dd.dataset.entity_idx_per_row)
    # The fit on it matches a full rebuild (the fit itself is held to the
    # reference's on equal layouts by test_torch_batched_solve.py).
    zeros = np.zeros(grown.num_examples, np.float32)
    model, stats = RandomEffectCoordinate(grown, config, "logistic_regression",
                                          device_data=dd).train(zeros)
    rebuilt, _ = RandomEffectCoordinate(grown, config, "logistic_regression",
                                        device="cpu").train(zeros)
    np.testing.assert_array_equal(model.keys, rebuilt.keys)
    np.testing.assert_allclose(model.table.numpy(), rebuilt.table.numpy(),
                               atol=GROWTH_ATOL, rtol=0)
    assert stats["entities"] == dd.dataset.num_entities
    counts = {name: _counter(session, name) for name in (
        "onboard.rows_in_place", "onboard.entities_migrated", "onboard.entities_new")}
    if projection != "none":
        assert counts["onboard.rows_in_place"] == 0 < counts["onboard.entities_migrated"]
    elif case == "migrate":
        assert counts["onboard.entities_migrated"] == 1
    else:
        assert counts["onboard.rows_in_place"] > 0 and counts["onboard.entities_new"] > 0


def _estimator_fixture(seed, n_entities=30, two_random=False):
    raw = make_game_data(n_entities, 4, 5, 4, seed=seed, n_random_coords=2)
    shards = {"global": raw["x_fixed"], "re0": raw["x_random"]["re0"]}
    ids = {"re0": raw["entity_ids"]["re0"]}
    if two_random:
        shards["re1"] = raw["x_random"]["re1"]
        ids["re1"] = raw["entity_ids"]["re1"]
    return raw["label"], shards, ids


def test_estimator_growth_matches_fresh_estimator_and_is_atomic():
    label, shards, ids = _estimator_fixture(81)
    base, ref_base = _both(label, shards, ids)
    lab2, sh2, ids2 = _estimator_fixture(82, n_entities=40)
    keep = (ids2["re0"] < 10) | (ids2["re0"] >= 35)
    grown, ref_grown = _both(np.concatenate([label, lab2[keep]]),
                     {n: np.concatenate([shards[n], sh2[n][keep]]) for n in shards},
                     {n: np.concatenate([ids[n], ids2[n][keep]]) for n in ids})
    config = GameOptimizationConfiguration(coordinates={
        "fixed": FixedEffectCoordinateConfig("global", _problem()),
        "per_entity": RandomEffectCoordinateConfig("re0", "re0", _problem()),
    }, descent_iterations=2)
    session = TelemetrySession("t")
    est = GameEstimator("logistic_regression", base, device="cpu", telemetry=session)
    first = est.fit([config])[0]
    # A batch one layout must refuse changes nothing.
    bad = GameDataset(grown.label, grown.offset, grown.weight,
                      {"global": grown.shards["global"]}, dict(grown.id_columns))
    with pytest.raises(KeyError):
        est.onboard_training_data(bad)
    assert est.training_data is base
    assert all(len(dd.dataset.entity_idx_per_row) == base.num_examples
               for dd in est._device_data_cache.values() if hasattr(dd, "dataset"))
    est.onboard_training_data(grown)
    dd = est.device_layout(config.coordinates["per_entity"])
    warm = GameModel({"fixed": first.model.coordinate("fixed"),
                      "per_entity": first.model.coordinate("per_entity")
                      .with_entities(dd.dataset.keys)}, "logistic_regression")
    second = est.fit([config], initial_model=warm)[0]
    fresh = GameEstimator("logistic_regression", grown, device="cpu").fit(
        [config], initial_model=warm)[0]
    for name in config.coordinates:
        got, want = second.model.coordinate(name), fresh.model.coordinate(name)
        got, want = ((got.table, want.table) if hasattr(got, "table")
                     else (got.coefficients.means, want.coefficients.means))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GROWTH_ATOL, rtol=0)
    assert _counter(session, "estimator.device_data_rebuilds", kind="random") == 0
    assert _counter(session, "estimator.device_data_rebuilds", kind="fixed") == 1
    # The fixed batch was rebuilt at the grown row count.
    fixed_dd = est.device_layout(config.coordinates["fixed"])
    assert fixed_dd.batch.num_examples == grown.num_examples
    # The JAX package's estimator, grown the same way from its own first
    # fit, lands within the GAME tolerance.
    ref_config = JaxConfig(coordinates={
        "fixed": jcoord.FixedEffectCoordinateConfig("global", _jax_problem()),
        "per_entity": jcoord.RandomEffectCoordinateConfig("re0", "re0", _jax_problem()),
    }, descent_iterations=2)
    ref_est = JaxEstimator("logistic_regression", ref_base)
    ref_first = ref_est.fit([ref_config])[0]
    ref_est.onboard_training_data(ref_grown)
    ref_keys = ref_est.device_layout(ref_config.coordinates["per_entity"]).dataset.keys
    np.testing.assert_array_equal(np.asarray(ref_keys), dd.dataset.keys)
    from photon_tpu.game.model import GameModel as JaxGameModel

    ref_warm = JaxGameModel({"fixed": ref_first.model.coordinate("fixed"),
                             "per_entity": ref_first.model.coordinate("per_entity")
                             .with_entities(ref_keys)}, "logistic_regression")
    ref_second = ref_est.fit([ref_config], initial_model=ref_warm)[0]
    for name in config.coordinates:
        got, want = second.model.coordinate(name), ref_second.model.coordinate(name)
        got, want = ((got.table, want.table) if hasattr(got, "table")
                     else (got.coefficients.means, want.coefficients.means))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=COEF_TOL,
                                   rtol=COEF_TOL, err_msg=name)


# -- merge and delta against the reference -----------------------------------


def _cut(n_ent, seed, keep=None, columns=("re0", "re1"), dtype=None):
    raw = make_game_data(n_ent, 4, 6, 4, seed=seed, n_random_coords=2)
    sel = slice(None) if keep is None else keep(raw["entity_ids"]["re0"])
    cols = {c: raw["entity_ids"][c][sel] for c in columns}
    if dtype is not None:
        cols = {c: v.astype(dtype) for c, v in cols.items()}
    return _both(raw["label"][sel], {"global": raw["x_fixed"][sel],
                                     "re0": raw["x_random"]["re0"][sel],
                                     "re1": raw["x_random"]["re1"][sel]}, cols)


def _online_config(iters=2, tolerance=1e-9):
    return GameOptimizationConfiguration(coordinates={
        "fixed": FixedEffectCoordinateConfig("global", _problem(0.01, 50, tolerance)),
        "per_user": RandomEffectCoordinateConfig("re0", "re0", _problem(1.0, 50, tolerance)),
        "per_item": RandomEffectCoordinateConfig("re1", "re1", _problem(1.0, 50, tolerance)),
    }, descent_iterations=iters)


def _jax_online_config(iters=2, tolerance=1e-9):
    return JaxConfig(coordinates={
        "fixed": jcoord.FixedEffectCoordinateConfig("global", _jax_problem(0.01, 50, tolerance)),
        "per_user": jcoord.RandomEffectCoordinateConfig("re0", "re0",
                                                        _jax_problem(1.0, 50, tolerance)),
        "per_item": jcoord.RandomEffectCoordinateConfig("re1", "re1",
                                                        _jax_problem(1.0, 50, tolerance)),
    }, descent_iterations=iters)


@pytest.mark.parametrize("batch_kind", ["missing_column", "narrow_ints", "new_and_existing"])
def test_merge_append_and_delta_match_the_reference(batch_kind):
    base, ref_base = _cut(20, 0, dtype=np.int32 if batch_kind == "narrow_ints" else None)
    keep = lambda ids: (ids < 5) | (ids >= 25)  # noqa: E731
    columns = ("re0",) if batch_kind == "missing_column" else ("re0", "re1")
    batch, ref_batch = _cut(30, 1, keep=keep, columns=columns)
    merged, absent = online.merge_append(base, batch)
    ref_merged, ref_absent = jonline.merge_append(ref_base, ref_batch)
    for field in ("label", "offset", "weight"):
        np.testing.assert_array_equal(getattr(merged, field), getattr(ref_merged, field))
    for name in merged.shards:
        np.testing.assert_array_equal(merged.shards[name].x, ref_merged.shards[name].x)
    for name in merged.id_columns:
        np.testing.assert_array_equal(merged.id_columns[name], ref_merged.id_columns[name])
        assert merged.id_columns[name].dtype == ref_merged.id_columns[name].dtype
        np.testing.assert_array_equal(absent[name], ref_absent[name])
    vocabs = {c: np.unique(base.id_columns[c]) for c in base.id_columns}
    delta = online.compute_delta(_online_config().coordinates, vocabs, batch, absent)
    ref_delta = jonline.compute_delta(_jax_online_config().coordinates, vocabs, ref_batch,
                                      ref_absent)
    assert delta.touched == ref_delta.touched and delta.untouched == ref_delta.untouched
    for name, cd in delta.coordinates.items():
        rd = ref_delta.coordinates[name]
        np.testing.assert_array_equal(cd.new_keys, rd.new_keys)
        np.testing.assert_array_equal(cd.existing_keys, rd.existing_keys)
    merged2 = online.merge_deltas([delta, delta])
    assert merged2.rows == 2 * delta.rows and merged2.untouched == delta.untouched
    with pytest.raises(ValueError, match="every feature shard"):
        online.merge_append(base, GameDataset(batch.label, batch.offset, batch.weight,
                                              {"re0": batch.shards["re0"]},
                                              dict(batch.id_columns)))


# -- feeds --------------------------------------------------------------------


def test_feeds_peek_commit_and_durable_cursor(tmp_path):
    feed = online.QueueFeed()
    a, b = feed.append(_cut(5, 0)[0]), feed.append(_cut(5, 1)[0])
    assert feed.poll() == [a, b] == feed.poll()  # peek, not consume
    feed.mark_consumed([a])
    assert feed.poll() == [b] and feed.pending_rows() == b.data.num_examples
    loads = []

    def loader(path):
        loads.append(os.path.basename(path))
        return _cut(5, len(loads))[0]

    d = tmp_path / "parts"
    d.mkdir()
    for name in ("part-001.avro", "part-000.avro", "_consumed.tmp", ".hidden.avro"):
        (d / name).write_bytes(b"x")
    session = TelemetrySession("feed")
    set_plan(FaultPlan.parse("online:ingest:times=2"))
    pending = online.DirectoryFeed(str(d), loader, telemetry=session).poll()
    set_plan(None)
    assert [p.source for p in pending] == ["part-000.avro", "part-001.avro"]
    assert _counter(session, "io.retries", site="online:ingest") == 2
    feed = online.DirectoryFeed(str(d), loader)
    feed.poll()
    feed.mark_consumed(pending[:1])
    loads.clear()
    again = online.DirectoryFeed(str(d), loader)
    assert [p.source for p in again.poll()] == ["part-001.avro"]
    assert loads == ["part-001.avro"] and again.consumed_sources() == ["part-000.avro"]
    set_plan(FaultPlan.parse("online:ingest:p=1.0"))
    with pytest.raises(OSError, match="online:ingest"):
        online.DirectoryFeed(str(d), loader).poll()


# -- the refresh service -----------------------------------------------------


def test_one_refresh_matches_the_reference_refresh():
    base, ref_base = _cut(30, 0)
    keep = lambda ids: (ids < 6) | (ids >= 30)  # noqa: E731
    batch, ref_batch = _cut(34, 1, keep=keep, columns=("re0",))
    models = {}
    for pkg in ("port", "ref"):
        if pkg == "port":
            est = GameEstimator(TASK, base, device="cpu")
            config, mod, data = _online_config(), online, batch
        else:
            est = JaxEstimator(TASK, ref_base)
            config, mod, data = _jax_online_config(), jonline, ref_batch
        model0 = est.fit([config])[0].model
        feed = mod.QueueFeed()
        service = mod.OnlineLearningService(est, config, feed, model=model0,
                                            policy=mod.RefreshPolicy(refresh_iterations=2))
        feed.append(data)
        result = service.refresh_once()
        assert result.locked == ["per_item"] and not result.published
        models[pkg] = (result.model, est.training_data)
    (model, merged), (ref_model, _) = models["port"], models["ref"]
    for name in ("fixed", "per_user", "per_item"):
        got, want = model.coordinate(name), ref_model.coordinate(name)
        if hasattr(got, "table"):
            np.testing.assert_array_equal(got.keys, np.asarray(want.keys))
            got, want = got.table.numpy(), np.asarray(want.table)
        else:
            got, want = got.coefficients.means.numpy(), np.asarray(want.coefficients.means)
        np.testing.assert_allclose(got, want, rtol=COEF_TOL, atol=COEF_TOL, err_msg=name)
    np.testing.assert_allclose(model.score(merged), np.asarray(ref_model.score(
        jdata.GameDataset.create(merged.label, {n: jdata.DenseShard(s.x)
                                                for n, s in merged.shards.items()},
                                 id_columns=dict(merged.id_columns)))),
        atol=METRIC_TOL, rtol=0)


def _bench_cut(n_ent, seed, keep=None):
    """``bench.py``'s online fixture (``bench.py:2864-2881``), smaller."""
    raw = make_game_data(n_ent, 6, 32, 8, seed=seed, n_random_coords=2)
    sel = slice(None) if keep is None else keep(raw["entity_ids"]["re0"])
    return _both(raw["label"][sel], {"global": raw["x_fixed"][sel],
                                     "re0": raw["x_random"]["re0"][sel],
                                     "re1": raw["x_random"]["re1"][sel]},
                 {c: raw["entity_ids"][c][sel] for c in ("re0", "re1")})[0]


def _bench_config():
    coords = {"fixed": FixedEffectCoordinateConfig("global", _problem(0.01, 5))}
    for i in range(2):
        coords[f"re{i}"] = RandomEffectCoordinateConfig(f"re{i}", f"re{i}", _problem(1.0, 4))
    return GameOptimizationConfiguration(coordinates=coords, descent_iterations=3)


def test_service_publishes_through_the_fleet_like_the_bench(tmp_path):
    n = 120
    base = _bench_cut(n, 0)
    config = _bench_config()
    session = TelemetrySession("online")
    est = GameEstimator(TASK, base, device="cpu", telemetry=session)
    model0 = est.fit([config])[0].model
    fleet = ServingFleet(model0, replicas=2, device="cpu",
                         request_spec=request_spec_for_dataset(model0, base),
                         telemetry=session, table_capacity_factor=2).warmup()
    captured = fleet.compilations
    feed = online.QueueFeed()
    ckpt = str(tmp_path / "rounds")
    service = online.OnlineLearningService(
        est, config, feed, model=model0, fleet=fleet, checkpoint_dir=ckpt,
        policy=online.RefreshPolicy(refresh_iterations=3), telemetry=session)
    keep = lambda ids: (ids < n // 10) | (ids >= n)  # noqa: E731
    try:
        feed.append(_bench_cut(int(n * 1.05), 1, keep))
        first = service.refresh_once()
        merged1 = est.training_data
        # Live traffic on the grown vocabulary during the second publish.
        traffic = build_requests(merged1, first.model, [4] * 12)
        futures = [fleet.submit(r) for r in traffic[:6]]
        feed.append(_bench_cut(int(n * 1.05), 2, keep))
        second = service.refresh_once()
        futures += [fleet.submit(r) for r in traffic[6:]]
        assert all(np.isfinite(f.result(timeout=60)).all() for f in futures)
        assert first.published and second.published
        assert fleet.compilations == captured  # no new capture across publishes
        assert fleet.current_model()[0] is second.model
    finally:
        fleet.close()
    assert _counter(session, "estimator.device_data_rebuilds", kind="random") == 0
    assert _counter(session, "onboard.rows_in_place") > 0
    assert open(os.path.join(ckpt, "rounds.txt")).read().split() == [
        "round-000000", "round-000001"]
    # The full-retrain oracle: fresh layouts over round 1's merged data.
    fresh = GameEstimator(TASK, merged1, device="cpu")
    warm = GameModel({name: (m.with_entities(fresh.device_layout(config.coordinates[name])
                                             .dataset.keys)
                             if hasattr(m, "with_entities") else m)
                      for name, m in model0.coordinates.items()}, TASK)
    full = fresh.fit([config], initial_model=warm)[0].model
    assert np.abs(first.model.score(merged1) - full.score(merged1)).max() <= RETRAIN_TOL


def test_growth_past_the_served_capacity_rebuilds_the_fleet():
    base = _bench_cut(40, 0)
    config = _bench_config()
    est = GameEstimator(TASK, base, device="cpu")
    model0 = est.fit([config])[0].model
    fleet = ServingFleet(model0, replicas=2, device="cpu",
                         request_spec=request_spec_for_dataset(model0, base),
                         table_capacity_factor=1).warmup()
    feed = online.QueueFeed()
    session = TelemetrySession("grow")
    service = online.OnlineLearningService(est, config, feed, model=model0, fleet=fleet,
                                           telemetry=session)
    try:
        feed.append(_bench_cut(120, 1, keep=lambda ids: ids >= 40))
        result = service.refresh_once()
        assert result.published and fleet.current_model()[0] is result.model
        assert _counter(session, "online.fleet_rebuilds") == 1
    finally:
        fleet.close()
    with pytest.raises(NotImplementedError, match="item 7"):
        online.OnlineLearningService(est, config, feed, model=model0, model_id="t")


def test_refresh_kills_resume_and_publish_exactly(tmp_path):
    base, _ = _cut(30, 0)
    config = _online_config(iters=2)
    est_args = (TASK, base)
    batch = _cut(34, 1, keep=lambda ids: (ids < 6) | (ids >= 30))[0]

    def service(ckpt):
        est = GameEstimator(*est_args, device="cpu")
        model0 = est.fit([config])[0].model
        feed = online.QueueFeed()
        feed.append(batch)
        return online.OnlineLearningService(
            est, config, feed, model=model0, checkpoint_dir=ckpt,
            policy=online.RefreshPolicy(refresh_iterations=3))

    clean = service(str(tmp_path / "clean")).refresh_once().model
    for site in ("descent:kill:iter=2", "online:refresh:kill"):
        ckpt = str(tmp_path / site.replace(":", "-"))
        set_plan(FaultPlan.parse(site))
        with pytest.raises(InjectedKillError):
            service(ckpt).refresh_once()
        set_plan(None)
        # The restart drains the same backlog; the round checkpoint carries
        # the descent (complete, for the kill between train and publish).
        resumed = service(ckpt).refresh_once()
        for name, m in clean.coordinates.items():
            got = resumed.model.coordinate(name)
            a, b = ((m.table, got.table) if hasattr(m, "table")
                    else (m.coefficients.means, got.coefficients.means))
            assert np.array_equal(a.numpy(), b.numpy()), (site, name)
    # The background loop runs the same round.
    background = service(str(tmp_path / "background"))
    served = background.model
    with background.start():
        deadline = time.monotonic() + 60
        while background.model is served and time.monotonic() < deadline:
            time.sleep(0.05)
    assert background.model is not served
    np.testing.assert_array_equal(background.model.coordinate("per_user").table.numpy(),
                                  clean.coordinate("per_user").table.numpy())


def test_replica_crash_and_hang_reroute_without_loss():
    base = _bench_cut(40, 0)
    config = _bench_config()
    model = GameEstimator(TASK, base, device="cpu").fit([config])[0].model
    want = model.score(base)
    session = TelemetrySession("faults")
    for spec in ("replica:crash:replica=r0:times=1", "replica:hang:replica=r0:times=1"):
        fleet = ServingFleet(model, replicas=2, device="cpu",
                             request_spec=request_spec_for_dataset(model, base),
                             telemetry=session).warmup()
        try:
            set_plan(FaultPlan.parse(spec))
            requests = build_requests(base, model, [4] * 10)
            futures = [fleet.submit(r) for r in requests]
            if "hang" in spec:
                # The wedged batch waits for detection from outside (a
                # supervisor's probe deadline, here set by hand).
                time.sleep(0.3)
                fleet.replicas[0].alive = False
            got = np.concatenate([f.result(timeout=60) for f in futures])
            set_plan(None)
            np.testing.assert_allclose(got, want[:len(got)], atol=1e-5, rtol=0)
            assert not fleet.replicas[0].alive and fleet.replicas[1].alive
        finally:
            fleet.close()


# -- the online_game driver ----------------------------------------------------


def test_online_game_driver_runs_and_restarts(tmp_path):
    from photon_tpu_torch.data.fixtures import make_movielens_like
    from photon_tpu_torch.data.game_io import write_game_avro
    from photon_tpu_torch.game.data import take_rows

    data, maps = make_movielens_like(n_users=60, n_items=40, mean_ratings=8)
    users = data.id_columns["userId"]
    late = np.isin(users, np.unique(users)[-6:])  # users only in the appends
    rng = np.random.default_rng(0)
    part_of = np.where(late, rng.integers(1, 4, len(users)),
                       np.where(rng.random(len(users)) < 0.7, 0,
                                rng.integers(1, 4, len(users))))
    appends = tmp_path / "appends"
    appends.mkdir()
    write_game_avro(str(tmp_path / "initial.avro"),
                    take_rows(data, np.nonzero(part_of == 0)[0]), maps)
    args = ["--input", str(tmp_path / "initial.avro"), "--append-dir", str(appends),
            "--feature-bags", "global=global,per_user=per_user",
            "--id-columns", "userId,itemId",
            "--coordinate", "fixed:type=fixed,shard=global,max_iters=10",
            "--coordinate", "per_user:type=random,shard=per_user,entity=userId,max_iters=5",
            "--replicas", "2", "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--backend", "cpu"]
    for k in (1, 2):
        write_game_avro(str(appends / f"part-{k:03d}.avro"),
                        take_rows(data, np.nonzero(part_of == k)[0]), maps)
    first = online_game.run(online_game.build_parser().parse_args(
        [*args, "--output-dir", str(tmp_path / "out1")]))
    assert first["rounds"] == 1 and first["rows_ingested"] == int((part_of > 0).sum()
                                                                  - (part_of == 3).sum())
    # A restart re-merges the published parts and ingests only the new one.
    write_game_avro(str(appends / "part-003.avro"),
                    take_rows(data, np.nonzero(part_of == 3)[0]), maps)
    second = online_game.run(online_game.build_parser().parse_args(
        [*args, "--output-dir", str(tmp_path / "out2")]))
    assert second["rounds"] == 1 and second["rows_ingested"] == int((part_of == 3).sum())
    summary = json.load(open(tmp_path / "out2" / "online_summary.json"))
    assert summary["published"] == 1 and os.path.isdir(summary["model_dir"])
    for flag in (["--transport", "tcp"], ["--replica-backend", "subprocess"]):
        with pytest.raises(NotImplementedError, match="item 7"):
            online_game.run(online_game.build_parser().parse_args(
                [*args, "--output-dir", str(tmp_path / "x"), *flag]))


def test_avro_reads_retry_injected_io_faults(tmp_path, monkeypatch):
    """Each part's read sits behind ``io:read`` and retries (both readers)."""
    from photon_tpu_torch.data.fixtures import make_movielens_like
    from photon_tpu_torch.data.game_io import read_game_avro, write_game_avro

    data, maps = make_movielens_like(n_users=20, n_items=10, mean_ratings=4)
    path = str(tmp_path / "part.avro")
    write_game_avro(path, data, maps)
    bags = {"global": "global", "per_user": "per_user"}
    clean, _ = read_game_avro(path, bags, ["userId"])
    for native_off in ("", "1"):
        monkeypatch.setenv("PHOTON_TPU_NO_NATIVE_AVRO", native_off)
        set_plan(FaultPlan.parse("io:read:times=2"))
        got, _ = read_game_avro(path, bags, ["userId"])
        np.testing.assert_array_equal(got.label, clean.label)
        set_plan(FaultPlan.parse("io:read:p=1"))
        with pytest.raises(OSError):
            read_game_avro(path, bags, ["userId"])
