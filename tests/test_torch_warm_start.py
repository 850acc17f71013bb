"""Port parity of GAME warm starts and locked coordinates, and of
``train_game`` with ``--initial-model``, ``--locked-coordinates`` and a
``factored_random`` coordinate.

Mirrors ``tests/test_game.py:308-370`` (a locked coordinate keeps the
initial model's coefficients bit for bit; a foreign vocabulary aligns by
key; locking without an initial model raises) and
``tests/test_batched_solve.py:296`` (the foreign join is cached per keys
object and its host traffic counted).  The drivers are held to the bounds
of ``tests/test_torch_game_drivers.py``: validation metrics within 1e-4,
coefficients within rtol = atol = 1e-3.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxOptimizerConfig
from photon_tpu.core.problem import ProblemConfig as JaxProblemConfig
from photon_tpu.data.fixtures import make_movielens_like
from photon_tpu.data.game_io import write_game_avro
from photon_tpu.data.synthetic import make_game_data
from photon_tpu.drivers import train_game as jax_train_game
from photon_tpu.game import coordinate as jcoord
from photon_tpu.game import data as jdata
from photon_tpu.game.model_io import load_game_model as jax_load
from photon_tpu_torch.core.objective import RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.drivers import train_game
from photon_tpu_torch.game import coordinate as tcoord
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.estimator import GameEstimator, GameOptimizationConfiguration
from photon_tpu_torch.game.model_io import load_game_model
from photon_tpu_torch.telemetry import TelemetrySession

METRIC_TOL = 1e-4
COEF_TOL = 1e-3


def _dataset(n_entities=25, seed=9, rows_mean=8):
    raw = make_game_data(n_entities=n_entities, rows_per_entity_mean=rows_mean,
                         fixed_dim=5, random_dim=4, seed=seed)
    label, ids = raw["label"], {"userId": raw["entity_ids"]["re0"]}
    shards = {"global": raw["x_fixed"], "per_entity": raw["x_random"]["re0"]}
    return (jdata.GameDataset.create(label, {k: jdata.DenseShard(v)
                                             for k, v in shards.items()}, ids),
            tdata.GameDataset.create(label, {k: tdata.DenseShard(v)
                                             for k, v in shards.items()}, ids))


def _problem(max_iterations=20):
    return ProblemConfig(regularization=RegularizationContext("l2", 1.0),
                         optimizer_config=OptimizerConfig(max_iterations=max_iterations))


def _configs():
    return GameOptimizationConfiguration({
        "fixed": tcoord.FixedEffectCoordinateConfig("global", _problem()),
        "per-user": tcoord.RandomEffectCoordinateConfig("per_entity", "userId",
                                                        _problem()),
    })


def test_warm_start_and_locked_coordinates():
    _, td = _dataset()
    train, val = tdata.split_game_dataset(td, 0.25)
    est = GameEstimator("logistic_regression", train, val, device="cpu")
    first = est.fit([_configs()])[0]
    second = est.fit([_configs()], initial_model=first.model,
                     locked_coordinates=["fixed"])[0]
    assert torch.equal(second.model.coordinate("fixed").coefficients.means,
                       first.model.coordinate("fixed").coefficients.means)
    assert "per-user" in second.model.coordinates
    # The unlocked coordinate trained from the warm start: one more pass
    # against the same offsets moves it by little.
    moved = (second.model.coordinate("per-user").table
             - first.model.coordinate("per-user").table).abs().max()
    assert 0.0 < float(moved) < 0.5
    solver = second.descent.history[0]["solver"]
    assert set(solver) == {"per-user"}  # the locked coordinate never trains


def test_locked_coordinate_checks():
    _, td = _dataset(n_entities=10, seed=11)
    est = GameEstimator("logistic_regression", td, device="cpu")
    with pytest.raises(ValueError, match="initial model"):
        est.fit([_configs()], locked_coordinates=["fixed"])
    model = est.fit([_configs()])[0].model
    with pytest.raises(KeyError, match="not in update sequence"):
        est.fit([_configs()], initial_model=model, locked_coordinates=["bogus"])
    partial = dataclasses.replace(model, coordinates={"per-user": model.coordinate("per-user")})
    with pytest.raises(KeyError, match="missing from initial model"):
        est.fit([_configs()], initial_model=partial, locked_coordinates=["fixed"])


def _random_coordinates(jd, td, max_iterations=5):
    jprob = JaxProblemConfig(regularization=JaxReg("l2", 1.0),
                             optimizer_config=JaxOptimizerConfig(max_iterations=max_iterations))
    tprob = _problem(max_iterations)
    return (jcoord.RandomEffectCoordinate(
                jd, jcoord.RandomEffectCoordinateConfig("per_entity", "userId", jprob),
                "logistic_regression"),
            tcoord.RandomEffectCoordinate(
                td, tcoord.RandomEffectCoordinateConfig("per_entity", "userId", tprob),
                "logistic_regression", device="cpu"))


def test_warm_start_aligns_entity_vocabularies_by_key():
    """A model trained on another entity set joins by key, not by index
    (the reference's :336): the aligned table equals the reference's."""
    jd, td = _dataset(n_entities=12, seed=13)
    jc, tc = _random_coordinates(jd, td)
    model, _ = tc.train(np.zeros(td.num_examples, np.float32))
    shifted = dataclasses.replace(model, keys=model.keys + 6)  # keys 6..17
    jmodel = jcoord.RandomEffectModel(
        table=model.table.numpy(), keys=shifted.keys, entity_column=model.entity_column,
        shard_name=model.shard_name, task_type=model.task_type)
    init = tc._initial_table(shifted).numpy()
    np.testing.assert_array_equal(init, np.asarray(jc._initial_table(jmodel)))
    for e, key in enumerate(tc.dataset.keys):
        src = np.searchsorted(shifted.keys, key)
        if src < len(shifted.keys) and shifted.keys[src] == key:
            np.testing.assert_array_equal(init[e], model.table.numpy()[src])
        else:
            assert (init[e] == 0.0).all()


def test_warm_start_parity_and_join_cache():
    """The reference's :296: a foreign warm start's join is cached per keys
    object (a second warm start with the same keys reuses it) and its host
    traffic is counted; the warm-started solve equals the reference's."""
    jd, td = _dataset(n_entities=30, seed=3)
    jc, tc = _random_coordinates(jd, td, max_iterations=100)
    offsets = np.zeros(td.num_examples, np.float32)
    first, _ = tc.train(offsets)
    foreign = dataclasses.replace(first, keys=first.keys + 6)
    jforeign = jcoord.RandomEffectModel(
        table=first.table.numpy(), keys=foreign.keys, entity_column=first.entity_column,
        shard_name=first.shard_name, task_type=first.task_type)
    session = TelemetrySession("t-warm")
    tc.telemetry = session
    got, _ = tc.train(offsets, initial_model=foreign)
    cache = tc.device_data._warm_join_cache
    assert len(cache) == 1 and next(iter(cache.values()))[0] is foreign.keys
    tc.train(offsets, initial_model=foreign)
    assert len(cache) == 1
    joins = [c for c in session.registry.snapshot()["counters"]
             if c["name"] == "descent.host_transfer_bytes"
             and c["labels"].get("path") == "warm_start"]
    assert joins and all(c["value"] > 0 for c in joins)
    want, _ = jc.train(offsets, initial_model=jforeign)
    np.testing.assert_allclose(got.table.numpy(), np.asarray(want.table), atol=1e-5, rtol=0)


def test_prefetched_join_is_the_synchronous_join():
    _, td = _dataset(n_entities=30, seed=3)
    est = GameEstimator("logistic_regression", td, device="cpu")
    model = est.fit([_configs()])[0].model
    re = model.coordinate("per-user")
    foreign = dataclasses.replace(re, keys=re.keys + 6)
    initial = dataclasses.replace(model, coordinates={**model.coordinates,
                                                      "per-user": foreign})
    coords = est._build_coordinates(_configs())
    session = TelemetrySession("t-prefetch")
    assert tcoord.prefetch_warm_joins(coords, initial, session) == 1
    assert tcoord.prefetch_warm_joins(coords, initial, session) == 0  # scheduled
    assert tcoord.prefetch_warm_joins(coords, model, session) == 0  # own vocabulary
    device_data = coords["per-user"].device_data
    got = tcoord._foreign_src_idx(device_data, foreign.keys)
    np.testing.assert_array_equal(got, tdata.entity_index_for(device_data.dataset.keys,
                                                              foreign.keys))
    counted = [c for c in session.registry.snapshot()["counters"]
               if c["name"] == "descent.warm_join_prefetch"]
    assert [c["value"] for c in counted] == [1]


# The drivers: phase 9's runs of chip_smoke.py at a small size, the
# iterative entity solves cut to the iterations before a lane reaches the
# float32 value floor (tests/test_torch_lane_solvers.py says why).  The
# per-item solves are cut further: every row of an item carries the item's
# genres, so its data fix one direction and the ridge the rest, and on such
# lanes the port's float64 line search (LaneObjective's values) and the
# reference's float32 one part ways by the third iteration.
BAGS = "global=global,per_user=per_user"
# Run A's per-user coordinate is smooth here: an elastic-net lane's orthant
# choice turns on the last bit of its offsets, and the factored coordinate
# downstream carries the difference past 1e-3.  The elastic-net route is
# held on the same inputs in tests/test_torch_entity_routes.py.
RUN_A = [
    "--coordinate", "per_user:type=random,shard=per_user,entity=userId,max_iters=4",
    "--coordinate", "per_item:type=factored_random,shard=per_user,entity=itemId,"
                    "latent_dim=4,latent_iterations=2,max_iters=2",
    "--coordinate", "fixed:type=fixed,shard=global,max_iters=30",
]
RUN_B = [
    "--coordinate", "fixed:type=fixed,shard=global,max_iters=30",
    "--coordinate", "per_user:type=random,shard=per_user,entity=userId,optimizer=tron,"
                    "max_iters=2",
    "--coordinate", "per_item:type=random,shard=per_user,entity=itemId,"
                    "projection=index_map,max_iters=2",
]


def _args(avro, out, coords, extra=(), iterations=2):
    return ["--input", avro, "--feature-bags", BAGS, "--id-columns", "userId,itemId",
            *coords, "--descent-iterations", str(iterations), "--validation-split", "0.2",
            "--output-dir", out, "--backend", "cpu", *extra]


def _hold(got, ref, tmp_path, name):
    for th, jh in zip(got["sweep"][0]["history"], ref["sweep"][0]["history"]):
        for metric, value in jh["metrics"].items():
            assert abs(th["metrics"][metric] - value) <= METRIC_TOL, (metric, th, jh)
    jm, _ = jax_load(str(tmp_path / "jax" / name / "best_model"))
    tm, _ = load_game_model(str(tmp_path / "torch" / name / "best_model"), device="cpu")
    assert list(tm.coordinates) == list(jm.coordinates)
    np.testing.assert_allclose(tm.coordinate("fixed").coefficients.means.numpy(),
                               np.asarray(jm.coordinate("fixed").coefficients.means),
                               rtol=COEF_TOL, atol=COEF_TOL)
    for coord in (name for name in tm.coordinates if name != "fixed"):
        np.testing.assert_array_equal(tm.coordinate(coord).keys, jm.coordinate(coord).keys)
        np.testing.assert_allclose(tm.coordinate(coord).table.numpy(),
                                   np.asarray(jm.coordinate(coord).table),
                                   rtol=COEF_TOL, atol=COEF_TOL)
    return tm, jm


def test_train_game_warm_start_locked_and_factored_match_reference(tmp_path, monkeypatch):
    """Run A (per-user, factored per-item, one descent iteration) then run B from A's model with the fixed effect locked (TRON
    per-user with the dense Newton off, index-map per-item, two), each
    through both drivers."""
    data, maps = make_movielens_like(n_users=300, n_items=200, mean_ratings=15)
    avro = str(tmp_path / "ml.avro")
    write_game_avro(avro, data, maps)
    runs = {}
    for pkg, driver, extra in (("jax", jax_train_game, ["--no-telemetry"]),
                               ("torch", train_game, [])):
        runs[pkg, "a"] = driver.run(driver.build_parser().parse_args(
            _args(avro, str(tmp_path / pkg / "a"), RUN_A, extra, iterations=1)))
    a_torch, _ = _hold(runs["torch", "a"], runs["jax", "a"], tmp_path, "a")
    monkeypatch.setenv("PHOTON_SOLVE_NEWTON", "off")
    for pkg, driver, extra in (("jax", jax_train_game, ["--no-telemetry"]),
                               ("torch", train_game, [])):
        warm = ["--initial-model", str(tmp_path / pkg / "a" / "best_model"),
                "--locked-coordinates", "fixed", *extra]
        runs[pkg, "b"] = driver.run(driver.build_parser().parse_args(
            _args(avro, str(tmp_path / pkg / "b"), RUN_B, warm)))
    b_torch, _ = _hold(runs["torch", "b"], runs["jax", "b"], tmp_path, "b")
    assert torch.equal(b_torch.coordinate("fixed").coefficients.means,
                       a_torch.coordinate("fixed").coefficients.means)
    history = runs["torch", "b"]["sweep"][0]["history"]
    assert all("fixed" not in h["solver"] for h in history)
    routes = {b["route"] for h in history for b in h["solver"]["per_user"]["bins"]}
    assert routes == {"vmapped"}
    report = json.loads((tmp_path / "torch" / "b" / "telemetry" / "run_report.json")
                        .read_text())
    names = {c["name"] for c in report["metrics"]["counters"]}
    assert {"solves.routed", "descent.warm_join_prefetch",
            "descent.host_transfer_bytes"} <= names
