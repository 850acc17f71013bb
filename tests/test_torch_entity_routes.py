"""Port parity of the random-effect bin dispatch: the route table, each
route through ``RandomEffectCoordinate.train`` against the reference's
coordinate, the NaN quarantine on every route and the ``solves.*``
telemetry.

Mirrors ``tests/test_batched_solve.py``: ``test_solver_route_selection``
(:172), the quarantine (:335) and the bin gauges (:657).  The Newton-CG
route polishes past the float32 value floor and is held within 1e-5; the
``vmapped`` routes are held within 1e-4 over the iterations before a lane
reaches that floor (``tests/test_torch_lane_solvers.py`` says why), and at
full convergence, cold and warm-started, within 1e-5 of each entity's
float64 optimum.
"""

import numpy as np
import pytest

from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxOptimizerConfig
from photon_tpu.core.problem import ProblemConfig as JaxProblemConfig
from photon_tpu.data.synthetic import make_game_data
from photon_tpu.game import batched_solve as jbs
from photon_tpu.game import coordinate as jcoord
from photon_tpu.game import data as jdata
from photon_tpu.telemetry import TelemetrySession as JaxSession
from photon_tpu_torch.core.objective import RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.game import batched_solve as tbs
from photon_tpu_torch.game import coordinate as tcoord
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.telemetry import TelemetrySession
from tests.test_torch_lane_solvers import (
    END_POINT_ATOL,
    END_POINT_ITERATIONS,
    dense_lanes,
    float64_optimum,
)

ENV_KEYS = ("PHOTON_SOLVE_BINNING", "PHOTON_SOLVE_NEWTON", "PHOTON_SOLVE_NEWTON_CG",
            "PHOTON_NEWTON_MAX_DIM", "PHOTON_NEWTON_CG_MAX_DIM")


def _dataset(n_entities=40, dim=6, seed=3):
    raw = make_game_data(n_entities=n_entities, rows_per_entity_mean=6, fixed_dim=5,
                         random_dim=dim, seed=seed)
    label, ids = raw["label"], {"userId": raw["entity_ids"]["re0"]}
    x = raw["x_random"]["re0"]
    return (jdata.GameDataset.create(label, {"re": jdata.DenseShard(x)}, ids),
            tdata.GameDataset.create(label, {"re": tdata.DenseShard(x)}, ids))


def _problems(optimizer="lbfgs", reg=("l2", 1.0), max_iterations=100):
    cfg = dict(max_iterations=max_iterations, tolerance=0.0, gradient_tolerance=1e-8)
    return (JaxProblemConfig(optimizer=optimizer, regularization=JaxReg(*reg),
                             optimizer_config=JaxOptimizerConfig(**cfg)),
            ProblemConfig(optimizer=optimizer, regularization=RegularizationContext(*reg),
                          optimizer_config=OptimizerConfig(**cfg)))


def _coordinates(jd, td, jprob, tprob, **config_kw):
    return (jcoord.RandomEffectCoordinate(
                jd, jcoord.RandomEffectCoordinateConfig("re", "userId", jprob, **config_kw),
                "logistic_regression"),
            tcoord.RandomEffectCoordinate(
                td, tcoord.RandomEffectCoordinateConfig("re", "userId", tprob, **config_kw),
                "logistic_regression", device="cpu"))


def test_solver_route_selection(monkeypatch):
    """``test_solver_route_selection`` (the reference's :172) with the
    port's knobs, each answer the reference's."""
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    jsmooth, tsmooth = _problems()
    jl1, tl1 = _problems("owlqn", ("l1", 0.5))
    jcg, tcg = _problems("newton_cg")
    jtron, ttron = _problems("tron")
    assert tbs.solver_route(tsmooth, 8) == "newton"
    assert tbs.solver_route(tsmooth, 8, row_split=True) == "row_split"
    assert tbs.solver_route(tsmooth, 10_000) == "vmapped"
    assert tbs.solver_route(tl1, 8) == "vmapped"
    envs = ({}, {"PHOTON_SOLVE_NEWTON": "off"}, {"PHOTON_SOLVE_NEWTON_CG": "off"},
            {"PHOTON_NEWTON_MAX_DIM": "0"}, {"PHOTON_NEWTON_CG_MAX_DIM": "100"},
            {"PHOTON_SOLVE_NEWTON": "0", "PHOTON_SOLVE_NEWTON_CG": "false"})
    for env in envs:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for jp, tp in ((jsmooth, tsmooth), (jl1, tl1), (jcg, tcg), (jtron, ttron)):
            for dim in (1, 8, 64, 65, 100, 101, 1024, 1025, 10_000):
                for row_split in (False, True):
                    assert (tbs.solver_route(tp, dim, row_split)
                            == jbs.solver_route(jp, dim, row_split)), (env, tp, dim)
        for k in env:
            monkeypatch.delenv(k)
    monkeypatch.setenv("PHOTON_SOLVE_NEWTON", "off")
    assert tbs.solver_route(tsmooth, 8) == "vmapped"


@pytest.mark.parametrize("env,optimizer,reg,max_iterations,atol,route,warm", [
    # Newton-CG at every dim (bench.py's _hidim_solve_env), to its end point.
    ({"PHOTON_NEWTON_MAX_DIM": "0"}, "lbfgs", ("l2", 1.0), 100, 1e-5, "newton_cg", True),
    # Explicit Newton-CG at a dim the dense Newton would take.
    ({}, "newton_cg", ("l2", 1.0), 100, 1e-5, "newton_cg", True),
    # The vmapped routes, before the float32 floor.  TRON's second fit,
    # warm-started two iterations deep, runs into it: held cold only.
    ({"PHOTON_SOLVE_NEWTON": "off"}, "lbfgs", ("l2", 1.0), 4, 1e-4, "vmapped", True),
    ({}, "owlqn", ("elastic_net", 1.0), 4, 1e-4, "vmapped", True),
    ({"PHOTON_SOLVE_NEWTON": "off"}, "tron", ("l2", 1.0), 2, 1e-4, "vmapped", False),
])
def test_coordinate_routes_match_reference(monkeypatch, env, optimizer, reg,
                                           max_iterations, atol, route, warm):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jd, td = _dataset()
    jc, tc = _coordinates(jd, td, *_problems(optimizer, reg, max_iterations))
    assert tc.routes == jc._bin_routes() == [route] * len(tc.routes)
    offsets = (0.1 * np.random.default_rng(0).standard_normal(jd.num_examples)
               ).astype(np.float32)
    jm, js = jc.train(offsets)
    tm, ts = tc.train(offsets)
    np.testing.assert_allclose(tm.table.numpy(), np.asarray(jm.table), atol=atol, rtol=0)
    for key in ("entities", "quarantined"):
        assert ts[key] == js[key]
    if route == "newton_cg":
        # Per-entity inner CG work, the same bins' entities beside it.
        assert ts["cg_entities"] == js["cg_entities"] == ts["entities"]
        assert ts["cg_iters"] > 0
    assert {b["route"] for b in ts.bins} == {route}
    if not warm:
        return
    # A warm start from its own model, as the next descent iteration does.
    jm2, _ = jc.train(offsets, initial_model=jm)
    tm2, _ = tc.train(offsets, initial_model=tm)
    np.testing.assert_allclose(tm2.table.numpy(), np.asarray(jm2.table), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("env,optimizer,reg", [
    ({"PHOTON_SOLVE_NEWTON": "off"}, "lbfgs", ("l2", 1.0)),
    ({}, "owlqn", ("l1", 0.3)),
    ({}, "owlqn", ("elastic_net", 1.0)),
    ({"PHOTON_SOLVE_NEWTON": "off"}, "tron", ("l2", 1.0)),
])
def test_vmapped_routes_reach_the_float64_optimum(monkeypatch, env, optimizer, reg):
    """The ``vmapped`` route through ``RandomEffectCoordinate.train`` at full
    convergence, cold and then warm-started from its own model as the next
    descent iteration does: every entity's row within ``END_POINT_ATOL`` of
    its float64 optimum, the L1 rows on its zeros exactly, no lane at the
    iteration cap."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, td = _dataset()
    _, tprob = _problems(optimizer, reg, END_POINT_ITERATIONS)
    coord = tcoord.RandomEffectCoordinate(
        td, tcoord.RandomEffectCoordinateConfig("re", "userId", tprob),
        "logistic_regression", device="cpu")
    assert set(coord.routes) == {"vmapped"}
    offsets = (0.1 * np.random.default_rng(0).standard_normal(td.num_examples)
               ).astype(np.float32)
    data, n = coord.device_data, coord.dataset.num_entities
    truth = np.zeros((n + 1, coord.dim))
    for i, bucket in enumerate(data.device_buckets):
        lanes = dense_lanes(data.batch_for(i, data.bin_offsets(i, offsets)), coord.dim)
        truth[bucket["entity_index"].numpy()] = float64_optimum(
            *lanes, "logistic_regression", coord.objective.l2_weight,
            coord.objective.l1_weight)
    model = None
    for _ in range(2):
        model, stats = coord.train(offsets, initial_model=model)
        table = model.table.double().numpy()
        np.testing.assert_allclose(table, truth[:n], atol=END_POINT_ATOL, rtol=0)
        if reg[0] != "l2":
            np.testing.assert_array_equal(table == 0.0, truth[:n] == 0.0)
        assert stats["iterations_max"] < END_POINT_ITERATIONS
        if optimizer != "tron":  # TRON stops at its collapsed trust region
            assert stats["converged"] == n


@pytest.mark.parametrize("env,optimizer,reg,fit", [
    ({}, "lbfgs", ("l2", 1.0), "run_newton_fit"),
    ({"PHOTON_NEWTON_MAX_DIM": "0"}, "lbfgs", ("l2", 1.0), "run_newton_cg_fit"),
    ({}, "owlqn", ("l1", 0.3), "run_lane_fit"),
    ({"PHOTON_SOLVE_NEWTON": "off"}, "tron", ("l2", 1.0), "run_lane_fit"),
])
def test_nan_quarantine_on_every_route(monkeypatch, env, optimizer, reg, fit):
    """The reference's quarantine (:335) on each route: the poisoned entity
    cold-starts at zero and is not counted converged; its bin-mates are
    solved."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, td = _dataset(n_entities=20, seed=4)
    _, tprob = _problems(optimizer, reg, 20)
    coord = tcoord.RandomEffectCoordinate(
        td, tcoord.RandomEffectCoordinateConfig("re", "userId", tprob),
        "logistic_regression", device="cpu")
    real = getattr(tcoord, fit)
    poisoned_bins = []

    def poisoned(*args, **kw):
        coefficients, result = real(*args, **kw)
        if not poisoned_bins:
            coefficients.means[0, 0] = float("nan")
        poisoned_bins.append(1)
        return coefficients, result

    monkeypatch.setattr(tcoord, fit, poisoned)
    model, stats = coord.train(np.zeros(td.num_examples, np.float32))
    table = model.table.numpy()
    assert np.isfinite(table).all()
    assert stats["quarantined"] == 1
    assert stats["converged"] <= stats["entities"] - 1
    first = int(coord.device_data.device_buckets[0]["entity_index"][0])
    assert (table[first] == 0.0).all()
    assert np.abs(table).sum() > 0


def _gauges(snapshot):
    return {(g["name"], g["labels"]["bin"]): (g["value"], g["labels"]["route"],
                                             g["labels"]["capacity"])
            for g in snapshot["gauges"] if g["name"].startswith("solves.")}


@pytest.mark.parametrize("env,optimizer,reg,route", [
    ({}, "lbfgs", ("l2", 1.0), "newton"),
    ({"PHOTON_NEWTON_MAX_DIM": "2"}, "lbfgs", ("l2", 1.0), "newton_cg"),
    ({}, "owlqn", ("l1", 0.3), "vmapped"),
])
def test_bin_telemetry_matches_reference_gauges(monkeypatch, env, optimizer, reg, route):
    """``record_bin_telemetry`` (the reference's :657): the same gauges and
    ``solves.routed`` counters as the reference's, every bin on its route."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jd, td = _dataset()
    jc, tc = _coordinates(jd, td, *_problems(optimizer, reg, 5))
    jsession, tsession = JaxSession("t-bins"), TelemetrySession("t-bins")
    jc.telemetry, jc.fault_name = jsession, "re"
    tc.telemetry, tc.name = tsession, "re"
    offsets = np.zeros(jd.num_examples, np.float32)
    jc.train(offsets)
    tc.train(offsets)
    tc.train(offsets)  # gauges are set once a layout
    jsnap, tsnap = jsession.registry.snapshot(), tsession.registry.snapshot()
    assert _gauges(tsnap) == _gauges(jsnap)
    assert {v[1] for v in _gauges(tsnap).values()} == {route}
    occupancy = sum(v[0] for (name, _), v in _gauges(tsnap).items()
                    if name == "solves.bin_occupancy")
    assert occupancy == tc.dataset.num_entities
    routed = [c for c in tsnap["counters"] if c["name"] == "solves.routed"]
    assert routed == [c for c in jsnap["counters"] if c["name"] == "solves.routed"]
    assert [c["value"] for c in routed] == [tc.dataset.num_entities]


def test_report_renders_the_routes_of_a_train_game_run(tmp_path):
    """A ``train_game`` run's report shows each coordinate's bins with their
    routes, so a bin that went by an unexpected route is visible."""
    import json

    from photon_tpu_torch.drivers import train_game
    from photon_tpu_torch.telemetry.report import render_markdown

    args = ["--input", "synthetic-game:30:5:4:3", "--coordinate",
            "fixed:type=fixed,shard=global,max_iters=10", "--coordinate",
            "re0:type=random,shard=re0,entity=re0,reg_type=l1,max_iters=10",
            "--output-dir", str(tmp_path), "--backend", "cpu"]
    train_game.run(train_game.build_parser().parse_args(args))
    report = json.loads((tmp_path / "telemetry" / "run_report.json").read_text())
    text = render_markdown(report)
    assert "## Entity solves" in text and "vmapped" in text
    routed = [c for c in report["metrics"]["counters"] if c["name"] == "solves.routed"]
    assert routed and routed[0]["labels"] == {"coordinate": "re0", "route": "vmapped"}


def test_entities_fixture_is_bench_and_hidim_routes_agree(monkeypatch):
    """The port's copy of ``bench.py``'s entity fixture gives its arrays,
    and on it ``bench.py``'s high-dimension assertion holds on the CPU:
    every bin on the Newton-CG route (``PHOTON_NEWTON_MAX_DIM=0``), and the
    Newton-CG and vmapped L-BFGS routes within p99 5e-3 and max 5e-2."""
    import bench

    from photon_tpu_torch.data.fixtures import make_entities_dataset

    ref = bench._entities_dataset(60, rows_mean=6, dim=64, seed=5)
    data = make_entities_dataset(60, rows_mean=6, dim=64, seed=5)
    np.testing.assert_array_equal(data.label, ref.label)
    np.testing.assert_array_equal(data.shards["re0"].x, ref.shards["re0"].x)
    np.testing.assert_array_equal(data.id_columns["re0"], ref.id_columns["re0"])
    config = tcoord.RandomEffectCoordinateConfig(
        "re0", "re0", problem=ProblemConfig(
            regularization=RegularizationContext("l2", 1.0),
            optimizer_config=OptimizerConfig(max_iterations=50)))
    tables = {}
    for path, env in (("newton_cg", {"PHOTON_NEWTON_MAX_DIM": "0"}),
                      ("lbfgs", {"PHOTON_SOLVE_NEWTON": "off",
                                 "PHOTON_SOLVE_NEWTON_CG": "off"})):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            coord = tcoord.RandomEffectCoordinate(data, config, "logistic_regression",
                                                  device="cpu")
            assert set(coord.routes) == {"newton_cg" if path == "newton_cg" else "vmapped"}
            tables[path] = coord.train(np.zeros(data.num_examples, np.float32))[0].table
    diff = (tables["newton_cg"] - tables["lbfgs"]).abs().numpy()
    assert np.quantile(diff, 0.99) <= 5e-3 and diff.max() <= 5e-2
