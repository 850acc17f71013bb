"""The GAME slice end to end: the port's ``train_game`` against the JAX
package's on the same Avro file, and GAME models across the packages.

BASELINE.json config 4 (fixed effect + per-user random effect, logistic)
on ``make_movielens_like()`` at its defaults, written to Avro and trained
by both drivers with the same arguments on the CPU.  Held to the
reference's own bounds: every validation metric of every descent
iteration within 1e-4 (``tests/test_residuals.py:260-265``), the fixed
effect's means and the random-effect table within rtol = atol = 1e-3
(``tests/test_game.py:377-385``), and each package's model files scored by
the other within 1e-5 (``tests/test_game_drivers.py:76``).
"""

import json
import os

import numpy as np
import pytest

from photon_tpu.data.fixtures import make_movielens_like
from photon_tpu.data.game_io import write_game_avro
from photon_tpu.drivers import train_game as jax_train_game
from photon_tpu.game.model_io import load_game_model as jax_load
from photon_tpu.game.model_io import save_game_model as jax_save
from photon_tpu_torch.drivers import train_game
from photon_tpu_torch.game.data import GameDataset, SparseShard
from photon_tpu_torch.game.model import game_model_from_numpy
from photon_tpu_torch.game.model_io import load_game_model, save_game_model

METRIC_TOL = 1e-4
COEF_TOL = 1e-3
SCORE_TOL = 1e-5
BAGS = "global=global,per_user=per_user"
COORDS = [
    "--coordinate", "fixed:type=fixed,shard=global,max_iters=30",
    "--coordinate", "per_user:type=random,shard=per_user,entity=userId,max_iters=20",
]


def _args(avro, out, extra=()):
    return ["--input", avro, "--feature-bags", BAGS, "--id-columns", "userId,itemId",
            *COORDS, "--descent-iterations", "2", "--validation-split", "0.2",
            "--output-dir", out, "--backend", "cpu", *extra]


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("game_slice")
    data, maps = make_movielens_like()
    avro = str(root / "movielens.avro")
    write_game_avro(avro, data, maps)
    jax_summary = jax_train_game.run(jax_train_game.build_parser().parse_args(
        _args(avro, str(root / "jax"), ["--no-telemetry"])))
    summary = train_game.run(train_game.build_parser().parse_args(
        _args(avro, str(root / "torch"))))
    return root, avro, jax_summary, summary


def _val_dataset(avro):
    """The validation rows both drivers held out (their split is numpy)."""
    from photon_tpu.data.game_io import read_game_avro
    from photon_tpu.game.data import split_game_dataset

    data, _ = read_game_avro(avro, {"global": "global", "per_user": "per_user"},
                             ["userId", "itemId"])
    return split_game_dataset(data, 0.2)[1]


def _as_port(data) -> GameDataset:
    return GameDataset(
        label=data.label, offset=data.offset, weight=data.weight,
        shards={n: SparseShard(s.ids, s.vals, s.dim_) for n, s in data.shards.items()},
        id_columns=dict(data.id_columns))


def test_metrics_match_reference_every_iteration(slice_runs):
    _, _, jax_summary, summary = slice_runs
    jhist = jax_summary["sweep"][0]["history"]
    thist = summary["sweep"][0]["history"]
    assert [h["iteration"] for h in thist] == [h["iteration"] for h in jhist] == [0, 1]
    for jh, th in zip(jhist, thist):
        assert set(th["metrics"]) == set(jh["metrics"]) == {"AUC", "LOGISTIC_LOSS"}
        for name, ref in jh["metrics"].items():
            assert abs(th["metrics"][name] - ref) <= METRIC_TOL, (name, th, jh)
    assert summary["best_configuration"] == jax_summary["best_configuration"]
    for key in ("task", "best_configuration", "best_metrics", "sweep", "phase_times"):
        assert key in summary
    assert summary["backend"] == "cpu"


def test_solver_records_in_summary(slice_runs):
    _, _, _, summary = slice_runs
    for h in summary["sweep"][0]["history"]:
        fixed, per_user = h["solver"]["fixed"], h["solver"]["per_user"]
        assert fixed["evaluations"] >= fixed["iterations"] >= 1
        assert fixed["host_reads"] >= fixed["evaluations"]
        assert per_user["entities"] == sum(b["entities"] for b in per_user["bins"])
        assert per_user["quarantined"] == 0
        assert {b["route"] for b in per_user["bins"]} == {"newton"}
        assert all(b["host_reads"] >= b["loop_iterations"] + 1
                   for b in per_user["bins"])
        assert h["residual_updates"] == 2
        assert h["host_syncs"] == {"stats": 1, "validation": 1}


def test_coefficients_match_reference(slice_runs):
    root, _, _, _ = slice_runs
    jm, _ = jax_load(str(root / "jax" / "best_model"))
    tm, _ = load_game_model(str(root / "torch" / "best_model"), device="cpu")
    np.testing.assert_allclose(
        tm.coordinate("fixed").coefficients.means.numpy(),
        np.asarray(jm.coordinate("fixed").coefficients.means), rtol=COEF_TOL, atol=COEF_TOL)
    np.testing.assert_array_equal(tm.coordinate("per_user").keys,
                                  jm.coordinate("per_user").keys)
    np.testing.assert_allclose(
        tm.coordinate("per_user").table.numpy(),
        np.asarray(jm.coordinate("per_user").table), rtol=COEF_TOL, atol=COEF_TOL)


@pytest.mark.parametrize("fmt", ["avro", "json"])
def test_models_read_across_packages(slice_runs, tmp_path, fmt):
    root, avro, _, _ = slice_runs
    val = _val_dataset(avro)
    jm, jmaps = jax_load(str(root / "jax" / "best_model"))
    tm, tmaps = load_game_model(str(root / "torch" / "best_model"), device="cpu")
    # Each package writes; the other reads and scores like the writer.
    jax_save(str(tmp_path / "from_jax"), jm, jmaps, fmt=fmt)
    save_game_model(str(tmp_path / "from_torch"), tm, tmaps, fmt=fmt)
    t_of_j, _ = load_game_model(str(tmp_path / "from_jax"), device="cpu")
    j_of_t, _ = jax_load(str(tmp_path / "from_torch"))
    np.testing.assert_allclose(t_of_j.score(_as_port(val)), jm.score(val),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    np.testing.assert_allclose(j_of_t.score(val), tm.score(_as_port(val)),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    assert list(t_of_j.coordinates) == list(jm.coordinates)
    with open(tmp_path / "from_torch" / "metadata.json") as f:
        with open(tmp_path / "from_jax" / "metadata.json") as g:
            assert json.load(f) == json.load(g)


def test_game_model_from_numpy_scores_like_reference(slice_runs):
    root, avro, _, _ = slice_runs
    val = _val_dataset(avro)
    jm, _ = jax_load(str(root / "jax" / "best_model"))
    fixed, per_user = jm.coordinate("fixed"), jm.coordinate("per_user")
    tm = game_model_from_numpy(jm.task_type, {
        "fixed": {"type": "fixed", "shard_name": fixed.shard_name,
                  "means": np.asarray(fixed.coefficients.means)},
        "per_user": {"type": "random", "shard_name": per_user.shard_name,
                     "entity_column": per_user.entity_column, "keys": per_user.keys,
                     "table": np.asarray(per_user.table)},
    }, device="cpu")
    np.testing.assert_allclose(tm.score(_as_port(val)), jm.score(val),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    np.testing.assert_allclose(tm.predict(_as_port(val)), jm.predict(val),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


def test_host_residuals_and_json_models_through_the_cli(slice_runs, tmp_path):
    root, avro, _, summary = slice_runs
    out = str(tmp_path / "host")
    host = train_game.run(train_game.build_parser().parse_args(_args(
        avro, out, ["--residuals", "host", "--model-format", "json",
                    "--save-all-models"])))
    for name, ref in summary["best_metrics"].items():
        assert abs(host["best_metrics"][name] - ref) <= METRIC_TOL
    assert os.path.exists(os.path.join(out, "best_model", "fixed-effect", "fixed",
                                       "coefficients.json"))
    assert os.path.isdir(os.path.join(out, f"model_{host['best_configuration']}"))
    jm, _ = jax_load(os.path.join(out, "best_model"))
    assert set(jm.coordinates) == {"fixed", "per_user"}


def test_synthetic_input_and_sweep(tmp_path):
    args = ["--input", "synthetic-game:30:6:5:3:1:4",
            "--coordinate", "fixed:type=fixed,shard=global,reg_weights=0.5+5",
            "--coordinate", "re0:type=random,shard=re0,entity=re0,variance=simple",
            "--validation-split", "0.25", "--evaluators", "AUC,LOGISTIC_LOSS",
            "--backend", "cpu"]
    summary = train_game.run(train_game.build_parser().parse_args(
        args + ["--output-dir", str(tmp_path / "t")]))
    ref = jax_train_game.run(jax_train_game.build_parser().parse_args(
        args[:-2] + ["--backend", "cpu", "--no-telemetry",
                     "--output-dir", str(tmp_path / "j")]))
    assert [e["configuration"] for e in summary["sweep"]] == [
        e["configuration"] for e in ref["sweep"]]
    for te, je in zip(summary["sweep"], ref["sweep"]):
        for name, value in je["metrics"].items():
            assert abs(te["metrics"][name] - value) <= METRIC_TOL
    tm, _ = load_game_model(str(tmp_path / "t" / "best_model"), device="cpu")
    assert tm.coordinate("re0").variances is not None


# The GAME fits that run but that the slice test above does not drive: two
# random-effect coordinates (per user and per item, config 5's structure)
# and the Poisson, linear and smoothed-hinge tasks, each through both
# drivers on the same Avro file for two descent iterations.
PER_ITEM = ["--coordinate", "per_item:type=random,shard=per_user,entity=itemId,max_iters=20"]


@pytest.mark.parametrize("task,extra_coords", [
    ("logistic_regression", PER_ITEM),
    ("poisson_regression", []),
    ("linear_regression", []),
    ("smoothed_hinge_loss_linear_svm", []),
])
def test_game_fits_match_reference(slice_runs, tmp_path, task, extra_coords):
    _, avro, _, _ = slice_runs
    extra = [*extra_coords, "--task", task]
    ref = jax_train_game.run(jax_train_game.build_parser().parse_args(
        _args(avro, str(tmp_path / "jax"), [*extra, "--no-telemetry"])))
    got = train_game.run(train_game.build_parser().parse_args(
        _args(avro, str(tmp_path / "torch"), extra)))
    for th, jh in zip(got["sweep"][0]["history"], ref["sweep"][0]["history"]):
        assert set(th["metrics"]) == set(jh["metrics"])
        for name, value in jh["metrics"].items():
            assert abs(th["metrics"][name] - value) <= METRIC_TOL, (name, th, jh)
    jm, _ = jax_load(str(tmp_path / "jax" / "best_model"))
    tm, _ = load_game_model(str(tmp_path / "torch" / "best_model"), device="cpu")
    assert list(tm.coordinates) == list(jm.coordinates)
    np.testing.assert_allclose(
        tm.coordinate("fixed").coefficients.means.numpy(),
        np.asarray(jm.coordinate("fixed").coefficients.means), rtol=COEF_TOL, atol=COEF_TOL)
    for name in list(tm.coordinates)[1:]:
        np.testing.assert_array_equal(tm.coordinate(name).keys, jm.coordinate(name).keys)
        np.testing.assert_allclose(tm.coordinate(name).table.numpy(),
                                   np.asarray(jm.coordinate(name).table),
                                   rtol=COEF_TOL, atol=COEF_TOL)


@pytest.mark.parametrize("extra,match", [
    (["--tuning", "random"], "item 10"),
    (["--coordinator", "localhost:1"], "item 10"),
])
def test_unported_flags_raise(tmp_path, extra, match):
    args = ["--input", "synthetic-game:10:3:4:3", "--coordinate",
            "fixed:type=fixed,shard=global", "--output-dir", str(tmp_path),
            "--backend", "cpu", *extra]
    with pytest.raises(NotImplementedError, match=match):
        train_game.run(train_game.build_parser().parse_args(args))


@pytest.mark.parametrize("extra", [
    ["--checkpoint-dir", "ckpt"],
    ["--checkpoint-dir", "ckpt", "--resume", "auto"],
    ["--faults", "io:read:p=1:times=1", "--checkpoint"],
    ["--dtype", "bfloat16"],
    ["--max-host-mb", "0.0001"],
    ["--stream-chunks", "7", "--spill-dir", "spill"],
    ["--stream-chunks", "7", "--spill-dir", "spill", "--tile-dtype", "bf16"],
])
def test_formerly_unported_flags_run(tmp_path, monkeypatch, extra):
    """The item 6 and item 9 flags, which raised before, now train."""
    monkeypatch.setenv("PHOTON_IO_RETRY_BASE_S", "0")
    monkeypatch.chdir(tmp_path)
    args = ["--input", "synthetic-game:10:3:4:3", "--coordinate",
            "fixed:type=fixed,shard=global", "--output-dir", str(tmp_path / "out"),
            "--backend", "cpu", *extra]
    summary = train_game.run(train_game.build_parser().parse_args(args))
    assert summary["best_configuration"]


@pytest.mark.parametrize("spec,match", [
    ("r:type=random,shard=re0,entity=re0,row_split=true", "item 10"),
])
def test_unported_coordinate_keys_raise(tmp_path, spec, match):
    args = ["--input", "synthetic-game:10:3:4:3", "--coordinate", spec,
            "--output-dir", str(tmp_path), "--backend", "cpu"]
    with pytest.raises(NotImplementedError, match=match):
        train_game.run(train_game.build_parser().parse_args(args))


@pytest.mark.parametrize("spec,route", [
    ("r:type=factored_random,shard=re0,entity=re0", "vmapped"),
    ("r:type=random,shard=re0,entity=re0,projection=random,projected_dim=2", "newton"),
    ("r:type=random,shard=re0,entity=re0,reg_type=l1", "vmapped"),
    ("r:type=random,shard=re0,entity=re0,reg_type=elastic_net", "vmapped"),
    ("r:type=random,shard=re0,entity=re0,optimizer=newton_cg", "newton_cg"),
])
def test_formerly_unported_coordinate_keys_train(tmp_path, spec, route):
    """The coordinate keys that raised before the rest of GAME training was
    ported now train, each bin on the reference's route."""
    args = ["--input", "synthetic-game:10:3:4:3", "--coordinate", spec,
            "--output-dir", str(tmp_path), "--backend", "cpu"]
    summary = train_game.run(train_game.build_parser().parse_args(args))
    bins = summary["sweep"][0]["history"][0]["solver"]["r"]["bins"]
    assert bins and {b["route"] for b in bins} == {route}


def test_gpu_backend_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = ["--input", "synthetic-game:10:3:4:3", "--coordinate",
            "fixed:type=fixed,shard=global", "--output-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="cuda"):
        train_game.run(train_game.build_parser().parse_args(args))


def test_validation_input_index_maps_and_tron_fixed_effect(tmp_path):
    """Separate validation Avro read against index maps from disk, a TRON
    fixed effect and FULL random-effect variances, against the JAX driver
    with the same arguments."""
    from photon_tpu.data.synthetic import make_game_dataset

    train, maps = make_game_dataset(30, 6, 5, 3, seed=6)
    val, _ = make_game_dataset(30, 3, 5, 3, seed=7)
    write_game_avro(str(tmp_path / "train.avro"), train, maps)
    write_game_avro(str(tmp_path / "val.avro"), val, maps)
    (tmp_path / "maps").mkdir()
    for shard, imap in maps.items():
        imap.save(str(tmp_path / "maps" / f"feature_index_{shard}.json"))
    args = ["--input", str(tmp_path / "train.avro"),
            "--validation-input", str(tmp_path / "val.avro"),
            "--feature-bags", "global=global,re0=re0", "--id-columns", "re0",
            "--index-maps", str(tmp_path / "maps"),
            "--coordinate", "fixed:type=fixed,shard=global,optimizer=tron,max_iters=20",
            "--coordinate", "re0:type=random,shard=re0,entity=re0,variance=full",
            "--descent-iterations", "2", "--backend", "cpu"]
    summary = train_game.run(train_game.build_parser().parse_args(
        args + ["--output-dir", str(tmp_path / "t")]))
    ref = jax_train_game.run(jax_train_game.build_parser().parse_args(
        args + ["--no-telemetry", "--output-dir", str(tmp_path / "j")]))
    for name, value in ref["best_metrics"].items():
        assert abs(summary["best_metrics"][name] - value) <= METRIC_TOL
    tm, _ = load_game_model(str(tmp_path / "t" / "best_model"), device="cpu")
    jm, _ = jax_load(str(tmp_path / "j" / "best_model"))
    np.testing.assert_allclose(tm.coordinate("re0").variances.numpy(),
                               np.asarray(jm.coordinate("re0").variances),
                               rtol=COEF_TOL, atol=COEF_TOL)
    np.testing.assert_allclose(tm.coordinate("fixed").coefficients.means.numpy(),
                               np.asarray(jm.coordinate("fixed").coefficients.means),
                               rtol=COEF_TOL, atol=COEF_TOL)
