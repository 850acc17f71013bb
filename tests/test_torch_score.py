"""Port parity for BASELINE.json config 2's path through the CLI (the train
driver with OWL-QN, the elastic net and normalization, then the scoring
driver), its inputs, and the fixed effect's down-samplers.

Held to the reference tests' own bounds: the train driver's sparsification
(``tests/test_driver.py:81``) and the train-then-score round trip (``:62``,
``:113``); final values to rtol 1e-5 and validation metrics to 1e-4 against
the JAX driver on the same files (``tests/test_torch_train.py``); the
samplers' rows and corrected weights bit for bit against the reference's
(``tests/test_sampling_validation.py:21,32,50,128``), and a down-sampled
GAME fixed effect within the GAME drivers' bounds (metrics 1e-4,
coefficients rtol = atol = 1e-3).
"""

import json
import os

import numpy as np
import pytest
import torch

from photon_tpu.data import sampling as jax_sampling
from photon_tpu.data.synthetic import make_glm_data as jax_make_glm_data
from photon_tpu.data.synthetic import write_libsvm as jax_write_libsvm
from photon_tpu.drivers import score as jax_score
from photon_tpu.drivers import train as jax_train
from photon_tpu_torch.data import sampling
from photon_tpu_torch.data.synthetic import make_glm_data, write_libsvm
from photon_tpu_torch.drivers import score, train

METRIC_TOL = 1e-4
COEF_TOL = 1e-3


@pytest.fixture(scope="module")
def config2_files(tmp_path_factory):
    """bench.py's config-2 data at a small size: linear regression, every
    feature dense, a 20% validation split, written by both writers."""
    tmp = tmp_path_factory.mktemp("config2")
    n, d = 250, 24
    batch, _ = make_glm_data(n + n // 5, d, task="linear_regression", seed=0,
                             device="cpu")
    x, y = batch.x.numpy()[:, :-1], batch.label.numpy()
    paths = {}
    for name, rows in (("train", slice(0, n)), ("val", slice(n, None))):
        paths[name] = str(tmp / f"{name}.libsvm")
        write_libsvm(paths[name], x[rows], y[rows])
        jax_write_libsvm(str(tmp / f"{name}.ref.libsvm"), x[rows], y[rows])
        with open(paths[name], "rb") as f, open(tmp / f"{name}.ref.libsvm", "rb") as g:
            assert f.read() == g.read()
    return paths


def _train_args(paths, out, *extra):
    return ["--input", paths["train"], "--validation-input", paths["val"],
            "--task", "linear_regression", "--optimizer", "owlqn",
            "--reg-type", "elastic_net", "--reg-weights", "1.0,10.0",
            "--max-iterations", "100", "--output-dir", out, "--backend", "cpu",
            *extra]


@pytest.mark.parametrize("normalization", ["none", "standardization"])
def test_config2_cli_matches_jax_driver(config2_files, tmp_path, normalization):
    extra = ["--normalization", normalization, "--save-all-models"]
    ref = jax_train.run(jax_train.build_parser().parse_args(
        _train_args(config2_files, str(tmp_path / "jax"), *extra, "--no-telemetry")))
    got = train.run(train.build_parser().parse_args(
        _train_args(config2_files, str(tmp_path / "torch"), *extra)))
    assert got["best_lambda"] == ref["best_lambda"]
    assert got["optimizer"] == "owlqn" and got["normalization"] == normalization
    assert got["input_reader"] == "native"
    for e, r in zip(got["sweep"], ref["sweep"]):
        np.testing.assert_allclose(e["final_value"], r["final_value"], rtol=1e-5)
        for name, value in r["metrics"].items():
            assert abs(e["metrics"][name] - value) <= METRIC_TOL * max(1.0, abs(value))
    for lam in ("1", "10"):
        assert os.path.exists(tmp_path / "torch" / f"model_lambda_{lam}.avro")
    with open(tmp_path / "torch" / "training_summary.json") as f:
        assert json.load(f)["normalization"] == normalization


def test_config2_train_then_score(config2_files, tmp_path):
    """The scoring driver on the validation file: the train summary's RMSE,
    the reference scoring driver's scores."""
    out = str(tmp_path / "model")
    summary = train.run(train.build_parser().parse_args(
        _train_args(config2_files, out, "--normalization", "standardization")))
    best = next(e for e in summary["sweep"] if e["lambda"] == summary["best_lambda"])
    model = os.path.join(out, "best_model.avro")
    got = score.run(score.build_parser().parse_args([
        "--input", config2_files["val"], "--model", model, "--evaluators", "RMSE",
        "--output-dir", str(tmp_path / "scored"), "--backend", "cpu"]))
    ref = jax_score.run(jax_score.build_parser().parse_args([
        "--input", config2_files["val"], "--model", model, "--evaluators", "RMSE",
        "--output-dir", str(tmp_path / "ref_scored"), "--backend", "cpu",
        "--no-telemetry"]))
    assert got["num_scored"] == ref["num_scored"] == 50
    np.testing.assert_allclose(got["metrics"]["RMSE"], best["metrics"]["RMSE"], rtol=1e-6)
    np.testing.assert_allclose(got["metrics"]["RMSE"], ref["metrics"]["RMSE"], rtol=1e-6)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "scored" / "scores.txt"),
                               np.loadtxt(tmp_path / "ref_scored" / "scores.txt"),
                               rtol=1e-5, atol=1e-5)
    # --stream over the one part file: the same scores and metrics.
    streamed = score.run(score.build_parser().parse_args([
        "--input", config2_files["val"], "--model", model, "--stream",
        "--evaluators", "RMSE", "--output-dir", str(tmp_path / "s"),
        "--backend", "cpu"]))
    assert streamed["num_scored"] == 50 and streamed["streamed"]
    assert streamed["metrics"]["RMSE"] == got["metrics"]["RMSE"]
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "s" / "scores.txt"),
                                  np.loadtxt(tmp_path / "scored" / "scores.txt"))


def test_train_driver_owlqn_sparsifies(tmp_path):
    """tests/test_driver.py:81 on the port's synthetic input, against the
    reference driver's model: the same exact zeros."""
    args = ["--input", "synthetic:linear_regression:300:10:3",
            "--task", "linear_regression", "--optimizer", "owlqn",
            "--reg-type", "elastic_net", "--reg-weights", "30.0",
            "--backend", "cpu", "--model-format", "json"]
    got = train.run(train.build_parser().parse_args(
        args + ["--output-dir", str(tmp_path / "torch")]))
    jax_train.run(jax_train.build_parser().parse_args(
        args + ["--output-dir", str(tmp_path / "jax"), "--no-telemetry"]))
    records = []
    for pkg in ("torch", "jax"):
        with open(tmp_path / pkg / "best_model.json") as f:
            records.append(json.load(f))
    # Zeros are dropped on save; dim 10 is 9 features and the intercept.
    kept = [sorted(m["name"] for m in r["means"]) for r in records]
    assert kept[0] == kept[1] and len(kept[0]) < 11
    assert got["sweep"][0]["zero_coefficients"] == 10 - len(kept[0])
    assert got["input_reader"] == "synthetic"


def test_train_score_round_trip_across_inputs(tmp_path):
    """tests/test_driver.py:62 and :113: a logistic model trained on LIBSVM
    scores its validation file, a synthetic draw and an Avro copy of it; a
    --no-intercept model keeps its ids (the index map decides)."""
    from photon_tpu_torch.data.game_io import write_game_avro
    from photon_tpu_torch.data.index_map import IndexMap, feature_key
    from photon_tpu_torch.game.data import DenseShard, GameDataset

    batch, _ = jax_make_glm_data(400, 13, task="logistic_regression", seed=1)
    x, y = np.asarray(batch.x)[:, :-1], np.asarray(batch.label)
    train_p, val_p = str(tmp_path / "train.libsvm"), str(tmp_path / "val.libsvm")
    write_libsvm(train_p, x[:300], y[:300])
    write_libsvm(val_p, x[300:], y[300:])
    out = str(tmp_path / "out")
    train.run(train.build_parser().parse_args([
        "--input", train_p, "--task", "logistic_regression", "--reg-weights", "1.0",
        "--output-dir", out, "--backend", "cpu"]))
    model = os.path.join(out, "best_model.avro")
    avro = str(tmp_path / "val.avro")
    imap = IndexMap.build([feature_key(f"f{i}") for i in range(12)], intercept=True)
    data = GameDataset.create(y[300:], {"global": DenseShard(
        np.concatenate([x[300:], np.ones((100, 1), np.float32)], axis=1))})
    write_game_avro(avro, data, {"global": imap}, feature_bags={"global": "features"})
    scored = {}
    for name, spec in (("libsvm", val_p), ("avro", avro),
                       ("synthetic", "synthetic:logistic_regression:100:13:9")):
        scored[name] = score.run(score.build_parser().parse_args([
            "--input", spec, "--model", model, "--output-dir", str(tmp_path / name),
            "--backend", "cpu", "--evaluators", "AUC,LOGISTIC_LOSS"]))
        assert scored[name]["num_scored"] == 100
    # The synthetic draw has its own true weights; the files share the model's.
    assert min(scored["libsvm"]["metrics"]["AUC"], scored["avro"]["metrics"]["AUC"]) > 0.7
    assert scored["avro"]["input_reader"] == "native"
    np.testing.assert_allclose(np.loadtxt(tmp_path / "avro" / "scores.txt"),
                               np.loadtxt(tmp_path / "libsvm" / "scores.txt"),
                               rtol=1e-5, atol=1e-5)
    # An Avro training input gives the same fit as the LIBSVM one.
    avro_train = str(tmp_path / "train.avro")
    write_game_avro(avro_train, GameDataset.create(y[:300], {"global": DenseShard(
        np.concatenate([x[:300], np.ones((300, 1), np.float32)], axis=1))}),
        {"global": imap}, feature_bags={"global": "features"})
    s_lib = train.run(train.build_parser().parse_args([
        "--input", train_p, "--task", "logistic_regression", "--reg-weights", "1.0",
        "--output-dir", str(tmp_path / "lib"), "--backend", "cpu"]))
    s_avro = train.run(train.build_parser().parse_args([
        "--input", avro_train, "--task", "logistic_regression", "--reg-weights", "1.0",
        "--output-dir", str(tmp_path / "av"), "--backend", "cpu"]))
    np.testing.assert_allclose(s_avro["sweep"][0]["final_value"],
                               s_lib["sweep"][0]["final_value"], rtol=1e-5)
    # A --no-intercept model scored with the default flags.
    nb, _ = jax_make_glm_data(300, 12, task="logistic_regression", seed=3,
                              intercept=False)
    plain_p = str(tmp_path / "plain.libsvm")
    write_libsvm(plain_p, np.asarray(nb.x), np.asarray(nb.label))
    train.run(train.build_parser().parse_args([
        "--input", plain_p, "--task", "logistic_regression", "--reg-weights", "1.0",
        "--output-dir", str(tmp_path / "ni"), "--backend", "cpu", "--no-intercept"]))
    res = score.run(score.build_parser().parse_args([
        "--input", plain_p, "--model", str(tmp_path / "ni" / "best_model.avro"),
        "--output-dir", str(tmp_path / "ni_s"), "--backend", "cpu", "--evaluators", "AUC"]))
    assert res["metrics"]["AUC"] > 0.7


@pytest.mark.parametrize("kind,rate,positives", [
    ("default", 0.2, 0.5), ("binary", 0.1, 0.05), ("default", 1.0, 0.5),
])
def test_samplers_match_reference(kind, rate, positives):
    rng = np.random.default_rng(2)
    n = 20000
    label = (rng.random(n) < positives).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32)
    rows, corrected = sampling.get_down_sampler(kind, rate).down_sample(label, weight, seed=3)
    ref_rows, ref_corrected = jax_sampling.get_down_sampler(kind, rate).down_sample(
        label, weight, seed=3)
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_array_equal(corrected, ref_corrected)
    if kind == "binary":
        assert label[rows].sum() == label.sum()


def test_sampler_registry_and_task_default():
    assert isinstance(sampling.get_down_sampler("binary", 0.5),
                      sampling.BinaryClassificationDownSampler)
    assert isinstance(sampling.down_sampler_for_task("logistic_regression", 0.5),
                      sampling.BinaryClassificationDownSampler)
    assert isinstance(sampling.down_sampler_for_task("poisson_regression", 0.5),
                      sampling.DefaultDownSampler)
    with pytest.raises(KeyError):
        sampling.get_down_sampler("nope", 0.5)
    with pytest.raises(ValueError):
        sampling.DefaultDownSampler(0.0)


@pytest.mark.parametrize("downsampler", ["binary", "default"])
def test_downsampled_fixed_effect_matches_reference(downsampler):
    """tests/test_sampling_validation.py:128 against the reference: a
    down-sampled fixed effect fits the same rows to the same model."""
    from photon_tpu.core.optimizers import OptimizerConfig as JaxConfig
    from photon_tpu.core.problem import ProblemConfig as JaxProblemConfig
    from photon_tpu.data.synthetic import make_game_dataset as jax_make
    from photon_tpu.game.coordinate import FixedEffectCoordinateConfig as JaxFixed
    from photon_tpu.game.estimator import GameEstimator as JaxEstimator
    from photon_tpu.game.estimator import GameOptimizationConfiguration as JaxConf
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import ProblemConfig
    from photon_tpu_torch.data.synthetic import make_game_dataset
    from photon_tpu_torch.game.coordinate import FixedEffectCoordinateConfig
    from photon_tpu_torch.game.estimator import (
        GameEstimator,
        GameOptimizationConfiguration,
    )

    jdata, _ = jax_make(40, 6, 6, 3, seed=1)
    ref = JaxEstimator("logistic_regression", jdata).fit([JaxConf(coordinates={
        "fixed": JaxFixed("global", JaxProblemConfig(
            optimizer_config=JaxConfig(max_iterations=30)),
            downsampling_rate=0.5, downsampler=downsampler, seed=4)})])[0]
    data, _ = make_game_dataset(40, 6, 6, 3, seed=1)
    est = GameEstimator("logistic_regression", data, device="cpu")
    config = FixedEffectCoordinateConfig(
        "global", ProblemConfig(optimizer_config=OptimizerConfig(max_iterations=30)),
        downsampling_rate=0.5, downsampler=downsampler, seed=4)
    got = est.fit([GameOptimizationConfiguration(coordinates={"fixed": config})])[0]
    kept = est.device_layout(config).train_rows
    np.testing.assert_array_equal(kept, jax_sampling.get_down_sampler(
        downsampler, 0.5).down_sample(np.asarray(jdata.label), np.asarray(jdata.weight),
                                      seed=4)[0])
    assert 0 < len(kept) < data.num_examples
    np.testing.assert_allclose(
        got.model.coordinates["fixed"].coefficients.means.numpy(),
        np.asarray(ref.model.coordinates["fixed"].coefficients.means),
        rtol=COEF_TOL, atol=COEF_TOL)
    assert torch.isfinite(got.model.coordinates["fixed"].coefficients.means).all()
