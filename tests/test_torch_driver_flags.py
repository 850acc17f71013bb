"""``--log-file`` and ``--profile-dir`` on the port's drivers, on the CPU.

Every driver that takes the JAX package's common arguments parses both
flags as the reference's parser does; ``--log-file`` copies the run's
phase lines into the file; ``--profile-dir`` writes a ``torch.profiler``
trace of the train phase of ``train`` and ``train_game``.
"""

import glob
import importlib
import json
import os

import pytest

DRIVERS = {
    "train": ["--input", "x.libsvm"],
    "train_game": ["--input", "x.avro", "--coordinate", "fixed:type=fixed,shard=global"],
    "score": ["--input", "x.libsvm", "--model", "m.avro"],
    "score_game": ["--input", "x.avro", "--model", "m"],
    "serve_game": ["--input", "x.avro", "--model", "m"],
    "online_game": ["--input", "x.avro", "--append-dir", "a",
                    "--coordinate", "fixed:type=fixed,shard=global"],
}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_flags_parse_as_the_reference(driver):
    flags = ["--output-dir", "out", "--log-file", "logs/run.log",
             "--profile-dir", "prof"]
    got = {}
    for package in ("photon_tpu_torch", "photon_tpu"):
        module = importlib.import_module(f"{package}.drivers.{driver}")
        args = module.build_parser().parse_args(DRIVERS[driver] + flags)
        got[package] = (args.log_file, args.profile_dir)
    assert got["photon_tpu_torch"] == got["photon_tpu"] == ("logs/run.log", "prof")
    module = importlib.import_module(f"photon_tpu_torch.drivers.{driver}")
    args = module.build_parser().parse_args(DRIVERS[driver] + ["--output-dir", "out"])
    assert args.log_file is None and args.profile_dir is None


def _trace_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_train_log_file_and_profile_dir(tmp_path):
    from photon_tpu_torch.drivers import score, train

    log, prof = tmp_path / "logs" / "train.log", tmp_path / "prof"
    train.run(train.build_parser().parse_args([
        "--input", "synthetic:logistic_regression:400:16:0:1",
        "--reg-weights", "0.1,1", "--max-iterations", "5",
        "--output-dir", str(tmp_path / "out"), "--backend", "cpu",
        "--log-file", str(log), "--profile-dir", str(prof)]))
    text = log.read_text()
    for phase in ("load-data", "validate-data", "train-lambda-0.1", "train-lambda-1.0"):
        assert f"phase {phase}: start" in text
    traces = sorted(os.path.basename(p) for p in glob.glob(str(prof / "*.json")))
    assert traces == ["train-lambda-0.1.pt.trace.json", "train-lambda-1.pt.trace.json"]
    assert any(n and n.startswith("aten::") for n in _trace_names(prof / traces[0]))
    # A second run logs to its own file only.
    score_log = tmp_path / "score.log"
    score.run(score.build_parser().parse_args([
        "--input", "synthetic:logistic_regression:200:16:1:1",
        "--model", str(tmp_path / "out" / "best_model.avro"),
        "--output-dir", str(tmp_path / "scored"), "--backend", "cpu",
        "--log-file", str(score_log)]))
    assert "phase" in score_log.read_text()
    assert log.read_text() == text


def test_train_game_log_file_and_profile_dir(tmp_path):
    from photon_tpu_torch.drivers import train_game

    log, prof = tmp_path / "tg.log", tmp_path / "prof"
    train_game.run(train_game.build_parser().parse_args([
        "--input", "synthetic-game:30:6:5:3",
        "--coordinate", "fixed:type=fixed,shard=global,max_iters=10",
        "--coordinate", "per_user:type=random,shard=re0,entity=re0,max_iters=5",
        "--descent-iterations", "1", "--output-dir", str(tmp_path / "out"),
        "--backend", "cpu", "--log-file", str(log), "--profile-dir", str(prof)]))
    text = log.read_text()
    assert "phase load-data: start" in text and "phase save-model" in text
    (trace,) = glob.glob(str(prof / "fit-000.pt.trace.json"))
    assert any(n and n.startswith("aten::") for n in _trace_names(trace))
