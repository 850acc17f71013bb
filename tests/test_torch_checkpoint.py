"""Training fault tolerance in the port: descent and sweep checkpoints,
resume, preemption, the fault flags and the host-sync guard.

The contracts of the reference's ``test_fault_injection.py``,
``test_async_checkpoint.py``, ``test_elastic.py`` (its single-device
cases), ``test_fault_sites.py`` and ``test_host_sync_guard.py``, held by
the port on the CPU, at the reference's small GAME fixture
(``make_game_dataset(40, 5, 6, 3)``, a 0.25 split, three descent
iterations): a killed and resumed fit matches the uninterrupted one within
atol 1e-6 (``test_fault_injection.py:242``), a preempted and resumed one
exactly (``test_elastic.py:347``).  Checkpoints are one format: one the JAX
package publishes resumes in the port and one the port publishes resumes
in the JAX package, each result held to the other package's resume under
the GAME tolerances of ``test_torch_game_drivers.py`` (metrics 1e-4,
coefficients rtol = atol = 1e-3).
"""

import inspect
import json
import os
import re
import shutil
import signal
import threading
import time

import numpy as np
import pytest

from photon_tpu.data.synthetic import make_game_dataset as jax_make_game_dataset
from photon_tpu.fault.checkpoint import DescentCheckpointer as JaxCheckpointer
from photon_tpu.fault.injection import FaultPlan as JaxFaultPlan
from photon_tpu.fault.injection import InjectedKillError as JaxKillError
from photon_tpu.fault.injection import set_plan as jax_set_plan
from photon_tpu.fault.preemption import clear_preemption as jax_clear_preemption
from photon_tpu.game import coordinate as jcoord
from photon_tpu.game.data import split_game_dataset as jax_split
from photon_tpu.game.estimator import GameEstimator as JaxEstimator
from photon_tpu.game.estimator import GameOptimizationConfiguration as JaxConfig
from photon_tpu_torch.core.objective import RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.data.synthetic import make_game_dataset
from photon_tpu_torch.drivers import common
from photon_tpu_torch.drivers import train as train_driver
from photon_tpu_torch.drivers import train_game
from photon_tpu_torch.fault import atomic
from photon_tpu_torch.fault.checkpoint import (
    AsyncPublisher,
    CheckpointError,
    DescentCheckpointer,
    resolve_checkpoint_async,
    stage_to_host,
)
from photon_tpu_torch.fault.injection import (
    KNOWN_FAULT_SITES,
    FaultPlan,
    InjectedKillError,
    set_plan,
)
from photon_tpu_torch.fault.preemption import (
    PREEMPTED_EXIT_CODE,
    PreemptedError,
    PreemptionHandler,
    clear_preemption,
    preemption_requested,
)
from photon_tpu_torch.game.coordinate import (
    FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.data import DenseShard, GameDataset, SparseShard
from photon_tpu_torch.game.data import split_game_dataset
from photon_tpu_torch.game.estimator import (
    GameEstimator,
    GameOptimizationConfiguration,
)
from photon_tpu_torch.telemetry import TelemetrySession
from photon_tpu_torch.tools import check_host_sync

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_TOL = 1e-4  # tests/test_torch_game_drivers.py
COEF_TOL = 1e-3
RESUME_ATOL = 1e-6  # tests/test_fault_injection.py:242


@pytest.fixture(autouse=True)
def _fault_hygiene(monkeypatch):
    monkeypatch.setenv("PHOTON_IO_RETRY_BASE_S", "0")
    for reset in (set_plan, jax_set_plan):
        reset(None)
    clear_preemption()
    jax_clear_preemption()
    yield
    for reset in (set_plan, jax_set_plan):
        reset(None)
    clear_preemption()
    jax_clear_preemption()


def _problem(lam: float, iters: int) -> ProblemConfig:
    return ProblemConfig(regularization=RegularizationContext("l2", lam),
                         optimizer_config=OptimizerConfig(max_iterations=iters))


def _config(re_lam: float = 1.0, iterations: int = 3, fixed_only: bool = False):
    coords = {"fixed": FixedEffectCoordinateConfig("global", _problem(0.01, 8))}
    if not fixed_only:
        coords["re0"] = RandomEffectCoordinateConfig("re0", "re0", _problem(re_lam, 6))
    return GameOptimizationConfiguration(coordinates=coords,
                                         descent_iterations=iterations, name="ckpt")


def _fixture():
    data, _ = make_game_dataset(40, 5, 6, 3, seed=7)
    train, val = split_game_dataset(data, 0.25)
    return train, val


def _fit(train, val, mode="device", telemetry=None, config=None, **kw):
    return GameEstimator("logistic_regression", train, val, device="cpu",
                         residual_mode=mode, telemetry=telemetry).fit(
        [config or _config()], **kw)[0]


def _arrays(model) -> dict:
    return {name: np.asarray(c.table if hasattr(c, "table") else c.coefficients.means)
            for name, c in model.coordinates.items()}


def _assert_models(a, b, atol=0.0, rtol=0.0):
    a, b = _arrays(a), _arrays(b)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_allclose(a[name], b[name], atol=atol, rtol=rtol, err_msg=name)


def _counter(session, name, **labels) -> float:
    return sum(c["value"] for c in session.registry.snapshot()["counters"]
               if c["name"] == name and all(c["labels"].get(k) == v
                                            for k, v in labels.items()))


# -- atomic publication and the publisher ------------------------------------


def test_atomic_dir_and_manifest_refuse_torn_and_corrupt_artifacts(tmp_path):
    final = str(tmp_path / "artifact")
    with atomic.atomic_dir(final) as tmp:
        open(os.path.join(tmp, "a.bin"), "wb").write(b"one")
        atomic.write_manifest(tmp)
    atomic.verify_manifest(final)
    # A failure inside the body leaves the previous artifact untouched.
    with pytest.raises(RuntimeError):
        with atomic.atomic_dir(final) as tmp:
            open(os.path.join(tmp, "a.bin"), "wb").write(b"torn")
            raise RuntimeError("killed mid-write")
    assert open(os.path.join(final, "a.bin"), "rb").read() == b"one"
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]
    open(os.path.join(final, "a.bin"), "wb").write(b"rot")
    with pytest.raises(atomic.CorruptArtifactError):
        atomic.verify_manifest(final)
    os.remove(os.path.join(final, "manifest.json"))
    with pytest.raises(atomic.CorruptArtifactError):
        atomic.verify_manifest(final)


def test_resolve_checkpoint_async(monkeypatch):
    monkeypatch.delenv("PHOTON_CHECKPOINT_ASYNC", raising=False)
    assert resolve_checkpoint_async() is True
    monkeypatch.setenv("PHOTON_CHECKPOINT_ASYNC", "off")
    assert resolve_checkpoint_async() is False
    assert resolve_checkpoint_async("on") is True
    assert resolve_checkpoint_async(False) is False
    with pytest.raises(ValueError):
        resolve_checkpoint_async("sometimes")


def test_publisher_surfaces_failures_and_bounds_depth():
    pub = AsyncPublisher()

    def boom():
        raise OSError("disk full")

    pub.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        pub.submit(lambda: None)  # the previous failure surfaces here
    pub.submit(boom)
    with pytest.raises(OSError):
        pub.drain()
    # Depth 1: a second submit waits for the first publish to land.
    gate, order = threading.Event(), []
    pub.submit(lambda: (gate.wait(5), order.append("first")))
    t = threading.Thread(target=lambda: pub.submit(lambda: order.append("second")))
    t.start()
    time.sleep(0.05)
    assert order == []
    gate.set()
    t.join(5)
    pub.drain()
    assert order == ["first", "second"]


def test_stage_to_host_copies_before_in_place_writes():
    """The loop overwrites the score table in place once ``save`` returns:
    the staged rows must be copies, not views."""
    import torch

    table = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    staged = stage_to_host({"row": table[1], "keys": np.array(["a", "b"])})
    table[1] = -1.0
    np.testing.assert_array_equal(staged["row"], [3.0, 4.0, 5.0])
    assert staged["keys"].tolist() == ["a", "b"]


# -- kill, preempt and resume ------------------------------------------------


@pytest.mark.parametrize("mode", ["device", "host"])
def test_kill_and_resume_matches_uninterrupted(tmp_path, mode):
    train, val = _fixture()
    baseline = _fit(train, val, mode)
    ckpt = str(tmp_path / "ckpt")
    set_plan(FaultPlan.parse("descent:kill:iter=2"))
    with pytest.raises(InjectedKillError):
        _fit(train, val, mode, checkpoint_dir=ckpt)
    set_plan(None)
    resumed = _fit(train, val, mode, checkpoint_dir=ckpt, resume="auto")
    for k, v in baseline.metrics.items():
        assert abs(v - resumed.metrics[k]) <= RESUME_ATOL
    _assert_models(baseline.model, resumed.model, atol=RESUME_ATOL)
    assert [h["iteration"] for h in resumed.descent.history] == [0, 1, 2]


@pytest.mark.parametrize("mode", ["device", "host"])
def test_preempt_checkpoints_and_resume_matches_exactly(tmp_path, mode):
    train, val = _fixture()
    baseline = _fit(train, val, mode)
    ckpt = str(tmp_path / "ckpt")
    session = TelemetrySession("t")
    set_plan(FaultPlan.parse("preempt:iter=2"))
    with pytest.raises(PreemptedError):
        _fit(train, val, mode, telemetry=session, checkpoint_dir=ckpt)
    set_plan(None)
    clear_preemption()
    assert _counter(session, "descent.preempted") == 1
    latest = DescentCheckpointer(os.path.join(ckpt, "cfg-000")).latest_path()
    assert latest is not None and latest.endswith("ckpt-000001")
    resumed = _fit(train, val, mode, checkpoint_dir=ckpt, resume="latest")
    _assert_models(baseline.model, resumed.model)
    assert baseline.metrics == resumed.metrics
    # Without a checkpointer a preemption still stops the descent.
    set_plan(FaultPlan.parse("preempt:iter=1"))
    with pytest.raises(PreemptedError, match="no checkpointer"):
        _fit(train, val, mode)


@pytest.mark.parametrize("change", ["coordinates", "regularization", "rows"])
def test_resume_refuses_a_mismatched_checkpoint(tmp_path, change):
    train, val = _fixture()
    ckpt = str(tmp_path / "ckpt")
    _fit(train, val, checkpoint_dir=ckpt)
    config = _config()
    if change == "coordinates":
        config = _config(fixed_only=True)
    elif change == "regularization":
        config = _config(re_lam=100.0)
    else:  # another logical layout: fewer training rows
        keep = np.arange(train.num_examples - 3)
        train = GameDataset(train.label[keep], train.offset[keep], train.weight[keep],
                            {n: DenseShard(s.x[keep]) for n, s in train.shards.items()},
                            {n: c[keep] for n, c in train.id_columns.items()})
    # Refused even though the checkpoint is complete.
    with pytest.raises(CheckpointError):
        _fit(train, val, config=config, checkpoint_dir=ckpt, resume="auto")


def test_resume_paths_and_completed_restore(tmp_path):
    train, val = _fixture()
    with pytest.raises(CheckpointError):
        _fit(train, val, checkpoint_dir=str(tmp_path / "none"), resume="latest")
    with pytest.raises(ValueError):
        _fit(train, val, resume="auto")
    ckpt = str(tmp_path / "ckpt")
    session = TelemetrySession("t")
    first = _fit(train, val, telemetry=session, checkpoint_dir=ckpt)
    assert _counter(session, "checkpoint.saves") == 3
    chain = DescentCheckpointer(os.path.join(ckpt, "cfg-000"))
    assert sorted(n for n in os.listdir(chain.directory) if n.startswith("ckpt-")) == [
        "ckpt-000001", "ckpt-000002"]  # keep 2
    # A completed checkpoint restores without a fit; an explicit version
    # path resumes too.
    again = TelemetrySession("t")
    restored = _fit(train, val, telemetry=again, checkpoint_dir=ckpt, resume="auto")
    assert _counter(again, "estimator.configurations_resumed") == 1
    _assert_models(first.model, restored.model)
    explicit = _fit(train, val, resume=chain.latest_path())
    _assert_models(first.model, explicit.model)
    # A raised iteration count resumes and runs the extra pass.
    more = _fit(train, val, config=_config(iterations=4), checkpoint_dir=ckpt,
                resume="auto")
    assert [h["iteration"] for h in more.descent.history] == [0, 1, 2, 3]


@pytest.mark.parametrize("site", ["checkpoint:write", "checkpoint:stage"])
def test_kill_windows_keep_the_previous_checkpoint(tmp_path, site):
    train, val = _fixture()
    baseline = _fit(train, val)
    ckpt = str(tmp_path / "ckpt")
    set_plan(FaultPlan.parse(f"{site}:iter=1"))
    with pytest.raises(InjectedKillError):
        _fit(train, val, checkpoint_dir=ckpt, checkpoint_async="on")
    set_plan(None)
    latest = DescentCheckpointer(os.path.join(ckpt, "cfg-000")).latest_path()
    assert latest.endswith("ckpt-000000")
    DescentCheckpointer.load_path(latest, device="cpu")
    resumed = _fit(train, val, checkpoint_dir=ckpt, resume="latest")
    _assert_models(baseline.model, resumed.model)


def test_corrupt_and_inconsistent_checkpoints_are_refused(tmp_path):
    train, val = _fixture()
    ckpt = str(tmp_path / "ckpt")
    _fit(train, val, checkpoint_dir=ckpt)
    latest = DescentCheckpointer(os.path.join(ckpt, "cfg-000")).latest_path()
    manifest_path = os.path.join(latest, "manifest.json")
    manifest = json.load(open(manifest_path))
    manifest["extra"]["layout_digest"] = "0" * 16
    json.dump(manifest, open(manifest_path, "w"))
    with pytest.raises(CheckpointError, match="layout digest"):
        DescentCheckpointer.load_path(latest, device="cpu")
    with open(os.path.join(latest, "arrays.npz"), "ab") as f:
        f.write(b"bit rot")
    with pytest.raises(atomic.CorruptArtifactError):
        DescentCheckpointer.load_path(latest, device="cpu")


def test_checkpointing_adds_no_descent_sync_and_counts_staging(tmp_path):
    train, val = _fixture()
    plain, ckpt = TelemetrySession("t"), TelemetrySession("t")
    _fit(train, val, telemetry=plain)
    _fit(train, val, telemetry=ckpt, checkpoint_dir=str(tmp_path / "c"))
    inline = TelemetrySession("t")
    _fit(train, val, telemetry=inline, checkpoint_dir=str(tmp_path / "i"),
         checkpoint_async="off")
    for session in (ckpt, inline):
        assert (_counter(plain, "descent.host_syncs", kind="stats")
                == _counter(session, "descent.host_syncs", kind="stats") == 3)
        # Checkpointing's one staging read a save, counted on its own.
        assert _counter(session, "descent.host_syncs", kind="checkpoint") == 3
        assert _counter(session, "checkpoint.saves") == 3
        assert session.gauge("checkpoint.staged_bytes").value > 0
    assert _counter(plain, "descent.host_syncs", kind="checkpoint") == 0
    # The default thread observes each publish's lag; inline has none.
    assert ckpt.histogram("checkpoint.publish_lag_s").count == 3
    assert inline.histogram("checkpoint.publish_seconds").count == 3
    assert inline.histogram("checkpoint.publish_lag_s").count == 0
    # Over the staged-bytes cap a snapshot publishes blocking.
    capped = TelemetrySession("t")
    _fit(train, val, telemetry=capped, checkpoint_dir=str(tmp_path / "d"),
         checkpoint_max_staged_mb=0.0)
    assert _counter(capped, "checkpoint.staged_fallback_sync") == 3


# -- one format: checkpoints cross between the packages ----------------------


def _jax_fixture():
    data, _ = jax_make_game_dataset(40, 5, 6, 3, seed=7)
    return jax_split(data, 0.25)


def _jax_config():
    from photon_tpu.core.objective import RegularizationContext as JR
    from photon_tpu.core.optimizers import OptimizerConfig as JO
    from photon_tpu.core.problem import ProblemConfig as JP

    def problem(lam, iters):
        return JP(regularization=JR("l2", lam), optimizer_config=JO(max_iterations=iters))

    return JaxConfig(coordinates={
        "fixed": jcoord.FixedEffectCoordinateConfig("global", problem(0.01, 8)),
        "re0": jcoord.RandomEffectCoordinateConfig("re0", "re0", problem(1.0, 6)),
    }, descent_iterations=3, name="ckpt")


def _to_port(data) -> GameDataset:
    def shard(s):
        if hasattr(s, "x"):
            return DenseShard(np.asarray(s.x))
        return SparseShard(np.asarray(s.ids), np.asarray(s.vals), s.dim_)

    return GameDataset(np.asarray(data.label), np.asarray(data.offset),
                       np.asarray(data.weight),
                       {n: shard(s) for n, s in data.shards.items()},
                       {n: np.asarray(c) for n, c in data.id_columns.items()})


def _jax_fit(train, val, **kw):
    return JaxEstimator("logistic_regression", train, val).fit([_jax_config()], **kw)[0]


def _assert_cross(port_result, jax_result):
    for k, v in jax_result.metrics.items():
        assert abs(port_result.metrics[k] - v) <= METRIC_TOL, k
    _assert_models(port_result.model, jax_result.model, atol=COEF_TOL, rtol=COEF_TOL)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    jtrain, jval = _jax_fixture()
    train, val = _to_port(jtrain), _to_port(jval)
    ckpt = str(tmp_path / "written")
    if writer == "jax":
        jax_set_plan(JaxFaultPlan.parse("descent:kill:iter=2"))
        with pytest.raises(JaxKillError):
            _jax_fit(jtrain, jval, checkpoint_dir=ckpt)
        jax_set_plan(None)
    else:
        set_plan(FaultPlan.parse("descent:kill:iter=2"))
        with pytest.raises(InjectedKillError):
            _fit(train, val, checkpoint_dir=ckpt)
        set_plan(None)
    assert JaxCheckpointer(os.path.join(ckpt, "cfg-000")).latest_path().endswith(
        "ckpt-000001")
    for name in ("jax", "torch"):
        shutil.copytree(ckpt, str(tmp_path / name))
    by_port = _fit(train, val, checkpoint_dir=str(tmp_path / "torch"), resume="latest")
    by_jax = _jax_fit(jtrain, jval, checkpoint_dir=str(tmp_path / "jax"), resume="latest")
    assert [h["iteration"] for h in by_port.descent.history] == [0, 1, 2]
    _assert_cross(by_port, by_jax)


# -- the drivers: train_game and the resident train sweep --------------------


GAME_ARGS = ["--input", "synthetic-game:30:4:6:3", "--task", "logistic_regression",
             "--coordinate", "fixed:type=fixed,shard=global,max_iters=6",
             "--coordinate", "re0:type=random,shard=re0,entity=re0,max_iters=5",
             "--descent-iterations", "3", "--validation-split", "0.25",
             "--backend", "cpu"]


def test_train_game_preempt_exit_75_and_resume(tmp_path):
    def main(out, *extra):
        return train_game.main([*GAME_ARGS, "--output-dir", str(tmp_path / out), *extra])

    main("base", "--checkpoint")
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SystemExit) as exc:
        main("stopped", "--checkpoint-dir", ckpt, "--faults", "preempt:iter=1")
    assert exc.value.code == PREEMPTED_EXIT_CODE
    report = json.load(open(tmp_path / "stopped" / "telemetry" / "run_report.json"))
    assert report["status"] == "preempted"
    main("resumed", "--checkpoint-dir", ckpt, "--resume", "latest")
    base = json.load(open(tmp_path / "base" / "training_summary.json"))
    resumed = json.load(open(tmp_path / "resumed" / "training_summary.json"))
    assert base["best_metrics"] == resumed["best_metrics"]
    assert os.path.islink(tmp_path / "base" / "checkpoint" / "latest")
    for bad, match in ((["--resume", "auto"], "needs --checkpoint-dir"),
                       (["--checkpoint-dir", str(tmp_path / "empty"), "--resume",
                         "latest"], "no published checkpoint")):
        with pytest.raises(ValueError, match=match):
            main("bad", *bad)


SWEEP_ARGS = ["--backend", "cpu", "--input", "synthetic:logistic_regression:120:10:3:5",
              "--task", "logistic_regression", "--reg-weights", "0.5,2.0",
              "--max-iterations", "15"]


def test_resident_train_sweep_resumes_without_refits(tmp_path):
    def run(out, *extra):
        return train_driver.run(train_driver.build_parser().parse_args(
            [*SWEEP_ARGS, "--output-dir", str(tmp_path / out), *extra]))

    baseline = run("base")
    ckpt = str(tmp_path / "ckpt")
    checkpointed = run("ckpt-run", "--checkpoint-dir", ckpt)
    for a, b in zip(baseline["sweep"], checkpointed["sweep"]):
        assert a["final_value"] == b["final_value"]
    shutil.rmtree(os.path.join(ckpt, "lam-001"))
    resumed = run("resumed", "--checkpoint-dir", ckpt, "--resume", "auto")
    for a, b in zip(baseline["sweep"], resumed["sweep"]):
        assert (a["final_value"], a["iterations"], a["convergence_reason"]) == (
            b["final_value"], b["iterations"], b["convergence_reason"])
    assert resumed["sweep"][0]["wall_time_s"] == 0.0
    report = json.load(open(tmp_path / "resumed" / "telemetry" / "run_report.json"))
    assert [c["value"] for c in report["metrics"]["counters"]
            if c["name"] == "train.lambdas_resumed"] == [1]
    with pytest.raises(CheckpointError):
        run("more", "--checkpoint-dir", ckpt, "--resume", "auto",
            "--max-iterations", "30")
    # The preemption boundary between weights: exit 75 with weight 0
    # published, then a resume that refits only weight 1.
    stop_ckpt = str(tmp_path / "stop")
    with pytest.raises(SystemExit) as exc:
        train_driver.main([*SWEEP_ARGS, "--output-dir", str(tmp_path / "p"),
                           "--checkpoint-dir", stop_ckpt, "--faults", "preempt:iter=1"])
    assert exc.value.code == PREEMPTED_EXIT_CODE
    after = run("after-stop", "--checkpoint-dir", stop_ckpt, "--resume", "latest")
    assert [e["final_value"] for e in after["sweep"]] == [
        e["final_value"] for e in baseline["sweep"]]
    assert after["sweep"][0]["wall_time_s"] == 0.0
    # --checkpoint-every paces the streamed loop's mid-fit snapshots; the
    # resident sweep snapshots finished weights and ignores it.
    paced = run("paced", "--checkpoint-dir", str(tmp_path / "paced-ck"),
                "--checkpoint-every", "2", "--checkpoint-async", "off")
    assert [e["final_value"] for e in paced["sweep"]] == [
        e["final_value"] for e in baseline["sweep"]]


def test_run_cli_and_signal_handling(tmp_path):
    import argparse

    def preempted(args):
        raise PreemptedError("boundary stop")

    with pytest.raises(SystemExit) as exc:
        common.run_cli(preempted, None)
    assert exc.value.code == PREEMPTED_EXIT_CODE

    def crashed(args):
        raise RuntimeError("real crash")

    with pytest.raises(RuntimeError, match="real crash"):
        common.run_cli(crashed, None)
    previous = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler("checkpoint"):
        signal.raise_signal(signal.SIGTERM)
        assert preemption_requested()
    assert signal.getsignal(signal.SIGTERM) is previous
    assert not preemption_requested()
    with PreemptionHandler("checkpoint"):
        signal.raise_signal(signal.SIGINT)
        assert preemption_requested()  # the first signal sets the flag only
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGINT)  # the second: stock behavior
    clear_preemption()
    with pytest.raises(ValueError):
        PreemptionHandler("sometimes")
    # Only the training drivers (their loops poll the flag) take SIGINT.
    args = argparse.Namespace(output_dir=str(tmp_path), telemetry=False, faults=None,
                              on_preempt="checkpoint", stall_timeout=None)
    logger = common.RunLogger("t")
    previous = signal.getsignal(signal.SIGINT)
    with common.telemetry_run(args, "score", logger):
        assert signal.getsignal(signal.SIGINT) is previous
    with common.telemetry_run(args, "train", logger, preemptible=True):
        assert signal.getsignal(signal.SIGINT) is not previous
    assert signal.getsignal(signal.SIGINT) is previous


# -- the host-sync guard and the fault-site registry -------------------------


def test_host_sync_guard_passes_and_catches(tmp_path):
    assert check_host_sync.main([]) == 0
    guarded = {str(p.relative_to(check_host_sync.PACKAGE))
               for p in check_host_sync.guarded_files()}
    for rel in ("game/descent.py", "game/batched_solve.py", "core/optimizers/lbfgs.py",
                "serving/scorer.py", "serving/batcher.py", "online/service.py",
                "serving/observe.py", "telemetry/live.py"):
        assert rel in guarded
    bad = tmp_path / "bad.py"
    bad.write_text("def hot(x):\n    return x.item()\n")
    assert check_host_sync.check_file(bad) == [(2, "return x.item()")]
    assert check_host_sync.main([str(bad)]) == 1
    ok = tmp_path / "ok.py"
    ok.write_text("def hot(x, e):\n    # host-sync: the one read\n    e.synchronize()\n"
                  "    return x.tolist()\n")
    assert check_host_sync.check_file(ok) == []
    far = tmp_path / "far.py"
    far.write_text("# host-sync: too far above\na = 1\nb = 2\nc = 3\nx = a.cpu()\n")
    assert len(check_host_sync.check_file(far)) == 1


_SITE_CALL = re.compile(r"""(?:fault_point|\.consume)\(\s*["']([^"']+)["']""")
# Sites consumed through the injection module's helpers.
_HELPER_SITES = {"consume_preempt_injection": "preempt",
                 "consume_hang_injection": "replica:hang",
                 "consume_nan_injection": "solve:nan"}


def _port_consumed_sites() -> set:
    consumed = set()
    for root, dirs, files in os.walk(os.path.join(REPO, "photon_tpu_torch")):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]  # builds, caches
        for name in files:
            path = os.path.join(root, name)
            if not name.endswith(".py") or path.endswith(os.path.join("fault", "injection.py")):
                continue
            text = open(path).read()
            consumed |= set(_SITE_CALL.findall(text))
            consumed |= {site for helper, site in _HELPER_SITES.items()
                         if re.search(rf"\b{helper}\(", text)}
    return consumed


def test_every_fault_site_the_port_consumes_is_registered_and_driven():
    consumed = _port_consumed_sites()
    assert {"descent:kill", "preempt", "checkpoint:stage", "checkpoint:write",
            "checkpoint:read", "online:ingest", "online:refresh:kill"} <= consumed
    assert consumed <= set(KNOWN_FAULT_SITES), consumed - set(KNOWN_FAULT_SITES)
    tests = "".join(open(os.path.join(REPO, "tests", n)).read()
                    for n in os.listdir(os.path.join(REPO, "tests"))
                    if n.startswith("test_torch_") and n.endswith(".py"))
    # This scan's own site list is not coverage.
    tests = tests.replace(inspect.getsource(
        test_every_fault_site_the_port_consumes_is_registered_and_driven), "")
    undriven = sorted(s for s in consumed if not re.search(rf"[\"'f]{re.escape(s)}[:\"']",
                                                            tests))
    assert not undriven, undriven


def test_checkpoint_read_faults_retry_on_resume(tmp_path):
    train, val = _fixture()
    ckpt = str(tmp_path / "ckpt")
    first = _fit(train, val, checkpoint_dir=ckpt)
    session = TelemetrySession("t")
    set_plan(FaultPlan.parse("checkpoint:read:times=2"))
    restored = _fit(train, val, telemetry=session, checkpoint_dir=ckpt, resume="latest")
    set_plan(None)
    _assert_models(first.model, restored.model)
    set_plan(FaultPlan.parse("checkpoint:read:p=1"))
    with pytest.raises(OSError):
        _fit(train, val, checkpoint_dir=ckpt, resume="latest")
