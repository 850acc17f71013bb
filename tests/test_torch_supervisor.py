"""The replica supervisor against the JAX package's contracts, on the CPU.

Mirrors ``tests/test_supervisor.py`` (:297-822) on thread replicas, as its
``_fleet`` fixture does: a crash mid-stream reroutes exactly once and the
supervisor resurrects the replica through its canary-gated rejoin; a hang
is declared by the probe deadline like a crash; a flapping replica is
quarantined for good; a replica resurrected across a rollout rejoins on
the new model; a failed spawn backs off and rejoins; a busy replica is not
a hang; the parity gate refuses NaN and misshapen answers; a failed
rollout keeps the model version monotonic; a fleet-wide parity regression
rolls the fleet back instead of quarantining it; the report renders the
supervisor timeline.  Kill and resurrect are held to the port's contract
of no capture after warmup (the reference pins its compile events, a pin
that fails on the reference itself).  The known-answer probe is the JAX
package's request for the same model, bit for bit.
"""

import time
from concurrent.futures import Future

import numpy as np
import pytest

from photon_tpu import serving as ref_serving
from photon_tpu.data.synthetic import make_game_dataset as ref_dataset
from photon_tpu.game import model as ref_model
from photon_tpu.models.glm import Coefficients as RefCoefficients
from photon_tpu.models.glm import model_for_task as ref_model_for_task
from photon_tpu.serving.supervisor import probe_request_for as ref_probe_request_for
from photon_tpu_torch.fault.injection import FaultPlan, set_plan
from photon_tpu_torch.fault.watchdog import heartbeat
from photon_tpu_torch.game.data import DenseShard, GameDataset
from photon_tpu_torch.game.model import game_model_from_numpy
from photon_tpu_torch.serving import (
    ServingFleet,
    SupervisorPolicy,
    build_requests,
    host_score_request,
    probe_request_for,
    request_spec_for_dataset,
)
from photon_tpu_torch.telemetry import TelemetrySession

SCORE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_fault_plan():
    yield
    set_plan(None)


def _arrays(seed, n_entities=40, fixed_dim=6, random_dim=4):
    data, _ = ref_dataset(n_entities, 4, fixed_dim, random_dim, seed=seed)
    rng = np.random.default_rng(seed)
    keys = np.unique(data.id_columns["re0"])
    means = rng.standard_normal(fixed_dim).astype(np.float32)
    table = rng.standard_normal((len(keys), random_dim)).astype(np.float32)
    return (means, keys, table), data


def _port_model(means, keys, table):
    return game_model_from_numpy("logistic_regression", {
        "fixed": {"type": "fixed", "shard_name": "global", "means": means},
        "per_entity": {"type": "random", "shard_name": "re0",
                       "entity_column": "re0", "keys": keys, "table": table},
    }, device="cpu")


def _as_port(data) -> GameDataset:
    return GameDataset(label=data.label, offset=data.offset, weight=data.weight,
                       shards={n: DenseShard(s.x) for n, s in data.shards.items()},
                       id_columns=dict(data.id_columns))


def _fixture(seed):
    arrays, rdata = _arrays(seed)
    return _port_model(*arrays), _as_port(rdata), arrays


def _retrained(arrays, seed):
    means, keys, table = arrays
    rng = np.random.default_rng(seed)
    return _port_model((means + rng.standard_normal(means.shape)).astype(np.float32),
                       keys, rng.standard_normal(table.shape).astype(np.float32))


def _counter_total(session, name, **labels):
    return sum(m["value"] for m in session.registry.snapshot()["counters"]
               if m["name"] == name
               and all(str(m["labels"].get(k)) == str(v) for k, v in labels.items()))


def _fleet(model, data, session, replicas=2, **kwargs):
    return ServingFleet(
        model, replicas=replicas, device="cpu",
        request_spec=request_spec_for_dataset(model, data),
        max_batch=16, max_delay_s=0.001, telemetry=session, **kwargs,
    ).warmup()


def _supervisor(fleet, **overrides):
    defaults = dict(probe_interval_s=0.05, probe_deadline_s=10.0,
                    respawn_base_s=0.0, respawn_jitter=0.0)
    defaults.update(overrides)
    return fleet.supervise(SupervisorPolicy(**defaults), start=False)


def _resurrect(sup, replica, rounds=30, sleep_s=0.05) -> bool:
    for _ in range(rounds):
        sup.check_once()
        if replica.alive:
            return True
        time.sleep(sleep_s)
    return replica.alive


def _timeline(session):
    steps = [(m["value"], m["labels"].get("replica"), m["labels"].get("phase"))
             for m in session.registry.snapshot()["gauges"]
             if m["name"] == "serving.supervisor_step"]
    return [(rid, phase) for _, rid, phase in sorted(steps)]


def _check_rows(results, want, data, rows=4):
    pos = 0
    for got in results:
        idx = np.arange(pos, pos + rows) % data.num_examples
        np.testing.assert_allclose(got, want[idx], rtol=0, atol=SCORE_TOL)
        pos = (pos + rows) % data.num_examples


# -- the known-answer probe ---------------------------------------------------

def test_known_answer_probe_is_the_references():
    """The supervisor's probe request (the fleet's one ``probe_request_for``)
    is the JAX package's for the same model, spec and seed."""
    arrays, rdata = _arrays(3)
    model = _port_model(*arrays)
    means, keys, table = arrays
    task = "logistic_regression"
    rmodel = ref_model.GameModel(coordinates={
        "fixed": ref_model.FixedEffectModel(
            ref_model_for_task(task, RefCoefficients(means)), "global"),
        "per_entity": ref_model.RandomEffectModel(
            table=table, keys=keys, entity_column="re0", shard_name="re0",
            task_type=task)}, task_type=task)
    spec = request_spec_for_dataset(model, _as_port(rdata))
    rspec = ref_serving.request_spec_for_dataset(rmodel, rdata)
    for rows, seed in ((2, 0), (5, 3)):
        ours = probe_request_for(model, spec, rows=rows, seed=seed)
        theirs = ref_probe_request_for(rmodel, rspec, rows=rows, seed=seed)
        np.testing.assert_array_equal(ours.features["global"], theirs.features["global"])
        np.testing.assert_array_equal(ours.features["re0"], theirs.features["re0"])
        np.testing.assert_array_equal(ours.entity_ids["re0"], theirs.entity_ids["re0"])
        np.testing.assert_allclose(host_score_request(model, ours),
                                   ref_serving.host_score_request(rmodel, theirs),
                                   rtol=0, atol=SCORE_TOL)


# -- crash: exactly-once reroute + resurrection --------------------------------

def test_crash_mid_stream_reroutes_exactly_once_then_resurrects():
    model, data, _ = _fixture(13)
    session = TelemetrySession("crash-resurrect")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet)
        requests = build_requests(data, model, [4] * 30)
        set_plan(FaultPlan.parse("replica:crash:replica=r0:times=1"))
        results = [f.result(timeout=60) for f in [fleet.submit(r) for r in requests]]
        set_plan(None)
        _check_rows(results, model.score(data), data)
        r0 = fleet.replicas[0]
        assert not r0.alive and r0.death_cause == "crash"
        assert _resurrect(sup, r0)
        assert r0.generation == 1 and not r0.rejoining
        np.testing.assert_allclose(r0.submit(requests[0]).result(timeout=30),
                                   model.score(data)[:4], rtol=0, atol=SCORE_TOL)
    assert _counter_total(session, "serving.replica_deaths", replica="r0", cause="crash") == 1
    assert _counter_total(session, "serving.replica_resurrections", replica="r0") == 1
    assert [p for rid, p in _timeline(session) if rid == "r0"] == [
        "died-crash", "respawn", "rejoin-probe", "rejoined"]


def test_hang_probe_timeout_treated_like_crash():
    model, data, _ = _fixture(17)
    session = TelemetrySession("hang")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet, probe_deadline_s=0.5, hang_timeout_s=0.2)
        requests = build_requests(data, model, [4] * 20)
        set_plan(FaultPlan.parse("replica:hang:replica=r0:times=1"))
        futures = [fleet.submit(r) for r in requests]
        time.sleep(0.4)  # the wedge latches; r0's heartbeat goes stale
        sup.check_once()  # declares the hang, abandons, reroutes
        results = [f.result(timeout=60) for f in futures]
        set_plan(None)
        _check_rows(results, model.score(data), data)
        r0 = fleet.replicas[0]
        assert _counter_total(session, "serving.replica_deaths", replica="r0",
                              cause="hang") == 1
        assert _resurrect(sup, r0)
    assert _counter_total(session, "serving.replica_resurrections", replica="r0") == 1
    phases = [p for rid, p in _timeline(session) if rid == "r0"]
    assert phases[0] == "died-hang" and phases[-1] == "rejoined"


def test_flapping_replica_quarantined_permanently():
    model, data, _ = _fixture(19)
    session = TelemetrySession("flap")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet, max_deaths=2, flap_window_s=60.0)
        (req,) = build_requests(data, model, [4])
        r0 = fleet.replicas[0]
        for death in range(2):
            set_plan(FaultPlan.parse("replica:crash:replica=r0:times=1"))
            fleet.submit(req).result(timeout=30)
            set_plan(None)
            assert not r0.alive
            if death == 0:
                assert _resurrect(sup, r0)
        for _ in range(5):
            sup.check_once()
        assert r0.quarantined and not r0.alive
        assert _counter_total(session, "serving.replica_quarantined", replica="r0") == 1
        assert _counter_total(session, "serving.replica_resurrections", replica="r0") == 1
        assert _counter_total(session, "serving.replica_deaths", replica="r0") == 2
        np.testing.assert_allclose(fleet.score(req), host_score_request(model, req),
                                   rtol=0, atol=SCORE_TOL)
        assert ("r0", "quarantined") in _timeline(session)


def test_resurrection_during_rollout_rejoins_on_new_model():
    model, data, arrays = _fixture(23)
    retrained = _retrained(arrays, 29)
    session = TelemetrySession("rollout-resurrect")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet)
        requests = build_requests(data, model, [4] * 6)
        for req in requests:
            fleet.score(req)
        set_plan(FaultPlan.parse("replica:crash:replica=r0:times=1"))
        [f.result(timeout=30) for f in [fleet.submit(r) for r in requests]]
        set_plan(None)
        r0 = fleet.replicas[0]
        assert not r0.alive
        fleet.rollout(retrained, probe_requests=requests[:2])
        assert fleet.current_model()[1] == 1
        assert _resurrect(sup, r0)
        np.testing.assert_allclose(r0.submit(requests[0]).result(timeout=30),
                                   retrained.score(data)[:4], rtol=0, atol=SCORE_TOL)
        assert r0.scorer.model is retrained


def test_kill_resurrect_cycle_captures_nothing_after_warmup():
    """The thread replica's re-warm finds its bucket programs captured and
    the rejoin probes replay them: no scorer captures again."""
    model, data, _ = _fixture(31)
    session = TelemetrySession("no-capture")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet)
        captured = [r.scorer.compilations for r in fleet.replicas]
        requests = build_requests(data, model, [4] * 12)
        set_plan(FaultPlan.parse("replica:crash:replica=r0:times=1"))
        [f.result(timeout=30) for f in [fleet.submit(r) for r in requests]]
        set_plan(None)
        assert _resurrect(sup, fleet.replicas[0])
        _check_rows([fleet.score(r) for r in requests], model.score(data), data)
        assert [r.scorer.compilations for r in fleet.replicas] == captured
    assert _counter_total(session, "serving.compilations") == sum(captured)


def test_spawn_failure_backs_off_and_eventually_rejoins():
    model, data, _ = _fixture(37)
    session = TelemetrySession("spawn-backoff")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet, respawn_base_s=0.05)
        (req,) = build_requests(data, model, [4])
        set_plan(FaultPlan.parse("replica:crash:replica=r0:times=1,"
                                 "replica:spawn:replica=r0:times=2"))
        fleet.submit(req).result(timeout=30)
        r0 = fleet.replicas[0]
        assert not r0.alive
        sup.check_once()  # death noted; respawn attempt 1 hits the fault
        assert _counter_total(session, "serving.respawn_failures", replica="r0") == 1
        sup.check_once()  # inside the backoff window: no attempt
        assert _counter_total(session, "serving.respawn_failures", replica="r0") == 1
        assert _resurrect(sup, r0, rounds=40, sleep_s=0.05)
        set_plan(None)
        assert _counter_total(session, "serving.respawn_failures", replica="r0") == 2
        assert _counter_total(session, "serving.replica_resurrections", replica="r0") == 1
        phases = [p for rid, p in _timeline(session) if rid == "r0"]
        assert phases.index("respawn-failed") < phases.index("rejoined")
        assert phases[-1] == "rejoined"


def test_respawn_failures_past_the_bound_quarantine():
    model, data, _ = _fixture(39)
    session = TelemetrySession("spawn-quarantine")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet, max_respawn_failures=2)
        (req,) = build_requests(data, model, [4])
        set_plan(FaultPlan.parse("replica:crash:replica=r0:times=1,replica:spawn:replica=r0:p=1"))
        fleet.submit(req).result(timeout=30)
        r0 = fleet.replicas[0]
        for _ in range(4):
            sup.check_once()
        assert r0.quarantined and not r0.alive
        assert _counter_total(session, "serving.respawn_failures", replica="r0") == 2


def test_probe_timeout_on_busy_replica_is_not_a_hang():
    model, data, _ = _fixture(53)
    session = TelemetrySession("busy-not-hung")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet, probe_deadline_s=0.1, hang_timeout_s=0.5)
        r0 = fleet.replicas[0]
        r0.submit = lambda request: Future()  # the probe never resolves
        heartbeat(r0.heartbeat_site)  # fresh scoring progress
        sup._health_check(r0)
        assert r0.alive  # busy, not hung
        time.sleep(0.6)  # now the progress mark is stale too
        sup._health_check(r0)
        assert not r0.alive and r0.death_cause == "hang"


def test_parity_gate_rejects_nan_and_shape_mismatch():
    from photon_tpu_torch.serving import router, supervisor
    from photon_tpu_torch.serving.supervisor import parity_worst

    assert supervisor.parity_worst is router.parity_worst
    assert parity_worst([1.0, 2.0], np.asarray([1.0, 2.0])) == 0.0
    assert parity_worst([1.0, 2.5], [1.0, 2.0]) == pytest.approx(0.5)
    assert parity_worst([1.0, np.nan], [1.0, 2.0]) == float("inf")
    assert parity_worst([1.0], [1.0, 2.0]) == float("inf")
    assert parity_worst([], []) == 0.0


def test_failed_rollout_keeps_model_version_monotonic():
    model, data, arrays = _fixture(59)
    retrained = _retrained(arrays, 61)
    session = TelemetrySession("rollout-version")
    with _fleet(model, data, session) as fleet:
        probes = build_requests(data, model, [4])
        assert fleet.current_model() == (model, 0)
        with pytest.raises(Exception):
            fleet.rollout(retrained, probe_requests=probes,
                          probe_oracle=lambda req: np.full(req.num_rows, 1e6, np.float32))
        m, v = fleet.current_model()
        assert m is model and v == 2  # bump + rollback-bump: monotonic
        assert not fleet.rollout_in_progress()
        fleet.rollout(retrained, probe_requests=probes)
        assert fleet.current_model() == (retrained, 3)
        assert all(r.scorer.model is retrained for r in fleet.replicas)


# -- the fleet-wide rollback ----------------------------------------------------

def test_fleet_wide_parity_regression_rolls_back_not_quarantines():
    model, data, arrays = _fixture(61)
    model2, skewed = _retrained(arrays, 62), _retrained(arrays, 63)
    session = TelemetrySession("fleet-rollback")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet)
        fleet.rollout(model2, probe_requests=build_requests(data, model2, [4, 4]))
        for replica in fleet.replicas:  # every replica silently serves skew
            replica.scorer.swap_model(skewed)
        sup.check_once()
        assert _counter_total(session, "serving.rollout_rollbacks") == 1
        assert _counter_total(session, "serving.replica_deaths") == 0
        assert _counter_total(session, "serving.replica_quarantined") == 0
        assert all(r.alive for r in fleet.replicas)
        assert fleet.current_model() == (model, 2)
        (req,) = build_requests(data, model, [6])
        np.testing.assert_allclose(fleet.score(req), host_score_request(model, req),
                                   rtol=0, atol=SCORE_TOL)
        sup.check_once()
        assert _counter_total(session, "serving.rollout_rollbacks") == 1
        phases = [phase for _rid, phase in _timeline(session)]
        assert phases.count("fleet-rollback") == len(fleet.replicas)


def test_partial_parity_failure_still_declares_per_replica():
    model, data, arrays = _fixture(67)
    model2, skewed = _retrained(arrays, 68), _retrained(arrays, 69)
    session = TelemetrySession("partial-parity")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet, resurrect=False)
        fleet.rollout(model2, probe_requests=build_requests(data, model2, [4]))
        fleet.replicas[0].scorer.swap_model(skewed)
        sup.check_once()
        assert _counter_total(session, "serving.rollout_rollbacks") == 0
        assert _counter_total(session, "serving.replica_deaths", cause="parity") == 1
        assert not fleet.replicas[0].alive and fleet.replicas[1].alive
        assert fleet.current_model()[0] is model2


def test_rollback_without_predecessor_falls_back_to_declarations():
    model, data, arrays = _fixture(71)
    skewed = _retrained(arrays, 72)
    session = TelemetrySession("no-predecessor")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet, resurrect=False)
        assert fleet.rollback_to_previous() is False
        for replica in fleet.replicas:
            replica.scorer.swap_model(skewed)
        sup.check_once()
        assert _counter_total(session, "serving.rollout_rollbacks") == 0
        assert _counter_total(session, "serving.replica_deaths",
                              cause="parity") == len(fleet.replicas)


def test_supervision_during_a_rebuild_does_not_roll_it_back():
    """A rebuild publishes its model before the replicas cut over to it: a
    known-answer pass in that window is a publish in flight, not a
    fleet-wide regression, and must not roll the new model back."""
    import dataclasses
    import threading

    import torch

    from photon_tpu_torch.game.model import RandomEffectModel

    model, data, arrays = _fixture(73)
    session = TelemetrySession("rebuild-supervised")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet, resurrect=False)
        requests = build_requests(data, model, [4, 4])
        fleet.rollout(_retrained(arrays, 74), probe_requests=requests)
        current = fleet.current_model()[0]
        per = current.coordinates["per_entity"]
        assert isinstance(per, RandomEffectModel)
        keys = np.asarray(per.keys)
        grown_per = per.with_entities(
            np.concatenate([keys, keys.max() + 1 + np.arange(len(keys))]))
        # Retrained rows: the old tables' answers differ from the new oracle.
        grown_per = dataclasses.replace(grown_per, table=torch.as_tensor(
            np.random.default_rng(5).standard_normal(tuple(grown_per.table.shape)),
            dtype=torch.float32))
        grown = type(current)(coordinates={**current.coordinates, "per_entity": grown_per},
                              task_type=current.task_type)
        passes = []
        build = fleet._build_replacement

        def build_with_a_pass(replica, m, factor):
            if replica is fleet.replicas[0]:  # one pass while the rebuild runs
                passes.append(threading.Thread(target=sup.check_once))
                passes[0].start()
                passes[0].join(timeout=3)
            return build(replica, m, factor)

        fleet._build_replacement = build_with_a_pass
        fleet.rebuild(model=grown, probe_requests=requests)
        passes[0].join(timeout=60)  # a pass that waited for the publish lock ends
        assert not passes[0].is_alive()
        assert fleet.current_model()[0] is grown
        assert _counter_total(session, "serving.rollout_rollbacks") == 0
        assert _counter_total(session, "serving.replica_deaths") == 0
        np.testing.assert_allclose(fleet.score(requests[0]),
                                   host_score_request(grown, requests[0]),
                                   rtol=0, atol=SCORE_TOL)


# -- the report -------------------------------------------------------------------

def test_report_renders_supervisor_timeline():
    from photon_tpu_torch.telemetry.report import render_markdown

    model, data, _ = _fixture(47)
    session = TelemetrySession("supervisor-report")
    with _fleet(model, data, session) as fleet:
        sup = _supervisor(fleet, max_deaths=2)
        (req,) = build_requests(data, model, [4])
        for _ in range(2):
            set_plan(FaultPlan.parse("replica:crash:replica=r0:times=1"))
            fleet.submit(req).result(timeout=30)
            set_plan(None)
            _resurrect(sup, fleet.replicas[0])
        for _ in range(3):
            sup.check_once()
    md = render_markdown({"driver": "test", "run_id": "x", "status": "ok",
                          "metrics": session.registry.snapshot()})
    assert "## Serving fleet" in md and "**supervisor**" in md
    assert "resurrections=1" in md and "quarantined=1 (r0)" in md
    assert "**supervisor timeline**" in md
    assert "r0:died-crash" in md and "r0:rejoined" in md and "r0:quarantined" in md


def test_supervise_twice_refused_and_started_thread_stops():
    model, data, _ = _fixture(79)
    with _fleet(model, data, TelemetrySession("twice")) as fleet:
        sup = fleet.supervise(SupervisorPolicy(probe_interval_s=0.01))
        with pytest.raises(RuntimeError, match="already supervised"):
            fleet.supervise()
        time.sleep(0.1)
        assert sup._thread is not None and sup._thread.is_alive()
    assert sup._thread is None  # close() stopped it
