"""The thread fleet, the router and the traffic generator against the JAX
package, on the CPU.

Mirrors the thread-fleet, traffic and report cases of
``tests/test_fleet.py``: dispatch across replicas, overload and deadline
shedding with their accounting and no capture after warmup, the
cold-start storm on the zero row, a replica killed mid-stream rerouted
with no lost request, the canary rollout under load and its rollbacks,
the fleet rollback and the zero-downtime rebuild; the generator's request
stream equals the reference's for the same seed; the "## Serving fleet"
report section.
"""

import numpy as np
import pytest

from photon_tpu.data.synthetic import make_game_dataset as ref_dataset
from photon_tpu import serving as ref_serving
from photon_tpu.game import model as ref_model
from photon_tpu.models.glm import Coefficients as RefCoefficients
from photon_tpu.models.glm import model_for_task as ref_model_for_task
from photon_tpu_torch.fault.injection import FaultPlan, set_plan
from photon_tpu_torch.game.data import DenseShard, GameDataset
from photon_tpu_torch.game.model import game_model_from_numpy
from photon_tpu_torch.serving import (
    AdmissionPolicy,
    NoHealthyReplicaError,
    RequestShedError,
    RolloutParityError,
    ServingFleet,
    TrafficSpec,
    build_requests,
    generate_traffic,
    host_score_request,
    request_spec_for_dataset,
    request_windows,
    run_closed_loop_outcomes,
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


def _ref_model(means, keys, table):
    task = "logistic_regression"
    return ref_model.GameModel(coordinates={
        "fixed": ref_model.FixedEffectModel(
            ref_model_for_task(task, RefCoefficients(means)), "global"),
        "per_entity": ref_model.RandomEffectModel(
            table=table, keys=keys, entity_column="re0", shard_name="re0",
            task_type=task),
    }, task_type=task)


def _as_port(data) -> GameDataset:
    return GameDataset(label=data.label, offset=data.offset, weight=data.weight,
                       shards={n: DenseShard(s.x) for n, s in data.shards.items()},
                       id_columns=dict(data.id_columns))


def _fixture(seed, n_entities=40):
    arrays, rdata = _arrays(seed, n_entities=n_entities)
    return _port_model(*arrays), _as_port(rdata), arrays, rdata


def _retrained(arrays, seed):
    means, keys, table = arrays
    rng = np.random.default_rng(seed)
    return _port_model((means + rng.standard_normal(means.shape)).astype(np.float32),
                       keys, rng.standard_normal(table.shape).astype(np.float32))


def _counter_total(session, name, **labels):
    total = 0
    for m in session.registry.snapshot()["counters"]:
        if m["name"] != name:
            continue
        if labels and any(str(m["labels"].get(k)) != str(v) for k, v in labels.items()):
            continue
        total += m["value"]
    return total


def _fleet(model, data, session, replicas=2, max_batch=16, **kwargs):
    return ServingFleet(
        model, replicas=replicas, device="cpu",
        request_spec=request_spec_for_dataset(model, data),
        max_batch=max_batch, max_delay_s=0.001, telemetry=session, **kwargs,
    ).warmup()


def _rollout_phases(session):
    steps = {(m["labels"]["replica"], m["labels"]["phase"]): m["value"]
             for m in session.registry.snapshot()["gauges"]
             if m["name"] == "serving.rollout_step"}
    return [key for key, _ in sorted(steps.items(), key=lambda kv: kv[1])]


def test_router_dispatches_across_replicas():
    model, data, _, _ = _fixture(9)
    session = TelemetrySession("dispatch")
    traffic = generate_traffic(data, model, TrafficSpec(requests=40, mean_rows=4,
                                                        max_rows=16, seed=0))
    with _fleet(model, data, session) as fleet:
        outcomes, _ = run_closed_loop_outcomes(
            lambda tid: (lambda item: fleet.score(item.request)), traffic.items,
            clients=4)
    assert all(o.status == "ok" for o in outcomes)
    for out in outcomes:
        np.testing.assert_allclose(out.scores, host_score_request(model, out.item.request),
                                   rtol=0, atol=SCORE_TOL)
    assert _counter_total(session, "serving.replica_requests", replica="r0") > 0
    assert _counter_total(session, "serving.replica_requests", replica="r1") > 0
    assert _counter_total(session, "serving.admitted") == 40


def test_overload_sheds_and_deadline_accounting_without_captures():
    model, data, _, _ = _fixture(11)
    session = TelemetrySession("overload")
    want = model.score(data)
    sizes = [4] * 150
    with _fleet(model, data, session, admission=AdmissionPolicy(max_queue_rows=64)) as fleet:
        captured = fleet.compilations
        admitted, sheds = [], 0
        for req, rows in zip(build_requests(data, model, sizes),
                             request_windows(data.num_examples, sizes)):
            try:
                admitted.append((fleet.submit(req), rows))
            except RequestShedError as e:
                assert e.reason in ("queue_full", "overload")
                sheds += 1
        for fut, rows in admitted:
            np.testing.assert_allclose(fut.result(timeout=60), want[rows],
                                       rtol=0, atol=SCORE_TOL)
        with pytest.raises(RequestShedError) as info:
            fleet.submit(build_requests(data, model, [4])[0], deadline_s=0.0)
        assert info.value.reason == "deadline"
        got = fleet.score(build_requests(data, model, [4])[0], deadline_s=30.0)
        np.testing.assert_allclose(got, want[:4], rtol=0, atol=SCORE_TOL)
        assert fleet.compilations == captured
    assert len(admitted) + sheds == len(sizes)
    assert _counter_total(session, "serving.shed") == sheds + 1
    assert _counter_total(session, "serving.shed", reason="deadline") == 1
    assert _counter_total(session, "serving.admitted") == len(admitted) + 1


def test_cold_start_storm_rides_zero_row_fallback():
    model, data, arrays, rdata = _fixture(17)
    session = TelemetrySession("storm")
    spec = TrafficSpec(requests=30, mean_rows=4, max_rows=16, storm_frac=0.3,
                       storm_at=0.5, seed=3)
    traffic = generate_traffic(data, model, spec)
    storm = [t for t in traffic.items if t.kind == "storm"]
    assert len(storm) == 9
    with _fleet(model, data, session) as fleet:
        captured = fleet.compilations
        outcomes, _ = run_closed_loop_outcomes(
            lambda tid: (lambda item: fleet.score(item.request)), traffic.items,
            clients=3)
        assert fleet.compilations == captured
    rm = _ref_model(*arrays)
    for out in outcomes:
        assert out.status == "ok"
        want = host_score_request(model, out.item.request)
        np.testing.assert_allclose(out.scores, want, rtol=0, atol=SCORE_TOL)
        req = out.item.request
        ref_req = ref_serving.ScoringRequest(features=req.features,
                                             entity_ids=req.entity_ids, offset=req.offset)
        np.testing.assert_allclose(want, ref_serving.host_score_request(rm, ref_req),
                                   rtol=0, atol=SCORE_TOL)
    assert _counter_total(session, "serving.cold_entities") == sum(
        t.request.num_rows for t in storm)


def test_replica_kill_mid_stream_reroutes_without_loss():
    model, data, _, _ = _fixture(19)
    session = TelemetrySession("kill")
    want = model.score(data)
    sizes = [4] * 30
    with _fleet(model, data, session) as fleet:
        set_plan(FaultPlan.parse("serve:replica_kill:replica=r0:times=1"))
        futures = [fleet.submit(r) for r in build_requests(data, model, sizes)]
        results = [f.result(timeout=60) for f in futures]
        set_plan(None)
        for rows, got in zip(request_windows(data.num_examples, sizes), results):
            np.testing.assert_allclose(got, want[rows], rtol=0, atol=SCORE_TOL)
        assert not fleet.replicas[0].alive and fleet.replicas[1].alive
    assert _counter_total(session, "serving.replica_deaths", replica="r0") == 1
    assert _counter_total(session, "serving.rerouted") >= 1


def test_all_replicas_dead_sheds_no_replica():
    model, data, _, _ = _fixture(23)
    with _fleet(model, data, TelemetrySession("dead"), replicas=1) as fleet:
        (req,) = build_requests(data, model, [4])
        set_plan(FaultPlan.parse("serve:replica_kill:times=1"))
        with pytest.raises(NoHealthyReplicaError):
            fleet.submit(req).result(timeout=30)
        set_plan(None)
        with pytest.raises(RequestShedError) as e:
            fleet.submit(req)
        assert e.value.reason == "no_replica"


def test_rollout_canary_probe_then_promote_under_load():
    model, data, arrays, _ = _fixture(29)
    retrained = _retrained(arrays, 31)
    session = TelemetrySession("rollout")
    want_old, want_new = model.score(data), retrained.score(data)
    sizes = [8] * 40
    with _fleet(model, data, session, max_batch=32) as fleet:
        captured = fleet.compilations
        futures = []
        for i, req in enumerate(build_requests(data, model, sizes)):
            if i == 20:
                fleet.rollout(retrained)
            futures.append(fleet.submit(req))
        results = [f.result(timeout=60) for f in futures]
        assert fleet.compilations == captured
        assert fleet.current_model() == (retrained, 1)
    windows = request_windows(data.num_examples, sizes)
    for rows, got in zip(windows, results):
        assert (np.allclose(got, want_old[rows], rtol=0, atol=SCORE_TOL)
                or np.allclose(got, want_new[rows], rtol=0, atol=SCORE_TOL))
    np.testing.assert_allclose(results[-1], want_new[windows[-1]], rtol=0, atol=SCORE_TOL)
    assert _counter_total(session, "serving.rollouts") == 1
    assert _counter_total(session, "serving.swaps") == 2  # canary + promote
    assert [p for _, p in _rollout_phases(session)] == ["canary", "probe_ok", "promoted"]


@pytest.mark.parametrize("failure", ["parity", "oracle"])
def test_rollout_rolls_the_canary_back(failure):
    model, data, arrays, _ = _fixture(37)
    session = TelemetrySession("rollback")
    with _fleet(model, data, session) as fleet:
        probes = build_requests(data, model, [4, 4])
        if failure == "parity":
            def oracle(req):
                return np.full(req.num_rows, 1e6, np.float32)
            error = RolloutParityError
        else:
            def oracle(req):
                raise RuntimeError("oracle exploded")
            error = RuntimeError
        with pytest.raises(error):
            fleet.rollout(_retrained(arrays, 41), probe_requests=probes,
                          probe_oracle=oracle)
        assert fleet.current_model() == (model, 2)
        for _ in range(4):
            np.testing.assert_allclose(fleet.score(probes[0]), model.score(data)[:4],
                                       rtol=0, atol=SCORE_TOL)
    assert "rolled_back" in {p for _, p in _rollout_phases(session)}
    assert _counter_total(session, "serving.rollouts") == 0


def test_rollout_survives_canary_kill_and_promote_failure():
    model, data, arrays, _ = _fixture(43)
    retrained = _retrained(arrays, 47)
    session = TelemetrySession("rollout-kill")
    with _fleet(model, data, session, replicas=3) as fleet:
        probes = build_requests(data, model, [4, 4])

        def refuse(_model):
            raise RuntimeError("device fell over at promote")

        fleet.replicas[2].scorer.swap_model = refuse
        set_plan(FaultPlan.parse("serve:replica_kill:replica=r0:times=1"))
        fleet.rollout(retrained, probe_requests=probes)
        set_plan(None)
        assert [r.alive for r in fleet.replicas] == [False, True, False]
        np.testing.assert_allclose(fleet.score(probes[0]), retrained.score(data)[:4],
                                   rtol=0, atol=SCORE_TOL)
    phases = _rollout_phases(session)
    assert ("r0", "died") in phases and ("r1", "probe_ok") in phases
    assert ("r2", "died") in phases
    assert _counter_total(session, "serving.rollouts") == 1


def test_rollback_to_previous_restores_the_predecessor():
    model, data, arrays, _ = _fixture(53)
    retrained = _retrained(arrays, 59)
    session = TelemetrySession("fleet-rollback")
    with _fleet(model, data, session) as fleet:
        probes = build_requests(data, model, [4])
        assert not fleet.rollback_to_previous()  # nothing published yet
        fleet.rollout(retrained, probe_requests=probes)
        assert not fleet.rollback_to_previous(expected_version=0)  # stale evidence
        assert fleet.rollback_to_previous(expected_version=1)
        assert fleet.current_model() == (model, 2)
        for _ in range(4):
            np.testing.assert_allclose(fleet.score(probes[0]), model.score(data)[:4],
                                       rtol=0, atol=SCORE_TOL)
        assert not fleet.rollback_to_previous()  # the slot cleared
    assert _counter_total(session, "serving.rollout_rollbacks") == 1


def test_rebuild_grows_capacity_without_dropping_requests():
    model, data, arrays, _ = _fixture(61)
    means, keys, table = arrays
    session = TelemetrySession("rebuild")
    capacity = model.coordinate("per_entity").serving_capacity
    extra = capacity  # past the served capacity: a rollout refuses
    rng = np.random.default_rng(62)
    grown = _port_model(means, np.concatenate([keys, np.arange(50_000, 50_000 + extra)]),
                        np.concatenate([table, rng.standard_normal(
                            (extra, table.shape[1])).astype(np.float32)]))
    sizes = [4] * 20
    with _fleet(model, data, session) as fleet:
        futures = [fleet.submit(r) for r in build_requests(data, model, sizes[:10])]
        with pytest.raises(ValueError, match="layout-shape change"):
            fleet.rollout(grown, probe_requests=build_requests(data, model, [4]))
        fleet.rebuild(model=grown, probe_requests=build_requests(data, model, [4]))
        futures += [fleet.submit(r) for r in build_requests(data, model, sizes[10:],
                                                              start=40)]
        results = [f.result(timeout=60) for f in futures]
        assert all(r.scorer._plan[1].capacity == 2 * 2 * capacity
                   for r in fleet.replicas)
        assert fleet.current_model() == (grown, 3)  # rollout, its undo, rebuild
    want_old, want_new = model.score(data), grown.score(data)
    windows = (request_windows(data.num_examples, sizes[:10])
               + request_windows(data.num_examples, sizes[10:], start=40))
    for rows, got in zip(windows, results):
        assert (np.allclose(got, want_old[rows], rtol=0, atol=SCORE_TOL)
                or np.allclose(got, want_new[rows], rtol=0, atol=SCORE_TOL))
    np.testing.assert_allclose(results[-1], want_new[windows[-1]], rtol=0, atol=SCORE_TOL)
    assert _counter_total(session, "serving.fleet_rebuilds") == 1
    assert _counter_total(session, "serving.replica_rebuilds") == 2


def test_submit_after_close_sheds_closed_without_phantom_death():
    model, data, _, _ = _fixture(73)
    session = TelemetrySession("closed")
    fleet = _fleet(model, data, session)
    (req,) = build_requests(data, model, [4])
    fleet.score(req)
    fleet.close()
    with pytest.raises(RequestShedError) as e:
        fleet.submit(req)
    assert e.value.reason == "closed"
    assert all(r.alive for r in fleet.replicas)
    assert _counter_total(session, "serving.replica_deaths") == 0


@pytest.mark.parametrize("what", ["subprocess", "supervise", "serve"])
def test_fleet_surfaces_serve(what):
    """The subprocess backend, the supervisor and the socket ingest each
    serve the host oracle's scores."""
    from photon_tpu_torch.serving import ScoringClient, SupervisorPolicy

    model, data, _, _ = _fixture(79)
    session = TelemetrySession(what)
    kwargs = {"backend": "subprocess"} if what == "subprocess" else {}
    requests = build_requests(data, model, [3, 9])
    with _fleet(model, data, session, replicas=1, **kwargs) as fleet:
        if what == "serve":
            with ScoringClient(fleet.serve().address) as client:
                got = [client.score(r) for r in requests]
        else:
            if what == "supervise":
                fleet.supervise(SupervisorPolicy(), start=False).check_once()
            got = [fleet.score(r) for r in requests]
        assert all(r.alive for r in fleet.replicas)
    for req, scores in zip(requests, got):
        np.testing.assert_allclose(scores, host_score_request(model, req),
                                   rtol=0, atol=SCORE_TOL)
    assert _counter_total(session, "serving.replica_deaths") == 0


@pytest.mark.parametrize("what", ["models"])
def test_not_ported_fleet_surfaces_raise(what):
    model, data, _, _ = _fixture(79)
    kwargs = {"models": {"models": {"m0": model}}}.get(what, {})
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        fleet = _fleet(model, data, TelemetrySession("np"), replicas=1, **kwargs)
        try:
            getattr(fleet, what)()
        finally:
            fleet.close()


@pytest.mark.parametrize("what", ["tenant_queue_rows", "fleet_model_id",
                                  "router_model_id", "submit_model"])
def test_not_ported_router_knobs_raise(what):
    """The arena's knobs refuse at the router as at the fleet, and a
    refusal leaves the fleet on its model."""
    if what == "tenant_queue_rows":
        with pytest.raises(NotImplementedError, match="queue 1, item 7"):
            AdmissionPolicy(tenant_queue_rows=4)
        return
    model, data, _, _ = _fixture(83)
    with _fleet(model, data, TelemetrySession("np"), replicas=1) as fleet:
        (req,) = build_requests(data, model, [3])
        with pytest.raises(NotImplementedError, match="queue 1, item 7"):
            if what == "submit_model":
                fleet.submit(req, model="m0")
            else:
                target = fleet if what == "fleet_model_id" else fleet.router
                target.rollout(model, probe_requests=[req], model_id="m0")
        assert fleet.current_model() == (model, 0)
        assert fleet.replicas[0].scorer.model is model


# -- traffic -----------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    TrafficSpec(requests=50, mean_rows=5, max_rows=16, alpha=1.2, storm_frac=0.1,
                target_qps=500.0, deadline_ms=20.0, seed=7),
    TrafficSpec(requests=40, mean_rows=8, max_rows=32, popularity="geometric", seed=4),
    TrafficSpec(requests=30, mean_rows=3, max_rows=8, ramp="flat", target_qps=100.0,
                splits={"a": 0.3, "b": 0.7}, seed=2),
])
def test_traffic_stream_equals_reference(spec):
    import dataclasses

    model, data, arrays, rdata = _fixture(49)
    ours = generate_traffic(data, model, spec)
    theirs = ref_serving.generate_traffic(
        rdata, _ref_model(*arrays),
        ref_serving.TrafficSpec(**dataclasses.asdict(spec)))
    assert ours.duration_s == theirs.duration_s
    assert len(ours.items) == len(theirs.items) == spec.requests
    for a, b in zip(ours.items, theirs.items):
        assert (a.at_s, a.kind, a.deadline_s, a.arm) == (b.at_s, b.kind, b.deadline_s, b.arm)
        np.testing.assert_array_equal(a.request.entity_ids["re0"],
                                      b.request.entity_ids["re0"])
        for k in b.request.features:
            np.testing.assert_array_equal(a.request.features[k], b.request.features[k])
        np.testing.assert_array_equal(a.request.offset, b.request.offset)
        assert a.request.model == b.request.model


def test_geometric_traffic_is_the_request_sizes_stream():
    from photon_tpu_torch.drivers.serve_game import request_sizes

    model, data, _, _ = _fixture(59)
    traffic = generate_traffic(data, model, TrafficSpec(
        requests=20, mean_rows=8, max_rows=32, popularity="geometric", seed=4))
    legacy = build_requests(data, model, request_sizes(20, 8.0, 32, seed=4))
    for item, old in zip(traffic.items, legacy):
        np.testing.assert_array_equal(item.request.features["global"], old.features["global"])
        np.testing.assert_array_equal(item.request.entity_ids["re0"], old.entity_ids["re0"])


def test_report_renders_serving_fleet_section():
    from photon_tpu_torch.telemetry.report import render_markdown

    model, data, arrays, _ = _fixture(61)
    session = TelemetrySession("fleet-report")
    with _fleet(model, data, session) as fleet:
        requests = build_requests(data, model, [4] * 10)
        for req in requests:
            fleet.score(req, deadline_s=30.0)
        with pytest.raises(RequestShedError):
            fleet.submit(requests[0], deadline_s=0.0)
        fleet.rollout(_retrained(arrays, 67), probe_requests=requests[:1])
    md = render_markdown({"driver": "test", "run_id": "x", "status": "ok",
                          "metrics": session.registry.snapshot()})
    assert "## Serving fleet" in md and "| r0 |" in md and "| r1 |" in md
    assert "**shed**" in md and "deadline=1" in md
    assert "**deadline hit rate**" in md and "**rollout timeline**" in md
    assert "canary" in md and "promoted" in md
    assert "## Serving fleet" not in render_markdown(
        {"driver": "t", "metrics": {"counters": [], "gauges": [], "histograms": []}})
