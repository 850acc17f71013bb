"""The socket transport against the JAX package's, on the CPU.

Mirrors the transport cases of ``tests/test_fleet.py`` (:153-245) and
``tests/test_supervisor.py`` (:251): the frames are byte-identical between
the packages for the same seeded request, response and control frame, each
package unpacks the other's frames, the JAX package's ``ScoringClient``
scores through the port's ``ScoringServer`` (and the port's client through
the JAX package's server) within 1e-5 of the host oracle, an injected
``transport:read`` fault is retried to a clean response, and the pipelined
``AsyncScoringClient`` drives an open loop through the socket.
"""

import numpy as np
import pytest

from photon_tpu import serving as ref_serving
from photon_tpu.data.synthetic import make_game_dataset as ref_dataset
from photon_tpu.game import model as ref_model
from photon_tpu.models.glm import Coefficients as RefCoefficients
from photon_tpu.models.glm import model_for_task as ref_model_for_task
from photon_tpu.serving import transport as ref_transport
from photon_tpu.telemetry.distributed import TraceContext as RefTraceContext
from photon_tpu.telemetry.distributed import attach_trace as ref_attach_trace
from photon_tpu_torch.fault.injection import FaultPlan, set_plan
from photon_tpu_torch.game.data import DenseShard, GameDataset
from photon_tpu_torch.game.model import game_model_from_numpy
from photon_tpu_torch.serving import (
    AsyncScoringClient,
    RequestShedError,
    ScoringClient,
    ScoringRequest,
    ServingFleet,
    TrafficSpec,
    TransportError,
    build_requests,
    generate_traffic,
    host_score_request,
    replay_open_loop,
    request_spec_for_dataset,
)
from photon_tpu_torch.serving import transport
from photon_tpu_torch.telemetry import TelemetrySession
from photon_tpu_torch.telemetry.distributed import TraceContext, attach_trace

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


def _fleet(model, data, session, replicas=1):
    return ServingFleet(
        model, replicas=replicas, device="cpu",
        request_spec=request_spec_for_dataset(model, data),
        max_batch=16, max_delay_s=0.001, telemetry=session,
    ).warmup()


def _counter_total(session, name, **labels):
    return sum(m["value"] for m in session.registry.snapshot()["counters"]
               if m["name"] == name
               and all(str(m["labels"].get(k)) == str(v) for k, v in labels.items()))


def _seeded_fields(seed: int):
    """One request's arrays: dense and sparse shards, int and string keys,
    an offset — every slot the wire carries."""
    rng = np.random.default_rng(seed)
    return dict(
        features={
            "dense": rng.standard_normal((3, 4)).astype(np.float32),
            "sparse": (rng.integers(0, 50, (3, 2), dtype=np.int32),
                       rng.standard_normal((3, 2)).astype(np.float32)),
        },
        entity_ids={"user": rng.integers(0, 1000, 3).astype(np.int64),
                    "item": np.asarray(["a-1", "bb-22", "ccc-333"])},
        offset=rng.standard_normal(3).astype(np.float32),
    )


def _both_requests(seed: int, model=None, trace=False):
    ours = ScoringRequest(**_seeded_fields(seed), model=model)
    theirs = ref_serving.ScoringRequest(**_seeded_fields(seed), model=model)
    if trace:
        attach_trace(ours, TraceContext("t" * 16, "s" * 8, True))
        ref_attach_trace(theirs, RefTraceContext("t" * 16, "s" * 8, True))
    return ours, theirs


def _assert_requests_equal(got, want):
    assert sorted(got.features) == sorted(want.features)
    for name, leaf in want.features.items():
        other = got.features[name]
        if isinstance(leaf, tuple):
            for a, b in zip(other, leaf):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        else:
            np.testing.assert_array_equal(other, leaf)
    for col, keys in want.entity_ids.items():
        np.testing.assert_array_equal(got.entity_ids[col], keys)
        assert got.entity_ids[col].dtype == keys.dtype
    np.testing.assert_array_equal(got.offset, want.offset)


# -- wire format -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"deadline_s": 0.025}, {"seq": 7}, {"seq": 3, "gen": 2},
    {"deadline_s": 1.5, "seq": 11, "gen": 0, "trace": True},
    {"model": "m1"}, {"model": np.asarray(["m0", "m1", "m0"], dtype=object)},
])
def test_request_frames_byte_identical(kw):
    kw = dict(kw)
    trace = kw.pop("trace", False)
    model = kw.pop("model", None)
    ours, theirs = _both_requests(5, model=model, trace=trace)
    assert transport.pack_request(ours, **kw) == ref_transport.pack_request(theirs, **kw)


@pytest.mark.parametrize("frame", ["scores", "scores_meta", "shed", "error", "control"])
def test_response_and_control_frames_byte_identical(frame):
    scores = np.linspace(-2, 2, 7, dtype=np.float32)
    meta = {"version": 3, "gen": 1, "spans": [{"start": 1.5, "events": [{"t": 1.6}]}]}
    packs = {
        "scores": lambda m: m.pack_scores(scores, seq=4),
        "scores_meta": lambda m: m.pack_scores(scores, seq=4, meta=meta),
        "shed": lambda m: m.pack_shed("overload", "queue projection blown", seq=2),
        "error": lambda m: m.pack_error("boom " * 600, seq=9),
        "control": lambda m: m.pack_control("pong", version=2, seq=5, gen=1,
                                            child_time=12.25, compilations=3),
    }
    assert packs[frame](transport) == packs[frame](ref_transport)


def test_each_package_unpacks_the_others_frames():
    ours, theirs = _both_requests(9, trace=True)
    got, deadline, seq, header = transport.unpack_request_hx(
        ref_transport.pack_request(theirs, deadline_s=0.5, seq=6, gen=4))
    _assert_requests_equal(got, theirs)
    assert (deadline, seq, header["gen"]) == (0.5, 6, 4)
    assert got._photon_trace.to_wire() == theirs._photon_trace.to_wire()
    back, deadline = ref_transport.unpack_request(transport.pack_request(ours, 0.25))
    _assert_requests_equal(back, ours)
    assert deadline == 0.25
    scores = np.arange(5, dtype=np.float32) / 3
    np.testing.assert_array_equal(transport.unpack_response(ref_transport.pack_scores(scores)),
                                  scores)
    np.testing.assert_array_equal(ref_transport.unpack_response(transport.pack_scores(scores)),
                                  scores)
    with pytest.raises(RequestShedError, match="blown") as e:
        transport.unpack_response(ref_transport.pack_shed("deadline", "budget blown"))
    assert e.value.reason == "deadline"
    with pytest.raises(TransportError, match="boom"):
        transport.unpack_response(ref_transport.pack_error("boom"))
    assert ref_transport.unpack_control(transport.pack_control("ok", seq=3)) == \
        transport.unpack_control(ref_transport.pack_control("ok", seq=3))


def test_malformed_frames_refused():
    payload = transport.pack_scores(np.ones(4, np.float32))
    with pytest.raises(TransportError, match="truncated"):
        transport._unpack(payload[:-3])
    with pytest.raises(TransportError, match="trailing"):
        transport._unpack(payload + b"x")
    with pytest.raises(TransportError, match="unexpected request kind"):
        transport.unpack_request(payload)


# -- TCP serving -------------------------------------------------------------

def test_jax_client_scores_through_port_server():
    arrays, rdata = _arrays(5)
    model, data = _port_model(*arrays), _as_port(rdata)
    rmodel = _ref_model(*arrays)
    session = TelemetrySession("tcp")
    sizes = [1, 5, 16, 3]
    with _fleet(model, data, session) as fleet:
        server = fleet.serve()
        with ref_transport.ScoringClient(server.address) as client:
            for req in ref_serving.build_requests(rdata, rmodel, sizes):
                got = client.score(req, deadline_s=10.0)
                np.testing.assert_allclose(
                    got, ref_serving.host_score_request(rmodel, req),
                    rtol=0, atol=SCORE_TOL)
        with pytest.raises(RuntimeError, match="already serving"):
            fleet.serve()
    assert _counter_total(session, "serving.transport_connections") >= 1
    assert _counter_total(session, "serving.transport_bytes", direction="in") > 0
    assert _counter_total(session, "serving.admitted") == len(sizes)


def test_port_client_scores_through_jax_server():
    arrays, rdata = _arrays(6)
    model, data = _port_model(*arrays), _as_port(rdata)
    rmodel = _ref_model(*arrays)
    rfleet = ref_serving.ServingFleet(
        rmodel, replicas=1, request_spec=ref_serving.request_spec_for_dataset(rmodel, rdata),
        max_batch=16, max_delay_s=0.001).warmup()
    try:
        server = rfleet.serve()
        with ScoringClient(server.address) as client:
            for req in build_requests(data, model, [4, 9]):
                np.testing.assert_allclose(client.score(req), host_score_request(model, req),
                                           rtol=0, atol=SCORE_TOL)
            with pytest.raises(RequestShedError) as e:
                client.score(build_requests(data, model, [2])[0], deadline_s=0.0)
            assert e.value.reason == "deadline"
    finally:
        rfleet.close()


def test_transport_read_fault_retried_to_clean_response(monkeypatch):
    monkeypatch.setenv("PHOTON_IO_RETRY_BASE_S", "0")
    arrays, rdata = _arrays(7)
    model, data = _port_model(*arrays), _as_port(rdata)
    session = TelemetrySession("transport-fault")
    with _fleet(model, data, session) as fleet:
        server = fleet.serve()
        (req,) = build_requests(data, model, [6])
        set_plan(FaultPlan.parse("transport:read:times=2"))
        with ScoringClient(server.address, telemetry=session) as client:
            got = client.score(req)
        set_plan(None)
        np.testing.assert_allclose(got, host_score_request(model, req), rtol=0, atol=SCORE_TOL)
    assert _counter_total(session, "io.retries", site="transport:read") >= 1


def test_async_client_drives_open_loop_through_socket():
    """seq-tagged frames over two connections, futures resolved out of
    order, a remote shed as a typed frame, and ``replay_open_loop``
    driving the socket itself."""
    arrays, rdata = _arrays(11)
    model, data = _port_model(*arrays), _as_port(rdata)
    session = TelemetrySession("async-client")
    with _fleet(model, data, session, replicas=2) as fleet:
        server = fleet.serve()
        want = model.score(data)
        with AsyncScoringClient(server.address, connections=2,
                                telemetry=session) as client:
            requests = build_requests(data, model, [4] * 24)
            futures = [client.submit(r) for r in requests]
            pos = 0
            for fut in futures:
                rows = np.arange(pos, pos + 4) % data.num_examples
                np.testing.assert_allclose(fut.result(timeout=30), want[rows],
                                           rtol=0, atol=1e-4)
                pos = (pos + 4) % data.num_examples
            with pytest.raises(RequestShedError) as e:
                client.submit(requests[0], deadline_s=0.0).result(timeout=30)
            assert e.value.reason == "deadline"
            traffic = generate_traffic(data, model, TrafficSpec(
                requests=30, mean_rows=4, max_rows=16, target_qps=400.0, seed=2))
            outcomes = replay_open_loop(client.submit, traffic, timeout_s=60.0)
        assert all(o.status == "ok" for o in outcomes)
        for out in outcomes:
            np.testing.assert_allclose(out.scores, host_score_request(model, out.item.request),
                                       rtol=0, atol=SCORE_TOL)
            assert out.finished_at_s is not None
        with pytest.raises(RuntimeError, match="closed"):
            client.submit(requests[0])
