"""Network fault injection, leases and the rebuild against the JAX package,
on the CPU.

Mirrors ``tests/test_netfault.py`` on one subprocess replica (``rig``):
every fault primitive keeps the response set of a clean run; the port's
``NetFaultPlan`` makes the same fault sequence from the same plan seed as
the JAX package's (frame for frame, over socket pairs); a dropped
connection rejoins silently within the lease; the generation fence
rejects a zombie; a partition shorter than the lease heals with no death;
one past the lease declares cause ``lease``; a skewed child clock is
measured and its spans de-skewed; ``rollout_with_rebuild`` crosses the
capacity boundary, on threads and on a child replaced under live traffic.
"""

import socket
import struct
import threading
import time
import types

import numpy as np
import pytest

from photon_tpu.data.synthetic import make_game_dataset as ref_dataset
from photon_tpu.serving import netfault as ref_netfault
from photon_tpu.serving import transport as ref_transport
from photon_tpu_torch.game.data import DenseShard, GameDataset
from photon_tpu_torch.game.model import GameModel, game_model_from_numpy
from photon_tpu_torch.serving import (
    ReplicaDeadError,
    ReplicaRebuildError,
    ServingFleet,
    SupervisorPolicy,
    build_requests,
    host_score_request,
    is_capacity_refusal,
    request_spec_for_dataset,
)
from photon_tpu_torch.serving import netfault, transport
from photon_tpu_torch.serving.netfault import LinkRule, NetFaultPlan, partition, set_net_plan
from photon_tpu_torch.serving.supervisor import ReplicaSupervisor
from photon_tpu_torch.telemetry import TelemetrySession
from photon_tpu_torch.telemetry.distributed import (
    TraceContext,
    attach_trace,
    new_trace_id,
    shift_span_times,
)


@pytest.fixture(autouse=True)
def _clean_net_plan():
    set_net_plan(None)
    yield
    set_net_plan(None)


def _fixture(seed=3, n_entities=40, fixed_dim=6, random_dim=4):
    rdata, _ = ref_dataset(n_entities, 4, fixed_dim, random_dim, seed=seed)
    rng = np.random.default_rng(seed)
    keys = np.unique(rdata.id_columns["re0"])
    model = game_model_from_numpy("logistic_regression", {
        "fixed": {"type": "fixed", "shard_name": "global",
                  "means": rng.standard_normal(fixed_dim).astype(np.float32)},
        "per_entity": {"type": "random", "shard_name": "re0", "entity_column": "re0",
                       "keys": keys,
                       "table": rng.standard_normal((len(keys), random_dim)).astype(np.float32)},
    }, device="cpu")
    data = GameDataset(label=rdata.label, offset=rdata.offset, weight=rdata.weight,
                       shards={n: DenseShard(s.x) for n, s in rdata.shards.items()},
                       id_columns=dict(rdata.id_columns))
    return model, data


def _counter(session, name, **labels):
    return sum(m["value"] for m in session.registry.snapshot()["counters"]
               if m["name"] == name
               and all(str(m["labels"].get(k)) == str(v) for k, v in labels.items()))


def _rewire(fleet):
    """Force every child replica's next exchange through a silent
    reconnect: the redial passes ``maybe_shim``, so a just-installed (or
    just-cleared) plan takes effect on a live fleet."""
    for replica in fleet.replicas:
        for chan in ("_data", "_ctrl"):
            try:
                getattr(replica.scorer, chan).close()
            except OSError:
                pass


def _grown(model, extra=None):
    """The capacity-crossing model: the per-entity vocabulary grown past
    the factor-1 headroom."""
    pe = model.coordinates["per_entity"]
    ks = np.asarray(pe.keys)
    n_new = extra if extra is not None else len(ks) + 4
    new = ks.max() + np.arange(1, n_new, dtype=ks.dtype)
    return GameModel(coordinates={"fixed": model.coordinates["fixed"],
                                  "per_entity": pe.with_entities(
                                      np.unique(np.concatenate([ks, new])))},
                     task_type=model.task_type)


def _subprocess_fleet(model, data, session, **kwargs):
    return ServingFleet(model, replicas=1, backend="subprocess", device="cpu",
                        request_spec=request_spec_for_dataset(model, data),
                        max_batch=16, max_delay_s=0.001, telemetry=session,
                        **kwargs).warmup()


@pytest.fixture(scope="module")
def rig():
    """One subprocess replica shared by the protocol tests; each restores
    the clean state it found (plan cleared, generation re-synced)."""
    set_net_plan(None)
    model, data = _fixture(seed=3)
    session = TelemetrySession("netfault-rig")
    fleet = _subprocess_fleet(model, data, session)
    # Short per-attempt silence: black-holed frames resend quickly.
    fleet.replicas[0].scorer.exchange_timeout_s = 0.25
    requests = build_requests(data, model, [4, 9, 2, 7, 3, 5])
    clean = [np.asarray(fleet.score(r), np.float64) for r in requests]
    yield types.SimpleNamespace(model=model, data=data, session=session, fleet=fleet,
                                requests=requests, clean=clean)
    set_net_plan(None)
    fleet.close()


# -- the same fault sequence as the reference ---------------------------------

_FRAMES = [transport.pack_control("ping", seq=i, child_time=100.0 + i,
                                  spans=[{"start": 50.0 + i, "events": [{"t": 50.5 + i}]}])
           for i in range(40)]
_RULES = {
    "drop": dict(drop_p=0.3),
    "duplicate": dict(dup_p=0.5),
    "reorder": dict(dup_p=0.3, reorder_p=0.4),
    "mixed": dict(drop_p=0.2, dup_p=0.2, reorder_p=0.3),
    "skew": dict(skew_s=30.0),
}


def _wire(payload: bytes) -> bytes:
    return struct.pack("!I", len(payload)) + payload


def _frames_of(raw: bytes) -> list:
    out, pos = [], 0
    while pos < len(raw):
        (n,) = struct.unpack("!I", raw[pos:pos + 4])
        out.append(raw[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def _drain(sock) -> bytes:
    sock.settimeout(2.0)
    chunks = []
    while True:
        chunk = sock.recv(1 << 16)
        if not chunk:
            return b"".join(chunks)
        chunks.append(chunk)


def _send_through(module, plan) -> list:
    a, b = socket.socketpair()
    shim = module.FrameShimSocket(a, "r0:data", plan)
    for payload in _FRAMES:
        shim.sendall(_wire(payload))
    shim.close()
    return _frames_of(_drain(b))


def _recv_through(module, tmod, plan) -> list:
    a, b = socket.socketpair()
    b.sendall(b"".join(_wire(p) for p in _FRAMES))
    b.close()
    shim = module.FrameShimSocket(a, "r0:data", plan)
    shim.settimeout(2.0)
    out = []
    while True:
        try:
            out.append(tmod.read_frame(shim))
        except OSError:  # the peer's close: every frame is in
            return out


@pytest.mark.parametrize("cell,direction", [
    (cell, direction) for cell in sorted(_RULES) for direction in ("send", "recv")
    if not (cell == "skew" and direction == "send")  # skew rewrites inbound frames
])
def test_same_fault_sequence_as_the_reference(cell, direction):
    """The same rules and seed fault the same frames the same way in both
    packages: the delivered frames and the event counters are equal."""
    got = {}
    for name, module, tmod in (("ours", netfault, transport),
                               ("theirs", ref_netfault, ref_transport)):
        plan = module.NetFaultPlan(
            [module.LinkRule(link="r0:*", direction=direction, **_RULES[cell])], seed=17)
        plan.activate()
        frames = (_send_through(module, plan) if direction == "send"
                  else _recv_through(module, tmod, plan))
        got[name] = (frames, dict(plan.counters))
    assert got["ours"] == got["theirs"]
    assert got["ours"][1], f"cell {cell} never fired"


def test_partition_windows_and_draws_match_the_reference():
    rules = [partition("r0:*", 0.5, 1.0), partition("r1:data", 0.0, None, "recv")]
    ref_rules = [ref_netfault.partition("r0:*", 0.5, 1.0),
                 ref_netfault.partition("r1:data", 0.0, None, "recv")]
    ours, theirs = NetFaultPlan(rules, seed=9), ref_netfault.NetFaultPlan(ref_rules, seed=9)
    now = time.monotonic()
    for t in (0.0, 0.49, 0.5, 1.2, 1.49, 1.5, 30.0):
        ours._epoch = theirs._epoch = now - t
        assert ([ours.partition_active(r) for r in ours.rules]
                == [theirs.partition_active(r) for r in theirs.rules])
    for link in ("r0:data", "r1:ctrl", "r7:data"):
        assert ours.applies(link) == theirs.applies(link)
        for direction in ("send", "recv"):
            a, b = ours.rng(link, direction), theirs.rng(link, direction)
            assert [a.random() for _ in range(5)] == [b.random() for _ in range(5)]
    assert partition("x", 1.0, 2.0) == LinkRule(link="x", partitions=((1.0, 3.0),))


def test_maybe_shim_wraps_only_matching_links():
    a, b = socket.socketpair()
    try:
        assert netfault.maybe_shim(a, "r0:data") is a
        set_net_plan(NetFaultPlan([LinkRule(link="r1:*", drop_p=1.0)]))
        assert netfault.maybe_shim(a, "r0:data") is a
        shim = netfault.maybe_shim(a, "r1:ctrl")
        assert isinstance(shim, netfault.FrameShimSocket)
        assert netfault.active_net_plan() is not None
    finally:
        a.close()
        b.close()


# -- the protocol under faults ---------------------------------------------------

def test_every_fault_primitive_preserves_response_set(rig):
    cells = {
        "drop": NetFaultPlan([LinkRule(link="r0:data", direction="both", drop_p=0.3)], seed=5),
        "duplicate": NetFaultPlan([LinkRule(link="r0:data", direction="both", dup_p=1.0)],
                                  seed=6),
        "delay": NetFaultPlan([LinkRule(link="r0:data", direction="both", delay_s=0.02)],
                              seed=7),
        "reorder": NetFaultPlan([LinkRule(link="r0:data", direction="both",
                                          dup_p=0.5, reorder_p=0.7)], seed=8),
        "throttle": NetFaultPlan([LinkRule(link="r0:data", direction="both",
                                           rate_bytes_per_s=2e6)], seed=9),
        "partition_heal": NetFaultPlan([partition("r0:data", 0.0, 0.6)], seed=10),
    }
    expect = {"drop": "dropped", "duplicate": "duplicated", "reorder": "reordered",
              "throttle": "throttled", "partition_heal": "partitioned"}
    for name, plan in cells.items():
        set_net_plan(plan)
        _rewire(rig.fleet)
        got = [np.asarray(rig.fleet.score(r), np.float64) for r in rig.requests]
        for g, c in zip(got, rig.clean):
            np.testing.assert_allclose(g, c, rtol=0, atol=1e-9, err_msg=f"cell {name}")
        if name in expect:
            assert plan.total(expect[name]) > 0, f"cell {name}: {plan.counters}"
    set_net_plan(None)
    _rewire(rig.fleet)
    assert _counter(rig.session, "serving.exchange_resends") > 0
    assert _counter(rig.session, "serving.fenced_responses", reason="stale_seq") > 0
    assert _counter(rig.session, "serving.replica_deaths") == 0


def test_dropped_connection_rejoins_silently_within_lease(rig):
    before = _counter(rig.session, "serving.replica_reconnects")
    _rewire(rig.fleet)
    got = np.asarray(rig.fleet.score(rig.requests[0]), np.float64)
    np.testing.assert_allclose(got, rig.clean[0], rtol=0, atol=1e-9)
    assert rig.fleet.replicas[0].ping(10.0).get("kind") == "pong"
    assert _counter(rig.session, "serving.replica_reconnects") > before
    assert _counter(rig.session, "serving.replica_deaths") == 0


def test_generation_fence_rejects_zombie_replica(rig):
    r0 = rig.fleet.replicas[0]
    before = _counter(rig.session, "serving.fenced_responses", reason="stale_gen")
    r0.scorer.ping(10.0, gen=r0.generation + 3)  # the child ratchets ahead
    with pytest.raises(ReplicaDeadError):
        r0.scorer.score_batch(rig.requests[0])
    assert _counter(rig.session, "serving.fenced_responses", reason="stale_gen") > before
    r0.generation += 3
    r0.scorer.generation = r0.generation
    got = np.asarray(r0.scorer.score_batch(rig.requests[0]), np.float64)
    np.testing.assert_allclose(got, rig.clean[0], rtol=0, atol=1e-9)


def test_partition_heals_within_lease_without_false_death(rig):
    sup = ReplicaSupervisor(rig.fleet, SupervisorPolicy(
        probe_interval_s=10.0, probe_deadline_s=0.3, hang_timeout_s=1e9, lease_s=30.0,
        respawn_base_s=0.0, respawn_jitter=0.0), telemetry=rig.session)
    sup.check_once()  # healthy pass: the lease is established
    misses0 = _counter(rig.session, "serving.lease_probe_misses")
    set_net_plan(NetFaultPlan([partition("r0:*", 0.0, 0.6)], seed=21))
    _rewire(rig.fleet)
    sup.check_once()  # the ping waits probe_deadline_s, then misses
    assert rig.fleet.replicas[0].alive, "declared dead inside the lease"
    assert _counter(rig.session, "serving.lease_probe_misses") > misses0
    time.sleep(0.45)  # the partition closes (0.3 s already spent)
    sup.check_once()  # renewal through the healed link
    assert rig.fleet.replicas[0].alive
    assert _counter(rig.session, "serving.replica_deaths") == 0
    assert _counter(rig.session, "serving.replica_resurrections") == 0
    set_net_plan(None)
    _rewire(rig.fleet)
    got = np.asarray(rig.fleet.score(rig.requests[1]), np.float64)
    np.testing.assert_allclose(got, rig.clean[1], rtol=0, atol=1e-9)


def test_skewed_child_clock_measured_and_spans_deskewed(rig):
    r0 = rig.fleet.replicas[0]
    plan = NetFaultPlan([LinkRule(link="r0:*", direction="recv", skew_s=30.0)], seed=11)
    set_net_plan(plan)
    _rewire(rig.fleet)
    for _ in range(15):  # the EWMA converges onto the injected skew
        r0.ping(10.0)
    assert plan.total("skewed") >= 15
    assert 25.0 < r0.scorer.clock_offset_s < 35.0
    collected = []
    r0.span_sink = collected.extend
    try:
        req = build_requests(rig.data, rig.model, [4])[0]
        attach_trace(req, TraceContext(new_trace_id(), "aaaa0001", True))
        r0.scorer.score_batch(req)
        spans = collected + r0.pull_spans(10.0)
    finally:
        r0.span_sink = None
    assert spans, "traced request produced no child spans"
    now = time.time()
    for span in spans:
        assert abs(float(span["start"]) - now) < 15.0, span["start"]
    set_net_plan(None)
    _rewire(rig.fleet)


def test_shift_span_times_shifts_starts_and_events_only():
    spans = [{"start": 130.0, "duration_s": 0.5, "name": "score",
              "events": [{"t": 130.2, "name": "batch"}]}]
    shifted = shift_span_times(spans, 30.0)
    assert shifted[0]["start"] == pytest.approx(100.0)
    assert shifted[0]["events"][0]["t"] == pytest.approx(100.2)
    assert shifted[0]["duration_s"] == 0.5
    assert shift_span_times(spans, 0.0) is spans


# -- lease expiry ----------------------------------------------------------------

def test_partition_past_lease_declares_death_with_cause_lease():
    model, data = _fixture(seed=5)
    session = TelemetrySession("netfault-lease")
    fleet = _subprocess_fleet(model, data, session)
    clock = types.SimpleNamespace(t=1000.0)
    try:
        sup = ReplicaSupervisor(fleet, SupervisorPolicy(
            probe_interval_s=10.0, probe_deadline_s=0.3, hang_timeout_s=1e9, lease_s=5.0,
            resurrect=False), telemetry=session, clock=lambda: clock.t)
        r0 = fleet.replicas[0]
        sup.check_once()
        set_net_plan(NetFaultPlan([partition("r0:*", 0.0, None)], seed=1))
        _rewire(fleet)
        clock.t += 1.0
        sup.check_once()
        assert r0.alive, "declared dead inside the lease window"
        assert _counter(session, "serving.lease_probe_misses", replica="r0") >= 1
        clock.t += 10.0  # past the 5 s lease
        sup.check_once()
        assert not r0.alive, "lease expiry did not declare"
        assert _counter(session, "serving.replica_deaths", cause="lease") == 1
        assert _counter(session, "serving.replica_resurrections") == 0
        assert r0.poll_exit() is not None  # the declared child was reaped
    finally:
        set_net_plan(None)
        fleet.close()


# -- zero-downtime rebuild --------------------------------------------------------

def test_rollout_with_rebuild_crosses_capacity_boundary():
    model, data = _fixture(seed=3)
    session = TelemetrySession("netfault-rebuild")
    with ServingFleet(model, replicas=2, device="cpu",
                      request_spec=request_spec_for_dataset(model, data), max_batch=16,
                      max_delay_s=0.001, telemetry=session,
                      table_capacity_factor=1).warmup() as fleet:
        requests = build_requests(data, model, [4, 9, 2])
        for r in requests:
            fleet.score(r)
        grown = _grown(model)
        assert fleet.rollout_with_rebuild(grown, probe_requests=requests[:2])
        for r in requests:
            got = np.asarray(fleet.score(r), np.float64)
            assert np.abs(got - host_score_request(grown, r)).max() < 1e-3
        current, version = fleet.current_model()
        assert current is grown
        assert _counter(session, "serving.fleet_rebuilds") == 1
        assert _counter(session, "serving.replica_rebuilds") == 2
        assert fleet.rollout_with_rebuild(grown) is False  # fits now: in place
        assert _counter(session, "serving.fleet_rebuilds") == 1
        assert fleet.current_model()[1] > version


def test_rebuild_canary_failure_restores_fleet():
    model, data = _fixture(seed=3)
    session = TelemetrySession("netfault-canary")
    with ServingFleet(model, replicas=2, device="cpu",
                      request_spec=request_spec_for_dataset(model, data), max_batch=16,
                      max_delay_s=0.001, telemetry=session,
                      table_capacity_factor=1).warmup() as fleet:
        requests = build_requests(data, model, [4, 9, 2])
        clean = [np.asarray(fleet.score(r), np.float64) for r in requests]
        with pytest.raises(ReplicaRebuildError):
            fleet.rebuild(_grown(model), parity_tol=-1.0, probe_requests=requests[:2])
        assert fleet.current_model()[0] is model
        for r, c in zip(requests, clean):
            np.testing.assert_allclose(np.asarray(fleet.score(r), np.float64), c,
                                       rtol=0, atol=1e-9)
        assert all(r.alive for r in fleet.replicas)
        assert _counter(session, "serving.fleet_rebuilds") == 0


def test_capacity_refusal_detector_matches_both_refusal_sites():
    from photon_tpu_torch.serving.transport import TransportError

    refusals = (
        RuntimeError("grown vocabulary requires a new GameScorer"),
        ValueError("capacity growth is a layout-shape change — rebuild "
                   "the scorer instead of hot-swapping"),
        TransportError("remote control failed: ValueError: capacity growth is a "
                       "layout-shape change — rebuild the scorer instead of hot-swapping"),
    )
    for exc in refusals:
        assert is_capacity_refusal(exc)
    wrapped = RuntimeError("swap failed")
    wrapped.__cause__ = refusals[0]
    assert is_capacity_refusal(wrapped)
    assert not is_capacity_refusal(RuntimeError("unrelated failure"))


def test_subprocess_rebuild_replaces_child_under_live_traffic():
    model, data = _fixture(seed=7)
    session = TelemetrySession("netfault-subproc-rebuild")
    fleet = _subprocess_fleet(model, data, session, table_capacity_factor=1)
    try:
        requests = build_requests(data, model, [4, 9, 2, 7])
        for r in requests:
            fleet.score(r)
        grown = _grown(model)
        old_pid = fleet.replicas[0].child_pid
        old_gen = fleet.replicas[0].generation
        errors, stop = [], threading.Event()

        def client():
            while not stop.is_set():
                try:
                    fleet.score(requests[0])
                except Exception as e:  # noqa: BLE001 — audited below
                    errors.append(e)
                time.sleep(0.02)

        t = threading.Thread(target=client)
        t.start()
        try:
            rebuilt = fleet.rollout_with_rebuild(grown, probe_requests=requests[:2])
        finally:
            stop.set()
            t.join()
        assert rebuilt
        assert not errors, f"live traffic failed during rebuild: {errors}"
        assert fleet.replicas[0].child_pid != old_pid
        assert fleet.replicas[0].generation == old_gen + 1
        for r in requests:
            got = np.asarray(fleet.score(r), np.float64)
            assert np.abs(got - host_score_request(grown, r)).max() < 1e-3
        assert fleet.replicas[0].ping(10.0).get("gen") == fleet.replicas[0].generation
        assert fleet.replicas[0].child_report()["captures_at_warmup"] == 2
    finally:
        fleet.close()
