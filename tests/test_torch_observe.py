"""The fleet observability plane against the JAX package, on the CPU.

Mirrors the 19 tests of ``tests/test_observe.py``.  The cross-package cases
feed the same inputs, made from a seed with numpy, through both packages and
compare what comes out: the trace context on the wire, the sampler's
decisions, merged histograms, the SLO monitor's alerts, clears, gauges and
``export()`` under one fake clock, ``critical_path`` for one set of spans,
``fleet_snapshot()``, ``render_snapshot`` and the Prometheus text for one
event stream, and a flight dump written by one package and collected by the
other.  The fleet cases run the port's thread fleet on ``device="cpu"``: a
reconciled trace, a shed trace, a kill's merged reroute trace, the
per-bucket admission histograms, the admission guard, the traced rollout
with and without an ambient trace, the HTTP plane with the console, and the
report section.  One subprocess-fleet test with one child covers the
three-process trace and the SIGKILL flight dump.
"""

import json
import os
import signal
import time
import types

import numpy as np
import pytest

from photon_tpu.data.synthetic import make_game_dataset as ref_dataset
from photon_tpu.serving import observe as ref_observe
from photon_tpu.serving import transport as ref_transport
from photon_tpu.telemetry import TelemetrySession as RefTelemetrySession
from photon_tpu.telemetry import distributed as ref_dist
from photon_tpu.telemetry import live as ref_live
from photon_tpu_torch.fault.injection import FaultPlan, set_plan
from photon_tpu_torch.game.data import DenseShard, GameDataset
from photon_tpu_torch.game.model import game_model_from_numpy
from photon_tpu_torch.online.service import OnlineLearningService
from photon_tpu_torch.serving import (
    AsyncScoringClient,
    FleetObserver,
    ObservePolicy,
    RequestShedError,
    ServingFleet,
    Slo,
    SloMonitor,
    SupervisorPolicy,
    build_requests,
    host_score_request,
    request_spec_for_dataset,
)
from photon_tpu_torch.serving import observe
from photon_tpu_torch.serving import transport
from photon_tpu_torch.telemetry import TelemetrySession
from photon_tpu_torch.telemetry import distributed as dist
from photon_tpu_torch.telemetry import live
from photon_tpu_torch.telemetry.distributed import (
    FlightRecorder,
    MergeableHistogram,
    SpanRecord,
    TraceContext,
    TraceSampler,
    activate_trace,
    attach_trace,
    current_trace,
    new_trace_id,
    trace_of,
)

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


def _observed_fleet(model, data, session, replicas=2, **kwargs):
    fleet = ServingFleet(
        model, replicas=replicas, device="cpu",
        request_spec=request_spec_for_dataset(model, data),
        max_batch=16, max_delay_s=0.001, telemetry=session, **kwargs,
    ).warmup()
    return fleet, fleet.observe(start=False)


def _trace_with_span(collector, name):
    for tid in reversed(collector.trace_ids()):
        if any(d.get("name") == name for d in collector.trace(tid)):
            return tid
    return None


def _no_t(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


class _FakeTime:
    """A stand-in for a module's ``time``: both packages' observers read
    the same clocks, so their snapshots are comparable value for value."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    @staticmethod
    def strftime(fmt, *args):
        return "12:00:00"


# -- wire + primitives ----------------------------------------------------------

def test_trace_context_rides_the_wire_between_packages():
    model, data, _ = _fixture(5)
    (req,) = build_requests(data, model, [3])
    ctx = TraceContext(new_trace_id(), "abcd1234", True)
    attach_trace(req, ctx)
    payload = transport.pack_request(req, seq=7)
    for unpack, trace in ((transport.unpack_request_ex, trace_of),
                          (ref_transport.unpack_request_ex, ref_dist.trace_of)):
        got, _, seq = unpack(payload)
        assert seq == 7
        got_ctx = trace(got)
        assert (got_ctx.trace_id, got_ctx.span_id) == (ctx.trace_id, ctx.span_id)
    # The port reads the reference's traced frame, and an untraced request
    # stays untraced across the wire.
    ref_req, _, _ = ref_transport.unpack_request_ex(payload)
    back, _, _ = transport.unpack_request_ex(ref_transport.pack_request(ref_req, seq=7))
    assert trace_of(back).trace_id == ctx.trace_id
    (bare,) = build_requests(data, model, [3])
    got2, _, _ = transport.unpack_request_ex(transport.pack_request(bare))
    assert trace_of(got2) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_decisions_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for rate in [0.0, 0.25, 1.0] + list(rng.uniform(0.0, 1.0, 4)):
        ours, theirs = TraceSampler(rate), ref_dist.TraceSampler(rate)
        picks = [ours.should_sample() for _ in range(200)]
        assert picks == [theirs.should_sample() for _ in range(200)]
    sampler = TraceSampler(0.25)
    picks = [sampler.should_sample() for _ in range(100)]
    assert picks[0] is True and sum(picks) == 26


def test_mergeable_histogram_merges_as_the_reference():
    rng = np.random.default_rng(3)
    snaps, ref_snaps = [], []
    for _ in range(3):
        values = rng.lognormal(-5.0, 1.5, 50)
        ours, theirs = MergeableHistogram(), ref_dist.MergeableHistogram()
        for v in values:
            ours.observe(float(v))
            theirs.observe(float(v))
        assert ours.snapshot() == theirs.snapshot()
        snaps.append(ours.snapshot())
        ref_snaps.append(theirs.snapshot())
    merged = MergeableHistogram.merged(snaps)
    ref_merged = ref_dist.MergeableHistogram.merged(ref_snaps)
    assert merged.count == ref_merged.count == 150
    for q in (0.5, 0.9, 0.99):
        assert merged.quantile(q) == ref_merged.quantile(q)
    assert merged.mean == ref_merged.mean


def test_flight_recorder_ring_bounded_and_dump_roundtrip(tmp_path):
    ring = FlightRecorder("r0", capacity=4)
    for i in range(10):
        ring.record("event", i=i)
    snap = ring.snapshot()
    assert len(snap["records"]) == 4 and snap["records_total"] == 10
    assert [r["i"] for r in snap["records"]] == [6, 7, 8, 9]
    path = str(tmp_path / "r0.flight.json")
    ring.dump(path)
    for load in (FlightRecorder.load, ref_dist.FlightRecorder.load):
        loaded = load(path)
        assert loaded["owner"] == "r0"
        assert [r["i"] for r in loaded["records"]] == [6, 7, 8, 9]
    assert FlightRecorder.load(str(tmp_path / "missing.json")) is None


# -- SLO burn rates -------------------------------------------------------------

def _slo_stream(seed, n=600):
    """(dt, kind, value) events: healthy traffic, a latency cliff, sheds,
    recovery, and parity probes, in seeded order."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        phase = (i // 100) % 3
        if rng.uniform() < 0.1:
            out.append((float(rng.uniform(0.01, 0.2)), "parity",
                        float(rng.choice([1e-6, 5e-3]))))
            continue
        if phase == 1:
            status, lat = "ok", float(rng.uniform(0.2, 0.6))
        elif phase == 2 and rng.uniform() < 0.5:
            status, lat = "shed", None
        else:
            status, lat = "ok", float(rng.uniform(0.001, 0.05))
        out.append((float(rng.uniform(0.01, 0.3)), status, lat))
    return out


def _drive_slo(monitor_cls, session, stream):
    clock = types.SimpleNamespace(t=1000.0)
    slos_mod = observe if monitor_cls is SloMonitor else ref_observe
    slos = [slos_mod.Slo("p99_latency", "latency", objective=0.1, budget=0.01,
                         fast_window_s=5.0, slow_window_s=60.0),
            slos_mod.Slo("shed_fraction", "shed_fraction", objective=0.0,
                         budget=0.05, fast_burn=2.0, slow_burn=1.0),
            slos_mod.Slo("canary_parity", "parity", objective=1e-3, budget=0.01)]
    monitor = monitor_cls(slos, telemetry=session, clock=lambda: clock.t)
    seen = []
    monitor.subscribe(seen.append)
    fired = []
    for i, (dt, kind, value) in enumerate(stream):
        if kind == "parity":
            monitor.observe_parity(value)
        else:
            monitor.observe_request(kind, value)
        clock.t += dt
        if i % 10 == 9:
            fired.append(_no_t(monitor.evaluate()))
    export = monitor.export()
    export["alerts"] = _no_t(export["alerts"])
    return fired, _no_t(seen), export


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_alerts_clears_and_export_equal_the_reference(seed):
    stream = _slo_stream(seed)
    ours_session, ref_session = TelemetrySession("slo"), RefTelemetrySession("slo")
    ours = _drive_slo(SloMonitor, ours_session, stream)
    theirs = _drive_slo(ref_observe.SloMonitor, ref_session, stream)
    assert ours == theirs
    fired, seen, export = ours
    assert sum(len(f) for f in fired) >= 2  # the cliff and the sheds both alert
    assert any(e.get("cleared") for e in seen)
    assert {s["name"] for s in export["slos"]} == {
        "p99_latency", "shed_fraction", "canary_parity"}
    assert (ours_session.registry.to_prometheus()
            == ref_session.registry.to_prometheus())


def test_slo_multiwindow_burn_alerts_once_and_notifies():
    clock = types.SimpleNamespace(t=1000.0)
    session = TelemetrySession("test-slo")
    monitor = SloMonitor(
        [Slo("p99_latency", "latency", objective=0.1, budget=0.01,
             fast_window_s=5.0, slow_window_s=60.0, fast_burn=14.0, slow_burn=2.0)],
        telemetry=session, clock=lambda: clock.t,
    )
    seen = []
    monitor.subscribe(seen.append)
    for _ in range(50):
        monitor.observe_request("ok", 0.01)
        clock.t += 0.05
    assert monitor.evaluate() == []
    for _ in range(50):
        monitor.observe_request("ok", 0.5)
        clock.t += 0.05
    fired = monitor.evaluate()
    assert len(fired) == 1 and fired[0]["slo"] == "p99_latency"
    assert monitor.evaluate() == []
    assert seen == fired
    gauges = {(m["labels"]["slo"], m["labels"]["window"]): m["value"]
              for m in session.registry.snapshot()["gauges"]
              if m["name"] == "slo.burn_rate"}
    assert gauges[("p99_latency", "fast")] >= 14.0
    for _ in range(200):
        monitor.observe_request("ok", 0.01)
        clock.t += 0.5
    assert monitor.evaluate() == []
    for _ in range(50):
        monitor.observe_request("ok", 0.5)
        clock.t += 0.05
    assert len(monitor.evaluate()) == 1


def test_slo_shed_fraction_kind_counts_sheds():
    clock = types.SimpleNamespace(t=0.0)
    monitor = SloMonitor([Slo("shed_fraction", "shed_fraction", objective=0.0,
                              budget=0.05, fast_burn=2.0, slow_burn=1.0)],
                         clock=lambda: clock.t)
    for i in range(40):
        monitor.observe_request("shed" if i % 2 else "ok", 0.01)
        clock.t += 0.1
    monitor.evaluate()
    state = monitor.export()["slos"][0]
    assert state["alerting"]
    assert state["fast_burn"] == pytest.approx(10.0, rel=0.3)


# -- critical path, live snapshot, console: the same numbers ---------------------

def _span_set(seed):
    """One request's spans: a client root, a router span with the request
    events, and a child hop with compute events, at seeded times."""
    rng = np.random.default_rng(seed)
    tid = new_trace_id()
    t0 = 1.7e9 + float(rng.uniform(0, 100))
    gaps = rng.uniform(1e-4, 5e-3, 8).cumsum()
    client = {"trace_id": tid, "span_id": "c0", "parent_id": None,
              "name": "client.request", "process": "client:1", "start": t0,
              "duration_s": float(gaps[7] + 1e-3), "status": "ok", "events": []}
    router = {"trace_id": tid, "span_id": "r0", "parent_id": "c0",
              "name": "serving.request", "process": "router:2",
              "start": t0 + 1e-4, "duration_s": float(gaps[7] - gaps[0]),
              "status": "ok",
              "events": [{"name": n, "t": t0 + 1e-4 + float(g - gaps[0])}
                         for n, g in zip(("enqueue", "admit", "dispatch",
                                          "batch_close", "score_begin"), gaps[:5])]
              + [{"name": "score_end", "t": t0 + 1e-4 + float(gaps[6] - gaps[0])}],
              "attrs": {"version": 0}}
    child_start = router["events"][4]["t"] + float(rng.uniform(1e-5, 1e-4))
    child = {"trace_id": tid, "span_id": "k0", "parent_id": "r0",
             "name": "replica.score", "process": "replica-r0:3",
             "start": child_start, "duration_s": float(gaps[6] - gaps[4]) * 0.8,
             "status": "ok",
             "events": [{"name": "compute_begin", "t": child_start + 1e-5},
                        {"name": "compute_end",
                         "t": child_start + float(gaps[6] - gaps[4]) * 0.6}]}
    return tid, [client, router, child]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_critical_path_equals_the_reference(seed):
    tid, spans = _span_set(seed)
    ours, theirs = dist.TraceCollector(), ref_dist.TraceCollector()
    assert ours.merge_remote(spans) == theirs.merge_remote(spans) == 3
    cp = ours.critical_path(tid)
    assert cp == theirs.critical_path(tid)
    assert cp["stage_sum_s"] == pytest.approx(cp["total_s"], abs=1e-6)
    assert [s["stage"] for s in cp["stages"]] == list(dist.STAGES)
    assert ours.tree(tid) == theirs.tree(tid)


def _feed_observer(obs, rng, clock):
    for _ in range(60):
        clock.t += float(rng.uniform(0.001, 0.05))
        if rng.uniform() < 0.15:
            obs.on_shed("overload", int(rng.integers(1, 16)))
        else:
            obs.on_done("ok", float(rng.uniform(0.001, 0.2)),
                        int(rng.integers(1, 16)), f"r{int(rng.integers(0, 2))}",
                        version=int(rng.integers(0, 2)))
    obs._child_hists["r0"] = {"counts": [0] * 10 + [3, 5, 2] + [0] * 28,
                              "count": 10, "sum": 0.05}


def test_fleet_snapshot_console_and_prometheus_equal_the_reference(monkeypatch):
    clock = _FakeTime()
    for mod in (observe, ref_observe, live, ref_live):
        monkeypatch.setattr(mod, "time", clock)
    ours_session, ref_session = TelemetrySession("snap"), RefTelemetrySession("snap")
    policy = dict(window_s=30.0)
    ours = FleetObserver(telemetry=ours_session, policy=ObservePolicy(**policy))
    theirs = ref_observe.FleetObserver(telemetry=ref_session,
                                       policy=ref_observe.ObservePolicy(**policy))
    start = clock.t
    _feed_observer(ours, np.random.default_rng(7), clock)
    clock.t = start
    _feed_observer(theirs, np.random.default_rng(7), clock)
    snap = ours.fleet_snapshot()
    ref_snap = theirs.fleet_snapshot()
    assert json.dumps(snap, sort_keys=True) == json.dumps(ref_snap, sort_keys=True)
    assert set(snap["versions"]) == {"0", "1", "None"}
    assert snap["child_compute"]["count"] == 10
    text = live.render_snapshot(snap)
    assert text == ref_live.render_snapshot(ref_snap)
    assert "fleet @ 12:00:00" in text and "child compute" in text
    assert ours_session.registry.to_prometheus() == ref_session.registry.to_prometheus()
    assert "slo_burn_rate" in ours_session.registry.to_prometheus()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_flight_dump_crosses_between_packages(tmp_path, writer):
    """A victim's ring written by one package is collected by the other's
    observer: the dump file, the adopted lost stub and the metadata are
    the same whichever way it goes."""
    tid = new_trace_id()
    dists = {"port": dist, "reference": ref_dist}
    w = dists[writer]
    ring = w.FlightRecorder("replica-r9:4242", capacity=16)
    ring.note_frame("in", "score", 128)
    orphan = w.SpanRecord(tid, "replica.score", "replica-r9:4242",
                          parent_id="root0")
    ring.note_span(orphan, "open")
    done = w.SpanRecord(tid, "replica.score", "replica-r9:4242", parent_id="root0")
    ring.note_span(done, "open")
    ring.note_span(done.finish(), "close")
    flight_path = str(tmp_path / "r9.flight.json")
    ring.dump(flight_path)
    victim = types.SimpleNamespace(replica_id="r9", generation=2,
                                   flight_path=flight_path)
    dumps = {}
    for name, obs_mod, session in (("port", observe, TelemetrySession("f")),
                                   ("reference", ref_observe, RefTelemetrySession("f"))):
        out = tmp_path / name
        obs = obs_mod.FleetObserver(telemetry=session, flight_dir=str(out))
        path = obs.collect_flight(victim, "crash")
        assert os.path.basename(path) == "flight-r9-g2-crash.json"
        with open(path) as f:
            dump = json.load(f)
        dump.pop("collected_at")
        (lost,) = obs.collector.trace(tid)
        assert lost["status"] == "lost" and lost["span_id"] == orphan.span_id
        assert lost["attrs"]["lost_reason"] == "crash"
        meta = dict(obs.flight_dumps[0])
        meta.pop("collected_at")
        meta.pop("path")
        dumps[name] = (dump, lost, meta)
    assert dumps["port"] == dumps["reference"]
    assert dumps["port"][2]["lost_spans_recovered"] == 1


# -- traced serving -------------------------------------------------------------

def test_traced_request_critical_path_reconciles_with_latency():
    model, data, _ = _fixture(7)
    session = TelemetrySession("test-trace")
    fleet, observer = _observed_fleet(model, data, session, replicas=1)
    with fleet:
        (req,) = build_requests(data, model, [4])
        t0 = time.monotonic()
        got = fleet.score(req, deadline_s=30.0)
        wall = time.monotonic() - t0
        np.testing.assert_allclose(got, host_score_request(model, req),
                                   rtol=0, atol=SCORE_TOL)
    tids = observer.collector.trace_ids()
    assert len(tids) == 1
    spans = observer.collector.trace(tids[0])
    (root,) = [d for d in spans if d.get("parent_id") is None]
    assert root["name"] == "serving.request" and root["status"] == "ok"
    assert {"enqueue", "admit", "dispatch", "batch_close", "score_begin",
            "score_end"} <= {e["name"] for e in root["events"]}
    assert root["attrs"]["version"] == 0
    cp = observer.collector.critical_path(tids[0])
    assert cp["stage_sum_s"] == pytest.approx(cp["total_s"], abs=1e-6)
    assert cp["total_s"] <= wall + 0.05
    assert [s["stage"] for s in cp["stages"]] == list(dist.STAGES)
    snap = observer.fleet_snapshot()
    assert snap["versions"]["0"]["requests"] == 1
    assert snap["versions"]["0"]["p99_s"] is not None


def test_shed_request_trace_carries_shed_decision_event():
    model, data, _ = _fixture(11)
    session = TelemetrySession("test-shed-trace")
    fleet, observer = _observed_fleet(model, data, session, replicas=1)
    with fleet:
        (req,) = build_requests(data, model, [4])
        fleet.score(req, deadline_s=30.0)
        with pytest.raises(RequestShedError):
            fleet.submit(req, deadline_s=0.0)
    shed_spans = [d for tid in observer.collector.trace_ids()
                  for d in observer.collector.trace(tid) if d.get("status") == "shed"]
    assert len(shed_spans) == 1
    (shed_event,) = [e for e in shed_spans[0]["events"] if e["name"] == "shed"]
    assert shed_event["reason"] == "deadline"
    snap = observer.fleet_snapshot()
    assert sum(v["requests"] for v in snap["versions"].values()) == 2
    assert any(v["shed_rate"] > 0 for v in snap["versions"].values())


def test_replica_kill_yields_single_merged_trace_with_reroute():
    model, data, _ = _fixture(13)
    session = TelemetrySession("test-kill-trace")
    fleet, observer = _observed_fleet(model, data, session, replicas=2)
    with fleet:
        requests = build_requests(data, model, [4] * 10)
        set_plan(FaultPlan.parse("serve:replica_kill:replica=r0:times=1"))
        futures = [fleet.submit(r) for r in requests]
        results = [f.result(timeout=60) for f in futures]
        set_plan(None)
        assert len(results) == len(requests)
    rerouted = [tid for tid in observer.collector.trace_ids()
                if any(e["name"] == "reroute"
                       for d in observer.collector.trace(tid)
                       for e in d.get("events", ()))]
    assert rerouted
    for tid in rerouted:
        spans = observer.collector.trace(tid)
        roots = [d for d in spans if d.get("parent_id") is None]
        assert len(roots) == 1 and roots[0]["status"] == "ok"
        assert all(d.get("duration_s") is not None for d in spans)
        (reroute_event,) = [e for e in roots[0]["events"] if e["name"] == "reroute"]
        assert reroute_event["from_replica"] == "r0"


def test_per_bucket_admission_error_histograms():
    model, data, _ = _fixture(17)
    session = TelemetrySession("test-bucket-hist")
    fleet, _ = _observed_fleet(model, data, session, replicas=1)
    with fleet:
        for req in build_requests(data, model, [1, 3, 9, 16]):
            fleet.score(req, deadline_s=30.0)
    hists = {tuple(sorted((m.get("labels") or {}).items())): m
             for m in session.registry.snapshot()["histograms"]
             if m["name"] == "serving.admission_error_s"}
    buckets = {dict(labels).get("bucket") for labels in hists if dict(labels).get("bucket")}
    assert len(buckets) >= 2
    assert () in hists
    assert sum(m["count"] for labels, m in hists.items() if labels) \
        == hists[()]["count"] >= 3


# -- subprocess fleet: 3-process traces + flight recorder --------------------------

def test_subprocess_trace_spans_three_processes_and_flight_dump(tmp_path):
    model, data, _ = _fixture(19)
    session = TelemetrySession("test-subprocess-trace")
    fleet = ServingFleet(
        model, replicas=1, backend="subprocess", device="cpu",
        request_spec=request_spec_for_dataset(model, data),
        max_batch=16, max_delay_s=0.05, telemetry=session,
    ).warmup()
    observer = fleet.observe(start=False, flight_dir=str(tmp_path))
    try:
        server = fleet.serve()
        (req,) = build_requests(data, model, [4])
        client = AsyncScoringClient(server.address, connections=1,
                                    telemetry=session, observer=observer)
        try:
            got = client.submit(req).result(timeout=60)
        finally:
            client.close()
        np.testing.assert_allclose(got, host_score_request(model, req),
                                   rtol=0, atol=SCORE_TOL)
        observer.poll_once()
        tid = _trace_with_span(observer.collector, "client.request")
        assert tid is not None
        spans = observer.collector.trace(tid)
        assert {"client.request", "serving.request", "replica.score"} \
            <= {d["name"] for d in spans}
        processes = observer.collector.processes(tid)
        assert len(processes) >= 3
        child_pids = {p.rsplit(":", 1)[-1] for p in processes if p.startswith("replica-")}
        assert child_pids and str(os.getpid()) not in child_pids
        (child,) = [d for d in spans if d["name"] == "replica.score"]
        assert {"ingress", "compute_begin", "compute_end", "egress"} \
            <= {e["name"] for e in child["events"]}
        assert child["attrs"]["version"] == 0
        cp = observer.collector.critical_path(tid)
        assert cp["stage_sum_s"] == pytest.approx(cp["total_s"], abs=1e-6)
        assert {s["stage"]: s["duration_s"] for s in cp["stages"]}["compute"] > 0.0
        assert observer.collector.tree(tid)["name"] == "client.request"

        # A burst coalesces into one batch: only the first traced request's
        # context rides the wire, and the batch's child hop is shared into
        # every other trace of it, so each still spans three processes.
        burst = build_requests(data, model, [3, 3, 3, 3], start=4)
        client = AsyncScoringClient(server.address, connections=1,
                                    telemetry=session, observer=observer)
        try:
            futures = [client.submit(r) for r in burst]
            for fut, r in zip(futures, burst):
                np.testing.assert_allclose(fut.result(timeout=60),
                                           host_score_request(model, r),
                                           rtol=0, atol=SCORE_TOL)
        finally:
            client.close()
        (coalesced,) = [h for h in session.registry.snapshot()["histograms"]
                        if h["name"] == "serving.coalesced"]
        assert coalesced["max"] > 1
        tids = [t for t in observer.collector.trace_ids()
                if any(d["name"] == "client.request" for d in observer.collector.trace(t))]
        assert len(tids) == 5
        shared = 0
        for t in tids:
            assert len(observer.collector.processes(t)) >= 3
            hops = [d for d in observer.collector.trace(t) if d["name"] == "replica.score"]
            assert len(hops) == 1
            shared += "shared_from" in hops[0]["attrs"]
            cp = observer.collector.critical_path(t)
            assert cp["stage_sum_s"] == pytest.approx(cp["total_s"], abs=1e-6)
        assert shared >= coalesced["max"] - 1

        # The crash: SIGKILL the child; the supervisor collects its ring.
        sup = fleet.supervise(SupervisorPolicy(probe_interval_s=0.05,
                                               probe_deadline_s=30.0,
                                               resurrect=False), start=False)
        r0 = fleet.replicas[0]
        os.kill(r0.child_pid, signal.SIGKILL)
        deadline = time.monotonic() + 60.0
        while r0.alive and time.monotonic() < deadline:
            sup.check_once()
            time.sleep(0.05)
        assert not r0.alive
        assert observer.flight_dumps, "the death produced no flight dump"
        meta = observer.flight_dumps[0]
        assert meta["replica"] == "r0"
        assert meta["path"] and os.path.exists(meta["path"])
        with open(meta["path"]) as f:
            dump = json.load(f)
        assert dump["cause"] and dump["cause"] == meta["cause"]
        assert {"frame", "span"} <= {r["kind"] for r in dump["child"]["records"]}
        assert dump["parent"] is not None
        # The reference's loader reads the port child's ring.
        assert ref_dist.FlightRecorder.load(r0.flight_path)["records"] \
            == dump["child"]["records"]
    finally:
        fleet.close()


def test_collect_flight_adopts_unshipped_spans_as_lost(tmp_path):
    observer = FleetObserver(telemetry=TelemetrySession("test-lost"),
                             flight_dir=str(tmp_path))
    tid = new_trace_id()
    root = SpanRecord(tid, "serving.request", "router:1")
    root.finish()
    observer.collector.add(root)
    ring = FlightRecorder("r9")
    orphan = SpanRecord(tid, "replica.score", "replica-r9:4242", parent_id=root.span_id)
    ring.note_span(orphan, "open")
    flight_path = str(tmp_path / "r9.flight.json")
    ring.dump(flight_path)
    victim = types.SimpleNamespace(replica_id="r9", generation=2, flight_path=flight_path)
    path = observer.collect_flight(victim, "crash")
    assert path and os.path.exists(path)
    spans = observer.collector.trace(tid)
    assert len(spans) == 2
    (lost,) = [d for d in spans if d["name"] == "replica.score"]
    assert lost["status"] == "lost" and lost["attrs"]["lost_reason"] == "crash"
    assert observer.flight_dumps[0]["lost_spans_recovered"] == 1
    observer.collect_flight(victim, "crash")
    assert len(observer.collector.trace(tid)) == 2


# -- live metrics plane -----------------------------------------------------------

def test_http_metrics_plane_and_live_console(capsys):
    import urllib.request

    model, data, _ = _fixture(23)
    session = TelemetrySession("test-http-plane")
    fleet = ServingFleet(model, replicas=1, device="cpu",
                         request_spec=request_spec_for_dataset(model, data),
                         max_batch=16, max_delay_s=0.001, telemetry=session).warmup()
    observer = fleet.observe(policy=ObservePolicy(http_port=0, poll_interval_s=0.05))
    with fleet:
        for req in build_requests(data, model, [2, 5]):
            fleet.score(req, deadline_s=30.0)
        host, port = observer.http_address
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            prom = r.read().decode()
        assert "serving_requests" in prom
        with urllib.request.urlopen(f"{base}/fleet.json", timeout=10) as r:
            snap = json.loads(r.read().decode())
        assert snap["versions"]["0"]["requests"] == 2
        assert "slo" in snap
        assert live.main(["--url", base, "--once"]) == 0
        out = capsys.readouterr().out
        assert "fleet @" in out and "qps" in out
        # The reference's console renders the port's endpoint too.
        assert ref_live.main(["--url", base, "--once"]) == 0
        assert "qps" in capsys.readouterr().out
    assert observer.http_address is None


# -- linked publish trace + report --------------------------------------------------

def test_rollout_under_ambient_trace_links_publish_and_probes():
    model, data, arrays = _fixture(29)
    retrained = _retrained(arrays, 31)
    session = TelemetrySession("test-publish-trace")
    fleet, observer = _observed_fleet(model, data, session, replicas=2)
    with fleet:
        for req in build_requests(data, model, [4, 4]):
            fleet.score(req, deadline_s=30.0)
        svc = types.SimpleNamespace(
            fleet=fleet, telemetry=session,
            policy=types.SimpleNamespace(rollout_parity_tol=1e-3))
        OnlineLearningService._publish(svc, retrained)
        (req,) = build_requests(data, model, [4])
        fleet.score(req, deadline_s=30.0)
    tid = _trace_with_span(observer.collector, "online.publish")
    assert tid is not None
    spans = observer.collector.trace(tid)
    (publish,) = [d for d in spans if d["name"] == "online.publish"]
    (rollout,) = [d for d in spans if d["name"] == "serving.rollout"]
    assert publish["parent_id"] is None
    assert rollout["parent_id"] == publish["span_id"]
    assert publish["status"] == "ok" and rollout["status"] == "ok"
    phases = [e["name"] for e in rollout["events"]]
    assert "canary" in phases and "promoted" in phases
    probe_roots = [d for d in spans if d["name"] == "serving.request"]
    assert probe_roots
    assert all(d["parent_id"] == rollout["span_id"] for d in probe_roots)
    v1 = [d for t in observer.collector.trace_ids() for d in observer.collector.trace(t)
          if d["name"] == "serving.request"
          and (d.get("attrs") or {}).get("version") == 1]
    assert v1


def test_rollout_without_ambient_trace_still_traced():
    model, data, arrays = _fixture(37)
    retrained = _retrained(arrays, 41)
    session = TelemetrySession("test-rollout-trace")
    fleet, observer = _observed_fleet(model, data, session, replicas=2)
    with fleet:
        for req in build_requests(data, model, [4, 4]):
            fleet.score(req, deadline_s=30.0)
        fleet.rollout(retrained)
    tid = _trace_with_span(observer.collector, "serving.rollout")
    assert tid is not None
    (rollout,) = [d for d in observer.collector.trace(tid)
                  if d["name"] == "serving.rollout"]
    assert rollout["parent_id"] is None


def test_ambient_trace_context_manager_restores():
    assert current_trace() is None
    ctx = TraceContext(new_trace_id(), "feed1234", True)
    with activate_trace(ctx):
        assert current_trace() is ctx
        inner = TraceContext(new_trace_id(), "beef5678", True)
        with activate_trace(inner):
            assert current_trace() is inner
        assert current_trace() is ctx
    assert current_trace() is None


def test_report_renders_fleet_traces_slos_section():
    from photon_tpu.telemetry.report import render_markdown as ref_render
    from photon_tpu_torch.telemetry.report import render_markdown

    model, data, _ = _fixture(43)
    session = TelemetrySession("test-observe-report")
    fleet, observer = _observed_fleet(model, data, session, replicas=1)
    with fleet:
        for req in build_requests(data, model, [4, 8]):
            fleet.score(req, deadline_s=30.0)
        with pytest.raises(RequestShedError):
            fleet.submit(req, deadline_s=0.0)
    observer.flight_dumps.append({
        "replica": "r0", "cause": "crash", "path": None, "generation": 1,
        "child_records": 7, "lost_spans_recovered": 1, "collected_at": time.time(),
    })
    report = session.build_report(extra={"observe": observer.export()})
    text = render_markdown(report)
    assert "## Fleet traces / SLOs" in text
    assert "queue (s)" in text and "compute (s)" in text
    assert "p99_latency" in text and "shed_fraction" in text
    assert "### Flight dumps" in text and "lost span(s)" in text
    # The reference renders the same section from the port's payload.
    section = text[text.index("## Fleet traces / SLOs"):]
    ref_text = ref_render(report)
    assert ref_text[ref_text.index("## Fleet traces / SLOs"):].split("\n## ")[0] \
        == section.split("\n## ")[0]
    assert "Fleet traces" not in render_markdown(session.build_report())


# -- SLO-driven admission guard -------------------------------------------------------

def test_admission_guard_tightens_on_alert_and_relaxes_on_clear():
    clock = types.SimpleNamespace(t=0.0)
    session = TelemetrySession("test-guard")
    model, data, _ = _fixture(7)
    fleet, observer = _observed_fleet(model, data, session, replicas=1)
    try:
        monitor = SloMonitor(
            [Slo("p99_latency", "latency", objective=0.1, budget=0.01,
                 fast_window_s=5.0, slow_window_s=60.0, fast_burn=14.0, slow_burn=2.0)],
            telemetry=session, clock=lambda: clock.t,
        )
        observer.slo_monitor = monitor
        observer.attach_admission_guard(fleet.router, tighten=8.0)
        assert fleet.router.burn_safety == 1.0
        for _ in range(50):
            monitor.observe_request("ok", 0.5)
            clock.t += 0.05
        monitor.evaluate()
        assert fleet.router.burn_safety == 8.0
        assert _counter_total(session, "serving.admission_tightened") == 1
        monitor.evaluate()
        assert _counter_total(session, "serving.admission_tightened") == 1
        for _ in range(200):
            monitor.observe_request("ok", 0.01)
            clock.t += 0.5
        monitor.evaluate()
        assert fleet.router.burn_safety == 1.0
        assert _counter_total(session, "serving.admission_relaxed") == 1
    finally:
        fleet.close()


def test_admission_guard_shed_rises_under_alert_and_recovers():
    model, data, _ = _fixture(7)
    session = TelemetrySession("test-guard-shed")
    fleet, _ = _observed_fleet(model, data, session, replicas=1)
    try:
        reqs = build_requests(data, model, [3, 5, 8])
        for r in reqs:
            fleet.score(r)
        shed0 = _counter_total(session, "serving.shed", reason="overload")
        fleet.router.burn_safety = 1e9
        with pytest.raises(RequestShedError):
            fleet.score(reqs[0], deadline_s=0.25)
        assert _counter_total(session, "serving.shed", reason="overload") > shed0
        fleet.router.burn_safety = 1.0
        got = fleet.score(reqs[0], deadline_s=0.25)
        np.testing.assert_allclose(got, host_score_request(model, reqs[0]),
                                   rtol=0, atol=SCORE_TOL)
    finally:
        fleet.close()


def test_policy_admission_guard_wires_at_observe():
    """``ObservePolicy(admission_guard=True)`` wires the guard when the
    fleet is observed; a second ``observe()`` refuses."""
    model, data, _ = _fixture(47)
    session = TelemetrySession("test-guard-policy")
    fleet = ServingFleet(model, replicas=1, device="cpu",
                         request_spec=request_spec_for_dataset(model, data),
                         max_batch=16, max_delay_s=0.001, telemetry=session).warmup()
    with fleet:
        observer = fleet.observe(policy=ObservePolicy(admission_guard=True,
                                                      admission_tighten=3.0),
                                 start=False)
        assert fleet.router.observer is observer
        with pytest.raises(RuntimeError, match="already observed"):
            fleet.observe(start=False)
        observer.slo_monitor._subscribers[0]({"slo": "p99_latency"})
        assert fleet.router.burn_safety == 3.0
