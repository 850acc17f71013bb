"""Fleet observability plane: tracing, live metrics, SLO burn rates, dumps.

A copy of ``photon_tpu/serving/observe.py``.

The fleet-facing half of the observability layer (the wire-level half is
:mod:`photon_tpu_torch.telemetry.distributed`).  One :class:`FleetObserver`
attaches to a :class:`~photon_tpu_torch.serving.fleet.ServingFleet` and owns:

- **Request tracing** — it decides sampling, originates the root span the
  router stamps admit/shed/dispatch/score events onto, and is the merge
  point (:class:`~photon_tpu_torch.telemetry.distributed.TraceCollector`) where
  child-replica spans shipped back over the data/control connections land
  as one cross-process trace tree per request.
- **The live metrics plane** — a sliding window of per-request outcomes
  (status, latency, rows, replica, model version) aggregated into
  fleet-level QPS/p50/p99/shed-rate per model version, merged with the
  children's shipped histogram snapshots, exposed via a stdlib-HTTP
  Prometheus endpoint (``/metrics``) and a JSON snapshot (``/fleet.json``
  — what ``python -m photon_tpu_torch.telemetry.live`` renders), replacing
  "wait for run_report.json" with during-run visibility.
- **SLO burn-rate monitoring** — declarative :class:`Slo` objectives
  (p99 latency, shed fraction, canary parity) evaluated over fast/slow
  sliding windows; an alert fires only when BOTH windows burn error
  budget past their thresholds (the multiwindow rule: the fast window
  catches the cliff, the slow window filters the blip).  Observe-only by
  default — alerts land in telemetry and in subscriber callbacks; nothing
  here touches dispatch.
- **Flight-recorder collection** — on a replica death/quarantine the
  supervisor hands the victim here; the observer persists the child's
  on-disk flight ring (written by the child BEFORE each traced batch, so
  a SIGKILL still leaves its final seconds) plus the parent-side event
  ring next to the run report, and adopts any unfinished child spans as
  terminal "lost" stubs so the trace stays whole (no orphan hops).

Residency contract (``tools/check_host_sync.py`` guards this module): the
observability plane is pure host-side bookkeeping over plain dicts — it
must never read device data (an observer that syncs would BE the latency
it exists to measure).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

from photon_tpu_torch.telemetry.distributed import (
    FlightRecorder,
    MergeableHistogram,
    SpanRecord,
    TraceCollector,
    TraceContext,
    TraceSampler,
    attach_span,
    attach_trace,
    current_trace,
    new_trace_id,
    span_of,
    trace_of,
)

__all__ = [
    "ObservePolicy",
    "Slo",
    "SloMonitor",
    "FleetObserver",
    "MetricsPlane",
]


@dataclasses.dataclass(frozen=True)
class ObservePolicy:
    """Observer knobs.

    ``sample_rate`` — fraction of requests traced (deterministic — see
    :class:`~photon_tpu_torch.telemetry.distributed.TraceSampler`); 1.0 traces
    everything (tests), a production fleet runs 0.01–0.1.
    ``trace_capacity`` — most-recent traces kept in the collector.
    ``flight_capacity`` — ring size of the per-replica flight recorders.
    ``window_s`` — the live plane's sliding window (QPS/p50/p99 horizon).
    ``poll_interval_s`` — child span/snapshot pull cadence.
    ``http_port`` — bind the live HTTP plane here (None = no server;
    0 = ephemeral port, read it back from ``observer.http_address``).
    ``admission_guard`` — close the SLO→admission loop: while any burn alert is
    active, the router's overload projection is multiplied by
    ``admission_tighten`` (sheds start earlier, queues drain); when
    every alert clears, admission relaxes back to 1.0.  Opt-in: the
    guard actuates the serving path, so attaching it is a deliberate
    control-loop decision, not a side effect of observing."""

    sample_rate: float = 1.0
    trace_capacity: int = 512
    flight_capacity: int = 128
    window_s: float = 30.0
    poll_interval_s: float = 0.5
    http_port: Optional[int] = None
    http_host: str = "127.0.0.1"
    admission_guard: bool = False
    admission_tighten: float = 4.0


@dataclasses.dataclass(frozen=True)
class Slo:
    """One declarative objective evaluated over sliding windows.

    ``kind`` picks the bad-event predicate: ``latency`` (a request slower
    than ``objective`` seconds is bad), ``shed_fraction`` (a shed request
    is bad; ``objective`` is unused for the predicate), ``parity`` (a
    probe whose worst disagreement exceeds ``objective`` is bad).
    ``budget`` is the allowed bad fraction; burn rate = bad_fraction /
    budget, so burn 1.0 spends budget exactly on schedule.  An alert
    fires when the FAST window burns past ``fast_burn`` AND the SLOW
    window past ``slow_burn`` — the standard multiwindow rule."""

    name: str
    kind: str  # "latency" | "shed_fraction" | "parity"
    objective: float
    budget: float = 0.01
    fast_window_s: float = 5.0
    slow_window_s: float = 60.0
    fast_burn: float = 14.0
    slow_burn: float = 2.0


DEFAULT_SLOS = (
    Slo("p99_latency", "latency", objective=1.0, budget=0.01),
    Slo("shed_fraction", "shed_fraction", objective=0.0, budget=0.05),
    Slo("canary_parity", "parity", objective=1e-3, budget=0.01),
)


class SloMonitor:
    """Sliding-window burn-rate evaluation over declarative SLOs.

    ``observe_request``/``observe_parity`` feed events; ``evaluate()``
    computes per-window burn rates, records them as telemetry gauges
    (``slo.burn_rate{slo,window}``), counts alerts (``slo.alerts{slo}``),
    and notifies subscribers.  Observe-only: subscribers decide what to do
    (the canary gate may refuse a promotion; the default is nothing)."""

    def __init__(self, slos: Sequence[Slo] = DEFAULT_SLOS, telemetry=None,
                 clock: Callable[[], float] = time.monotonic):
        from photon_tpu_torch.telemetry import NULL_SESSION

        self.slos = list(slos)
        self.telemetry = telemetry or NULL_SESSION
        self.clock = clock
        self._lock = threading.Lock()
        # Per slo: deque of (t, bad) trimmed to the slow window.
        self._events = {slo.name: deque() for slo in self.slos}
        self._subscribers: List[Callable] = []
        self.alerts: List[dict] = []
        self._alerting: set = set()  # slo names currently in alert

    def subscribe(self, callback: Callable[[dict], None]) -> None:
        self._subscribers.append(callback)

    # -- feeds ---------------------------------------------------------------
    def observe_request(self, status: str, latency_s: Optional[float]) -> None:
        now = self.clock()
        with self._lock:
            for slo in self.slos:
                if slo.kind == "latency":
                    if status == "ok" and latency_s is not None:
                        self._events[slo.name].append(
                            (now, latency_s > slo.objective)
                        )
                elif slo.kind == "shed_fraction":
                    self._events[slo.name].append((now, status == "shed"))

    def observe_parity(self, worst: float) -> None:
        now = self.clock()
        with self._lock:
            for slo in self.slos:
                if slo.kind == "parity":
                    self._events[slo.name].append((now, worst > slo.objective))

    # -- evaluation ----------------------------------------------------------
    def _burn(self, slo: Slo, events, now: float, window_s: float) -> float:
        cut = now - window_s
        bad = total = 0
        for t, is_bad in reversed(events):
            if t < cut:
                break
            total += 1
            bad += bool(is_bad)
        if total == 0:
            return 0.0
        return (bad / total) / max(slo.budget, 1e-9)

    def alerting(self) -> bool:
        """True while ANY SLO is in alert state — what a control-loop
        subscriber (the admission guard) checks before relaxing."""
        with self._lock:
            return bool(self._alerting)

    def evaluate(self) -> List[dict]:
        """One evaluation pass; returns the alerts that FIRED this pass
        (entering alert state — a continuing alert is not re-fired).
        Subscribers additionally see CLEAR transitions (an alert leaving
        alert state) as events with ``"cleared": True`` — the edge a
        control loop needs to relax whatever it tightened."""
        now = self.clock()
        fired = []
        cleared = []
        with self._lock:
            for slo in self.slos:
                events = self._events[slo.name]
                cut = now - slo.slow_window_s
                while events and events[0][0] < cut:
                    events.popleft()
                fast = self._burn(slo, events, now, slo.fast_window_s)
                slow = self._burn(slo, events, now, slo.slow_window_s)
                self.telemetry.gauge(
                    "slo.burn_rate", slo=slo.name, window="fast"
                ).set(fast)
                self.telemetry.gauge(
                    "slo.burn_rate", slo=slo.name, window="slow"
                ).set(slow)
                alerting = fast >= slo.fast_burn and slow >= slo.slow_burn
                if alerting and slo.name not in self._alerting:
                    self._alerting.add(slo.name)
                    alert = {
                        "t": time.time(), "slo": slo.name,
                        "fast_burn": fast, "slow_burn": slow,
                        "objective": slo.objective, "budget": slo.budget,
                    }
                    self.alerts.append(alert)
                    fired.append(alert)
                    self.telemetry.counter("slo.alerts", slo=slo.name).inc()
                elif not alerting and slo.name in self._alerting:
                    self._alerting.discard(slo.name)
                    cleared.append({
                        "t": time.time(), "slo": slo.name, "cleared": True,
                        "fast_burn": fast, "slow_burn": slow,
                    })
                    self.telemetry.counter(
                        "slo.alert_clears", slo=slo.name
                    ).inc()
        for event in fired + cleared:
            for cb in self._subscribers:
                try:
                    cb(event)
                except Exception:  # noqa: BLE001 — observe-only: a bad
                    # subscriber must not take down the monitor.
                    pass
        return fired

    def export(self) -> dict:
        with self._lock:
            state = []
            for slo in self.slos:
                now = self.clock()
                events = self._events[slo.name]
                state.append({
                    "name": slo.name, "kind": slo.kind,
                    "objective": slo.objective, "budget": slo.budget,
                    "fast_burn": self._burn(slo, events, now,
                                            slo.fast_window_s),
                    "slow_burn": self._burn(slo, events, now,
                                            slo.slow_window_s),
                    "alerting": slo.name in self._alerting,
                })
            return {"slos": state, "alerts": list(self.alerts)}


class FleetObserver:
    """The fleet's observability plane — see the module docstring.

    Attach with :meth:`ServingFleet.observe` (which wires the router hook,
    the child span sinks, and the supervisor feed) or construct directly
    over a bare router in tests.  ``flight_dir`` is where collected flight
    dumps persist (pass the run's output dir to land them next to the run
    report)."""

    def __init__(self, fleet=None, router=None, telemetry=None,
                 policy: Optional[ObservePolicy] = None,
                 slos: Sequence[Slo] = DEFAULT_SLOS,
                 flight_dir: Optional[str] = None):
        from photon_tpu_torch.telemetry import NULL_SESSION

        self.fleet = fleet
        self.router = router if router is not None else (
            fleet.router if fleet is not None else None
        )
        self.telemetry = telemetry or (
            fleet.telemetry if fleet is not None else None
        ) or NULL_SESSION
        self.policy = policy or ObservePolicy()
        self.process = f"router:{os.getpid()}"
        self.sampler = TraceSampler(self.policy.sample_rate)
        self.collector = TraceCollector(self.policy.trace_capacity)
        self.slo_monitor = SloMonitor(slos, telemetry=self.telemetry)
        self.flight_dir = flight_dir
        self.flight_dumps: List[dict] = []
        # Parent-side per-replica event rings: even a thread-backed replica
        # (no child process, no on-disk ring) leaves a postmortem.
        self._parent_rings: dict = {}
        self._events: deque = deque(maxlen=8192)  # live-plane window feed
        self._events_lock = threading.Lock()
        self._child_hists: dict = {}  # replica_id -> last shipped snapshot
        self._lock = threading.Lock()
        self._last_eval = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._http: Optional[MetricsPlane] = None

    # -- SLO -> admission feedback -------------------------------------------
    def attach_admission_guard(self, router, tighten: Optional[float] = None
                               ) -> None:
        """Close the loop from the SLO burn-rate monitor to the router's
        admission controller: while any multiwindow alert is live the
        router's ``burn_safety`` multiplier is raised to ``tighten``
        (projected waits look ``tighten``× worse, so the controller sheds
        earlier and protects the deadline SLO); when the last alert
        clears the multiplier relaxes back to 1.0.  Opt-in via
        ``ObservePolicy.admission_guard`` because it actuates the serving
        path rather than just observing it."""
        factor = float(tighten if tighten is not None
                       else self.policy.admission_tighten)

        def _on_slo_event(event: dict) -> None:
            if event.get("cleared"):
                # Relax only once every alert has cleared — one SLO
                # recovering while another still burns keeps the guard up.
                if self.slo_monitor.alerting():
                    return
                if router.burn_safety != 1.0:
                    router.burn_safety = 1.0
                    self.telemetry.counter("serving.admission_relaxed").inc()
            else:
                if router.burn_safety != factor:
                    router.burn_safety = factor
                    self.telemetry.counter("serving.admission_tightened").inc()

        self.slo_monitor.subscribe(_on_slo_event)

    # -- trace origination (router + client hooks) ---------------------------
    def maybe_start_span(self, request, name: str = "serving.request",
                         process: Optional[str] = None
                         ) -> Optional[SpanRecord]:
        """Root-span decision for one request: continue an attached wire
        context, else the thread's ambient trace (the refresh→rollout
        linkage), else sample a fresh trace.  Returns None when the
        request is not traced (the hot path's common case)."""
        ctx = trace_of(request)
        if ctx is None:
            ctx = current_trace()
        if ctx is None:
            if not self.sampler.should_sample():
                return None
            span = SpanRecord(new_trace_id(), name, process or self.process)
        else:
            span = SpanRecord(ctx.trace_id, name, process or self.process,
                              parent_id=ctx.span_id)
        attach_span(request, span)
        return span

    def client_span(self, request) -> Optional[SpanRecord]:
        """Client-side origination (the ``AsyncScoringClient`` hook): the
        span covers send→response on the client's clock, and its context
        rides the request frame so the server-side root span links under
        it."""
        span = self.maybe_start_span(
            request, name="client.request", process=f"client:{os.getpid()}"
        )
        if span is not None:
            attach_trace(request, span.context())
        return span

    # -- router feed ----------------------------------------------------------
    def _record_event(self, **event) -> None:
        event["t"] = time.monotonic()
        with self._events_lock:
            self._events.append(event)
        rid = event.get("replica")
        if rid:
            ring = self._parent_rings.get(rid)
            if ring is None:
                ring = self._parent_rings.setdefault(
                    rid, FlightRecorder(rid, self.policy.flight_capacity)
                )
            ring.record("request", **{
                k: v for k, v in event.items() if k != "t"
            })

    def _maybe_evaluate(self) -> None:
        """Throttled burn-rate evaluation for the per-request hooks: an
        evaluation scans the sliding windows (O(window events)), and doing
        that on EVERY request would make the observer the overhead it
        polices.  The poll thread (and ``poll_once`` in tests) evaluates
        unconditionally."""
        now = time.monotonic()
        if now - self._last_eval >= self.policy.poll_interval_s:
            self._last_eval = now
            self.slo_monitor.evaluate()

    def on_shed(self, reason: str, rows: int, span=None,
                model: Optional[str] = None) -> None:
        if span is not None:
            span.event("shed", reason=reason)
            span.finish(status="shed")
            self.collector.add(span)
        self._record_event(status="shed", reason=reason, rows=rows,
                           replica=None, version=None, latency_s=None,
                           model=model)
        self.slo_monitor.observe_request("shed", None)
        self._maybe_evaluate()

    def on_done(self, status: str, latency_s: Optional[float], rows: int,
                replica_id: Optional[str], version=None,
                model: Optional[str] = None) -> None:
        self._record_event(status=status, latency_s=latency_s, rows=rows,
                           replica=replica_id, version=version, model=model)
        self.slo_monitor.observe_request(status, latency_s)
        self._maybe_evaluate()

    # -- supervisor feed -------------------------------------------------------
    def on_parity(self, replica_id: str, worst: float) -> None:
        self.slo_monitor.observe_parity(worst)
        self._maybe_evaluate()

    def collect_flight(self, replica, cause: str) -> Optional[str]:
        """Collect + persist one dead replica's flight record: the child's
        on-disk ring (subprocess replicas — written before each traced
        batch, so it survives SIGKILL) plus the parent-side event ring.
        Unfinished child spans are adopted into the collector as terminal
        "lost" stubs — the trace that was mid-flight on the victim stays
        whole.  Returns the persisted dump path (None if persisting was
        impossible); always safe to call — never raises."""
        try:
            rid = replica.replica_id
            child = None
            child_path = getattr(replica, "flight_path", None)
            if child_path:
                child = FlightRecorder.load(child_path)
            ring = self._parent_rings.get(rid)
            dump = {
                "replica": rid,
                "generation": getattr(replica, "generation", 0),
                "cause": cause,
                "collected_at": time.time(),
                "parent": ring.snapshot() if ring is not None else None,
                "child": child,
            }
            lost = self._adopt_lost_spans(child, cause)
            dump["lost_spans_recovered"] = lost
            path = None
            if self.flight_dir:
                os.makedirs(self.flight_dir, exist_ok=True)
                path = os.path.join(
                    self.flight_dir,
                    f"flight-{rid}-g{dump['generation']}-{cause}.json",
                )
                tmp = f"{path}.tmp"
                with open(tmp, "w") as f:
                    json.dump(dump, f, default=str)
                os.replace(tmp, path)
            self.telemetry.counter(
                "observe.flight_dumps", replica=rid, cause=cause
            ).inc()
            with self._lock:
                self.flight_dumps.append({
                    "replica": rid, "cause": cause, "path": path,
                    "generation": dump["generation"],
                    "child_records": len((child or {}).get("records", ())),
                    "lost_spans_recovered": lost,
                    "collected_at": dump["collected_at"],
                })
            return path
        except Exception:  # noqa: BLE001 — postmortem collection must
            # never make a death worse.
            return None

    def _adopt_lost_spans(self, child_dump: Optional[dict],
                          cause: str) -> int:
        """Span-stream loss recovery: a child span opened on the victim but
        never shipped (the kill landed mid-batch) is adopted as a "lost"
        stub so its trace keeps the hop instead of orphaning it."""
        if not child_dump:
            return 0
        adopted = 0
        closed = set()
        opened = []
        for rec in child_dump.get("records", ()):
            if rec.get("kind") != "span":
                continue
            span = rec.get("span") or {}
            if rec.get("phase") == "close":
                closed.add(span.get("span_id"))
            elif rec.get("phase") == "open":
                opened.append(span)
        for span in opened:
            sid, tid = span.get("span_id"), span.get("trace_id")
            if not tid or sid in closed:
                continue
            have = {d.get("span_id") for d in self.collector.trace(tid)}
            if sid in have:
                continue  # it DID ship (inline with the response)
            self.collector.recover_lost(tid, span, reason=cause)
            self.telemetry.counter("observe.lost_spans_recovered").inc()
            adopted += 1
        return adopted

    # -- child polling ---------------------------------------------------------
    def poll_once(self) -> None:
        """One pull pass over the fleet's replicas: drain completed child
        spans over the control connection, pull the shipped mergeable
        histogram snapshots, and evaluate SLOs.  Advisory — any per-replica
        failure is skipped (liveness verdicts belong to the supervisor)."""
        replicas = list(self.router.replicas) if self.router else []
        for replica in replicas:
            if not getattr(replica, "alive", False):
                continue
            pull = getattr(replica, "pull_spans", None)
            if pull is not None:
                try:
                    self.collector.merge_remote(pull())
                except Exception:  # noqa: BLE001 — advisory pull
                    pass
            hist = getattr(replica.scorer, "last_hist_snapshot", None)
            if hist:
                self._child_hists[replica.replica_id] = hist
        self.slo_monitor.evaluate()

    def _run(self) -> None:
        while not self._stop.wait(self.policy.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — observation must outlive
                # a bad pass.
                pass

    def start(self) -> "FleetObserver":
        if self.policy.http_port is not None and self._http is None:
            self._http = MetricsPlane(
                self, host=self.policy.http_host,
                port=self.policy.http_port,
            )
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="photon-fleet-observer", daemon=True
            )
            self._thread.start()
        return self

    @property
    def http_address(self):
        return None if self._http is None else self._http.address

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._http is not None:
            self._http.close()
            self._http = None
        try:
            self.poll_once()  # final span drain before the fleet tears down
        except Exception:  # noqa: BLE001 — best-effort drain
            pass

    # -- the live plane --------------------------------------------------------
    def fleet_snapshot(self) -> dict:
        """Fleet-level live aggregates over the sliding window, grouped per
        model version AND per tenant model id: QPS, p50/p99 latency, shed
        rate — plus the merged child histogram (device-side compute
        seconds) and current SLO state.  The per-model grouping is what a
        multi-tenant arena's isolation claims are checked against: tenant
        A's storm shows up in A's shed rate, not B's."""
        now = time.monotonic()
        cut = now - self.policy.window_s
        with self._events_lock:
            window = [e for e in self._events if e["t"] >= cut]
        span_s = self.policy.window_s
        if window:
            span_s = min(span_s, max(now - window[0]["t"], 1e-3))

        def _aggregate(group_key: str) -> dict:
            groups: dict = {}
            for e in window:
                key = str(e.get(group_key))
                g = groups.setdefault(
                    key, {"ok": 0, "shed": 0, "error": 0, "rows": 0,
                          "latencies": []}
                )
                status = e.get("status", "ok")
                g[status if status in g else "error"] += 1
                g["rows"] += int(e.get("rows") or 0)
                if e.get("latency_s") is not None:
                    g["latencies"].append(float(e["latency_s"]))
            out = {}
            for key, g in sorted(groups.items()):
                lat = sorted(g["latencies"])

                def pct(p):
                    if not lat:
                        return None
                    return lat[min(len(lat) - 1,
                                   max(0, round(p * (len(lat) - 1))))]

                total = g["ok"] + g["shed"] + g["error"]
                out[key] = {
                    "qps": g["ok"] / span_s,
                    "rows_per_s": g["rows"] / span_s,
                    "p50_s": pct(0.50),
                    "p99_s": pct(0.99),
                    "shed_rate": g["shed"] / total if total else 0.0,
                    "error_rate": g["error"] / total if total else 0.0,
                    "requests": total,
                }
            return out

        merged_child = MergeableHistogram.merged(
            list(self._child_hists.values())
        )
        return {
            "at": time.time(),
            "window_s": span_s,
            "versions": _aggregate("version"),
            "models": _aggregate("model"),
            "child_compute": {
                "p50_s": merged_child.quantile(0.50),
                "p99_s": merged_child.quantile(0.99),
                "count": merged_child.count,
            },
            "traces": len(self.collector.trace_ids()),
            "flight_dumps": len(self.flight_dumps),
            "slo": self.slo_monitor.export(),
        }

    # -- report export ---------------------------------------------------------
    def export(self, trace_limit: int = 8) -> dict:
        """The run report's ``extra["observe"]`` payload: recent traces
        with their critical-path decompositions, SLO state, and the
        collected flight dumps — what the report renderer's "Fleet traces
        / SLOs" section draws."""
        paths = []
        for tid in self.collector.trace_ids()[-trace_limit:]:
            cp = self.collector.critical_path(tid)
            if cp is not None:
                paths.append(cp)
        with self._lock:
            dumps = list(self.flight_dumps)
        return {
            "sample_rate": self.sampler.rate,
            "spans_merged": self.collector.spans_merged,
            "traces_kept": len(self.collector.trace_ids()),
            "critical_paths": paths,
            "slo": self.slo_monitor.export(),
            "flight_dumps": dumps,
        }


class MetricsPlane:
    """Stdlib-HTTP live endpoint: ``/metrics`` is the Prometheus text
    exposition of the fleet's registry, ``/fleet.json`` the live snapshot
    the ``python -m photon_tpu_torch.telemetry.live`` console view polls.  A
    scrape is read-only and lock-bounded — it can slow nothing but
    itself."""

    def __init__(self, observer: FleetObserver, host: str = "127.0.0.1",
                 port: int = 0):
        import http.server

        outer = observer

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: D102 — silence stderr
                pass

            def do_GET(self):  # noqa: N802 — stdlib handler name
                try:
                    if self.path.startswith("/metrics"):
                        body = outer.telemetry.registry.to_prometheus()
                        ctype = "text/plain; version=0.0.4"
                    else:
                        body = json.dumps(outer.fleet_snapshot(),
                                          default=str)
                        ctype = "application/json"
                except Exception as e:  # noqa: BLE001 — a scrape error is
                    # the scraper's problem, never the fleet's.
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(str(e).encode())
                    return
                data = body.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = http.server.ThreadingHTTPServer((host, port),
                                                       _Handler)
        self.address = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="photon-metrics-plane", daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10.0)
