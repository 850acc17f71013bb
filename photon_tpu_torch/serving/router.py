"""Fleet router: replicated scorers, queue-depth dispatch, admission control.

A copy of ``photon_tpu/serving/router.py``; only the host oracle
(:func:`host_score_request`) reads torch tensors.  One scorer behind one
batcher is the serving stack; this module is the fleet tier above it (1612.01437's core finding — at scale the system
overheads *around* the math dominate — is why this layer exists at all):

- :class:`ScorerReplica` — one :class:`~photon_tpu_torch.serving.scorer.GameScorer`
  owning its own device-resident tables behind its own dedicated
  :class:`~photon_tpu_torch.serving.batcher.RequestBatcher`.  A thread
  replica's scorer owns its tables, its CUDA stream and its captured
  graphs; a subprocess replica
  (:class:`~photon_tpu_torch.serving.replica_proc.SubprocessReplica`)
  keeps the same surface over a child process.
- :class:`FleetRouter` — queue-depth-aware dispatch across the healthy
  replicas (least projected wait, from each replica's live ``pending_rows``
  and an EWMA of its measured per-row service time), deadline-aware
  ADMISSION CONTROL in front (a request whose queue-wait projection already
  blows its deadline is shed — fast-failed — instead of queued:
  ``serving.shed{reason}``), replica-death rerouting (an in-flight request
  on a dying replica re-dispatches to a healthy one, resolving its future
  exactly once — never lost, never duplicated), and the staggered/canary
  ``swap_model`` rollout (:meth:`FleetRouter.rollout`).

Residency contract: the router never touches device data — it moves REQUESTS between host queues;
the only sanctioned host fetches are in the parity oracle
(:func:`host_score_request`), which exists precisely to score on host.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional

import numpy as np
import torch

from photon_tpu_torch.fault.injection import (
    InjectedKillError,
    consume_hang_injection,
    fault_point,
)
from photon_tpu_torch.fault.watchdog import complete as retire_heartbeat
from photon_tpu_torch.fault.watchdog import heartbeat
from photon_tpu_torch.serving.batcher import DEFAULT_MAX_DELAY_S, RequestBatcher
from photon_tpu_torch.serving.scorer import GameScorer, ScoringRequest
from photon_tpu_torch.telemetry.distributed import (
    SpanRecord,
    attach_span,
    attach_trace,
    current_trace,
    new_trace_id,
)


_heartbeat_nonce = itertools.count(1)


def not_ported(what: str, item: str) -> NotImplementedError:
    """The one refusal of a fleet feature that is not ported yet: ``item``
    is its ROADMAP.md queue 1 item (7.5 the multi-model arena)."""
    return NotImplementedError(
        f"{what} is not ported yet; it waits in ROADMAP.md queue 1, "
        f"item {item}"
    )


def replica_heartbeat_site(replica_id: str) -> str:
    """A watchdog heartbeat site for one replica INSTANCE: the scoring
    path's progress marks land on it through ``replica.heartbeat_site``
    (a watchdog's hang check reads it).  The process-wide nonce keeps two fleets
    in one process (both naming replicas ``r0``…) from cross-talking each
    other's hang detection through a shared site name."""
    return f"serving.replica.{replica_id}#{next(_heartbeat_nonce)}"


class RequestShedError(RuntimeError):
    """A request fast-failed by admission control (never queued, never
    scored).  ``reason`` is the shed bucket: ``deadline`` (already past
    its deadline at arrival), ``overload`` (queue-wait projection blows
    the deadline), ``queue_full`` (hard per-replica depth cap),
    ``no_replica`` (every replica dead), or ``closed`` (the router is
    shutting down)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or f"request shed ({reason})")
        self.reason = reason


class ReplicaDeadError(RuntimeError):
    """A replica's scoring path died (injected ``serve:replica_kill`` or a
    real device failure); the router reroutes its in-flight work."""


class NoHealthyReplicaError(RuntimeError):
    """Every replica is dead; nothing can serve this request."""


class RolloutParityError(RuntimeError):
    """The canary's mirrored-traffic parity probe disagreed with the new
    model's host oracle; the rollout was aborted and the canary rolled
    back to the previous model."""


def parity_worst(got, want) -> float:
    """Worst absolute disagreement between served scores and the host
    oracle — the ONE comparison the rollout canary gate and the rebuild
    canary both use.
    Deliberately paranoid: a shape mismatch or any non-finite value in
    the served answer is infinite disagreement (``np.abs(nan) > tol`` is
    False — a NaN-serving canary/replica must FAIL the gate, not slide
    through it and get promoted fleet-wide)."""
    # host-sync: probe-oracle comparison — host arrays both sides (the
    # served response vs the host-scored answer).
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if got.size and not np.all(np.isfinite(got)):
        return float("inf")
    delta = np.abs(got - want)
    return float(delta.max()) if delta.size else 0.0


def _host64(t) -> np.ndarray:
    """A model tensor (on any device) as a float64 host array."""
    return t.detach().to("cpu", torch.float64).numpy()


def host_score_request(model, request: ScoringRequest) -> np.ndarray:
    """HOST-side oracle scores for one request — pure numpy, no serving
    tables involved.  The fleet uses it two ways: the canary rollout's
    parity probe (does the canary serve the NEW model's scores?) and the
    fleet bench's per-request parity acceptance (served == host ≤ 1e-3).
    Unknown entities contribute zero margin, exactly like the serving
    zero-row fallback."""
    from photon_tpu_torch.game.data import entity_index_for
    from photon_tpu_torch.game.model import FixedEffectModel, RandomEffectModel

    n = request.num_rows
    total = np.zeros(n, np.float64)
    if request.offset is not None:
        # host-sync: parity oracle — deliberate host-side scoring.
        total += np.asarray(request.offset, np.float64)
    for coord in model.coordinates.values():
        leaf = request.features[coord.shard_name]
        if isinstance(coord, FixedEffectModel):
            # host-sync: parity oracle — the model tables are fetched to
            # host on purpose (this is the reference scoring path).
            w = _host64(coord.coefficients.means)
            if isinstance(leaf, tuple):
                ids, vals = leaf
                # host-sync: parity oracle — caller-owned request leaves.
                total += np.sum(w[np.asarray(ids)] * np.asarray(vals),
                                axis=-1)
            else:
                # host-sync: parity oracle — caller-owned request leaves.
                total += np.asarray(leaf, np.float64) @ w
        elif isinstance(coord, RandomEffectModel):
            idx = entity_index_for(
                request.entity_ids[coord.entity_column], coord.keys
            )
            # host-sync: parity oracle — same deliberate host fetch.
            table = _host64(coord.table)
            safe = np.maximum(idx, 0)
            if isinstance(leaf, tuple):
                ids, vals = leaf
                # host-sync: parity oracle — caller-owned request leaves.
                m = np.sum(
                    table[safe[:, None], np.asarray(ids)] * np.asarray(vals),
                    axis=-1,
                )
            else:
                # host-sync: parity oracle — caller-owned request leaves.
                m = np.einsum(
                    "nd,nd->n", np.asarray(leaf, np.float64), table[safe]
                )
            total += np.where(idx >= 0, m, 0.0)
        else:
            raise TypeError(f"cannot score a {type(coord).__name__}")
    return total.astype(np.float32)


class _KillableScorer:
    """The replica's scoring hook: delegates to the real scorer but (1)
    declares the ``serve:replica_kill`` and ``replica:crash`` fault sites
    so CI can kill/crash a named replica's scoring path deterministically,
    (2) latches death — once a kill fired, every later batch on this
    replica raises :class:`ReplicaDeadError` (a dead replica stays dead
    until the supervisor resurrects it; the one-shot fault rule must not
    let the next batch silently succeed) — and (3) marks watchdog
    heartbeats around each batch, the progress signal the supervisor's
    hang detection reads.  An injected ``replica:hang`` WEDGES the batch
    (the thread-backed shape of a hung runtime) until the replica is
    declared dead from outside or :attr:`HANG_CAP_S` passes."""

    # The wedge-simulation backstop: an unsupervised hung replica fails its
    # batch after this long instead of holding the batcher thread forever.
    HANG_CAP_S = 60.0

    def __init__(self, replica: "ScorerReplica", scorer: GameScorer):
        self._replica = replica
        self._scorer = scorer

    def __getattr__(self, name):
        return getattr(self._scorer, name)

    def _die(self, cause: str, exc: BaseException) -> None:
        self._replica.death_cause = cause
        self._replica.alive = False
        raise ReplicaDeadError(
            f"replica {self._replica.replica_id} {cause}: {exc}"
        ) from exc

    def score_batch(self, request: ScoringRequest) -> np.ndarray:
        replica = self._replica
        # ``rejoining`` lifts the dead-latch for the supervisor's rejoin
        # parity probes only: the replica is still OUT of the dispatch set
        # (alive stays False until revive), so no caller traffic can reach
        # a replica that has not passed its canary gate.
        if not replica.alive and not replica.rejoining:
            raise ReplicaDeadError(f"replica {replica.replica_id} is dead")
        heartbeat(replica.heartbeat_site)
        if consume_hang_injection(replica.replica_id):
            deadline = time.monotonic() + self.HANG_CAP_S
            while replica.alive and time.monotonic() < deadline:
                time.sleep(0.02)
            raise ReplicaDeadError(
                f"replica {replica.replica_id} wedged (injected hang)"
            )
        try:
            fault_point("serve:replica_kill", replica=replica.replica_id)
        except InjectedKillError as e:
            self._die("kill", e)
        try:
            fault_point("replica:crash", replica=replica.replica_id)
        except InjectedKillError as e:
            self._die("crash", e)
        try:
            scores = self._scorer.score_batch(request)
        except ReplicaDeadError:
            # The backend itself died mid-batch (a subprocess child's
            # connection dropped): latch it like an injected crash.
            if replica.alive:
                replica.death_cause = replica.death_cause or "crash"
                replica.alive = False
            raise
        heartbeat(replica.heartbeat_site)
        return scores


class ScorerReplica:
    """One serving replica: scorer + dedicated batcher + health/latency
    state the router dispatches on.

    Supervision surface (the fleet supervisor drives these):
    ``generation`` counts resurrections and cutovers — death accounting is
    per (replica, generation), so a replica that dies, rejoins, and dies
    again is two deaths, not one latched event; ``death_cause`` labels the
    death counter (kill/crash/hang/parity/lease/error); ``quarantined`` is
    the permanent flap verdict; :meth:`respawn` stands the serving path
    back up (re-warmed, fresh batcher) WITHOUT returning it to dispatch —
    only :meth:`FleetRouter.revive`, after the canary-gated rejoin probe,
    does that."""

    def __init__(
        self,
        replica_id: str,
        scorer: GameScorer,
        max_batch: Optional[int] = None,
        max_delay_s: float = DEFAULT_MAX_DELAY_S,
        telemetry=None,
    ):
        from photon_tpu_torch.telemetry import NULL_SESSION

        self.replica_id = replica_id
        self.scorer = scorer
        self.alive = True
        self.heartbeat_site = replica_heartbeat_site(replica_id)
        self.generation = 0
        self.death_cause: Optional[str] = None
        self.quarantined = False
        # True between respawn and revive: the supervisor's rejoin probes
        # may score, the router still never dispatches (alive is False).
        self.rejoining = False
        self._max_batch = max_batch
        self._max_delay_s = max_delay_s
        self.telemetry = telemetry or scorer.telemetry or NULL_SESSION
        self.batcher = self._new_batcher()
        # EWMA seconds-per-PADDED-row through this replica (queue wait
        # included), the router's projection basis.  None until the first
        # completion: a cold replica admits optimistically.
        self.row_seconds: Optional[float] = None
        self.requests_served = 0
        self.depth_peak = 0

    def pending_rows(self) -> int:
        return self.batcher.pending_rows()

    def pending_padded_rows(self) -> int:
        return self.batcher.pending_padded_rows()

    def padded_rows(self, n: int) -> int:
        """``n`` request rows at their padded bucket-ladder cost (what the
        projection charges — padded rows cost compute too)."""
        try:
            return self.scorer.padded_rows(n)
        except Exception:
            return int(n)

    def projected_wait_s(self, extra_rows: int) -> float:
        """Projected time for a new ``extra_rows``-row request to clear
        this replica: live PADDED queue depth × measured per-padded-row
        pace (bucket padding folded in — a raw-rows projection under-
        estimates the wait and over-admits near saturation)."""
        if self.row_seconds is None:
            return 0.0
        return (
            self.pending_padded_rows() + self.padded_rows(extra_rows)
        ) * self.row_seconds

    def submit(self, request: ScoringRequest) -> Future:
        try:
            return self.batcher.submit(request)
        except RuntimeError:
            # A background-rebuild cutover can swap the batcher between
            # our read and the enqueue; the fresh batcher takes the
            # request — retry once instead of surfacing a phantom death.
            return self.batcher.submit(request)

    def cutover_to(self, scorer) -> None:
        """Zero-downtime serving-path cutover: swap in a
        replacement scorer and a fresh batcher so NEW submissions flow to
        the replacement immediately, then drain the old batcher — its
        ``_KillableScorer`` holds the OLD scorer reference, so everything
        already queued completes against the old backend.  Nothing is
        shed, nothing is lost; the router's generation bump
        (:meth:`FleetRouter.cutover`) fences any answer the retired
        backend produces after this point."""
        old_batcher = self.batcher
        self.scorer = scorer
        self.batcher = self._new_batcher()
        old_batcher.close()

    def _new_batcher(self) -> RequestBatcher:
        """A batcher over the current scorer, behind the kill/heartbeat
        hook."""
        return RequestBatcher(
            _KillableScorer(self, self.scorer),
            max_batch=self._max_batch,
            max_delay_s=self._max_delay_s,
            telemetry=self.telemetry,
        )

    # -- supervision ---------------------------------------------------------
    def poll_exit(self) -> Optional[int]:
        """Exit code of the replica's backing process, or None while it
        runs.  Thread-backed replicas have no backing process — always
        None; the subprocess replica overrides this with the child's
        ``Popen.poll()``."""
        return None

    def abandon_pending(self, exc: BaseException) -> None:
        """Fail everything queued on (and in flight through) this replica
        so the router's done-callbacks reroute it — the supervisor's
        teardown step when it declares a replica dead."""
        self.batcher.abandon(exc)

    def abandon_for_respawn(self) -> None:
        """First step of every respawn: fail whatever the dead batcher
        still held (the router reroutes it exactly once)."""
        self.batcher.abandon(
            ReplicaDeadError(f"replica {self.replica_id} is being respawned")
        )

    def attach_fresh_batcher(self) -> None:
        """Last step of every respawn: a fresh batcher over the (re)stood
        scorer, and ``rejoining`` lifted so ONLY the supervisor's rejoin
        probes can score — shared by the thread and subprocess respawn
        paths so their rebuild semantics cannot drift."""
        self.batcher = self._new_batcher()
        self.rejoining = True

    def respawn(self, model=None) -> None:
        """Stand the dead serving path back up: abandon whatever the old
        batcher still held, sync the scorer to ``model`` (the fleet's
        CURRENT model — a replica resurrected mid-rollout must come back
        on the model the fleet serves now, never the one it died on),
        re-warm the bucket ladder, and attach a fresh batcher.  For a
        thread-backed replica the runtime survived the "crash", so the
        re-warm finds every bucket's program already captured — nothing
        captures again; the subprocess replica overrides this with a real
        child respawn.  The replica stays OUT of the dispatch set until
        ``router.revive()`` after the rejoin parity probe."""
        fault_point("replica:spawn", replica=self.replica_id)
        self.abandon_for_respawn()
        if model is not None and model is not self.scorer.model:
            self.scorer.swap_model(model)
        self.scorer.warmup()
        self.attach_fresh_batcher()

    def close(self) -> None:
        retire_heartbeat(self.heartbeat_site)
        self.batcher.close()


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Admission-control knobs.

    ``max_queue_rows`` — hard per-replica depth cap (rows); a request that
    would push the least-loaded replica past it sheds ``queue_full``.
    ``tenant_queue_rows`` — the per-tenant budget of the multi-model
    arena; not ported, anything but None raises.
    ``default_deadline_s`` — deadline budget applied to requests submitted
    without one (None = no deadline, never shed on time).
    ``safety`` — multiplier on the queue-wait projection before comparing
    against the deadline (projection error margin).
    ``ewma_alpha`` — smoothing of the per-row service-time estimate."""

    max_queue_rows: Optional[int] = None
    tenant_queue_rows: Optional[int] = None
    default_deadline_s: Optional[float] = None
    safety: float = 1.0
    ewma_alpha: float = 0.25

    def __post_init__(self):
        if self.tenant_queue_rows is not None:
            raise not_ported("the per-tenant admission budget "
                             "(tenant_queue_rows)", "7.5")


class _Entry:
    __slots__ = ("request", "future", "rows", "deadline_at", "attempts",
                 "dispatched_at", "pending_before", "padded",
                 "padded_before", "projected_wait", "span", "admitted_at")

    def __init__(self, request: ScoringRequest, deadline_at: Optional[float]):
        self.request = request
        self.future: Future = Future()
        self.rows = request.num_rows
        self.deadline_at = deadline_at
        self.attempts = 0
        self.dispatched_at = 0.0
        self.pending_before = 0
        self.padded = 0
        self.padded_before = 0
        self.projected_wait: Optional[float] = None
        # Distributed-trace root span (sampled requests only) + the
        # admission timestamp its end-to-end latency is measured from.
        self.span = None
        self.admitted_at = 0.0


class FleetRouter:
    """Queue-depth-aware dispatch + deadline admission over N replicas.

    ``submit(request, deadline_s=...)`` either returns a future (admitted;
    it resolves to the scores or to the replica failure after rerouting is
    exhausted) or raises :class:`RequestShedError` synchronously — the
    fast-fail contract: a shed request costs the caller one projection, not
    a queue slot.  ``deadline_s`` is a RELATIVE budget (seconds from
    submit); the router converts it to an absolute deadline once at
    admission.
    """

    def __init__(
        self,
        replicas: List[ScorerReplica],
        telemetry=None,
        admission: Optional[AdmissionPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        from photon_tpu_torch.telemetry import NULL_SESSION

        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.replicas = list(replicas)
        self.telemetry = telemetry or NULL_SESSION
        self.admission = admission or AdmissionPolicy()
        self.clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        # Recent admitted requests, mirrored to the canary as the rollout
        # parity probe's traffic sample.
        self._mirror: deque = deque(maxlen=8)
        # Optional FleetObserver (set by ServingFleet.observe or directly):
        # when present, sampled requests get a root span that admit/shed/
        # dispatch/reroute events land on, and every outcome feeds the
        # live-metrics window + SLO monitor.  None costs one attribute read
        # per request — the untraced hot path stays untraced.
        self.observer = None
        # SLO-driven admission tightening: the observer's burn-rate guard
        # raises this above 1.0 while an SLO budget is burning — the
        # overload projection pads out, sheds start earlier, queues drain
        # — and relaxes it back to 1.0 when the alert clears.  Mutable
        # attribute (AdmissionPolicy is frozen) so the control loop can
        # actuate without republishing policy.
        self.burn_safety = 1.0
        self._rollout_seq = itertools.count(1)
        # Death accounting is per (replica, generation): a rebuilt
        # replica's NEXT death is a new event, not a latched repeat.
        self._dead_keys: set = set()
        self._closed = False

    # -- admission + dispatch ------------------------------------------------
    def healthy_replicas(self) -> List[ScorerReplica]:
        return [r for r in self.replicas if r.alive]

    def _shed(self, reason: str, detail: str = "", span=None,
              rows: int = 0) -> None:
        self.telemetry.counter("serving.shed", reason=reason).inc()
        if self.observer is not None:
            self.observer.on_shed(reason, rows, span=span)
        raise RequestShedError(reason, detail)

    def submit(self, request: ScoringRequest,
               deadline_s: Optional[float] = None) -> Future:
        now = self.clock()
        if self._closed:
            self._shed("closed", "router is closed")
        span = (self.observer.maybe_start_span(request)
                if self.observer is not None else None)
        rows = request.num_rows
        if span is not None:
            span.event("enqueue", rows=rows)
        budget = (
            deadline_s if deadline_s is not None
            else self.admission.default_deadline_s
        )
        deadline_at = None if budget is None else now + float(budget)
        healthy = self.healthy_replicas()
        if not healthy:
            self._shed("no_replica", "every replica is dead",
                       span=span, rows=rows)
        replica = min(
            healthy, key=lambda r: (r.projected_wait_s(rows), r.pending_rows())
        )
        cap = self.admission.max_queue_rows
        if cap is not None and replica.pending_rows() + rows > cap:
            self._shed(
                "queue_full",
                f"least-loaded replica {replica.replica_id} is at "
                f"{replica.pending_rows()} of {cap} queued rows",
                span=span, rows=rows,
            )
        if deadline_at is not None:
            if now >= deadline_at:
                self._shed("deadline", "deadline already expired at arrival",
                           span=span, rows=rows)
            wait = (replica.projected_wait_s(rows)
                    * self.admission.safety * self.burn_safety)
            if now + wait > deadline_at:
                self._shed(
                    "overload",
                    f"projected queue wait {wait * 1e3:.1f} ms blows the "
                    f"{(deadline_at - now) * 1e3:.1f} ms deadline budget",
                    span=span, rows=rows,
                )
        entry = _Entry(request, deadline_at)
        entry.span = span
        entry.admitted_at = now
        if span is not None:
            span.event("admit", replica=replica.replica_id)
        self.telemetry.counter("serving.admitted").inc()
        self._mirror.append(request)
        self._dispatch(entry, replica)
        return entry.future

    def _dispatch(self, entry: _Entry, replica: ScorerReplica) -> None:
        entry.attempts += 1
        entry.pending_before = replica.pending_rows()
        entry.padded = replica.padded_rows(entry.rows)
        entry.padded_before = replica.pending_padded_rows()
        entry.projected_wait = (
            None if replica.row_seconds is None
            else replica.projected_wait_s(entry.rows)
        )
        entry.dispatched_at = self.clock()
        t = self.telemetry
        t.counter("serving.replica_requests", replica=replica.replica_id).inc()
        t.counter("serving.replica_rows", replica=replica.replica_id).inc(
            entry.rows
        )
        depth = entry.pending_before + entry.rows
        if depth > replica.depth_peak:
            replica.depth_peak = depth
            t.gauge(
                "serving.replica_depth", replica=replica.replica_id
            ).set(depth)
        if entry.span is not None:
            entry.span.event("dispatch", replica=replica.replica_id,
                             attempt=entry.attempts)
        try:
            fut = replica.submit(entry.request)
        except BaseException as e:  # batcher closed / replica torn down
            if self._closed:
                # Shutdown race: a handler thread admitted this request
                # before close() landed and hit the closing batcher.  The
                # fleet is shutting down, not losing replicas — shed the
                # request instead of recording phantom deaths/reroutes.
                self.telemetry.counter("serving.shed", reason="closed").inc()
                if self.observer is not None:
                    self.observer.on_shed("closed", entry.rows,
                                          span=entry.span)
                    entry.span = None
                entry.future.set_exception(
                    RequestShedError("closed", "router closed mid-dispatch")
                )
                return
            self._replica_failed(entry, replica, e)
            return
        fut.add_done_callback(
            lambda f, e=entry, r=replica: self._on_done(e, r, f)
        )

    def _served_version(self, replica: ScorerReplica):
        version = getattr(replica.scorer, "version", None)
        if version is None:
            version = getattr(replica, "served_version", None)
        return version

    def _on_done(self, entry: _Entry, replica: ScorerReplica,
                 fut: Future) -> None:
        exc = fut.exception()
        if exc is None:
            now = self.clock()
            replica.requests_served += 1
            # Per-PADDED-row pace sample: this request's submit->resolve
            # time over the padded rows that were ahead of (and in) it — a
            # Little's-law-ish estimate that tracks the replica's live
            # drain rate in the unit the device actually pays (padding
            # included), matching the projection's cost unit.
            observed = now - entry.dispatched_at
            sample = observed / max(1, entry.padded_before + entry.padded)
            alpha = self.admission.ewma_alpha
            replica.row_seconds = (
                sample if replica.row_seconds is None
                else (1 - alpha) * replica.row_seconds + alpha * sample
            )
            if entry.projected_wait is not None:
                # The over/under-shedding premium, measurable: how far the
                # admission projection was from this request's real wait.
                self.telemetry.histogram("serving.admission_error_s").observe(
                    observed - entry.projected_wait
                )
                # Per-bucket twin: projection error is a function of where
                # the request lands on the bucket ladder (padding distorts
                # small requests most) — the evidence base for a future
                # per-bucket service model.
                try:
                    bucket = replica.scorer.bucket_for(entry.rows)
                except Exception:  # a scorer stub without a ladder
                    bucket = None
                if bucket is not None:
                    self.telemetry.histogram(
                        "serving.admission_error_s", bucket=bucket
                    ).observe(observed - entry.projected_wait)
            if entry.deadline_at is not None and now > entry.deadline_at:
                self.telemetry.counter("serving.deadline_missed").inc()
                self.telemetry.histogram("serving.deadline_overrun_s").observe(
                    now - entry.deadline_at
                )
            version = self._served_version(replica)
            if entry.span is not None:
                entry.span.attrs["rows"] = entry.rows
                entry.span.attrs["replica"] = replica.replica_id
                if version is not None:
                    entry.span.attrs["version"] = version
                entry.span.finish()
                if self.observer is not None:
                    self.observer.collector.add(entry.span)
            if self.observer is not None:
                self.observer.on_done(
                    "ok", now - entry.admitted_at, entry.rows,
                    replica.replica_id, version=version,
                )
            entry.future.set_result(fut.result())
            return
        if isinstance(exc, ReplicaDeadError):
            self._replica_failed(entry, replica, exc)
            return
        self._finish_entry_span(entry, replica, status="error")
        entry.future.set_exception(exc)

    def _finish_entry_span(self, entry: _Entry, replica: ScorerReplica,
                           status: str) -> None:
        if entry.span is not None:
            entry.span.finish(status=status)
            if self.observer is not None:
                self.observer.collector.add(entry.span)
        if self.observer is not None:
            self.observer.on_done(
                status, self.clock() - entry.admitted_at, entry.rows,
                replica.replica_id, version=self._served_version(replica),
            )

    def _replica_failed(self, entry: _Entry, replica: ScorerReplica,
                        exc: BaseException) -> None:
        """Mark the replica dead (once) and reroute the in-flight request.
        The entry's future resolves exactly once — with the rerouted scores
        or, when no replica is left, with the failure — so a replica death
        can neither lose nor duplicate a response."""
        self._mark_dead(replica, exc)
        self.telemetry.counter(
            "serving.rerouted", replica=replica.replica_id
        ).inc()
        if entry.span is not None:
            entry.span.event("reroute", from_replica=replica.replica_id,
                             cause=str(exc)[:200])
        healthy = self.healthy_replicas()
        if healthy and entry.attempts < len(self.replicas) + 1:
            target = min(
                healthy,
                key=lambda r: (r.projected_wait_s(entry.rows),
                               r.pending_rows()),
            )
            self._dispatch(entry, target)
            return
        self._finish_entry_span(entry, replica, status="error")
        entry.future.set_exception(
            NoHealthyReplicaError(
                f"request could not be rerouted after replica "
                f"{replica.replica_id} died: {exc}"
            )
        )

    def _mark_dead(self, replica: ScorerReplica, exc: BaseException,
                   cause: Optional[str] = None) -> None:
        with self._lock:
            key = (replica.replica_id, replica.generation)
            first = key not in self._dead_keys
            self._dead_keys.add(key)
            replica.alive = False
            if cause and not replica.death_cause:
                replica.death_cause = cause
        if first:
            self.telemetry.counter(
                "serving.replica_deaths", replica=replica.replica_id,
                cause=replica.death_cause or cause or "error",
            ).inc()
            retire_heartbeat(replica.heartbeat_site)

    def mark_unhealthy(self, replica: ScorerReplica, cause: str,
                       detail: str = "") -> None:
        """Declare a replica dead (a failed health probe — hang, crash,
        parity, lease — or a failed rebuild or rollback swap).  Death
        accounting + heartbeat retire; the caller tears down in-flight
        work via ``replica.abandon_pending`` so the router reroutes it."""
        self._mark_dead(
            replica,
            RuntimeError(
                detail or f"replica {replica.replica_id} unhealthy ({cause})"
            ),
            cause=cause,
        )

    def revive(self, replica: ScorerReplica) -> None:
        """Return a resurrected replica to the dispatch set.  The
        supervisor calls this ONLY after the canary-gated rejoin parity
        probe passed — resurrection is gated exactly like a rollout canary.
        The generation bump re-arms death accounting; the pace EWMA resets
        so the rejoined replica admits optimistically like a cold one."""
        with self._lock:
            replica.generation += 1
            replica.death_cause = None
            replica.row_seconds = None
            replica.rejoining = False
            replica.alive = True
            # Sync the backend's membership stamp: frames the revived
            # replica sends from here on carry the new generation, and any
            # answer still in flight from the OLD incarnation is fenced by
            # the exchange loop's stale-generation check.
            scorer = replica.scorer
            if hasattr(scorer, "generation"):
                scorer.generation = replica.generation
        self.telemetry.counter(
            "serving.replica_resurrections", replica=replica.replica_id
        ).inc()

    def cutover(self, replica: ScorerReplica) -> None:
        """Publish a background-rebuild cutover: bump the
        replica's membership generation (fencing the retired backend —
        a zombie that keeps answering carries the old stamp) and reset
        its pace EWMA so the rebuilt backend re-measures like a cold one.
        The serving-path swap itself happened in
        :meth:`ScorerReplica.cutover_to`; this is the router-visible
        half — together they are the atomic generation-bump cutover."""
        with self._lock:
            replica.generation += 1
            replica.row_seconds = None
            scorer = replica.scorer
            if hasattr(scorer, "generation"):
                scorer.generation = replica.generation
        self.telemetry.counter(
            "serving.replica_rebuilds", replica=replica.replica_id
        ).inc()

    def recent_requests(self) -> List[ScoringRequest]:
        """The mirror of recently admitted requests — the rollout canary's,
        the rebuild canary's and the supervisor's rejoin probe's traffic
        sample."""
        return list(self._mirror)

    # -- canary rollout ------------------------------------------------------
    def _mark_rollout(self, replica_id: str, phase: str) -> None:
        """Timeline breadcrumb: a monotonic sequence number per (replica,
        phase) event — the report renderer sorts these into the rollout
        timeline."""
        self.telemetry.gauge(
            "serving.rollout_step", replica=replica_id, phase=phase
        ).set(next(self._rollout_seq))
        span = getattr(self, "_rollout_span", None)
        if span is not None:
            span.event(phase, replica=replica_id)

    def rollout(
        self,
        model,
        probe_requests: Optional[List[ScoringRequest]] = None,
        parity_tol: float = 1e-3,
        probe_oracle: Optional[Callable] = None,
        probe_timeout_s: float = 30.0,
        model_id: Optional[str] = None,
    ) -> None:
        """Staggered/canary ``swap_model`` across the fleet: ONE replica
        swaps first, a parity probe replays mirrored traffic through it
        against the new model's host oracle, and only then do the remaining
        replicas swap — so a bad artifact is caught while (n-1)/n of the
        fleet still serves the old model.  Each replica's swap is atomic
        (the scorer's one-assignment publication), so no response is ever a
        mix of two models; during the stagger, different replicas serve
        different models — each response wholly one of them.

        Probe traffic: ``probe_requests`` if given, else the router's
        mirror of recently admitted requests.  Probe responses never reach
        callers.  A parity failure rolls the canary back and raises
        :class:`RolloutParityError` — and any OTHER probe failure (a probe
        timeout, an oracle error) rolls it back the same way before
        propagating; a canary that DIES mid-probe is marked dead and the
        rollout restarts on the next healthy replica (the
        mid-rollout-kill path).

        ``model_id`` (one tenant slice of a multi-model arena) is not
        ported and raises."""
        if model_id is not None:
            raise not_ported("a per-tenant rollout (model_id=)", "7.5")
        oracle = probe_oracle or (
            lambda req: host_score_request(model, req)
        )
        probes = list(probe_requests) if probe_requests else list(self._mirror)
        if not probes:
            raise ValueError(
                "rollout has no traffic to probe the canary with: pass "
                "probe_requests or roll out under live traffic"
            )
        # One rollout = one span: the canary/probe/promote timeline becomes
        # a trace, parented under the thread's ambient context when there
        # is one (the online refresh's publish span) so refresh→canary→swap
        # reads as one linked trace.  Probe requests carry its context, so
        # subprocess canaries link their scoring hops under it too.
        rspan = None
        probe_spans = []
        if self.observer is not None:
            ctx = current_trace()
            if ctx is not None:
                rspan = SpanRecord(ctx.trace_id, "serving.rollout",
                                   self.observer.process,
                                   parent_id=ctx.span_id)
            else:
                rspan = SpanRecord(new_trace_id(), "serving.rollout",
                                   self.observer.process)
            # Probe submissions bypass admission (canary.submit goes
            # straight to the replica), so the request path never opens a
            # span for them — open one per probe here so the canary's
            # parity replay shows up as serving.request hops under the
            # rollout span instead of vanishing from the trace.
            for req in probes:
                pspan = SpanRecord(rspan.trace_id, "serving.request",
                                   self.observer.process,
                                   parent_id=rspan.span_id)
                pspan.attrs["probe"] = True
                attach_trace(req, pspan.context())
                attach_span(req, pspan)
                probe_spans.append(pspan)
        self._rollout_span = rspan
        try:
            self._run_rollout(model, oracle, probes, parity_tol,
                              probe_timeout_s)
            if rspan is not None:
                rspan.finish()
        except BaseException:
            if rspan is not None:
                rspan.finish(status="error")
            raise
        finally:
            self._rollout_span = None
            if rspan is not None:
                for pspan in probe_spans:
                    self.observer.collector.add(pspan.finish())
                self.observer.collector.add(rspan)

    def _run_rollout(self, model, oracle, probes, parity_tol,
                     probe_timeout_s) -> None:
        while True:
            healthy = self.healthy_replicas()
            if not healthy:
                raise NoHealthyReplicaError(
                    "rollout aborted: every replica is dead"
                )
            canary = healthy[0]
            self._mark_rollout(canary.replica_id, "canary")
            old_model = canary.scorer.model
            canary.scorer.swap_model(model)
            # Per-codec parity histogram: every canary probe's
            # worst |delta| lands labeled with the served storage tier, so
            # the measured bound per dtype is an observable distribution,
            # not just a pass/fail gate.
            parity_hist = self.telemetry.histogram(
                "serving.rollout_parity",
                dtype=getattr(canary.scorer, "table_dtype", "f32"),
            )
            try:
                futs = [canary.submit(req) for req in probes]
                for req, fut in zip(probes, futs):
                    got = fut.result(timeout=probe_timeout_s)
                    worst = parity_worst(got, oracle(req))
                    parity_hist.observe(worst)
                    if worst > parity_tol:
                        raise RolloutParityError(
                            f"canary {canary.replica_id} parity probe "
                            f"disagreed with the new model's host oracle "
                            f"(max |delta| {worst:.2e} > {parity_tol:g})"
                        )
            except ReplicaDeadError as e:
                # Mid-rollout kill: the canary died while probing.  It is
                # already marked dead (the scorer hook latched); restart the
                # rollout on the next healthy replica.
                self._mark_dead(canary, e)
                self._mark_rollout(canary.replica_id, "died")
                continue
            except BaseException:
                # ANY other probe failure — parity disagreement, a probe
                # future timeout, an oracle error — must not leave the
                # canary serving a model the rest of the fleet does not:
                # roll it back before surfacing the failure.
                if canary.alive:
                    canary.scorer.swap_model(old_model)
                self._mark_rollout(canary.replica_id, "rolled_back")
                raise
            self._mark_rollout(canary.replica_id, "probe_ok")
            for replica in self.replicas:
                if replica is canary or not replica.alive:
                    continue
                try:
                    replica.scorer.swap_model(model)
                    self._mark_rollout(replica.replica_id, "promoted")
                except Exception as e:
                    # The raw scorer's swap fails with its own error (a
                    # refusal or device failure), never ReplicaDeadError.
                    # A replica that cannot take the promoted model must
                    # not keep serving the old one: mark it dead so its
                    # in-flight work reroutes to promoted replicas.
                    self._mark_dead(replica, e)
                    self._mark_rollout(replica.replica_id, "died")
            self.telemetry.counter("serving.rollouts").inc()
            return

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        wall = max(self.clock() - self._t0, 1e-9)
        for replica in self.replicas:
            self.telemetry.gauge(
                "serving.replica_qps", replica=replica.replica_id
            ).set(replica.requests_served / wall)
            replica.close()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
