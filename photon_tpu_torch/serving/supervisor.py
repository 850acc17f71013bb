"""Replica supervision: health probes, resurrection, quarantine.

Counterpart of ``photon_tpu/serving/supervisor.py``.  The router sheds
AROUND failure (a dead replica's work reroutes, the fleet shrinks); this
module makes the fleet heal FROM failure.  One supervisor watches a
fleet's replicas, thread or subprocess, and closes the loop:

- **Detection.**  Every probe interval, each live replica is checked four
  ways: child exit code (``poll_exit`` — a subprocess replica that
  hard-exited), watchdog heartbeat age (work pending but no scoring
  progress — the mid-batch wedge, ``fault/watchdog.py`` machinery), a
  liveness ping frame with a hard deadline (subprocess control channel,
  via ``call_with_timeout``), and a tiny KNOWN-ANSWER score probe checked
  against the host oracle (a replica that answers quickly but wrongly is
  as dead as one that doesn't answer).
- **Declaration.**  An unhealthy replica is marked dead through the
  router (``serving.replica_deaths{replica,cause}``) and its pending
  futures are failed with ``ReplicaDeadError`` — they reroute through the
  existing exactly-once path, so a hang costs its callers a reroute, not
  a lost response.
- **Resurrection.**  The supervisor re-spawns with capped exponential
  backoff (the ``fault/retry.py`` policy shape), re-warms the bucket
  ladder, then gates the return through the rollout's canary machinery:
  mirrored recent traffic (or a synthetic known-answer probe) replays
  through the rejoining replica against the CURRENT model's host oracle,
  and only parity ≤ ``parity_tol`` readmits it (``router.revive``).  The
  fleet's model version is re-checked around the probe, so a replica
  resurrected mid-rollout comes back on the model the fleet serves NOW,
  never the one it died on.
- **Quarantine.**  A flapping replica — ``max_deaths`` deaths inside
  ``flap_window_s`` — is quarantined permanently
  (``serving.replica_quarantined``): a replica that keeps dying is a
  capacity lie, and readmitting it again and again turns every death into
  fleet-wide reroute churn.

Timeline: every supervision event lands a monotonic
``serving.supervisor_step{replica,phase}`` gauge (``died-<cause>``,
``respawn``, ``rejoin-probe``, ``rejoined``, ``respawn-failed``,
``quarantined``) — the telemetry report renders them in order.

Residency contract (``tools/check_host_sync.py`` guards this module): the
supervisor is pure host-side control; its only sanctioned fetches are the
probe-oracle parity comparisons, which exist precisely to score on host.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import threading
import time
from collections import deque
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Dict, Optional, Tuple

from photon_tpu_torch.fault.retry import RetryPolicy
from photon_tpu_torch.fault.watchdog import IOStallTimeoutError, age_of
from photon_tpu_torch.serving.fleet import probe_request_for
from photon_tpu_torch.serving.router import (  # noqa: F401 — parity_worst is
    # re-exported here (the supervision-facing name tests/callers use).
    ReplicaDeadError,
    host_score_request,
    parity_worst,
)


class RejoinParityError(RuntimeError):
    """A resurrected replica's rejoin probe disagreed with the current
    model's host oracle; it was NOT readmitted (the attempt counts as a
    respawn failure and backs off)."""


@dataclasses.dataclass(frozen=True)
class SupervisorPolicy:
    """Supervision knobs.

    ``probe_interval_s`` — seconds between health passes.
    ``probe_deadline_s`` — hard deadline on the ping and the known-answer
    probe; a probe that misses it declares the replica hung.
    ``hang_timeout_s`` — heartbeat age past which a replica WITH pending
    work is declared hung even between probes.
    ``lease_s`` — the membership lease: a replica stays a
    member as long as SOME ping succeeded within the last ``lease_s``
    seconds.  Ping failures inside the window are tolerated misses
    (transient partition / dropped connection — the replica rejoins
    silently); only lease expiry declares death (cause ``"lease"``).
    ``parity_tol`` — known-answer and rejoin probes vs the host oracle.
    ``respawn_base_s``/``respawn_max_s``/``respawn_jitter`` — the capped
    exponential backoff between resurrection attempts (the
    ``fault/retry.py`` policy shape).
    ``max_deaths``/``flap_window_s`` — the permanent-quarantine verdict:
    ``max_deaths`` deaths inside the window.
    ``max_respawn_failures`` — consecutive failed resurrection attempts
    (spawn faults, rejoin-probe failures) before the replica is
    quarantined like a flapper: a spawn path that never succeeds is a
    capacity lie too, and retrying it forever is a hot loop.
    ``resurrect`` — False supervises (detect + declare) without healing.
    """

    probe_interval_s: float = 0.5
    probe_deadline_s: float = 5.0
    probe_rows: int = 2
    hang_timeout_s: float = 5.0
    lease_s: float = 15.0
    parity_tol: float = 1e-3
    respawn_base_s: float = 0.05
    respawn_max_s: float = 2.0
    respawn_jitter: float = 0.25
    max_deaths: int = 3
    flap_window_s: float = 60.0
    max_respawn_failures: int = 64
    resurrect: bool = True


class ReplicaSupervisor:
    """Health-checked supervision + canary-gated resurrection for one
    :class:`~photon_tpu_torch.serving.fleet.ServingFleet`.

    ``check_once()`` is one full supervision pass (tests drive it
    directly, deterministically); ``start()`` runs it on a background
    thread every ``probe_interval_s``.  The supervisor never blocks the
    serving path: probes ride the replicas' own batchers, and declaration
    /resurrection touch only router bookkeeping and the dead replica."""

    def __init__(self, fleet, policy: Optional[SupervisorPolicy] = None,
                 telemetry=None, logger=None,
                 clock=time.monotonic):
        from photon_tpu_torch.telemetry import NULL_SESSION

        self.fleet = fleet
        self.router = fleet.router
        self.policy = policy or SupervisorPolicy()
        self.telemetry = telemetry or fleet.telemetry or NULL_SESSION
        self.logger = logger
        self.clock = clock
        self._seq = itertools.count(1)
        self._rng = random.Random(0)
        self._backoff = RetryPolicy(
            attempts=1_000_000,  # max_respawn_failures bounds attempts
            base_delay_s=self.policy.respawn_base_s,
            max_delay_s=self.policy.respawn_max_s,
            jitter=self.policy.respawn_jitter,
        )
        self._noted: set = set()  # (replica_id, generation) deaths recorded
        # Per-replica lease expiry instants: renewed by every
        # successful ping, popped on death so a rejoined replica starts a
        # fresh lease.
        self._leases: Dict[str, float] = {}
        self._deaths: Dict[str, deque] = {}
        self._attempts: Dict[str, Tuple[int, float]] = {}  # id -> (n, at)
        # (model, request, want): the known-answer probe and its oracle
        # for the model the fleet serves (the multi-model arena's
        # per-tenant rotation waits in ROADMAP.md queue 1, item 7.5).
        self._probe_cache: Optional[Tuple] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- bookkeeping ----------------------------------------------------------
    def _mark(self, replica_id: str, phase: str) -> None:
        """Timeline breadcrumb, same shape as the rollout timeline: a
        monotonic sequence number per (replica, phase) event."""
        self.telemetry.gauge(
            "serving.supervisor_step", replica=replica_id, phase=phase
        ).set(next(self._seq))

    def _known_answer(self, model):
        """``(request, want)`` for the health probe: a tiny SYNTHETIC
        request (deterministic, ``probe_rows`` rows — mirrored live
        requests can be max-batch sized, too heavy to score on host every
        probe pass) with its host-oracle answer computed ONCE per model."""
        cached = self._probe_cache
        if cached is not None and cached[0] is model:
            return cached[1], cached[2]
        request = probe_request_for(
            model, self._request_spec(), rows=self.policy.probe_rows
        )
        want = host_score_request(model, request)
        self._probe_cache = (model, request, want)
        return request, want

    def _request_spec(self):
        for replica in self.router.replicas:
            spec = getattr(replica.scorer, "request_spec", None)
            if spec:
                return spec
        raise RuntimeError("no replica exposes a request spec to probe with")

    # -- one supervision pass -------------------------------------------------
    def check_once(self) -> None:
        # Known-answer parity failures are COLLECTED, not declared inline:
        # when EVERY live replica fails parity right after a swap, the
        # fleet — not N replicas — regressed, and the fix is ONE rollout
        # rollback to the predecessor artifact instead of N quarantines.
        # Crash/hang causes stay replica-local and declare immediately
        # inside _health_check.
        parity: dict = {}
        for replica in self.router.replicas:
            if replica.quarantined:
                continue
            if replica.alive:
                verdict = self._health_check(replica)
                if verdict is not None:
                    parity[replica] = verdict
                elif replica.alive:
                    self._pull_stats(replica)
            # Crash/hang declarations keep the per-replica
            # interleaving: teardown + resurrection happen here, before
            # the next replica's probes — a replica that just absorbed a
            # dead sibling's rerouted work gets the resurrection window to
            # complete a batch before its own heartbeat is judged.
            if not replica.alive and not replica.quarantined:
                self._note_death(replica)
                if self.policy.resurrect and not replica.quarantined:
                    self._maybe_resurrect(replica)
        live = {
            r for r in self.router.replicas
            if r.alive and not r.quarantined
        }
        if parity and set(parity) == live:
            _model, version = self.fleet.current_model()
            if self._fleet_rollback(version):
                return
            if self.fleet.current_model()[1] != version:
                # A publish landed while the rollback waited for the
                # fleet's publish lock: every parity verdict was collected
                # against a model nobody serves any more — drop them and
                # re-probe next pass instead of declaring on stale
                # evidence.
                return
        for replica, (cause, detail) in parity.items():
            self._declare(replica, cause, detail)
            if not replica.alive and not replica.quarantined:
                if self.policy.resurrect and not replica.quarantined:
                    self._maybe_resurrect(replica)

    def _fleet_rollback(self, expected_version) -> bool:
        """Every live replica failed its known-answer probe: republish the
        predecessor artifact fleet-wide (``ServingFleet.
        rollback_to_previous``).  Returns False when there is no
        predecessor (nothing ever rolled out) or the model version moved
        past ``expected_version`` (the probe evidence is stale) — the
        caller then declares per-replica or drops the stale verdicts."""
        rollback = getattr(self.fleet, "rollback_to_previous", None)
        if rollback is None or not rollback(expected_version):
            return False
        # The model changed: drop the cached probe oracles so the next
        # pass probes against the restored artifact.
        self._probe_cache = None
        for replica in self.router.replicas:
            if replica.alive and not replica.quarantined:
                self._mark(replica.replica_id, "fleet-rollback")
        if self.logger is not None:
            self.logger.warning(
                "supervisor: every replica failed its known-answer probe "
                "after a swap — rolled the fleet back to the predecessor "
                "artifact (one rollback, zero quarantines)"
            )
        return True

    def _pull_stats(self, replica) -> None:
        """Child-telemetry aggregation: each healthy pass also pulls a
        subprocess replica's
        scorer-level ``serving.*`` counters into the parent registry
        (``SubprocessReplica.pull_stats`` — delta merge, idempotent).
        Advisory only: a failed pull never declares a replica — liveness
        verdicts belong to the probes above."""
        pull = getattr(replica, "pull_stats", None)
        if pull is None:
            return
        try:
            pull(self.policy.probe_deadline_s)
        except Exception:  # noqa: BLE001 — stats must never fail a pass
            pass

    # -- detection ------------------------------------------------------------
    def _health_check(self, replica):
        # 1. Crash: the backing process hard-exited (subprocess replicas).
        code = replica.poll_exit()
        if code is not None:
            self._declare(replica, "crash",
                          f"child exited with code {code}")
            return
        # 2. Hang between probes: work is pending but the heartbeat the
        # scoring path marks around each batch has gone stale.
        age = age_of(replica.heartbeat_site)
        if (age is not None and age > self.policy.hang_timeout_s
                and replica.pending_rows() > 0):
            self._declare(replica, "hang",
                          f"no scoring progress for {age:.1f}s with "
                          f"{replica.pending_rows()} rows pending")
            return
        # 3. Liveness ping (subprocess control channel) under LEASE
        # semantics: a successful ping RENEWS the replica's
        # time-bounded lease; a failed one inside the lease window is a
        # MISS — tolerated, because over a real network a dropped control
        # connection or a transient partition is indistinguishable from
        # death at single-probe granularity, and a false declaration
        # spawns a twin of a live replica (the double-serve the
        # generation fence then has to catch).  Only lease EXPIRY — no
        # successful renewal for ``lease_s`` — declares.  A genuinely
        # wedged child is still caught promptly by step 2 (stale
        # heartbeat with work pending) and a hard-exited one by step 1;
        # the lease only governs the silent-network signal.
        ping = getattr(replica, "ping", None)
        if ping is not None:
            rid = replica.replica_id
            now = self.clock()
            expires = self._leases.get(rid)
            if expires is None:
                expires = now + self.policy.lease_s
                self._leases[rid] = expires
            try:
                ping(self.policy.probe_deadline_s, gen=replica.generation)
            except (IOStallTimeoutError, OSError, RuntimeError) as e:
                now = self.clock()
                if now < expires:
                    self.telemetry.counter(
                        "serving.lease_probe_misses", replica=rid
                    ).inc()
                    self.telemetry.gauge(
                        "serving.lease_remaining_s", replica=rid
                    ).set(expires - now)
                    self._mark(rid, "lease-miss")
                    # Skip the score probe too: it would ride the same
                    # partitioned link and turn one miss into a deadline
                    # pile-up.  Re-probe next pass.
                    return
                self._leases.pop(rid, None)
                self._declare(
                    replica, "lease",
                    f"lease expired ({self.policy.lease_s:g}s without a "
                    f"successful renewal): {e}",
                )
                return
            self._leases[rid] = self.clock() + self.policy.lease_s
            self.telemetry.gauge(
                "serving.lease_remaining_s", replica=rid
            ).set(self.policy.lease_s)
        # 4. Known-answer score probe vs the host oracle.
        model, version = self.fleet.current_model()
        request, want = self._known_answer(model)
        try:
            got = replica.submit(request).result(
                timeout=self.policy.probe_deadline_s
            )
        except FutureTimeoutError:
            # The probe rides the replica's OWN queue: under heavy load a
            # saturated-but-progressing replica can miss the deadline just
            # by queueing.  Busy is not hung — only a replica whose
            # heartbeat ALSO went stale (no batch completed either) is
            # declared; otherwise a load spike would cascade into a mass
            # abandon+reroute and, repeated, a permanent quarantine of a
            # perfectly healthy fleet.
            age = age_of(replica.heartbeat_site)
            if age is not None and age <= self.policy.hang_timeout_s:
                return
            self._declare(replica, "hang",
                          f"score probe missed its "
                          f"{self.policy.probe_deadline_s:g}s deadline "
                          f"with no scoring progress")
            return
        except ReplicaDeadError:
            # Already latched by the scoring path; cause rides the replica.
            self._declare(replica, replica.death_cause or "crash",
                          "probe found the replica dead")
            return
        except Exception as e:  # noqa: BLE001 — any probe failure is fatal
            self._declare(replica, "error", f"score probe failed: {e}")
            return
        if self.fleet.current_model()[1] != version:
            return  # a rollout landed mid-probe: the oracle is stale
        worst = parity_worst(got, want)
        # Per-codec parity histogram: known-answer probe deltas
        # labeled by the replica's serving storage tier.
        self.telemetry.histogram(
            "serving.probe_parity",
            dtype=getattr(replica.scorer, "table_dtype", "f32"),
        ).observe(worst)
        observer = getattr(self.fleet, "observer", None)
        if observer is not None:
            # Feed BOTH verdicts to the SLO monitor: the canary-parity
            # burn rate needs good probes in its denominator.
            try:
                observer.on_parity(replica.replica_id, worst)
            except Exception:  # noqa: BLE001 — observation is advisory
                pass
        if worst > self.policy.parity_tol:
            if self.fleet.rollout_in_progress():
                # Mid-rollout, different replicas LEGITIMATELY serve
                # different versions (the stagger window); a version
                # mismatch here is the rollout's job to resolve, not a
                # replica fault — declaring would kill healthy replicas
                # on every rollout.
                return None
            # DEFERRED verdict: check_once declares it per-replica unless
            # the whole fleet failed parity (→ one rollout rollback).
            return (
                "parity",
                f"known-answer probe off by {worst:.2e} "
                f"(> {self.policy.parity_tol:g})",
            )
        return None

    def _declare(self, replica, cause: str, detail: str) -> None:
        if self.logger is not None:
            self.logger.warning("supervisor: replica %s unhealthy (%s): %s",
                                replica.replica_id, cause, detail)
        self.router.mark_unhealthy(replica, cause, detail)
        self._note_death(replica)

    def _note_death(self, replica) -> None:
        """Record one death exactly once per (replica, generation): flap
        accounting, the timeline mark, teardown of whatever the dead
        replica still held (failed futures reroute), and the permanent
        quarantine verdict."""
        key = (replica.replica_id, replica.generation)
        if key in self._noted:
            return
        self._noted.add(key)
        rid = replica.replica_id
        self._leases.pop(rid, None)  # a rejoin starts a fresh lease
        cause = replica.death_cause or "error"
        # Idempotent router-side accounting: a death latched by the scoring
        # proxy outside any router dispatch (e.g. a probe submitted straight
        # to the replica) still lands its serving.replica_deaths count.
        self.router.mark_unhealthy(replica, cause, "noted by supervisor")
        now = self.clock()
        self._deaths.setdefault(rid, deque(maxlen=64)).append(now)
        self._mark(rid, f"died-{cause}")
        replica.abandon_pending(
            ReplicaDeadError(f"replica {rid} declared dead ({cause})")
        )
        kill = getattr(replica, "kill_backend", None)
        if kill is not None:
            kill()
        # Postmortem collection AFTER the kill (the child's on-disk flight
        # ring is final by then): persist the victim's last seconds next
        # to the run report and adopt its mid-flight spans as lost stubs.
        observer = getattr(self.fleet, "observer", None)
        if observer is not None:
            observer.collect_flight(replica, cause)
        window = [
            t for t in self._deaths[rid]
            if now - t <= self.policy.flap_window_s
        ]
        if len(window) >= self.policy.max_deaths:
            replica.quarantined = True
            self.telemetry.counter(
                "serving.replica_quarantined", replica=rid
            ).inc()
            self._mark(rid, "quarantined")
            if self.logger is not None:
                self.logger.warning(
                    "supervisor: replica %s quarantined permanently "
                    "(%d deaths inside %.0fs)", rid, len(window),
                    self.policy.flap_window_s,
                )

    # -- resurrection ---------------------------------------------------------
    def _maybe_resurrect(self, replica) -> None:
        rid = replica.replica_id
        attempt, not_before = self._attempts.get(rid, (0, 0.0))
        if self.clock() < not_before:
            return  # still backing off
        try:
            self._mark(rid, "respawn")
            model, version = self.fleet.current_model()
            # Re-spawn + re-warm (thread replicas re-warm against their
            # captured programs — nothing captures; subprocess replicas
            # boot a fresh warmed child from the current shared artifact).
            replica.respawn(model=model)
            # Canary-gated rejoin: mirrored recent traffic (or the
            # synthetic known-answer probe) through the rejoining replica
            # vs the CURRENT model's host oracle — dispatch readmission is
            # gated on parity exactly like a rollout canary.
            self._mark(rid, "rejoin-probe")
            probes = self.router.recent_requests() or [
                self._known_answer(model)[0]
            ]
            for request in probes:
                got = replica.submit(request).result(
                    timeout=self.policy.probe_deadline_s
                )
                worst = parity_worst(got, host_score_request(model, request))
                if worst > self.policy.parity_tol:
                    raise RejoinParityError(
                        f"rejoin probe off by {worst:.2e} "
                        f"(> {self.policy.parity_tol:g})"
                    )
            # Model-version re-sync: a rollout may have published while
            # this replica was being resurrected — it must come back on
            # the model the fleet serves NOW, never the one it died on.
            current, current_version = self.fleet.current_model()
            if current_version != version:
                replica.scorer.swap_model(current)
            self.router.revive(replica)
            self._attempts.pop(rid, None)
            # A rejoined member starts a fresh lease: the misses that led
            # to its death must not count against the new incarnation.
            self._leases[rid] = self.clock() + self.policy.lease_s
            self._mark(rid, "rejoined")
            if self.logger is not None:
                self.logger.info("supervisor: replica %s rejoined the "
                                 "dispatch set", rid)
        except BaseException as e:  # noqa: BLE001 — spawn/probe failures
            replica.rejoining = False
            self.telemetry.counter(
                "serving.respawn_failures", replica=rid
            ).inc()
            delay = self._backoff.delay(attempt, self._rng)
            self._attempts[rid] = (attempt + 1, self.clock() + delay)
            self._mark(rid, "respawn-failed")
            observer = getattr(self.fleet, "observer", None)
            if observer is not None:
                observer.collect_flight(replica, "respawn-failed")
            if self.logger is not None:
                self.logger.warning(
                    "supervisor: resurrecting %s failed (%s: %s); retrying "
                    "in %.2fs (attempt %d)", rid, type(e).__name__, e,
                    delay, attempt + 1,
                )
            # A spawn path that NEVER succeeds must not retry forever:
            # the flap quarantine counts deaths per generation (one per
            # failed-resurrection streak), so consecutive respawn
            # failures get their own bound.
            if attempt + 1 >= self.policy.max_respawn_failures:
                replica.quarantined = True
                self.telemetry.counter(
                    "serving.replica_quarantined", replica=rid
                ).inc()
                self._mark(rid, "quarantined")
                if self.logger is not None:
                    self.logger.warning(
                        "supervisor: replica %s quarantined after %d "
                        "consecutive failed resurrection attempts",
                        rid, attempt + 1,
                    )

    # -- lifecycle ------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.policy.probe_interval_s):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — supervision must outlive a
                # bad pass (one probe hiccup must not silently end
                # detection for the rest of the run).
                pass

    def start(self) -> "ReplicaSupervisor":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="photon-replica-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
