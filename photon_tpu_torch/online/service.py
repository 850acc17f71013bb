"""Online learning service: continual training with zero-downtime refresh.

Counterpart of ``photon_tpu/online/service.py``: the loop that joins
ingest, growth, refresh and publish into one data-in → model-out
subsystem:

1. **Ingest** — drain an append-only feed (:mod:`photon_tpu_torch.online.feed`:
   in-process queue or directory watch, IO under the retry/watchdog
   triangle's ``online:ingest`` site).
2. **Delta** — which coordinates and which entities the appended rows
   touch (:mod:`photon_tpu_torch.online.delta`).
3. **Grow** — device data extends IN PLACE for both new and existing
   entities (``GameEstimator.onboard_training_data`` → per-bin
   row-capacity headroom + entity migration; ZERO full random-effect
   layout rebuilds, asserted via ``estimator.device_data_rebuilds``).
4. **Refresh** — a warm-started partial ``CoordinateDescent``: untouched
   coordinates stay LOCKED on the serving model, touched ones retrain
   warm-started from it.  Checkpointable mid-refresh (``descent:kill`` →
   restart → ``resume auto`` → exact parity).
5. **Publish** — ``ServingFleet.rollout``: the canary-gated staggered
   ``swap_model`` under live traffic — no new capture (serving-table
   capacity headroom), zero dropped or mixed-model responses,
   parity-probed; a vocabulary grown past the served capacity publishes
   through ``ServingFleet.rebuild`` instead.  The ``online:refresh:kill``
   fault site sits between train and publish: a kill there resumes the
   COMPLETED fit from its checkpoint and publishes on restart.

Telemetry (``online.*``): refresh latency append→serving
(``online.refresh_latency_s``), rows/batches ingested, coordinates
refreshed vs locked, a staleness gauge (age of the oldest unpublished
append), publish and failure counters.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from photon_tpu_torch.fault.checkpoint import CheckpointError
from photon_tpu_torch.game.estimator import (
    GameEstimator,
    GameOptimizationConfiguration,
)
from photon_tpu_torch.game.model import GameModel, RandomEffectModel
from photon_tpu_torch.online.delta import (
    BatchDelta,
    compute_delta,
    merge_append,
    merge_deltas,
)
from photon_tpu_torch.telemetry import NULL_SESSION

ROUNDS_NAME = "rounds.txt"


@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """Online-refresh knobs.

    ``refresh_iterations`` — outer descent iterations per refresh (the
    partial retrain is warm-started, so a small number converges).
    ``min_rows`` — pending-row threshold below which a poll is a no-op.
    ``lock_untouched`` — lock coordinates the drained batches do not touch
    (False retrains everything every refresh).
    ``max_quarantined`` — the descent quarantine budget per refresh.
    ``rollout_parity_tol`` — the canary parity gate of each publish;
    ``None`` (default) derives the gate from the fleet's serving table
    dtype (``lowp.parity_tol_for`` — f32 keeps the historical 1e-3, a
    bf16/int8 fleet gates at its measured codec bound).
    ``poll_interval_s`` — the background loop's cadence.
    """

    refresh_iterations: int = 2
    min_rows: int = 1
    lock_untouched: bool = True
    max_quarantined: Optional[int] = 8
    rollout_parity_tol: Optional[float] = None
    poll_interval_s: float = 0.2


@dataclasses.dataclass
class RefreshResult:
    """Outcome of one refresh round."""

    round: int
    model: GameModel
    delta: BatchDelta
    locked: List[str]
    rows: int
    latency_s: float
    published: bool


class OnlineLearningService:
    """Background continual training over a :class:`GameEstimator` + feed,
    publishing through a :class:`~photon_tpu_torch.serving.fleet.ServingFleet`.

    ``estimator`` owns the training data and the device layouts (they grow
    in place, refresh over refresh); ``configuration`` is the ONE
    configuration refreshed (online refresh is not a sweep); ``model`` is
    the currently served model — the warm-start seed of the first refresh.
    ``fleet`` is optional: without one the service trains and updates
    ``self.model`` but publishes nowhere (a trainer-only deployment).

    ``checkpoint_dir`` makes every refresh preemption-safe: round ``k``
    checkpoints under ``round-00000k/`` and a restarted service (same
    estimator data, same feed backlog) resumes it exactly — the feed's
    consumed cursor advances only after publish, so the restart drains the
    same batches and the descent checkpoint carries the rest.  The merged
    training data itself is NOT durable: on restart the owner must
    reconstruct it as base data + the feed's ``consumed_sources()`` parts
    in order (``drivers/online_game`` does) before re-ingesting the
    backlog — otherwise published rows silently drop from training.

    Drive it synchronously (:meth:`refresh_once` — tests, benches, drain
    loops) or as a background thread (:meth:`start`/:meth:`stop`).
    """

    def __init__(
        self,
        estimator: GameEstimator,
        configuration: GameOptimizationConfiguration,
        feed,
        model: GameModel,
        fleet=None,
        checkpoint_dir: Optional[str] = None,
        policy: Optional[RefreshPolicy] = None,
        telemetry=None,
        logger=None,
        model_id: Optional[str] = None,
    ):
        if model_id is not None:
            raise NotImplementedError(
                "a per-tenant publish (model_id=) waits with the serving "
                "arena in ROADMAP.md queue 1, item 7.5")
        self.estimator = estimator
        self.configuration = configuration
        self.feed = feed
        self.model = model
        self.fleet = fleet
        self.checkpoint_dir = checkpoint_dir
        self.policy = policy or RefreshPolicy()
        self.telemetry = telemetry or NULL_SESSION
        self.logger = logger
        self._round = self._read_completed_rounds()
        # Batches already folded into the estimator's training data but
        # not yet published (a refresh that failed AFTER onboarding): the
        # retry must not merge them twice.  In-memory only — a RESTART
        # rebuilds the estimator from base data + the feed's CONSUMED
        # parts (the owner re-merges them: the merged training data is
        # not durable; see drivers/online_game's replay-consumed-parts
        # step and DirectoryFeed.consumed_sources) and then re-ingests
        # the pending backlog.
        self._onboarded: set = set()
        # The batch set of the CURRENT round, snapshotted on its first
        # attempt: a retry after a failed publish must train the SAME
        # round (the round checkpoint's fingerprint pins the row count
        # and lock list) — parts arriving mid-round wait for the next.
        self._round_batches: Optional[List] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- durable round counter ----------------------------------------------
    def _rounds_path(self) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        return os.path.join(self.checkpoint_dir, ROUNDS_NAME)

    def _read_completed_rounds(self) -> int:
        path = self._rounds_path()
        if path is None:
            return 0
        try:
            with open(path) as f:
                return sum(1 for line in f if line.strip())
        except FileNotFoundError:
            return 0

    def _complete_round(self) -> None:
        """Durably record a published round (atomic rewrite): a restart
        resumes at the right ``round-NNNNNN`` checkpoint subdirectory.
        Written AFTER publish, BEFORE the feed cursor — a kill between the
        two re-ingests already-published rows into the next round, which
        is idempotent training work, never a lost refresh."""
        path = self._rounds_path()
        self._round += 1
        if path is None:
            return
        from photon_tpu_torch.fault.atomic import atomic_write_bytes

        os.makedirs(self.checkpoint_dir, exist_ok=True)
        atomic_write_bytes(
            path,
            "".join(
                f"round-{i:06d}\n" for i in range(self._round)
            ).encode(),
        )

    # -- warm start ----------------------------------------------------------
    def _vocabs(self) -> Dict[str, np.ndarray]:
        """Current entity vocabularies per id column, from the estimator's
        live device layouts (fallback: the serving model's keys)."""
        vocabs: Dict[str, np.ndarray] = dict(
            self.estimator.entity_vocabularies()
        )
        for m in self.model.coordinates.values():
            if isinstance(m, RandomEffectModel):
                # host-sync: entity vocabularies are host numpy by
                # construction (model build time, not the serving path).
                vocabs.setdefault(m.entity_column, np.asarray(m.keys))
        return vocabs

    def _grown_warm_start(self) -> GameModel:
        """The serving model grown to the onboarded vocabularies ON DEVICE
        (``RandomEffectModel.with_entities`` — existing entities keep their
        rows, new entities start at zero, the cold-start value)."""
        coords = {}
        for name, m in self.model.coordinates.items():
            cc = self.configuration.coordinates.get(name)
            if isinstance(m, RandomEffectModel) and cc is not None:
                dd = self.estimator.device_layout(cc)
                if len(dd.dataset.keys) != len(m.keys):
                    m = m.with_entities(dd.dataset.keys)
            coords[name] = m
        return GameModel(coords, self.model.task_type)

    # -- the loop body -------------------------------------------------------
    def refresh_once(self) -> Optional[RefreshResult]:
        """One full refresh round: drain the feed, grow device data, run
        the warm-started partial fit, publish through the canary gate, and
        commit the feed cursor.  Returns None when the backlog is below
        ``policy.min_rows``."""
        pending = self.feed.poll()
        # Staleness from the batches just polled (one feed scan per tick).
        self.telemetry.gauge("online.staleness_s").set(
            time.monotonic() - min(b.appended_at for b in pending)
            if pending else 0.0
        )
        if self._round_batches is None:
            batches = pending
        else:
            # Retry of a failed round: replay EXACTLY its batch set, so
            # the round checkpoint's fingerprint (row count, lock list)
            # still matches; newer arrivals join the NEXT round.
            batches = self._round_batches
        pending_rows = sum(b.data.num_examples for b in batches)
        if not batches or pending_rows < self.policy.min_rows:
            return None
        self._round_batches = batches
        t_append = min(b.appended_at for b in batches)
        round_id = self._round
        with self.telemetry.span("online.refresh", round=round_id,
                                 rows=pending_rows):
            # 1+2. Ingest + delta: merge every pending batch onto the
            # current training data, accumulating the per-column absent
            # masks and the per-batch coordinate deltas.  A batch a FAILED
            # previous attempt already folded into the estimator (onboard
            # succeeded, fit/publish did not) is skipped here — merging it
            # again would double its rows' weight in the model; its delta
            # still counts toward this round's lock list.
            vocabs = self._vocabs()
            merged = self.estimator.training_data
            n_base = merged.num_examples
            absent: Dict[str, list] = {}
            deltas = []
            fresh_batches = []
            for batch in batches:
                deltas.append(compute_delta(
                    self.configuration.coordinates, vocabs, batch.data,
                ))
                if id(batch) in self._onboarded:
                    continue
                fresh_batches.append(batch)
                merged, batch_absent = merge_append(merged, batch.data)
                for colname, mask in batch_absent.items():
                    absent.setdefault(colname, []).append(mask)
            absent_tail = {
                colname: np.concatenate(masks)
                for colname, masks in absent.items()
            }
            delta = merge_deltas(deltas)
            self.telemetry.counter("online.batches_ingested").inc(
                len(fresh_batches)
            )
            self.telemetry.counter("online.rows_ingested").inc(
                merged.num_examples - n_base
            )
            # 3. Grow device data in place (new + existing entities).
            if fresh_batches:
                self.estimator.onboard_training_data(
                    merged, absent_tail=absent_tail
                )
                self._onboarded.update(id(b) for b in fresh_batches)
            # 4. Warm-started partial refresh with untouched coordinates
            # locked on the serving model.
            warm = self._grown_warm_start()
            locked = []
            if self.policy.lock_untouched:
                locked = [
                    name for name in delta.untouched
                    if name in warm.coordinates
                ]
            round_dir = (
                os.path.join(self.checkpoint_dir, f"round-{round_id:06d}")
                if self.checkpoint_dir else None
            )
            config = dataclasses.replace(
                self.configuration,
                descent_iterations=self.policy.refresh_iterations,
                name=f"refresh-{round_id:06d}",
            )
            with self.telemetry.span("online.train", round=round_id):
                try:
                    results = self.estimator.fit(
                        [config],
                        initial_model=warm,
                        locked_coordinates=locked,
                        checkpoint_dir=round_dir,
                        resume="auto" if round_dir else None,
                        max_quarantined=self.policy.max_quarantined,
                    )
                except CheckpointError:
                    # The round checkpoint no longer matches this round's
                    # shape (a RESTARTED service drained a different batch
                    # set than the killed attempt — e.g. parts arrived
                    # between the kill and the restart).  The checkpoint
                    # was an optimization, not a correctness requirement:
                    # train the round fresh, overwriting the stale chain,
                    # instead of wedging on the refusal forever.
                    self.telemetry.counter(
                        "online.checkpoint_refused"
                    ).inc()
                    if self.logger is not None:
                        self.logger.warning(
                            "online refresh %d: round checkpoint does not "
                            "match this round's batch set; training fresh",
                            round_id,
                        )
                    results = self.estimator.fit(
                        [config],
                        initial_model=warm,
                        locked_coordinates=locked,
                        checkpoint_dir=round_dir,
                        max_quarantined=self.policy.max_quarantined,
                    )
            model = results[0].model
            self.telemetry.counter("online.coordinates_refreshed").inc(
                len(config.coordinates) - len(locked)
            )
            if locked:
                self.telemetry.counter("online.coordinates_locked").inc(
                    len(locked)
                )
            # 5. Publish through the canary gate.  The kill window between
            # train and publish: a restart finds the round's fit COMPLETE
            # in its checkpoint (rebuilt without re-running) and publishes.
            from photon_tpu_torch.fault.injection import fault_point

            fault_point("online:refresh:kill", iteration=round_id)
            published = False
            if self.fleet is not None:
                with self.telemetry.span("online.publish", round=round_id):
                    self._publish(model)
                published = True
                self.telemetry.counter("online.publishes").inc()
            self.model = model
            self.telemetry.counter("online.refreshes").inc()
            self._complete_round()
            self.feed.mark_consumed(batches)
            self._onboarded.difference_update(id(b) for b in batches)
            self._round_batches = None
            latency = time.monotonic() - t_append
            self.telemetry.histogram("online.refresh_latency_s").observe(
                latency
            )
            self.telemetry.gauge("online.staleness_s").set(0.0)
        if self.logger is not None:
            self.logger.info(
                "online refresh %d: %d rows in %d batch(es), %d/%d "
                "coordinates refreshed (%s locked), append->serving "
                "%.3fs%s",
                round_id, pending_rows, len(batches),
                len(config.coordinates) - len(locked),
                len(config.coordinates),
                ",".join(locked) or "none", latency,
                ", published" if published else "",
            )
        return RefreshResult(
            round=round_id, model=model, delta=delta, locked=locked,
            rows=pending_rows, latency_s=latency, published=published,
        )

    def _publish(self, model: GameModel) -> None:
        """Fleet-wide canary rollout of the refreshed model.  Probe traffic
        is the router's mirror of recently admitted live requests; a cold
        fleet probes with a synthetic known-answer request instead.  A
        model whose vocabulary outgrew the served tables' capacity (the
        canary's swap refuses it, nothing swapped) publishes through a
        zero-downtime :meth:`ServingFleet.rebuild` at a larger capacity."""
        from photon_tpu_torch.game.lowp import parity_tol_for
        from photon_tpu_torch.game.model import CAPACITY_REFUSAL
        from photon_tpu_torch.serving.fleet import probe_request_for

        parity_tol = self.policy.rollout_parity_tol
        if parity_tol is None:
            parity_tol = parity_tol_for(getattr(self.fleet, "table_dtype", "f32"))
        probes = None
        if not self.fleet.router.recent_requests():
            spec = next((r.scorer.request_spec for r in self.fleet.replicas
                         if getattr(r.scorer, "request_spec", None)), None)
            if spec is None:
                raise RuntimeError("no replica exposes a request spec to probe with")
            probes = [probe_request_for(model, spec)]

        def rollout_or_rebuild() -> None:
            try:
                self.fleet.rollout(model, probe_requests=probes,
                                   parity_tol=parity_tol)
            except ValueError as e:
                if CAPACITY_REFUSAL not in str(e):
                    raise
                self.telemetry.counter("online.fleet_rebuilds").inc()
                self.fleet.rebuild(model=model, parity_tol=parity_tol,
                                   probe_requests=probes)

        # getattr: _publish is duck-typed (tests drive it with a bare
        # namespace standing in for the service).
        observer = getattr(self.fleet, "observer", None)
        if observer is None:
            rollout_or_rebuild()
            return
        # Traced publish: refresh -> canary -> swap becomes ONE linked
        # trace.  The publish span's context is activated as the ambient
        # trace, so the router parents its serving.rollout span under it
        # and the canary probes carry the same trace id down to the
        # subprocess children.
        from photon_tpu_torch.telemetry.distributed import (
            SpanRecord, activate_trace, current_trace, new_trace_id,
        )

        ambient = current_trace()
        span = SpanRecord(
            trace_id=ambient.trace_id if ambient else new_trace_id(),
            name="online.publish",
            process=observer.process,
            parent_id=ambient.span_id if ambient else None,
        )
        span.attrs["version"] = getattr(model, "version", None)
        try:
            with activate_trace(span.context()):
                rollout_or_rebuild()
            span.finish()
        except BaseException:
            span.finish("error")
            raise
        finally:
            observer.collector.add(span)

    # -- background loop -----------------------------------------------------
    def start(self) -> "OnlineLearningService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="photon-online-refresh", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.policy.poll_interval_s):
            try:
                self.refresh_once()
            except Exception as e:  # noqa: BLE001 — the loop must survive a
                # bad round (a poisoned batch, a failed rollout); the backlog
                # stays pending and the failure is counted and logged, so a
                # transient cause retries on the next poll.
                self.telemetry.counter("online.refresh_failures").inc()
                if self.logger is not None:
                    self.logger.warning("online refresh failed: %s: %s",
                                        type(e).__name__, e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None

    def __enter__(self) -> "OnlineLearningService":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
