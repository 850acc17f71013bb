"""Serving fleet: N scorer replicas behind the router, in one process.

Counterpart of ``photon_tpu/serving/fleet.py`` for ``backend="thread"``:
builds N :class:`~photon_tpu_torch.serving.router.ScorerReplica` instances
from ONE model object (each replica builds its own tables on the device
from it), wires them behind a
:class:`~photon_tpu_torch.serving.router.FleetRouter` with deadline-aware
admission control, and runs the canary rollout, the fleet rollback and the
zero-downtime rebuild.

On one card ``devices="split"`` puts every replica on the same device; each
replica's scorer has its own CUDA stream, graphs and graph memory pool.
The multi-GPU split waits for ROADMAP.md queue 1, item 10; the subprocess
backend, the multi-model arena, supervision, the observability plane and
the socket ingest wait for item 7 and raise.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_tpu_torch.serving.batcher import DEFAULT_MAX_DELAY_S
from photon_tpu_torch.serving.router import (
    AdmissionPolicy,
    FleetRouter,
    ScorerReplica,
    host_score_request,
    not_ported,
    parity_worst,
)
from photon_tpu_torch.serving.scorer import (
    DEFAULT_MAX_BATCH,
    DEFAULT_MIN_BUCKET,
    GameScorer,
    ScoringRequest,
    ShardSpec,
    request_spec_for_model,
)


class ReplicaRebuildError(RuntimeError):
    """A background-rebuild replacement failed its canary parity probe;
    the replacement was retired and the fleet is untouched."""


def probe_request_for(model, request_spec, rows: int = 2,
                      seed: int = 0) -> ScoringRequest:
    """A tiny deterministic known-answer probe request built from the
    request spec: seeded feature rows, entity keys drawn from each random
    coordinate's own vocabulary (so the gather path is probed too)."""
    from photon_tpu_torch.game.model import RandomEffectModel

    rng = np.random.default_rng(seed)
    features: Dict[str, object] = {}
    entity_ids: Dict[str, np.ndarray] = {}
    for coord in model.coordinates.values():
        spec = request_spec[coord.shard_name]
        if coord.shard_name not in features:
            if spec.dense:
                features[coord.shard_name] = rng.standard_normal(
                    (rows, spec.dim)
                ).astype(np.float32)
            else:
                features[coord.shard_name] = (
                    rng.integers(0, spec.dim, (rows, spec.nnz),
                                 dtype=np.int32),
                    rng.standard_normal((rows, spec.nnz)).astype(np.float32),
                )
        if isinstance(coord, RandomEffectModel):
            keys = np.asarray(coord.keys)
            entity_ids[coord.entity_column] = keys[
                rng.integers(0, len(keys), rows)
            ]
    return ScoringRequest(features=features, entity_ids=entity_ids,
                          offset=None)


class ServingFleet:
    """N replicated scorers behind a deadline-aware router.

    Context-manager lifecycle; ``close()`` drains every replica's batcher
    and stamps the per-replica QPS gauges.  ``submit``/``score`` go through
    admission control (``deadline_s`` is a relative budget; sheds raise
    :class:`~photon_tpu_torch.serving.router.RequestShedError`).
    """

    def __init__(
        self,
        model,
        replicas: int = 2,
        device=None,
        devices: str = "split",
        backend: str = "thread",
        request_spec: Optional[Dict[str, ShardSpec]] = None,
        buckets=None,
        max_batch: int = DEFAULT_MAX_BATCH,
        min_bucket: int = DEFAULT_MIN_BUCKET,
        max_delay_s: float = DEFAULT_MAX_DELAY_S,
        telemetry=None,
        admission: Optional[AdmissionPolicy] = None,
        table_capacity_factor: int = 1,
        table_dtype: str = "f32",
        models: Optional[Dict[str, object]] = None,
    ):
        from photon_tpu_torch.game.lowp import check_dtype
        from photon_tpu_torch.telemetry import NULL_SESSION

        if replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        if backend == "subprocess":
            raise not_ported("the subprocess replica backend")
        if backend != "thread":
            raise ValueError(f"unknown replica backend {backend!r} "
                             "(thread | subprocess)")
        if models:
            raise not_ported("the multi-model arena (models=)")
        # ``devices``: the reference deals devices round-robin under
        # "split"; on one card every placement is the same device.
        del devices
        self.model = model
        self.backend = backend
        self.device = device
        self._table_capacity_factor = int(table_capacity_factor)
        self._request_spec_cfg = request_spec
        self._buckets = buckets
        self._max_batch = int(max_batch)
        self._min_bucket = int(min_bucket)
        self.table_dtype = check_dtype(table_dtype)
        self.telemetry = telemetry or NULL_SESSION
        self._model_lock = threading.Lock()
        # Serializes whole PUBLISH operations (rollout, fleet rollback,
        # rebuild): two interleaving publishes would split the fleet.
        self._publish_lock = threading.Lock()
        self._model_version = 0
        self._rolling = 0
        self._previous_model = None
        self.replicas: List[ScorerReplica] = []
        for i in range(int(replicas)):
            self.replicas.append(
                ScorerReplica(
                    f"r{i}", self._new_scorer(model, table_capacity_factor),
                    max_batch=max_batch, max_delay_s=max_delay_s,
                    telemetry=self.telemetry,
                )
            )
        self.router = FleetRouter(
            self.replicas, telemetry=self.telemetry, admission=admission
        )
        self.telemetry.gauge("serving.replicas").set(int(replicas))

    def _new_scorer(self, model, factor: int) -> GameScorer:
        # One card: every replica's scorer on the same device, each with
        # its own stream, graphs and graph pool.
        return GameScorer(
            model,
            device=self.device,
            request_spec=self._request_spec_cfg,
            buckets=self._buckets,
            max_batch=self._max_batch,
            min_bucket=self._min_bucket,
            telemetry=self.telemetry,
            table_capacity_factor=factor,
            table_dtype=self.table_dtype,
        )

    # -- serving -------------------------------------------------------------
    def warmup(self) -> "ServingFleet":
        """Capture every replica's bucket ladder; after this no arrival
        pattern captures again."""
        for replica in self.replicas:
            replica.scorer.warmup()
        return self

    @property
    def compilations(self) -> int:
        return sum(r.scorer.compilations for r in self.replicas)

    def submit(self, request: ScoringRequest,
               deadline_s: Optional[float] = None,
               model: Optional[str] = None):
        """Admit one request.  ``model`` (routing to one tenant of a
        multi-model arena) is not ported and raises."""
        if model is not None:
            raise not_ported("tenant routing (model=)")
        return self.router.submit(request, deadline_s=deadline_s)

    def score(self, request: ScoringRequest,
              deadline_s: Optional[float] = None,
              model: Optional[str] = None):
        return self.submit(request, deadline_s=deadline_s,
                           model=model).result()

    def current_model(self) -> Tuple[object, int]:
        """The model the fleet serves NOW and its monotonic version."""
        with self._model_lock:
            return self.model, self._model_version

    def rollout(self, model, **kwargs) -> None:
        """Staggered/canary ``swap_model`` across the fleet (see
        :meth:`FleetRouter.rollout`).  The fleet's (model, version) is
        published before the router rollout runs and rolled back if it
        fails; whole publishes serialize on ``_publish_lock``.  The canary
        parity gate defaults to the fleet's table-dtype bound
        (``lowp.parity_tol_for``); an explicit ``parity_tol`` wins."""
        if "parity_tol" not in kwargs:
            from photon_tpu_torch.game.lowp import parity_tol_for

            kwargs["parity_tol"] = parity_tol_for(self.table_dtype)
        if kwargs.get("model_id") is not None:
            raise not_ported("a per-tenant rollout (model_id=)")
        with self._publish_lock:
            with self._model_lock:
                previous_model = self.model
                self.model = model
                self._model_version += 1
                self._rolling += 1
            try:
                self.router.rollout(model, **kwargs)
            except BaseException:
                with self._model_lock:
                    self.model = previous_model
                    # The version stays monotonic: the rollback is itself
                    # a new published state.
                    self._model_version += 1
                raise
            finally:
                with self._model_lock:
                    self._rolling -= 1
            with self._model_lock:
                # Promoted fleet-wide: the predecessor is the rollback
                # target.
                self._previous_model = previous_model

    def rebuild(self, model=None, table_capacity_factor: Optional[int] = None,
                parity_tol: Optional[float] = None,
                probe_requests: Optional[List[ScoringRequest]] = None) -> None:
        """Zero-downtime background replica rebuild.  For each replica: a
        REPLACEMENT scorer at ``table_capacity_factor`` (default: double
        the current factor) is built and warmed while the old one serves;
        the FIRST replacement is canaried with mirrored traffic against the
        host oracle; then the serving path cuts over (new submissions to
        the replacement, the old batcher drains against the old scorer)
        and the router's generation bump fences the retired backend.

        A canary parity failure raises :class:`ReplicaRebuildError` with
        the fleet untouched.  ``model=None`` rebuilds on the served model;
        passing a model publishes it as :meth:`rollout` does."""
        if parity_tol is None:
            from photon_tpu_torch.game.lowp import parity_tol_for

            parity_tol = parity_tol_for(self.table_dtype)
        factor = (
            int(table_capacity_factor) if table_capacity_factor
            else max(1, self._table_capacity_factor) * 2
        )
        with self._publish_lock:
            with self._model_lock:
                previous = self.model
                published = model is not None and model is not self.model
                if published:
                    self.model = model
                    self._model_version += 1
                target = self.model
            try:
                self._rebuild_replicas(
                    target, factor, float(parity_tol), probe_requests
                )
            except BaseException:
                with self._model_lock:
                    if published:
                        self.model = previous
                        self._model_version += 1
                raise
            self._table_capacity_factor = factor
            if published:
                with self._model_lock:
                    self._previous_model = previous
        self.telemetry.counter("serving.fleet_rebuilds").inc()

    def _rebuild_replicas(self, model, factor: int, parity_tol: float,
                          probe_requests) -> None:
        live = [r for r in self.replicas if r.alive]
        if not live:
            raise RuntimeError("rebuild aborted: every replica is dead")
        probes = self._rebuild_probes(model, probe_requests)
        canary = True
        for replica in live:
            try:
                scorer = self._new_scorer(model, factor).warmup()
            except BaseException as e:
                if canary:
                    raise
                # Post-canary build failure: don't abort a half-cut-over
                # fleet — declare the replica unhealthy.
                self.router.mark_unhealthy(
                    replica, "rebuild", f"replacement build failed: {e}"
                )
                replica.abandon_pending(
                    RuntimeError(f"replica {replica.replica_id} rebuild "
                                 f"replacement failed: {e}")
                )
                continue
            if canary:
                # Mirrored-traffic canary BEFORE the replacement takes any
                # caller traffic: probe responses never reach callers.
                for req in probes:
                    worst = parity_worst(
                        scorer.score_batch(req),
                        host_score_request(model, req),
                    )
                    if worst > parity_tol:
                        raise ReplicaRebuildError(
                            f"replacement for {replica.replica_id} "
                            f"failed its canary parity probe (max "
                            f"|delta| {worst:.2e} > {parity_tol:g})"
                        )
                canary = False
            self.telemetry.counter(
                "serving.rebuild_phase", replica=replica.replica_id,
                phase="cutover",
            ).inc()
            replica.cutover_to(scorer)
            self.router.cutover(replica)

    def _rebuild_probes(self, model,
                        probe_requests) -> List[ScoringRequest]:
        """The canary's traffic sample: explicit probes, else the router's
        mirror of recent requests, else one synthetic known-answer probe."""
        probes = (
            list(probe_requests) if probe_requests
            else self.router.recent_requests()
        )
        probes = [
            p for p in probes
            if getattr(p, "model", None) is None or isinstance(p.model, str)
        ]
        if not probes:
            spec = self.replicas[0].scorer.request_spec or \
                request_spec_for_model(model)
            probes = [probe_request_for(model, spec)]
        return probes

    def rollback_to_previous(self, expected_version=None) -> bool:
        """Fleet-wide rollback to the predecessor model (one that already
        served and passed its canary), without a canary stagger: the
        version bumps, every live replica swaps back in place, and the
        predecessor slot clears so one regression cannot ping-pong.
        Returns False when there is nothing to roll back to, a rollout is
        mid-flight, or ``expected_version`` is stale."""
        with self._publish_lock:
            with self._model_lock:
                if self._previous_model is None or self._rolling:
                    return False
                if (expected_version is not None
                        and self._model_version != expected_version):
                    return False
                target = self._previous_model
                self._previous_model = None
                self.model = target
                self._model_version += 1
            for replica in self.replicas:
                if not replica.alive:
                    continue
                try:
                    replica.scorer.swap_model(target)
                except Exception as e:  # noqa: BLE001 — a replica that cannot
                    # take the restored model must not keep serving the bad one.
                    self.router.mark_unhealthy(
                        replica, "swap", f"rollback swap failed: {e}"
                    )
        self.telemetry.counter("serving.rollout_rollbacks").inc()
        return True

    def supervise(self, *args, **kwargs):
        raise not_ported("the replica supervisor (supervise)")

    def observe(self, *args, **kwargs):
        raise not_ported("the fleet observability plane (observe)")

    def serve(self, *args, **kwargs):
        raise not_ported("the TCP transport (serve)")

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self.router.close()

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
