"""Serving fleet: N scorer replicas + router + optional socket ingest.

Counterpart of ``photon_tpu/serving/fleet.py``: builds N replicas from
ONE model object, wires them behind a
:class:`~photon_tpu_torch.serving.router.FleetRouter` with deadline-aware
admission control, optionally attaches the
:class:`~photon_tpu_torch.serving.transport.ScoringServer` socket ingest
(:meth:`ServingFleet.serve`) and the self-healing
:class:`~photon_tpu_torch.serving.supervisor.ReplicaSupervisor`
(:meth:`ServingFleet.supervise`), and runs the canary rollout, the fleet
rollback and the zero-downtime rebuild.

``backend="thread"`` keeps every replica in this process (each builds its
own tables on the device from the model); ``backend="subprocess"`` runs
each replica as a child process
(:class:`~photon_tpu_torch.serving.replica_proc.SubprocessReplica`) that
loads the shared model artifact under ``workdir``.  On one card
``devices="split"`` puts every replica on the same device; each replica's
scorer has its own CUDA stream, graphs and graph memory pool (and a child
its own CUDA context).  The multi-GPU split waits for ROADMAP.md queue 1,
item 10; the observability plane for item 7.4; the multi-model arena for
item 7.5.

Residency contract: the fleet layer moves requests and models between
components — it never fetches device data itself.
"""

from __future__ import annotations

import concurrent.futures
import shutil
import tempfile
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


#: The capacity-plan refusal markers: a ``swap_model`` that cannot fit the
#: new model in the serving tables' headroom raises with ONE of these texts
#: (the scorer's plan comparison, or ``serving_table``'s vocabulary-vs-
#: capacity check underneath it) — and both survive the subprocess boundary
#: (the child's refusal travels back inside a typed error frame's message).
CAPACITY_REFUSAL_MARKERS = (
    "requires a new GameScorer",
    "rebuild the scorer instead of hot-swapping",
)


def is_capacity_refusal(exc: BaseException) -> bool:
    """Does this exception chain carry the capacity-plan refusal?  Walks
    ``__cause__``/``__context__`` so a refusal wrapped by the transport
    (TransportError) or a retry layer still matches."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        text = str(exc)
        if any(marker in text for marker in CAPACITY_REFUSAL_MARKERS):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


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

    Context-manager lifecycle; ``close()`` stops the supervisor and the
    socket ingest, drains every replica's batcher and stamps the
    per-replica QPS gauges.  ``submit``/``score`` go through admission
    control (``deadline_s`` is a relative budget; sheds raise
    :class:`~photon_tpu_torch.serving.router.RequestShedError`).

    ``backend`` picks the replica runtime: ``"thread"`` (scorers in this
    process) or ``"subprocess"`` (a child process per replica speaking the
    frame protocol over loopback, its card dealt through
    ``CUDA_VISIBLE_DEVICES``; the shared model artifact and the children's
    logs live under ``workdir``, a temporary directory by default).
    ``device`` is where the scorers run, ``cuda`` unless the caller asks
    for ``cpu``; a subprocess fleet passes it to its children.
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
        workdir: Optional[str] = None,
        child_env: Optional[Dict[str, str]] = None,
        spawn_timeout_s: float = 120.0,
        table_capacity_factor: int = 1,
        table_dtype: str = "f32",
        models: Optional[Dict[str, object]] = None,
    ):
        from photon_tpu_torch.game.lowp import check_dtype
        from photon_tpu_torch.telemetry import NULL_SESSION

        if replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        if backend not in ("thread", "subprocess"):
            raise ValueError(f"unknown replica backend {backend!r} "
                             "(thread | subprocess)")
        if models:
            raise not_ported("the multi-model arena (models=)", "7.5")
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
        self._supervisor = None
        self._server = None
        self._store = None
        self._workdir_owned = False
        self.replicas: List[ScorerReplica] = []
        if backend == "subprocess":
            self._spawn_replicas(
                model, int(replicas), workdir, child_env, spawn_timeout_s,
                max_delay_s,
            )
        else:
            for i in range(int(replicas)):
                self.replicas.append(ScorerReplica(
                    f"r{i}", self._new_scorer(model, table_capacity_factor),
                    max_batch=max_batch, max_delay_s=max_delay_s,
                    telemetry=self.telemetry,
                ))
        self.router = FleetRouter(
            self.replicas, telemetry=self.telemetry, admission=admission
        )
        self.telemetry.gauge("serving.replicas").set(int(replicas))

    def _spawn_replicas(self, model, n: int, workdir, child_env,
                        spawn_timeout_s: float, max_delay_s: float) -> None:
        from photon_tpu_torch.serving.replica_proc import (
            ModelStore,
            SubprocessReplica,
            child_device_env,
        )

        if workdir is None:
            workdir = tempfile.mkdtemp(prefix="photon-fleet-")
            self._workdir_owned = True
        self._store = ModelStore(workdir)
        self._store.publish(model)  # the v0 shared artifact
        spec = self._request_spec_cfg or request_spec_for_model(model)
        # The children's device: ``cuda`` unless the caller asks for the
        # CPU.  It is not resolved here: a child that finds no card fails
        # its own spawn.
        device = "cuda" if self.device is None else self.device

        def spawn(i: int) -> SubprocessReplica:
            env = dict(child_device_env(i, n, device))
            env.update(child_env or {})
            return SubprocessReplica(
                f"r{i}", model, self._store,
                request_spec=spec, device=device,
                buckets=self._buckets, max_batch=self._max_batch,
                min_bucket=self._min_bucket, max_delay_s=max_delay_s,
                telemetry=self.telemetry, child_env=env,
                spawn_timeout_s=spawn_timeout_s,
                table_capacity_factor=self._table_capacity_factor,
                table_dtype=self.table_dtype,
            )

        # The children start side by side: each one's interpreter, torch
        # import, CUDA start and capture overlap the others'.
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            futures = [pool.submit(spawn, i) for i in range(n)]
        errors = [f.exception() for f in futures if f.exception() is not None]
        self.replicas.extend(f.result() for f in futures if f.exception() is None)
        if errors:
            # Partial-spawn failure: a half-built fleet has no close()
            # caller — reap the children that did start and the owned
            # workdir here, or they leak past the raised error.
            for replica in self.replicas:
                try:
                    replica.close()
                except Exception:  # noqa: BLE001 — best-effort reap
                    pass
            if self._workdir_owned:
                shutil.rmtree(workdir, ignore_errors=True)
            raise errors[0]

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
        """Capture every replica's bucket ladder (a child captured its own
        at boot); after this no arrival pattern captures again."""
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
            raise not_ported("tenant routing (model=)", "7.5")
        return self.router.submit(request, deadline_s=deadline_s)

    def score(self, request: ScoringRequest,
              deadline_s: Optional[float] = None,
              model: Optional[str] = None):
        return self.submit(request, deadline_s=deadline_s,
                           model=model).result()

    def current_model(self) -> Tuple[object, int]:
        """The model the fleet serves NOW and its monotonic version — the
        supervisor's resurrection target (a replica resurrected
        mid-rollout re-syncs against this, never the model it died on)."""
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
            raise not_ported("a per-tenant rollout (model_id=)", "7.5")
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
                # Promoted fleet-wide: the predecessor is the supervisor's
                # fleet-rollback target.
                self._previous_model = previous_model

    def rollout_with_rebuild(self, model, **kwargs) -> bool:
        """Rollout that survives the capacity boundary: try the in-place
        staggered rollout first (nothing captures when the grown model
        still fits the serving tables' headroom); when the canary swap
        REFUSES for capacity (``is_capacity_refusal``), fall through to a
        zero-downtime background :meth:`rebuild` at doubled capacity.
        Returns True when a rebuild was needed, False when the plain
        rollout sufficed."""
        try:
            self.rollout(model, **kwargs)
            return False
        except BaseException as e:
            if not is_capacity_refusal(e):
                raise
        self.rebuild(
            model=model,
            probe_requests=kwargs.get("probe_requests"),
            parity_tol=kwargs.get("parity_tol"),
        )
        return True

    def rebuild(self, model=None, table_capacity_factor: Optional[int] = None,
                parity_tol: Optional[float] = None,
                probe_requests: Optional[List[ScoringRequest]] = None) -> None:
        """Zero-downtime background replica rebuild.  For each replica in
        turn: a REPLACEMENT backend (a scorer, or a child process) at
        ``table_capacity_factor`` (default: double the current factor) is
        built and warmed while the old one serves; the FIRST replacement
        is canaried with mirrored traffic against the host oracle; then
        the serving path cuts over (new submissions to the replacement,
        the old batcher drains against the old backend) and the router's
        generation bump fences the retired backend, before the next
        replica's replacement starts.

        A canary that fails to build or to match its oracle is retired and
        raises (:class:`ReplicaRebuildError` for parity) with the fleet
        untouched; a later replacement that fails to build is declared
        unhealthy (a supervisor heals it at the new factor).
        ``model=None`` rebuilds on the served model; passing a model
        publishes it as :meth:`rollout` does."""
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
                # A rebuild is a publish in flight, like a rollout: until
                # the last cutover the replicas serve the old model while
                # the fleet publishes the new one, and a supervisor that
                # read that as a fleet-wide parity regression would roll
                # the new model back the moment the rebuild finished.
                self._rolling += 1
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
            finally:
                with self._model_lock:
                    self._rolling -= 1
            self._table_capacity_factor = factor
            if published:
                with self._model_lock:
                    self._previous_model = previous
        self.telemetry.counter("serving.fleet_rebuilds").inc()

    def _rebuild_replicas(self, model, factor: int, parity_tol: float,
                          probe_requests) -> None:
        live = [r for r in self.replicas if r.alive and not r.quarantined]
        if not live:
            raise RuntimeError("rebuild aborted: every replica is dead")
        probes = self._rebuild_probes(model, probe_requests)
        canary = True
        for replica in live:
            try:
                proc, scorer = self._build_replacement(replica, model, factor)
            except BaseException as e:
                if canary:
                    raise
                # Post-canary build failure: don't abort a half-cut-over
                # fleet — declare it, and let the supervisor heal it at the
                # new factor (the replica's stored factor first).
                if hasattr(replica, "_table_capacity_factor"):
                    replica._table_capacity_factor = factor
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
                try:
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
                except BaseException:
                    self._retire_replacement(proc, scorer)
                    raise
                canary = False
            self.telemetry.counter(
                "serving.rebuild_phase", replica=replica.replica_id,
                phase="cutover",
            ).inc()
            if proc is not None:
                replica.cutover_to(scorer, proc=proc,
                                   table_capacity_factor=factor)
            else:
                replica.cutover_to(scorer)
            self.router.cutover(replica)

    def _build_replacement(self, replica, model, factor: int):
        """``(proc_or_None, warmed scorer)`` at the new capacity factor —
        the old backend serves untouched while this builds."""
        build = getattr(replica, "build_replacement", None)
        if build is not None:  # subprocess replica: a fresh child
            return build(model, factor)
        return None, self._new_scorer(model, factor).warmup()

    @staticmethod
    def _retire_replacement(proc, scorer) -> None:
        from photon_tpu_torch.serving.replica_proc import reap_process

        disconnect = getattr(scorer, "disconnect", None)
        if disconnect is not None:
            disconnect()
        reap_process(proc)

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
        served and passed its canary) — the supervisor's answer to EVERY
        replica failing its known-answer probe right after a swap — without
        a canary stagger: the version bumps, every live replica swaps back
        in place, and the predecessor slot clears so one regression cannot
        ping-pong.  Returns False when there is nothing to roll back to, a
        rollout is mid-flight, or ``expected_version`` is stale (another
        publish landed after the caller's probe evidence)."""
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

    def rollout_in_progress(self) -> bool:
        """True while a staggered rollout is mid-flight — the window in
        which different replicas legitimately serve different versions,
        so the supervisor must not read a known-answer parity mismatch
        as a replica fault."""
        with self._model_lock:
            return self._rolling > 0

    def supervise(self, policy=None, logger=None, start: bool = True):
        """Attach the self-healing supervisor (health probes, canary-gated
        resurrection, flap quarantine); returns the
        :class:`~photon_tpu_torch.serving.supervisor.ReplicaSupervisor`.
        With ``start=False`` the supervisor is built but not threaded —
        tests drive ``check_once()`` deterministically.  Without an
        explicit policy, the known-answer/rejoin parity gates default to
        the fleet's table-dtype bound."""
        from photon_tpu_torch.serving.supervisor import (
            ReplicaSupervisor,
            SupervisorPolicy,
        )

        if self._supervisor is not None:
            raise RuntimeError("fleet already supervised")
        if policy is None and self.table_dtype != "f32":
            from photon_tpu_torch.game.lowp import parity_tol_for

            policy = SupervisorPolicy(
                parity_tol=parity_tol_for(self.table_dtype)
            )
        self._supervisor = ReplicaSupervisor(
            self, policy=policy, telemetry=self.telemetry, logger=logger
        )
        if start:
            self._supervisor.start()
        return self._supervisor

    def observe(self, *args, **kwargs):
        raise not_ported("the fleet observability plane (observe)", "7.4")

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """Attach the socket ingest; returns the
        :class:`~photon_tpu_torch.serving.transport.ScoringServer` (its
        ``.address`` is the bound ``(host, port)``)."""
        from photon_tpu_torch.serving.transport import ScoringServer

        if self._server is not None:
            raise RuntimeError("fleet already serving")
        self._server = ScoringServer(
            self.router, host=host, port=port, telemetry=self.telemetry
        )
        return self._server

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        # The supervisor stops FIRST: a teardown must not race a
        # resurrection re-spawning the replicas being closed.
        if self._supervisor is not None:
            self._supervisor.stop()
            self._supervisor = None
        if self._server is not None:
            self._server.close()
            self._server = None
        self.router.close()
        if self._workdir_owned and self._store is not None:
            shutil.rmtree(self._store.workdir, ignore_errors=True)
            self._store = None

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
