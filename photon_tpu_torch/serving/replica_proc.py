"""Process-backed serving replicas: own runtime, frame protocol, respawn.

Counterpart of ``photon_tpu/serving/replica_proc.py``.  A thread replica
shares one Python runtime with the rest of the fleet; this module gives
each replica a process of its own:

- **The child** (``python -m photon_tpu_torch.serving.replica_proc``) is a
  full replica runtime: it loads the shared model ARTIFACT (the wire-format
  model file every replica of a fleet reads), builds its own
  :class:`~photon_tpu_torch.serving.scorer.GameScorer` on the device its
  config names (its own CUDA context, stream, graphs and graph pool on the
  card), captures the bucket ladder, then serves the length-prefixed frame
  protocol on a loopback socket — ``score`` frames on the data
  connection, plus the supervision vocabulary on a control connection:
  ``ping``/``pong`` (liveness), ``stats`` (the child's counters, captures,
  allocator segments, kernel launches and card memory), ``spans``, ``swap`` (hot-swap to a
  newer model artifact into the captured tables) and ``shutdown``.  A
  child configured for ``cuda`` that finds no card fails its start; it
  never scores on the CPU instead.
- **The parent side** (:class:`SubprocessReplica`) is a drop-in
  :class:`~photon_tpu_torch.serving.router.ScorerReplica`: the router's
  batcher coalesces requests exactly as for a thread replica, and the
  replica's "scorer" (:class:`_RemoteScorer`) exchanges each micro-batch
  as one frame on the data connection.  A dropped connection mid-batch is
  the crash signal: the batch raises
  :class:`~photon_tpu_torch.serving.router.ReplicaDeadError` and the
  router reroutes it exactly once.  Children start through
  ``subprocess.Popen`` of a fresh interpreter, never a fork, so a parent
  that holds a CUDA context can spawn them.
- **Fault surface**: ``replica:spawn`` fires at the top of every (re)spawn
  (retriable — the supervisor backs off and retries); ``replica:crash``
  consumed INSIDE the child hard-exits it (``os._exit``), a real crash
  with a real exit code; ``replica:hang`` consumed in the child wedges the
  handler, a real hang only the supervisor's probe deadline can see.

The multi-model child (``models=``) hosts an arena and waits with it in
ROADMAP.md queue 1, item 7.5.

Residency contract (``tools/check_host_sync.py`` guards this module): the
parent side is pure host IO (frames, numpy); the one sanctioned fetch is
the artifact publish, which copies the model tables to the host once per
published version.  Scores leave the child as host numpy after the
scorer's one wait a batch.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.fault.injection import (
    InjectedKillError,
    consume_hang_injection,
    fault_point,
)
from photon_tpu_torch.ops import launch_counts
from photon_tpu_torch.serving.netfault import maybe_shim
from photon_tpu_torch.serving.router import (
    ReplicaDeadError,
    ScorerReplica,
    not_ported,
)
from photon_tpu_torch.serving.scorer import (
    ShardSpec,
    bucket_ladder,
    padded_cost,
)
from photon_tpu_torch.serving.transport import (
    TransportError,
    _decode_response,
    _pack,
    _unpack,
    pack_control,
    pack_error,
    pack_request,
    pack_scores,
    payload_kind,
    read_frame,
    unpack_control,
    unpack_request_hx,
    write_frame,
)
from photon_tpu_torch.telemetry.distributed import (
    FlightRecorder,
    MergeableHistogram,
    SpanRecord,
    rider_hops,
    shift_span_times,
    trace_of,
)

ARTIFACT_VERSION = 1
CRASH_EXIT_CODE = 86  # the child's injected-crash exit status
# The directory holding the package: prepended to the child's PYTHONPATH so
# the child imports the same copy of the port as its parent.
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ReplicaSpawnError(OSError):
    """Spawning a replica child failed (an ``OSError``: the supervisor's
    backoff-and-retry policy applies to a failed spawn exactly as the
    retry layer's does to failed IO).  The message names the child's
    log."""


# -- model wire artifact -------------------------------------------------------
#
# The shared model artifact every child loads (at boot and at swap) is ONE
# frame payload — the same header + array-manifest wire format the scoring
# protocol uses, byte for byte the reference package's: fixed coordinates
# carry their coefficient vector, random coordinates their [entities, dim]
# table and sorted key vocabulary (string keys ride as their <U* buffers
# like any id column).  Serving needs means only; the artifact drops
# variances.


def _host_f32(t) -> np.ndarray:
    # host-sync: artifact publish — a model tensor is copied to the host
    # once per published model version.
    return t.detach().to("cpu", torch.float32).contiguous().numpy()


def pack_model(model, version: int) -> bytes:
    """One GAME model as a wire payload (the shared serving artifact)."""
    from photon_tpu_torch.game.model import FixedEffectModel, RandomEffectModel

    entries = []
    meta = []
    for name, coord in model.coordinates.items():
        if isinstance(coord, FixedEffectModel):
            meta.append({"name": name, "kind": "fixed",
                         "shard": coord.shard_name,
                         "task": coord.model.task_type})
            entries.append(("coef", name, _host_f32(coord.coefficients.means)))
        elif isinstance(coord, RandomEffectModel):
            meta.append({"name": name, "kind": "random",
                         "shard": coord.shard_name,
                         "column": coord.entity_column,
                         "task": coord.task_type})
            entries.append(("table", name, _host_f32(coord.table)))
            entries.append(("keys", name, np.asarray(coord.keys)))
        else:
            raise TypeError(f"cannot publish a {type(coord).__name__}")
    return _pack({
        "v": ARTIFACT_VERSION, "kind": "model",
        "task": model.task_type, "version": int(version), "coords": meta,
        "_arrays": entries,
    })


def unpack_model(payload: bytes, device=None):
    """``(GameModel, version)`` from a model artifact payload, its tables
    on ``device`` (``cuda`` unless the caller asks for ``cpu``)."""
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.game.model import (
        FixedEffectModel,
        GameModel,
        RandomEffectModel,
    )
    from photon_tpu_torch.models.glm import Coefficients, model_for_task

    dev = resolve_device(device)
    header, arrays = _unpack(payload)
    if header.get("kind") != "model":
        raise TransportError(
            f"unexpected artifact kind {header.get('kind')!r}"
        )
    slots: Dict[Tuple[str, str], np.ndarray] = {}
    for entry, arr in zip(header.get("arrays", []), arrays):
        slots[(entry["slot"], entry["name"])] = arr

    def put(arr):
        # The wire arrays are read-only views of the payload: copy.
        return torch.tensor(np.array(arr, np.float32), device=dev)

    coordinates = {}
    for meta in header["coords"]:
        name = meta["name"]
        if meta["kind"] == "fixed":
            coordinates[name] = FixedEffectModel(
                model_for_task(
                    meta["task"], Coefficients(put(slots[("coef", name)]))
                ),
                meta["shard"],
            )
        else:
            coordinates[name] = RandomEffectModel(
                table=put(slots[("table", name)]),
                keys=np.array(slots[("keys", name)]),
                entity_column=meta["column"],
                shard_name=meta["shard"],
                task_type=meta["task"],
            )
    model = GameModel(coordinates=coordinates, task_type=header["task"])
    return model, int(header.get("version", 0))


def save_model_artifact(path: str, model, version: int) -> None:
    """Atomic artifact publish: temp + fsync + rename, so a reader (a
    booting child) sees the previous complete artifact or the new one."""
    payload = pack_model(model, version)
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp",
        dir=os.path.dirname(path) or ".",
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_model_artifact(path: str, telemetry=None, device=None):
    """``(GameModel, version)`` from an artifact file (retried like any
    guarded model load), its tables on ``device``."""
    from photon_tpu_torch.fault.retry import retry_call

    def attempt():
        with open(path, "rb") as f:
            return f.read()

    return unpack_model(
        retry_call(attempt, site="model:load", telemetry=telemetry),
        device=device,
    )


class ModelStore:
    """Versioned shared model artifacts under one fleet workdir.

    ``publish()`` writes the wire-format artifact ONCE per model object
    (cached by identity, with a strong reference so the cache key cannot
    be recycled) and returns its path+version; every child — at boot, at
    swap, at respawn — loads from the same file.

    Only the newest ``keep`` versions stay cached (default 2: the served
    model plus its predecessor, which an in-flight swap/rollback may
    still reference) — a long-running fleet rolling models out
    periodically must not grow host memory and workdir disk by one full
    table set per rollout forever.  Re-publishing an evicted model (a
    deep rollback) simply writes it again under a fresh version."""

    def __init__(self, workdir: str, keep: int = 2):
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.keep = max(1, int(keep))
        self._lock = threading.Lock()
        self._published = []  # [(model, path, version)] — strong refs
        self._next = 0

    def publish(self, model) -> Tuple[str, int]:
        with self._lock:
            for m, path, version in self._published:
                if m is model:
                    return path, version
            version = self._next
            self._next += 1
            path = os.path.join(self.workdir, f"model-v{version:06d}.bin")
            save_model_artifact(path, model, version)
            self._published.append((model, path, version))
            while len(self._published) > self.keep:
                _, old_path, _ = self._published.pop(0)
                try:
                    os.unlink(old_path)
                except OSError:
                    pass
            return path, version


# -- the child runtime ---------------------------------------------------------


def device_memory(device) -> dict:
    """What this process holds on ``device``: the caching allocator's
    reserved bytes, its peak allocated bytes, and the segments it has ever
    allocated (a segment after warmup is a new device allocation on the
    serving path).  Zeros on the CPU."""
    if device.type != "cuda":
        return {"memory_reserved": 0, "max_memory_allocated": 0,
                "segments": 0}
    return {
        "memory_reserved": int(torch.cuda.memory_reserved(device)),
        "max_memory_allocated": int(torch.cuda.max_memory_allocated(device)),
        "segments": int(torch.cuda.memory_stats(device).get(
            "segment.all.allocated", 0)),
    }


class _ChildService:
    """The replica child's state: one scorer (+ artifact version) behind a
    lock so a ``swap`` and a concurrent ``score`` can never interleave a
    half-published model (the scorer's own locked publication does the
    real work; the lock only orders version bookkeeping).

    ``telemetry`` is the child's own in-process registry: the scorer's
    ``serving.*`` counters (host_syncs, batches, cold_entities, ...)
    accrue HERE, in the child — the ``stats`` control frame is how they
    reach the parent's run report."""

    def __init__(self, replica_id: str, scorer, version: int,
                 telemetry=None, flight_path: Optional[str] = None,
                 generation: int = 0):
        from collections import deque

        from photon_tpu_torch.telemetry import NULL_SESSION

        self.replica_id = replica_id
        self.scorer = scorer
        self.version = version
        # Membership generation: seeded from the spawn config, then
        # ratcheted to the max stamp seen on any inbound frame — the child
        # adopts the parent's view and ECHOES its own on every response,
        # so a zombie (a child whose lease expired while a newer
        # generation took over) keeps answering with a stale stamp the
        # parent's exchange loop fences.
        self.generation = int(generation)
        self.telemetry = telemetry or NULL_SESSION
        self.lock = threading.Lock()
        # Observability: the crash flight recorder (flushed to
        # ``flight_path`` at traced-frame ingress, BEFORE scoring — so a
        # SIGKILL mid-batch still leaves the victim's last accepted work
        # on disk), the mergeable compute-latency histogram the parent
        # aggregates fleet-wide, and the overflow queue for spans whose
        # response frame could not carry them (error paths).
        self.process = f"replica-{replica_id}:{os.getpid()}"
        self.flight_path = flight_path
        self.flight = FlightRecorder(self.process)
        self.latency_hist = MergeableHistogram()
        self._pending_spans: deque = deque(maxlen=256)
        self._spans_lock = threading.Lock()

    def _flush_flight(self) -> None:
        if not self.flight_path:
            return
        try:
            self.flight.dump(self.flight_path)
        except OSError:
            pass  # a full disk must not fail the scoring path

    def _drain_spans(self) -> list:
        with self._spans_lock:
            out = list(self._pending_spans)
            self._pending_spans.clear()
        return out

    def _score_frame(self, payload: bytes) -> bytes:
        """One scoring exchange, with the traced-request hop recorded: a
        request carrying a wire trace context gets a child span (ingress →
        compute → egress) shipped back inline on the response header."""
        self.flight.note_frame("in", "score", len(payload))
        self.maybe_fault()
        request, _, seq, rheader = unpack_request_hx(payload)
        gen = rheader.get("gen")
        if gen is not None:
            self.generation = max(self.generation, int(gen))
        ctx = trace_of(request)
        span = None
        if ctx is not None:
            span = SpanRecord(ctx.trace_id, "replica.score", self.process,
                              parent_id=ctx.span_id)
            span.event("ingress", rows=request.num_rows,
                       nbytes=len(payload))
            self.flight.note_span(span, "open")
            self._flush_flight()
        t0 = time.monotonic()
        try:
            if span is not None:
                span.event("compute_begin")
            scores = self.scorer.score_batch(request)
            if span is not None:
                span.event("compute_end")
        except BaseException as e:
            if span is not None:
                span.finish(status="error")
                self.flight.note_span(span, "close")
                with self._spans_lock:
                    self._pending_spans.append(span.to_dict())
            # Echo ``seq`` on the error frame: the parent's seq-matching
            # exchange loop would FENCE a seq-less reply and resend until
            # its deadline — a scoring failure must settle the exchange
            # that caused it, not starve it.
            return pack_error(f"{type(e).__name__}: {e}", seq=seq)
        self.latency_hist.observe(time.monotonic() - t0)
        meta = {"version": self.version, "gen": self.generation}
        if span is not None:
            span.event("egress")
            span.attrs["rows"] = request.num_rows
            span.attrs["version"] = self.version
            span.finish()
            self.flight.note_span(span, "close")
            meta["spans"] = [span.to_dict()] + self._drain_spans()
        return pack_scores(scores, seq=seq, meta=meta)

    def serving_counters(self) -> list:
        """This child's scorer-level ``serving.*`` counters as JSON-ready
        ``{name, labels, value}`` rows — the ``stats`` frame payload.
        Values are CUMULATIVE for the child's lifetime; the parent merges
        deltas, so repeated pulls never double-count."""
        snapshot = self.telemetry.registry.snapshot()
        return [
            {"name": m["name"], "labels": dict(m.get("labels") or {}),
             "value": float(m["value"])}
            for m in snapshot.get("counters", [])
            if m["name"].startswith("serving.")
        ]

    def maybe_fault(self) -> None:
        """The child-side fault surface: an injected ``replica:crash``
        HARD-EXITS the child (a real crash with a real exit code — the
        supervisor sees it via ``poll_exit``/the dropped connection), an
        injected ``replica:hang`` wedges this handler thread (a real hang
        only the probe deadline can see; the supervisor kills the child)."""
        try:
            fault_point("replica:crash", replica=self.replica_id)
        except InjectedKillError:
            os._exit(CRASH_EXIT_CODE)
        if consume_hang_injection(self.replica_id):
            time.sleep(3600.0)

    def handle(self, sock: socket.socket, shutdown) -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                payload = read_frame(sock)
            except (OSError, TransportError):
                return
            kind = payload_kind(payload)
            # Control frames echo the caller's ``seq`` (and the pong its
            # generation): the parent's exchange loops discard stale
            # replies left in the pipe by a timed-out earlier exchange —
            # without the echo, a late pong could satisfy the WRONG ping
            # and poison the clock-offset estimate.
            seq = None
            try:
                if kind == "score":
                    out = self._score_frame(payload)
                elif kind == "ping":
                    self.maybe_fault()
                    header = unpack_control(payload)
                    seq = header.get("seq")
                    gen = header.get("gen")
                    if gen is not None:
                        self.generation = max(self.generation, int(gen))
                    out = pack_control(
                        "pong", version=self.version, pid=os.getpid(),
                        compilations=self.scorer.compilations,
                        seq=seq, gen=self.generation,
                        # Clock-offset estimation: the child's wall clock,
                        # sampled mid-exchange — the parent subtracts the
                        # RTT midpoint to estimate this host's skew and
                        # de-skews child span timestamps before merging.
                        child_time=time.time(),
                    )
                elif kind == "stats":
                    # Deliberately NOT behind maybe_fault: a stats pull is
                    # advisory telemetry, not a liveness probe.
                    seq = unpack_control(payload).get("seq")
                    out = pack_control(
                        "stats", version=self.version,
                        counters=self.serving_counters(),
                        hist=self.latency_hist.snapshot(),
                        seq=seq, device=str(self.scorer.device),
                        captures=self.scorer.compilations,
                        kernel_launches=launch_counts(),
                        **device_memory(self.scorer.device),
                    )
                elif kind == "spans":
                    # Drain completed-but-unshipped spans (error paths) —
                    # advisory like stats, so NOT behind maybe_fault.
                    seq = unpack_control(payload).get("seq")
                    out = pack_control("spans", spans=self._drain_spans(),
                                       seq=seq)
                elif kind == "swap":
                    header = unpack_control(payload)
                    seq = header.get("seq")
                    if header.get("model_id") is not None:
                        raise not_ported("a per-tenant swap (model_id=)",
                                         "7.5")
                    model, version = load_model_artifact(
                        header["path"], device=self.scorer.device)
                    with self.lock:
                        self.scorer.swap_model(model)
                        self.version = version
                    out = pack_control("ok", version=version, seq=seq)
                elif kind == "shutdown":
                    seq = unpack_control(payload).get("seq")
                    out = pack_control("ok", seq=seq)
                    try:
                        write_frame(sock, out)
                    except OSError:
                        pass
                    shutdown()
                    return
                else:
                    out = pack_error(f"unknown frame kind {kind!r}")
            except BaseException as e:  # surfaced as a typed frame
                out = pack_error(f"{type(e).__name__}: {e}", seq=seq)
            try:
                write_frame(sock, out)
            except OSError:
                return


def _child_main(argv=None) -> None:
    import argparse
    import socketserver

    p = argparse.ArgumentParser("photon_tpu_torch.serving.replica_proc")
    p.add_argument("--artifact", default=None)
    p.add_argument("--ready-file", required=True)
    p.add_argument("--config", required=True, help="JSON replica config")
    args = p.parse_args(argv)
    cfg = json.loads(args.config)

    # Parent-death watchdog: the parent holds our stdin pipe open for our
    # whole life and never writes to it — EOF means the parent is GONE
    # (crashed, SIGKILLed, or torn down racing a respawn), and an orphaned
    # replica serving nobody forever is a resource leak, not availability.
    def watch_parent():
        try:
            sys.stdin.buffer.read()
        except Exception:  # noqa: BLE001 — any stdin failure == orphaned
            pass
        os._exit(0)

    threading.Thread(target=watch_parent, name="parent-watch",
                     daemon=True).start()

    if cfg.get("models"):
        raise not_ported("the multi-model child (models=)", "7.5")

    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.serving.scorer import GameScorer
    from photon_tpu_torch.telemetry import TelemetrySession

    # The device the parent named: ``cuda`` without a card raises here and
    # the spawn fails — a child never scores on the CPU in its place.
    device = resolve_device(cfg.get("device", "cuda"))
    spec = {
        shard: ShardSpec(kind=s["kind"], dim=int(s["dim"]),
                         nnz=int(s.get("nnz", 0)))
        for shard, s in cfg["spec"].items()
    }
    # The child's own registry: scorer counters accrue in THIS process and
    # travel to the parent via the stats frame — never written to disk
    # here (the parent's run report is the one report of the fleet).
    session = TelemetrySession(f"replica-{cfg['replica_id']}")
    t0 = time.monotonic()
    model, version = load_model_artifact(args.artifact, device=device)
    scorer = GameScorer(
        model,
        device=device,
        request_spec=spec,
        buckets=tuple(cfg["buckets"]) if cfg.get("buckets") else None,
        max_batch=int(cfg["max_batch"]),
        min_bucket=int(cfg["min_bucket"]),
        telemetry=session,
        table_capacity_factor=int(cfg.get("table_capacity_factor", 1)),
        table_dtype=cfg.get("table_dtype", "f32"),
    ).warmup()
    warmup_s = time.monotonic() - t0
    service = _ChildService(cfg["replica_id"], scorer, version,
                            telemetry=session,
                            flight_path=cfg.get("flight_path"),
                            generation=int(cfg.get("generation", 0)))

    class _Handler(socketserver.BaseRequestHandler):
        def handle(self):  # noqa: D102 — per-connection loop
            service.handle(self.request, shutdown)

    class _Server(socketserver.ThreadingTCPServer):
        daemon_threads = True
        allow_reuse_address = True

    server = _Server(("127.0.0.1", 0), _Handler)

    def shutdown():
        threading.Thread(target=server.shutdown, daemon=True).start()

    # Atomic readiness handshake: the parent polls for this file.
    ready = {
        "port": server.server_address[1],
        "pid": os.getpid(),
        "version": version,
        "compilations": scorer.compilations,
        "device": str(device),
        "warmup_s": warmup_s,
        "kernel_launches": launch_counts(),
        **device_memory(device),
    }
    tmp = args.ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ready, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, args.ready_file)
    server.serve_forever()
    server.server_close()


# -- the parent side -----------------------------------------------------------


def child_device_env(index: int, n_replicas: int, device) -> Dict[str, str]:
    """The per-child device deal.  On ``cuda`` each child owns a
    round-robin slice of the visible cards through
    ``CUDA_VISIBLE_DEVICES``, cut from the PARENT'S OWN mask when one is
    set (``CUDA_VISIBLE_DEVICES=2,3`` must deal ``2``/``3`` to the
    children, never absolute ids the job was fenced away from), else from
    ``range(torch.cuda.device_count())``.  On one card every child gets
    ``0``: the replicas share it, each with its own CUDA context.  A
    ``cpu`` child is dealt no card."""
    if torch.device(device).type != "cuda":
        return {"CUDA_VISIBLE_DEVICES": ""}
    mask = os.environ.get("CUDA_VISIBLE_DEVICES", "").strip()
    if mask:
        ids = [t.strip() for t in mask.split(",") if t.strip()]
    else:
        ids = [str(i) for i in range(torch.cuda.device_count())]
    if not ids:
        # No card to deal: the child starts on cuda, finds none and fails
        # its spawn.
        return {"CUDA_VISIBLE_DEVICES": ""}
    mine = ids[index % len(ids):: n_replicas] or [ids[index % len(ids)]]
    return {"CUDA_VISIBLE_DEVICES": ",".join(mine)}


class _RemoteScorer:
    """Parent-side facade of a child's scorer: mirrors the GameScorer
    surface the replica/batcher/router layers touch (bucket ladder, model,
    compilations, warmup, swap) while ``score_batch`` is one frame
    exchange on the data connection.  A dropped/reset connection raises
    :class:`ReplicaDeadError` — the crash signal the router reroutes on."""

    def __init__(self, replica_id: str, model, version: int,
                 store: ModelStore, request_spec: Dict[str, ShardSpec],
                 buckets, max_batch: int, min_bucket: int,
                 port: int, compilations: int, telemetry=None,
                 timeout_s: float = 300.0, span_sink=None,
                 table_dtype: str = "f32", generation: int = 0,
                 ready: Optional[dict] = None):
        from photon_tpu_torch.telemetry import NULL_SESSION

        self.replica_id = replica_id
        self.model = model
        # Membership generation: stamped on every request and ping; the
        # child echoes the stamp on responses, and a response whose stamp
        # disagrees is FENCED — a zombie child (dead-declared but still
        # answering) cannot satisfy a live exchange.
        self.generation = int(generation)
        self.version = version
        # The child's ready record (device, captures, allocator segments
        # and card memory at warmup) and its last stats frame.
        self.ready = dict(ready or {})
        self.last_stats: Optional[dict] = None
        # Estimated child-minus-parent wall-clock offset (EWMA over ping
        # RTT midpoints) — applied to child span timestamps before they
        # merge into the parent's trace tree.
        self.clock_offset_s = 0.0
        # Mirrors the child scorer's storage tier so parent-side parity
        # gates (router canary histogram, fleet defaults) see one surface.
        self.table_dtype = str(table_dtype)
        # Observability: completed child spans piggybacked on response
        # headers (or pulled via the ``spans`` control frame) go here; the
        # last shipped histogram snapshot is what an observer aggregates.
        self.span_sink = span_sink
        self.last_hist_snapshot: Optional[dict] = None
        self.request_spec = request_spec
        self.buckets = bucket_ladder(buckets, max_batch, min_bucket)
        self.max_bucket = self.buckets[-1]
        self.compilations = int(compilations)
        self.telemetry = telemetry or NULL_SESSION
        self._store = store
        self._data_lock = threading.Lock()
        self._ctrl_lock = threading.Lock()
        # Last-seen child counter values per (name, labels) — the delta
        # base for stats pulls.  Lives on the scorer (fresh per spawned
        # child), so a respawned child's counters restarting at zero can
        # never produce negative deltas.  The lock serializes WHOLE pulls
        # (exchange + read-merge-update): a supervisor-thread pull racing
        # a direct pull_stats()/close() must not compute two deltas from
        # one stale base and double-count into the parent registry.
        self._stats_seen: Dict[tuple, float] = {}
        self._stats_lock = threading.Lock()
        # Exchange bookkeeping: every request/ping carries a
        # process-unique seq the child echoes; on a per-attempt timeout
        # the exchange RESENDS (the frame may have been black-holed by a
        # partition) until ``resend_deadline_s``, fencing any stale-seq
        # replies a prior timed-out attempt left in the pipe.  A dropped
        # CONNECTION (vs. dropped frame) gets one silent reconnect per
        # exchange — rejoin-within-lease, not death.
        self._seq = itertools.count(1)
        self._port = int(port)
        self._timeout_s = float(timeout_s)
        self._closed = False
        self.exchange_timeout_s = 30.0
        self.resend_deadline_s = float(timeout_s)
        self._data = self._connect(port, timeout_s, "data")
        self._ctrl = self._connect(port, timeout_s, "ctrl")

    def _connect(self, port: int, timeout_s: float, chan: str):
        sock = socket.create_connection(("127.0.0.1", port),
                                        timeout=timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Chaos seam: an installed NetFaultPlan wraps this socket so every
        # partition/duplicate/reorder scenario is reproducible.
        return maybe_shim(sock, f"{self.replica_id}:{chan}")

    def _reconnect(self, chan: str):
        """Silent rejoin within the lease window: a dropped control or
        data connection is NOT death — dial the same child again and let
        the caller resend.  Refused (child actually gone) raises, which
        the exchange surfaces as :class:`ReplicaDeadError`."""
        if self._closed:
            raise ConnectionError(
                f"replica {self.replica_id} scorer is disconnected"
            )
        old = self._data if chan == "data" else self._ctrl
        try:
            old.close()
        except OSError:
            pass
        sock = self._connect(self._port, self._timeout_s, chan)
        if chan == "data":
            self._data = sock
        else:
            self._ctrl = sock
        self.telemetry.counter("serving.replica_reconnects",
                               replica=self.replica_id, chan=chan).inc()
        return sock

    # -- GameScorer surface ---------------------------------------------------
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} rows exceeds max bucket "
                         f"{self.max_bucket}")

    def padded_rows(self, n: int) -> int:
        return padded_cost(n, self.buckets)

    def warmup(self) -> "_RemoteScorer":
        return self  # the child captured its ladder at boot

    def score_batch(self, request) -> np.ndarray:
        seq = next(self._seq)
        payload = pack_request(request, seq=seq, gen=self.generation)
        try:
            with self._data_lock:
                scores, header = self._exchange_scores(payload, seq)
        except (socket.timeout, OSError) as e:
            raise ReplicaDeadError(
                f"replica {self.replica_id} child connection lost: {e}"
            ) from e
        spans = header.get("spans")
        if spans and self.span_sink is not None:
            try:
                self.span_sink(spans + rider_hops(request, spans))
            except Exception:  # noqa: BLE001 — span delivery is advisory
                pass
        return scores

    def _exchange_scores(self, payload: bytes, seq: int):
        """One at-least-once scoring exchange with fencing: send, then
        read until a response matching ``seq`` AND the current generation
        arrives.  A per-attempt ``exchange_timeout_s`` silence means the
        frame (either direction) may be black-holed — resend until
        ``resend_deadline_s``.  Duplicated/stale-seq replies are discarded
        and counted; a matching reply stamped with a STALE generation
        raises :class:`ReplicaDeadError` (the zombie fence — the router
        reroutes, exactly-once preserved).  Duplicate sends are safe: the
        child may score a request twice, but only ONE reply per seq ever
        settles the exchange."""
        deadline = time.monotonic() + self.resend_deadline_s
        reconnected = False
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ConnectionError(
                    f"no matching response for seq {seq} within "
                    f"{self.resend_deadline_s:g}s"
                )
            try:
                self._data.settimeout(
                    min(self.exchange_timeout_s, max(remaining, 0.05))
                )
                write_frame(self._data, payload)
                while True:
                    rseq, scores, exc, header = _decode_response(
                        read_frame(self._data)
                    )
                    if rseq is None:
                        if exc is not None:
                            raise exc  # seq-less child failure: backstop
                        continue
                    if int(rseq) != seq:
                        self.telemetry.counter(
                            "serving.fenced_responses",
                            replica=self.replica_id, reason="stale_seq",
                        ).inc()
                        continue
                    rgen = header.get("gen")
                    if rgen is not None and int(rgen) != int(self.generation):
                        self.telemetry.counter(
                            "serving.fenced_responses",
                            replica=self.replica_id, reason="stale_gen",
                        ).inc()
                        raise ReplicaDeadError(
                            f"replica {self.replica_id} answered from stale "
                            f"generation {rgen} (current {self.generation}) "
                            f"— response fenced"
                        )
                    if exc is not None:
                        raise exc
                    return scores, header
            except socket.timeout:
                self.telemetry.counter(
                    "serving.exchange_resends", replica=self.replica_id
                ).inc()
                continue
            except OSError:
                if reconnected or self._closed:
                    raise
                reconnected = True
                self._reconnect("data")
                continue

    def swap_model(self, model) -> None:
        """Hot-swap the CHILD to a newer model: publish the shared
        artifact (cached per model object — one file serves every replica
        of the fleet) and instruct the child over the control connection.
        The child's scorer copies it into its captured tables — nothing
        captures again, with the same refusal semantics as a thread
        replica."""
        path, version = self._store.publish(model)
        header = self._ctrl_exchange("swap", path=path, version=version)
        if header.get("kind") != "ok":
            raise TransportError(
                f"swap refused: unexpected reply {header.get('kind')!r}"
            )
        self.model = model
        self.version = version

    def _ctrl_exchange(self, kind: str, **fields) -> dict:
        """One seq-tagged control exchange: send, then read until the
        reply echoes our seq (discarding stale replies a timed-out
        earlier exchange left in the pipe — counted as fenced)."""
        seq = next(self._seq)
        with self._ctrl_lock:
            write_frame(self._ctrl, pack_control(kind, seq=seq, **fields))
            while True:
                header = unpack_control(read_frame(self._ctrl))
                if header.get("seq") in (None, seq):
                    return header
                self.telemetry.counter(
                    "serving.fenced_responses",
                    replica=self.replica_id, reason="stale_ctrl",
                ).inc()

    # -- supervision ----------------------------------------------------------
    def ping(self, deadline_s: float, gen: Optional[int] = None) -> dict:
        """Liveness ping — the LEASE RENEWAL exchange.  The ping carries a
        ``seq`` (stale pongs from timed-out earlier probes are fenced, not
        mistaken for this renewal) and the membership generation stamp
        the child adopts; the deadline rides the socket (so a silent
        partition surfaces as ``socket.timeout`` promptly and RELEASES the
        control lock — the next probe after heal can renew), with the
        watchdog's ``call_with_timeout`` as the backstop for a wedged
        write.  A dropped control connection gets one silent reconnect —
        rejoin within the lease, not death.

        Each pong doubles as a clock-offset sample: the child echoes its
        wall clock, and ``child_time - (t_send + t_recv)/2`` estimates
        this child's skew (the RTT-midpoint trick).  An EWMA smooths
        jitter; the offset de-skews child span timestamps before trace
        merge.  The pong also refreshes ``compilations``."""
        from photon_tpu_torch.fault.watchdog import call_with_timeout

        seq = next(self._seq)
        stamp = self.generation if gen is None else int(gen)

        def exchange():
            with self._ctrl_lock:
                deadline = time.monotonic() + deadline_s
                reconnected = False
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise socket.timeout(
                            f"ping seq {seq} unanswered within "
                            f"{deadline_s:g}s"
                        )
                    try:
                        self._ctrl.settimeout(max(remaining, 0.05))
                        t_send = time.time()
                        write_frame(
                            self._ctrl,
                            pack_control("ping", seq=seq, gen=stamp),
                        )
                        while True:
                            header = unpack_control(read_frame(self._ctrl))
                            if header.get("seq") in (None, seq):
                                break
                            self.telemetry.counter(
                                "serving.fenced_responses",
                                replica=self.replica_id,
                                reason="stale_pong",
                            ).inc()
                        t_recv = time.time()
                        break
                    except socket.timeout:
                        raise
                    except OSError:
                        if reconnected or self._closed:
                            raise
                        reconnected = True
                        self._reconnect("ctrl")
            child_time = header.get("child_time")
            if isinstance(child_time, (int, float)):
                sample = float(child_time) - (t_send + t_recv) / 2.0
                self.clock_offset_s = (
                    sample if self.clock_offset_s == 0.0
                    else 0.8 * self.clock_offset_s + 0.2 * sample
                )
            comps = header.get("compilations")
            if comps is not None:
                self.compilations = int(comps)
            return header

        return call_with_timeout(
            exchange, deadline_s + 1.0, site=f"replica:{self.replica_id}:ping"
        )

    def stats(self, deadline_s: float = 5.0) -> list:
        """Pull the child's cumulative ``serving.*`` counters over the
        control connection (the ``stats`` frame), deadline-bounded like
        the ping: a wedged child must not hang the supervisor's stats
        pass.  The whole frame (captures, allocator segments, card
        memory) stays in :attr:`last_stats`."""
        from photon_tpu_torch.fault.watchdog import call_with_timeout

        header = call_with_timeout(
            lambda: self._ctrl_exchange("stats"),
            deadline_s, site=f"replica:{self.replica_id}:stats"
        )
        self.last_hist_snapshot = header.get("hist") or self.last_hist_snapshot
        self.last_stats = header
        return header.get("counters", [])

    def pull_spans(self, deadline_s: float = 5.0) -> list:
        """Drain the child's completed-but-unshipped spans (error paths)
        over the control connection — deadline-bounded like every other
        control exchange."""
        from photon_tpu_torch.fault.watchdog import call_with_timeout

        header = call_with_timeout(
            lambda: self._ctrl_exchange("spans"),
            deadline_s, site=f"replica:{self.replica_id}:spans"
        )
        return header.get("spans", [])

    def shutdown(self, deadline_s: float = 5.0) -> None:
        from photon_tpu_torch.fault.watchdog import call_with_timeout

        call_with_timeout(lambda: self._ctrl_exchange("shutdown"),
                          deadline_s,
                          site=f"replica:{self.replica_id}:shutdown")

    def disconnect(self) -> None:
        # Latch first: a batcher thread mid-exchange must NOT dial the
        # (possibly respawned-on-the-same-port) child back after teardown.
        self._closed = True
        for sock in (self._data, self._ctrl):
            try:
                sock.close()
            except OSError:
                pass


class SubprocessReplica(ScorerReplica):
    """A serving replica whose runtime is a CHILD PROCESS — its own Python
    and torch runtime, its own CUDA context on the card it is dealt (via
    the spawn environment), speaking the frame protocol to the router over
    loopback sockets.

    Drop-in for :class:`ScorerReplica`: the router dispatches, sheds,
    reroutes, and rolls out against it unchanged.  Crash detection is
    structural (child exit code via :meth:`poll_exit`, dropped data
    connection mid-batch → :class:`ReplicaDeadError`); :meth:`respawn`
    spawns a fresh child from the fleet's CURRENT model artifact.  The
    child's log is ``<workdir>/<replica_id>.log``."""

    def __init__(
        self,
        replica_id: str,
        model,
        store: ModelStore,
        request_spec: Dict[str, ShardSpec],
        device="cuda",
        buckets=None,
        max_batch: int = 256,
        min_bucket: int = 8,
        max_delay_s: float = 0.002,
        telemetry=None,
        child_env: Optional[Dict[str, str]] = None,
        spawn_timeout_s: float = 120.0,
        table_capacity_factor: int = 1,
        table_dtype: str = "f32",
        models: Optional[Dict] = None,
    ):
        if models:
            raise not_ported("the multi-model child (models=)", "7.5")
        self._store = store
        self._request_spec = dict(request_spec)
        self._device = str(torch.device(device))
        self._buckets = buckets
        self._min_bucket = min_bucket
        self._table_capacity_factor = int(table_capacity_factor)
        self._table_dtype = str(table_dtype)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self.child_env = dict(child_env or {})
        self._proc: Optional[subprocess.Popen] = None
        self._replica_id = replica_id
        self._cfg_max_batch = int(max_batch)
        self.log_path = os.path.join(store.workdir, f"{replica_id}.log")
        # Observability: where the child flushes its flight-recorder ring
        # (a postmortem collector reads it after a kill), and the sink
        # completed child spans forward to.  The sink lives on the REPLICA
        # (not the per-child scorer) so it survives respawn; _spawn hands
        # each child scorer the bound forwarder.
        self.flight_path = os.path.join(store.workdir,
                                        f"{replica_id}.flight.json")
        self.span_sink = None
        # The reports of the children this replica let go (a cutover's
        # retired child, a respawn's dead one), each at its last stats pull.
        self.retired_children: list = []
        scorer = self._spawn(model, telemetry=telemetry)
        super().__init__(replica_id, scorer, max_batch=max_batch,
                         max_delay_s=max_delay_s, telemetry=telemetry)

    # -- child lifecycle ------------------------------------------------------
    def _spawn(self, model, telemetry=None) -> _RemoteScorer:
        """Spawn one child on the current shared artifact and connect —
        the ``replica:spawn`` fault site (retriable: the supervisor backs
        off and retries a failed spawn)."""
        proc, scorer = self._launch_child(
            model, self._table_capacity_factor, telemetry=telemetry,
            generation=getattr(self, "generation", 0),
        )
        self._proc = proc
        return scorer

    def build_replacement(self, model,
                          table_capacity_factor: int) -> Tuple:
        """Spawn (and warm) a REPLACEMENT child at a new capacity factor
        while the current child keeps serving — the background half of a
        zero-downtime rebuild.  Returns ``(proc, scorer)``; nothing on
        this replica changes until :meth:`cutover_to`.  The replacement is
        born into generation+1, the stamp the router's cutover publishes —
        any answer the OLD child still produces after cutover carries the
        stale generation and is fenced."""
        return self._launch_child(
            model, int(table_capacity_factor), telemetry=self.telemetry,
            generation=getattr(self, "generation", 0) + 1,
        )

    def cutover_to(self, scorer, proc=None,
                   table_capacity_factor: Optional[int] = None) -> None:
        """Atomically swap serving to a replacement child: new
        submissions flow to the new scorer immediately, the OLD batcher
        drains its queued work against the old child (zero shed), then
        the old child is retired."""
        old_proc = self._proc
        old_scorer = self.scorer
        if table_capacity_factor is not None:
            self._table_capacity_factor = int(table_capacity_factor)
        if proc is not None:
            self._proc = proc
        super().cutover_to(scorer)  # swaps batcher + drains the old one
        try:
            # The retired child's final counts, after its drain.
            self.pull_stats(deadline_s=5.0, scorer=old_scorer)
        except Exception:  # noqa: BLE001 — stats are advisory
            pass
        self.retired_children.append(self.child_report(old_scorer))
        try:
            old_scorer.shutdown(deadline_s=5.0)
        except Exception:  # noqa: BLE001 — retirement is best-effort
            pass
        old_scorer.disconnect()
        reap_process(old_proc)

    def _launch_child(self, model, table_capacity_factor: int,
                      telemetry=None, generation: int = 0) -> Tuple:
        fault_point("replica:spawn", replica=self._replica_id)
        t_spawn = time.monotonic()
        artifact, version = self._store.publish(model)
        ready_path = os.path.join(
            self._store.workdir,
            f"{self._replica_id}-ready-{os.getpid()}-{time.monotonic_ns()}"
            ".json",
        )
        config = {
            "replica_id": self._replica_id,
            "device": self._device,
            "spec": {
                shard: {"kind": s.kind, "dim": s.dim, "nnz": s.nnz}
                for shard, s in self._request_spec.items()
            },
            "buckets": list(self._buckets) if self._buckets else None,
            "max_batch": self._cfg_max_batch,
            "min_bucket": self._min_bucket,
            "table_capacity_factor": int(table_capacity_factor),
            "table_dtype": self._table_dtype,
            "flight_path": self.flight_path,
            "generation": int(generation),
        }
        env = dict(os.environ)
        env.update(self.child_env)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        log = open(self.log_path, "ab")
        try:
            # A fresh interpreter, never a fork: the parent may hold a
            # CUDA context.  stdin is a PIPE the parent never writes: the
            # child's parent-death watchdog reads it and exits on EOF, so
            # a crashed (or respawn-racing) parent can never leak orphan
            # children.
            proc = subprocess.Popen(
                [sys.executable, "-m", "photon_tpu_torch.serving.replica_proc",
                 "--artifact", artifact, "--ready-file", ready_path,
                 "--config", json.dumps(config)],
                env=env, stdin=subprocess.PIPE, stdout=log, stderr=log,
            )
        finally:
            log.close()
        deadline = time.monotonic() + self._spawn_timeout_s
        ready = None
        while time.monotonic() < deadline:
            code = proc.poll()
            if code is not None:
                reap_process(proc)
                raise ReplicaSpawnError(
                    f"replica {self._replica_id} child exited {code} during "
                    f"startup (log: {self.log_path})"
                )
            if os.path.exists(ready_path):
                with open(ready_path) as f:
                    ready = json.load(f)
                break
            time.sleep(0.02)
        if ready is None:
            reap_process(proc)
            raise ReplicaSpawnError(
                f"replica {self._replica_id} child not ready within "
                f"{self._spawn_timeout_s:g}s (log: {self.log_path})"
            )
        try:
            os.unlink(ready_path)
        except OSError:
            pass
        ready["spawn_s"] = time.monotonic() - t_spawn
        try:
            scorer = _RemoteScorer(
                self._replica_id, model, version, self._store,
                self._request_spec, self._buckets, self._cfg_max_batch,
                self._min_bucket, port=int(ready["port"]),
                compilations=int(ready.get("compilations", 0)),
                telemetry=telemetry, span_sink=self._deliver_spans,
                table_dtype=self._table_dtype, generation=int(generation),
                ready=ready,
            )
        except BaseException:
            reap_process(proc)
            raise
        return proc, scorer

    def child_report(self, scorer: Optional[_RemoteScorer] = None) -> dict:
        """A child's record (the current child's unless ``scorer`` names
        another): its device, spawn seconds, captures, allocator segments
        and kernel launches at warmup and at the last stats pull, its card
        memory, and its host syncs and batches — what a caller holds the
        no-capture-after-warmup, one-sync-a-batch and kernel-count
        contracts to."""
        scorer = scorer or self.scorer
        ready = scorer.ready
        stats = scorer.last_stats or {}
        totals: Dict[str, float] = {}
        for m in stats.get("counters", []):
            totals[m["name"]] = totals.get(m["name"], 0.0) + m["value"]
        return {
            "replica": self.replica_id, "pid": ready.get("pid"),
            "device": ready.get("device"), "spawn_s": ready.get("spawn_s"),
            "warmup_s": ready.get("warmup_s"),
            "captures_at_warmup": ready.get("compilations"),
            "segments_at_warmup": ready.get("segments"),
            "captures": stats.get("captures"),
            "segments": stats.get("segments"),
            "kernel_launches_at_warmup": ready.get("kernel_launches"),
            "kernel_launches": stats.get("kernel_launches"),
            "memory_reserved": stats.get("memory_reserved"),
            "max_memory_allocated": stats.get("max_memory_allocated"),
            "host_syncs": totals.get("serving.host_syncs", 0.0),
            "batches": totals.get("serving.batches", 0.0),
        }

    def _deliver_spans(self, spans: list) -> None:
        sink = self.span_sink
        if sink is not None:
            # De-skew the child's wall-clock timestamps onto the parent's
            # clock before they merge into the trace tree (the ping-RTT
            # offset estimate).
            offset = getattr(self.scorer, "clock_offset_s", 0.0)
            sink(shift_span_times(spans, offset))

    def poll_exit(self) -> Optional[int]:
        return None if self._proc is None else self._proc.poll()

    @property
    def child_pid(self) -> Optional[int]:
        return None if self._proc is None else self._proc.pid

    def kill_backend(self) -> None:
        """Tear the child down hard (the unhealthy-replica reaper): close
        the sockets — which unwedges a batcher thread blocked on a hung
        exchange — then SIGKILL the process."""
        self.scorer.disconnect()
        reap_process(self._proc)

    def respawn(self, model=None) -> None:
        """Real resurrection: abandon whatever the old batcher held (the
        router reroutes it), reap the dead child, spawn a FRESH child from
        the fleet's current model artifact (captured at boot), and attach
        a fresh batcher.  Dispatch resumes only after ``router.revive()``
        — the canary-gated rejoin."""
        self.abandon_for_respawn()
        self.kill_backend()
        self.retired_children.append(self.child_report())
        model = model if model is not None else self.scorer.model
        self.scorer = self._spawn(model, telemetry=self.telemetry)
        self.attach_fresh_batcher()

    def ping(self, deadline_s: float, **kw) -> dict:
        return self.scorer.ping(deadline_s, **kw)

    def pull_spans(self, deadline_s: float = 5.0) -> list:
        spans = self.scorer.pull_spans(deadline_s)
        return shift_span_times(
            spans, getattr(self.scorer, "clock_offset_s", 0.0)
        )

    def pull_stats(self, deadline_s: float = 5.0,
                   scorer: Optional[_RemoteScorer] = None) -> dict:
        """Pull the child's scorer-level ``serving.*`` counters and merge
        the DELTA since the last pull into the parent's telemetry registry
        under the same metric names plus a ``replica`` label — so a
        subprocess fleet's host_syncs/batches/cold_entities land in the
        parent's run report exactly like a thread replica's do.
        Idempotent across repeated pulls (cumulative child values, delta
        merge); the seen-state lives on the per-child scorer, so a
        respawned child restarts the base at zero.  ``scorer`` names a
        child other than the current one (a cutover's retiring child).
        Returns the merged deltas keyed by (name, labels)."""
        scorer = scorer or self.scorer
        with scorer._stats_lock:
            merged = {}
            seen = scorer._stats_seen
            for m in scorer.stats(deadline_s):
                name = m.get("name")
                labels = {
                    str(k): str(v) for k, v in (m.get("labels") or {}).items()
                }
                value = float(m.get("value", 0.0))
                key = (name, tuple(sorted(labels.items())))
                delta = value - seen.get(key, 0.0)
                if delta <= 0.0:
                    continue
                seen[key] = value
                self.telemetry.counter(
                    name, replica=self.replica_id, **labels
                ).inc(delta)
                merged[key] = delta
            return merged

    def close(self) -> None:
        # Drain FIRST: close()'s contract (queued requests still get
        # scored) needs the child alive while the batcher empties; tearing
        # the child down first would fail every drained request with
        # ReplicaDeadError.  A dead/hung child makes the drain fail fast
        # (socket errors) inside the batcher's bounded join.
        super().close()
        if self._proc is not None and self._proc.poll() is None:
            # Final stats pull AFTER the drain (so the drained batches are
            # counted) and BEFORE teardown — a fleet that never ran a
            # supervisor still gets its children's counters in the report.
            try:
                self.pull_stats(deadline_s=5.0)
            except Exception:  # noqa: BLE001 — stats are advisory
                pass
            try:
                self.scorer.shutdown()
            except (OSError, TransportError):
                pass
        self.kill_backend()


def reap_process(proc: Optional[subprocess.Popen]) -> None:
    """SIGKILL a child if it still runs and wait for it, so no process
    this module started outlives its replica."""
    if proc is None:
        return
    if proc.poll() is None:
        proc.kill()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        pass
    if proc.stdin is not None:
        try:
            proc.stdin.close()
        except OSError:
            pass


if __name__ == "__main__":
    _child_main()
