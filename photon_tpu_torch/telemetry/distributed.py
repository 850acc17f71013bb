"""Cross-process request tracing, mergeable snapshots, flight recorder.

A copy of ``photon_tpu/telemetry/distributed.py``.

The fleet (router → replica subprocess → scorer batch) is a distributed
system whose existing telemetry is per-process and end-of-run: a request
that is shed, rerouted around a dead replica, or slowed by batch-wait
leaves no record that crosses a process boundary.  This module is the
wire-level half of the observability plane (the fleet-facing half lives in
:mod:`photon_tpu_torch.serving.observe`):

- :class:`TraceContext` — a trace id + parent span id small enough to ride
  the length-prefixed frame protocol's JSON header on every hop;
- :class:`SpanRecord` — a mutable per-hop span that accumulates timestamped
  events (enqueue, admit/shed, coalesce, dispatch, compute, egress) and
  serializes to a plain dict;
- :class:`TraceSampler` — deterministic rate-based sampling so the hot
  path stays cheap (no RNG: runs stay reproducible);
- :class:`TraceCollector` — the parent-side merge point: spans from every
  process land here, keyed by trace id, bounded to the most recent traces;
  :meth:`TraceCollector.critical_path` decomposes one request into
  queue / batch-wait / compute / transport stages whose sum reconciles
  with the measured end-to-end latency by construction;
- :class:`MergeableHistogram` — fixed-bucket counts that merge across
  processes by addition (the registry's reservoir histograms cannot merge:
  two reservoirs with different strides have no sound union);
- :class:`FlightRecorder` — a bounded ring of recent spans/events/frame
  summaries each replica keeps; persisted next to the run report when the
  supervisor declares the replica dead, so postmortems start with the
  victim's final seconds.

Everything here is host-side Python over plain dicts — nothing touches torch
or devices, and every record is JSON-ready so it can ride frame headers
and land in run reports unchanged.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Iterator, List, Optional

__all__ = [
    "TraceContext",
    "SpanRecord",
    "TraceSampler",
    "TraceCollector",
    "MergeableHistogram",
    "FlightRecorder",
    "new_trace_id",
    "attach_trace",
    "trace_of",
    "attach_span",
    "span_of",
    "activate_trace",
    "current_trace",
    "shift_span_times",
]


def shift_span_times(spans: List[dict], offset_s: float) -> List[dict]:
    """Map child-process span timestamps onto the parent's clock before
    merging trace trees.  ``offset_s`` is the estimated child-minus-parent
    wall-clock offset (from control-connection ping RTT: the child's
    ``pong`` echoes its ``time.time()``, and the parent estimates
    ``offset = child_time - (t_send + t_recv) / 2``); subtracting it
    de-skews ``start`` and every event ``t`` so a skewed host can no
    longer misorder cross-process hops on the merged timeline.  Durations
    are untouched — they were measured monotonically on the child and are
    already skew-free.  Mutates and returns ``spans`` (the caller owns the
    freshly-deserialized wire dicts)."""
    if not offset_s:
        return spans
    for d in spans or []:
        if not isinstance(d, dict):
            continue
        if isinstance(d.get("start"), (int, float)):
            d["start"] = d["start"] - offset_s
        for e in d.get("events") or []:
            if isinstance(e, dict) and isinstance(e.get("t"), (int, float)):
                e["t"] = e["t"] - offset_s
    return spans

_id_lock = threading.Lock()
_id_counter = 0


def new_trace_id() -> str:
    """Process-unique id: pid-scoped counter + startup entropy.  Hex, short
    enough to ride every frame header without bloating small requests."""
    global _id_counter
    with _id_lock:
        _id_counter += 1
        n = _id_counter
    return f"{os.getpid():x}-{_ENTROPY}-{n:x}"


_ENTROPY = os.urandom(4).hex()


class TraceContext:
    """What crosses a process boundary: the trace id, the parent span id,
    and the sampling verdict (a child must not re-roll the sampling dice —
    a trace is whole or absent)."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def to_wire(self) -> dict:
        return {"tid": self.trace_id, "sid": self.span_id}

    @classmethod
    def from_wire(cls, wire: Optional[dict]) -> Optional["TraceContext"]:
        if not wire or "tid" not in wire:
            return None
        return cls(str(wire["tid"]), str(wire.get("sid", "")), True)

    def child_of(self, span: "SpanRecord") -> "TraceContext":
        return TraceContext(self.trace_id, span.span_id, self.sampled)


class SpanRecord:
    """One hop of one trace: a named region in one process with timestamped
    events.  Mutable while open; :meth:`to_dict` is the wire/report form.

    Timestamps are epoch seconds (``time.time``) so events from different
    processes land on one axis; durations are measured monotonically so a
    clock step mid-span cannot produce a negative stage."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "process",
        "start", "duration_s", "events", "attrs", "status", "_t0",
    )

    def __init__(self, trace_id: str, name: str, process: str,
                 parent_id: Optional[str] = None,
                 span_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id or new_trace_id()
        self.parent_id = parent_id
        self.name = name
        self.process = process
        self.start = time.time()
        self.duration_s: Optional[float] = None
        self.events: List[dict] = []
        self.attrs: dict = {}
        self.status = "ok"
        self._t0 = time.monotonic()

    def event(self, name: str, **attrs) -> None:
        e = {"name": name, "t": time.time()}
        if attrs:
            e.update(attrs)
        self.events.append(e)

    def finish(self, status: str = "ok") -> "SpanRecord":
        if self.duration_s is None:
            self.duration_s = time.monotonic() - self._t0
            self.status = status
        return self

    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id, True)

    def to_dict(self) -> dict:
        out = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "process": self.process,
            "start": self.start,
            "duration_s": self.duration_s,
            "status": self.status,
            "events": list(self.events),
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out


class TraceSampler:
    """Deterministic rate sampling: an accumulator crosses 1.0 every
    ``1/rate`` requests, so a 0.1 rate samples exactly every 10th request
    — no RNG, so benchmark runs reproduce and the overhead bound is a
    property of the rate, not of luck."""

    __slots__ = ("rate", "_acc", "_lock")

    def __init__(self, rate: float = 1.0):
        self.rate = max(0.0, min(1.0, float(rate)))
        self._acc = 1.0 if self.rate > 0 else 0.0  # sample the first request
        self._lock = threading.Lock()

    def should_sample(self) -> bool:
        if self.rate <= 0.0:
            return False
        if self.rate >= 1.0:
            return True
        with self._lock:
            self._acc += self.rate
            if self._acc >= 1.0:
                self._acc -= 1.0
                return True
            return False


# -- critical-path stage names, in request order -----------------------------
STAGES = ("queue", "batch_wait", "transport", "compute", "child_other",
          "resolve")


class TraceCollector:
    """Parent-side merge point for spans from every process.

    Bounded: keeps the most recent ``capacity`` traces (eviction is by
    trace arrival order — a long run cannot grow memory without bound).
    ``merge_remote`` accepts span dicts shipped back from child replicas
    over the control connection or recovered from a flight-recorder dump.
    """

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()
        self.spans_merged = 0
        self.spans_dropped = 0

    # -- ingest --------------------------------------------------------------
    def add(self, span) -> None:
        d = span.to_dict() if isinstance(span, SpanRecord) else dict(span)
        tid = d.get("trace_id")
        if not tid:
            return
        with self._lock:
            bucket = self._traces.get(tid)
            if bucket is None:
                while len(self._traces) >= self.capacity:
                    self._traces.popitem(last=False)
                    self.spans_dropped += 1
                bucket = self._traces[tid] = []
            else:
                self._traces.move_to_end(tid)
            bucket.append(d)
            self.spans_merged += 1

    def merge_remote(self, spans: List[dict]) -> int:
        """Merge spans shipped from another process; returns count merged.
        A span for an already-evicted trace re-opens it (the dump of a dead
        replica may arrive long after the trace finished)."""
        n = 0
        for d in spans or []:
            if isinstance(d, dict) and d.get("trace_id"):
                self.add(d)
                n += 1
        return n

    def recover_lost(self, trace_id: str, span: dict, reason: str) -> None:
        """Adopt an unfinished span recovered from a dead replica's flight
        dump as a terminal stub — the trace stays whole (no orphan hop)
        and the stub says why the hop never reported back."""
        stub = dict(span)
        stub["status"] = "lost"
        stub.setdefault("duration_s", 0.0)
        stub.setdefault("attrs", {})
        stub["attrs"] = dict(stub["attrs"], lost_reason=reason)
        self.add(stub)

    # -- queries -------------------------------------------------------------
    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces.keys())

    def trace(self, trace_id: str) -> List[dict]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def tree(self, trace_id: str) -> Optional[dict]:
        """The merged cross-process trace tree: each node is the span dict
        plus a ``children`` list; returns the root (parentless) node.
        Spans whose parent never arrived attach to the root rather than
        dangling — a merged trace has no orphans by construction."""
        spans = self.trace(trace_id)
        if not spans:
            return None
        nodes = {d["span_id"]: dict(d, children=[]) for d in spans}
        root = None
        for node in nodes.values():
            if node.get("parent_id") in nodes:
                nodes[node["parent_id"]]["children"].append(node)
            elif node.get("parent_id") is None and root is None:
                root = node
        if root is None:  # no parentless span shipped: oldest is the root
            root = min(nodes.values(), key=lambda n: n["start"])
        for node in nodes.values():
            if node is root:
                continue
            if node.get("parent_id") not in nodes:
                root["children"].append(node)
        return root

    def processes(self, trace_id: str) -> List[str]:
        return sorted({d.get("process", "?") for d in self.trace(trace_id)})

    def critical_path(self, trace_id: str) -> Optional[dict]:
        """Per-request stage decomposition for one trace.

        Anchored entirely on the ROOT span's clock: the root's events
        partition ``[enqueue, done]`` into queue → batch-wait → remote →
        resolve, and the remote segment is subdivided by the child span's
        *measured durations* (compute, other) with transport as the
        remainder, clamped at zero and rescaled if clock skew makes the
        child claim more time than the parent observed.  The stage sum
        therefore equals the measured end-to-end latency by construction.
        """
        spans = self.trace(trace_id)
        if not spans:
            return None
        # Anchor on the ROUTER hop — the span carrying the "enqueue" event
        # is where queue/batch-wait decomposition is defined.  A trace
        # rooted above it (a client span, an online-publish span) still
        # decomposes; a trace without one falls back to the tree root.
        root = next(
            (d for d in spans
             if d.get("duration_s") is not None
             and any(e.get("name") == "enqueue"
                     for e in d.get("events", ()))),
            None,
        )
        if root is None:
            root = next(
                (d for d in spans if d.get("parent_id") is None), None
            )
        if root is None or root.get("duration_s") is None:
            return None
        total = float(root["duration_s"])
        ev = {e["name"]: float(e["t"]) for e in root.get("events", ())}
        t0 = float(root["start"])
        t_end = t0 + total

        def at(name: str, default: float) -> float:
            return min(max(ev.get(name, default), t0), t_end)

        t_dispatch = at("dispatch", t0)
        t_score0 = at("score_begin", t_dispatch)
        t_score1 = at("score_end", t_end)
        stages = {
            "queue": max(0.0, t_dispatch - t0),
            "batch_wait": max(0.0, t_score0 - t_dispatch),
            "resolve": max(0.0, t_end - t_score1),
        }
        remote = max(0.0, t_score1 - t_score0)
        # Subdivide the remote segment with the child hop's own clock.
        child = next(
            (d for d in spans
             if d.get("parent_id") == root["span_id"]
             and d.get("process") != root.get("process")
             and d.get("duration_s") is not None),
            None,
        )
        if child is not None and remote > 0:
            child_total = min(float(child["duration_s"]), remote)
            cev = {e["name"]: float(e["t"]) for e in child.get("events", ())}
            compute = max(0.0, cev.get("compute_end", 0.0)
                          - cev.get("compute_begin", 0.0))
            compute = min(compute, child_total)
            stages["transport"] = remote - child_total
            stages["compute"] = compute
            stages["child_other"] = child_total - compute
        else:
            stages["transport"] = 0.0
            stages["compute"] = remote
            stages["child_other"] = 0.0
        ordered = [
            {"stage": name, "duration_s": stages.get(name, 0.0)}
            for name in STAGES
        ]
        return {
            "trace_id": trace_id,
            "total_s": total,
            "stages": ordered,
            "stage_sum_s": sum(s["duration_s"] for s in ordered),
            "processes": self.processes(trace_id),
            "spans": len(spans),
        }

    def export(self, limit: int = 32) -> List[dict]:
        """Most recent ``limit`` traces as flat span lists (report form)."""
        with self._lock:
            ids = list(self._traces.keys())[-limit:]
        return [{"trace_id": tid, "spans": self.trace(tid)} for tid in ids]


class MergeableHistogram:
    """Fixed-bucket latency histogram whose snapshots merge by addition.

    The registry's reservoir histograms are ideal in-process but two
    reservoirs with different strides have no sound union; fleet-level
    p50/p99 therefore aggregates these instead: log-spaced bucket counts
    (100 µs … ~100 s) that any process can snapshot, ship as a plain list,
    and the supervisor merges with elementwise adds.  Quantiles interpolate
    within the winning bucket — bounded error, zero coordination.
    """

    # 40 log-spaced bounds, 1e-4 s to ~100 s (ratio ~1.43 per step).
    BOUNDS = tuple(1e-4 * (10 ** (i / 6.45)) for i in range(40))

    __slots__ = ("counts", "count", "sum", "_lock")

    def __init__(self, counts: Optional[List[int]] = None,
                 count: int = 0, total: float = 0.0):
        self.counts = list(counts) if counts else [0] * (len(self.BOUNDS) + 1)
        self.count = int(count)
        self.sum = float(total)
        self._lock = threading.Lock()

    def _bucket(self, value: float) -> int:
        lo, hi = 0, len(self.BOUNDS)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.BOUNDS[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, value: float) -> None:
        value = float(value)
        idx = self._bucket(value)
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.sum += value

    def snapshot(self) -> dict:
        with self._lock:
            return {"counts": list(self.counts), "count": self.count,
                    "sum": self.sum}

    def merge(self, snap: dict) -> None:
        counts = snap.get("counts") or []
        with self._lock:
            for i, c in enumerate(counts[: len(self.counts)]):
                self.counts[i] += int(c)
            self.count += int(snap.get("count", 0))
            self.sum += float(snap.get("sum", 0.0))

    @classmethod
    def merged(cls, snaps: List[dict]) -> "MergeableHistogram":
        h = cls()
        for s in snaps:
            h.merge(s)
        return h

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 1], interpolated within the
        winning bucket (upper bound for the overflow bucket)."""
        with self._lock:
            counts, total = list(self.counts), self.count
        if total == 0:
            return None
        target = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= target and c > 0:
                lo = self.BOUNDS[i - 1] if i > 0 else 0.0
                hi = self.BOUNDS[i] if i < len(self.BOUNDS) else self.BOUNDS[-1]
                frac = (target - seen) / c if c else 0.0
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            seen += c
        return self.BOUNDS[-1]

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None


class FlightRecorder:
    """Bounded ring of a replica's recent spans, events, and frame
    summaries — the crash postmortem's raw material.

    ``dump()`` persists the ring atomically (tmp + replace) so a reader
    never sees a torn file even if the writer dies mid-dump; the child
    flushes at traced-frame ingress *before* scoring, so a SIGKILL mid-
    batch still leaves the victim's last accepted work on disk.
    """

    def __init__(self, owner: str, capacity: int = 128):
        self.owner = owner
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        self.records_total = 0

    def record(self, kind: str, **fields) -> None:
        entry = {"t": time.time(), "kind": kind}
        entry.update(fields)
        with self._lock:
            self._ring.append(entry)
            self.records_total += 1

    def note_frame(self, direction: str, kind: str, nbytes: int,
                   seq: Optional[int] = None) -> None:
        self.record("frame", direction=direction, frame_kind=kind,
                    nbytes=int(nbytes), seq=seq)

    def note_span(self, span: SpanRecord, phase: str) -> None:
        self.record("span", phase=phase, span=span.to_dict())

    def snapshot(self) -> dict:
        with self._lock:
            records = list(self._ring)
        return {
            "owner": self.owner,
            "written_at": time.time(),
            "records_total": self.records_total,
            "records": records,
        }

    def dump(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f, default=str)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> Optional[dict]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


# -- request attachment ------------------------------------------------------
# ScoringRequest is a frozen dataclass: the trace context rides as an extra
# attribute set via object.__setattr__ — invisible to equality/repr, absent
# unless tracing sampled this request, and dropped naturally when the
# request is re-sliced (concat_requests builds new objects).
_TRACE_ATTR = "_photon_trace"


def attach_trace(request, ctx: TraceContext) -> None:
    object.__setattr__(request, _TRACE_ATTR, ctx)


def trace_of(request) -> Optional[TraceContext]:
    return getattr(request, _TRACE_ATTR, None)


# The live SpanRecord rides the same way (parent-process only — the span
# object itself never crosses the wire, only its TraceContext does): the
# batcher reads it to stamp batch-close/score events onto the root span
# without the router having to thread span handles through the queue.
_SPAN_ATTR = "_photon_span"


def attach_span(request, span: SpanRecord) -> None:
    object.__setattr__(request, _SPAN_ATTR, span)


def span_of(request) -> Optional[SpanRecord]:
    return getattr(request, _SPAN_ATTR, None)


# -- thread-local active trace (the refresh→canary→swap linkage) -------------
_active = threading.local()


def current_trace() -> Optional[TraceContext]:
    return getattr(_active, "ctx", None)


@contextlib.contextmanager
def activate_trace(ctx: Optional[TraceContext]) -> Iterator[None]:
    """Make ``ctx`` the thread's ambient trace context: spans originated
    on this thread without an explicit parent (e.g. the rollout pipeline
    under an online refresh) join this trace instead of starting new
    ones."""
    prev = getattr(_active, "ctx", None)
    _active.ctx = ctx
    try:
        yield
    finally:
        _active.ctx = prev
