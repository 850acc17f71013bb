"""Tracing spans: nested wall-clock timing with attributes and status.

A copy of ``photon_tpu/telemetry/tracing.py``.

The structured upgrade of the reference's ``Timed { }`` phase logs
(SURVEY.md §5 'Tracing / profiling'): each instrumented region becomes a
span with a parent (nesting reconstructs the phase tree: driver run →
fit-config → descent iteration → coordinate solve), wall-clock duration,
free-form attributes, and an ok/error status recorded even when the region
raises.  Spans are process-local and host-side — device-level profiling
stays with ``torch.profiler``;
these spans answer "where did the run's wall-clock go" without a trace
viewer.

The active-span stack is thread-local, so spans opened on IO-pool worker
threads become roots of their own trees instead of corrupting the main
thread's nesting.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Iterator, List, Optional


class Span:
    """One timed region.  ``duration_s`` is None while the span is open."""

    __slots__ = (
        "name", "span_id", "parent_id", "start_time", "duration_s",
        "attributes", "status", "error", "thread",
    )

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 start_time: float, thread: str):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_time = start_time  # epoch seconds (for cross-run ordering)
        self.duration_s: Optional[float] = None
        self.attributes: dict = {}
        self.status = "ok"
        self.error: Optional[str] = None
        self.thread = thread

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_time": self.start_time,
            "duration_s": self.duration_s,
            "status": self.status,
        }
        if self.attributes:
            out["attributes"] = self.attributes
        if self.error is not None:
            out["error"] = self.error
        if self.thread != "MainThread":
            out["thread"] = self.thread
        return out


class Tracer:
    """Creates spans, tracks the per-thread active stack, keeps finished
    spans for export (append order == completion order, children before
    parents)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 0
        self.finished: List[Span] = []

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def span(self, name: str, **attributes) -> Iterator[Span]:
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        sp = Span(name, span_id, parent, time.time(),
                  threading.current_thread().name)
        sp.attributes.update(attributes)
        t0 = time.monotonic()
        stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.status = "error"
            sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            sp.duration_s = time.monotonic() - t0
            stack.pop()
            with self._lock:
                self.finished.append(sp)

    def export(self) -> List[dict]:
        with self._lock:
            return [sp.to_dict() for sp in self.finished]

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for entry in self.export():
                # default=str: never crash a run over an attribute type.
                f.write(json.dumps(entry, default=str) + "\n")

    def phase_totals(self) -> dict:
        """Total seconds per span name over finished spans — the run
        report's wall-clock breakdown table (same shape as PhotonLogger's
        ``phase_times``, derived from spans instead of a parallel dict)."""
        totals: dict = {}
        with self._lock:
            spans = list(self.finished)
        for sp in spans:
            if sp.duration_s is not None:
                totals[sp.name] = totals.get(sp.name, 0.0) + sp.duration_s
        return totals
