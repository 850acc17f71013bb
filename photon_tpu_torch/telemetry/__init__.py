"""Structured telemetry: metrics registry, tracing spans, run reports.

A copy of ``photon_tpu/telemetry/__init__.py``.

The observability layer of the rebuild (SURVEY.md §5 'Tracing /
profiling').  One :class:`TelemetrySession` spans one driver run and owns:

- a :class:`~photon_tpu_torch.telemetry.registry.MetricsRegistry` — labeled
  counters/gauges/histograms written by the drivers and the serving
  layer;
- a :class:`~photon_tpu_torch.telemetry.tracing.Tracer` — nested wall-clock spans
  (``PhotonLogger.timed`` phases feed it automatically once the session is
  attached to the logger);
- finalization into ``<output-dir>/telemetry/`` run-report artifacts
  (:mod:`photon_tpu_torch.telemetry.report`).

Telemetry is on by default and gated twice: per-run by the drivers'
``--no-telemetry`` flag, globally by ``PHOTON_TELEMETRY=off`` (or 0/false).
A disabled session is a full no-op object — spans yield a null span,
instruments swallow writes, finalize writes nothing — so library code takes
a session unconditionally (``telemetry or NULL_SESSION``) and never
branches.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

from photon_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from photon_tpu_torch.telemetry.tracing import Span, Tracer  # noqa: F401
from photon_tpu_torch.telemetry.distributed import (  # noqa: F401
    FlightRecorder,
    MergeableHistogram,
    SpanRecord,
    TraceCollector,
    TraceContext,
    TraceSampler,
    activate_trace,
    attach_trace,
    current_trace,
    new_trace_id,
    span_of,
    trace_of,
)

# photon_tpu_torch.telemetry.report is imported lazily (build_report below): it is
# also the `python -m photon_tpu_torch.telemetry.report` CLI, and importing it here
# would make runpy warn about the double import.

_ENV_VAR = "PHOTON_TELEMETRY"
_OFF_VALUES = ("off", "0", "false", "no")


def telemetry_enabled(flag: Optional[bool] = None) -> bool:
    """Resolve the two gates: the env var kills telemetry process-wide
    (operator override, e.g. benchmark runs); otherwise the driver flag
    (default True) decides."""
    if os.environ.get(_ENV_VAR, "").strip().lower() in _OFF_VALUES:
        return False
    return True if flag is None else bool(flag)


class _NullMetric:
    """Write-only sink standing in for every instrument when disabled."""

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    @property
    def value(self):
        return None


_NULL_METRIC = _NullMetric()


class _NullRegistry:
    def counter(self, name: str, **labels) -> _NullMetric:
        return _NULL_METRIC

    gauge = counter
    histogram = counter

    def snapshot(self) -> dict:
        return {"counters": [], "gauges": [], "histograms": []}

    def to_prometheus(self) -> str:
        return ""


class _NullSpan:
    def set_attribute(self, key: str, value) -> None:
        pass


_NULL_SPAN = _NullSpan()


class TelemetrySession:
    """Run-scoped telemetry: registry + tracer + report finalization.

    ``write`` (default True) lets multi-process drivers restrict artifact
    output to the primary rank after they learn their process index —
    instruments still record everywhere (cheap, and keeps rank behavior
    identical up to the filesystem).
    """

    def __init__(self, driver: str, enabled: bool = True):
        self.driver = driver
        self.enabled = enabled
        self.write = True
        self.registry = MetricsRegistry() if enabled else _NullRegistry()
        self.tracer = Tracer() if enabled else None
        self.started_at = time.time()
        self._t0 = time.monotonic()
        self.run_id = (
            f"{driver}-{time.strftime('%Y%m%d-%H%M%S', time.localtime(self.started_at))}"
            f"-{os.getpid()}"
        )
        self._finalized: Optional[dict] = None

    # -- instruments --------------------------------------------------------
    def counter(self, name: str, **labels):
        return self.registry.counter(name, **labels)

    def gauge(self, name: str, **labels):
        return self.registry.gauge(name, **labels)

    def histogram(self, name: str, **labels):
        return self.registry.histogram(name, **labels)

    @contextlib.contextmanager
    def span(self, name: str, **attributes) -> Iterator[object]:
        if self.tracer is None:
            yield _NULL_SPAN
            return
        with self.tracer.span(name, **attributes) as sp:
            yield sp

    def attach(self, logger) -> None:
        """Route the logger's ``timed()`` phases through this session's
        tracer (phase logs and spans stay one instrumentation point)."""
        if self.enabled:
            logger.tracer = self.tracer

    # -- finalization -------------------------------------------------------
    def build_report(self, status: str = "success",
                     error: Optional[str] = None,
                     extra: Optional[dict] = None) -> dict:
        from photon_tpu_torch.telemetry.report import capture_environment

        report = {
            "driver": self.driver,
            "run_id": self.run_id,
            "status": status,
            "error": error,
            "started_at": self.started_at,
            "duration_s": time.monotonic() - self._t0,
            "environment": capture_environment(),
            "phase_totals": self.tracer.phase_totals() if self.tracer else {},
            "metrics": self.registry.snapshot(),
            "spans": self.tracer.export() if self.tracer else [],
        }
        if extra:
            report["extra"] = extra
        return report

    def finalize(self, output_dir: str, status: str = "success",
                 error: Optional[str] = None,
                 extra: Optional[dict] = None) -> Optional[dict]:
        """Build the run report and write ``telemetry/{run_report.json,
        spans.jsonl}`` under ``output_dir``.  Idempotent: a second call
        (e.g. the error path after a failed success-path write) returns the
        first report unchanged.  Returns None when disabled.  Never raises:
        a telemetry failure (unwritable output dir, disk quota) must not
        crash an otherwise-successful run, nor — on the error path —
        replace the driver's real exception with a telemetry traceback."""
        if not self.enabled:
            return None
        if self._finalized is not None:
            return self._finalized
        import json
        import logging

        try:
            report = self.build_report(status=status, error=error, extra=extra)
        except Exception as e:
            logging.getLogger("photon_tpu_torch.telemetry").warning(
                "telemetry report build failed (%s: %s); run continues",
                type(e).__name__, e,
            )
            return None
        self._finalized = report
        if self.write and output_dir:
            try:
                tdir = os.path.join(output_dir, "telemetry")
                os.makedirs(tdir, exist_ok=True)
                with open(os.path.join(tdir, "run_report.json"), "w") as f:
                    # default=str: a non-JSON attribute (numpy scalar, Path)
                    # degrades to its repr.
                    json.dump(report, f, indent=1, default=str)
                self.tracer.write_jsonl(os.path.join(tdir, "spans.jsonl"))
            except Exception as e:
                logging.getLogger("photon_tpu_torch.telemetry").warning(
                    "telemetry write to %s failed (%s: %s); run continues",
                    output_dir, type(e).__name__, e,
                )
        return report


NULL_SESSION = TelemetrySession("null", enabled=False)
