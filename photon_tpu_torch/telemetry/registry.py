"""Metrics registry: labeled counters, gauges, and histograms.

A copy of ``photon_tpu/telemetry/registry.py``.

The reference publishes run statistics through Spark accumulators and the
driver logs (SURVEY.md §5 'Tracing'); this process-local registry is the
rebuild's equivalent: cheap thread-safe instruments that drivers, optimizers,
and the GAME descent loop write into, snapshotted at the end of a run into
the structured run report (:mod:`photon_tpu_torch.telemetry.report`).

Instruments are created lazily and keyed by ``(name, labels)`` so call sites
can re-request a metric (``registry.counter("optimizer.runs", lam="0.1")``)
without holding a handle.  All values are host-side Python floats — nothing
here touches torch or devices.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count (rows scored, solves run, ...)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc by {amount})")
        with self._lock:
            self._value += float(amount)

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-written value (dataset size, best lambda, rows/s)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value: float | None = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float | None:
        return self._value


class Histogram:
    """Distribution of observations (per-solve seconds, chunk sizes).

    Keeps exact count/sum/min/max plus a bounded, deterministic reservoir
    for percentiles: once the reservoir fills it is decimated to every
    second sample and the keep-stride doubles, so memory stays O(cap) while
    the kept samples remain an even sweep of the observation sequence (no
    RNG — runs stay reproducible).
    """

    __slots__ = ("_lock", "count", "sum", "min", "max", "_kept", "_stride", "_cap")

    def __init__(self, lock: threading.RLock, cap: int = 256):
        self._lock = lock
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._kept: List[float] = []
        self._stride = 1
        self._cap = cap

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            if self.count % self._stride == 0:
                self._kept.append(value)
                if len(self._kept) > self._cap:
                    self._kept = self._kept[::2]
                    self._stride *= 2
            self.count += 1
            self.sum += value

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def percentile(self, p: float) -> float | None:
        """Approximate percentile from the kept reservoir (p in [0, 100])."""
        with self._lock:
            kept = sorted(self._kept)
        if not kept:
            return None
        idx = min(len(kept) - 1, max(0, round(p / 100.0 * (len(kept) - 1))))
        return kept[idx]

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Thread-safe registry of labeled instruments.

    One registry per run (owned by the
    :class:`~photon_tpu_torch.telemetry.TelemetrySession`); ``snapshot()`` is the
    JSON-ready export embedded in the run report, ``to_prometheus()`` the
    text exposition for scraping a long-lived process.
    """

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[Tuple[str, LabelKey], Tuple[str, object]] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, object]):
        key = (name, _label_key(labels))
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                existing_kind, metric = existing
                if existing_kind != kind:
                    raise TypeError(
                        f"metric {name!r}{dict(key[1])} already registered "
                        f"as {existing_kind}, requested as {kind}"
                    )
                return metric
            metric = self._KINDS[kind](self._lock)
            self._metrics[key] = (kind, metric)
            return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def snapshot(self) -> dict:
        """JSON-ready ``{"counters": [...], "gauges": [...], "histograms":
        [...]}``, each entry ``{"name", "labels", ...value(s)}``, sorted by
        (name, labels) so identical runs export identical structures.
        Formats under the registry lock (the instruments share it, so a
        mid-``observe`` count/sum pair can never tear)."""
        out: dict = {"counters": [], "gauges": [], "histograms": []}
        with self._lock:
            for (name, labels), (kind, metric) in sorted(self._metrics.items()):
                entry = {"name": name, "labels": dict(labels)}
                if kind == "histogram":
                    entry.update(metric.summary())
                else:
                    entry["value"] = metric.value
                out[kind + "s"].append(entry)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition: one ``# TYPE`` line per metric name,
        label values escaped per the text format, histograms exported as
        summaries with quantile labels.  Formats under the registry lock
        (see :meth:`snapshot`)."""

        def sanitize(name: str) -> str:
            return "".join(c if c.isalnum() or c == "_" else "_" for c in name)

        def escape(value: str) -> str:
            return (
                value.replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n")
            )

        def fmt_labels(labels: dict, extra: dict | None = None) -> str:
            merged = {**labels, **(extra or {})}
            if not merged:
                return ""
            body = ",".join(
                f'{sanitize(k)}="{escape(str(v))}"'
                for k, v in sorted(merged.items())
            )
            return "{" + body + "}"

        lines: List[str] = []
        typed: set = set()
        with self._lock:
            for (name, labels), (kind, metric) in sorted(self._metrics.items()):
                pname = sanitize(name)
                labels = dict(labels)
                if kind == "gauge" and metric.value is None:
                    continue
                prom_type = "summary" if kind == "histogram" else kind
                if pname not in typed:  # one TYPE line per name, ever
                    typed.add(pname)
                    lines.append(f"# TYPE {pname} {prom_type}")
                if kind in ("counter", "gauge"):
                    lines.append(f"{pname}{fmt_labels(labels)} {metric.value:g}")
                else:
                    for q in (0.5, 0.9, 0.99):
                        v = metric.percentile(q * 100)
                        if v is not None:
                            lines.append(
                                f"{pname}"
                                f"{fmt_labels(labels, {'quantile': f'{q:g}'})}"
                                f" {v:g}"
                            )
                    lines.append(f"{pname}_sum{fmt_labels(labels)} {metric.sum:g}")
                    lines.append(
                        f"{pname}_count{fmt_labels(labels)} {metric.count:g}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")
