"""Run reports: environment capture, JSON artifact, markdown rendering.

A copy of ``photon_tpu/telemetry/report.py``; only
:func:`capture_environment` differs (it reads torch).

Every driver run finalizes its :class:`~photon_tpu_torch.telemetry.TelemetrySession`
into ``<output-dir>/telemetry/``:

- ``run_report.json`` — status, duration, captured environment, the metrics
  registry snapshot, and the full span tree (the machine-readable record of
  the run; the reference's scattered driver logs, made structural).
- ``spans.jsonl`` — one span per line for trace tooling.

``python -m photon_tpu_torch.telemetry.report <run_report.json>`` renders the
report as markdown (status header, environment, phase breakdown, metrics
tables) — the human-readable view, kept out of the hot path.

Telemetry artifacts live beside — never inside — ``training_summary.json``:
summaries stay byte-identical across identical runs (the determinism
contract tests/test_legacy_avro_determinism.py pins), while telemetry holds
all the wall-clock data.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
from typing import Optional


def capture_environment() -> dict:
    """Host/process facts worth pinning to a run: the interpreter, the
    platform, ``PHOTON_*`` settings, and torch's version, CUDA version and
    device name.  The device name is read only when CUDA is already
    initialized: telemetry must never be what starts a CUDA context."""
    env = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "photon_env": {
            k: v for k, v in sorted(os.environ.items())
            if k.startswith("PHOTON_")
        },
    }
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None:
        info: dict = {"version": getattr(torch_mod, "__version__", None),
                      "cuda": getattr(torch_mod.version, "cuda", None)}
        try:
            if torch_mod.cuda.is_initialized():
                info["device"] = torch_mod.cuda.get_device_name(0)
                info["device_count"] = torch_mod.cuda.device_count()
            else:
                info["device"] = "cpu" if not torch_mod.cuda.is_available() \
                    else "cuda (uninitialized)"
        except Exception as e:  # never let capture kill a report
            info["error"] = f"{type(e).__name__}: {e}"
        env["torch"] = info
    return env


def _fmt(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _fmt_labels(labels: dict) -> str:
    return ", ".join(f"{k}={v}" for k, v in sorted(labels.items())) or "—"


def _render_pipeline_section(report: dict) -> list:
    """The checkpoint-publisher / io-pool pipeline at a glance: how long
    the training loop actually blocked on checkpoint IO vs how long the
    background publishes took, plus the host-IO pool's live shape.  Empty
    when the run neither checkpointed nor pooled reads."""
    metrics = report.get("metrics") or {}
    hists = {
        (h["name"], tuple(sorted(h.get("labels", {}).items()))): h
        for h in metrics.get("histograms") or []
    }
    scalars = {
        (m["name"], tuple(sorted(m.get("labels", {}).items()))): m["value"]
        for m in (metrics.get("counters") or []) + (metrics.get("gauges") or [])
    }

    def hist(name):
        return hists.get((name, ()))

    def scalar(name):
        return scalars.get((name, ()))

    lines = []
    ckpt_rows = []
    for name, label in (
        ("checkpoint.write_seconds", "loop-side save (stage + submit)"),
        ("checkpoint.blocked_s", "loop blocked on previous publish"),
        ("checkpoint.publish_lag_s", "background publish (enqueue→landed)"),
    ):
        h = hist(name)
        if h and h.get("count"):
            ckpt_rows.append(
                f"| {name} | {label} | {h['count']} | {_fmt(h['mean'])} "
                f"| {_fmt(h['max'])} |"
            )
    if ckpt_rows or scalar("checkpoint.saves"):
        lines += ["", "## Checkpoint pipeline", ""]
        if scalar("checkpoint.saves") is not None:
            lines.append(f"- **saves**: {_fmt(scalar('checkpoint.saves'))}")
        if ckpt_rows:
            lines += ["", "| metric | meaning | count | mean (s) | max (s) |",
                      "|---|---|---|---|---|", *ckpt_rows]
    pool = {
        name: scalar(name)
        for name in ("io_pool.workers", "io_pool.in_flight_peak")
        if scalar(name) is not None
    }
    if pool:
        lines += ["", "## Host-IO pool", ""]
        for name, value in pool.items():
            lines.append(f"- **{name}**: {_fmt(value)}")
    # Elastic-resume / stall events: preemptions honored, watchdog stalls,
    # guarded-IO timeout escalations, and staged-RSS blocking fallbacks —
    # labeled counters, so sum over label variants.
    resilience = {}
    for name in ("descent.preempted", "watchdog.stalled",
                 "io.stall_timeouts", "checkpoint.staged_fallback_sync"):
        total = sum(
            m["value"] for m in metrics.get("counters") or []
            if m["name"] == name
        )
        if total:
            resilience[name] = total
    if resilience:
        lines += ["", "## Resilience events", ""]
        for name, value in resilience.items():
            lines.append(f"- **{name}**: {_fmt(value)}")
    return lines


def _render_streaming_section(report: dict) -> list:
    """The out-of-core stream's measured tier economics (``stream.*`` /
    ``tiles.*``): per-tier stall vs hidden-overlap seconds for the
    disk→host and host→device stages, plus the host-cache and disk-store
    shape of a spilled run.  Empty when the run never streamed."""
    metrics = report.get("metrics") or {}
    counters = metrics.get("counters") or []
    gauges = metrics.get("gauges") or []

    def plain(name, coll):
        for m in coll:
            if m["name"] == name and not m.get("labels"):
                return m["value"]
        return None

    def by_tier(name):
        out = {}
        for m in counters:
            if m["name"] == name:
                out[(m.get("labels") or {}).get("tier", "")] = m["value"]
        return out

    if plain("stream.chunks", counters) is None:
        return []
    lines = ["", "## Streaming tiers", "",
             f"- **chunks delivered**: {_fmt(plain('stream.chunks', counters))}"]
    stalls = by_tier("stream.stall_s")
    overlaps = by_tier("stream.prefetch_overlap_s")
    tiers = [t for t in ("disk", "h2d") if t in stalls or t in overlaps]
    if tiers:
        lines += ["", "| tier | stall (s) | overlap hidden (s) |",
                  "|---|---|---|"]
        for tier in tiers:
            lines.append(
                f"| {tier} | {_fmt(stalls.get(tier, 0.0))} "
                f"| {_fmt(overlaps.get(tier, 0.0))} |"
            )
    cache = {
        name: plain(name, counters)
        for name in ("tiles.cache_hits", "tiles.cache_misses",
                     "tiles.cache_evictions", "tiles.rebuilt")
        if plain(name, counters) is not None
    }
    for name in ("tiles.host_cache_bytes", "tiles.disk_bytes"):
        value = plain(name, gauges)
        if value is not None:
            cache[name] = value
    if cache:
        lines.append("")
        for name, value in cache.items():
            lines.append(f"- **{name}**: {_fmt(value)}")
    return lines


def _render_entity_solves_section(report: dict) -> list:
    """The random-effect size-bin layout at a glance (``solves.*`` gauges):
    per (coordinate, bin) — routed solver, row capacity, live vs padded
    entities, and the padded fraction of the bin's entity×row cells — so
    the bin policy's padding waste is observable instead of guessed.
    Empty when the run trained no random-effect coordinate."""
    metrics = report.get("metrics") or {}
    by_bin: dict = {}
    for m in metrics.get("gauges") or []:
        if not m["name"].startswith("solves."):
            continue
        labels = m.get("labels", {})
        key = (labels.get("coordinate", "?"), labels.get("bin", "?"))
        entry = by_bin.setdefault(key, dict(labels))
        entry[m["name"]] = m["value"]
    if not by_bin:
        return []
    lines = [
        "", "## Entity solves", "",
        "| coordinate | bin | capacity | route | live entities "
        "| padded entities | padded fraction |",
        "|---|---|---|---|---|---|---|",
    ]
    for (coord, b) in sorted(by_bin):
        e = by_bin[(coord, b)]
        lines.append(
            f"| {coord} | {b} | {e.get('capacity', '—')} "
            f"| {e.get('route', '—')} "
            f"| {_fmt(e.get('solves.bin_occupancy'))} "
            f"| {_fmt(e.get('solves.bin_entities_padded'))} "
            f"| {_fmt(e.get('solves.padded_fraction'))} |"
        )
    return lines


def _render_serving_section(report: dict) -> list:
    """The online scoring service at a glance (``serving.*``): request/batch
    counters and the coalescing ratio they imply, padded fraction, cold
    entities, host syncs per batch (the ≤ 1 residency contract, made
    visible), and the latency/QPS numbers.  Empty when the run served
    nothing."""
    metrics = report.get("metrics") or {}
    counters = metrics.get("counters") or []
    gauges = metrics.get("gauges") or []

    def total(name):
        return sum(m["value"] for m in counters if m["name"] == name)

    def gauge(name):
        for m in gauges:
            if m["name"] == name and not m.get("labels"):
                return m["value"]
        return None

    batches = total("serving.batches")
    requests = total("serving.requests")
    if not batches and not requests:
        return []
    lines = ["", "## Online serving", ""]
    rows = [("serving.requests", requests),
            ("serving.batches", batches),
            ("serving.rows", total("serving.rows"))]
    if requests and batches:
        rows.append(("requests per batch (coalescing)",
                     round(requests / batches, 3)))
    if batches:
        rows.append(("serving.host_syncs per batch",
                     round(total("serving.host_syncs") / batches, 3)))
    cold = total("serving.cold_entities")
    if cold:
        rows.append(("serving.cold_entities", cold))
    compilations = total("serving.compilations")
    rows.append(("serving.compilations", compilations))
    for name in ("serving.qps", "serving.rows_per_second",
                 "serving.model_bytes"):
        v = gauge(name)
        if v is not None:
            rows.append((name, v))
    lines += ["| metric | value |", "|---|---|"]
    lines += [f"| {name} | {_fmt(value)} |" for name, value in rows]
    hists = [
        h for h in metrics.get("histograms") or []
        if h["name"] in ("serving.request_latency_s", "serving.score_seconds",
                         "serving.batch_rows", "serving.padded_fraction",
                         "serving.coalesced", "serving.admission_error_s")
    ]
    if hists:
        lines += ["", "| distribution | count | mean | p50 | p99 | max |",
                  "|---|---|---|---|---|---|"]
        for h in hists:
            lines.append(
                f"| {h['name']} | {h['count']} | {_fmt(h['mean'])} "
                f"| {_fmt(h['p50'])} | {_fmt(h['p99'])} | {_fmt(h['max'])} |"
            )
    return lines


def _render_fleet_section(report: dict) -> list:
    """The serving fleet at a glance (``serving.replica_*`` / shed /
    rollout metrics): per-replica traffic and health, the admission-control
    shed breakdown, the deadline hit rate over admitted requests, and the
    canary-rollout timeline.  Empty when the run never routed requests
    through a fleet (single-scorer serving keeps the plain "Online
    serving" section only)."""
    metrics = report.get("metrics") or {}
    counters = metrics.get("counters") or []
    gauges = metrics.get("gauges") or []

    def by_label(coll, name, label):
        out = {}
        for m in coll:
            if m["name"] == name:
                key = (m.get("labels") or {}).get(label, "?")
                out[key] = out.get(key, 0) + m["value"]
        return out

    def total(name):
        return sum(m["value"] for m in counters if m["name"] == name)

    replica_requests = by_label(counters, "serving.replica_requests",
                                "replica")
    if not replica_requests:
        return []
    replica_rows = by_label(counters, "serving.replica_rows", "replica")
    replica_deaths = by_label(counters, "serving.replica_deaths", "replica")
    rerouted = by_label(counters, "serving.rerouted", "replica")
    replica_qps = by_label(gauges, "serving.replica_qps", "replica")
    replica_depth = by_label(gauges, "serving.replica_depth", "replica")
    lines = ["", "## Serving fleet", "",
             "| replica | requests | rows | qps | depth peak (rows) "
             "| deaths | rerouted off |",
             "|---|---|---|---|---|---|---|"]
    for rid in sorted(replica_requests):
        lines.append(
            f"| {rid} | {_fmt(replica_requests[rid])} "
            f"| {_fmt(replica_rows.get(rid, 0))} "
            f"| {_fmt(replica_qps.get(rid))} "
            f"| {_fmt(replica_depth.get(rid))} "
            f"| {_fmt(replica_deaths.get(rid, 0))} "
            f"| {_fmt(rerouted.get(rid, 0))} |"
        )
    admitted = total("serving.admitted")
    shed = by_label(counters, "serving.shed", "reason")
    shed_total = sum(shed.values())
    offered = admitted + shed_total
    lines.append("")
    lines.append(f"- **admitted**: {_fmt(admitted)} of {_fmt(offered)} "
                 "offered")
    if shed_total:
        breakdown = ", ".join(
            f"{reason}={_fmt(count)}" for reason, count in sorted(shed.items())
        )
        lines.append(
            f"- **shed**: {_fmt(shed_total)} "
            f"({shed_total / offered:.1%} of offered) — {breakdown}"
        )
    missed = total("serving.deadline_missed")
    if admitted:
        lines.append(
            f"- **deadline hit rate**: {(admitted - missed) / admitted:.1%}"
            f" of admitted ({_fmt(missed)} missed)"
        )
    rollout_steps = []
    for m in gauges:
        if m["name"] == "serving.rollout_step":
            labels = m.get("labels") or {}
            rollout_steps.append(
                (m["value"], labels.get("replica", "?"),
                 labels.get("phase", "?"))
            )
    if rollout_steps:
        timeline = " → ".join(
            f"{rid}:{phase}" for _, rid, phase in sorted(rollout_steps)
        )
        lines.append(f"- **rollout timeline**: {timeline}")
    # Self-healing supervisor: deaths/restarts summary + the
    # event timeline (died-<cause> / respawn / rejoin-probe / rejoined /
    # respawn-failed / quarantined), same monotonic-gauge shape as the
    # rollout timeline.
    resurrections = by_label(counters, "serving.replica_resurrections",
                             "replica")
    quarantined = by_label(counters, "serving.replica_quarantined",
                           "replica")
    respawn_failures = total("serving.respawn_failures")
    supervisor_steps = []
    for m in gauges:
        if m["name"] == "serving.supervisor_step":
            labels = m.get("labels") or {}
            supervisor_steps.append(
                (m["value"], labels.get("replica", "?"),
                 labels.get("phase", "?"))
            )
    if resurrections or quarantined or respawn_failures or supervisor_steps:
        deaths_total = sum(replica_deaths.values())
        lines.append(
            f"- **supervisor**: deaths={_fmt(deaths_total)}, "
            f"resurrections={_fmt(sum(resurrections.values()))}, "
            f"respawn failures={_fmt(respawn_failures)}, "
            f"quarantined={_fmt(sum(quarantined.values()))}"
            + (f" ({', '.join(sorted(quarantined))})" if quarantined else "")
        )
    if supervisor_steps:
        timeline = " → ".join(
            f"{rid}:{phase}" for _, rid, phase in sorted(supervisor_steps)
        )
        lines.append(f"- **supervisor timeline**: {timeline}")
    # Child telemetry aggregation: subprocess
    # replicas' scorer counters arrive via the stats control frame merged
    # under the same names + a replica label — thread replicas' own
    # counters carry no replica label and are excluded here (key "?").
    child_syncs = by_label(counters, "serving.host_syncs", "replica")
    child_syncs.pop("?", None)
    if child_syncs:
        child_batches = by_label(counters, "serving.batches", "replica")
        child_cold = by_label(counters, "serving.cold_entities", "replica")
        parts = [
            f"{rid}: host_syncs={_fmt(child_syncs[rid])}, "
            f"batches={_fmt(child_batches.get(rid, 0))}, "
            f"cold_entities={_fmt(child_cold.get(rid, 0))}"
            for rid in sorted(child_syncs)
        ]
        lines.append("- **child scorers**: " + "; ".join(parts))
    return lines


def _render_online_section(report: dict) -> list:
    """The online-learning loop at a glance (``online.*`` + ``onboard.*``):
    rows/batches ingested, coordinates refreshed vs locked per refresh,
    the in-place device-data growth split (rows into headroom vs migrated
    vs new entities — the zero-full-rebuild contract made visible),
    append->serving refresh latency, and the staleness gauge.  Empty when
    the run performed no online refresh."""
    metrics = report.get("metrics") or {}
    counters = metrics.get("counters") or []
    gauges = metrics.get("gauges") or []

    def total(name):
        return sum(m["value"] for m in counters if m["name"] == name)

    def gauge(name):
        for m in gauges:
            if m["name"] == name and not m.get("labels"):
                return m["value"]
        return None

    refreshes = total("online.refreshes")
    ingested = total("online.rows_ingested")
    if not refreshes and not ingested:
        return []
    lines = ["", "## Online learning", "", "| metric | value |", "|---|---|"]
    rows = [
        ("online.refreshes", refreshes),
        ("online.batches_ingested", total("online.batches_ingested")),
        ("online.rows_ingested", ingested),
        ("online.coordinates_refreshed", total("online.coordinates_refreshed")),
        ("online.coordinates_locked", total("online.coordinates_locked")),
        ("online.publishes", total("online.publishes")),
    ]
    failures = total("online.refresh_failures")
    if failures:
        rows.append(("online.refresh_failures", failures))
    rollbacks = total("serving.rollout_rollbacks")
    if rollbacks:
        rows.append(("serving.rollout_rollbacks", rollbacks))
    for name in ("onboard.rows_in_place", "onboard.rows_migrated",
                 "onboard.entities_migrated", "onboard.entities_new",
                 "onboard.rows_absent"):
        v = total(name)
        if v:
            rows.append((name, v))
    stale = gauge("online.staleness_s")
    if stale is not None:
        rows.append(("online.staleness_s", stale))
    lines += [f"| {name} | {_fmt(value)} |" for name, value in rows]
    hists = [
        h for h in metrics.get("histograms") or []
        if h["name"] == "online.refresh_latency_s"
    ]
    if hists:
        lines += ["", "| distribution | count | mean | p50 | p99 | max |",
                  "|---|---|---|---|---|---|"]
        for h in hists:
            lines.append(
                f"| {h['name']} | {h['count']} | {_fmt(h['mean'])} "
                f"| {_fmt(h['p50'])} | {_fmt(h['p99'])} | {_fmt(h['max'])} |"
            )
    # Per-bin capacity headroom (the in-place growth budget): grouped like
    # the entity-solves section.
    by_bin: dict = {}
    for m in gauges:
        if not m["name"].startswith("onboard.bin_"):
            continue
        labels = m.get("labels", {})
        key = (labels.get("column", "?"), labels.get("bin", "?"))
        by_bin.setdefault(key, {})[m["name"]] = m["value"]
    if by_bin:
        lines += ["", "| column | bin | row cells | live rows | headroom |",
                  "|---|---|---|---|---|"]
        for (column, b) in sorted(by_bin):
            e = by_bin[(column, b)]
            lines.append(
                f"| {column} | {b} "
                f"| {_fmt(e.get('onboard.bin_row_capacity'))} "
                f"| {_fmt(e.get('onboard.bin_rows_live'))} "
                f"| {_fmt(e.get('onboard.bin_row_headroom'))} |"
            )
    return lines


def _render_observe_section(report: dict) -> list:
    """The fleet observability plane: cross-process trace
    critical paths (queue vs batch-wait vs transport vs compute per
    request, stage sum reconciling with end-to-end latency by
    construction), SLO burn-rate state + fired alerts, and the flight
    dumps collected from dead replicas.  Reads the driver-provided
    ``extra["observe"]`` payload (``FleetObserver.export()``); empty when
    the run was not observed."""
    observe = (report.get("extra") or {}).get("observe") or {}
    if not observe:
        return []
    lines = ["", "## Fleet traces / SLOs", ""]
    lines.append(
        f"- **tracing**: sample rate {_fmt(observe.get('sample_rate'))}, "
        f"{_fmt(observe.get('traces_kept'))} trace(s) kept, "
        f"{_fmt(observe.get('spans_merged'))} child span(s) merged"
    )
    paths = observe.get("critical_paths") or []
    if paths:
        stage_names = [s["stage"] for s in paths[0].get("stages", [])]
        lines += ["",
                  "| trace | procs | spans | total (s) | "
                  + " | ".join(f"{n} (s)" for n in stage_names) + " |",
                  "|---|---|---|---|" + "---|" * len(stage_names)]
        for cp in paths:
            stages = {s["stage"]: s["duration_s"]
                      for s in cp.get("stages", [])}
            lines.append(
                f"| {cp.get('trace_id', '?')} "
                f"| {len(cp.get('processes', []))} "
                f"| {_fmt(cp.get('spans'))} | {_fmt(cp.get('total_s'))} | "
                + " | ".join(_fmt(stages.get(n)) for n in stage_names)
                + " |"
            )
    slo = observe.get("slo") or {}
    slos = slo.get("slos") or []
    if slos:
        lines += ["", "| SLO | kind | objective | budget | fast burn "
                  "| slow burn | state |",
                  "|---|---|---|---|---|---|---|"]
        for row in slos:
            state = "**ALERT**" if row.get("alerting") else "ok"
            lines.append(
                f"| {row.get('name', '?')} | {row.get('kind', '?')} "
                f"| {_fmt(row.get('objective'))} | {_fmt(row.get('budget'))} "
                f"| {_fmt(row.get('fast_burn'))} "
                f"| {_fmt(row.get('slow_burn'))} | {state} |"
            )
    alerts = slo.get("alerts") or []
    if alerts:
        parts = ", ".join(
            f"{a.get('slo', '?')} (fast {_fmt(a.get('fast_burn'))}×)"
            for a in alerts
        )
        lines.append(f"- **alerts fired**: {len(alerts)} — {parts}")
    dumps = observe.get("flight_dumps") or []
    if dumps:
        lines += ["", "### Flight dumps", ""]
        for d in dumps:
            where = d.get("path") or "(in memory)"
            lines.append(
                f"- **{d.get('replica', '?')}** g{d.get('generation', 0)} "
                f"({d.get('cause', '?')}): "
                f"{_fmt(d.get('child_records'))} child record(s), "
                f"{_fmt(d.get('lost_spans_recovered'))} lost span(s) "
                f"recovered — {where}"
            )
    return lines


def render_markdown(report: dict) -> str:
    """Human-readable view of a run report dict."""
    lines = [
        f"# Run report: {report.get('driver', '?')}",
        "",
        f"- **run id**: {report.get('run_id', '?')}",
        f"- **status**: {report.get('status', '?')}"
        + (f" — {report['error']}" if report.get("error") else ""),
        f"- **duration**: {_fmt(report.get('duration_s'))} s",
    ]
    env = report.get("environment", {})
    if env:
        lines += ["", "## Environment", ""]
        for key in ("python", "platform", "pid"):
            if key in env:
                lines.append(f"- **{key}**: {env[key]}")
        torch_info = env.get("torch")
        if torch_info:
            lines.append(
                "- **torch**: "
                + ", ".join(f"{k}={v}" for k, v in torch_info.items())
            )
        if env.get("photon_env"):
            lines.append(
                "- **PHOTON_ env**: "
                + ", ".join(f"{k}={v}" for k, v in env["photon_env"].items())
            )

    totals = report.get("phase_totals") or {}
    if totals:
        lines += ["", "## Wall-clock by phase", "",
                  "| phase | total (s) |", "|---|---|"]
        for name, secs in sorted(totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"| {name} | {secs:.3f} |")

    lines += _render_pipeline_section(report)
    lines += _render_streaming_section(report)
    lines += _render_entity_solves_section(report)
    lines += _render_serving_section(report)
    lines += _render_fleet_section(report)
    lines += _render_observe_section(report)
    lines += _render_online_section(report)

    metrics = report.get("metrics") or {}
    counters = metrics.get("counters") or []
    gauges = metrics.get("gauges") or []
    if counters or gauges:
        lines += ["", "## Metrics", "",
                  "| metric | labels | value |", "|---|---|---|"]
        for entry in counters + gauges:
            lines.append(
                f"| {entry['name']} | {_fmt_labels(entry['labels'])} "
                f"| {_fmt(entry['value'])} |"
            )
    histograms = metrics.get("histograms") or []
    if histograms:
        lines += ["", "## Distributions", "",
                  "| metric | labels | count | mean | p50 | p99 | max |",
                  "|---|---|---|---|---|---|---|"]
        for entry in histograms:
            lines.append(
                f"| {entry['name']} | {_fmt_labels(entry['labels'])} "
                f"| {entry['count']} | {_fmt(entry['mean'])} "
                f"| {_fmt(entry['p50'])} | {_fmt(entry['p99'])} "
                f"| {_fmt(entry['max'])} |"
            )

    spans = report.get("spans") or []
    if spans:
        lines += ["", f"## Spans ({len(spans)})", ""]
        # Children finish before parents, so rebuild the tree for display.
        by_parent: dict = {}
        for sp in spans:
            by_parent.setdefault(sp.get("parent_id"), []).append(sp)

        def walk(parent_id, depth):
            for sp in sorted(
                by_parent.get(parent_id, []), key=lambda s: s["start_time"]
            ):
                flag = "" if sp.get("status") == "ok" else " **[error]**"
                lines.append(
                    f"{'  ' * depth}- {sp['name']}: "
                    f"{_fmt(sp.get('duration_s'))} s{flag}"
                )
                walk(sp["span_id"], depth + 1)

        walk(None, 0)
    return "\n".join(lines) + "\n"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "photon_tpu_torch.telemetry.report",
        description="Render a telemetry run_report.json as markdown.",
    )
    p.add_argument("report", help="path to run_report.json (or a driver "
                   "output dir containing telemetry/run_report.json)")
    p.add_argument("-o", "--output", default=None,
                   help="write markdown here instead of stdout")
    return p


def resolve_report_path(path: str) -> str:
    if os.path.isdir(path):
        nested = os.path.join(path, "telemetry", "run_report.json")
        return nested if os.path.exists(nested) else os.path.join(
            path, "run_report.json"
        )
    return path


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    with open(resolve_report_path(args.report)) as f:
        report = json.load(f)
    text = render_markdown(report)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)


if __name__ == "__main__":
    main()
