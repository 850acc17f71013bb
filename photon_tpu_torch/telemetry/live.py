"""Live fleet console: poll a FleetObserver's HTTP plane, render a table.

A copy of ``photon_tpu/telemetry/live.py``.

``python -m photon_tpu_torch.telemetry.live --url http://127.0.0.1:PORT`` polls
the :class:`~photon_tpu_torch.serving.observe.MetricsPlane` JSON endpoint (the
same server whose ``/metrics`` path speaks Prometheus text) and renders
the fleet snapshot as a terminal table: per-model-version QPS / p50 / p99
/ shed rate, merged child compute-latency quantiles, SLO burn-rate state,
and flight-dump count.  ``--once`` prints a single frame and exits (the
mode tests drive); without it the view refreshes every ``--interval``
seconds until interrupted.

Stdlib only (urllib) — the console must work wherever the fleet does,
including containers with nothing installed beyond the package itself.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request


def fetch_snapshot(url: str, timeout_s: float = 5.0) -> dict:
    """GET the observer's JSON snapshot (any path except /metrics)."""
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _fmt_ms(seconds) -> str:
    if seconds is None:
        return "-"
    return f"{float(seconds) * 1e3:.2f}ms"


def render_snapshot(snap: dict) -> str:
    """One console frame from a ``FleetObserver.fleet_snapshot()`` dict."""
    lines = []
    lines.append(
        f"fleet @ {time.strftime('%H:%M:%S')} — "
        f"window {snap.get('window_s', '?')}s, "
        f"{snap.get('traces', 0)} trace(s) kept, "
        f"{snap.get('flight_dumps', 0)} flight dump(s)"
    )
    versions = snap.get("versions") or {}
    header = (f"{'version':>8} {'qps':>8} {'rows/s':>10} {'p50':>10} "
              f"{'p99':>10} {'shed%':>7} {'err%':>6} {'reqs':>7}")
    lines.append(header)
    lines.append("-" * len(header))
    if not versions:
        lines.append("  (no traffic in window)")
    for version in sorted(versions, key=str):
        row = versions[version]
        lines.append(
            f"{str(version):>8} {row.get('qps', 0.0):>8.1f} "
            f"{row.get('rows_per_s', 0.0):>10.1f} "
            f"{_fmt_ms(row.get('p50_s')):>10} "
            f"{_fmt_ms(row.get('p99_s')):>10} "
            f"{100.0 * row.get('shed_rate', 0.0):>6.1f}% "
            f"{100.0 * row.get('error_rate', 0.0):>5.1f}% "
            f"{row.get('requests', 0):>7d}"
        )
    compute = snap.get("child_compute") or {}
    if compute.get("count"):
        lines.append(
            f"child compute: p50 {_fmt_ms(compute.get('p50_s'))} "
            f"p99 {_fmt_ms(compute.get('p99_s'))} "
            f"({compute['count']} batch(es))"
        )
    slo = snap.get("slo") or {}
    for row in slo.get("slos", []):
        state = "ALERT" if row.get("alerting") else "ok"
        lines.append(
            f"slo {row.get('name', '?'):<16} {state:<5} "
            f"fast-burn {row.get('fast_burn', 0.0):.2f} "
            f"slow-burn {row.get('slow_burn', 0.0):.2f}"
        )
    alerts = slo.get("alerts", [])
    if alerts:
        lines.append(f"alerts fired: {len(alerts)} "
                     f"(latest: {alerts[-1].get('slo', '?')})")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m photon_tpu_torch.telemetry.live",
        description="Live console view of a serving fleet's metrics plane.",
    )
    parser.add_argument("--url", required=True,
                        help="observer HTTP address, e.g. http://127.0.0.1:9900")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="refresh period in seconds (default 2)")
    parser.add_argument("--once", action="store_true",
                        help="print one frame and exit")
    args = parser.parse_args(argv)

    url = args.url
    if not url.startswith("http"):
        url = f"http://{url}"
    while True:
        try:
            snap = fetch_snapshot(url)
        except Exception as e:  # noqa: BLE001 — operator-facing CLI
            print(f"live: fetch from {url} failed: {e}", file=sys.stderr)
            return 1
        print(render_snapshot(snap))
        if args.once:
            return 0
        print()
        time.sleep(max(0.05, args.interval))


if __name__ == "__main__":
    sys.exit(main())
