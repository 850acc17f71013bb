"""The port's telemetry and fault modules against the JAX package's.

They are copies, so the same writes give the same snapshot, Prometheus
text and markdown report in both packages; the port's environment capture
reads torch; the fault plan, the retry layer and the watchdog behave as
the reference's (``tests/test_telemetry.py``, ``tests/test_fault_injection.py``);
``telemetry_run`` writes the run report of a driver run, also of a failed
one.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

from photon_tpu import telemetry as ref_telemetry
from photon_tpu.fault import injection as ref_injection
from photon_tpu.telemetry import report as ref_report
from photon_tpu_torch import telemetry
from photon_tpu_torch.fault import injection, retry, watchdog
from photon_tpu_torch.telemetry import report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(session):
    session.counter("serving.requests").inc(3)
    session.counter("serving.batches", bucket=8).inc(2)
    session.counter("serving.host_syncs").inc(2)
    session.counter("serving.replica_requests", replica="r0").inc(3)
    session.counter("serving.shed", reason="deadline").inc()
    session.gauge("serving.qps").set(12.5)
    session.gauge("serving.rollout_step", replica="r0", phase="canary").set(1)
    for v in range(300):
        session.histogram("serving.request_latency_s").observe(v / 1000.0)
    with session.span("outer", k=1):
        with session.span("inner"):
            pass


def test_same_writes_same_snapshot_prometheus_and_markdown():
    ours, theirs = telemetry.TelemetrySession("t"), ref_telemetry.TelemetrySession("t")
    _write(ours)
    _write(theirs)
    assert ours.registry.snapshot() == theirs.registry.snapshot()
    assert ours.registry.to_prometheus() == theirs.registry.to_prometheus()
    rep = {"driver": "t", "run_id": "x", "status": "success",
           "metrics": ours.registry.snapshot(),
           "phase_totals": ours.tracer.phase_totals()}
    assert report.render_markdown(rep) == ref_report.render_markdown(rep)
    assert "## Online serving" in report.render_markdown(rep)
    assert [s["name"] for s in ours.tracer.export()] == ["inner", "outer"]


def test_registry_kinds_and_thread_safety():
    reg = telemetry.MetricsRegistry()
    with pytest.raises(TypeError):
        reg.counter("x")
        reg.gauge("x")
    with pytest.raises(ValueError):
        reg.counter("y").inc(-1)
    threads = [threading.Thread(target=lambda: [reg.counter("c").inc()
                                                for _ in range(1000)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert reg.counter("c").value == 8000


def test_environment_reads_torch_and_finalize_writes_artifacts(tmp_path):
    env = report.capture_environment()
    assert "jax" not in env
    import torch

    assert env["torch"]["version"] == torch.__version__
    assert "device" in env["torch"]
    session = telemetry.TelemetrySession("t")
    _write(session)
    rep = session.finalize(str(tmp_path))
    assert rep is session.finalize(str(tmp_path))  # idempotent
    with open(tmp_path / "telemetry" / "run_report.json") as f:
        assert json.load(f)["metrics"] == session.registry.snapshot()
    assert (tmp_path / "telemetry" / "spans.jsonl").read_text().count("\n") == 2
    md = report.render_markdown(json.loads(json.dumps(rep, default=str)))
    assert "- **torch**: " in md
    assert telemetry.NULL_SESSION.finalize(str(tmp_path / "none")) is None
    assert not (tmp_path / "none").exists()


def test_env_var_gate(monkeypatch):
    monkeypatch.setenv("PHOTON_TELEMETRY", "off")
    assert not telemetry.telemetry_enabled(True)
    monkeypatch.delenv("PHOTON_TELEMETRY")
    assert telemetry.telemetry_enabled(None) and not telemetry.telemetry_enabled(False)


@pytest.mark.parametrize("spec", ["io:read:p=0.5,serve:replica_kill:replica=r1:times=1",
                                  "transport:read:times=2,preempt:iter=1"])
def test_fault_plan_fires_as_the_reference(spec):
    def fires(mod):
        mod.set_plan(mod.FaultPlan.parse(spec, seed=3))
        out = []
        try:
            for i in range(12):
                for site, ctx in (("io:read", {}), ("serve:replica_kill", {"replica": f"r{i % 2}"}),
                                  ("transport:read", {})):
                    try:
                        mod.fault_point(site, **ctx)
                        out.append(None)
                    except mod.InjectedFaultError as e:
                        out.append(type(e).__name__)
        finally:
            mod.set_plan(None)
        return out

    assert fires(injection) == fires(ref_injection)
    assert injection.KNOWN_FAULT_SITES == ref_injection.KNOWN_FAULT_SITES


def test_retry_recovers_counts_and_gives_up(monkeypatch):
    monkeypatch.setenv("PHOTON_IO_RETRY_BASE_S", "0")
    session = telemetry.TelemetrySession("retry")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry.retry_call(flaky, site="model:load", telemetry=session) == "ok"
    retries = [m for m in session.registry.snapshot()["counters"]
               if m["name"] == "io.retries"]
    assert retries[0]["labels"] == {"site": "model:load"} and retries[0]["value"] == 2
    with pytest.raises(OSError):
        retry.retry_call(lambda: (_ for _ in ()).throw(OSError("down")),
                         site="io:write", policy=retry.RetryPolicy(attempts=2, base_delay_s=0.0))
    with pytest.raises(ValueError):  # not retriable
        retry.retry_call(lambda: (_ for _ in ()).throw(ValueError("bad")), site="x")


def test_watchdog_heartbeats_and_timeout():
    watchdog.heartbeat("site-a")
    assert watchdog.age_of("site-a") is not None and watchdog.age_of("site-a") >= 0
    watchdog.complete("site-a")
    assert watchdog.age_of("site-a") is None
    assert watchdog.call_with_timeout(lambda: 5, 10.0, site="s") == 5
    with pytest.raises(watchdog.IOStallTimeoutError):
        watchdog.call_with_timeout(lambda: threading.Event().wait(5), 0.05, site="s")


def test_telemetry_run_writes_reports_of_success_and_failure(tmp_path):
    import argparse

    from photon_tpu_torch.drivers import common

    logger = common.RunLogger("t")
    args = argparse.Namespace(output_dir=str(tmp_path / "ok"), telemetry=True)
    with common.telemetry_run(args, "drv", logger) as session:
        with logger.timed("phase-a"):
            session.counter("c").inc()
    with open(tmp_path / "ok" / "telemetry" / "run_report.json") as f:
        rep = json.load(f)
    assert rep["status"] == "success" and "phase-a" in rep["phase_totals"]
    args = argparse.Namespace(output_dir=str(tmp_path / "bad"), telemetry=True)
    with pytest.raises(RuntimeError, match="boom"):
        with common.telemetry_run(args, "drv", logger):
            raise RuntimeError("boom")
    with open(tmp_path / "bad" / "telemetry" / "run_report.json") as f:
        rep = json.load(f)
    assert rep["status"] == "error" and "boom" in rep["error"]
    args = argparse.Namespace(output_dir=str(tmp_path / "off"), telemetry=False)
    with common.telemetry_run(args, "drv", logger):
        pass
    assert not (tmp_path / "off" / "telemetry").exists()


def test_report_cli_renders_a_run_dir(tmp_path):
    session = telemetry.TelemetrySession("cli")
    _write(session)
    session.finalize(str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "photon_tpu_torch.telemetry.report", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "# Run report: cli" in out.stdout and "## Online serving" in out.stdout
