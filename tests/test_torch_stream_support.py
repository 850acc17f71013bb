"""The port's host-IO pool and cache-root contract (``photon_tpu_torch/utils/
io_pool.py``, ``utils/caches.py``), held to tests/test_io_pool.py and
tests/test_caches.py and to the JAX package's copies on the same calls."""

import os
import time

import numpy as np
import pytest
import torch

from photon_tpu.utils import caches as ref_caches
from photon_tpu.utils import io_pool as ref_pool
from photon_tpu_torch.utils import caches, io_pool
from photon_tpu_torch.utils.caches import resolve_cache_dir
from photon_tpu_torch.utils.io_pool import map_ordered


def test_map_ordered_preserves_order_and_window():
    started = []

    def work(i):
        started.append(i)
        time.sleep(0.002 * (7 - i % 8))  # later items often finish first
        return i * i

    out = []
    for r in map_ordered(work, range(40), workers=4, window=6):
        out.append(r)
        time.sleep(0.004)  # a slow consumer: unbounded submission would race
        assert len(started) <= len(out) + 6, (
            f"window exceeded: {len(started)} started, {len(out)} consumed")
    assert out == [i * i for i in range(40)]


def test_map_ordered_sequential_fallback_and_errors():
    seen = []

    def trace(i):
        seen.append(i)
        return i

    it = map_ordered(trace, [1, 2, 3], workers=1)
    assert next(it) == 1 and seen == [1], "workers=1 must stay lazy"

    def boom(i):
        if i == 3:
            raise ValueError("file 3 is corrupt")
        return i

    out = []
    with pytest.raises(ValueError, match="file 3"):
        for r in map_ordered(boom, range(6), workers=3):
            out.append(r)
    assert out == [0, 1, 2], "items before the failure must still deliver"


def test_map_ordered_abandon_cancels_pending():
    started = []

    def work(i):
        started.append(i)
        time.sleep(0.005)
        return i

    it = map_ordered(work, range(100), workers=2, window=3)
    assert next(it) == 0
    it.close()
    time.sleep(0.05)
    assert len(started) <= 10, f"abandoned iterator kept working: {started}"


def test_map_ordered_marks_pool_workers():
    marks = list(map_ordered(lambda i: io_pool.in_pool_worker(), range(4), workers=2))
    assert marks == [True] * 4
    assert not io_pool.in_pool_worker()
    assert list(map_ordered(lambda i: io_pool.in_pool_worker(), range(2),
                            workers=1)) == [False, False]


def test_map_ordered_retries_transient_errors(monkeypatch):
    from photon_tpu_torch.telemetry import TelemetrySession

    failed = set()

    def flaky(i):
        if i == 2 and i not in failed:
            failed.add(i)
            raise OSError("transient")
        return i

    monkeypatch.setenv("PHOTON_IO_RETRY_BASE_S", "0")
    session = TelemetrySession("t")
    out = list(map_ordered(flaky, range(4), workers=2, retry_site="libsvm:read",
                           telemetry=session))
    assert out == [0, 1, 2, 3]
    assert session.counter("io.retries", site="libsvm:read").value == 1


@pytest.mark.parametrize("value,expected", [("3", 3), ("0", None), ("junk", None)])
def test_io_threads_env(monkeypatch, value, expected):
    monkeypatch.setenv("PHOTON_IO_THREADS", value)
    got = io_pool.io_threads()
    assert got == ref_pool.io_threads()
    if expected is None:
        assert got == max(1, min(os.cpu_count() or 1, 8))
    else:
        assert got == expected


def test_submit_runs_on_named_pools():
    fut = io_pool.submit(lambda: 7)
    assert fut.result(timeout=5) == 7
    assert io_pool.submit(lambda: 8, pool="tile-prefetch").result(timeout=5) == 8


def test_map_ordered_telemetry_gauges():
    from photon_tpu_torch.telemetry import TelemetrySession

    session = TelemetrySession("t")
    out = list(map_ordered(lambda i: i + 1, range(20), workers=4, window=6,
                           telemetry=session))
    assert out == list(range(1, 21))
    assert session.gauge("io_pool.workers").value == 4
    peak = session.gauge("io_pool.in_flight_peak").value
    assert 1 <= peak <= 6
    assert session.gauge("io_pool.in_flight").value == 0
    seq = TelemetrySession("t2")
    list(map_ordered(lambda i: i, range(3), workers=1, telemetry=seq))
    assert seq.gauge("io_pool.in_flight_peak").value is None


def test_pooled_stream_pass_matches_sequential(tmp_path, monkeypatch):
    """A streamed pass over part files: pooled chunk loads give the value
    and gradient of the single-thread prefetch bit for bit."""
    from photon_tpu.data.synthetic import make_glm_data, write_libsvm
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.data.streaming import LibsvmFileSource, StreamingObjective

    files = []
    for i in range(5):
        batch, _ = make_glm_data(60, 16, task="logistic_regression", seed=i)
        p = str(tmp_path / f"part-{i}.libsvm")
        write_libsvm(p, np.asarray(batch.x), np.asarray(batch.label))
        files.append(p)

    def run():
        source = LibsvmFileSource(files, intercept=True, device="cpu")
        obj = StreamingObjective(
            GlmObjective.create("logistic", RegularizationContext("l2", 0.5)),
            source.chunk_iter_factory)
        v, g = obj.value_and_grad(torch.zeros(source.dim))
        return float(v), g.numpy()

    monkeypatch.setenv("PHOTON_IO_THREADS", "1")
    v1, g1 = run()
    monkeypatch.setenv("PHOTON_IO_THREADS", "4")
    v4, g4 = run()
    assert v1 == v4
    np.testing.assert_array_equal(g1, g4)


# -- the cache-root contract (tests/test_caches.py) ---------------------------

CACHE_CASES = [
    # (env, name, subdir, expected)
    ({"PHOTON_LAYOUT_CACHE": "/tmp/somewhere", "PHOTON_ROUTE_CACHE": "/tmp/elsewhere"},
     "PHOTON_LAYOUT_CACHE", "layouts", "/tmp/somewhere"),
    ({"PHOTON_LAYOUT_CACHE": "0", "PHOTON_ROUTE_CACHE": "/tmp/elsewhere"},
     "PHOTON_LAYOUT_CACHE", "layouts", None),
    ({"PHOTON_ROUTE_CACHE": "/tmp/routes"}, "PHOTON_LAYOUT_CACHE", "layouts",
     os.path.join("/tmp/routes", "layouts")),
    ({"PHOTON_ROUTE_CACHE": "0"}, "PHOTON_STREAM_LAYOUT_CACHE", "stream", None),
    ({"PHOTON_ROUTE_CACHE": "/tmp/routes"}, "PHOTON_ROUTE_CACHE", "", "/tmp/routes"),
    ({"PHOTON_ROUTE_CACHE": "0", "PHOTON_LAYOUT_CACHE": "/tmp/explicit"},
     "PHOTON_LAYOUT_CACHE", "layouts", "/tmp/explicit"),
]


@pytest.mark.parametrize("env,name,subdir,expected", CACHE_CASES, ids=[
    "override_wins", "zero_disables", "follows_route_cache",
    "route_zero_disables_followers", "route_cache_resolves_own_root",
    "override_wins_when_route_disabled"])
def test_resolve_cache_dir(monkeypatch, env, name, subdir, expected):
    for var in ("PHOTON_LAYOUT_CACHE", "PHOTON_ROUTE_CACHE", "PHOTON_STREAM_LAYOUT_CACHE"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    got = resolve_cache_dir(name, subdir)
    assert got == expected
    assert got == ref_caches.resolve_cache_dir(name, subdir)


def test_default_root_location(monkeypatch, tmp_path):
    monkeypatch.delenv("PHOTON_ROUTE_CACHE", raising=False)
    caches.default_route_cache_root.cache_clear()
    monkeypatch.chdir(tmp_path)  # no legacy directory here
    try:
        assert caches.default_route_cache_root() == os.path.join(
            os.path.expanduser("~"), ".cache", "photon_tpu", "routes")
        assert resolve_cache_dir("PHOTON_ROUTE_CACHE", "") is not None
        caches.default_route_cache_root.cache_clear()
        os.makedirs(tmp_path / ".photon_route_cache")
        assert caches.default_route_cache_root() == str(tmp_path / ".photon_route_cache")
    finally:
        caches.default_route_cache_root.cache_clear()


def test_stream_layout_cache_lives_apart_from_the_jax_packages(monkeypatch, tmp_path):
    """The port's stream-layout files go under ``torch/`` of the root the
    JAX package uses, so neither package loads the other's files."""
    from photon_tpu.data import stream_layouts as ref_sl
    from photon_tpu_torch.data import stream_layouts as sl

    monkeypatch.setenv("PHOTON_STREAM_LAYOUT_CACHE", str(tmp_path / "c"))
    part = tmp_path / "part.libsvm"
    part.write_text("1 1:0.5\n")
    mine = sl._aux_cache_path(str(part), 8, "xchg", "cumsum", 2)
    theirs = ref_sl._aux_cache_path(str(part), 8, "xchg", "cumsum", 2)
    assert os.path.dirname(mine) == str(tmp_path / "c" / "torch")
    assert os.path.dirname(theirs) == str(tmp_path / "c")
    monkeypatch.setenv("PHOTON_STREAM_LAYOUT_CACHE", "0")
    assert sl._aux_cache_path(str(part), 8, "xchg", "cumsum", 2) is None
