"""The port's streamed GLM training (``photon_tpu_torch/data/streaming.py``
and ``train --stream``), mirroring tests/test_streaming.py and held to the
JAX package's streamed path on the same part files.

Tolerances: a chunked fold against the flat batch, value rtol 1e-5 and
gradient rtol 1e-4 / atol 1e-5 (float32 sums in another grouping); a
streamed pass against the JAX package's, value rtol 1e-5 and gradient atol
1e-5; a streamed L-BFGS against the JAX package's, value rtol 1e-5 and
coefficients atol 1e-4 (the same host loop on float32 sums in another
order); a fit resumed in one package from the other's mid-fit snapshot,
value rtol 1e-5 and coefficients rtol 1e-2 / atol 1e-3; against the
resident fit, tests/test_streaming.py:272-275's value rtol 1e-4 and
coefficients rtol 5e-2 / atol 5e-3 (another optimizer's stopping point); a
resumed fit against the uninterrupted one, exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxConfig
from photon_tpu.data import streaming as jax_streaming
from photon_tpu.data.synthetic import make_glm_data, write_libsvm
from photon_tpu.fault import checkpoint as jax_checkpoint
from photon_tpu.fault import injection as jax_injection
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig, lbfgs
from photon_tpu_torch.data.batch import SparseBatch
from photon_tpu_torch.data.streaming import (
    ChunkedGlmObjective,
    LibsvmFileSource,
    StreamingObjective,
    chunk_batch,
    make_global_batch,
    map_batch_tensors,
    shard_files_for_process,
    stream_chunks,
    streaming_lbfgs,
)
from photon_tpu_torch.drivers import train
from photon_tpu_torch.fault.checkpoint import StreamCheckpointer
from photon_tpu_torch.fault.injection import FaultPlan, InjectedKillError, set_plan

D = 40


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "autodiff")
    monkeypatch.setenv("PHOTON_ROUTE_CACHE", "0")
    monkeypatch.delenv("PHOTON_STREAM_KERNEL", raising=False)


def _sparse_data(n=900, k=5, d=64, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, d, size=(n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    w_true = (rng.standard_normal(d) * 0.4).astype(np.float32)
    m = (w_true[ids] * vals).sum(1)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-m))).astype(np.float32)
    return SparseBatch(*(torch.as_tensor(a) for a in (
        ids, vals, y, np.zeros(n, np.float32), np.ones(n, np.float32))))


def test_chunked_objective_matches_flat():
    batch = _sparse_data()
    chunks = chunk_batch(batch, rows_per_chunk=128)
    assert chunks.num_chunks == 8 and chunks.num_examples == 1024
    assert float(chunks.weight[-1, -1]) == 0.0  # pad rows weigh nothing
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 0.5))
    cobj = ChunkedGlmObjective(obj)
    assert cobj.l2_weight == 0.5 and cobj.l1_weight == 0.0
    w = torch.as_tensor(np.random.default_rng(1).standard_normal(64).astype(np.float32))
    v1, g1 = obj.value_and_grad(w, batch)
    v2, g2 = cobj.value_and_grad(w, chunks)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-5)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cobj.grad(w, chunks).numpy(), g2.numpy())
    np.testing.assert_allclose(float(obj.value(w, batch)), float(cobj.value(w, chunks)),
                               rtol=1e-5)
    v = torch.ones(64)
    np.testing.assert_allclose(obj.hessian_vector(w, v, batch).numpy(),
                               cobj.hessian_vector(w, v, chunks).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(obj.hessian_diagonal(w, batch).numpy(),
                               cobj.hessian_diagonal(w, chunks).numpy(),
                               rtol=1e-4, atol=1e-4)
    small = _sparse_data(n=50, d=8)
    np.testing.assert_allclose(
        obj.hessian_matrix(w[:8], small).numpy(),
        cobj.hessian_matrix(w[:8], chunk_batch(small, 16)).numpy(), rtol=1e-4, atol=1e-4)


def test_chunked_objective_full_fit_matches():
    batch = _sparse_data(seed=2)
    chunks = chunk_batch(batch, rows_per_chunk=256)
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 1.0))
    cobj = ChunkedGlmObjective(obj)
    config = OptimizerConfig(max_iterations=40)
    w0 = torch.zeros(64)
    r1 = lbfgs(lambda w: obj.value_and_grad(w, batch), w0, config)
    r2 = lbfgs(lambda w: cobj.value_and_grad(w, chunks), w0, config)
    np.testing.assert_allclose(r1.value, r2.value, rtol=1e-4)
    np.testing.assert_allclose(r1.w.numpy(), r2.w.numpy(), rtol=1e-2, atol=1e-3)


def test_stream_chunks_order_and_prefetch(monkeypatch):
    monkeypatch.setenv("PHOTON_IO_THREADS", "1")  # the single prefetching thread
    seen = []

    def load(i):
        seen.append(i)
        return None if i == 2 else torch.full((2,), float(i))

    out = list(stream_chunks(load, 5, prefetch=2))
    assert [int(o[0]) for o in out] == [0, 1, 3, 4]  # None skips
    assert seen == [0, 1, 2, 3, 4]


def test_stream_chunks_pooled_delivery_order(monkeypatch):
    """The pool delivers in order when loads finish out of order, and never
    starts more than ``prefetch`` loads ahead of the consumer."""
    import time

    monkeypatch.setenv("PHOTON_IO_THREADS", "4")
    started = []

    def load(i):
        started.append(i)
        time.sleep(0.002 * ((i * 3) % 4))
        return torch.full((2,), float(i))

    out = []
    for c in stream_chunks(load, 8, prefetch=2):
        out.append(c)
        time.sleep(0.005)
        assert len(started) <= len(out) + 2, f"{len(started)} started, {len(out)} consumed"
    assert [int(o[0]) for o in out] == list(range(8))


@pytest.mark.parametrize("threads", ["1", "4"])
def test_stream_chunks_propagates_worker_error(monkeypatch, threads):
    monkeypatch.setenv("PHOTON_IO_THREADS", threads)

    def load(i):
        if i == 2:
            raise RuntimeError("disk error")
        return torch.zeros(1)

    with pytest.raises(RuntimeError, match="disk error"):
        list(stream_chunks(load, 4))


def test_stream_chunks_records_its_pass(monkeypatch):
    from photon_tpu_torch.data.streaming import StreamStats

    monkeypatch.setenv("PHOTON_IO_THREADS", "2")
    batch = _sparse_data(n=32)
    stats = StreamStats()
    out = list(stream_chunks(lambda i: batch, 3, device="cpu", stats=stats))
    assert len(out) == 3 and stats.chunks == 3 and stats.rows == 96
    assert stats.rss_peak_bytes >= stats.rss_start_bytes > 0
    assert stats.resolve().copy_ms == 0.0  # no card, no copies
    doubled = map_batch_tensors(batch, lambda t: t * 2)
    assert torch.equal(doubled.vals, batch.vals * 2) and doubled.fm is None


def test_shard_files_for_process():
    files = [f"part-{i:03d}" for i in range(10)]
    shards = [shard_files_for_process(files, p, 3) for p in range(3)]
    assert sorted(sum(shards, [])) == files
    assert abs(len(shards[0]) - len(shards[2])) <= 1
    assert shard_files_for_process(files, 0, 1) == files
    assert shard_files_for_process(files) == files  # no process group: rank 0 of 1
    for p in range(3):
        assert shards[p] == jax_streaming.shard_files_for_process(files, p, 3)


def _write_files(tmp_path, n_files=3, rows=120, d=D, seed=0):
    paths, xs, ys = [], [], []
    for i in range(n_files):
        b, _ = make_glm_data(rows, d, seed=seed + i, weight_seed=7)
        x = np.asarray(b.x)[:, :-1]
        y = np.asarray(b.label)
        p = str(tmp_path / f"part-{i}.libsvm")
        write_libsvm(p, x, y)
        paths.append(p)
        xs.append(x)
        ys.append(y)
    return paths, np.concatenate(xs), np.concatenate(ys)


def _objective(source, l2=1.0):
    return StreamingObjective(
        GlmObjective.create("logistic", RegularizationContext("l2", l2)),
        source.chunk_iter_factory)


def _jax_objective(paths, l2=1.0):
    source = jax_streaming.LibsvmFileSource(paths)
    return source, jax_streaming.StreamingObjective(
        JaxObjective.create("logistic", JaxReg("l2", l2)), source.chunk_iter_factory)


def test_streaming_objective_matches_jax(tmp_path):
    paths, _, y = _write_files(tmp_path)
    source = LibsvmFileSource(paths, device="cpu")
    assert source.num_examples == len(y)
    jax_source, jax_obj = _jax_objective(paths, l2=0.3)
    assert (source.dim, source.capacity) == (jax_source.dim, jax_source.capacity)
    w = (np.random.default_rng(4).standard_normal(source.dim) * 0.2).astype(np.float32)
    obj = _objective(source, l2=0.3)
    v, g = obj.value_and_grad(torch.as_tensor(w))
    v_ref, g_ref = jax_obj.value_and_grad(jnp.asarray(w))
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-4, atol=1e-5)
    assert obj.last_kernel == "autodiff"
    assert source.last_pass.chunks == 3 and source.last_pass.rows == len(y)


def test_streaming_lbfgs_matches_jax_and_the_resident_fit(tmp_path):
    paths, x, y = _write_files(tmp_path)
    source = LibsvmFileSource(paths, device="cpu")
    config = OptimizerConfig(max_iterations=40)
    result = streaming_lbfgs(_objective(source), torch.zeros(source.dim), config)
    assert result.converged
    _, jax_obj = _jax_objective(paths)
    ref = jax_streaming.streaming_lbfgs(jax_obj, jnp.zeros(source.dim, jnp.float32),
                                        JaxConfig(max_iterations=40))
    np.testing.assert_allclose(result.value, float(ref.value), rtol=1e-5)
    np.testing.assert_allclose(result.w.numpy(), np.asarray(ref.w), atol=1e-4)
    assert int(result.reason) == int(ref.reason)

    # The resident fit of the port on the concatenated rows.
    from photon_tpu_torch.data.libsvm import load_sparse_batch

    parts = [load_sparse_batch(p, dim=source.feature_dim, capacity=source.capacity,
                               device="cpu")[0] for p in paths]
    flat = SparseBatch(*(torch.cat(cols) for cols in zip(*(b[:5] for b in parts))))
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 1.0))
    resident = lbfgs(lambda w: obj.value_and_grad(w, flat), torch.zeros(source.dim), config)
    np.testing.assert_allclose(result.value, resident.value, rtol=1e-4)
    np.testing.assert_allclose(result.w.numpy(), resident.w.numpy(), rtol=5e-2, atol=5e-3)


def test_streaming_lbfgs_kill_and_resume_exact(tmp_path):
    """A fit killed at ``stream:kill`` and resumed from its mid-fit snapshot
    repeats the uninterrupted fit exactly."""
    paths, _, _ = _write_files(tmp_path)
    source = LibsvmFileSource(paths, device="cpu")
    config = OptimizerConfig(max_iterations=25)
    w0 = torch.zeros(source.dim)
    baseline = streaming_lbfgs(_objective(source), w0, config)

    ckpt = StreamCheckpointer(str(tmp_path / "ckpt"), async_publish="on")
    set_plan(FaultPlan.parse("stream:kill:iter=3"))
    try:
        with pytest.raises(InjectedKillError):
            streaming_lbfgs(_objective(source), w0, config, checkpointer=ckpt)
    finally:
        set_plan(None)
    state = ckpt.load("latest")
    assert state is not None and not state.completed and state.iteration <= 3
    resumed = streaming_lbfgs(_objective(source), w0, config, checkpointer=ckpt,
                              resume_state=state)
    np.testing.assert_array_equal(baseline.w.numpy(), resumed.w.numpy())
    assert (baseline.iterations, baseline.reason) == (resumed.iterations, resumed.reason)
    np.testing.assert_array_equal(baseline.history_value, resumed.history_value)


def test_streaming_completed_checkpoint_rebuilds_without_passes(tmp_path):
    paths, _, _ = _write_files(tmp_path)
    source = LibsvmFileSource(paths, device="cpu")
    config = OptimizerConfig(max_iterations=25)
    passes = {"n": 0}

    def counting_factory():
        passes["n"] += 1
        return source.chunk_iter_factory()

    obj = GlmObjective.create("logistic", RegularizationContext("l2", 1.0))
    ckpt = StreamCheckpointer(str(tmp_path / "ckpt"))
    w0 = torch.zeros(source.dim)
    fitted = streaming_lbfgs(StreamingObjective(obj, counting_factory), w0, config,
                             checkpointer=ckpt)
    state = ckpt.load("latest")
    assert state is not None and state.completed
    passes["n"] = 0
    rebuilt = streaming_lbfgs(StreamingObjective(obj, counting_factory), w0, config,
                              checkpointer=ckpt, resume_state=state)
    assert passes["n"] == 0
    np.testing.assert_array_equal(fitted.w.numpy(), rebuilt.w.numpy())
    assert fitted.value == rebuilt.value and fitted.converged == rebuilt.converged


def test_streaming_max_iterations_checkpoint_continues_with_larger_budget(tmp_path):
    paths, _, _ = _write_files(tmp_path)
    source = LibsvmFileSource(paths, device="cpu")
    w0 = torch.zeros(source.dim)
    small = OptimizerConfig(max_iterations=3)
    ckpt = StreamCheckpointer(str(tmp_path / "ckpt"))
    capped = streaming_lbfgs(_objective(source), w0, small, checkpointer=ckpt)
    assert capped.iterations == 3 and not capped.converged
    state = ckpt.load("latest")
    assert state is not None and state.completed
    same = streaming_lbfgs(_objective(source), w0, small, checkpointer=ckpt,
                           resume_state=state)
    assert same.iterations == 3
    grown = streaming_lbfgs(_objective(source), w0, OptimizerConfig(max_iterations=25),
                            checkpointer=ckpt, resume_state=state)
    assert grown.iterations > 3 and grown.value < capped.value
    assert grown.history_value.shape == (26,)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mid_fit_checkpoints_cross_between_the_packages(tmp_path, writer):
    """A fit killed at iteration 3 in one package resumes in the other from
    the mid-fit snapshot and lands where the other package's uninterrupted
    fit lands."""
    paths, _, _ = _write_files(tmp_path)
    config = OptimizerConfig(max_iterations=25)
    source = LibsvmFileSource(paths, device="cpu")
    jax_source, _ = _jax_objective(paths)
    ckpt_dir = str(tmp_path / "ckpt")
    if writer == "jax":
        ckpt = jax_checkpoint.StreamCheckpointer(ckpt_dir, async_publish="off")
        jax_injection.set_plan(jax_injection.FaultPlan.parse("stream:kill:iter=3"))
        try:
            with pytest.raises(jax_injection.InjectedKillError):
                jax_streaming.streaming_lbfgs(
                    _jax_objective(paths)[1], jnp.zeros(jax_source.dim, jnp.float32),
                    JaxConfig(max_iterations=25), checkpointer=ckpt)
        finally:
            jax_injection.set_plan(None)
        state = StreamCheckpointer(ckpt_dir).load("latest")
        assert not state.completed and state.iteration == 3
        resumed = streaming_lbfgs(_objective(source), torch.zeros(source.dim), config,
                                  resume_state=state)
        baseline = streaming_lbfgs(_objective(source), torch.zeros(source.dim), config)
        got_w, got_v, want_w, want_v = (resumed.w.numpy(), resumed.value,
                                        baseline.w.numpy(), baseline.value)
    else:
        ckpt = StreamCheckpointer(ckpt_dir, async_publish="off")
        set_plan(FaultPlan.parse("stream:kill:iter=3"))
        try:
            with pytest.raises(InjectedKillError):
                streaming_lbfgs(_objective(source), torch.zeros(source.dim), config,
                                checkpointer=ckpt)
        finally:
            set_plan(None)
        state = jax_checkpoint.StreamCheckpointer(ckpt_dir).load("latest")
        assert not state.completed and state.iteration == 3
        w0 = jnp.zeros(jax_source.dim, jnp.float32)
        resumed = jax_streaming.streaming_lbfgs(
            _jax_objective(paths)[1], w0, JaxConfig(max_iterations=25), resume_state=state)
        baseline = jax_streaming.streaming_lbfgs(
            _jax_objective(paths)[1], w0, JaxConfig(max_iterations=25))
        got_w, got_v, want_w, want_v = (np.asarray(resumed.w), float(resumed.value),
                                        np.asarray(baseline.w), float(baseline.value))
    # Past the snapshot each package continues on its own float32 sums: the
    # resumed fit is held to the reader's own fit under the L-BFGS bounds of
    # tests/test_torch_xchg.py (objective rtol 1e-5, coefficients rtol 1e-2
    # and atol 1e-3).
    assert int(resumed.iterations) > 3
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    np.testing.assert_allclose(got_w, want_w, rtol=1e-2, atol=1e-3)


def test_source_with_files_and_known_dim(tmp_path):
    paths, _, _ = _write_files(tmp_path)
    full = LibsvmFileSource(paths, device="cpu")
    fast = LibsvmFileSource(paths, feature_dim=full.feature_dim, device="cpu")
    assert (fast.dim, fast.capacity, fast.num_examples) == (
        full.dim, full.capacity, full.num_examples)
    shard = full.with_files(paths[:1])
    assert shard.dim == full.dim
    chunks = list(shard.chunk_iter_factory())
    assert len(chunks) == 1 and chunks[0].ids.shape[1] == full.capacity
    with pytest.raises(ValueError, match="at least one file"):
        LibsvmFileSource([], device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        make_global_batch(chunks[0], None)


def _train_args(tmp_path, out, *extra):
    return ["--backend", "cpu", "--input", str(tmp_path / "part-*.libsvm"), "--stream",
            "--validation-input", "synthetic:logistic_regression:200:40:5:7",
            "--max-iterations", "30", "--output-dir", str(tmp_path / out), *extra]


def test_streaming_train_driver_matches_jax_driver(tmp_path):
    from photon_tpu.drivers import train as jax_train

    _write_files(tmp_path, n_files=2, rows=150)
    got = train.run(train.build_parser().parse_args(_train_args(tmp_path, "torch")))
    ref = jax_train.run(jax_train.build_parser().parse_args(
        _train_args(tmp_path, "jax", "--no-telemetry")))
    assert got["streaming"] is True and ref["streaming"] is True
    assert os.path.exists(tmp_path / "torch" / "best_model.avro")
    for e, r in zip(got["sweep"], ref["sweep"]):
        np.testing.assert_allclose(e["final_value"], r["final_value"], rtol=1e-5)
        assert abs(e["metrics"]["AUC"] - r["metrics"]["AUC"]) <= 1e-4
        assert e["last_kernel"] == "autodiff"
    assert got["sweep"][0]["metrics"]["AUC"] > 0.6
    assert got["stream_kernel"] == "autodiff"


def test_streaming_train_preempted_then_resumed_equals_uninterrupted(tmp_path):
    """``preempt:iter=2`` exits 75 with the mid-fit snapshot published;
    ``--resume auto`` ends at the uninterrupted model exactly."""
    from photon_tpu_torch.fault.preemption import PREEMPTED_EXIT_CODE, clear_preemption

    _write_files(tmp_path, n_files=2, rows=150)
    base = train.run(train.build_parser().parse_args(_train_args(tmp_path, "base")))
    ckpt = str(tmp_path / "ck")
    try:
        with pytest.raises(SystemExit) as exc:
            train.main(_train_args(tmp_path, "stop", "--checkpoint-dir", ckpt,
                                   "--checkpoint-every", "1", "--faults", "preempt:iter=2"))
    finally:
        clear_preemption()
    assert exc.value.code == PREEMPTED_EXIT_CODE
    state = StreamCheckpointer(os.path.join(ckpt, "lam-000")).load("latest")
    assert state.iteration == 2 and not state.completed
    resumed = train.run(train.build_parser().parse_args(_train_args(
        tmp_path, "resumed", "--checkpoint-dir", ckpt, "--resume", "latest")))
    assert resumed["sweep"][0]["final_value"] == base["sweep"][0]["final_value"]
    assert resumed["sweep"][0]["iterations"] == base["sweep"][0]["iterations"]
    from photon_tpu_torch.data.model_io import load_glm_model
    from photon_tpu_torch.data.index_map import IndexMap

    imap = IndexMap.load(str(tmp_path / "base" / "feature_index.json"))
    models = [load_glm_model(str(tmp_path / out / "best_model.avro"), imap, device="cpu")
              for out in ("base", "resumed")]
    assert torch.equal(models[0].coefficients.means, models[1].coefficients.means)


def test_streaming_path_validates_data(tmp_path):
    from photon_tpu_torch.data.validation import DataValidationError

    bad = tmp_path / "bad.libsvm"
    bad.write_text("nan 1:1.0\n1 2:1.0\n-1 1:0.5\n")
    args = ["--input", str(bad), "--task", "logistic_regression", "--stream",
            "--max-iterations", "3", "--output-dir", str(tmp_path / "out"),
            "--backend", "cpu"]
    with pytest.raises(DataValidationError):
        train.run(train.build_parser().parse_args(args + ["--data-validation", "error"]))
    summary = train.run(train.build_parser().parse_args(args + ["--data-validation", "off"]))
    assert summary is not None
    for flag in (["--normalization", "standardization"], ["--optimizer", "tron"],
                 ["--reg-type", "l1"]):
        with pytest.raises(ValueError, match="--stream"):
            train.run(train.build_parser().parse_args(
                args + ["--data-validation", "off", *flag]))


@pytest.mark.parametrize("mode", ["error", "warn", "off"])
def test_resident_path_validates_data_as_the_reference(tmp_path, monkeypatch, mode):
    """The resident (no --stream) train validates the loaded batch where
    the reference does: ``error`` raises naming the NaN label in both
    packages, ``warn`` trains in both, ``off`` never runs the check."""
    from photon_tpu.data import validation as jax_validation
    from photon_tpu.data.validation import DataValidationError as JaxValidationError
    from photon_tpu.drivers import train as jax_train
    from photon_tpu_torch.data import validation
    from photon_tpu_torch.data.validation import DataValidationError

    bad = tmp_path / "bad.libsvm"
    bad.write_text("nan 1:1.0\n1 2:1.0\n-1 1:0.5\n")
    drivers = {"port": (train, DataValidationError, validation, ["--backend", "cpu"]),
               "jax": (jax_train, JaxValidationError, jax_validation, [])}
    for name, (driver, error, module, extra) in drivers.items():
        args = ["--input", str(bad), "--task", "logistic_regression",
                "--max-iterations", "3", "--output-dir", str(tmp_path / name),
                "--data-validation", mode, *extra]
        if mode == "off":
            def refuse(*a, **k):
                raise AssertionError("validation ran under --data-validation off")

            monkeypatch.setattr(module, "validate_batch", refuse)
        run = lambda: driver.run(driver.build_parser().parse_args(args))  # noqa: E731
        if mode == "error":
            with pytest.raises(error, match="non_finite_label: 1 rows"):
                run()
            assert not (tmp_path / name / "best_model.avro").exists()
        else:
            assert run() is not None
            assert (tmp_path / name / "best_model.avro").exists()
