"""Streamed chunks on the fast routes, and the ``cumsum`` reduce of ``xchg``.

Mirrors tests/test_stream_kernels.py on the port (``photon_tpu_torch/data/
stream_layouts.py``): chunks re-parsed every pass carry cached layouts and
routes, reach the fast routes and give the numbers of the plain
``autodiff`` pass and of the JAX package's streamed pass; the per-file
cache is hit by a fresh source and missed after a file changes.  Then the
``cumsum`` reduce (``PHOTON_XCHG_REDUCE=cumsum``) on a resident batch
against the JAX package's ``xchg_segment_grad`` (Pallas in interpret
mode), and the compensated scan against the JAX package's and a float64
prefix.

Tolerances are the reference's: value rtol 2e-5; gradient rtol 2e-4 and atol
2e-4 times the largest |gradient| (float32 sums in other orders).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_tpu_torch.data.stream_layouts as sl
from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.data.batch import SparseBatch as JaxBatch
from photon_tpu.data.batch import attach_feature_major as jax_attach
from photon_tpu.data.streaming import LibsvmFileSource as JaxSource
from photon_tpu.data.streaming import StreamingObjective as JaxStreaming
from photon_tpu.ops import vperm as jv
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.data.batch import SparseBatch, attach_feature_major
from photon_tpu_torch.data.streaming import LibsvmFileSource, StreamingObjective
from photon_tpu_torch.ops import vperm as tv

D_RAW = 96  # feature dim before the intercept column
VALUE_RTOL = 2e-5
GRAD_RTOL = 2e-4
GRAD_ATOL = 2e-4  # times the largest |gradient| (at least 1)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PHOTON_ROUTE_CACHE", "0")
    for var in ("PHOTON_XCHG_REDUCE", "PHOTON_XCHG_DTYPE", "PHOTON_STREAM_KERNEL",
                "PHOTON_STREAM_LAYOUT_CACHE"):
        monkeypatch.delenv(var, raising=False)


def _write_files(tmp_path, n_files=3, rows=64, k=6, seed=0):
    """tests/test_stream_kernels.py's part files: the last file shorter."""
    rng = np.random.default_rng(seed)
    files = []
    for fi in range(n_files):
        path = tmp_path / f"part-{fi:03d}.libsvm"
        with open(path, "w") as f:
            n = rows if fi < n_files - 1 else rows // 2
            for _ in range(n):
                ids = np.sort(rng.choice(np.arange(1, D_RAW + 1), size=k, replace=False))
                vals = rng.standard_normal(k)
                y = 1 if rng.random() < 0.5 else -1
                f.write(f"{y} " + " ".join(f"{j}:{v:.5f}" for j, v in zip(ids, vals))
                        + "\n")
        files.append(str(path))
    return files


def _streamed_vg(files, w, l2=0.5):
    source = LibsvmFileSource(files, intercept=True, device="cpu")
    obj = StreamingObjective(
        GlmObjective.create("logistic", RegularizationContext("l2", l2)),
        source.chunk_iter_factory)
    v, g = obj.value_and_grad(w)
    return float(v), g.numpy(), obj.last_kernel


def _jax_streamed_vg(files, w, l2=0.5):
    source = JaxSource(files, intercept=True)
    obj = JaxStreaming(JaxObjective.create("logistic", JaxReg("l2", l2)),
                       source.chunk_iter_factory)
    v, g = obj.value_and_grad(jnp.asarray(w.numpy()))
    return float(v), np.asarray(g), obj.last_kernel


def _close(v, g, v_ref, g_ref):
    np.testing.assert_allclose(v, v_ref, rtol=VALUE_RTOL)
    scale = max(float(np.abs(g_ref).max()), 1.0)
    np.testing.assert_allclose(g, g_ref, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale)


@pytest.mark.parametrize("kernel,reduce_mode", [
    ("fm", None), ("pallas", None), ("xchg", "cumsum"), ("xchg", "aligned"),
])
def test_streamed_kernel_matches_autodiff_and_jax(tmp_path, monkeypatch, kernel,
                                                  reduce_mode):
    files = _write_files(tmp_path)
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "autodiff")
    dim = LibsvmFileSource(files, intercept=True, device="cpu").dim
    w = torch.as_tensor(np.random.default_rng(1).standard_normal(dim)
                        .astype(np.float32) * 0.1)
    v_ref, g_ref, ran = _streamed_vg(files, w)
    assert ran == "autodiff"

    monkeypatch.setenv("PHOTON_SPARSE_GRAD", kernel)
    if reduce_mode is not None:
        monkeypatch.setenv("PHOTON_XCHG_REDUCE", reduce_mode)
    monkeypatch.setenv("PHOTON_STREAM_LAYOUT_CACHE", str(tmp_path / "cache"))
    v, g, ran = _streamed_vg(files, w)
    assert ran == kernel
    _close(v, g, v_ref, g_ref)
    v_jax, g_jax, ran_jax = _jax_streamed_vg(files, w)
    assert ran_jax == kernel
    _close(v, g, v_jax, g_jax)


def _counting_builds(monkeypatch):
    builds = []
    real_build = sl._build_aux

    def counting_build(*args, **kw):
        builds.append(1)
        return real_build(*args, **kw)

    monkeypatch.setattr(sl, "_build_aux", counting_build)
    return builds


@pytest.mark.parametrize("kernel,reduce_mode", [
    ("pallas", None), ("xchg", "cumsum"), ("xchg", "aligned")])
def test_stream_layout_cache_hit_skips_build(tmp_path, monkeypatch, kernel, reduce_mode):
    """The second pass and a fresh source (as after a restart) load the
    cached layouts instead of building them, with equal results."""
    files = _write_files(tmp_path)
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", kernel)
    if reduce_mode is not None:
        monkeypatch.setenv("PHOTON_XCHG_REDUCE", reduce_mode)
    monkeypatch.setenv("PHOTON_STREAM_LAYOUT_CACHE", str(tmp_path / "cache"))
    dim = LibsvmFileSource(files, intercept=True, device="cpu").dim
    w = torch.zeros(dim)
    builds = _counting_builds(monkeypatch)
    v1, g1, _ = _streamed_vg(files, w)
    assert len(builds) == len(files)  # one build a file, on the first pass
    v2, g2, _ = _streamed_vg(files, w)  # a fresh source
    assert len(builds) == len(files)  # all cache hits
    assert v1 == v2
    np.testing.assert_array_equal(g1, g2)
    assert len(os.listdir(tmp_path / "cache" / "torch")) == len(files)


def test_stream_kernel_follows_forced_sparse_grad(monkeypatch):
    from photon_tpu.data.stream_layouts import stream_kernel as jax_stream_kernel

    for forced, want in (("xchg", "xchg"), ("auto", "autodiff"), ("benes", "autodiff"),
                         ("fm", "fm")):
        monkeypatch.setenv("PHOTON_SPARSE_GRAD", forced)
        assert sl.stream_kernel() == jax_stream_kernel() == want
    monkeypatch.setenv("PHOTON_STREAM_KERNEL", "pallas")
    assert sl.stream_kernel() == "pallas"
    monkeypatch.setenv("PHOTON_STREAM_KERNEL", "fused")
    with pytest.raises(ValueError, match="PHOTON_STREAM_KERNEL"):
        sl.stream_kernel()
    assert "cached" in sl.stream_kernel_why("xchg")
    assert "host" in sl.stream_kernel_why("autodiff")


def test_stream_cache_invalidated_by_file_change(tmp_path, monkeypatch):
    """A rewritten part file (new size and mtime) misses the cache and
    rebuilds instead of serving the stale route."""
    files = _write_files(tmp_path, n_files=1, rows=32)
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "xchg")
    monkeypatch.setenv("PHOTON_XCHG_REDUCE", "cumsum")
    monkeypatch.setenv("PHOTON_STREAM_LAYOUT_CACHE", str(tmp_path / "cache"))
    dim = LibsvmFileSource(files, intercept=True, device="cpu").dim
    builds = _counting_builds(monkeypatch)
    _streamed_vg(files, torch.zeros(dim))
    assert len(builds) == 1
    _write_files(tmp_path, n_files=1, rows=48, seed=9)
    dim2 = LibsvmFileSource(files, intercept=True, device="cpu").dim
    v_new, g_new, _ = _streamed_vg(files, torch.zeros(dim2))
    assert len(builds) == 2  # rebuilt for the new file identity
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "autodiff")
    v_ref, g_ref, _ = _streamed_vg(files, torch.zeros(dim2))
    np.testing.assert_allclose(v_new, v_ref, rtol=VALUE_RTOL)
    np.testing.assert_allclose(g_new, g_ref, rtol=GRAD_RTOL, atol=1e-4)


@pytest.mark.parametrize("reduce_mode", ["aligned", "cumsum"])
def test_equal_files_share_one_pow2_geometry(tmp_path, monkeypatch, reduce_mode):
    """Full part files take one geometry (pow2-padded slabs, tiles and
    block census); the short last file a bucket of its own.  The cache
    files round-trip every plane."""
    files = _write_files(tmp_path, n_files=4, rows=64, seed=3)
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "xchg")
    monkeypatch.setenv("PHOTON_XCHG_REDUCE", reduce_mode)
    monkeypatch.setenv("PHOTON_STREAM_LAYOUT_CACHE", str(tmp_path / "cache"))
    source = LibsvmFileSource(files, intercept=True, device="cpu")
    chunks = [source.load_host_chunk(i) for i in range(len(files))]
    routes = [c.xchg.route for c in chunks]
    geometry = [(r.nc, r.ch, getattr(r, "blk", None)) for r in routes]
    assert len(set(geometry[:3])) == 1
    for c in chunks:
        assert (c.al is not None) == (reduce_mode == "aligned")
        assert (c.xchg.bounds is not None) == (reduce_mode == "cumsum")
        assert c.xchg.vals_dest is None  # no value baking on streamed chunks
        if c.al is not None:
            n_tiles, n_slabs = c.al.slab_of_tile.shape[0], c.al.n_slabs
            assert n_slabs & (n_slabs - 1) == 0 and n_tiles & (n_tiles - 1) == 0
    again = [source.load_host_chunk(i) for i in range(len(files))]  # the cache
    for a, b in zip(chunks, again):
        za, zb = tv._aux_to_npz(a.xchg), tv._aux_to_npz(b.xchg)
        assert sorted(za) == sorted(zb)
        for key in za:
            np.testing.assert_array_equal(za[key], zb[key])


# -- the cumsum reduce on a resident batch ------------------------------------


def _arrays(n, k, d, seed, zipf=False):
    rng = np.random.default_rng(seed)
    if zipf:
        ids = np.minimum(rng.zipf(1.3, size=(n, k)) - 1, d - 1).astype(np.int32)
    else:
        ids = rng.integers(0, d, size=(n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    vals[rng.random((n, k)) < 0.15] = 0.0
    return (ids, vals, (rng.random(n) < 0.4).astype(np.float32),
            (rng.standard_normal(n) * 0.1).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32))


@pytest.mark.parametrize("zipf", [False, True])
@pytest.mark.parametrize("k", [6, 32])
def test_cumsum_reduce_matches_jax_xchg(monkeypatch, k, zipf):
    """The resident batch under ``PHOTON_XCHG_REDUCE=cumsum``: the baked
    sorted route (k=6 rides the K4 stream path, k=32 the K6 path) against
    the JAX package's cumsum route in interpret mode, value and gradient,
    and against the port's own autodiff route."""
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "xchg")
    monkeypatch.setenv("PHOTON_XCHG_REDUCE", "cumsum")
    n, d = (256, 48) if k == 6 else (96, 48)
    arrays = _arrays(n, k, d, seed=80, zipf=zipf)
    w = (np.random.default_rng(81).standard_normal(d) * 0.1).astype(np.float32)
    ref = jax_attach(JaxBatch(*(jnp.asarray(a) for a in arrays)), aligned_dim=d)
    assert ref.xchg.bounds is not None
    obj_j = JaxObjective.create("logistic", JaxReg("l2", 0.6))
    assert obj_j._sparse_kernel(ref, d) == "xchg"
    v_ref, g_ref = obj_j.value_and_grad(jnp.asarray(w), ref)

    batch = attach_feature_major(SparseBatch(*(torch.as_tensor(a) for a in arrays)),
                                 aligned_dim=d)
    assert batch.xchg.bounds is not None and batch.xchg.vals_dest is not None
    assert isinstance(batch.xchg.route, tv.BalancedRoute)
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 0.6))
    assert obj._sparse_kernel(batch, d) == "xchg"
    v, g = obj.value_and_grad(torch.as_tensor(w), batch)
    _close(float(v), g.numpy(), float(v_ref), np.asarray(g_ref))
    # The reduce alone, from one dz, against the JAX package's.
    dz = np.random.default_rng(82).standard_normal(n).astype(np.float32)
    got = tv.xchg_segment_grad(torch.as_tensor(dz), batch.vals, None, batch.xchg, d)
    want = jv.xchg_segment_grad(jnp.asarray(dz), ref.vals, ref.al, ref.xchg, d)
    exact = np.zeros(d)
    np.add.at(exact, arrays[0].reshape(-1),
              (dz[:, None].astype(np.float64) * arrays[1]).reshape(-1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "autodiff")
    v_a, g_a = obj.value_and_grad(torch.as_tensor(w), batch)
    _close(float(v), g.numpy(), float(v_a), g_a.numpy())


@pytest.mark.parametrize("baked", [False, True])
def test_sorted_routes_match_the_jax_builders(baked):
    """The colored and balanced sorted routes of the port against the JAX
    package's builders: the same bounds, and the same moved stream (the
    routes' own planes may differ where an edge coloring has a choice)."""
    n, k, d = 512, 8, 64
    ids, vals = _arrays(n, k, d, seed=5)[:2]
    flat = ids.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    colored = tv.build_xchg_sorted_route(ids, d, order=order, device="cpu")
    colored_ref = jv.build_xchg_sorted_route(ids, d, order=order)
    np.testing.assert_array_equal(colored.bounds.numpy(), np.asarray(colored_ref.bounds))
    balanced, bounds = tv.build_balanced_sorted_route(ids, d, order, device="cpu")
    balanced_ref, bounds_ref = jv.build_balanced_sorted_route(ids, d, order)
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(bounds_ref))
    assert (balanced.nc, balanced.ch, balanced.blk, balanced.ds_win) == (
        balanced_ref.nc, balanced_ref.ch, balanced_ref.blk, balanced_ref.ds_win)
    dz = np.random.default_rng(6).standard_normal(n).astype(np.float32)
    exact = np.zeros(d)
    np.add.at(exact, flat, (dz[:, None].astype(np.float64) * vals).reshape(-1))
    for aux in (colored, tv.XchgAux(route=balanced, bounds=bounds)):
        if baked:
            aux = tv.bake_vals_dest(aux, vals)
            assert aux.vals_dest is not None
        got = tv.xchg_segment_grad(torch.as_tensor(dz), torch.as_tensor(vals), None,
                                   aux, d)
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)
        # A cache round trip keeps every plane and the bounds.
        back = tv._aux_from_npz(tv._aux_to_npz(aux), device="cpu")
        np.testing.assert_array_equal(
            tv.xchg_segment_grad(torch.as_tensor(dz), torch.as_tensor(vals), None,
                                 back, d).numpy(),
            tv.xchg_segment_grad(torch.as_tensor(dz), torch.as_tensor(vals), None,
                                 tv.XchgAux(route=aux.route, bounds=aux.bounds),
                                 d).numpy())
    # The JAX package's npz loads into the port: the same keys.
    z = jv._aux_to_npz(colored_ref)
    loaded = tv._aux_from_npz({key: np.asarray(v) for key, v in z.items()}, device="cpu")
    got = tv.xchg_segment_grad(torch.as_tensor(dz), torch.as_tensor(vals), None, loaded, d)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)


def test_cumsum_route_needs_dim_and_skips_the_layout(monkeypatch):
    monkeypatch.setenv("PHOTON_XCHG_REDUCE", "cumsum")
    ids, vals = _arrays(64, 4, 16, seed=3)[:2]
    with pytest.raises(ValueError, match="dim"):
        tv.build_xchg_aux(None, ids, device="cpu")
    aux = tv.build_xchg_aux(None, ids, vals=vals, device="cpu", dim=16)
    assert aux.bounds.shape == (17,) and aux.vals_dest is not None
    with pytest.raises(ValueError, match="slot stream"):
        tv.xchg_slot_products(torch.ones(64), torch.as_tensor(vals), aux)


# -- the compensated scan -----------------------------------------------------


@pytest.mark.parametrize("n", [1, 31, 32, 4095, 4096, 4097, 1 << 16])
def test_compensated_scan_matches_jax_and_a_float64_prefix(n):
    """``compensated_scan`` (on the CPU its plain version) and the JAX
    package's ``_compensated_cumsum`` each hold ``|hi + lo - c64| <= 2^-40
    * C`` elementwise, with ``c64`` the float64 prefix and ``C`` the float64
    prefix of |x|; chip_smoke's gate for the kernel.  The inputs have a
    large mean, so that a plain float32 cumsum falls far outside it."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) + 100.0).astype(np.float32)
    x[rng.random(n) < 0.1] *= 1e-4
    exact = np.cumsum(x.astype(np.float64))
    bound = 2.0 ** -40 * np.cumsum(np.abs(x.astype(np.float64)))
    hi, lo = tv.compensated_scan(torch.as_tensor(x))
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == (n,)
    ours = hi.double().numpy() + lo.double().numpy()
    rhi, rlo = jv._compensated_cumsum(jnp.asarray(x))
    theirs = np.asarray(rhi, np.float64) + np.asarray(rlo, np.float64)
    assert np.all(np.abs(ours - exact) <= bound)
    assert np.all(np.abs(theirs - exact) <= bound)
    if n >= 4096:
        plain = np.cumsum(x).astype(np.float64)
        assert np.max(np.abs(plain - exact) / bound) > 100


def test_compensated_scan_refuses_other_inputs():
    with pytest.raises(ValueError, match="flat float32"):
        tv.compensated_scan(torch.zeros(4, 2))
    with pytest.raises(ValueError, match="flat float32"):
        tv.compensated_scan(torch.zeros(4, dtype=torch.float64))
    hi, lo = tv.compensated_scan(torch.zeros(0))
    assert hi.shape == lo.shape == (0,)
    assert tv.compensated_scan.launches == 0  # CPU tensors launch nothing
