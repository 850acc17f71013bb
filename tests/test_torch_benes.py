"""Port parity for the ``benes`` route: the slab gather (K3), the Clos
permutation on tensors, and value, gradient and Hv through
``PHOTON_SPARSE_GRAD=benes``, against the JAX package (Pallas in interpret
mode, as tests/test_benes.py runs it on the CPU).

The slab gather is one float32 multiply a slot and the permutations move
data only: both are held bit for bit.  Value, gradient and Hv are held to
tests/test_benes.py's tolerances (value rtol 1e-5; gradient and Hv rtol
2e-4, atol 1e-5: float32 sums in other orders); the CLI's AUC to 1e-4.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.data.batch import SparseBatch as JaxBatch
from photon_tpu.data.batch import attach_feature_major as jax_attach
from photon_tpu.ops import clos as jax_clos
from photon_tpu.ops.pallas_gather import aligned_gather_products as jax_gather
from photon_tpu.ops.pallas_gather import build_aligned_layout as jax_build_layout
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.data.batch import SparseBatch, attach_feature_major
from photon_tpu_torch.drivers import train
from photon_tpu_torch.ops import clos
from photon_tpu_torch.ops.benes import benes_slot_products, build_benes_aux
from photon_tpu_torch.ops.slab_reduce import (
    LANES,
    aligned_gather_products,
    aligned_gather_products_plain,
    build_aligned_layout,
    device_layout,
    gather_products,
    gather_products_reference,
)

HERE = os.path.dirname(os.path.abspath(__file__))
A1A = os.path.join(HERE, "fixtures", "a1a.libsvm")
A1A_T = os.path.join(HERE, "fixtures", "a1a.t.libsvm")


def _random(n, k, d, seed, zipf=False):
    """tests/test_fast_sparse.py's _random_batch arrays (padded row tails)."""
    rng = np.random.default_rng(seed)
    if zipf:
        ids = ((rng.zipf(1.3, size=(n, k)) - 1) % d).astype(np.int32)
    else:
        ids = rng.integers(0, d, size=(n, k), dtype=np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    cut = rng.integers(1, k + 1, size=n)
    mask = np.arange(k)[None, :] < cut[:, None]
    vals = np.where(mask, vals, 0.0).astype(np.float32)
    ids = np.where(mask, ids, 0).astype(np.int32)
    label = (rng.random(n) < 0.5).astype(np.float32)
    offset = (rng.standard_normal(n) * 0.1).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return ids, vals, label, offset, weight


@pytest.mark.parametrize("zipf", [False, True])
def test_slab_gather_matches_jax_exactly(zipf):
    n, k, d = 3000, 8, 700
    ids, vals = _random(n, k, d, seed=60, zipf=zipf)[:2]
    layout = build_aligned_layout(ids, vals, d)
    jax_layout = jax_build_layout(ids, vals, d)
    np.testing.assert_array_equal(layout.lo, jax_layout.lo)
    w = np.random.default_rng(61).standard_normal(d).astype(np.float32)
    w2d = w[layout.dup_map].reshape(-1, LANES)
    ref = np.asarray(jax_gather(
        jnp.asarray(w2d), jnp.asarray(layout.slab_of_tile), jnp.asarray(layout.lo),
        jnp.asarray(layout.vals), interpret=True,
    ))
    al = device_layout(layout, "cpu")
    got = aligned_gather_products(torch.as_tensor(w2d), al.slab_of_tile, al.lo, al.vals)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), gather_products_reference(w, layout))
    np.testing.assert_array_equal(gather_products(torch.as_tensor(w), layout).numpy(), ref)
    assert aligned_gather_products.launches == 0  # CPU tensors: the plain version


def test_slab_gather_checks_its_inputs():
    ids, vals = _random(200, 4, 64, seed=62)[:2]
    al = device_layout(build_aligned_layout(ids, vals, 64), "cpu")
    w2d = torch.zeros(al.n_slabs * 8, LANES)
    with pytest.raises(ValueError, match="lo/vals"):
        aligned_gather_products(w2d, al.slab_of_tile, al.lo[:-1], al.vals)
    with pytest.raises(ValueError, match="w2d"):
        aligned_gather_products(w2d[:-1], al.slab_of_tile, al.lo, al.vals)
    with pytest.raises(TypeError):
        aligned_gather_products(w2d, al.slab_of_tile, al.lo.long(), al.vals)
    with pytest.raises(TypeError):
        aligned_gather_products(w2d.double(), al.slab_of_tile, al.lo, al.vals)
    assert torch.equal(
        aligned_gather_products(w2d + 1, al.slab_of_tile, al.lo, al.vals),
        aligned_gather_products_plain(w2d + 1, al.slab_of_tile, al.lo, al.vals),
    )


@pytest.mark.parametrize("n,a,b", [
    (16, 4, 4), (100, None, None), (4096, 64, 64), (5000, None, None),
])
def test_clos_route_matches_jax(n, a, b):
    """tests/test_benes.py::test_route_matches_flat_gather on both packages."""
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    x = rng.standard_normal(n).astype(np.float32)
    route = clos.route_permutation(perm, a, b)
    got = clos.apply_clos(torch.as_tensor(x), clos.device_route(route, "cpu"))
    np.testing.assert_array_equal(got.numpy(), x[perm])
    ref = jax_clos.apply_clos(jnp.asarray(x), jax_clos.route_permutation(perm, a, b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_clos_route_inversion_round_trips():
    """tests/test_benes.py::test_route_inversion_round_trips, and the
    inverse's stages equal the reference's argsort of each row."""
    rng = np.random.default_rng(2)
    n = 2048
    perm = rng.permutation(n)
    route = clos.route_permutation(perm, 64, 32)
    inv = clos.invert_route(route)
    fwd_d, inv_d = clos.device_route(route, "cpu"), clos.device_route(inv, "cpu")
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
    assert torch.equal(clos.apply_clos(clos.apply_clos(x, fwd_d), inv_d), x)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(n)
    np.testing.assert_array_equal(clos.apply_clos(x, inv_d).numpy(), x.numpy()[inv_perm])
    jax_inv = jax_clos.invert_route(jax_clos.route_permutation(perm, 64, 32))
    for stage in ("p1", "p2", "p3"):
        np.testing.assert_array_equal(getattr(inv, stage),
                                      np.asarray(getattr(jax_inv, stage)))
    assert clos.invert_route(route, n=100).n == 100


def test_clos_python_router_and_refusals():
    rng = np.random.default_rng(1)
    perm = rng.permutation(512)
    x = torch.as_tensor(rng.standard_normal(512).astype(np.float32))
    for use_native in (True, False):
        route = clos.device_route(
            clos.route_permutation(perm, 32, 16, use_native=use_native), "cpu")
        np.testing.assert_array_equal(clos.apply_clos(x, route).numpy(),
                                      x.numpy()[perm])
    with pytest.raises(ValueError):
        clos.route_permutation(np.array([0, 0, 2, 3]), 2, 2)
    with pytest.raises(ValueError, match="routed n"):
        clos.apply_clos(x[:-1], route)


def _benes_pair(monkeypatch, arrays, d):
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "benes")
    ref = jax_attach(JaxBatch(*(jnp.asarray(a) for a in arrays)), aligned_dim=d)
    batch = attach_feature_major(SparseBatch(*(torch.as_tensor(a) for a in arrays)),
                                 aligned_dim=d)
    return ref, batch


@pytest.mark.parametrize("zipf", [False, True])
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_benes_matches_jax_benes(monkeypatch, loss, zipf):
    """tests/test_benes.py::test_benes_kernel_matches_autodiff against the
    JAX package's own benes route."""
    n, k, d = 256, 6, 48
    arrays = _random(n, k, d, seed=90, zipf=zipf)
    ref, batch = _benes_pair(monkeypatch, arrays, d)
    assert batch.al is not None and batch.benes is not None
    rng = np.random.default_rng(91)
    w = (rng.standard_normal(d) * 0.1).astype(np.float32)
    vec = rng.standard_normal(d).astype(np.float32)
    obj_j = JaxObjective.create(loss, JaxReg("l2", 0.6))
    assert obj_j._sparse_kernel(ref, d) == "benes"
    v_ref, g_ref = obj_j.value_and_grad(jnp.asarray(w), ref)
    hv_ref = obj_j.hessian_vector(jnp.asarray(w), jnp.asarray(vec), ref)

    obj = GlmObjective.create(loss, RegularizationContext("l2", 0.6))
    assert obj._sparse_kernel(batch) == "benes"
    wt, vt = torch.as_tensor(w), torch.as_tensor(vec)
    v, g = obj.value_and_grad(wt, batch)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(obj.hessian_vector(wt, vt, batch).numpy(),
                               np.asarray(hv_ref), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(obj.hvp_operator(wt, batch)(vt).numpy(),
                               np.asarray(hv_ref), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("zipf", [False, True])
def test_benes_slot_products_equal_pallas(monkeypatch, zipf):
    """The exchange moves the pallas route's per-slot products bit for bit,
    and the forward equals the row-major margins to rounding."""
    n, k, d = 300, 8, 64
    arrays = _random(n, k, d, seed=93, zipf=zipf)
    _, batch = _benes_pair(monkeypatch, arrays, d)
    al = batch.al
    dz = torch.as_tensor(np.random.default_rng(94).standard_normal(n).astype(np.float32))
    pv_b = benes_slot_products(dz, batch.vals, batch.benes).view(al.lo.shape)
    pv_p = dz.index_select(0, al.rows.view(-1)).view(al.rows.shape) * al.vals
    assert torch.equal(pv_b, pv_p)
    obj = GlmObjective.create("logistic")
    w = torch.as_tensor(np.random.default_rng(95).standard_normal(d).astype(np.float32))
    from photon_tpu_torch.data.batch import margins

    np.testing.assert_allclose(obj._margins_for_kernel("benes", w, batch).numpy(),
                               margins(w, batch).numpy(), rtol=1e-5, atol=1e-5)


def test_benes_aux_built_only_when_forced(monkeypatch):
    """tests/test_benes.py::test_benes_aux_not_built_without_optin."""
    arrays = _random(64, 4, 32, seed=94)
    for mode in ("auto", "pallas", "xchg"):
        monkeypatch.setenv("PHOTON_SPARSE_GRAD", mode)
        batch = attach_feature_major(
            SparseBatch(*(torch.as_tensor(a) for a in arrays)), aligned_dim=32)
        assert batch.benes is None
    _, batch = _benes_pair(monkeypatch, arrays, 32)
    assert batch.benes is not None and batch.al_t is None  # its forward reads al
    assert batch.benes.n_rowmajor == 64 * 4
    assert batch.benes.n_slots == batch.al.lo.numel()
    moved = batch.to("cpu")
    assert torch.equal(moved.benes.to_rows.p1, batch.benes.to_rows.p1)
    # Without the routes (attached under another mode) benes falls back.
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "benes")
    assert GlmObjective.create("logistic")._sparse_kernel(
        batch._replace(benes=None)) == "pallas"
    with pytest.raises(ValueError, match="grid"):
        build_benes_aux(build_aligned_layout(arrays[0], arrays[1], 32), 64, 4, a=4, b=4)


def test_train_cli_tron_benes_matches_default(monkeypatch, tmp_path):
    args = [
        "--input", A1A, "--validation-input", A1A_T,
        "--task", "logistic_regression", "--optimizer", "tron",
        "--reg-weights", "0.1,1,10", "--evaluators", "AUC,LOGISTIC_LOSS",
        "--backend", "cpu",
    ]
    aucs = {}
    for route in ("benes", "fused"):
        monkeypatch.setenv("PHOTON_SPARSE_GRAD", route)
        out = train.run(train.build_parser().parse_args(
            args + ["--output-dir", str(tmp_path / route)]))
        best = next(e for e in out["sweep"] if e["lambda"] == out["best_lambda"])
        aucs[route] = best["metrics"]["AUC"]
    assert abs(aucs["benes"] - aucs["fused"]) <= 1e-4
