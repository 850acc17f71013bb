"""Port parity for the ``xchg`` route end to end: the objective, L-BFGS and
the train CLI with ``PHOTON_SPARSE_GRAD=xchg``, against the JAX package's
``xchg`` route (Pallas in interpret mode) and against the port's other
routes.

Tolerances are those of tests/test_xchg.py: value rtol 1e-5, gradient rtol
2e-4 and atol 1e-5 (float32 sums in other orders); for L-BFGS, coefficients
rtol 1e-2 and atol 1e-3 and the objective at the optimum rtol 1e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import lbfgs as jax_lbfgs
from photon_tpu.data.batch import SparseBatch as JaxBatch
from photon_tpu.data.batch import attach_feature_major as jax_attach
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.core.optimizers import lbfgs
from photon_tpu_torch.data.batch import SparseBatch, attach_feature_major
from photon_tpu_torch.drivers import train
from photon_tpu_torch.ops import vperm as tv
from photon_tpu_torch.ops.slab_reduce import aligned_segment_grad, build_aligned_layout
from photon_tpu_torch.ops.sparse_grad_select import select_kernel

HERE = os.path.dirname(os.path.abspath(__file__))
A1A = os.path.join(HERE, "fixtures", "a1a.libsvm")
A1A_T = os.path.join(HERE, "fixtures", "a1a.t.libsvm")


@pytest.fixture(autouse=True)
def _xchg(monkeypatch):
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "xchg")
    monkeypatch.setenv("PHOTON_ROUTE_CACHE", "0")  # the JAX side's disk cache
    monkeypatch.delenv("PHOTON_XCHG_REDUCE", raising=False)
    monkeypatch.delenv("PHOTON_XCHG_DTYPE", raising=False)


def _arrays(n, k, d, seed, zipf=False):
    """tests/test_xchg.py's batch: 15% zero vals, 40% positive labels."""
    rng = np.random.default_rng(seed)
    if zipf:
        ids = np.minimum(rng.zipf(1.3, size=(n, k)) - 1, d - 1).astype(np.int32)
    else:
        ids = rng.integers(0, d, size=(n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    vals[rng.random((n, k)) < 0.15] = 0.0
    return (
        ids, vals, (rng.random(n) < 0.4).astype(np.float32),
        (rng.standard_normal(n) * 0.1).astype(np.float32),
        rng.uniform(0.5, 2.0, n).astype(np.float32),
    )


def _port_batch(arrays, d, attach=True):
    batch = SparseBatch(*(torch.as_tensor(a) for a in arrays))
    return attach_feature_major(batch, aligned_dim=d) if attach else batch


@pytest.mark.parametrize("zipf", [False, True])
@pytest.mark.parametrize("loss", ["logistic", "squared"])
@pytest.mark.parametrize("k", [6, 32])
def test_value_and_grad_matches_jax_xchg(loss, zipf, k):
    """k=6 rides the balanced route's K4 stream path, k=32 the K6 path."""
    n, d = (256, 48) if k == 6 else (96, 48)
    arrays = _arrays(n, k, d, seed=80, zipf=zipf)
    w = (np.random.default_rng(81).standard_normal(d) * 0.1).astype(np.float32)
    ref = jax_attach(JaxBatch(*(jnp.asarray(a) for a in arrays)), aligned_dim=d)
    assert ref.xchg is not None
    obj_j = JaxObjective.create(loss, JaxReg("l2", 0.6))
    assert obj_j._sparse_kernel(ref, d) == "xchg"
    v_ref, g_ref = obj_j.value_and_grad(jnp.asarray(w), ref)

    batch = _port_batch(arrays, d)
    assert batch.al_t is not None and batch.xchg.vals_dest is not None
    assert batch.xchg.route.k_expand == (k if 128 % k == 0 else 0)
    obj = GlmObjective.create(loss, RegularizationContext("l2", 0.6))
    assert obj._sparse_kernel(batch) == "xchg"
    v, g = obj.value_and_grad(torch.as_tensor(w), batch)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("colored", [False, True], ids=["balanced", "colored"])
@pytest.mark.parametrize("zipf", [False, True])
def test_xchg_gradient_equals_pallas_gradient_exactly(monkeypatch, zipf, colored):
    """Both routes form the same slot products (``dz[rows] * vals``, one
    float32 multiply either side of the exchange) and reduce them through
    the same position-reduce and epilogue, so here on the CPU they agree
    bit for bit.  (On the card the epilogue's ``index_add_`` adds with
    atomics in another order each run where a key spans several dictionary
    slots, in float64, so the order hardly ever shows; chip_smoke.py holds
    the slot products bit for bit there and the gradients to its gradient
    gate.)"""
    n, k, d = 512, 32, 64
    arrays = _arrays(n, k, d, seed=90, zipf=zipf)
    batch = _port_batch(arrays, d)
    if colored:
        layout = build_aligned_layout(arrays[0], arrays[1], d)
        batch = batch._replace(xchg=tv.build_xchg_aux(
            layout, arrays[0], vals=arrays[1], force_colored=True, device="cpu"))
        assert isinstance(batch.xchg.route, tv.VpermRoute)
    dz = torch.as_tensor(np.random.default_rng(91).standard_normal(n).astype(np.float32))
    al = batch.al
    assert torch.equal(
        tv.xchg_slot_products(dz, batch.vals, batch.xchg),
        (dz[al.rows.long()] * al.vals).view(-1),
    )
    g_x = tv.xchg_segment_grad(dz, batch.vals, al, batch.xchg, d)
    assert torch.equal(g_x, aligned_segment_grad(dz, al, d))
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 0.5))
    w = torch.as_tensor(np.random.default_rng(92).standard_normal(d).astype(np.float32))
    v_x, g_x = obj.value_and_grad(w, batch)
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "pallas")
    assert obj._sparse_kernel(batch) == "pallas"
    v_p, g_p = obj.value_and_grad(w, batch)
    assert float(v_x) == float(v_p) and torch.equal(g_x, g_p)


def test_lbfgs_under_xchg_reaches_the_jax_optimum(monkeypatch):
    n, k, d = 256, 5, 32
    arrays = _arrays(n, k, d, seed=85)
    batch = _port_batch(arrays, d)
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 1.0))
    res = lbfgs(lambda w: obj.value_and_grad(w, batch), torch.zeros(d))

    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "autodiff")
    ref_batch = JaxBatch(*(jnp.asarray(a) for a in arrays))
    obj_j = JaxObjective.create("logistic", JaxReg("l2", 1.0))
    ref = jax_lbfgs(lambda w: obj_j.value_and_grad(w, ref_batch),
                    jnp.zeros(d, jnp.float32))
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(
        float(obj_j.value(jnp.asarray(res.w.numpy()), ref_batch)),
        float(obj_j.value(ref.w, ref_batch)), rtol=1e-6,
    )


def test_train_cli_xchg_matches_fm_auc(monkeypatch, tmp_path):
    args = [
        "--input", A1A, "--validation-input", A1A_T,
        "--task", "logistic_regression", "--reg-weights", "0.1,1,10",
        "--evaluators", "AUC,LOGISTIC_LOSS", "--backend", "cpu",
    ]
    aucs = {}
    for route in ("xchg", "fm"):
        monkeypatch.setenv("PHOTON_SPARSE_GRAD", route)
        tv.route_build_seconds = 0.0
        out = train.run(train.build_parser().parse_args(
            args + ["--output-dir", str(tmp_path / route)]))
        best = next(e for e in out["sweep"] if e["lambda"] == out["best_lambda"])
        aucs[route] = best["metrics"]["AUC"]
        assert (tv.route_build_seconds > 0) == (route == "xchg")  # route built
    assert abs(aucs["xchg"] - aucs["fm"]) <= 1e-4


@pytest.mark.parametrize("var,value", [
    ("PHOTON_XCHG_REDUCE", "cumsum"), ("PHOTON_XCHG_DTYPE", "bfloat16"),
])
def test_unported_variants_raise(monkeypatch, var, value):
    arrays = _arrays(64, 4, 16, seed=3)
    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
        _port_batch(arrays, 16)
    # A route attached before the switch refuses at evaluation too.
    monkeypatch.delenv(var)
    batch = _port_batch(arrays, 16)
    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
        GlmObjective.create("logistic").value_and_grad(torch.zeros(16), batch)


def test_baked_values_guard_rejects_other_values():
    n, k, d = 128, 8, 32
    arrays = _arrays(n, k, d, seed=22)
    batch = _port_batch(arrays, d)
    dz = torch.ones(n)
    tv.xchg_segment_grad(dz, batch.vals, batch.al, batch.xchg, d)
    with pytest.raises(ValueError, match="BAKED"):
        tv.xchg_segment_grad(dz, 3.0 * batch.vals, batch.al, batch.xchg, d)
    batch.vals.mul_(2.0)  # changed in place: checked again
    with pytest.raises(ValueError, match="BAKED"):
        tv.xchg_segment_grad(dz, batch.vals, batch.al, batch.xchg, d)


def test_route_selection_and_attach(monkeypatch):
    assert select_kernel(has_fm=True, has_aligned=True, has_xchg=True) == "xchg"
    assert select_kernel(has_fm=True, has_aligned=True) == "pallas"
    arrays = _arrays(64, 4, 16, seed=4)
    batch = attach_feature_major(
        SparseBatch(*(torch.as_tensor(a) for a in arrays)),
        aligned_dim=16, aligned_forward=False,
    )
    assert batch.xchg is not None and batch.al_t is not None  # xchg forces al_t
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "pallas")
    assert attach_feature_major(
        SparseBatch(*(torch.as_tensor(a) for a in arrays)), aligned_dim=16
    ).xchg is None
    moved = batch.to("cpu")
    assert torch.equal(moved.xchg.vals_dest, batch.xchg.vals_dest)
