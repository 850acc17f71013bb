"""Port parity: GlmObjective.value_and_grad on every route of the port
(``fused``, ``pallas``, ``fm``, ``autodiff``) against the JAX package's
GlmObjective with L2.

Tolerances are those of tests/test_fast_sparse.py: value rtol 1e-5;
gradient rtol 2e-4, atol 1e-5 (float32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.data.batch import SparseBatch as JaxBatch
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.data.batch import SparseBatch, attach_feature_major, dense_batch
from photon_tpu_torch.ops.sparse_grad_select import aligned_layout_wanted, select_kernel

ROUTES = ["fused", "pallas", "fm", "autodiff"]


def _arrays(n=512, k=8, d=64, seed=1, zipf=False, poisson=False):
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
    if poisson:
        label = rng.poisson(1.0, n).astype(np.float32)
    else:
        label = (rng.random(n) < 0.5).astype(np.float32)
    offset = rng.standard_normal(n).astype(np.float32) * 0.1
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w = (rng.standard_normal(d) * 0.1).astype(np.float32)
    return w, (ids, vals, label, offset, weight)


def _reference(loss, w, arrays, l2=0.7):
    obj = JaxObjective.create(loss, JaxReg("l2", l2))
    batch = JaxBatch(*(jnp.asarray(a) for a in arrays))
    v, g = obj.value_and_grad(jnp.asarray(w), batch)
    return float(v), np.asarray(g)


@pytest.mark.parametrize("zipf", [False, True])
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
@pytest.mark.parametrize("route", ROUTES)
def test_value_and_grad_matches_jax(monkeypatch, route, loss, zipf):
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", route)
    w, arrays = _arrays(zipf=zipf, poisson=loss == "poisson")
    v_ref, g_ref = _reference(loss, w, arrays)
    batch = SparseBatch(*(torch.as_tensor(a) for a in arrays))
    if route != "fused":
        batch = attach_feature_major(batch, aligned_dim=64 if route == "pallas" else None)
    obj = GlmObjective.create(loss, RegularizationContext("l2", 0.7))
    assert obj._sparse_kernel(batch) == route
    v, g = obj.value_and_grad(torch.as_tensor(w), batch)
    np.testing.assert_allclose(float(v), v_ref, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(
        float(obj.value(torch.as_tensor(w), batch)), v_ref, rtol=1e-5
    )


def test_pallas_route_with_gather_margins(monkeypatch):
    """Without the transposed layout the pallas route takes its margins from
    the row-major gather and still reduces the gradient through ``al``."""
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "pallas")
    w, arrays = _arrays(seed=7, zipf=True)
    v_ref, g_ref = _reference("logistic", w, arrays)
    batch = attach_feature_major(
        SparseBatch(*(torch.as_tensor(a) for a in arrays)),
        aligned_dim=64, aligned_forward=False,
    )
    assert batch.al is not None and batch.al_t is None
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 0.7))
    v, g = obj.value_and_grad(torch.as_tensor(w), batch)
    np.testing.assert_allclose(float(v), v_ref, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=2e-4, atol=1e-5)


def test_dense_batch_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((200, 16)).astype(np.float32)
    y = (rng.random(200) < 0.5).astype(np.float32)
    w = (rng.standard_normal(16) * 0.1).astype(np.float32)
    from photon_tpu.data.batch import dense_batch as jax_dense

    obj_j = JaxObjective.create("logistic", JaxReg("l2", 0.3))
    v_ref, g_ref = jax.value_and_grad(obj_j.value)(jnp.asarray(w), jax_dense(x, y))
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 0.3))
    v, g = obj.value_and_grad(torch.as_tensor(w), dense_batch(x, y, device="cpu"))
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=2e-4, atol=1e-5)


def test_route_selection(monkeypatch):
    monkeypatch.delenv("PHOTON_SPARSE_GRAD", raising=False)
    assert select_kernel(has_fm=True, has_aligned=True) == "fused"
    assert not aligned_layout_wanted()
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "pallas")
    assert aligned_layout_wanted()
    assert select_kernel(has_fm=True, has_aligned=True) == "pallas"
    assert select_kernel(has_fm=True, has_aligned=False) == "fm"
    assert select_kernel() == "fused"
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "fm")
    assert select_kernel(has_fm=False) == "autodiff"
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "xchg")
    assert aligned_layout_wanted()
    assert select_kernel(has_fm=True, has_aligned=True, has_xchg=True) == "xchg"
    assert select_kernel(has_fm=True, has_aligned=True) == "pallas"
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "benes")
    assert aligned_layout_wanted()
    assert select_kernel(has_fm=True, has_aligned=True, has_benes=True) == "benes"
    assert select_kernel(has_fm=True, has_aligned=True, has_xchg=True) == "pallas"
    assert select_kernel(has_fm=True) == "fm"
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "auto")
    assert select_kernel(has_fm=True, has_aligned=True, has_benes=True) == "fused"
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "bogus")
    with pytest.raises(ValueError):
        select_kernel()


def test_regularization_context():
    reg = RegularizationContext("elastic_net", 2.0, alpha=0.25)
    assert reg.l1_weight == 0.5 and reg.l2_weight == 1.5
    obj = GlmObjective.create("logistic", reg)
    assert obj.l1_weight == 0.5 and obj.l2_weight == 1.5
    with pytest.raises(ValueError):
        RegularizationContext("l3", 1.0)
