"""Port parity for second-order GLM training: Hessian-vector products,
Hessian diagonal and matrix on every route, TRON, Newton-CG, the SIMPLE and
FULL variances and the train CLI with ``--optimizer tron``, against the JAX
package on the same numpy inputs.

Tolerances are the reference tests' own: Hv rtol 2e-4, atol 1e-5
(tests/test_benes.py, float32 sums in other orders); the Hessian diagonal
rtol 1e-4, atol 1e-4 (tests/test_objective.py); the Hessian matrix and the
FULL variance rtol 1e-3 (tests/test_variance_full.py); TRON's and
Newton-CG's final w rtol 1e-3, atol 1e-4 (tests/test_optimizers.py); a
sparse fit's coefficients rtol 1e-2, atol 1e-3 and objective rtol 1e-5
(tests/test_xchg.py: two float32 solvers part inside the flat bottom); the
CLI's AUC within 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core import variance as jax_variance
from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxConfig
from photon_tpu.core.optimizers import newton_cg as jax_newton_cg
from photon_tpu.core.optimizers import tron as jax_tron
from photon_tpu.core.problem import GlmOptimizationProblem as JaxProblem
from photon_tpu.core.problem import ProblemConfig as JaxProblemConfig
from photon_tpu.core.problem import hvp_at_for as jax_hvp_at_for
from photon_tpu.data.batch import DenseBatch as JaxDense
from photon_tpu.data.batch import SparseBatch as JaxBatch
from photon_tpu.drivers import train as jax_train
from photon_tpu_torch.core import variance
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig, newton_cg, tron
from photon_tpu_torch.core.problem import (
    GlmOptimizationProblem,
    ProblemConfig,
    hvp_at_for,
)
from photon_tpu_torch.data.batch import DenseBatch, SparseBatch, attach_feature_major
from photon_tpu_torch.drivers import train

HERE = os.path.dirname(os.path.abspath(__file__))
A1A = os.path.join(HERE, "fixtures", "a1a.libsvm")
A1A_T = os.path.join(HERE, "fixtures", "a1a.t.libsvm")
ROUTES = ["fused", "pallas", "xchg", "benes", "fm", "autodiff"]
CFG = OptimizerConfig(max_iterations=200, tolerance=1e-10, gradient_tolerance=1e-7)
JAX_CFG = JaxConfig(max_iterations=200, tolerance=1e-10, gradient_tolerance=1e-7)


@pytest.fixture(autouse=True)
def _no_route_cache(monkeypatch):
    monkeypatch.setenv("PHOTON_ROUTE_CACHE", "0")  # the JAX side's disk cache


def _arrays(n=256, k=6, d=48, seed=1, zipf=False, poisson=False):
    rng = np.random.default_rng(seed)
    if zipf:
        ids = np.minimum(rng.zipf(1.3, size=(n, k)) - 1, d - 1).astype(np.int32)
    else:
        ids = rng.integers(0, d, size=(n, k), dtype=np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    vals[rng.random((n, k)) < 0.15] = 0.0
    w_true = (rng.standard_normal(d) * 0.2).astype(np.float32)
    if poisson:
        label = rng.poisson(np.exp((w_true[ids] * vals).sum(1))).astype(np.float32)
    else:
        label = (rng.random(n) < 0.4).astype(np.float32)
    offset = (rng.standard_normal(n) * 0.1).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return ids, vals, label, offset, weight


def _port_batch(monkeypatch, route, arrays, d):
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", route)
    batch = SparseBatch(*(torch.as_tensor(a) for a in arrays))
    if route == "fused":
        return batch
    aligned = route in ("pallas", "xchg", "benes")
    return attach_feature_major(batch, aligned_dim=d if aligned else None)


def _jax_batch(arrays):
    return JaxBatch(*(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
@pytest.mark.parametrize("route", ROUTES)
def test_hessian_terms_match_jax(monkeypatch, route, loss):
    d = 48
    arrays = _arrays(d=d, seed=11, zipf=route in ("xchg", "fm"),
                     poisson=loss == "poisson")
    rng = np.random.default_rng(12)
    w = (rng.standard_normal(d) * 0.1).astype(np.float32)
    v = rng.standard_normal(d).astype(np.float32)
    obj_j = JaxObjective.create(loss, JaxReg("l2", 0.6))
    jb = _jax_batch(arrays)
    hv_ref = np.asarray(obj_j.hessian_vector(jnp.asarray(w), jnp.asarray(v), jb))
    diag_ref = np.asarray(obj_j.hessian_diagonal(jnp.asarray(w), jb))
    h_ref = np.asarray(obj_j.hessian_matrix(jnp.asarray(w), jb))

    batch = _port_batch(monkeypatch, route, arrays, d)
    obj = GlmObjective.create(loss, RegularizationContext("l2", 0.6))
    assert obj._sparse_kernel(batch, d) == route
    wt, vt = torch.as_tensor(w), torch.as_tensor(v)
    hv = obj.hessian_vector(wt, vt, batch)
    np.testing.assert_allclose(hv.numpy(), hv_ref, rtol=2e-4, atol=1e-5)
    # The operator computes D(w) once and reproduces the one-shot product.
    op = obj.hvp_operator(wt, batch)
    assert torch.equal(op(vt), obj.hessian_vector_product(wt, vt, batch))
    np.testing.assert_allclose(op(vt).numpy(), hv_ref, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(
        obj.hessian_diagonal(wt, batch).numpy(), diag_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        obj.hessian_matrix(wt, batch).numpy(), h_ref, rtol=1e-3, atol=1e-3)


def test_dense_batch_hessian_terms_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((120, 9)).astype(np.float32)
    y = (rng.random(120) < 0.5).astype(np.float32)
    offset = (rng.standard_normal(120) * 0.1).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, 120).astype(np.float32)
    w = (rng.standard_normal(9) * 0.3).astype(np.float32)
    v = rng.standard_normal(9).astype(np.float32)
    obj_j = JaxObjective.create("logistic", JaxReg("l2", 0.3))
    jb = JaxDense(*(jnp.asarray(a) for a in (x, y, offset, weight)))
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 0.3))
    tb = DenseBatch(*(torch.as_tensor(a) for a in (x, y, offset, weight)))
    wt, vt = torch.as_tensor(w), torch.as_tensor(v)
    np.testing.assert_allclose(
        obj.hessian_vector_product(wt, vt, tb).numpy(),
        np.asarray(obj_j.hessian_vector_product(jnp.asarray(w), jnp.asarray(v), jb)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        obj.hessian_diagonal(wt, tb).numpy(),
        np.asarray(obj_j.hessian_diagonal(jnp.asarray(w), jb)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        obj.hessian_matrix(wt, tb).numpy(),
        np.asarray(obj_j.hessian_matrix(jnp.asarray(w), jb)), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("loss", ["logistic", "poisson"])
@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_fused_hvp_operator_matches_jax(monkeypatch, dist, loss):
    """The ``fused`` route's Hv (the row-major gather and the row scatter,
    on the CPU the scatter's plain version) against the JAX package's
    ``hvp_operator`` on uniform and zipf ids, at the tolerances of
    test_hessian_terms_match_jax; one D(w) serves several products."""
    d = 48
    arrays = _arrays(d=d, seed=23, zipf=dist == "zipf", poisson=loss == "poisson")
    rng = np.random.default_rng(24)
    w = (rng.standard_normal(d) * 0.1).astype(np.float32)
    obj_j = JaxObjective.create(loss, JaxReg("l2", 0.6))
    op_j = obj_j.hvp_operator(jnp.asarray(w), _jax_batch(arrays))
    batch = _port_batch(monkeypatch, "fused", arrays, d)
    obj = GlmObjective.create(loss, RegularizationContext("l2", 0.6))
    assert obj._sparse_kernel(batch, d) == "fused"
    op = obj.hvp_operator(torch.as_tensor(w), batch)
    for _ in range(3):
        v = rng.standard_normal(d).astype(np.float32)
        np.testing.assert_allclose(op(torch.as_tensor(v)).numpy(),
                                   np.asarray(op_j(jnp.asarray(v))),
                                   rtol=2e-4, atol=1e-5)


def test_normalized_objective_waits():
    """Normalized objectives are ported: TRON fits in the normalized space
    through the normalized Hv, like the JAX package's, and the problem
    returns the coefficients and SIMPLE variances in the original space."""
    from photon_tpu.core.normalization import NormalizationContext as JaxNorm
    from photon_tpu.core.stats import BasicStatisticalSummary as JaxSummary
    from photon_tpu.data.batch import dense_batch as jax_dense
    from photon_tpu_torch.core.normalization import NormalizationContext
    from photon_tpu_torch.core.stats import BasicStatisticalSummary
    from photon_tpu_torch.data.batch import dense_batch

    rng = np.random.default_rng(40)
    x = (rng.standard_normal((200, 8)) * 3.0 + 1.0).astype(np.float32)
    x[:, -1] = 1.0
    y = (rng.random(200) < 1.0 / (1.0 + np.exp(-x @ (rng.standard_normal(8) * 0.2)))
         ).astype(np.float32)
    jb, tb = jax_dense(x, y), dense_batch(x, y, device="cpu")
    jnorm = JaxNorm.build("standardization", JaxSummary.from_batch(jb, 8), intercept_id=7)
    norm = NormalizationContext.build(
        "standardization", BasicStatisticalSummary.from_batch(tb, 8), intercept_id=7)
    cfg = dict(optimizer="tron", variance_computation="simple")
    jc, jr = JaxProblem(
        JaxObjective.create("logistic", JaxReg("l2", 0.5), normalization=jnorm),
        JaxProblemConfig(regularization=JaxReg("l2", 0.5), **cfg),
    ).run(jb, jnp.zeros(8, jnp.float32))
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 0.5),
                              normalization=norm)
    coef, res = GlmOptimizationProblem(
        obj, ProblemConfig(regularization=RegularizationContext("l2", 0.5), **cfg),
    ).run(tb, dim=8)
    np.testing.assert_allclose(res.value, float(jr.value), rtol=1e-5)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(jr.w), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(coef.means.numpy(),
                               np.asarray(jnorm.model_to_original_space(jc.means)),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(coef.variances.numpy(),
                               np.asarray(jnorm.variances_to_original_space(jc.variances)),
                               rtol=1e-3)


def _quadratic(seed):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(8, 8))
    a = (m @ m.T + 8 * np.eye(8)).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    return a, b


def test_tron_quadratic_matches_jax():
    """tests/test_optimizers.py::test_tron_quadratic_exact on both packages."""
    a, b = _quadratic(1)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    ref = jax_tron(lambda w: (0.5 * w @ aj @ w - bj @ w, aj @ w - bj),
                   jnp.zeros(8), JAX_CFG, hvp=lambda w, v: aj @ v)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    res = tron(lambda w: (0.5 * w @ at @ w - bt @ w, at @ w - bt),
               torch.zeros(8), CFG, hvp=lambda w, v: at @ v)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(res.w.numpy(), np.linalg.solve(a, b), rtol=1e-3, atol=1e-4)
    assert res.host_reads == 1 + res.iterations + res.cg_iterations


def _poisson_dense(seed=3, n=300, d=8):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    w_true = (rng.normal(size=d) * 0.5).astype(np.float32)
    y = rng.poisson(np.exp(x @ w_true)).astype(np.float32)
    return x, y, w_true


@pytest.mark.parametrize("solver", ["tron", "newton_cg"])
def test_poisson_dense_matches_jax(solver):
    """tests/test_optimizers.py::test_poisson_tron_converges on both
    packages, and the same problem through Newton-CG."""
    x, y, w_true = _poisson_dense()
    n, d = x.shape
    ones, zeros = np.ones(n, np.float32), np.zeros(n, np.float32)
    obj_j = JaxObjective.create("poisson", JaxReg("l2", 0.5))
    jb = JaxDense(*(jnp.asarray(a) for a in (x, y, zeros, ones)))
    fun_j = jax.jit(lambda w: obj_j.value_and_grad(w, jb))
    obj = GlmObjective.create("poisson", RegularizationContext("l2", 0.5))
    tb = DenseBatch(*(torch.as_tensor(a) for a in (x, y, zeros, ones)))
    if solver == "tron":
        ref = jax_tron(fun_j, jnp.zeros(d), JAX_CFG, hvp_at=jax_hvp_at_for(obj_j, jb))
        res = tron(lambda w: obj.value_and_grad(w, tb), torch.zeros(d), CFG,
                   hvp=lambda w, v: obj.hessian_vector(w, v, tb))
    else:
        ref = jax_newton_cg(fun_j, jnp.zeros(d), JAX_CFG,
                            hvp_at=jax_hvp_at_for(obj_j, jb),
                            diag=lambda w: obj_j.hessian_diagonal(w, jb))
        res = newton_cg(lambda w: obj.value_and_grad(w, tb), torch.zeros(d), CFG,
                        hvp_at=hvp_at_for(obj, tb),
                        diag=lambda w: obj.hessian_diagonal(w, tb))
        assert res.cg_iterations > 0
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=1e-3, atol=1e-4)
    assert res.grad_norm < 1e-3 * max(1.0, res.value)
    assert np.corrcoef(res.w.numpy(), w_true)[0, 1] > 0.9


@pytest.mark.parametrize("solver", ["tron", "newton_cg"])
@pytest.mark.parametrize("route", ["fused", "pallas", "xchg", "benes"])
def test_sparse_problem_matches_jax(monkeypatch, route, solver):
    """GlmOptimizationProblem.run on a sparse Poisson batch through each
    route against the JAX package's problem on the plain batch."""
    d = 32
    arrays = _arrays(n=300, k=5, d=d, seed=21, poisson=True)
    reg = 1.0
    ref_c, ref_r = JaxProblem(
        JaxObjective.create("poisson", JaxReg("l2", reg)),
        JaxProblemConfig(optimizer=solver, regularization=JaxReg("l2", reg)),
    ).run(_jax_batch(arrays), dim=d)
    batch = _port_batch(monkeypatch, route, arrays, d)
    c, r = GlmOptimizationProblem(
        GlmObjective.create("poisson", RegularizationContext("l2", reg)),
        ProblemConfig(optimizer=solver, regularization=RegularizationContext("l2", reg)),
    ).run(batch, dim=d)
    np.testing.assert_allclose(r.value, float(ref_r.value), rtol=1e-5)
    np.testing.assert_allclose(c.means.numpy(), np.asarray(ref_c.means),
                               rtol=1e-2, atol=1e-3)
    assert r.cg_iterations > 0 and r.host_reads > r.cg_iterations


def test_tron_counts_rejected_trials_and_needs_curvature():
    with pytest.raises(ValueError, match="hvp"):
        tron(lambda w: (w @ w, 2 * w), torch.ones(3))
    with pytest.raises(ValueError, match="hvp_at"):
        newton_cg(lambda w: (w @ w, 2 * w), torch.ones(3))
    # A model whose curvature understates the function: long trial steps
    # are rejected, and each counts as an iteration, as in the reference.
    res = tron(lambda w: ((w ** 4).sum(), 4 * w ** 3), torch.full((4,), 3.0),
               OptimizerConfig(max_iterations=6), hvp=lambda w, v: 0.01 * v)
    ref = jax_tron(lambda w: ((w ** 4).sum(), 4 * w ** 3), jnp.full((4,), 3.0),
                   JaxConfig(max_iterations=6), hvp=lambda w, v: 0.01 * v)
    assert res.iterations == int(ref.iterations) == 6
    assert res.reason == int(ref.reason)
    np.testing.assert_array_equal(res.history_valid, np.asarray(ref.history_valid))
    assert res.history_valid.sum() - 1 < res.iterations  # some were rejected
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=1e-3, atol=1e-4)


def test_newton_cg_negative_curvature_falls_back():
    """tests/test_newton_cg.py::test_negative_curvature_falls_back_to_steepest_descent."""
    def fun(w):
        return -0.5 * torch.dot(w, w), -w

    w0 = torch.tensor([1.0, -2.0, 0.5])
    cfg = OptimizerConfig(max_iterations=5, tolerance=0.0, gradient_tolerance=1e-12)
    res = newton_cg(fun, w0, cfg, hvp_at=lambda w: (lambda v: -v))
    assert bool(torch.isfinite(res.w).all())
    assert res.value < float(fun(w0)[0])
    assert not res.converged
    assert res.cg_iterations >= 1


@pytest.mark.parametrize("kind", ["simple", "full"])
@pytest.mark.parametrize("route", ["fused", "pallas"])
def test_variances_match_jax(monkeypatch, route, kind):
    d = 24
    arrays = _arrays(n=200, k=4, d=d, seed=31)
    w = (np.random.default_rng(32).standard_normal(d) * 0.2).astype(np.float32)
    ref = JaxProblem(
        JaxObjective.create("logistic", JaxReg("l2", 0.5)),
        JaxProblemConfig(variance_computation=kind),
    ).compute_variances(jnp.asarray(w), _jax_batch(arrays))
    batch = _port_batch(monkeypatch, route, arrays, d)
    got = GlmOptimizationProblem(
        GlmObjective.create("logistic", RegularizationContext("l2", 0.5)),
        ProblemConfig(variance_computation=kind),
    ).compute_variances(torch.as_tensor(w), batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-5)


def test_cg_solve_matches_direct():
    """tests/test_variance_full.py::test_cg_solve_matches_direct, both packages."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((24, 24)).astype(np.float32)
    h = a @ a.T + 24 * np.eye(24, dtype=np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    ht = torch.as_tensor(h)
    x = variance.cg_solve(lambda v: ht @ v, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(h @ x, b, rtol=1e-3, atol=1e-4)
    x_j = np.asarray(jax_variance.cg_solve(lambda v: jnp.asarray(h) @ v, jnp.asarray(b)))
    np.testing.assert_allclose(x, x_j, rtol=1e-3, atol=1e-4)


def _orthogonal_batch(d, per, seed):
    """Each example touches one feature: the Hessian is diagonal."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(d, dtype=np.int32), per)[:, None]
    vals = rng.uniform(0.5, 2.0, (d * per, 1)).astype(np.float32)
    label = (rng.random(d * per) < 0.5).astype(np.float32)
    return ids, vals, label, np.zeros(d * per, np.float32), np.ones(d * per, np.float32)


def test_hutchinson_exact_for_orthogonal_features():
    """tests/test_variance_full.py::test_hutchinson_exact_for_orthogonal_features."""
    d = 16
    arrays = _orthogonal_batch(d, 8, seed=1)
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 0.5))
    batch = SparseBatch(*(torch.as_tensor(a) for a in arrays))
    w = torch.as_tensor(np.random.default_rng(1).standard_normal(d).astype(np.float32)) * 0.1
    est = variance.hutchinson_diag_inverse(
        obj.hvp_operator(w, batch), dim=d, num_probes=2)
    h = obj.hessian_matrix(w, batch).numpy()
    assert np.abs(h - np.diag(np.diag(h))).max() < 1e-5
    np.testing.assert_allclose(est.numpy(), 1.0 / np.diag(h), rtol=1e-3)


def test_hutchinson_matches_exact_estimator_on_given_probes():
    """On a general Hessian the estimate is mean(z * H^-1 z) over the
    probes: held to that sum computed in float64 from the dense Hessian."""
    d = 20
    arrays = _arrays(n=160, k=4, d=d, seed=41)
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 1.0))
    batch = SparseBatch(*(torch.as_tensor(a) for a in arrays))
    w = torch.zeros(d)
    probes = np.where(np.random.default_rng(42).random((6, d)) < 0.5, -1.0, 1.0)
    est = variance.hutchinson_diag_inverse(
        obj.hvp_operator(w, batch), dim=d, probes=probes, cg_tol=1e-6)
    h = obj.hessian_matrix(w, batch).double().numpy() + 1e-9 * np.eye(d)
    want = np.maximum((probes * np.linalg.solve(h, probes.T).T).mean(0), 0.0)
    np.testing.assert_allclose(est.numpy(), want, rtol=1e-3, atol=1e-6)
    seeded = variance.rademacher_probes(d, 4, seed=7)
    assert torch.equal(seeded, variance.rademacher_probes(d, 4, seed=7))
    assert set(seeded.unique().tolist()) == {-1.0, 1.0}


def test_full_variance_routes_matrix_free_above_threshold(monkeypatch):
    """tests/test_variance_full.py::test_full_variance_routes_matrix_free_above_threshold."""
    monkeypatch.setattr(variance, "FULL_DENSE_MAX_DIM", 4)
    d = 12
    arrays = _orthogonal_batch(d, 6, seed=2)
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 1.0))
    batch = SparseBatch(*(torch.as_tensor(a) for a in arrays))
    coeffs, _ = GlmOptimizationProblem(
        obj, ProblemConfig(variance_computation="full")).run(batch, dim=d)
    h = obj.hessian_matrix(coeffs.means, batch).numpy()
    np.testing.assert_allclose(coeffs.variances.numpy(), 1.0 / np.diag(h), rtol=1e-3)


def _best(summary):
    return next(e for e in summary["sweep"] if e["lambda"] == summary["best_lambda"])


def test_cli_tron_simple_variances_match_jax_driver(monkeypatch, tmp_path):
    monkeypatch.delenv("PHOTON_SPARSE_GRAD", raising=False)
    args = [
        "--input", A1A, "--validation-input", A1A_T,
        "--task", "logistic_regression", "--optimizer", "tron",
        "--variance-computation", "simple", "--reg-weights", "0.1,1,10",
        "--evaluators", "AUC,LOGISTIC_LOSS", "--model-format", "json",
    ]
    ours = train.run(train.build_parser().parse_args(
        args + ["--output-dir", str(tmp_path / "port"), "--backend", "cpu"]))
    ref = jax_train.run(jax_train.build_parser().parse_args(
        args + ["--output-dir", str(tmp_path / "jax")]))
    assert ours["optimizer"] == ref["optimizer"] == "tron"
    assert ours["best_lambda"] == ref["best_lambda"]
    assert abs(_best(ours)["metrics"]["AUC"] - _best(ref)["metrics"]["AUC"]) <= 1e-4

    def variances(path):
        with open(path) as f:
            record = json.load(f)
        return {(t["name"], t["term"]): t["value"] for t in record["variances"]}

    got = variances(tmp_path / "port" / "best_model.json")
    want = variances(tmp_path / "jax" / "best_model.json")
    assert got.keys() == want.keys() and len(got) > 100
    keys = sorted(got)
    np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys],
                               rtol=1e-3)
