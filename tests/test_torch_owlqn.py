"""Port parity: OWL-QN against the JAX package's ``owlqn`` on the problems
of ``tests/test_optimizers.py:108,144,163``, and the problem layer that
routes L1 and the elastic net to it.

Held to: the same total objective value to rtol 1e-5 and the same pattern
of exact zeros; with zero L1, the value of the port's own L-BFGS to rtol
1e-5.  The coefficients of two float32 fits that sum in different orders
agree to the width of the flat bottom (``tests/test_torch_train.py``):
1e-2 * max(1, |w|_inf).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxConfig
from photon_tpu.core.optimizers import owlqn as jax_owlqn
from photon_tpu.data.batch import dense_batch as jax_dense
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig, lbfgs, owlqn
from photon_tpu_torch.core.optimizers.owlqn import (
    _orthant_project,
    _project_direction,
    _pseudo_gradient,
)
from photon_tpu_torch.core.problem import GlmOptimizationProblem, ProblemConfig
from photon_tpu_torch.data.batch import dense_batch

CFG = dict(max_iterations=200, tolerance=1e-10, gradient_tolerance=1e-7)


def _lasso():
    """tests/test_optimizers.py:108: three true features of fifteen."""
    rng = np.random.default_rng(4)
    n, d = 120, 15
    x = rng.normal(size=(n, d)).astype(np.float32)
    w_true = np.zeros(d, np.float32)
    w_true[:3] = [2.0, -3.0, 1.5]
    y = (x @ w_true + 0.01 * rng.normal(size=n)).astype(np.float32)
    return x, y, RegularizationContext("l1", 25.0)


def _elastic_net():
    """tests/test_optimizers.py:144: BASELINE config 2's problem, small."""
    rng = np.random.default_rng(5)
    n, d = 100, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    w_true = np.zeros(d, np.float32)
    w_true[:2] = [1.0, -2.0]
    y = (x @ w_true).astype(np.float32)
    return x, y, RegularizationContext("elastic_net", 10.0, alpha=0.5)


def _fit_both(x, y, reg, loss="squared"):
    obj_j = JaxObjective.create(loss, JaxReg(reg.reg_type, reg.reg_weight, reg.alpha))
    jb = jax_dense(x, y)
    ref = jax_owlqn(jax.jit(lambda w: obj_j.value_and_grad(w, jb)),
                    jnp.zeros(x.shape[1]), JaxConfig(**CFG), l1_weight=reg.l1_weight)
    obj = GlmObjective.create(loss, reg)
    tb = dense_batch(x, y, device="cpu")
    got = owlqn(lambda w: obj.value_and_grad(w, tb), torch.zeros(x.shape[1]),
                OptimizerConfig(**CFG), l1_weight=reg.l1_weight)
    return ref, got


@pytest.mark.parametrize("problem", [_lasso, _elastic_net])
def test_owlqn_matches_reference(problem):
    x, y, reg = problem()
    ref, got = _fit_both(x, y, reg)
    np.testing.assert_allclose(got.value, float(ref.value), rtol=1e-5)
    w_ref, w = np.asarray(ref.w), got.w.numpy()
    np.testing.assert_array_equal(w == 0.0, w_ref == 0.0)
    np.testing.assert_allclose(w, w_ref, atol=1e-2 * max(1.0, float(np.abs(w_ref).max())))
    assert got.converged == bool(ref.converged)
    assert got.host_reads >= got.evaluations >= got.iterations + 1
    # The history is on the total objective and never rises.
    values = got.history_value[got.history_valid]
    np.testing.assert_allclose(values[0], float(ref.history_value[0]), rtol=1e-5)
    assert np.all(np.diff(values) <= 1e-6 * abs(values[0]))
    assert int(np.sum(w == 0.0)) >= 1


def test_zero_l1_matches_lbfgs():
    """tests/test_optimizers.py:163 on the port: with no L1 OWL-QN is
    L-BFGS."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(200, 10)).astype(np.float32)
    w_true = rng.normal(size=10).astype(np.float32)
    y = (rng.random(200) < 1.0 / (1.0 + np.exp(-(x @ w_true)))).astype(np.float32)
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 1.0))
    tb = dense_batch(x, y, device="cpu")
    fun = lambda w: obj.value_and_grad(w, tb)  # noqa: E731
    r1 = lbfgs(fun, torch.zeros(10), OptimizerConfig(**CFG))
    r2 = owlqn(fun, torch.zeros(10), OptimizerConfig(**CFG), l1_weight=0.0)
    np.testing.assert_allclose(r2.value, r1.value, rtol=1e-5)
    np.testing.assert_allclose(r2.w.numpy(), r1.w.numpy(), rtol=1e-4, atol=1e-5)


def test_orthant_helpers_match_reference():
    # The package exports the function under the module's name.
    jmod = importlib.import_module("photon_tpu.core.optimizers.owlqn")
    rng = np.random.default_rng(7)
    w = rng.normal(size=64).astype(np.float32)
    w[::4] = 0.0
    g = rng.normal(size=64).astype(np.float32)
    d = rng.normal(size=64).astype(np.float32)
    for l1 in (0.0, 0.3, 2.0):
        np.testing.assert_array_equal(
            _pseudo_gradient(torch.as_tensor(w), torch.as_tensor(g), l1).numpy(),
            np.asarray(jmod._pseudo_gradient(jnp.asarray(w), jnp.asarray(g),
                                             jnp.float32(l1))))
    np.testing.assert_array_equal(
        _project_direction(torch.as_tensor(d), torch.as_tensor(g)).numpy(),
        np.asarray(jmod._project_direction(jnp.asarray(d), jnp.asarray(g))))
    xi = np.sign(rng.normal(size=64)).astype(np.float32)
    np.testing.assert_array_equal(
        _orthant_project(torch.as_tensor(d), torch.as_tensor(xi)).numpy(),
        np.asarray(jmod._orthant_project(jnp.asarray(d), jnp.asarray(xi))))


def test_problem_routes_l1_to_owlqn():
    x, y, reg = _elastic_net()
    problem = GlmOptimizationProblem(
        GlmObjective.create("squared", reg),
        ProblemConfig(optimizer="owlqn", regularization=reg,
                      optimizer_config=OptimizerConfig(**CFG)))
    coefficients, result = problem.run(dense_batch(x, y, device="cpu"), dim=10)
    _, ref = _fit_both(x, y, reg)
    np.testing.assert_allclose(result.value, ref.value, rtol=1e-5)
    assert torch.equal(coefficients.means, result.w)
    for optimizer in ("lbfgs", "tron", "newton_cg"):
        with pytest.raises(ValueError, match="OWL-QN"):
            ProblemConfig(optimizer=optimizer, regularization=reg)
    assert ProblemConfig(optimizer="OWL-QN", regularization=reg).optimizer == "OWL-QN"
