"""Port parity for the trained GLM: L-BFGS on a1a, the train CLI, and models
carried across from the JAX package.

Two float32 L-BFGS programs that sum in different orders follow the same
path for many iterations and part only near the end: the function-value
test (relative change <= 1e-7, about one float32 ulp of the objective)
fires when a step stops moving f by more than rounding, and where exactly
that happens inside the flat bottom differs by a few iterations.  So the
fit is held to: the same stopping reason; the early history to rtol 1e-5;
the final value to rtol 1e-5; the coefficients to 1e-2 * max(1, |w|_inf)
(the width of that flat bottom in w); the iteration count to within 10%.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.problem import GlmOptimizationProblem as JaxProblem
from photon_tpu.core.problem import ProblemConfig as JaxProblemConfig
from photon_tpu.data.index_map import IndexMap as JaxIndexMap
from photon_tpu.data.libsvm import load_sparse_batch as jax_load
from photon_tpu.data.model_io import load_glm_model as jax_load_model
from photon_tpu.data.model_io import save_glm_model as jax_save_model
from photon_tpu.drivers import train as jax_train
from photon_tpu.models.glm import Coefficients as JaxCoefficients
from photon_tpu.models.glm import model_for_task as jax_model_for_task
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizationStatesTracker, OptimizerConfig
from photon_tpu_torch.core.problem import GlmOptimizationProblem, ProblemConfig
from photon_tpu_torch.data.index_map import IndexMap, feature_key
from photon_tpu_torch.data.libsvm import load_sparse_batch
from photon_tpu_torch.data.model_io import load_glm_model, save_glm_model
from photon_tpu_torch.drivers import train
from photon_tpu_torch.models.glm import from_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
A1A = os.path.join(HERE, "fixtures", "a1a.libsvm")
A1A_T = os.path.join(HERE, "fixtures", "a1a.t.libsvm")


def test_libsvm_batches_bit_identical():
    jb, jd, jraw = jax_load(A1A)
    tb, td, traw = load_sparse_batch(A1A, device="cpu")
    assert (jd, jraw) == (td, traw)
    for name in ("ids", "vals", "label", "offset", "weight"):
        np.testing.assert_array_equal(
            getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), name
        )


def test_lbfgs_fit_on_a1a_matches_jax():
    jb, dim, _ = jax_load(A1A)
    tb, _, _ = load_sparse_batch(A1A, device="cpu")
    w0 = (np.random.default_rng(0).standard_normal(dim) * 0.01).astype(np.float32)
    jc, jr = JaxProblem(
        JaxObjective.create("logistic", JaxReg("l2", 1.0)), JaxProblemConfig()
    ).run(jb, jnp.asarray(w0))
    tc, tr = GlmOptimizationProblem(
        GlmObjective.create("logistic", RegularizationContext("l2", 1.0)),
        ProblemConfig(),
    ).run(tb, torch.as_tensor(w0))
    assert tr.reason == int(jr.reason) and tr.converged == bool(jr.converged)
    early = slice(0, 6)
    np.testing.assert_allclose(
        tr.history_value[early], np.asarray(jr.history_value)[early], rtol=1e-5
    )
    np.testing.assert_allclose(tr.value, float(jr.value), rtol=1e-5)
    w_ref = np.asarray(jc.means)
    np.testing.assert_allclose(
        tc.means.numpy(), w_ref, atol=1e-2 * max(1.0, float(np.abs(w_ref).max()))
    )
    assert abs(tr.iterations - int(jr.iterations)) <= max(1, int(jr.iterations) // 10)
    tracker = OptimizationStatesTracker(tr)
    assert tracker.convergence_reason == "FUNCTION_VALUES_TOLERANCE"
    assert len(tracker.states()) == tr.iterations + 1


def test_lbfgs_stops_on_max_iterations_and_zero_gradient():
    tb, dim, _ = load_sparse_batch(A1A, device="cpu")
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 1.0))
    _, res = GlmOptimizationProblem(
        obj, ProblemConfig(optimizer_config=OptimizerConfig(max_iterations=3))
    ).run(tb, dim=dim)
    assert res.iterations == 3 and res.reason == 1 and not res.converged
    assert res.value < float(res.history_value[0])
    # Squared loss at its exact minimum: zero gradient at w0, no iteration.
    zero = tb._replace(label=torch.zeros_like(tb.label))
    _, res = GlmOptimizationProblem(
        GlmObjective.create("squared"), ProblemConfig()
    ).run(zero, dim=dim)
    assert res.iterations == 0 and res.reason == 3 and res.converged


def test_unported_optimizers_raise():
    with pytest.raises(NotImplementedError, match="queue 1"):
        ProblemConfig(optimizer="tron")
    with pytest.raises(NotImplementedError, match="queue 1"):
        ProblemConfig(variance_computation="simple")


def _best_auc(summary):
    best = next(e for e in summary["sweep"] if e["lambda"] == summary["best_lambda"])
    return best["metrics"]["AUC"]


def test_cli_cpu_matches_jax_driver(tmp_path):
    args = [
        "--input", A1A, "--validation-input", A1A_T,
        "--task", "logistic_regression", "--optimizer", "lbfgs",
        "--reg-type", "l2", "--reg-weights", "0.1,1,10",
        "--evaluators", "AUC,LOGISTIC_LOSS", "--backend", "cpu",
    ]
    port = train.run(train.build_parser().parse_args(
        args + ["--output-dir", str(tmp_path / "port")]
    ))
    ref = jax_train.run(jax_train.build_parser().parse_args(
        args + ["--output-dir", str(tmp_path / "jax"), "--no-telemetry"]
    ))
    assert port["best_lambda"] == ref["best_lambda"]
    assert abs(_best_auc(port) - _best_auc(ref)) <= 1e-4
    with open(tmp_path / "port" / "training_summary.json") as f:
        assert json.load(f)["best_lambda"] == port["best_lambda"]
    # Each package reads the other's model file.
    jmap = JaxIndexMap.load(str(tmp_path / "port" / "feature_index.json"))
    jmodel = jax_load_model(str(tmp_path / "port" / "best_model.avro"), jmap)
    tmap = IndexMap.load(str(tmp_path / "jax" / "feature_index.json"))
    tmodel = load_glm_model(str(tmp_path / "jax" / "best_model.avro"), tmap, device="cpu")
    assert jmodel.task_type == tmodel.task_type == "logistic_regression"


@pytest.mark.parametrize("fmt", ["avro", "json"])
def test_port_loads_jax_saved_model(tmp_path, fmt):
    rng = np.random.default_rng(4)
    keys = [feature_key(f"f{i}", "t" if i % 2 else "") for i in range(9)]
    means = rng.standard_normal(10).astype(np.float32)
    means[3] = 0.0  # dropped by the sparse writer, read back as 0
    variances = rng.uniform(0.1, 1.0, 10).astype(np.float32)
    jmap = JaxIndexMap.build(keys, intercept=True)
    path = str(tmp_path / f"model.{fmt}")
    jax_save_model(
        path,
        jax_model_for_task(
            "poisson_regression",
            JaxCoefficients(jnp.asarray(means), jnp.asarray(variances)),
        ),
        jmap, fmt=fmt,
    )
    model = load_glm_model(path, IndexMap.build(keys, intercept=True), device="cpu")
    assert model.task_type == "poisson_regression" and model.loss.name == "poisson"
    np.testing.assert_array_equal(model.coefficients.means.numpy(), means)
    np.testing.assert_array_equal(model.coefficients.variances.numpy(), variances)
    out = str(tmp_path / f"again.{fmt}")
    save_glm_model(out, model, IndexMap.build(keys, intercept=True), fmt=fmt)
    back = jax_load_model(out, jmap)
    np.testing.assert_array_equal(np.asarray(back.coefficients.means), means)


def test_from_numpy_scores_match_jax():
    jb, dim, _ = jax_load(A1A_T, dim=123)
    tb, _, _ = load_sparse_batch(A1A_T, dim=123, device="cpu")
    means = (np.random.default_rng(6).standard_normal(dim) * 0.3).astype(np.float32)
    jmodel = jax_model_for_task("logistic_regression", JaxCoefficients(jnp.asarray(means)))
    model = from_numpy(np.asarray(jmodel.coefficients.means), None,
                       "logistic_regression", device="cpu")
    np.testing.assert_allclose(
        model.compute_score(tb).numpy(), np.asarray(jmodel.compute_score(jb)),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        model.predict(tb).numpy(), np.asarray(jmodel.predict(jb)), rtol=1e-6, atol=1e-6
    )
    assert model.coefficients.variances is None
