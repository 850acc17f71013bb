"""Port parity: feature statistics, normalization contexts and the
normalized objective against the JAX package on the same numpy inputs.

Tolerances are the reference tests' own: statistics as
``tests/test_objective.py:159`` holds sparse to dense (mean rtol 1e-4 /
atol 1e-5, variance rtol 1e-3 / atol 1e-5, extremes rtol 1e-5), the model
space round trips as ``:92`` and ``:109``; value rtol 1e-5, gradient and Hv
rtol 2e-4 / atol 1e-5 (``tests/test_fast_sparse.py:173,260,332``); the
Hessian diagonal and matrix rtol = atol = 1e-3 (``test_objective.py:130``,
``test_variance_full.py:43``).  The ``pallas`` route runs K2's plain version
here and the reference's Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core.normalization import NormalizationContext as JaxNorm
from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.stats import BasicStatisticalSummary as JaxSummary
from photon_tpu.core.stats import summarize as jax_summarize
from photon_tpu.data.batch import SparseBatch as JaxSparse
from photon_tpu.data.batch import attach_feature_major as jax_attach
from photon_tpu.data.batch import dense_batch as jax_dense
from photon_tpu_torch.core.normalization import NormalizationContext
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.core.stats import BasicStatisticalSummary, summarize
from photon_tpu_torch.data.batch import SparseBatch, attach_feature_major, dense_batch

TYPES = ["scale_with_standard_deviation", "scale_with_max_magnitude", "standardization"]
N, K, D = 256, 8, 40
INTERCEPT = D - 1


def _arrays(seed, n=N, k=K, d=D):
    """A padded sparse batch whose last slot of every row is the intercept
    (id d - 1, value 1); the other ids avoid it."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, d - 1, size=(n, k), dtype=np.int32)
    vals = (rng.standard_normal((n, k)) * 2.0 + 0.5).astype(np.float32)
    cut = rng.integers(1, k, size=n)
    pad = np.arange(k)[None, :] >= cut[:, None]
    ids[pad], vals[pad] = 0, 0.0
    ids[:, -1], vals[:, -1] = d - 1, 1.0
    label = (rng.random(n) < 0.5).astype(np.float32)
    offset = (rng.standard_normal(n) * 0.1).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return ids, vals, label, offset, weight


def _both(arrays):
    return (JaxSparse(*(jnp.asarray(a) for a in arrays)),
            SparseBatch(*(torch.as_tensor(a) for a in arrays)))


def _close_summary(got, ref):
    np.testing.assert_allclose(float(got.count), float(ref.count))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.variance.numpy(), np.asarray(ref.variance),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.min.numpy(), np.asarray(ref.min), rtol=1e-5)
    np.testing.assert_allclose(got.max.numpy(), np.asarray(ref.max), rtol=1e-5)
    np.testing.assert_array_equal(got.num_nonzeros.numpy(), np.asarray(ref.num_nonzeros))


def test_stats_match_reference_summarize():
    jb, tb = _both(_arrays(1))
    _close_summary(BasicStatisticalSummary.from_batch(tb, D), JaxSummary.from_batch(jb, D))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((90, 12)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = 0.0
    _close_summary(BasicStatisticalSummary.from_batch(dense_batch(x, None, device="cpu"), 12),
                   JaxSummary.from_batch(jax_dense(x, np.zeros(90)), 12))
    # The associative merge over several batches.
    parts = [_arrays(s, n=64) for s in (3, 4, 5)]
    _close_summary(summarize([_both(a)[1] for a in parts], D),
                   jax_summarize([_both(a)[0] for a in parts], D))


@pytest.mark.parametrize("norm_type", TYPES)
def test_build_matches_reference(norm_type):
    jb, tb = _both(_arrays(6))
    ref = JaxNorm.build(norm_type, JaxSummary.from_batch(jb, D), intercept_id=INTERCEPT)
    got = NormalizationContext.build(norm_type, BasicStatisticalSummary.from_batch(tb, D),
                                     intercept_id=INTERCEPT)
    np.testing.assert_allclose(got.factors.numpy(), np.asarray(ref.factors), rtol=1e-4)
    assert got.factors[INTERCEPT] == 1.0
    if norm_type == "standardization":
        np.testing.assert_allclose(got.shifts.numpy(), np.asarray(ref.shifts),
                                   rtol=1e-4, atol=1e-5)
        assert got.shifts[INTERCEPT] == 0.0
    else:
        assert got.shifts is None and ref.shifts is None
    assert NormalizationContext.build("none", None) is None
    with pytest.raises(ValueError):
        NormalizationContext.build("standardization", BasicStatisticalSummary.from_batch(tb, D))


def test_model_space_round_trips():
    rng = np.random.default_rng(8)
    f = rng.uniform(0.5, 2.0, D).astype(np.float32)
    s = rng.standard_normal(D).astype(np.float32)
    f[INTERCEPT], s[INTERCEPT] = 1.0, 0.0
    w = rng.standard_normal(D).astype(np.float32)
    var = rng.uniform(0.1, 1.0, D).astype(np.float32)
    ref = JaxNorm(jnp.asarray(f), jnp.asarray(s), INTERCEPT)
    got = NormalizationContext(torch.as_tensor(f), torch.as_tensor(s), INTERCEPT)
    w_t = torch.as_tensor(w)
    np.testing.assert_allclose(got.model_to_original_space(w_t).numpy(),
                               np.asarray(ref.model_to_original_space(jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.model_to_normalized_space(got.model_to_original_space(w_t)).numpy(),
                               w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.variances_to_original_space(torch.as_tensor(var)).numpy(),
                               np.asarray(ref.variances_to_original_space(jnp.asarray(var))),
                               rtol=1e-5)
    assert got.variances_to_original_space(None) is None
    # Margins of the normalized objective equal the original-space model's.
    jb, tb = _both(_arrays(9))
    obj = GlmObjective.create("logistic", normalization=got)
    np.testing.assert_allclose(
        obj._margins(w_t, tb).numpy(),
        GlmObjective.create("logistic")._margins(got.model_to_original_space(w_t), tb).numpy(),
        rtol=1e-4, atol=1e-4)


def _contexts(norm_type, jb, tb):
    ref = JaxNorm.build(norm_type, JaxSummary.from_batch(jb, D), intercept_id=INTERCEPT)
    got = NormalizationContext(
        None if ref.factors is None else torch.tensor(np.array(ref.factors)),
        None if ref.shifts is None else torch.tensor(np.array(ref.shifts)),
        INTERCEPT)
    return ref, got


@pytest.mark.parametrize("route", ["autodiff", "fm", "pallas", "fused"])
@pytest.mark.parametrize("norm_type", TYPES)
def test_normalized_objective_matches_reference(monkeypatch, norm_type, route):
    """Value, gradient and Hv against the reference's normalized objective
    (its autodiff value and gradient, its jvp of the normalized gradient);
    on ``fused`` the port takes the plain reductions (K1 stays out)."""
    arrays = _arrays(10 + TYPES.index(norm_type))
    jb, tb = _both(arrays)
    ref_norm, norm = _contexts(norm_type, jb, tb)
    loss = "poisson" if route == "fm" else "logistic"
    obj_j = JaxObjective.create(loss, JaxReg("l2", 0.4), normalization=ref_norm)
    obj = GlmObjective.create(loss, RegularizationContext("l2", 0.4), normalization=norm)
    rng = np.random.default_rng(20)
    w = (rng.standard_normal(D) * 0.1).astype(np.float32)
    v = rng.standard_normal(D).astype(np.float32)
    v_ref, g_ref = jax.value_and_grad(obj_j.value)(jnp.asarray(w), jb)
    hv_ref = jax.jvp(lambda u: jax.grad(obj_j.value)(u, jb), (jnp.asarray(w),),
                     (jnp.asarray(v),))[1]
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", route)
    if route in ("fm", "pallas"):
        tb = attach_feature_major(tb, aligned_dim=D if route == "pallas" else None)
    expect = "autodiff" if route == "fused" else route
    assert obj._sparse_kernel(tb, D) == expect
    if route == "fused":
        from photon_tpu_torch.ops import fused_sparse

        def no_k1(*a, **k):
            raise AssertionError("K1 ran under normalization")

        monkeypatch.setattr(fused_sparse, "fused_value_and_grad", no_k1)
    val, g = obj.value_and_grad(torch.as_tensor(w), tb)
    np.testing.assert_allclose(float(val), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=2e-4, atol=1e-5)
    hv = obj.hessian_vector(torch.as_tensor(w), torch.as_tensor(v), tb)
    np.testing.assert_allclose(hv.numpy(), np.asarray(hv_ref), rtol=2e-4, atol=1e-5)
    if route == "pallas":
        # The reference's own pallas route under normalization (interpret mode).
        jfast = jax_attach(jb, aligned_dim=D)
        v_p, g_p = obj_j.value_and_grad(jnp.asarray(w), jfast)
        np.testing.assert_allclose(float(val), float(v_p), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_p), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("norm_type", TYPES)
def test_normalized_hessians_match_reference(norm_type):
    jb, tb = _both(_arrays(30 + TYPES.index(norm_type)))
    ref_norm, norm = _contexts(norm_type, jb, tb)
    obj_j = JaxObjective.create("logistic", JaxReg("l2", 0.5), normalization=ref_norm)
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 0.5), normalization=norm)
    w = (np.random.default_rng(31).standard_normal(D) * 0.2).astype(np.float32)
    h_ref = np.asarray(jax.hessian(obj_j.value)(jnp.asarray(w), jb))
    np.testing.assert_allclose(obj.hessian_matrix(torch.as_tensor(w), tb).numpy(), h_ref,
                               rtol=1e-3, atol=1e-3)
    # The sparse diagonal sums each entry's square, as the reference's does
    # (ids repeat within a row here, so it is held to the reference's).
    np.testing.assert_allclose(
        obj.hessian_diagonal(torch.as_tensor(w), tb).numpy(),
        np.asarray(obj_j.hessian_diagonal(jnp.asarray(w), jb)), rtol=1e-3, atol=1e-3)
    # A dense batch through the same algebra.
    rng = np.random.default_rng(32)
    x = rng.standard_normal((120, 10)).astype(np.float32)
    x[:, -1] = 1.0
    y = (rng.random(120) < 0.5).astype(np.float32)
    jd, td = jax_dense(x, y), dense_batch(x, y, device="cpu")
    ref_d = JaxNorm.build(norm_type, JaxSummary.from_batch(jd, 10), intercept_id=9)
    got_d = NormalizationContext.build(norm_type, BasicStatisticalSummary.from_batch(td, 10),
                                       intercept_id=9)
    oj = JaxObjective.create("logistic", JaxReg("l2", 0.5), normalization=ref_d)
    ot = GlmObjective.create("logistic", RegularizationContext("l2", 0.5), normalization=got_d)
    wd = (rng.standard_normal(10) * 0.2).astype(np.float32)
    np.testing.assert_allclose(ot.hessian_matrix(torch.as_tensor(wd), td).numpy(),
                               np.asarray(jax.hessian(oj.value)(jnp.asarray(wd), jd)),
                               rtol=1e-3, atol=1e-3)
    v_ref, g_ref = jax.value_and_grad(oj.value)(jnp.asarray(wd), jd)
    val, g = ot.value_and_grad(torch.as_tensor(wd), td)
    np.testing.assert_allclose(float(val), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=2e-4, atol=1e-5)


def test_normalized_game_fixed_effect_matches_reference():
    """A GAME fit whose fixed effect is standardized, through both packages'
    estimators (``photon_tpu/game/estimator.py:70-124``): validation metrics
    within 1e-4 and the fixed effect's original-space means within rtol =
    atol = 1e-3 (the GAME drivers' bounds); the random effect takes none."""
    from photon_tpu.core.optimizers import OptimizerConfig as JaxConfig
    from photon_tpu.core.problem import ProblemConfig as JaxProblemConfig
    from photon_tpu.data.synthetic import make_game_dataset as jax_make
    from photon_tpu.game import coordinate as jax_coord
    from photon_tpu.game.estimator import GameEstimator as JaxEstimator
    from photon_tpu.game.estimator import GameOptimizationConfiguration as JaxConf
    from photon_tpu.game.model import shard_to_batch as jax_shard_to_batch
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import ProblemConfig
    from photon_tpu_torch.data.synthetic import make_game_dataset
    from photon_tpu_torch.game import coordinate
    from photon_tpu_torch.game.estimator import (
        GameEstimator,
        GameOptimizationConfiguration,
    )
    from photon_tpu_torch.game.model import shard_to_batch

    jdata, _ = jax_make(40, 6, 6, 3, seed=2)
    data, _ = make_game_dataset(40, 6, 6, 3, seed=2)
    jnorm = JaxNorm.build("standardization", JaxSummary.from_batch(
        jax_shard_to_batch(jdata.shard("global"), jdata.label), 6), intercept_id=5)
    norm = NormalizationContext.build("standardization", BasicStatisticalSummary.from_batch(
        shard_to_batch(data.shard("global"), data.label, device="cpu"), 6), intercept_id=5)
    ref = JaxEstimator("logistic_regression", jdata, jdata,
                       normalization={"global": jnorm}).fit([JaxConf(coordinates={
        "fixed": jax_coord.FixedEffectCoordinateConfig(
            "global", JaxProblemConfig(optimizer_config=JaxConfig(max_iterations=40))),
        "re0": jax_coord.RandomEffectCoordinateConfig(
            "re0", "re0", JaxProblemConfig(optimizer_config=JaxConfig(max_iterations=20))),
    })])[0]
    est = GameEstimator("logistic_regression", data, data, device="cpu",
                        normalization={"global": norm})
    got = est.fit([GameOptimizationConfiguration(coordinates={
        "fixed": coordinate.FixedEffectCoordinateConfig(
            "global", ProblemConfig(optimizer_config=OptimizerConfig(max_iterations=40))),
        "re0": coordinate.RandomEffectCoordinateConfig(
            "re0", "re0", ProblemConfig(optimizer_config=OptimizerConfig(max_iterations=20))),
    })])[0]
    for name, value in ref.metrics.items():
        assert abs(got.metrics[name] - value) <= 1e-4, (name, got.metrics, ref.metrics)
    np.testing.assert_allclose(
        got.model.coordinates["fixed"].coefficients.means.numpy(),
        np.asarray(ref.model.coordinates["fixed"].coefficients.means), rtol=1e-3, atol=1e-3)
    with pytest.raises(TypeError):
        GameEstimator("logistic_regression", data, device="cpu", normalization=norm)
