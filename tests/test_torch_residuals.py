"""Port parity of the residual engine and of coordinate descent over it.

Held as the reference's own engine tests hold it
(``tests/test_residuals.py``): offsets against the float64 host path within
1e-4 (:68), the Neumaier total against a signal buried under cancelling
rows within 1e-6 (:117-132), the device and host modes of a whole GAME fit
within 1e-4 on every validation metric (:260-265), a non-finite row
rejected with the previous row kept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.game.residuals import ResidualEngine as JaxEngine
from photon_tpu_torch.core.objective import RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.data.synthetic import make_game_dataset
from photon_tpu_torch.game import descent as tdescent
from photon_tpu_torch.game.coordinate import (
    FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.data import split_game_dataset
from photon_tpu_torch.game.estimator import GameEstimator, GameOptimizationConfiguration
from photon_tpu_torch.game.residuals import (
    HostResiduals,
    ResidualEngine,
    ValidationEngine,
    neumaier_rows,
    resolve_residual_mode,
    resolve_validation_mode,
)


def _random_scores(n: int, n_coords: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 10.0 ** (i - 1)).astype(np.float32)
            for i in range(n_coords)]


@pytest.mark.parametrize("seed", [3, 4])
def test_engine_offsets_match_host_and_reference(seed):
    n, names = 257, ["a", "b", "c", "d"]
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(n).astype(np.float32)
    scores = _random_scores(n, len(names), seed=seed + 1)
    engine = ResidualEngine(base, names, "cpu")
    host = HostResiduals(base)
    ref = JaxEngine(base, names=names)
    for name, s in zip(names, scores):
        engine.update(name, torch.as_tensor(s))
        host.update(name, s)
        ref.update(name, jnp.asarray(s))
    for name in names:
        got = engine.offsets_for(name).numpy()
        np.testing.assert_allclose(got, host.offsets_for(name), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, np.asarray(ref.offsets_for(name)), rtol=0,
                                   atol=1e-6)


def test_compensated_sum_beats_naive_f32():
    n = 128
    big = np.full(n, 3e7, np.float32)
    small = np.full(n, 0.5, np.float32)
    engine = ResidualEngine(np.zeros(n, np.float32), ["big", "neg", "small", "probe"],
                            "cpu")
    engine.update("big", big)
    engine.update("neg", -big)
    engine.update("small", small)
    np.testing.assert_allclose(engine.offsets_for("probe").numpy(), small, rtol=0,
                               atol=1e-6)
    # Rows in the order that loses the signal to plain float32 sums.
    rows = torch.as_tensor(np.stack([small, big, -big]))
    np.testing.assert_array_equal((rows[0] + rows[1] + rows[2]).numpy(), 0.0)
    total, comp = neumaier_rows(rows)
    np.testing.assert_allclose((total + comp).numpy(), small, rtol=0, atol=1e-6)


def test_engine_partial_updates_exclude_own_row_and_validate():
    n = 64
    engine = ResidualEngine(np.zeros(n, np.float32), ["x", "y"], "cpu")
    sx = np.full(n, 2.0, np.float32)
    engine.update("x", sx)
    np.testing.assert_allclose(engine.offsets_for("y").numpy(), sx)
    np.testing.assert_allclose(engine.offsets_for("x").numpy(), np.zeros(n))
    with pytest.raises(ValueError, match="shape"):
        engine.update("x", np.zeros(n + 1, np.float32))
    with pytest.raises(ValueError, match="duplicate"):
        ResidualEngine(np.zeros(8, np.float32), ["a", "a"], "cpu")
    with pytest.raises(ValueError, match="at least one"):
        ValidationEngine(np.zeros(8, np.float32), [], "cpu")


@pytest.mark.parametrize("engine_cls", [ResidualEngine, ValidationEngine, HostResiduals])
def test_nonfinite_row_is_rejected(engine_cls):
    n = 32
    base = np.linspace(-1, 1, n).astype(np.float32)
    engine = engine_cls(base, ["f", "r"], "cpu")
    good = np.arange(n, dtype=np.float32)
    engine.update("f", good)
    bad = good.copy()
    bad[5] = np.nan
    engine.update("f", bad)
    engine.update("r", np.ones(n, np.float32))
    assert engine.poll_quarantined() == ["f"]
    assert engine.poll_quarantined() == []
    if engine_cls is ValidationEngine:
        np.testing.assert_allclose(engine.composite().numpy(), base + good + 1.0,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(np.asarray(engine.offsets_for("r")), base + good,
                                   atol=1e-6)
    assert engine.nonfinite_rows == {"f": 1}


def test_mode_resolution(monkeypatch):
    monkeypatch.delenv("PHOTON_RESIDUALS", raising=False)
    monkeypatch.delenv("PHOTON_VALIDATION", raising=False)
    assert resolve_residual_mode() == "device"
    assert resolve_residual_mode("host") == "host"
    monkeypatch.setenv("PHOTON_RESIDUALS", "host")
    assert resolve_residual_mode() == "host"
    assert resolve_validation_mode(None, "host") == "host"
    assert resolve_validation_mode("device", "host") == "device"
    with pytest.raises(ValueError):
        resolve_residual_mode("sideways")


def _fit(residuals: str, validation=None, seed=3, checkpoint_fn=None):
    data, _ = make_game_dataset(60, 8, 6, 4, seed=seed, n_random_coords=2)
    train, val = split_game_dataset(data, 0.25, seed=1)
    problem = ProblemConfig(regularization=RegularizationContext("l2", 1.0),
                            optimizer_config=OptimizerConfig(max_iterations=30))
    config = GameOptimizationConfiguration(coordinates={
        "fixed": FixedEffectCoordinateConfig("global", problem),
        "re0": RandomEffectCoordinateConfig("re0", "re0", problem),
        "re1": RandomEffectCoordinateConfig("re1", "re1", problem),
    }, descent_iterations=2)
    est = GameEstimator("logistic_regression", train, val, device="cpu",
                        residual_mode=residuals, validation_mode=validation)
    return est.fit([config], checkpoint_fn=checkpoint_fn)[0]


def test_game_fit_device_matches_host_within_1e4():
    host = _fit("host")
    device = _fit("device")
    assert device.metrics and set(device.metrics) == set(host.metrics)
    for name, ref in host.metrics.items():
        assert abs(device.metrics[name] - ref) < 1e-4, (name, device.metrics[name], ref)
    for h, d in zip(host.descent.history, device.descent.history):
        assert d["residual_updates"] == h["residual_updates"] == 3
        assert d["host_syncs"] == {"stats": 1, "validation": 1}
        assert h["host_syncs"] == {"stats": 1, "validation": 0}
    mixed = _fit("device", validation="host")
    for name, ref in device.metrics.items():
        assert abs(mixed.metrics[name] - ref) < 1e-4


@pytest.mark.parametrize("bad_call", [1, 2])
def test_descent_rolls_back_a_rejected_score_row(monkeypatch, bad_call):
    """A coordinate whose fresh scores are non-finite goes back to its
    previous iterate, or leaves the composite on its first pass."""
    from photon_tpu_torch.game.coordinate import RandomEffectCoordinate

    real = RandomEffectCoordinate.score_device
    seen = []

    def flaky(self, model):
        out = real(self, model)
        if self.config.entity_column == "re1":
            seen.append(model)
            if len(seen) == bad_call:
                out = torch.full_like(out, float("inf"))
        return out

    monkeypatch.setattr(RandomEffectCoordinate, "score_device", flaky)
    passes = []
    result = _fit("device", checkpoint_fn=lambda it, model: passes.append(model))
    first, last = passes
    if bad_call == 1:
        assert "re1" not in first.coordinates
        assert last.coordinates["re1"] is seen[1]
    else:
        assert first.coordinates["re1"] is seen[0]
        assert seen[2] is seen[0]  # the rollback re-scores the previous iterate
        assert last.coordinates["re1"] is seen[0]
    assert result.descent.last_model.coordinates == last.coordinates


def test_quarantine_budget_is_enforced(monkeypatch):
    from photon_tpu_torch.game.coordinate import RandomEffectCoordinate

    def poisoned(self, model):
        return torch.full((self.data.num_examples,), float("nan"))

    monkeypatch.setattr(RandomEffectCoordinate, "score_device", poisoned)
    data, _ = make_game_dataset(20, 5, 4, 3, seed=2)
    problem = ProblemConfig(optimizer_config=OptimizerConfig(max_iterations=5))
    config = GameOptimizationConfiguration(coordinates={
        "fixed": FixedEffectCoordinateConfig("global", problem),
        "re0": RandomEffectCoordinateConfig("re0", "re0", problem),
    }, descent_iterations=3)
    est = GameEstimator("logistic_regression", data, device="cpu")
    with pytest.raises(tdescent.QuarantineBudgetError):
        est.fit([config], max_quarantined=1)
    result = est.fit([config], max_quarantined=None)[0]
    assert "re0" not in result.model.coordinates
