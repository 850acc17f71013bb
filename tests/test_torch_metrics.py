"""Port parity for the evaluation metrics (photon_tpu_torch.evaluation.metrics)
against photon_tpu.evaluation.metrics on the CPU, on the same numpy inputs.

precision@k takes the k highest scores; among equal scores the reference's
``lax.top_k`` takes the lower index first, so the port must too.  The draws
are tie-heavy (scores in {0, 1, 2}) and put zero-weight rows, which both
functions mask to -inf, among them.  The results are counts over k, so they
must agree exactly; AUC and RMSE sum in float32 in other orders (rtol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.evaluation import metrics as jax_metrics
from photon_tpu_torch.evaluation import metrics


def _precision_both(scores, labels, weights, k):
    ref = jax_metrics.precision_at_k(
        jnp.asarray(scores), jnp.asarray(labels),
        None if weights is None else jnp.asarray(weights), k=k)
    got = metrics.precision_at_k(
        torch.as_tensor(scores), torch.as_tensor(labels),
        None if weights is None else torch.as_tensor(weights), k=k)
    return float(got), float(ref)


def test_precision_at_k_all_tied_takes_the_lowest_index():
    scores = np.zeros(4, np.float32)
    labels = np.array([1, 0, 0, 0], np.float32)
    got, ref = _precision_both(scores, labels, None, k=1)
    assert ref == 1.0
    assert got == ref


@pytest.mark.parametrize("seed", range(12))
def test_precision_at_k_matches_jax_on_tied_scores(seed):
    rng = np.random.default_rng(seed)
    for _ in range(15):
        n = int(rng.integers(5, 201))
        k = int(rng.integers(1, 20))
        scores = rng.integers(0, 3, size=n).astype(np.float32)
        labels = (rng.random(n) < 0.4).astype(np.float32)
        weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
        weights[rng.random(n) < 0.3] = 0.0  # padding rows: -inf in both
        got, ref = _precision_both(scores, labels, weights, k)
        assert got == ref, (n, k)
        got, ref = _precision_both(scores, labels, None, k)
        assert got == ref, (n, k)


def test_precision_at_k_with_k_past_the_row_count():
    scores = np.array([2, 1, 1, 0, 2], np.float32)
    labels = np.array([0, 1, 0, 1, 1], np.float32)
    weights = np.array([1, 0, 1, 1, 1], np.float32)
    got, ref = _precision_both(scores, labels, weights, k=9)
    assert got == ref


@pytest.mark.parametrize("seed", range(4))
def test_auc_and_rmse_match_jax_on_tied_scores(seed):
    rng = np.random.default_rng(100 + seed)
    n = 300
    scores = rng.integers(0, 5, size=n).astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    weights[rng.random(n) < 0.2] = 0.0
    for name in ("area_under_roc_curve", "rmse"):
        ref = getattr(jax_metrics, name)(
            jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(weights))
        got = getattr(metrics, name)(
            torch.as_tensor(scores), torch.as_tensor(labels), torch.as_tensor(weights))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
