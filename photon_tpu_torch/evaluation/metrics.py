"""Metric functions on (scores, labels, weights) tensors.

Counterpart of ``photon_tpu/evaluation/metrics.py`` for the headline
metrics: weighted tie-corrected AUC, RMSE, the mean losses and
precision@k.  Rows with ``weight == 0`` (padding) are absent.  Per-entity
(sharded) metrics wait in ROADMAP.md queue 1, item 4.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from photon_tpu_torch.core.losses import get_loss

Tensor = torch.Tensor


def _weights_or_ones(scores: Tensor, weights: Optional[Tensor]) -> Tensor:
    return torch.ones_like(scores) if weights is None else weights


def area_under_roc_curve(
    scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None
) -> Tensor:
    """Weighted, tie-corrected AUC (Mann-Whitney U):
    ``sum_i w+_i (W-_below(s_i) + W-_tied(s_i) / 2) / (W+ W-)``."""
    w = _weights_or_ones(scores, weights)
    pos_w = w * labels
    neg_w = w * (1.0 - labels)
    order = torch.argsort(scores)
    s_sorted = scores[order]
    csneg = torch.cumsum(neg_w[order], 0)
    lo = torch.searchsorted(s_sorted, s_sorted, side="left")
    hi = torch.searchsorted(s_sorted, s_sorted, side="right")
    csneg_ex = torch.cat([torch.zeros(1, dtype=csneg.dtype, device=csneg.device), csneg])
    below = csneg_ex[lo]
    tied = csneg_ex[hi] - below
    num = torch.sum(pos_w[order] * (below + 0.5 * tied))
    wpos, wneg = torch.sum(pos_w), torch.sum(neg_w)
    ok = (wpos > 0) & (wneg > 0)
    return torch.where(ok, num / torch.where(ok, wpos * wneg, 1.0), 0.5)


def rmse(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    w = _weights_or_ones(scores, weights)
    se = w * (scores - labels) ** 2
    return torch.sqrt(torch.sum(se) / torch.clamp_min(torch.sum(w), 1e-30))


def _mean_loss(loss_name: str) -> Callable:
    loss = get_loss(loss_name)

    def metric(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
        w = _weights_or_ones(scores, weights)
        return torch.sum(w * loss.value(scores, labels)) / torch.clamp_min(
            torch.sum(w), 1e-30
        )

    return metric


logistic_loss_metric = _mean_loss("logistic")
poisson_loss_metric = _mean_loss("poisson")
squared_loss_metric = _mean_loss("squared")
smoothed_hinge_loss_metric = _mean_loss("smoothed_hinge")


def precision_at_k(
    scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None, k: int = 10
) -> Tensor:
    """Fraction of positives among the k highest-scoring (non-padded) rows.
    Among equal scores the lower index comes first, as ``lax.top_k`` takes
    them (``torch.topk`` promises no order among ties)."""
    w = _weights_or_ones(scores, weights)
    masked = torch.where(w > 0, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(masked, descending=True, stable=True).indices
    top_idx = order[: min(k, int(scores.shape[0]))]
    valid = w[top_idx] > 0
    hits = labels[top_idx] * valid
    return torch.sum(hits) / torch.clamp_min(torch.sum(valid), 1)
