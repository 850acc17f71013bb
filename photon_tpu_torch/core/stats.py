"""One-pass per-feature statistics of a batch, the input of normalization.

Counterpart of ``photon_tpu/core/stats.py``: per-feature mean, variance,
min, max and nonzero count over a batch, and the associative merge that
folds the summaries of several batches.  On a sparse batch the sums are
``index_add_`` scatters and the extremes ``scatter_reduce`` over the
entries, accumulated in float64 on the batch's device and rounded once;
implicit zeros count toward every statistic, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from photon_tpu_torch.data.batch import Batch, DenseBatch

Tensor = torch.Tensor


class BasicStatisticalSummary(NamedTuple):
    """Per-feature moments; every field but ``count`` is ``[d]`` float32."""

    count: Tensor  # scalar: total examples
    mean: Tensor
    variance: Tensor
    min: Tensor
    max: Tensor
    num_nonzeros: Tensor

    @classmethod
    def from_batch(cls, batch: Batch, dim: int) -> "BasicStatisticalSummary":
        return _summarize(batch, dim)

    def merge(self, other: "BasicStatisticalSummary") -> "BasicStatisticalSummary":
        return _merge(self, other)


def _merge(a: BasicStatisticalSummary, b: BasicStatisticalSummary) -> BasicStatisticalSummary:
    """Chan et al.'s parallel mean and variance merge."""
    na, nb = a.count.double(), b.count.double()
    n = na + nb
    n1 = torch.clamp(n, min=1.0)
    wa = torch.where(n > 0, na / n1, 0.0)
    wb = torch.where(n > 0, nb / n1, 0.0)
    mean = wa * a.mean.double() + wb * b.mean.double()
    delta = b.mean.double() - a.mean.double()
    m2 = (a.variance.double() * torch.clamp(na - 1, min=0.0)
          + b.variance.double() * torch.clamp(nb - 1, min=0.0)
          + delta * delta * na * nb / n1)
    var = m2 / torch.clamp(n - 1, min=1.0)
    return BasicStatisticalSummary(
        count=n.float(), mean=mean.float(), variance=var.float(),
        min=torch.minimum(a.min, b.min), max=torch.maximum(a.max, b.max),
        num_nonzeros=a.num_nonzeros + b.num_nonzeros,
    )


def _summarize(batch: Batch, dim: int) -> BasicStatisticalSummary:
    if isinstance(batch, DenseBatch):
        x = batch.x.double()
        n = x.shape[0]
        var = (torch.var(x, dim=0, correction=1) if n > 1
               else torch.zeros(dim, dtype=torch.float64, device=x.device))
        return BasicStatisticalSummary(
            count=torch.tensor(float(n), device=x.device),
            mean=x.mean(dim=0).float(), variance=var.float(),
            min=batch.x.min(dim=0).values, max=batch.x.max(dim=0).values,
            num_nonzeros=(batch.x != 0.0).sum(dim=0).float(),
        )
    ids = batch.ids.reshape(-1).long()
    vals = batch.vals.reshape(-1)
    dev = vals.device
    n = float(batch.ids.shape[0])
    # Pad entries (0, 0.0) add nothing to the sums; they are masked out of
    # the counts and the extremes.
    valid = vals != 0.0
    v64 = vals.double()
    zeros = torch.zeros(dim, dtype=torch.float64, device=dev)
    s1 = zeros.index_add(0, ids, v64)
    s2 = zeros.index_add(0, ids, v64 * v64)
    nnz = zeros.index_add(0, ids, valid.double())
    mean = s1 / n
    var = torch.clamp((s2 - n * mean * mean) / max(n - 1.0, 1.0), min=0.0)
    inf = float("inf")
    mn = torch.full((dim,), inf, device=dev).scatter_reduce(
        0, ids, torch.where(valid, vals, inf), "amin")
    mx = torch.full((dim,), -inf, device=dev).scatter_reduce(
        0, ids, torch.where(valid, vals, -inf), "amax")
    # A feature with fewer nonzeros than rows also takes the value 0.
    implicit_zero = nnz < n
    mn = torch.where(implicit_zero, torch.clamp(mn, max=0.0), mn)
    mx = torch.where(implicit_zero, torch.clamp(mx, min=0.0), mx)
    mn = torch.where(torch.isinf(mn), 0.0, mn)
    mx = torch.where(torch.isinf(mx), 0.0, mx)
    return BasicStatisticalSummary(
        count=torch.tensor(n, device=dev), mean=mean.float(), variance=var.float(),
        min=mn, max=mx, num_nonzeros=nnz.float(),
    )


def summarize(batches, dim: int) -> BasicStatisticalSummary:
    """Summarize an iterable of batches with the associative merge."""
    total = None
    for b in batches:
        s = _summarize(b, dim)
        total = s if total is None else _merge(total, s)
    if total is None:
        raise ValueError("no batches to summarize")
    return total
