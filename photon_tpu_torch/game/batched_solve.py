"""Size-binned batched solves of the random-effect entities.

Counterpart of ``photon_tpu/game/batched_solve.py``:

- **Bin layout** — :func:`bin_layout` merges the power-of-two row-capacity
  buckets into a few padded size bins (``game.data.plan_size_bins`` /
  ``merge_buckets``), one batched solve each.  ``PHOTON_SOLVE_BINNING=off``
  keeps one bin per bucket.
- **Solver route** — :func:`solver_route` gives a bin the ``newton`` route
  (the batched damped Newton of ``core/optimizers/newton.py``, one
  ``[B, d, d]`` Cholesky per iteration) for smooth problems up to
  ``PHOTON_NEWTON_MAX_DIM`` (64), the reference's rule for that route.
  Everything else the reference sends to ``newton_cg`` or ``vmapped``
  (an explicit ``newton_cg`` request, L1, larger dims) raises: those routes
  wait in ROADMAP.md queue 1, item 5, and no other solver is swapped in.
- **The lane objective** — :class:`LaneObjective` is the counterpart of
  ``jax.vmap`` over ``GlmObjective``: value, gradient, Hessian and Hessian
  diagonal of ``B`` independent GLMs, one per entity, over a bin's padded
  rows (sparse ``ids/vals [B, R, k]`` or dense ``x [B, R, d]``; padded rows
  carry weight 0).  Scatter sums accumulate in float64 and round once.

Knobs (environment): ``PHOTON_SOLVE_BINNING`` (``on``/``off``),
``PHOTON_SOLVE_MAX_BINS`` (4), ``PHOTON_SOLVE_BIN_WASTE`` (2.0) and
``PHOTON_NEWTON_MAX_DIM`` (64) — the reference's names and defaults.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from photon_tpu_torch.core.losses import PointwiseLoss
from photon_tpu_torch.core.objective import GlmObjective
from photon_tpu_torch.core.optimizers.base import OptimizerConfig
from photon_tpu_torch.core.optimizers.newton import BatchedResult, newton
from photon_tpu_torch.data.batch import DenseBatch
from photon_tpu_torch.models.glm import Coefficients

Tensor = torch.Tensor


def binning_enabled() -> bool:
    value = os.environ.get("PHOTON_SOLVE_BINNING", "on").strip().lower()
    return value not in ("off", "0", "false")


def max_bins() -> int:
    return int(os.environ.get("PHOTON_SOLVE_MAX_BINS", "4"))


def bin_waste_cap() -> float:
    return float(os.environ.get("PHOTON_SOLVE_BIN_WASTE", "2.0"))


def newton_max_dim() -> int:
    return int(os.environ.get("PHOTON_NEWTON_MAX_DIM", "64"))


def bin_layout(buckets: tuple) -> list:
    """Bucket-index groups of the operative bin policy: the planned size
    bins, or one bucket per bin when binning is off."""
    if not binning_enabled() or len(buckets) <= 1:
        return [[i] for i in range(len(buckets))]
    from photon_tpu_torch.game.data import plan_size_bins

    return plan_size_bins(buckets, max_bins=max_bins(), waste_cap=bin_waste_cap())


def solver_route(problem, solve_dim: int) -> str:
    """``"newton"`` for a smooth problem (no L1) of dim up to
    :func:`newton_max_dim`, as the reference routes it; anything else
    raises, since the reference's ``newton_cg`` and ``vmapped`` routes
    (the batched Newton-CG and the per-lane L-BFGS/OWL-QN/TRON) are not
    ported."""
    optimizer = problem.optimizer.lower()
    smooth = (problem.regularization.l1_weight == 0
              and optimizer not in ("owlqn", "owl-qn"))
    if smooth and optimizer not in ("newton_cg", "newton-cg") \
            and solve_dim <= newton_max_dim():
        return "newton"
    raise NotImplementedError(
        f"entity solves with optimizer {problem.optimizer!r}, "
        f"l1 weight {problem.regularization.l1_weight:g} and dim {solve_dim} "
        "take the reference's newton_cg or vmapped route, which is not ported "
        "yet; it waits in ROADMAP.md queue 1, item 5 (the port solves "
        f"random-effect bins with the batched Newton route: smooth problems of "
        f"dim <= {newton_max_dim()})"
    )


@dataclasses.dataclass(frozen=True)
class LaneObjective:
    """``B`` independent GLM objectives, one per lane: for lane ``b``,
    ``sum_r weight[b, r] * loss(margin[b, r], label[b, r]) + (l2/2)|w_b|^2``
    over a bin batch whose tensors carry a leading lane axis (a
    :class:`SparseBatch` with ``ids/vals [B, R, k]`` or a :class:`DenseBatch`
    with ``x [B, R, d]``; ``label``/``offset``/``weight`` ``[B, R]``)."""

    loss: PointwiseLoss
    l2_weight: float = 0.0

    @classmethod
    def of(cls, objective: GlmObjective) -> "LaneObjective":
        if objective.l1_weight:
            raise NotImplementedError(
                "L1 entity solves need OWL-QN, which waits in ROADMAP.md "
                "queue 1, item 3"
            )
        return cls(objective.loss, objective.l2_weight)

    def margins(self, w: Tensor, batch) -> Tensor:
        """``[B, R]`` margins ``w_b . x_br + offset_br``."""
        if isinstance(batch, DenseBatch):
            return torch.bmm(batch.x, w[:, :, None])[..., 0] + batch.offset
        bsz, rows, k = batch.ids.shape
        wx = torch.gather(w, 1, batch.ids.reshape(bsz, rows * k).long())
        return (wx.view(bsz, rows, k) * batch.vals).sum(-1) + batch.offset

    def line_values(self, w: Tensor, step: Tensor, ts: Tensor, batch) -> Tensor:
        """``[B, T]``: lane ``b``'s objective at ``w_b + ts[b, j] * step_b``
        for each of its ``T`` step sizes, in one pass over the bin.  Each
        point is formed as the solver moves to it and its margins gathered
        as :meth:`margins` gathers them, so the line search holds the very
        point it accepts."""
        wt = w[:, None] + ts[..., None] * step[:, None]
        bsz, n_pts, _ = wt.shape
        if isinstance(batch, DenseBatch):
            z = torch.bmm(wt, batch.x.transpose(1, 2))
        else:
            _, rows, k = batch.ids.shape
            ids = batch.ids.reshape(bsz, 1, rows * k).long().expand(-1, n_pts, -1)
            z = (torch.gather(wt, 2, ids).view(bsz, n_pts, rows, k)
                 * batch.vals[:, None]).sum(-1)
        z = z + batch.offset[:, None]
        v = torch.sum(batch.weight[:, None] * self.loss.value(z, batch.label[:, None]),
                      dim=-1)
        if self.l2_weight != 0.0:
            v = v + 0.5 * self.l2_weight * torch.sum(wt * wt, dim=-1)
        return v

    def _scatter(self, batch, per_row: Tensor, dim: int) -> Tensor:
        """``out[b, f] = sum_r per_row[b, r] * x_brf`` (``[B, d]``): a
        float64 scatter for sparse lanes, a batched matmul for dense."""
        if isinstance(batch, DenseBatch):
            return torch.bmm(per_row[:, None, :], batch.x)[:, 0]
        bsz = per_row.shape[0]
        terms = (per_row[..., None] * batch.vals).reshape(bsz, -1)
        out = torch.zeros(bsz, dim, dtype=torch.float64, device=per_row.device)
        out.scatter_add_(1, batch.ids.reshape(bsz, -1).long(), terms.double())
        return out.float()

    def value_and_grad(self, w: Tensor, batch) -> tuple[Tensor, Tensor]:
        z = self.margins(w, batch)
        v = torch.sum(batch.weight * self.loss.value(z, batch.label), dim=-1)
        g = self._scatter(batch, batch.weight * self.loss.d1(z, batch.label), w.shape[1])
        if self.l2_weight != 0.0:
            v = v + 0.5 * self.l2_weight * torch.sum(w * w, dim=-1)
            g = g + self.l2_weight * w
        return v, g

    def _curvature(self, w: Tensor, batch) -> Tensor:
        return batch.weight * self.loss.d2(self.margins(w, batch), batch.label)

    def hessian_matrix(self, w: Tensor, batch) -> Tensor:
        """``[B, d, d]``: ``X_b^T diag(weight * d2) X_b + l2 I`` per lane."""
        d2w = self._curvature(w, batch)
        bsz, d = w.shape
        if isinstance(batch, DenseBatch):
            h = torch.bmm(batch.x.transpose(1, 2), d2w[..., None] * batch.x)
        else:
            vals = batch.vals
            terms = d2w[..., None, None] * vals[..., :, None] * vals[..., None, :]
            ids = batch.ids.long()
            flat = ids[..., :, None] * d + ids[..., None, :]
            out = torch.zeros(bsz, d * d, dtype=torch.float64, device=w.device)
            out.scatter_add_(1, flat.reshape(bsz, -1), terms.reshape(bsz, -1).double())
            h = out.float().view(bsz, d, d)
        eye = torch.eye(d, dtype=w.dtype, device=w.device)
        return h + self.l2_weight * eye

    def hessian_diagonal(self, w: Tensor, batch) -> Tensor:
        """``[B, d]``: ``sum_r weight * d2 * x_brf^2 + l2`` per lane."""
        d2w = self._curvature(w, batch)
        if isinstance(batch, DenseBatch):
            diag = torch.bmm(d2w[:, None, :], batch.x * batch.x)[:, 0]
        else:
            diag = self._scatter(batch._replace(vals=batch.vals * batch.vals), d2w,
                                 w.shape[1])
        return diag + self.l2_weight


def compute_variances(objective: LaneObjective, kind: str, w: Tensor,
                      batch) -> Optional[Tensor]:
    """Per-lane variances at the optimum, the reference's
    ``_compute_variances`` per entity: SIMPLE = 1 / diag(H); FULL =
    diag(H^-1) through a Cholesky of ``H + 1e-9 I``."""
    if kind == "none":
        return None
    if kind == "simple":
        return 1.0 / torch.clamp_min(objective.hessian_diagonal(w, batch), 1e-12)
    if kind != "full":
        raise ValueError(f"unknown variance computation {kind!r}")
    h = objective.hessian_matrix(w, batch)
    d = h.shape[-1]
    eye = torch.eye(d, dtype=h.dtype, device=h.device)
    chol, _ = torch.linalg.cholesky_ex(h + 1e-9 * eye)
    inv = torch.cholesky_solve(eye.expand_as(h).contiguous(), chol)
    return torch.clamp_min(torch.diagonal(inv, dim1=-2, dim2=-1), 0.0)


def run_newton_fit(objective: LaneObjective, batch, w0: Tensor, *,
                   cfg: OptimizerConfig, variance: str
                   ) -> tuple[Coefficients, BatchedResult]:
    """One bin's batched damped-Newton fit (the reference's
    ``_run_newton_fit`` under ``vmap``): ``w0`` and the result's means are
    ``[B, d]``; variances as :func:`compute_variances`."""
    result = newton(
        lambda w: objective.value_and_grad(w, batch), w0, cfg,
        hess=lambda w: objective.hessian_matrix(w, batch),
        values=lambda w, step, ts: objective.line_values(w, step, ts, batch),
    )
    return Coefficients(
        means=result.w,
        variances=compute_variances(objective, variance, result.w, batch),
    ), result


def record_bin_telemetry(telemetry, coordinate: str, bin_stats: list,
                         routes: list) -> None:
    """The reference's bin-occupancy gauges; a no-op sink here: the port's
    telemetry registry waits in ROADMAP.md queue 1, item 6.  The same
    numbers reach ``training_summary.json`` through the coordinate's
    per-bin solve records."""
    del telemetry, coordinate, bin_stats, routes
