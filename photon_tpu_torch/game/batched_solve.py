"""Size-binned batched solves of the random-effect entities.

Counterpart of ``photon_tpu/game/batched_solve.py``:

- **Bin layout** — :func:`bin_layout` merges the power-of-two row-capacity
  buckets into a few padded size bins (``game.data.plan_size_bins`` /
  ``merge_buckets``), one batched solve each.  ``PHOTON_SOLVE_BINNING=off``
  keeps one bin per bucket.
- **Solver route** — :func:`solver_route` is the reference's rule: smooth
  bins (no L1) of dim up to ``PHOTON_NEWTON_MAX_DIM`` (64) take ``newton``
  (the batched damped Newton of ``core/optimizers/newton.py``, one
  ``[B, d, d]`` Cholesky per iteration); smooth bins past it, up to
  ``PHOTON_NEWTON_CG_MAX_DIM`` (1024), and every bin of an explicit
  ``newton_cg`` problem take ``newton_cg`` (the matrix-free
  ``newton_cg_lanes``: Hessian-vector products through
  :meth:`LaneObjective.hvp_operator`, a Jacobi preconditioner, no
  ``[B, d, d]`` block); everything else — L1 and elastic-net bins, dims
  past the Newton-CG cap, ``PHOTON_SOLVE_NEWTON=off`` — takes ``vmapped``,
  the problem's own optimizer batched over lanes (``lbfgs_lanes``,
  ``owlqn_lanes``, ``tron_lanes``).  Row-split placement routes
  ``row_split``, which needs the device mesh of ROADMAP.md queue 1,
  item 10, and raises there.
- **The lane objective** — :class:`LaneObjective` is the counterpart of
  ``jax.vmap`` over ``GlmObjective``: value, gradient, Hessian, Hessian
  diagonal and Hessian-vector products of ``B`` independent GLMs, one per
  entity, over a bin's padded rows (sparse ``ids/vals [B, R, k]`` or dense
  ``x [B, R, d]``; padded rows carry weight 0).  Scatter sums accumulate in
  float64 and round once.
- **Telemetry** — :func:`record_bin_telemetry` exports the reference's
  ``solves.*`` counters and gauges, so a bin that took an unexpected route
  shows in the run report.

Knobs (environment): ``PHOTON_SOLVE_BINNING`` (``on``/``off``),
``PHOTON_SOLVE_MAX_BINS`` (4), ``PHOTON_SOLVE_BIN_WASTE`` (2.0),
``PHOTON_SOLVE_NEWTON`` (``on``/``off``), ``PHOTON_NEWTON_MAX_DIM`` (64),
``PHOTON_SOLVE_NEWTON_CG`` (``on``/``off``) and
``PHOTON_NEWTON_CG_MAX_DIM`` (1024) — the reference's names and defaults.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from photon_tpu_torch.core.losses import PointwiseLoss
from photon_tpu_torch.core.objective import GlmObjective
from photon_tpu_torch.core.optimizers.base import OptimizerConfig
from photon_tpu_torch.core.optimizers.lanes import BatchedResult
from photon_tpu_torch.core.optimizers.lbfgs import lbfgs_lanes
from photon_tpu_torch.core.optimizers.newton import newton
from photon_tpu_torch.core.optimizers.newton_cg import newton_cg_lanes
from photon_tpu_torch.core.optimizers.owlqn import owlqn_lanes
from photon_tpu_torch.core.optimizers.tron import tron_lanes
from photon_tpu_torch.core.problem import _optimizer_name
from photon_tpu_torch.data.batch import DenseBatch
from photon_tpu_torch.models.glm import Coefficients

Tensor = torch.Tensor


def _switch(name: str) -> bool:
    return os.environ.get(name, "on").strip().lower() not in ("off", "0", "false")


def binning_enabled() -> bool:
    return _switch("PHOTON_SOLVE_BINNING")


def newton_enabled() -> bool:
    return _switch("PHOTON_SOLVE_NEWTON")


def newton_cg_enabled() -> bool:
    return _switch("PHOTON_SOLVE_NEWTON_CG")


def max_bins() -> int:
    return int(os.environ.get("PHOTON_SOLVE_MAX_BINS", "4"))


def bin_waste_cap() -> float:
    return float(os.environ.get("PHOTON_SOLVE_BIN_WASTE", "2.0"))


def newton_max_dim() -> int:
    return int(os.environ.get("PHOTON_NEWTON_MAX_DIM", "64"))


def newton_cg_max_dim() -> int:
    return int(os.environ.get("PHOTON_NEWTON_CG_MAX_DIM", "1024"))


def bin_layout(buckets: tuple) -> list:
    """Bucket-index groups of the operative bin policy: the planned size
    bins, or one bucket per bin when binning is off."""
    if not binning_enabled() or len(buckets) <= 1:
        return [[i] for i in range(len(buckets))]
    from photon_tpu_torch.game.data import plan_size_bins

    return plan_size_bins(buckets, max_bins=max_bins(), waste_cap=bin_waste_cap())


def solver_route(problem, solve_dim: int, row_split: bool = False) -> str:
    """Which solver a bin runs, the reference's rule: ``row_split`` under
    row-split placement; ``newton_cg`` for an explicit Newton-CG problem at
    any dim (the route must not rename the user's solver); ``newton`` for a
    smooth problem of dim up to :func:`newton_max_dim`; ``newton_cg`` for a
    smooth one past it up to :func:`newton_cg_max_dim`; else ``vmapped``."""
    if row_split:
        return "row_split"
    optimizer = _optimizer_name(problem.optimizer)
    if optimizer == "newton_cg":
        return "newton_cg"
    smooth = problem.regularization.l1_weight == 0 and optimizer != "owlqn"
    if smooth and newton_enabled() and solve_dim <= newton_max_dim():
        return "newton"
    if (smooth and newton_cg_enabled()
            and newton_max_dim() < solve_dim <= newton_cg_max_dim()):
        return "newton_cg"
    return "vmapped"


@dataclasses.dataclass(frozen=True)
class LaneObjective:
    """``B`` independent GLM objectives, one per lane: for lane ``b``,
    ``sum_r weight[b, r] * loss(margin[b, r], label[b, r]) + (l2/2)|w_b|^2``
    over a bin batch whose tensors carry a leading lane axis (a
    :class:`SparseBatch` with ``ids/vals [B, R, k]`` or a :class:`DenseBatch`
    with ``x [B, R, d]``; ``label``/``offset``/``weight`` ``[B, R]``).

    The value methods take the dtype of the values (margins, losses and
    their sums), which the route decides: the Newton routes keep the
    reference's float32 (they polish past its floor, and float64 values
    cost their lane evaluations up to ~1.4x on the card, as
    ``chip_smoke.py`` times them in both); the
    ``vmapped`` route passes float64 (:func:`run_lane_fit`): its Armijo and
    stopping tests compare these values, and in float32 a lane's progress
    near its optimum rounds to an ulp, so where an L-BFGS, OWL-QN or TRON
    lane stops would turn on the last bit of the arithmetic (the card's and
    the host's differ), ~1e-2 from its optimum on heavy lanes.  Gradients
    and Hessian products are float32, from the same margins (their sparse
    scatters accumulate in float64)."""

    loss: PointwiseLoss
    l2_weight: float = 0.0
    # The L1 weight goes to the optimizer (OWL-QN), as the reference's
    # ``_run_fit`` passes ``objective.l1_weight``: it never enters the smooth
    # value.
    l1_weight: float = 0.0
    @classmethod
    def of(cls, objective: GlmObjective) -> "LaneObjective":
        return cls(objective.loss, objective.l2_weight, objective.l1_weight)

    def margins(self, w: Tensor, batch) -> Tensor:
        """``[B, R]`` margins ``w_b . x_br + offset_br``."""
        return self._xv(w, batch) + batch.offset

    def _xv(self, w: Tensor, batch) -> Tensor:
        """``[B, R]`` products ``w_b . x_br``."""
        if isinstance(batch, DenseBatch):
            return torch.bmm(batch.x.to(w.dtype), w[:, :, None])[..., 0]
        bsz, rows, k = batch.ids.shape
        wx = torch.gather(w, 1, batch.ids.reshape(bsz, rows * k).long())
        return (wx.view(bsz, rows, k) * batch.vals).sum(-1)

    def line_values(self, w: Tensor, step: Tensor, ts: Tensor, batch,
                    dtype: torch.dtype = torch.float32) -> Tensor:
        """``[B, T]``: lane ``b``'s objective at ``w_b + ts[b, j] * step_b``
        for each of its ``T`` step sizes, in one pass over the bin.  Each
        point is formed as the solver moves to it and its margins gathered
        as :meth:`margins` gathers them, so the line search holds the very
        point it accepts."""
        return self.point_values(w[:, None] + ts[..., None] * step[:, None], batch, dtype)

    def point_values(self, wt: Tensor, batch,
                     dtype: torch.dtype = torch.float32) -> Tensor:
        """``[B, T]`` in ``dtype``: lane ``b``'s (smooth) objective at each
        of its ``T`` points ``wt[b, j]`` (``wt`` ``[B, T, d]``), in one pass
        over the bin (OWL-QN's orthant-projected trial points are not on a
        line)."""
        return self._values(self._point_margins(wt, batch, dtype), wt, batch)

    def _point_margins(self, wt: Tensor, batch, dtype: torch.dtype) -> Tensor:
        """``[B, T, R]`` margins of each lane's ``T`` points in ``dtype`` (the
        float32 operands promote inside each kernel)."""
        wt = wt.to(dtype)
        bsz, n_pts, _ = wt.shape
        if isinstance(batch, DenseBatch):
            z = torch.bmm(wt, batch.x.to(dtype).transpose(1, 2))
        else:
            _, rows, k = batch.ids.shape
            ids = batch.ids.reshape(bsz, 1, rows * k).long().expand(-1, n_pts, -1)
            z = (torch.gather(wt, 2, ids).view(bsz, n_pts, rows, k)
                 * batch.vals[:, None]).sum(-1)
        return z + batch.offset[:, None]

    def _values(self, z: Tensor, wt: Tensor, batch) -> Tensor:
        """``[B, T]`` objectives from :meth:`_point_margins`, in its dtype."""
        v = torch.sum(batch.weight[:, None] * self.loss.value(z, batch.label[:, None]),
                      dim=-1)
        if self.l2_weight != 0.0:
            wt = wt.to(z.dtype)
            v = v + 0.5 * self.l2_weight * torch.sum(wt * wt, dim=-1)
        return v

    def _scatter(self, batch, per_row: Tensor, dim: int,
                 square: bool = False) -> Tensor:
        """``out[b, f] = sum_r per_row[b, r] * x_brf`` (``x_brf^2`` with
        ``square``; ``[B, d]``): a float64 scatter for sparse lanes, a
        batched matmul for dense, in the reference's order of operations (a
        dense square in the storage dtype, a sparse one in float32 after
        the coefficient)."""
        if isinstance(batch, DenseBatch):
            x = batch.x * batch.x if square else batch.x
            return torch.bmm(per_row[:, None, :], x.to(per_row.dtype))[:, 0]
        bsz = per_row.shape[0]
        terms = per_row[..., None] * batch.vals
        if square:
            terms = terms * batch.vals
        terms = terms.reshape(bsz, -1)
        out = torch.zeros(bsz, dim, dtype=torch.float64, device=per_row.device)
        out.scatter_add_(1, batch.ids.reshape(bsz, -1).long(), terms.double())
        return out.float()

    def value_and_grad(self, w: Tensor, batch,
                       dtype: torch.dtype = torch.float32) -> tuple[Tensor, Tensor]:
        """``([B] in dtype, [B, d])``: the values and gradients at ``w``, both
        from one pass of margins in ``dtype``."""
        z = self._point_margins(w[:, None], batch, dtype)
        d1 = self.loss.d1(z[:, 0], batch.label).float()
        g = self._scatter(batch, batch.weight * d1, w.shape[1])
        if self.l2_weight != 0.0:
            g = g + self.l2_weight * w
        return self._values(z, w[:, None], batch)[:, 0], g

    def _curvature(self, w: Tensor, batch) -> Tensor:
        return batch.weight * self.loss.d2(self.margins(w, batch), batch.label)

    def hvp_operator(self, w: Tensor, batch):
        """``v [B, d] -> H(w) v`` per lane, the reference's ``hvp_operator``
        under ``vmap``: the per-row curvature ``weight * d2`` once here,
        then each product is two lane matvecs ``X^T (D (X v)) + l2 v`` (the
        sparse scatter in float64), never a ``[B, d, d]`` block."""
        d2w = self._curvature(w, batch)
        dim = w.shape[1]

        def hv(v: Tensor) -> Tensor:
            out = self._scatter(batch, d2w * self._xv(v, batch), dim)
            return out + self.l2_weight * v if self.l2_weight != 0.0 else out

        return hv

    def hessian_matrix(self, w: Tensor, batch) -> Tensor:
        """``[B, d, d]``: ``X_b^T diag(weight * d2) X_b + l2 I`` per lane."""
        d2w = self._curvature(w, batch)
        bsz, d = w.shape
        if isinstance(batch, DenseBatch):
            h = torch.bmm(batch.x.to(d2w.dtype).transpose(1, 2), d2w[..., None] * batch.x)
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
        return self._scatter(batch, d2w, w.shape[1], square=True) + self.l2_weight


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
    return _coefficients(objective, variance, result, batch), result


def run_newton_cg_fit(objective: LaneObjective, batch, w0: Tensor, *,
                      cfg: OptimizerConfig, variance: str
                      ) -> tuple[Coefficients, BatchedResult]:
    """One bin's matrix-free Newton-CG fit (the reference's
    ``_run_newton_cg_fit`` under ``vmap``): the curvature through
    :meth:`LaneObjective.hvp_operator`, the Jacobi diagonal from
    :meth:`LaneObjective.hessian_diagonal`, the variances as every route's."""
    result = newton_cg_lanes(
        lambda w: objective.value_and_grad(w, batch), w0, cfg,
        hvp_at=lambda w: objective.hvp_operator(w, batch),
        diag=lambda w: objective.hessian_diagonal(w, batch),
        values=lambda w, step, ts: objective.line_values(w, step, ts, batch),
    )
    return _coefficients(objective, variance, result, batch), result


def run_lane_fit(objective: LaneObjective, batch, w0: Tensor, *, optimizer: str,
                 cfg: OptimizerConfig, variance: str
                 ) -> tuple[Coefficients, BatchedResult]:
    """One bin's ``vmapped`` fit: the problem's own optimizer batched over
    lanes, the reference's ``_run_fit`` under ``vmap`` — OWL-QN (the l1
    weight goes to the optimizer), TRON (curvature through
    :meth:`LaneObjective.hvp_operator`), Newton-CG, else L-BFGS; the
    values in float64 (see :class:`LaneObjective`)."""
    optimizer = _optimizer_name(optimizer)
    if optimizer == "newton_cg":
        return run_newton_cg_fit(objective, batch, w0, cfg=cfg, variance=variance)
    f64 = torch.float64

    def fun(w):
        return objective.value_and_grad(w, batch, f64)

    def values(w, step, ts):
        return objective.line_values(w, step, ts, batch, f64)

    if optimizer == "owlqn":
        result = owlqn_lanes(fun, w0, cfg, l1_weight=objective.l1_weight,
                             point_values=lambda pts: objective.point_values(pts, batch,
                                                                             f64))
    elif optimizer == "tron":
        result = tron_lanes(fun, w0, cfg,
                            hvp_at=lambda w: objective.hvp_operator(w, batch))
    else:
        result = lbfgs_lanes(fun, w0, cfg, values=values)
    return _coefficients(objective, variance, result, batch), result


def _coefficients(objective: LaneObjective, variance: str, result: BatchedResult,
                  batch) -> Coefficients:
    return Coefficients(
        means=result.w,
        variances=compute_variances(objective, variance, result.w, batch),
    )


def record_bin_telemetry(telemetry, coordinate: str, bin_stats: list,
                         routes: list) -> None:
    """The bin layout's padding economics and routes, the reference's
    gauges: ``solves.bin_occupancy`` (live entities a bin),
    ``solves.bin_entities_padded`` (padding slots), ``solves.padded_fraction``
    (padded share of the bin's entity x row cells), labelled by coordinate,
    bin, row capacity and route; and the ``solves.routed{route}`` counter
    of the live entities each route received, so a bin that went by an
    unexpected route shows in the run report."""
    for b, (stats, route) in enumerate(zip(bin_stats, routes)):
        labels = dict(coordinate=coordinate, bin=str(b),
                      capacity=str(stats["capacity"]), route=route)
        telemetry.counter("solves.routed", coordinate=coordinate,
                          route=route).inc(stats["live_entities"])
        telemetry.gauge("solves.bin_occupancy", **labels).set(stats["live_entities"])
        telemetry.gauge("solves.bin_entities_padded", **labels).set(
            stats["total_entities"] - stats["live_entities"])
        cells = stats["total_entities"] * stats["capacity"]
        telemetry.gauge("solves.padded_fraction", **labels).set(
            0.0 if cells == 0 else 1.0 - stats["live_rows"] / cells)
