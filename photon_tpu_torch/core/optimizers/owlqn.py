"""OWL-QN, orthant-wise limited-memory quasi-Newton, for L1 and the elastic
net, as a Python loop over device tensors.

Counterpart of ``photon_tpu/core/optimizers/owlqn.py`` (Andrew & Gao 2007):
the pseudo-gradient stands in for the gradient of the L1 term, the L-BFGS
two-loop direction (built from smooth-gradient (s, y) pairs, the port's
``lbfgs._History``) is projected onto the pseudo-gradient's descent
orthant, and every line-search trial point is orthant-projected, so
coordinates that cross zero land exactly on zero.  ``fun`` returns the
smooth value and gradient (the L2 of an elastic net included); the L1 term
lives here.  History and tolerances are on the total objective (smooth plus
L1), and the loop ends in the reference's two-step polish.

Host syncs: one per objective evaluation, as in the port's L-BFGS.  Each
line-search trial reads one packed vector — the trial's total value, the
projected Armijo verdict, ``s.y``, ``y.y`` and the trial's pseudo-gradient
norm — and the host takes every decision from it.

:func:`owlqn_lanes` is the same solver batched over lanes, the reference's
``owlqn`` under ``jax.vmap`` (GAME's L1 and elastic-net entity solves):
every update masked per lane, trial points evaluated as explicit
orthant-projected points, one host read a block of step sizes.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from photon_tpu_torch.core.optimizers.base import (
    ConvergenceReason,
    OptimizerConfig,
    OptimizerResult,
    check_convergence,
    reason_is_converged,
)
from photon_tpu_torch.core.optimizers.lanes import (
    BatchedResult,
    LaneState,
    armijo_lanes,
    dot,
    norm,
)
from photon_tpu_torch.core.optimizers.lbfgs import (
    _ARMIJO_C1,
    _PAIR_EPS,
    LaneHistory,
    _History,
)

Tensor = torch.Tensor


def _pseudo_gradient(w: Tensor, g: Tensor, l1: float) -> Tensor:
    """Andrew & Gao eq. (4): the subgradient of least norm."""
    left, right = g - l1, g + l1
    at_zero = torch.where(right < 0.0, right,
                          torch.where(left > 0.0, left, torch.zeros_like(g)))
    return torch.where(w > 0.0, right, torch.where(w < 0.0, left, at_zero))


def _project_direction(d: Tensor, pg: Tensor) -> Tensor:
    """Zero the components of ``d`` that do not descend along ``-pg``."""
    return torch.where(d * pg < 0.0, d, torch.zeros_like(d))


def _orthant_project(w_new: Tensor, xi: Tensor) -> Tensor:
    """Clamp the coordinates that left the orthant ``xi`` to zero."""
    return torch.where(w_new * xi > 0.0, w_new, torch.zeros_like(w_new))


def _orthant(w: Tensor, pg: Tensor) -> Tensor:
    """``sign(w)``, or ``sign(-pg)`` where ``w`` is zero."""
    return torch.where(w != 0.0, torch.sign(w), -torch.sign(pg))


def owlqn(
    fun: Callable[[Tensor], tuple[Tensor, Tensor]],
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    l1_weight: float = 0.0,
) -> OptimizerResult:
    """Minimize ``fun(w) + l1_weight * ||w||_1`` from ``w0``; ``fun``
    returns the smooth (value, gradient) tensors.  With ``l1_weight == 0``
    this is L-BFGS with a line search that never projects."""
    f32 = np.float32
    l1 = float(f32(l1_weight))
    n_hist = config.max_iterations + 1
    hv = np.zeros(n_hist, np.float32)
    hg = np.zeros(n_hist, np.float32)
    hvalid = np.zeros(n_hist, bool)

    def total(w: Tensor, f_smooth: Tensor) -> Tensor:
        return f_smooth + l1 * torch.sum(torch.abs(w))

    w = w0
    f, g = fun(w)
    pg = _pseudo_gradient(w, g, l1)
    # host-sync: the solver's one read a decision (counted in host_reads)
    f_h, gnorm0 = torch.stack([total(w, f), torch.linalg.vector_norm(pg)]).tolist()
    reads = evaluations = 1
    gnorm_h = gnorm0
    hv[0], hg[0], hvalid[0] = f_h, gnorm0, True
    hist = _History(config.history_length, w0)
    active = gnorm0 != 0.0
    reason = (
        ConvergenceReason.NOT_CONVERGED if active
        else ConvergenceReason.GRADIENT_TOLERANCE
    )
    it = 0
    while active:
        dvec = _project_direction(hist.direction(pg), pg)
        # Steepest descent on the pseudo-gradient when the projected
        # direction does not descend.
        dvec = torch.where(torch.dot(pg, dvec) >= 0.0, -pg, dvec)
        xi = _orthant(w, pg)
        f_total = total(w, f)
        t = 1.0 if hist.num_pairs else float(
            f32(1.0) / np.maximum(f32(gnorm_h), f32(1.0))
        )

        def trial(t: float):
            w_t = _orthant_project(w + t * dvec, xi)
            f_t, g_t = fun(w_t)
            tot_t = total(w_t, f_t)
            # Armijo on the total objective along the projected step.
            ok = ((tot_t <= f_total + _ARMIJO_C1 * torch.dot(pg, w_t - w))
                  & torch.isfinite(f_t))
            s, y = w_t - w, g_t - g
            pg_t = _pseudo_gradient(w_t, g_t, l1)
            packed = torch.stack([  # host-sync: the solver's read
                tot_t, ok.to(f_t.dtype), torch.dot(s, y), torch.dot(y, y),
                torch.linalg.vector_norm(pg_t),
            ]).tolist()
            return w_t, f_t, g_t, pg_t, s, y, packed

        w_t, f_t, g_t, pg_t, s, y, packed = trial(t)
        halvings = 0
        while not packed[1] and halvings < config.max_line_search:
            t *= 0.5
            w_t, f_t, g_t, pg_t, s, y, packed = trial(t)
            halvings += 1
        reads += 1 + halvings
        evaluations += 1 + halvings
        f_new, ok, sy, yy, gnorm_new = packed
        ok = bool(ok)
        if ok and sy > _PAIR_EPS:  # cautious update: positive curvature only
            hist.push(s, y, sy, yy)
        converged, reason = check_convergence(f_new, f_h, gnorm_new, gnorm0, config)
        if not ok:
            reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
        it += 1
        hit_max = it >= config.max_iterations
        if hit_max and not (converged or not ok):
            reason = ConvergenceReason.MAX_ITERATIONS
        active = not (converged or not ok or hit_max)
        if ok:  # on line-search failure keep the old iterate
            w, f, g, pg, f_h, gnorm_h = w_t, f_t, g_t, pg_t, f_new, gnorm_new
            hv[it], hg[it], hvalid[it] = f_h, gnorm_h, True

    # Full-step polish, through OWL-QN's machinery: the direction from the
    # pseudo-gradient, projected onto its descent orthant, the stepped point
    # orthant-projected (exact zeros stay zero).  Each of the two steps is
    # kept only when small relative to the iterate, finite, and not growing
    # the pseudo-gradient.
    for _ in range(2):
        step = _project_direction(hist.direction(pg), pg)
        finite, step_norm, w_norm = torch.stack([  # host-sync: the solver's read
            torch.isfinite(step).all().to(step.dtype),
            torch.linalg.vector_norm(step), torch.linalg.vector_norm(w),
        ]).tolist()
        reads += 1
        if not (finite and step_norm <= 1e-3 * max(w_norm, 1.0)):
            continue
        w_p = _orthant_project(w + step, _orthant(w, pg))
        f_p, g_p = fun(w_p)
        pg_p = _pseudo_gradient(w_p, g_p, l1)
        f_ph, g_finite, gnorm_p = torch.stack([  # host-sync: the solver's read
            total(w_p, f_p), torch.isfinite(g_p).all().to(f_p.dtype),
            torch.linalg.vector_norm(pg_p),
        ]).tolist()
        reads += 1
        evaluations += 1
        if np.isfinite(f_ph) and g_finite and gnorm_p <= gnorm_h:
            w, f, g, pg, f_h, gnorm_h = w_p, f_p, g_p, pg_p, f_ph, gnorm_p
    return OptimizerResult(
        w=w, value=f_h, grad_norm=gnorm_h, iterations=it,
        converged=reason_is_converged(reason), reason=reason,
        history_value=hv, history_grad_norm=hg, history_valid=hvalid,
        host_reads=reads, evaluations=evaluations,
    )


def owlqn_lanes(
    fun: Callable[[Tensor], tuple[Tensor, Tensor]],
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    l1_weight: float = 0.0,
    point_values: Optional[Callable[[Tensor], Tensor]] = None,
) -> BatchedResult:
    """:func:`owlqn` batched over lanes (``w`` ``[B, d]``, ``fun`` ->
    smooth ``([B], [B, d])``), the reference's ``owlqn`` under ``vmap``
    (GAME's ``vmapped`` route for L1 and elastic-net entity solves): per
    lane the pseudo-gradient, the two-loop direction over its own ring
    buffer (``lbfgs.LaneHistory``) projected onto the pseudo-gradient's
    descent orthant, orthant-projected trial points, the projected Armijo
    test on the total objective, the cautious pair update and the two
    polish steps.

    An orthant-projected trial point is not ``w + t * step``, so the line
    search evaluates explicit points: ``point_values(points [B, T, d]) ->
    [B, T]`` is the smooth objective at each (for GLM lanes
    ``LaneObjective.point_values``), by default one ``fun`` call a column.
    Host reads: one a line-search block."""
    if point_values is None:
        def point_values(points: Tensor) -> Tensor:
            return torch.stack([fun(points[:, j])[0] for j in range(points.shape[1])], 1)
    l1 = float(np.float32(l1_weight))

    def total(w: Tensor, f_smooth: Tensor) -> Tensor:
        # The l1 term in the smooth values' dtype (float64 on GAME lanes):
        # a float32 |w|_1 would round away the progress the values resolve.
        return f_smooth + l1 * torch.sum(torch.abs(w), dim=-1, dtype=f_smooth.dtype)

    f, g = fun(w0)
    w = w0
    pg = _pseudo_gradient(w, g, l1)
    lanes = LaneState(total(w, f), norm(pg), config)
    hist = LaneHistory(config.history_length, w0)
    any_active = bool(lanes.active.any())
    reads, loops = 1, 0
    while any_active:
        loops += 1
        pg = _pseudo_gradient(w, g, l1)
        dvec = _project_direction(hist.direction(pg), pg)
        # Steepest descent on the pseudo-gradient where the projected
        # direction does not descend.
        dvec = torch.where((dot(pg, dvec) >= 0.0)[:, None], -pg, dvec)
        xi = _orthant(w, pg)
        t0 = torch.where(hist.num_pairs == 0, 1.0 / torch.clamp_min(norm(pg), 1.0),
                         torch.ones_like(lanes.gnorm0))

        def trial(ts):
            # Armijo on the total objective along the projected step:
            # f(w_t) <= f(w) + c1 * pg . (w_t - w).
            pts = _orthant_project(w[:, None] + ts[..., None] * dvec[:, None], xi[:, None])
            return (total(pts, point_values(pts)),
                    _ARMIJO_C1 * torch.sum(pg[:, None] * (pts - w[:, None]), dim=-1))

        def finish(t, ls_ok, f_try, level):
            w_t = _orthant_project(w + t[:, None] * dvec, xi)
            f_t, g_t = fun(w_t)
            decided = lanes.decide(f_try, level, norm(_pseudo_gradient(w_t, g_t, l1)),
                                   ls_ok)
            return (w_t, f_t, g_t, ls_ok, decided), decided[1].any()

        (w_t, f_t, g_t, ls_ok, decided), any_active, block_reads = armijo_lanes(
            trial, t0, lanes.active, config.max_line_search + 1, finish)
        reads += block_reads
        hist.push(w_t - w, g_t - g, lanes.active & ls_ok)
        keep = decided[3]  # on a failed search the old iterate stays
        w = torch.where(keep[:, None], w_t, w)
        f = torch.where(keep, f_t, f)
        g = torch.where(keep[:, None], g_t, g)
        lanes.commit(decided, total(w, f), norm(_pseudo_gradient(w, g, l1)))

    # Full-step polish through OWL-QN's machinery (exact zeros stay zero):
    # each step kept per lane only when small, finite and not growing the
    # pseudo-gradient.
    for _ in range(2):
        pg = _pseudo_gradient(w, g, l1)
        step = _project_direction(hist.direction(pg), pg)
        near = torch.isfinite(step).all(dim=-1) & (
            norm(step) <= 1e-3 * torch.clamp_min(norm(w), 1.0))
        w_p = torch.where(near[:, None], _orthant_project(w + step, _orthant(w, pg)), w)
        f_p, g_p = fun(w_p)
        keep = (near & torch.isfinite(f_p) & torch.isfinite(g_p).all(dim=-1)
                & (norm(_pseudo_gradient(w_p, g_p, l1)) <= norm(pg)))
        w = torch.where(keep[:, None], w_p, w)
        f = torch.where(keep, f_p, f)
        g = torch.where(keep[:, None], g_p, g)
    return lanes.result(w, total(w, f), norm(_pseudo_gradient(w, g, l1)), loops, reads)
