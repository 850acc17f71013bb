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
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from photon_tpu_torch.core.optimizers.base import (
    ConvergenceReason,
    OptimizerConfig,
    OptimizerResult,
    check_convergence,
    reason_is_converged,
)
from photon_tpu_torch.core.optimizers.lbfgs import _ARMIJO_C1, _PAIR_EPS, _History

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
            packed = torch.stack([
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
        finite, step_norm, w_norm = torch.stack([
            torch.isfinite(step).all().to(step.dtype),
            torch.linalg.vector_norm(step), torch.linalg.vector_norm(w),
        ]).tolist()
        reads += 1
        if not (finite and step_norm <= 1e-3 * max(w_norm, 1.0)):
            continue
        w_p = _orthant_project(w + step, _orthant(w, pg))
        f_p, g_p = fun(w_p)
        pg_p = _pseudo_gradient(w_p, g_p, l1)
        f_ph, g_finite, gnorm_p = torch.stack([
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
