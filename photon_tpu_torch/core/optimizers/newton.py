"""Damped Newton over a batch of independent problems, one per lane.

Counterpart of ``photon_tpu/core/optimizers/newton.py``.  The reference
writes one problem's solve as a ``lax.while_loop`` and maps it over the
entities of a GAME size bin with ``jax.vmap``; ``torch.vmap`` cannot batch
a data-dependent loop, so this solver carries the lane axis itself: ``w``
is ``[B, d]``, ``fun`` returns ``([B], [B, d])`` and ``hess`` ``[B, d, d]``,
and every state update is masked on a per-lane ``active`` flag, so a lane
that has converged freezes while the others iterate — the reference's
contract under ``vmap``.  Per iteration and lane:

- the Hessian gets the relative ridge ``_RIDGE * (1 + max|diag H|)`` and
  one batched Cholesky factor and solve gives the Newton step;
- a failed factorization, a non-finite step or a non-descent step falls
  back to steepest descent with ``t0 = 1 / max(|g|, 1)``;
- the Armijo backtracking of :mod:`lbfgs` (``_ARMIJO_C1``; the step
  sizes ``t0 * 2^-j``, ``j = 0 .. max_line_search``) runs per lane: each
  lane takes its first step size that passes, so lanes that pass at once
  wait for the rest.  The step sizes are tried in blocks of
  ``lanes.LINE_SEARCH_BLOCK``, all of a block's values in one ``values`` call
  (for GLM lanes one pass over the bin), then one ``fun`` call at each
  lane's choice;
- the stopping rules, reasons and history are the base module's
  (``lanes.check_convergence_lanes`` is :func:`base.check_convergence`
  per lane).

Then two full-step polish steps, each taken only where the Hessian
factors, the step is small beside the iterate and it leaves a finite
point, carry the iterate past the float32
value-stall basin (~1e-4 wide) to within ~1e-6 of the optimum.

Host reads: one per iteration — a packed read of "any lane still
searching" and "any lane still active" after the first block — plus one
per further block, which only a lane that needs more than
``lanes.LINE_SEARCH_BLOCK - 1`` halvings costs.  :attr:`BatchedResult.host_reads`
counts them.
"""

from __future__ import annotations

from typing import Callable

import torch

from photon_tpu_torch.core.optimizers.base import OptimizerConfig
from photon_tpu_torch.core.optimizers.lanes import (
    BatchedResult,
    LaneState,
    armijo_lanes,
    default_values,
    dot,
    norm,
    polish_step,
)
from photon_tpu_torch.core.optimizers.lbfgs import _ARMIJO_C1

Tensor = torch.Tensor

# Relative ridge on the Hessian's diagonal before factorization: keeps the
# Cholesky defined on flat directions, far below any curvature that moves
# the solution at the 1e-5 parity tolerance.
_RIDGE = 1e-9


def newton_step(h: Tensor, g: Tensor) -> tuple[Tensor, Tensor]:
    """``(-H^-1 g, factorization ok)`` per lane, through one batched
    Cholesky of the ridged Hessians."""
    diag = torch.diagonal(h, dim1=-2, dim2=-1)
    ridge = _RIDGE * (1.0 + torch.amax(torch.abs(diag), dim=-1))
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    chol, info = torch.linalg.cholesky_ex(h + ridge[:, None, None] * eye)
    step = -torch.cholesky_solve(g[..., None], chol)[..., 0]
    return step, info == 0


def damped_step(fun, values, lanes: LaneState, w: Tensor, f: Tensor, g: Tensor,
                step: Tensor, bad: Tensor):
    """One damped (Newton or Newton-CG) iteration on every active lane:
    ``bad`` lanes (a failed factorization, a non-finite or non-descent step)
    fall back to steepest descent with ``t0 = 1 / max(|g|, 1)``, the others
    try the full step first; then the Armijo backtracking of
    :func:`lanes.armijo_lanes` and the masked update.  Returns ``(w, f, g,
    any_active, host reads)``; the verdict and history are committed to
    ``lanes``."""
    dir_deriv = dot(g, step)
    bad = bad | (dir_deriv >= 0.0)
    gg = dot(g, g)
    step = torch.where(bad[:, None], -g, step)
    dir_deriv = torch.where(bad, -gg, dir_deriv)
    t0 = torch.where(
        bad, 1.0 / torch.clamp_min(torch.sqrt(gg), 1.0), torch.ones_like(gg)
    )

    def trial(ts):
        return values(w, step, ts), (_ARMIJO_C1 * ts) * dir_deriv[:, None]

    def finish(t, ls_ok, f_try, level):
        """The masked update, as the reference's ``tree_where`` over its
        loop body: the function-value test holds ``f_try``, the line
        search's value at the chosen step, to ``level``, its value at
        t = 0; on a failed search the old iterate stays."""
        f_new, g_new = fun(w + t[:, None] * step)
        decided = lanes.decide(f_try, level, norm(g_new), ls_ok)
        keep = decided[3]
        new = (torch.where(keep[:, None], w + t[:, None] * step, w),
               torch.where(keep, f_new, f),
               torch.where(keep[:, None], g_new, g), decided)
        return new, decided[1].any()

    (w, f, g, decided), any_active, reads = armijo_lanes(
        trial, t0, lanes.active, lanes.config.max_line_search + 1, finish)
    lanes.commit(decided, f, norm(g))
    return w, f, g, any_active, reads


def newton(
    fun: Callable[[Tensor], tuple[Tensor, Tensor]],
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    hess: Callable[[Tensor], Tensor] | None = None,
    values: Callable[[Tensor, Tensor, Tensor], Tensor] | None = None,
) -> BatchedResult:
    """Minimize each lane of ``fun`` (``[B, d] -> ([B], [B, d])``) from
    ``w0`` with damped Newton steps; ``hess(w) -> [B, d, d]`` is the dense
    Hessian (for GLM lanes, ``LaneObjective.hessian_matrix``) and
    ``values(w, step, ts) -> [B, T]`` the objective at ``w + ts[:, j] *
    step`` for each column ``j`` of ``ts`` ``[B, T]`` (for GLM lanes,
    ``LaneObjective.line_values``), by default one ``fun`` call a column."""
    if hess is None:
        raise ValueError("the batched Newton solver needs hess(w) -> [B, d, d]")
    values = values or default_values(fun)
    f, g = fun(w0)
    w = w0
    lanes = LaneState(f, norm(g), config)
    any_active = bool(lanes.active.any())
    reads, loops = 1, 0
    while any_active:
        loops += 1
        step, chol_ok = newton_step(hess(w), g)
        bad = ~chol_ok | ~torch.isfinite(step).all(dim=-1)
        w, f, g, any_active, block_reads = damped_step(
            fun, values, lanes, w, f, g, step, bad)
        reads += block_reads

    # Full-step polish (see the module docstring): masked, no host reads.
    for _ in range(2):
        step, chol_ok = newton_step(hess(w), g)
        w, f, g = polish_step(fun, w, f, g, step, chol_ok)
    return lanes.result(w, f, norm(g), loops, reads)
