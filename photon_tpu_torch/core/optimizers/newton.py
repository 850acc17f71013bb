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
  ``_LINE_SEARCH_BLOCK``, all of a block's values in one ``values`` call
  (for GLM lanes one pass over the bin), then one ``fun`` call at each
  lane's choice;
- the stopping rules, reasons and history are the base module's
  (:func:`check_convergence_lanes` is :func:`base.check_convergence`
  per lane, in float32).

Then two full-step polish steps, each taken only where the Hessian
factors, the step is small beside the iterate and it leaves a finite
point, carry the iterate past the float32
value-stall basin (~1e-4 wide) to within ~1e-6 of the optimum.

Host reads: one per iteration — a packed read of "any lane still
searching" and "any lane still active" after the first block — plus one
per further block, which only a lane that needs more than
``_LINE_SEARCH_BLOCK - 1`` halvings costs.  :attr:`BatchedResult.host_reads`
counts them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from photon_tpu_torch.core.optimizers.base import ConvergenceReason, OptimizerConfig
from photon_tpu_torch.core.optimizers.lbfgs import _ARMIJO_C1

Tensor = torch.Tensor

# Relative ridge on the Hessian's diagonal before factorization: keeps the
# Cholesky defined on flat directions, far below any curvature that moves
# the solution at the 1e-5 parity tolerance.
_RIDGE = 1e-9

# Armijo step sizes tried per host read: the full step and seven halvings.
_LINE_SEARCH_BLOCK = 8


class BatchedResult(NamedTuple):
    """Per-lane outcome of :func:`newton` (device tensors): final ``w``
    ``[B, d]``, ``value``/``grad_norm`` ``[B]``, ``iterations``/``reason``
    ``[B]`` int32, ``converged`` ``[B]`` bool, and the history ``[B,
    max_iterations + 1]`` (entry 0 is the initial point).  ``loop_iterations``
    is how many times the lockstep loop ran and ``host_reads`` how many
    device-to-host reads it made (host ints)."""

    w: Tensor
    value: Tensor
    grad_norm: Tensor
    iterations: Tensor
    converged: Tensor
    reason: Tensor
    history_value: Tensor
    history_grad_norm: Tensor
    history_valid: Tensor
    loop_iterations: int
    host_reads: int


def check_convergence_lanes(f_new: Tensor, f_old: Tensor, gnorm: Tensor,
                            gnorm0: Tensor, config: OptimizerConfig):
    """Per-lane (converged, reason): :func:`base.check_convergence` on
    ``[B]`` float32 tensors."""
    rel_improve = torch.abs(f_old - f_new) / torch.clamp_min(torch.abs(f_old), 1e-12)
    f_conv = rel_improve <= config.tolerance
    g_conv = gnorm <= config.gradient_tolerance * torch.clamp_min(gnorm0, 1.0)
    reason = torch.where(
        g_conv, ConvergenceReason.GRADIENT_TOLERANCE,
        torch.where(f_conv, ConvergenceReason.FUNCTION_VALUES_TOLERANCE,
                    ConvergenceReason.NOT_CONVERGED),
    ).to(torch.int32)
    return f_conv | g_conv, reason


def newton_step(h: Tensor, g: Tensor) -> tuple[Tensor, Tensor]:
    """``(-H^-1 g, factorization ok)`` per lane, through one batched
    Cholesky of the ridged Hessians."""
    diag = torch.diagonal(h, dim1=-2, dim2=-1)
    ridge = _RIDGE * (1.0 + torch.amax(torch.abs(diag), dim=-1))
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    chol, info = torch.linalg.cholesky_ex(h + ridge[:, None, None] * eye)
    step = -torch.cholesky_solve(g[..., None], chol)[..., 0]
    return step, info == 0


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
    if values is None:
        def values(w: Tensor, step: Tensor, ts: Tensor) -> Tensor:
            return torch.stack(
                [fun(w + ts[:, j, None] * step)[0] for j in range(ts.shape[1])], 1)
    dev = w0.device
    n_hist = config.max_iterations + 1
    f, g = fun(w0)
    w = w0
    gnorm0 = torch.linalg.vector_norm(g, dim=-1)
    bsz = w0.shape[0]
    hv = torch.zeros(bsz, n_hist, dtype=f.dtype, device=dev)
    hg = torch.zeros_like(hv)
    hvalid = torch.zeros(bsz, n_hist, dtype=torch.bool, device=dev)
    hv[:, 0], hg[:, 0], hvalid[:, 0] = f, gnorm0, True
    conv0 = gnorm0 == 0.0
    active = ~conv0
    reason = torch.where(conv0, ConvergenceReason.GRADIENT_TOLERANCE,
                         ConvergenceReason.NOT_CONVERGED).to(torch.int32)
    it = torch.zeros(bsz, dtype=torch.int32, device=dev)
    lanes = torch.arange(bsz, device=dev)

    def update(t, f_new, g_new, ls_ok, f_try):
        """The iteration's masked state update (``w, f, g, it, active,
        reason`` and the history slot), as the reference's ``tree_where``
        over its loop body: lanes that were inactive keep everything.  The
        function-value test holds ``f_try``, the line search's value at the
        chosen step, to ``level``, its value at t = 0."""
        gnorm_new = torch.linalg.vector_norm(g_new, dim=-1)
        converged, why = check_convergence_lanes(f_try, level, gnorm_new, gnorm0, config)
        stop_ls = ~ls_ok
        why = torch.where(stop_ls, ConvergenceReason.OBJECTIVE_NOT_IMPROVING, why)
        it_new = it + 1
        hit_max = it_new >= config.max_iterations
        why = torch.where(hit_max & ~(converged | stop_ls),
                          ConvergenceReason.MAX_ITERATIONS, why).to(torch.int32)
        keep = active & ls_ok  # on a failed search the old iterate stays
        return (
            torch.where(keep[:, None], w + t[:, None] * step, w),
            torch.where(keep, f_new, f),
            torch.where(keep[:, None], g_new, g),
            torch.where(active, it_new, it),
            active & ~(converged | stop_ls | hit_max),
            torch.where(active, why, reason),
            keep, it_new.clamp_max(n_hist - 1).long(),
        )

    n_steps = config.max_line_search + 1  # t0 and its halvings
    any_active = bool(active.any())
    reads, loops = 1, 0
    while any_active:
        loops += 1
        step, chol_ok = newton_step(hess(w), g)
        dir_deriv = torch.sum(g * step, dim=-1)
        bad = ~chol_ok | ~torch.isfinite(step).all(dim=-1) | (dir_deriv >= 0.0)
        gg = torch.sum(g * g, dim=-1)
        step = torch.where(bad[:, None], -g, step)
        dir_deriv = torch.where(bad, -gg, dir_deriv)
        t0 = torch.where(
            bad, 1.0 / torch.clamp_min(torch.sqrt(gg), 1.0), torch.ones_like(gg)
        )
        # Armijo backtracking per lane, a block of step sizes per read; an
        # inactive lane does not search.  The first block also takes the
        # value at t = 0: the Armijo and function-value tests hold the step
        # sizes' values to it, so both sides of each come from the same
        # ``values`` arithmetic and a step of no change passes at a minimum.
        t, f_try, searching = t0, f, active
        ls_ok = torch.zeros_like(active)
        for j0 in range(0, n_steps, _LINE_SEARCH_BLOCK):
            js = torch.arange(j0, min(j0 + _LINE_SEARCH_BLOCK, n_steps), device=dev)
            ts = t0[:, None] * torch.pow(0.5, js.to(t0.dtype))[None, :]
            if j0 == 0:
                f_c = values(w, step, torch.cat([torch.zeros_like(t0)[:, None], ts], 1))
                level, f_c = f_c[:, 0], f_c[:, 1:]
            else:
                f_c = values(w, step, ts)
            ok = (f_c <= level[:, None] + (_ARMIJO_C1 * ts) * dir_deriv[:, None]) \
                & torch.isfinite(f_c)
            found = ok.any(dim=1)
            first = torch.where(found, ok.int().argmax(dim=1), len(js) - 1)[:, None]
            t = torch.where(searching, ts.gather(1, first)[:, 0], t)
            f_try = torch.where(searching, f_c.gather(1, first)[:, 0], f_try)
            ls_ok = ls_ok | (searching & found)
            searching = searching & ~found
            f_new, g_new = fun(w + t[:, None] * step)
            new = update(t, f_new, g_new, ls_ok, f_try)
            more, any_active = torch.stack([searching.any(), new[4].any()]).tolist()
            reads += 1
            if not more:
                break
        w, f, g, it, active, reason, keep, slot = new
        hv[lanes, slot] = torch.where(keep, f, hv[lanes, slot])
        hg[lanes, slot] = torch.where(
            keep, torch.linalg.vector_norm(g, dim=-1), hg[lanes, slot])
        hvalid[lanes, slot] |= keep

    # Full-step polish (see the module docstring): masked, no host reads.
    for _ in range(2):
        step, chol_ok = newton_step(hess(w), g)
        near = chol_ok & torch.isfinite(step).all(dim=-1) & (
            torch.linalg.vector_norm(step, dim=-1)
            <= 1e-3 * torch.clamp_min(torch.linalg.vector_norm(w, dim=-1), 1.0)
        )
        w_p = torch.where(near[:, None], w + step, w)
        f_p, g_p = fun(w_p)
        keep = near & torch.isfinite(f_p) & torch.isfinite(g_p).all(dim=-1)
        w = torch.where(keep[:, None], w_p, w)
        f = torch.where(keep, f_p, f)
        g = torch.where(keep[:, None], g_p, g)
    converged = (reason == ConvergenceReason.FUNCTION_VALUES_TOLERANCE) | (
        reason == ConvergenceReason.GRADIENT_TOLERANCE)
    return BatchedResult(
        w=w, value=f, grad_norm=torch.linalg.vector_norm(g, dim=-1),
        iterations=it, converged=converged, reason=reason,
        history_value=hv, history_grad_norm=hg, history_valid=hvalid,
        loop_iterations=loops, host_reads=reads,
    )
