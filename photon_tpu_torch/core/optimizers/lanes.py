"""Shared pieces of the optimizers batched over lanes.

The reference solves a GAME size bin with ``jax.vmap`` over one problem's
masked ``lax.while_loop``.  ``torch.vmap`` cannot batch a data-dependent
loop, so the port's lane solvers (``newton.newton``, ``newton_cg.
newton_cg_lanes``, ``lbfgs.lbfgs_lanes``, ``owlqn.owlqn_lanes``, ``tron.
tron_lanes``) carry the lane axis themselves: ``w`` is ``[B, d]`` and every
state update is masked on a per-lane ``active`` flag, so a lane that has
converged freezes while the others iterate.  This module holds what they
share: the result type, the per-lane stopping rules and history, and the
Armijo backtracking that tries a block of step sizes per host read.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from photon_tpu_torch.core.optimizers.base import ConvergenceReason, OptimizerConfig

Tensor = torch.Tensor

# Armijo step sizes tried per host read: the first step and seven halvings.
LINE_SEARCH_BLOCK = 8
# Inner CG steps (Newton-CG, TRON) run per host read.  A masked step on a
# finished lane changes nothing, so a block gives what one step a read would.
CG_BLOCK = 8


class BatchedResult(NamedTuple):
    """Per-lane outcome of a lane solver (device tensors): final ``w``
    ``[B, d]``, ``value``/``grad_norm`` ``[B]``, ``iterations``/``reason``
    ``[B]`` int32, ``converged`` ``[B]`` bool, and the history ``[B,
    max_iterations + 1]`` (entry 0 is the initial point).  ``loop_iterations``
    is how many times the lockstep loop ran and ``host_reads`` how many
    device-to-host reads it made (host ints).  ``cg_iterations`` ``[B]``
    int32 is the inner CG work of the solvers that have an inner loop
    (Newton-CG, TRON), None elsewhere."""

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
    cg_iterations: Optional[Tensor] = None


def check_convergence_lanes(f_new: Tensor, f_old: Tensor, gnorm: Tensor,
                            gnorm0: Tensor, config: OptimizerConfig):
    """Per-lane (converged, reason): :func:`base.check_convergence` on
    ``[B]`` tensors (float64 values on the ``vmapped`` route)."""
    rel_improve = torch.abs(f_old - f_new) / torch.clamp_min(torch.abs(f_old), 1e-12)
    f_conv = rel_improve <= config.tolerance
    g_conv = gnorm <= config.gradient_tolerance * torch.clamp_min(gnorm0, 1.0)
    reason = torch.where(
        g_conv, ConvergenceReason.GRADIENT_TOLERANCE,
        torch.where(f_conv, ConvergenceReason.FUNCTION_VALUES_TOLERANCE,
                    ConvergenceReason.NOT_CONVERGED),
    ).to(torch.int32)
    return f_conv | g_conv, reason


def converged_lanes(reason: Tensor) -> Tensor:
    """True only where a tolerance was met."""
    return (reason == ConvergenceReason.FUNCTION_VALUES_TOLERANCE) | (
        reason == ConvergenceReason.GRADIENT_TOLERANCE)


class LaneState:
    """The loop bookkeeping every lane solver carries: iteration counts,
    ``active`` flags, reasons, ``gnorm0`` and the ``[B, max_iterations + 1]``
    history (slot 0 the initial point)."""

    def __init__(self, f0: Tensor, gnorm0: Tensor, config: OptimizerConfig):
        bsz, dev = f0.shape[0], f0.device
        self.config = config
        self.n_hist = config.max_iterations + 1
        self.gnorm0 = gnorm0
        self.hv = torch.zeros(bsz, self.n_hist, dtype=f0.dtype, device=dev)
        self.hg = torch.zeros_like(self.hv)
        self.hvalid = torch.zeros(bsz, self.n_hist, dtype=torch.bool, device=dev)
        self.hv[:, 0], self.hg[:, 0], self.hvalid[:, 0] = f0, gnorm0, True
        conv0 = gnorm0 == 0.0
        self.active = ~conv0
        self.reason = torch.where(conv0, ConvergenceReason.GRADIENT_TOLERANCE,
                                  ConvergenceReason.NOT_CONVERGED).to(torch.int32)
        self.it = torch.zeros(bsz, dtype=torch.int32, device=dev)
        self.lanes = torch.arange(bsz, device=dev)

    def decide(self, f_new: Tensor, f_old: Tensor, gnorm_new: Tensor,
               ls_ok: Tensor):
        """The iteration's per-lane verdict, as the reference's loop body
        takes it: ``(it, active, reason, keep)`` after this iteration
        (unchanged on inactive lanes); ``keep`` marks the lanes that move
        to their new point.  A failed line search (``~ls_ok``) stops the
        lane with OBJECTIVE_NOT_IMPROVING and keeps its old point."""
        config = self.config
        converged, why = check_convergence_lanes(f_new, f_old, gnorm_new,
                                                 self.gnorm0, config)
        stop_ls = ~ls_ok
        why = torch.where(stop_ls, ConvergenceReason.OBJECTIVE_NOT_IMPROVING, why)
        it_new = self.it + 1
        hit_max = it_new >= config.max_iterations
        why = torch.where(hit_max & ~(converged | stop_ls),
                          ConvergenceReason.MAX_ITERATIONS, why).to(torch.int32)
        return (torch.where(self.active, it_new, self.it),
                self.active & ~(converged | stop_ls | hit_max),
                torch.where(self.active, why, self.reason),
                self.active & ls_ok)

    def commit(self, decided, f: Tensor, gnorm: Tensor) -> None:
        """Take a :meth:`decide` verdict and record ``(f, gnorm)`` (the
        lanes' values after the iteration) in the history of the lanes that
        moved."""
        it_new, self.active, self.reason, keep = decided
        slot = (self.it + 1).clamp_max(self.n_hist - 1).long()
        self.it = it_new
        lanes = self.lanes
        self.hv[lanes, slot] = torch.where(keep, f, self.hv[lanes, slot])
        self.hg[lanes, slot] = torch.where(keep, gnorm, self.hg[lanes, slot])
        self.hvalid[lanes, slot] |= keep

    def result(self, w: Tensor, f: Tensor, gnorm: Tensor, loops: int, reads: int,
               cg: Optional[Tensor] = None) -> BatchedResult:
        return BatchedResult(
            w=w, value=f, grad_norm=gnorm, iterations=self.it,
            converged=converged_lanes(self.reason), reason=self.reason,
            history_value=self.hv, history_grad_norm=self.hg,
            history_valid=self.hvalid, loop_iterations=loops, host_reads=reads,
            cg_iterations=cg,
        )


def armijo_lanes(trial: Callable[[Tensor], tuple[Tensor, Tensor]], t0: Tensor,
                 searching: Tensor, n_steps: int, finish: Callable):
    """Armijo backtracking per lane over the step sizes ``t0 * 2^-j``,
    ``j = 0 .. n_steps - 1``, a block of :data:`LINE_SEARCH_BLOCK` of them
    per host read.

    ``trial(ts)`` gives, for step sizes ``ts`` ``[B, T]``, each lane's
    objective at its trial points and the Armijo decrease (<= 0) each must
    reach below the level: ``(values [B, T], decrease [B, T])``.  The first
    block's call also gets ``t = 0`` (column 0), whose value is the level:
    the test holds each trial to a value from the same arithmetic, so a
    step of no change passes at a minimum.  Each lane takes its first step
    size that passes; a lane that finds none keeps the last one tried and
    fails (``ls_ok`` False).  Lanes not ``searching`` (inactive) search
    nothing.

    ``finish(t, ls_ok, f_try, level)`` is the iteration's masked update at
    each lane's step size so far (``f_try`` its trial value); it runs after
    every block and returns ``(state, any_active)``, ``any_active`` a device
    bool read with the block's "still searching".  Returns ``(state of the
    last block, any_active as a host bool, host reads)``."""
    dev = t0.device
    t, f_try = t0, torch.zeros_like(t0)
    ls_ok = torch.zeros_like(searching)
    reads = 0
    for j0 in range(0, n_steps, LINE_SEARCH_BLOCK):
        js = torch.arange(j0, min(j0 + LINE_SEARCH_BLOCK, n_steps), device=dev)
        ts = t0[:, None] * torch.pow(0.5, js.to(t0.dtype))[None, :]
        if j0 == 0:
            f_c, dec = trial(torch.cat([torch.zeros_like(t0)[:, None], ts], 1))
            level, f_c, dec = f_c[:, 0], f_c[:, 1:], dec[:, 1:]
        else:
            f_c, dec = trial(ts)
        ok = (f_c <= level[:, None] + dec) & torch.isfinite(f_c)
        found = ok.any(dim=1)
        first = torch.where(found, ok.int().argmax(dim=1), len(js) - 1)[:, None]
        t = torch.where(searching, ts.gather(1, first)[:, 0], t)
        f_try = torch.where(searching, f_c.gather(1, first)[:, 0], f_try)
        ls_ok = ls_ok | (searching & found)
        searching = searching & ~found
        state, any_active = finish(t, ls_ok, f_try, level)
        # host-sync: the solver's one read a decision (counted in host_reads)
        more, any_active = torch.stack([searching.any(), any_active]).tolist()
        reads += 1
        if not more:
            break
    return state, bool(any_active), reads


def default_values(fun):
    """``values(w, step, ts)`` by one ``fun`` call a column of ``ts``."""
    def values(w: Tensor, step: Tensor, ts: Tensor) -> Tensor:
        return torch.stack(
            [fun(w + ts[:, j, None] * step)[0] for j in range(ts.shape[1])], 1)
    return values


def polish_step(fun, w: Tensor, f: Tensor, g: Tensor, step: Tensor, ok: Tensor,
                no_growth: bool = False):
    """One guarded full step of the polish: kept per lane only where ``ok``
    (the step is defined), the step is finite and small beside the iterate
    (``|step| <= 1e-3 max(|w|, 1)``) and the new point is finite; with
    ``no_growth`` (the quasi-Newton polish, whose direction no Hessian
    certifies) also only where the gradient norm does not grow."""
    near = ok & torch.isfinite(step).all(dim=-1) & (
        norm(step) <= 1e-3 * torch.clamp_min(norm(w), 1.0))
    w_p = torch.where(near[:, None], w + step, w)
    f_p, g_p = fun(w_p)
    keep = near & torch.isfinite(f_p) & torch.isfinite(g_p).all(dim=-1)
    if no_growth:
        keep = keep & (norm(g_p) <= norm(g))
    return (torch.where(keep[:, None], w_p, w), torch.where(keep, f_p, f),
            torch.where(keep[:, None], g_p, g))


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Per-lane inner product ``[B, d] x [B, d] -> [B]``."""
    return torch.sum(a * b, dim=-1)


def norm(a: Tensor) -> Tensor:
    """Per-lane Euclidean norm ``[B, d] -> [B]``."""
    return torch.linalg.vector_norm(a, dim=-1)
