"""TRON: trust-region Newton with a truncated conjugate-gradient inner loop.

Counterpart of ``photon_tpu/core/optimizers/tron.py`` (LIBLINEAR's tron.cpp)
as a Python loop over device tensors: the same constants (eta0/1/2,
sigma1/2/3), the same trcg truncation at the trust boundary, the same
radius update and acceptance test, and rejected trials count toward
``max_iterations`` as in the reference.  The curvature operator is built
once per outer iteration (``hvp_at(w)``, for GLMs
``GlmObjective.hvp_operator``: one margin pass, then two matvecs per CG
step).

Host reads: one packed read per CG step (the scalars its stop test needs:
``d.Hd``, the trial step's norm, the new residual norm and the dot
products of the boundary step), one per outer iteration (the step's
predicted and actual reduction and the new gradient norm) and one at the
start.  The host takes every decision from them in float32 arithmetic, as
the reference's device loop does; the vectors stay on the device.
``OptimizerResult.host_reads`` reports the count.

:func:`tron_lanes` is the same solver batched over lanes, the reference's
``tron`` under ``jax.vmap`` (GAME's TRON entity solves): a trust radius per
lane, every update masked per lane, the CG steps in blocks with one host
read a block and one an outer iteration.
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
    CG_BLOCK,
    BatchedResult,
    LaneState,
    check_convergence_lanes,
    dot,
    norm,
)

Tensor = torch.Tensor
f32 = np.float32

_ETA0, _ETA1, _ETA2 = f32(1e-4), f32(0.25), f32(0.75)
_SIGMA1, _SIGMA2, _SIGMA3 = f32(0.25), f32(0.5), f32(4.0)
_TINY = f32(1e-30)


def _norm(x: Tensor) -> Tensor:
    return torch.linalg.vector_norm(x)


def _trcg(hvp: Callable[[Tensor], Tensor], g: Tensor, gnorm: float,
          delta: float, max_cg: int, cg_tolerance: float):
    """LIBLINEAR's trcg: approximately solve ``H s = -g`` with
    ``||s|| <= delta``.  Returns ``(s, r, steps, host reads)``, where
    ``r = -g - H s`` is the residual."""
    cg_tol = f32(cg_tolerance) * f32(gnorm)
    s = torch.zeros_like(g)
    r = -g
    d = r.clone()
    rtr_t = torch.dot(g, g)
    it = reads = 0
    done = not f32(gnorm) > cg_tol
    while not done:
        hd = hvp(d)
        dhd = torch.dot(d, hd)
        alpha = rtr_t / torch.where(dhd > _TINY, dhd, torch.ones_like(dhd))
        s_try = s + alpha * d
        r_in = r - alpha * hd
        rtr_new_t = torch.dot(r_in, r_in)
        # host-sync: the solver's one read a CG step (counted in host_reads)
        dhd_h, s_try_norm, rtr, rtr_new, std, sts, dtd = (f32(x) for x in torch.stack([
            dhd, _norm(s_try), rtr_t, rtr_new_t, torch.dot(s, d), torch.dot(s, s),
            torch.dot(d, d)]).tolist())
        reads += 1
        it += 1
        if s_try_norm > f32(delta) or dhd_h <= _TINY:
            # Truncate to the trust boundary along d from the previous s.
            dsq = f32(delta) * f32(delta)
            rad = np.sqrt(np.maximum(std * std + dtd * (dsq - sts), f32(0.0)))
            alpha_b = ((dsq - sts) / np.maximum(std + rad, _TINY) if std >= 0
                       else (rad - std) / np.maximum(dtd, _TINY))
            s = s + float(alpha_b) * d
            r = r - float(alpha_b) * hd
            break
        s, r = s_try, r_in
        beta = rtr_new / np.maximum(rtr, _TINY)
        d = r_in + float(beta) * d
        rtr_t = rtr_new_t
        done = np.sqrt(rtr_new) <= cg_tol or it >= max_cg
    return s, r, it, reads


def tron(
    fun: Callable[[Tensor], tuple[Tensor, Tensor]],
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    hvp: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
    hvp_at: Optional[Callable[[Tensor], Callable[[Tensor], Tensor]]] = None,
) -> OptimizerResult:
    """Minimize ``fun`` (returning (value, grad) tensors) from ``w0``.

    ``hvp_at(w) -> (v -> H(w) v)`` is the curvature operator, built once
    per outer iteration; ``hvp(w, v)`` is the per-call form.  One of the two
    is required: the port's objectives are not differentiated, so there is
    no jvp-of-gradient default.
    """
    if hvp_at is None:
        if hvp is None:
            raise ValueError("tron needs hvp_at or hvp (H(w) v products)")

        def hvp_at(w):
            return lambda v: hvp(w, v)

    max_cg = config.cg_max_iterations or min(int(w0.shape[0]), 100)
    n_hist = config.max_iterations + 1
    hv = np.zeros(n_hist, np.float32)
    hg = np.zeros(n_hist, np.float32)
    hvalid = np.zeros(n_hist, bool)

    w = w0
    f, g = fun(w)
    # host-sync: the solver's one read a decision (counted in host_reads)
    f_h, gnorm0 = (f32(x) for x in torch.stack([f, _norm(g)]).tolist())
    reads = 1
    hv[0], hg[0], hvalid[0] = f_h, gnorm0, True
    gnorm = gnorm0
    delta = gnorm0
    accepted = it = cg_total = 0
    active = gnorm0 != 0.0
    reason = (ConvergenceReason.NOT_CONVERGED if active
              else ConvergenceReason.GRADIENT_TOLERANCE)
    while active:
        step, resid, cg_it, cg_reads = _trcg(
            hvp_at(w), g, gnorm, delta, max_cg, config.cg_tolerance
        )
        cg_total += cg_it
        w_new = w + step
        f_new, g_new = fun(w_new)
        # host-sync: the solver's one read a decision (counted in host_reads)
        gs, s_r, f_new_h, snorm, gnorm_new = (f32(x) for x in torch.stack([
            torch.dot(g, step), torch.dot(step, resid), f_new, _norm(step),
            _norm(g_new)]).tolist())
        reads += cg_reads + 1
        prered = f32(-0.5) * (gs - s_r)
        actred = f_h - f_new_h
        # The first successful iteration clamps the radius to the step.
        if accepted == 0:
            delta = np.minimum(delta, snorm)
        denom = f_new_h - f_h - gs
        alpha = (_SIGMA3 if denom <= 0 else
                 np.maximum(_SIGMA1, f32(-0.5) * (gs / denom)))
        lo, hi = np.minimum, np.maximum
        if actred < _ETA0 * prered:
            delta = lo(hi(alpha, _SIGMA1) * snorm, _SIGMA2 * delta)
        elif actred < _ETA1 * prered:
            delta = hi(_SIGMA1 * delta, lo(alpha * snorm, _SIGMA2 * delta))
        elif actred < _ETA2 * prered:
            delta = hi(_SIGMA1 * delta, lo(alpha * snorm, _SIGMA3 * delta))
        else:
            delta = hi(delta, lo(alpha * snorm, _SIGMA3 * delta))
        accept = bool(actred > _ETA0 * prered) and bool(np.isfinite(f_new_h))
        it += 1
        f_old = f_h
        if accept:
            w, f, g, f_h, gnorm = w_new, f_new, g_new, f_new_h, gnorm_new
            accepted += 1
            hv[it], hg[it], hvalid[it] = f_h, gnorm, True
            converged, reason = check_convergence(f_h, f_old, gnorm, gnorm0, config)
        else:
            converged, reason = False, ConvergenceReason.NOT_CONVERGED
        # Degenerate model: no predicted reduction possible.
        degenerate = prered <= 0 and actred <= 0
        if degenerate:
            reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
        hit_max = it >= config.max_iterations
        if hit_max and not (converged or degenerate):
            reason = ConvergenceReason.MAX_ITERATIONS
        active = not (converged or degenerate or hit_max)
    return OptimizerResult(
        w=w, value=float(f_h), grad_norm=float(gnorm), iterations=it,
        converged=reason_is_converged(reason), reason=reason,
        history_value=hv, history_grad_norm=hg, history_valid=hvalid,
        cg_iterations=cg_total, host_reads=reads,
    )


def _trcg_lanes(hvp: Callable[[Tensor], Tensor], g: Tensor, delta: Tensor,
                max_cg: int, active: Tensor, cg_tolerance: float):
    """:func:`_trcg` on every lane at once (``g`` ``[B, d]``, ``delta``
    ``[B]``), the reference's ``_trcg`` under ``vmap``: each CG step masked
    on the lanes still iterating, the steps in blocks of
    :data:`lanes.CG_BLOCK`, one host read a block.  Returns ``(s, r, steps
    [B] int32, host reads)``, ``r = -g - H s``."""
    cg_tol = cg_tolerance * norm(g)
    s = torch.zeros_like(g)
    r = -g
    d = r.clone()
    rtr = dot(g, g)
    it = torch.zeros(g.shape[0], dtype=torch.int32, device=g.device)
    done = ~active | (torch.sqrt(rtr) <= cg_tol)
    tiny = torch.full_like(rtr, float(_TINY))
    one = torch.ones_like(rtr)
    dsq = delta * delta
    reads = 0
    while True:
        for _ in range(CG_BLOCK):
            hd = hvp(d)
            dhd = dot(d, hd)
            # Flat directions (d.Hd ~ 0) stop at the boundary.
            alpha = rtr / torch.where(dhd > _TINY, dhd, one)
            bad_curv = dhd <= _TINY
            s_try = s + alpha[:, None] * d
            over = norm(s_try) > delta
            # Truncate to the trust boundary along d from the previous s.
            std, sts, dtd = dot(s, d), dot(s, s), dot(d, d)
            rad = torch.sqrt(torch.clamp_min(std * std + dtd * (dsq - sts), 0.0))
            alpha_b = torch.where(std >= 0.0,
                                  (dsq - sts) / torch.maximum(std + rad, tiny),
                                  (rad - std) / torch.maximum(dtd, tiny))
            r_in = r - alpha[:, None] * hd
            rtr_new = dot(r_in, r_in)
            beta = rtr_new / torch.maximum(rtr, tiny)
            d_new = r_in + beta[:, None] * d
            stop_boundary = over | bad_curv
            done_new = (stop_boundary | (torch.sqrt(rtr_new) <= cg_tol)
                        | (it + 1 >= max_cg))
            step = ~done
            edge = (step & stop_boundary)[:, None]
            inner = (step & ~stop_boundary)[:, None]
            s = torch.where(edge, s + alpha_b[:, None] * d, torch.where(inner, s_try, s))
            r = torch.where(edge, r - alpha_b[:, None] * hd, torch.where(inner, r_in, r))
            d = torch.where(step[:, None], d_new, d)
            rtr = torch.where(step, rtr_new, rtr)
            it = torch.where(step, it + 1, it)
            done = torch.where(step, done_new, done)
        reads += 1
        if bool(done.all()):
            return s, r, it, reads


def tron_lanes(
    fun: Callable[[Tensor], tuple[Tensor, Tensor]],
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    hvp_at: Optional[Callable[[Tensor], Callable[[Tensor], Tensor]]] = None,
) -> BatchedResult:
    """:func:`tron` batched over lanes (``w`` ``[B, d]``, ``fun`` ->
    ``([B], [B, d])``), the reference's ``tron`` under ``vmap`` (GAME's
    ``vmapped`` route for TRON entity solves): per lane a trust radius, the
    truncated CG of :func:`_trcg_lanes` on ``hvp_at(w)`` (for GLM lanes
    ``LaneObjective.hvp_operator``), LIBLINEAR's radius update and
    acceptance test; rejected trials count toward ``max_iterations``.  Host
    reads: one a CG block and one an outer iteration."""
    if hvp_at is None:
        raise ValueError("tron_lanes needs hvp_at (the curvature operator)")
    max_cg = config.cg_max_iterations or min(int(w0.shape[1]), 100)
    f, g = fun(w0)
    w = w0
    gnorm0 = norm(g)
    lanes = LaneState(f, gnorm0, config)
    delta = gnorm0.clone()
    accepted = torch.zeros_like(lanes.it)
    cg = torch.zeros_like(lanes.it)
    any_active = bool(lanes.active.any())
    reads, loops = 1, 0
    while any_active:
        loops += 1
        active = lanes.active
        step, resid, cg_it, cg_reads = _trcg_lanes(
            hvp_at(w), g, delta, max_cg, active, config.cg_tolerance)
        cg = cg + cg_it
        w_new = w + step
        f_new, g_new = fun(w_new)
        gs = dot(g, step)
        prered = -0.5 * (gs - dot(step, resid))
        actred = f - f_new
        snorm = norm(step)
        # The first successful iteration clamps the radius to the step.
        rad = torch.where(accepted == 0, torch.minimum(delta, snorm), delta)
        denom = f_new - f - gs
        alpha = torch.where(
            denom <= 0.0, torch.full_like(denom, float(_SIGMA3)),
            torch.clamp_min(-0.5 * (gs / torch.where(denom <= 0.0, torch.ones_like(denom),
                                                     denom)), float(_SIGMA1)))
        lo, hi = torch.minimum, torch.maximum
        rad = torch.where(
            actred < _ETA0 * prered,
            lo(torch.clamp_min(alpha, float(_SIGMA1)) * snorm, _SIGMA2 * rad),
            torch.where(
                actred < _ETA1 * prered,
                hi(_SIGMA1 * rad, lo(alpha * snorm, _SIGMA2 * rad)),
                torch.where(actred < _ETA2 * prered,
                            hi(_SIGMA1 * rad, lo(alpha * snorm, _SIGMA3 * rad)),
                            hi(rad, lo(alpha * snorm, _SIGMA3 * rad)))))
        accept = (actred > _ETA0 * prered) & torch.isfinite(f_new)
        f_out = torch.where(accept, f_new, f)
        gnorm_new = norm(torch.where(accept[:, None], g_new, g))
        # Tolerances are tested only after accepted steps; a degenerate
        # model (no predicted reduction possible) stops the lane.
        converged, why = check_convergence_lanes(f_out, f, gnorm_new, gnorm0, config)
        converged = converged & accept
        why = torch.where(accept, why, ConvergenceReason.NOT_CONVERGED)
        degenerate = (prered <= 0.0) & (actred <= 0.0)
        why = torch.where(degenerate, ConvergenceReason.OBJECTIVE_NOT_IMPROVING, why)
        it_new = lanes.it + 1
        hit_max = it_new >= config.max_iterations
        why = torch.where(hit_max & ~(converged | degenerate),
                          ConvergenceReason.MAX_ITERATIONS, why).to(torch.int32)
        still = active & ~(converged | degenerate | hit_max)
        keep = active & accept
        w = torch.where(keep[:, None], w_new, w)
        f = torch.where(keep, f_new, f)
        g = torch.where(keep[:, None], g_new, g)
        delta = torch.where(active, rad.to(delta.dtype), delta)
        accepted = torch.where(keep, accepted + 1, accepted)
        lanes.commit((torch.where(active, it_new, lanes.it), still,
                      torch.where(active, why, lanes.reason), keep), f, norm(g))
        any_active = bool(still.any())
        reads += cg_reads + 1
    return lanes.result(w, f, norm(g), loops, reads, cg)
