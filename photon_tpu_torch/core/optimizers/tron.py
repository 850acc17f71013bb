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
        dhd_h, s_try_norm, rtr, rtr_new, std, sts, dtd = (f32(x) for x in torch.stack([
            dhd, _norm(s_try), rtr_t, rtr_new_t, torch.dot(s, d), torch.dot(s, s),
            torch.dot(d, d),
        ]).tolist())
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
        gs, s_r, f_new_h, snorm, gnorm_new = (f32(x) for x in torch.stack([
            torch.dot(g, step), torch.dot(step, resid), f_new, _norm(step),
            _norm(g_new),
        ]).tolist())
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
