"""Matrix-free damped Newton with a preconditioned-CG inner solve.

Counterpart of ``photon_tpu/core/optimizers/newton_cg.py`` as a Python loop
over device tensors: each outer iteration builds the curvature operator
once (``hvp_at(w)``), solves ``H p = -g`` by Jacobi-preconditioned CG
(diagonal from ``diag(w)``, for GLMs ``GlmObjective.hessian_diagonal``)
to the Eisenstat-Walker tolerance ``min(0.5, sqrt(|g| / |g0|)) |g|``, falls
back to steepest descent on a non-finite or non-descent direction, and
takes the Armijo backtracking line search; two guarded full Newton steps
at a tight CG tolerance polish the result past the float32 value stall.

Host reads: one per CG step (``d.Hd``, the residual norm, ``r.z``), one to
start each CG solve, one per line-search trial and one for the direction
test; ``OptimizerResult.host_reads`` reports the count.

:func:`newton_cg_lanes` is the same solver batched over lanes, the
reference's ``newton_cg`` under ``jax.vmap`` (GAME's ``newton_cg`` entity
route): every update masked per lane, the CG steps in blocks of
``lanes.CG_BLOCK`` and the step sizes in blocks of
``lanes.LINE_SEARCH_BLOCK``, one host read a block.
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
    default_values,
    dot,
    norm,
    polish_step,
)
from photon_tpu_torch.core.optimizers.newton import damped_step

Tensor = torch.Tensor
f32 = np.float32

_ARMIJO_C1 = 1e-4
# Floor on the Jacobi diagonal: keeps the scaling defined on flat directions.
_DIAG_FLOOR = 1e-12
# Relative CG tolerance of the two polish steps.
_POLISH_ETA = 1e-2


def _norm(x: Tensor) -> Tensor:
    return torch.linalg.vector_norm(x)


def _pcg(hv: Callable[[Tensor], Tensor], g: Tensor, mdiag: Tensor,
         tol: float, max_cg: int):
    """Jacobi-preconditioned CG on ``H p = -g``; returns ``(p, steps, host
    reads)``.  Stops on ``|r| <= tol``, ``max_cg`` steps, a non-finite
    ``r.z``, or negative curvature (``d.Hd <= 0``: the current iterate, or
    on the first step the preconditioned steepest-descent direction)."""
    r = -g
    z = r / mdiag
    rz_t = torch.dot(r, z)
    # host-sync: the solver's one read a decision (counted in host_reads)
    b_norm, rz = (f32(x) for x in torch.stack([_norm(r), rz_t]).tolist())
    p = torch.zeros_like(g)
    dvec = z
    it, reads = 0, 1
    done = b_norm <= tol or not np.isfinite(rz)
    while not done:
        hd = hv(dvec)
        dhd = torch.dot(dvec, hd)
        alpha = rz_t / torch.where(dhd <= 0, torch.ones_like(dhd), dhd)
        r_new = r - alpha * hd
        z_new = r_new / mdiag
        rz_new_t = torch.dot(r_new, z_new)
        dhd_h, r_norm, rz_new = (f32(x) for x in torch.stack(  # host-sync: the solver's read
            [dhd, _norm(r_new), rz_new_t]).tolist())
        reads += 1
        it += 1
        if dhd_h <= 0:
            if it == 1:
                p = z
            break
        p = p + alpha * dvec
        beta = rz_new / (rz if rz > 0 else f32(1.0))
        dvec = z_new + float(beta) * dvec
        r, z, rz, rz_t = r_new, z_new, rz_new, rz_new_t
        done = r_norm <= tol or it >= max_cg or not np.isfinite(rz_new)
    return p, it, reads


def newton_cg(
    fun: Callable[[Tensor], tuple[Tensor, Tensor]],
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    hvp_at: Optional[Callable[[Tensor], Callable[[Tensor], Tensor]]] = None,
    diag: Optional[Callable[[Tensor], Tensor]] = None,
) -> OptimizerResult:
    """Minimize ``fun`` (returning (value, grad) tensors) by inexact
    Newton-CG.  ``hvp_at(w)`` returns ``v -> H(w) v`` (required: the port's
    objectives are not differentiated); ``diag(w)`` the Jacobi diagonal
    (identity when None).  ``config.cg_max_iterations`` bounds the inner
    loop (0 means ``min(dim, 256)``)."""
    if hvp_at is None:
        raise ValueError("newton_cg needs hvp_at (the curvature operator)")
    if diag is None:
        def diag(w):
            return torch.ones_like(w)

    max_cg = config.cg_max_iterations or min(int(w0.shape[0]), 256)
    n_hist = config.max_iterations + 1
    hv_hist = np.zeros(n_hist, np.float32)
    hg = np.zeros(n_hist, np.float32)
    hvalid = np.zeros(n_hist, bool)

    w = w0
    f, g = fun(w)
    # host-sync: the solver's one read a decision (counted in host_reads)
    f_h, gnorm0 = (f32(x) for x in torch.stack([f, _norm(g)]).tolist())
    reads = 1
    hv_hist[0], hg[0], hvalid[0] = f_h, gnorm0, True
    gnorm = gnorm0
    it = cg_total = 0
    active = gnorm0 != 0.0
    reason = (ConvergenceReason.NOT_CONVERGED if active
              else ConvergenceReason.GRADIENT_TOLERANCE)
    while active:
        mdiag = torch.clamp(diag(w), min=_DIAG_FLOOR)
        # Eisenstat-Walker forcing term: loose early, tight near the optimum.
        eta = np.minimum(f32(0.5), np.sqrt(gnorm / np.maximum(gnorm0, f32(1e-30))))
        step, cg_it, cg_reads = _pcg(hvp_at(w), g, mdiag, eta * gnorm, max_cg)
        cg_total += cg_it
        dir_deriv_t = torch.dot(g, step)
        finite, dir_deriv = torch.stack([  # host-sync: the solver's read
            torch.isfinite(step).all().to(step.dtype), dir_deriv_t]).tolist()
        reads += cg_reads + 1
        # A non-finite or non-descent CG result falls back to steepest descent.
        t = 1.0
        if not finite or dir_deriv >= 0:
            step = -g
            dir_deriv_t = -torch.dot(g, g)
            t = float(f32(1.0) / np.maximum(gnorm, f32(1.0)))
        halvings = 0
        while True:
            f_t, g_t = fun(w + t * step)
            ok = (f_t <= f + (_ARMIJO_C1 * t) * dir_deriv_t) & torch.isfinite(f_t)
            f_t_h, ok_h, gnorm_t = torch.stack(  # host-sync: the solver's read
                [f_t, ok.to(f_t.dtype), _norm(g_t)]).tolist()
            reads += 1
            if ok_h or halvings >= config.max_line_search:
                break
            t *= 0.5
            halvings += 1
        ls_ok = bool(ok_h)
        converged, reason = check_convergence(f_t_h, f_h, gnorm_t, gnorm0, config)
        if not ls_ok:
            reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
        it += 1
        hit_max = it >= config.max_iterations
        if hit_max and not (converged or not ls_ok):
            reason = ConvergenceReason.MAX_ITERATIONS
        active = not (converged or not ls_ok or hit_max)
        if ls_ok:  # on line-search failure keep the old iterate
            w, f, g, f_h, gnorm = w + t * step, f_t, g_t, f32(f_t_h), f32(gnorm_t)
            hv_hist[it], hg[it], hvalid[it] = f_h, gnorm, True

    # Full-step polish: two guarded Newton steps at a tight CG tolerance
    # keep contracting on the float32 gradient's zero after the line-searched
    # loop stalls on float32 function differences.
    for _ in range(2):
        mdiag = torch.clamp(diag(w), min=_DIAG_FLOOR)
        step, cg_it, cg_reads = _pcg(
            hvp_at(w), g, mdiag, f32(_POLISH_ETA) * gnorm, max_cg
        )
        cg_total += cg_it
        finite, step_norm, w_norm = torch.stack([  # host-sync: the solver's read
            torch.isfinite(step).all().to(step.dtype), _norm(step), _norm(w),
        ]).tolist()
        reads += cg_reads + 1
        if not (finite and step_norm <= 1e-3 * max(w_norm, 1.0)):
            continue
        f_p, g_p = fun(w + step)
        f_ph, g_finite, gnorm_p = torch.stack([  # host-sync: the solver's read
            f_p, torch.isfinite(g_p).all().to(f_p.dtype), _norm(g_p),
        ]).tolist()
        reads += 1
        if np.isfinite(f_ph) and g_finite:
            w, f, g, f_h, gnorm = w + step, f_p, g_p, f32(f_ph), f32(gnorm_p)
    return OptimizerResult(
        w=w, value=float(f_h), grad_norm=float(gnorm), iterations=it,
        converged=reason_is_converged(reason), reason=reason,
        history_value=hv_hist, history_grad_norm=hg, history_valid=hvalid,
        cg_iterations=cg_total, host_reads=reads,
    )


def _pcg_lanes(hv: Callable[[Tensor], Tensor], g: Tensor, mdiag: Tensor,
               tol: Tensor, max_cg: int, active: Tensor):
    """:func:`_pcg` on every lane at once (``g``, ``mdiag`` ``[B, d]``,
    ``tol`` ``[B]``), the reference's ``_pcg`` under ``vmap``: each step is
    masked on the lanes still iterating, and the steps run in blocks of
    :data:`lanes.CG_BLOCK`, one host read ("any lane still iterating") a
    block.  Inactive lanes do not iterate.  Returns ``(p, steps [B] int32,
    host reads)``."""
    r = -g
    z = r / mdiag
    rz = dot(r, z)
    p = torch.zeros_like(g)
    dvec = z
    it = torch.zeros(g.shape[0], dtype=torch.int32, device=g.device)
    done = ~active | (norm(r) <= tol) | ~torch.isfinite(rz)
    reads = 0
    while True:
        for _ in range(CG_BLOCK):
            hd = hv(dvec)
            dhd = dot(dvec, hd)
            neg = dhd <= 0.0
            alpha = rz / torch.where(neg, torch.ones_like(dhd), dhd)
            p_new = p + alpha[:, None] * dvec
            r_new = r - alpha[:, None] * hd
            z_new = r_new / mdiag
            rz_new = dot(r_new, z_new)
            beta = rz_new / torch.where(rz > 0.0, rz, torch.ones_like(rz))
            d_new = z_new + beta[:, None] * dvec
            # Negative curvature keeps the iterate so far, or on the first
            # step the preconditioned steepest-descent direction.
            p_new = torch.where(neg[:, None], torch.where((it == 0)[:, None], z, p), p_new)
            it_new = it + 1
            done_new = (neg | (norm(r_new) <= tol) | (it_new >= max_cg)
                        | ~torch.isfinite(rz_new))
            step = ~done
            p = torch.where(step[:, None], p_new, p)
            r = torch.where(step[:, None], r_new, r)
            z = torch.where(step[:, None], z_new, z)
            dvec = torch.where(step[:, None], d_new, dvec)
            rz = torch.where(step, rz_new, rz)
            it = torch.where(step, it_new, it)
            done = torch.where(step, done_new, done)
        reads += 1
        if bool(done.all()):
            return p, it, reads


def newton_cg_lanes(
    fun: Callable[[Tensor], tuple[Tensor, Tensor]],
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    hvp_at: Optional[Callable[[Tensor], Callable[[Tensor], Tensor]]] = None,
    diag: Optional[Callable[[Tensor], Tensor]] = None,
    values: Optional[Callable[[Tensor, Tensor, Tensor], Tensor]] = None,
) -> BatchedResult:
    """:func:`newton_cg` batched over lanes (``w`` ``[B, d]``, ``fun`` ->
    ``([B], [B, d])``), the reference's ``newton_cg`` under ``vmap``:
    ``hvp_at(w)`` returns ``v [B, d] -> H(w) v`` (for GLM lanes
    ``LaneObjective.hvp_operator``: the per-row curvature once per outer
    iteration, two lane matvecs a CG step, no ``[B, d, d]`` block);
    ``diag(w)`` the Jacobi diagonal ``[B, d]``; ``values`` as
    :func:`newton.newton`'s.  Per lane the Eisenstat-Walker tolerance, the
    steepest-descent fallback, the Armijo search of :func:`newton.
    damped_step` and the two polish steps at a tight CG tolerance.  Host
    reads: one a CG block and one a line-search block."""
    if hvp_at is None:
        raise ValueError("newton_cg_lanes needs hvp_at (the curvature operator)")
    if diag is None:
        def diag(w):
            return torch.ones_like(w)
    values = values or default_values(fun)
    max_cg = config.cg_max_iterations or min(int(w0.shape[1]), 256)
    f, g = fun(w0)
    w = w0
    lanes = LaneState(f, norm(g), config)
    cg = torch.zeros(w0.shape[0], dtype=torch.int32, device=w0.device)
    any_active = bool(lanes.active.any())
    reads, loops = 1, 0
    while any_active:
        loops += 1
        mdiag = torch.clamp_min(diag(w), _DIAG_FLOOR)
        gnorm = norm(g)
        # Eisenstat-Walker forcing term: loose early, tight near the optimum.
        eta = torch.clamp_max(
            torch.sqrt(gnorm / torch.clamp_min(lanes.gnorm0, 1e-30)), 0.5)
        step, cg_it, cg_reads = _pcg_lanes(hvp_at(w), g, mdiag, eta * gnorm,
                                           max_cg, lanes.active)
        cg = cg + cg_it
        w, f, g, any_active, ls_reads = damped_step(
            fun, values, lanes, w, f, g, step, ~torch.isfinite(step).all(dim=-1))
        reads += cg_reads + ls_reads

    # Full-step polish: two guarded Newton steps at a tight CG tolerance.
    every = torch.ones_like(lanes.active)
    for _ in range(2):
        mdiag = torch.clamp_min(diag(w), _DIAG_FLOOR)
        step, cg_it, cg_reads = _pcg_lanes(hvp_at(w), g, mdiag, _POLISH_ETA * norm(g),
                                           max_cg, every)
        cg = cg + cg_it
        reads += cg_reads
        w, f, g = polish_step(fun, w, f, g, step, every)
    return lanes.result(w, f, norm(g), loops, reads, cg)
