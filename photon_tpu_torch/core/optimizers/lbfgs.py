"""L-BFGS as a Python loop over device tensors.

Counterpart of ``photon_tpu/core/optimizers/lbfgs.py``: the same two-loop
recursion over a ring buffer of (s, y) pairs, the same Armijo backtracking
line search (halving from ``t0``), the same cautious pair update, stopping
rules and history, and the same two-step gradient polish at the end.

Host syncs: one per objective evaluation.  Each line-search trial reads one
packed vector back — the trial value, the Armijo verdict, ``s.y``, ``y.y``
and the new gradient norm — and the host makes every decision from it (accept
or halve, store the pair, converge or stop).  An iteration whose first step
is accepted therefore costs exactly one sync; the direction, the trial point
and the pair update stay on the device.  The polish costs up to two syncs
per step.
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
from photon_tpu_torch.core.optimizers.lanes import (
    BatchedResult,
    LaneState,
    armijo_lanes,
    default_values,
    dot,
    norm,
    polish_step,
)

Tensor = torch.Tensor

_ARMIJO_C1 = 1e-4
_PAIR_EPS = 1e-10


class _History:
    """Ring buffer of (s, y) pairs; slot validity and rho live on the host."""

    def __init__(self, m: int, w0: Tensor):
        self.m = m
        self.S = torch.zeros(m, w0.shape[0], dtype=w0.dtype, device=w0.device)
        self.Y = torch.zeros_like(self.S)
        self.rho = [0.0] * m
        self.num_pairs = 0
        self.insert_pos = 0
        self.gamma = 1.0

    def push(self, s: Tensor, y: Tensor, sy: float, yy: float) -> None:
        self.S[self.insert_pos] = s
        self.Y[self.insert_pos] = y
        self.rho[self.insert_pos] = float(np.float32(1.0) / np.float32(sy))
        self.num_pairs = min(self.num_pairs + 1, self.m)
        self.insert_pos = (self.insert_pos + 1) % self.m
        self.gamma = float(np.float32(sy) / np.maximum(np.float32(yy), np.float32(1e-30)))

    def direction(self, g: Tensor) -> Tensor:
        """``-H g`` by the two-loop recursion (newest pair first)."""
        m, q = self.m, g
        alphas = [None] * m
        for j in range(self.num_pairs):
            idx = (self.insert_pos - 1 - j) % m
            alphas[idx] = self.rho[idx] * torch.dot(self.S[idx], q)
            q = q - alphas[idx] * self.Y[idx]
        r = self.gamma * q
        for j in range(self.num_pairs):
            idx = (self.insert_pos - self.num_pairs + j) % m
            beta = self.rho[idx] * torch.dot(self.Y[idx], r)
            r = r + (alphas[idx] - beta) * self.S[idx]
        return -r


def lbfgs(
    fun: Callable[[Tensor], tuple[Tensor, Tensor]],
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
) -> OptimizerResult:
    """Minimize ``fun`` (returning (value, grad) tensors) from ``w0``."""
    f32 = np.float32
    n_hist = config.max_iterations + 1
    hv = np.zeros(n_hist, np.float32)
    hg = np.zeros(n_hist, np.float32)
    hvalid = np.zeros(n_hist, bool)

    w = w0
    f, g = fun(w)
    # host-sync: the solver's one read a decision (counted in host_reads)
    f_h, gnorm0 = torch.stack([f, torch.linalg.vector_norm(g)]).tolist()
    reads = evaluations = 1
    gnorm_h = gnorm0
    hv[0], hg[0], hvalid[0] = f_h, gnorm0, True
    hist = _History(config.history_length, w0)
    # The gradient test is relative to ||g0||: at w0 it fires only for an
    # exactly-zero gradient.
    active = gnorm0 != 0.0
    reason = (
        ConvergenceReason.NOT_CONVERGED if active
        else ConvergenceReason.GRADIENT_TOLERANCE
    )
    it = 0
    while active:
        dvec = hist.direction(g)
        dir_deriv = torch.dot(g, dvec)
        # Steepest descent when the direction is not a descent direction.
        bad = dir_deriv >= 0.0
        dvec = torch.where(bad, -g, dvec)
        dir_deriv = torch.where(bad, -torch.dot(g, g), dir_deriv)
        t = 1.0 if hist.num_pairs else float(
            f32(1.0) / np.maximum(f32(gnorm_h), f32(1.0))
        )

        def trial(t: float):
            w_t = w + t * dvec
            f_t, g_t = fun(w_t)
            ok = (f_t <= f + (_ARMIJO_C1 * t) * dir_deriv) & torch.isfinite(f_t)
            s, y = w_t - w, g_t - g
            packed = torch.stack([  # host-sync: the solver's read
                f_t, ok.to(f_t.dtype), torch.dot(s, y), torch.dot(y, y),
                torch.linalg.vector_norm(g_t),
            ]).tolist()
            return w_t, f_t, g_t, s, y, packed

        w_t, f_t, g_t, s, y, packed = trial(t)
        halvings = 0
        while not packed[1] and halvings < config.max_line_search:
            t *= 0.5
            w_t, f_t, g_t, s, y, packed = trial(t)
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
            w, f, g, f_h, gnorm_h = w_t, f_t, g_t, f_new, gnorm_new
            hv[it], hg[it], hvalid[it] = f_h, gnorm_h, True

    # Full-step polish: the line-searched loop stops where f32 function
    # differences round to zero; the quasi-Newton map keeps contracting the
    # gradient past that.  Two unsearched full steps, each kept only when
    # small relative to the iterate, finite, and not growing the gradient.
    for _ in range(2):
        step = hist.direction(g)
        finite, step_norm, w_norm = torch.stack([  # host-sync: the solver's read
            torch.isfinite(step).all().to(step.dtype),
            torch.linalg.vector_norm(step), torch.linalg.vector_norm(w),
        ]).tolist()
        reads += 1
        if not (finite and step_norm <= 1e-3 * max(w_norm, 1.0)):
            continue
        w_p = w + step
        f_p, g_p = fun(w_p)
        f_ph, g_finite, gnorm_p = torch.stack([  # host-sync: the solver's read
            f_p, torch.isfinite(g_p).all().to(f_p.dtype),
            torch.linalg.vector_norm(g_p),
        ]).tolist()
        reads += 1
        evaluations += 1
        if np.isfinite(f_ph) and g_finite and gnorm_p <= gnorm_h:
            w, f, g, f_h, gnorm_h = w_p, f_p, g_p, f_ph, gnorm_p
    return OptimizerResult(
        w=w, value=f_h, grad_norm=gnorm_h, iterations=it,
        converged=reason_is_converged(reason), reason=reason,
        history_value=hv, history_grad_norm=hg, history_valid=hvalid,
        host_reads=reads, evaluations=evaluations,
    )


class LaneHistory:
    """Per-lane ring buffers of (s, y) pairs (``S``, ``Y`` ``[B, m, d]``,
    ``rho`` ``[B, m]``), the reference's L-BFGS state under ``vmap``: each
    lane stores its own pairs at its own insert position."""

    def __init__(self, m: int, w0: Tensor):
        bsz, d = w0.shape
        dev = w0.device
        self.m = m
        self.S = torch.zeros(bsz, m, d, dtype=w0.dtype, device=dev)
        self.Y = torch.zeros_like(self.S)
        self.rho = torch.zeros(bsz, m, dtype=w0.dtype, device=dev)
        self.num_pairs = torch.zeros(bsz, dtype=torch.int64, device=dev)
        self.insert_pos = torch.zeros(bsz, dtype=torch.int64, device=dev)
        self.gamma = torch.ones(bsz, dtype=w0.dtype, device=dev)
        self.lanes = torch.arange(bsz, device=dev)

    def push(self, s: Tensor, y: Tensor, ok: Tensor) -> None:
        """Store ``(s, y)`` on the lanes where ``ok`` and ``s.y`` is
        positive (the cautious update)."""
        sy = torch.sum(s * y, dim=-1)
        ok = ok & (sy > _PAIR_EPS)
        lanes, pos = self.lanes, self.insert_pos
        self.S[lanes, pos] = torch.where(ok[:, None], s, self.S[lanes, pos])
        self.Y[lanes, pos] = torch.where(ok[:, None], y, self.Y[lanes, pos])
        self.rho[lanes, pos] = torch.where(
            ok, 1.0 / torch.where(ok, sy, torch.ones_like(sy)), self.rho[lanes, pos])
        self.num_pairs = torch.where(ok, torch.clamp_max(self.num_pairs + 1, self.m),
                                     self.num_pairs)
        self.insert_pos = torch.where(ok, (pos + 1) % self.m, pos)
        self.gamma = torch.where(
            ok, sy / torch.clamp_min(torch.sum(y * y, dim=-1), 1e-30), self.gamma)

    def direction(self, g: Tensor) -> Tensor:
        """``-H g`` per lane by the two-loop recursion.  The ring buffers
        are first gathered newest first, so step ``j`` of both loops reads
        slot ``j`` of every lane; a slot past a lane's pair count adds an
        exact zero, and the valid slots run in the reference's order."""
        m, d = self.m, g.shape[1]
        order = (self.insert_pos[:, None] - 1
                 - torch.arange(m, device=g.device)[None, :]) % m
        S = self.S.gather(1, order[..., None].expand(-1, -1, d))
        Y = self.Y.gather(1, order[..., None].expand(-1, -1, d))
        rho = self.rho.gather(1, order)
        zero = torch.zeros_like(self.gamma)
        q, alphas = g, []
        for j in range(m):  # newest first
            valid = j < self.num_pairs
            alpha = torch.where(valid, rho[:, j] * torch.sum(S[:, j] * q, dim=-1), zero)
            q = q - alpha[:, None] * Y[:, j]
            alphas.append(alpha)
        r = self.gamma[:, None] * q
        for j in range(m - 1, -1, -1):  # oldest first
            valid = j < self.num_pairs
            beta = torch.where(valid, rho[:, j] * torch.sum(Y[:, j] * r, dim=-1), zero)
            r = r + torch.where(valid, alphas[j] - beta, zero)[:, None] * S[:, j]
        return -r


def lbfgs_lanes(
    fun: Callable[[Tensor], tuple[Tensor, Tensor]],
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    values: Callable[[Tensor, Tensor, Tensor], Tensor] | None = None,
) -> BatchedResult:
    """:func:`lbfgs` batched over lanes (``w`` ``[B, d]``, ``fun`` ->
    ``([B], [B, d])``), the reference's ``lbfgs`` under ``vmap`` (GAME's
    ``vmapped`` entity route): per lane the two-loop direction over its own
    ring buffer, the steepest-descent fallback, ``t0 = 1 / max(|g|, 1)``
    until the first pair, the Armijo search of :func:`lanes.armijo_lanes`
    (``values`` as :func:`newton.newton`'s), the cautious pair update and
    the two polish steps.  Returns a :class:`lanes.BatchedResult`; host
    reads: one a line-search block."""
    values = values or default_values(fun)
    f, g = fun(w0)
    w = w0
    lanes = LaneState(f, norm(g), config)
    hist = LaneHistory(config.history_length, w0)
    any_active = bool(lanes.active.any())
    reads, loops = 1, 0
    while any_active:
        loops += 1
        dvec = hist.direction(g)
        dir_deriv = dot(g, dvec)
        # Steepest descent where the direction is not a descent direction.
        bad = dir_deriv >= 0.0
        dvec = torch.where(bad[:, None], -g, dvec)
        dir_deriv = torch.where(bad, -dot(g, g), dir_deriv)
        t0 = torch.where(hist.num_pairs == 0, 1.0 / torch.clamp_min(norm(g), 1.0),
                         torch.ones_like(dir_deriv))

        def trial(ts):
            return values(w, dvec, ts), (_ARMIJO_C1 * ts) * dir_deriv[:, None]

        def finish(t, ls_ok, f_try, level):
            w_t = w + t[:, None] * dvec
            f_t, g_t = fun(w_t)
            decided = lanes.decide(f_try, level, norm(g_t), ls_ok)
            return (w_t, f_t, g_t, ls_ok, decided), decided[1].any()

        (w_t, f_t, g_t, ls_ok, decided), any_active, block_reads = armijo_lanes(
            trial, t0, lanes.active, config.max_line_search + 1, finish)
        reads += block_reads
        hist.push(w_t - w, g_t - g, lanes.active & ls_ok)
        keep = decided[3]  # on a failed search the old iterate stays
        w = torch.where(keep[:, None], w_t, w)
        f = torch.where(keep, f_t, f)
        g = torch.where(keep[:, None], g_t, g)
        lanes.commit(decided, f, norm(g))

    # Full-step polish: two unsearched steps of the final quasi-Newton map,
    # each kept per lane only when small, finite and not growing |g|.
    every = torch.ones_like(lanes.active)
    for _ in range(2):
        w, f, g = polish_step(fun, w, f, g, hist.direction(g), every, no_growth=True)
    return lanes.result(w, f, norm(g), loops, reads)
