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
    f_h, gnorm0 = torch.stack([f, torch.linalg.vector_norm(g)]).tolist()
    reads = 1
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
            packed = torch.stack([
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
        finite, step_norm, w_norm = torch.stack([
            torch.isfinite(step).all().to(step.dtype),
            torch.linalg.vector_norm(step), torch.linalg.vector_norm(w),
        ]).tolist()
        reads += 1
        if not (finite and step_norm <= 1e-3 * max(w_norm, 1.0)):
            continue
        w_p = w + step
        f_p, g_p = fun(w_p)
        f_ph, g_finite, gnorm_p = torch.stack([
            f_p, torch.isfinite(g_p).all().to(f_p.dtype),
            torch.linalg.vector_norm(g_p),
        ]).tolist()
        reads += 1
        if np.isfinite(f_ph) and g_finite and gnorm_p <= gnorm_h:
            w, f, g, f_h, gnorm_h = w_p, f_p, g_p, f_ph, gnorm_p
    return OptimizerResult(
        w=w, value=f_h, grad_norm=gnorm_h, iterations=it,
        converged=reason_is_converged(reason), reason=reason,
        history_value=hv, history_grad_norm=hg, history_valid=hvalid,
        host_reads=reads,
    )
