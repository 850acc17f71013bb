"""Shared optimizer types: config, result, convergence reasons, states tracker.

Counterpart of ``photon_tpu/core/optimizers/base.py``.  The port's
optimizers are Python loops over device tensors that read a few scalars back
each iteration, so the per-iteration history lives on the host as numpy
arrays of length ``max_iterations + 1`` with a validity mask, the same shape
as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


class ConvergenceReason:
    """Integer codes for why optimization stopped."""

    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    FUNCTION_VALUES_TOLERANCE = 2
    GRADIENT_TOLERANCE = 3
    OBJECTIVE_NOT_IMPROVING = 4  # line search failed to find descent

    NAMES = {
        0: "NOT_CONVERGED",
        1: "MAX_ITERATIONS",
        2: "FUNCTION_VALUES_TOLERANCE",
        3: "GRADIENT_TOLERANCE",
        4: "OBJECTIVE_NOT_IMPROVING",
    }


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """``tolerance`` is the relative function-value tolerance and
    ``gradient_tolerance`` the relative gradient-norm tolerance
    (``||g|| <= gtol * max(1, ||g0||)``), both checked each iteration.
    ``history_length`` is the L-BFGS memory; ``max_line_search`` bounds the
    backtracking halvings.  ``cg_max_iterations`` bounds the inner CG of
    TRON and Newton-CG (0 means ``min(dim, 100)`` for TRON, LIBLINEAR's
    constant, and ``min(dim, 256)`` for Newton-CG); ``cg_tolerance`` is
    TRON's relative CG tolerance."""

    max_iterations: int = 100
    tolerance: float = 1e-7
    gradient_tolerance: float = 1e-6
    history_length: int = 10
    max_line_search: int = 25
    cg_max_iterations: int = 0
    cg_tolerance: float = 0.1


class OptimizerResult(NamedTuple):
    """Final state plus per-iteration history (host arrays of length
    ``max_iterations + 1``; entry 0 is the initial point, entries not marked
    in ``history_valid`` are unused).  ``cg_iterations`` is the total inner
    CG work of the solvers that have an inner loop (TRON, Newton-CG), None
    elsewhere; ``host_reads`` counts the device-to-host reads the loop
    made to take its decisions."""

    w: torch.Tensor
    value: float
    grad_norm: float
    iterations: int
    converged: bool
    reason: int
    history_value: np.ndarray
    history_grad_norm: np.ndarray
    history_valid: np.ndarray
    cg_iterations: Optional[int] = None
    host_reads: Optional[int] = None


class OptimizationStatesTracker:
    """Host-side view of a run's per-iteration history: iterate for
    (iteration, value, gradient norm), query the convergence reason."""

    def __init__(self, result: OptimizerResult, wall_time_s: Optional[float] = None):
        valid = np.asarray(result.history_valid)
        self.values = np.asarray(result.history_value)[valid]
        self.grad_norms = np.asarray(result.history_grad_norm)[valid]
        self.iterations = int(result.iterations)
        self.converged = bool(result.converged)
        self.reason_code = int(result.reason)
        self.wall_time_s = wall_time_s

    @property
    def convergence_reason(self) -> str:
        return ConvergenceReason.NAMES.get(self.reason_code, "UNKNOWN")

    def __iter__(self):
        return iter(zip(range(len(self.values)), self.values, self.grad_norms))

    def states(self) -> list:
        """JSON-ready per-iteration trace ``[[value, |grad|], ...]``."""
        return [[float(v), float(g)] for _, v, g in self]

    def summary(self) -> str:
        lines = [
            f"iterations={self.iterations} converged={self.converged} "
            f"reason={self.convergence_reason}"
            + (f" wall={self.wall_time_s:.3f}s" if self.wall_time_s is not None else "")
        ]
        for i, v, g in self:
            lines.append(f"  iter {i:4d}  f={v:.10g}  |g|={g:.6g}")
        return "\n".join(lines)


def reason_is_converged(reason: int) -> bool:
    """True only for a tolerance met, not for running out of iterations or a
    failed line search."""
    return reason in (
        ConvergenceReason.FUNCTION_VALUES_TOLERANCE,
        ConvergenceReason.GRADIENT_TOLERANCE,
    )


def check_convergence(
    f_new: float, f_old: float, gnorm: float, gnorm0: float,
    config: OptimizerConfig,
) -> tuple[bool, int]:
    """Return (converged, reason) per the reference's tolerance semantics,
    in float32 arithmetic like the reference's on-device check."""
    f32 = np.float32
    rel_improve = np.abs(f32(f_old) - f32(f_new)) / np.maximum(
        np.abs(f32(f_old)), f32(1e-12)
    )
    f_conv = bool(rel_improve <= f32(config.tolerance))
    g_conv = bool(
        f32(gnorm) <= f32(config.gradient_tolerance) * np.maximum(f32(gnorm0), f32(1.0))
    )
    if g_conv:
        return True, ConvergenceReason.GRADIENT_TOLERANCE
    if f_conv:
        return True, ConvergenceReason.FUNCTION_VALUES_TOLERANCE
    return False, ConvergenceReason.NOT_CONVERGED
