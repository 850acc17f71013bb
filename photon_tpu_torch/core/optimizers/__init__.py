"""Optimizers of the port (L-BFGS in this slice; OWL-QN, TRON and the
Newton solvers wait in ROADMAP.md queue 1, item 3)."""

from photon_tpu_torch.core.optimizers.base import (
    ConvergenceReason,
    OptimizationStatesTracker,
    OptimizerConfig,
    OptimizerResult,
)
from photon_tpu_torch.core.optimizers.lbfgs import lbfgs

__all__ = [
    "ConvergenceReason",
    "OptimizationStatesTracker",
    "OptimizerConfig",
    "OptimizerResult",
    "lbfgs",
]
