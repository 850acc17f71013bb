"""Optimizers of the port: L-BFGS, TRON and Newton-CG, and the damped
Newton batched over lanes that solves GAME's random-effect entities
(``newton``).  OWL-QN waits in ROADMAP.md queue 1, item 3."""

from photon_tpu_torch.core.optimizers.base import (
    ConvergenceReason,
    OptimizationStatesTracker,
    OptimizerConfig,
    OptimizerResult,
)
from photon_tpu_torch.core.optimizers.lbfgs import lbfgs
from photon_tpu_torch.core.optimizers.newton_cg import newton_cg
from photon_tpu_torch.core.optimizers.tron import tron

__all__ = [
    "ConvergenceReason",
    "OptimizationStatesTracker",
    "OptimizerConfig",
    "OptimizerResult",
    "lbfgs",
    "newton_cg",
    "tron",
]
