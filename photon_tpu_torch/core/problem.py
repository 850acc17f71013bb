"""Optimization problem: objective + optimizer + configuration.

Counterpart of ``photon_tpu/core/problem.py`` for the L-BFGS fit.  Other
optimizers and the coefficient variances raise ``NotImplementedError``:
they wait in ROADMAP.md queue 1, item 3.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig, OptimizerResult, lbfgs
from photon_tpu_torch.data.batch import Batch
from photon_tpu_torch.models.glm import Coefficients

_QUEUE = "ROADMAP.md queue 1, item 3 (optimizers)"


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Per-fit training configuration (optimizer + regularization +
    tolerances)."""

    optimizer: str = "lbfgs"
    regularization: RegularizationContext = RegularizationContext()
    optimizer_config: OptimizerConfig = OptimizerConfig()
    variance_computation: str = "none"

    def __post_init__(self):
        if self.optimizer.lower() != "lbfgs":
            raise NotImplementedError(
                f"optimizer {self.optimizer!r} is not ported yet; it waits in {_QUEUE}"
            )
        if self.variance_computation != "none":
            raise NotImplementedError(
                f"variance computation {self.variance_computation!r} is not "
                f"ported yet; it waits in {_QUEUE}"
            )
        if self.regularization.l1_weight > 0:
            raise ValueError(
                "L1/elastic-net regularization requires the OWL-QN optimizer, "
                f"which waits in {_QUEUE}"
            )


def _run_fit(objective: GlmObjective, batch: Batch, w0: torch.Tensor,
             cfg: OptimizerConfig) -> tuple[Coefficients, OptimizerResult]:
    result = lbfgs(lambda w: objective.value_and_grad(w, batch), w0, cfg)
    return Coefficients(means=result.w), result


class GlmOptimizationProblem:
    """Runs one GLM fit: ``run(batch, w0) -> (Coefficients, OptimizerResult)``
    on the batch's device."""

    def __init__(self, objective: GlmObjective, config: ProblemConfig):
        self.objective = objective
        self.config = config

    def run(
        self, batch: Batch, w0: Optional[torch.Tensor] = None,
        dim: Optional[int] = None,
    ) -> tuple[Coefficients, OptimizerResult]:
        device = batch.label.device
        if w0 is None:
            if dim is None:
                raise ValueError("need w0 or dim")
            w0 = torch.zeros(dim, dtype=torch.float32, device=device)
        if w0.device != device:
            raise ValueError(f"w0 is on {w0.device}, the batch on {device}")
        return _run_fit(self.objective, batch, w0, self.config.optimizer_config)
