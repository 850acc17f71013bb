"""Optimization problem: objective + optimizer + variances, bound together.

Counterpart of ``photon_tpu/core/problem.py`` for the L-BFGS, TRON and
Newton-CG fits and the SIMPLE and FULL coefficient variances.  OWL-QN (and
with it L1 and the elastic net) raises ``NotImplementedError``: it waits in
ROADMAP.md queue 1, item 3.  The reference's jitted solver cache has no
counterpart: every fit runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.core.optimizers import (
    OptimizerConfig,
    OptimizerResult,
    lbfgs,
    newton_cg,
    tron,
)
from photon_tpu_torch.data.batch import Batch
from photon_tpu_torch.models.glm import Coefficients

_QUEUE = "ROADMAP.md queue 1, item 3 (optimizers)"
OPTIMIZERS = ("lbfgs", "tron", "newton_cg")
VARIANCE_TYPES = ("none", "simple", "full")


def _optimizer_name(name: str) -> str:
    name = name.lower()
    name = {"l-bfgs": "lbfgs", "newton-cg": "newton_cg"}.get(name, name)
    if name in ("owlqn", "owl-qn"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet; it waits in {_QUEUE}"
        )
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; available: {', '.join(OPTIMIZERS)}")
    return name


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Per-fit training configuration (optimizer + regularization +
    tolerances + variance kind)."""

    optimizer: str = "lbfgs"
    regularization: RegularizationContext = RegularizationContext()
    optimizer_config: OptimizerConfig = OptimizerConfig()
    variance_computation: str = "none"

    def __post_init__(self):
        _optimizer_name(self.optimizer)
        if self.variance_computation not in VARIANCE_TYPES:
            raise ValueError(
                f"unknown variance computation {self.variance_computation!r}"
            )
        if self.regularization.l1_weight > 0:
            raise ValueError(
                "L1/elastic-net regularization requires the OWL-QN optimizer, "
                f"which waits in {_QUEUE}"
            )


def hvp_at_for(objective: GlmObjective, batch: Batch):
    """Curvature-operator factory ``w -> (v -> H(w) v)`` for TRON and
    Newton-CG: ``hvp_operator`` computes the per-row curvature once per
    outer iteration, so each CG step is two matvecs."""
    return lambda w: objective.hvp_operator(w, batch)


def _run_fit(objective: GlmObjective, batch: Batch, w0: torch.Tensor,
             optimizer: str, cfg: OptimizerConfig,
             variance: str) -> tuple[Coefficients, OptimizerResult]:
    def fun(w):
        return objective.value_and_grad(w, batch)

    if optimizer == "tron":
        result = tron(fun, w0, cfg, hvp_at=hvp_at_for(objective, batch))
    elif optimizer == "newton_cg":
        result = newton_cg(
            fun, w0, cfg, hvp_at=hvp_at_for(objective, batch),
            diag=lambda w: objective.hessian_diagonal(w, batch),
        )
    else:
        result = lbfgs(fun, w0, cfg)
    variances = _compute_variances(objective, variance, result.w, batch)
    return Coefficients(means=result.w, variances=variances), result


def _compute_variances(objective: GlmObjective, kind: str, w: torch.Tensor,
                       batch: Batch) -> Optional[torch.Tensor]:
    """Per-coefficient variances at the optimum: SIMPLE = 1/diag(H); FULL =
    diag(H^-1), by a Cholesky solve of the dense Hessian up to
    ``FULL_DENSE_MAX_DIM`` and by the matrix-free Hutchinson estimate above
    it (``core/variance.py``)."""
    if kind == "none":
        return None
    if kind == "simple":
        return 1.0 / torch.clamp(objective.hessian_diagonal(w, batch), min=1e-12)
    from photon_tpu_torch.core import variance

    d = int(w.shape[0])
    if d > variance.FULL_DENSE_MAX_DIM:
        return variance.hutchinson_diag_inverse(
            hvp_at_for(objective, batch)(w), dim=d, device=w.device
        )
    h = objective.hessian_matrix(w, batch)
    # A tiny jitter keeps the factorization defined on flat directions
    # (unreached features with zero curvature).
    eye = torch.eye(d, dtype=h.dtype, device=h.device)
    inv = torch.cholesky_inverse(torch.linalg.cholesky(h + 1e-9 * eye))
    return torch.clamp(torch.diagonal(inv), min=0.0)


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
        return _run_fit(
            self.objective, batch, w0, _optimizer_name(self.config.optimizer),
            self.config.optimizer_config, self.config.variance_computation,
        )

    def compute_variances(self, w: torch.Tensor, batch: Batch) -> Optional[torch.Tensor]:
        return _compute_variances(
            self.objective, self.config.variance_computation, w, batch
        )
