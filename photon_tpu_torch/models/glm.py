"""Generalized linear models.

Counterpart of ``photon_tpu/models/glm.py``: a model is coefficients (means
plus optional variances) and the task's loss; ``compute_score`` is the raw
margin and ``predict`` applies the mean function.  :func:`from_numpy`
carries a model trained by the JAX package (its arrays as numpy) across.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from photon_tpu_torch.core.losses import PointwiseLoss, get_loss
from photon_tpu_torch.data.batch import Batch, margins
from photon_tpu_torch.device import resolve_device


class Coefficients(NamedTuple):
    """Coefficient means + optional per-coefficient variances."""

    means: torch.Tensor
    variances: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    coefficients: Coefficients
    loss: PointwiseLoss
    task_type: str = "custom"

    def compute_score(self, batch: Batch) -> torch.Tensor:
        return margins(self.coefficients.means, batch)

    def predict(self, batch: Batch) -> torch.Tensor:
        return self.loss.mean(self.compute_score(batch))


_TASK_LOSSES = {
    "logistic_regression": "logistic",
    "linear_regression": "squared",
    "poisson_regression": "poisson",
    "smoothed_hinge_loss_linear_svm": "smoothed_hinge",
}


def model_for_task(task_type: str, coefficients: Coefficients) -> GeneralizedLinearModel:
    task = task_type.lower()
    if task not in _TASK_LOSSES:
        raise KeyError(
            f"unknown task type {task_type!r}; available: {sorted(_TASK_LOSSES)}"
        )
    return GeneralizedLinearModel(coefficients, get_loss(_TASK_LOSSES[task]), task)


def from_numpy(
    means: np.ndarray, variances: Optional[np.ndarray], task: str, device=None
) -> GeneralizedLinearModel:
    """A model from coefficient arrays (e.g. ``np.asarray`` of a JAX
    model's ``coefficients.means``/``variances``) on ``device``."""
    dev = resolve_device(device)

    def put(a):
        return None if a is None else torch.tensor(
            np.asarray(a, np.float32), device=dev
        )

    return model_for_task(task, Coefficients(put(means), put(variances)))
