"""Pointwise GLM loss functions on tensors.

Counterpart of ``photon_tpu/core/losses.py``.  Each loss is defined on the
margin ``z = w . x + offset`` and a label, and exposes the value plus the
first and second derivatives in the margin (``d1``, ``d2``) and the mean
(inverse link).  The derivatives are analytic: the port never
differentiates through a loss, so no autograd function is needed.

Label conventions: binary losses take labels in {0, 1} (smoothed hinge maps
them to +-1 internally), Poisson takes non-negative counts, squared loss
takes real labels.  ``code`` is the loss's index in the CUDA kernels'
templated switch (``ops/csrc/fused_sparse.cu``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """A pointwise loss l(z, y) with derivatives in the margin z."""

    name: str
    code: int
    value: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    mean: Callable[[Tensor], Tensor]


def _logistic_value(z: Tensor, y: Tensor) -> Tensor:
    # log(1 + e^z) - y*z, computed stably as max(z,0) + log1p(e^-|z|) - y*z.
    return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-torch.abs(z))) - y * z


def _logistic_d1(z: Tensor, y: Tensor) -> Tensor:
    # The exact derivative, also at z = 0 where the stable form's max/abs
    # kinks meet (every margin is 0 at w0 = 0): sigmoid(0) - y.
    return torch.sigmoid(z) - y


def _logistic_d2(z: Tensor, y: Tensor) -> Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 - s)


LOGISTIC = PointwiseLoss(
    name="logistic", code=0, value=_logistic_value, d1=_logistic_d1,
    d2=_logistic_d2, mean=torch.sigmoid,
)


def _squared_value(z: Tensor, y: Tensor) -> Tensor:
    d = z - y
    return 0.5 * d * d


SQUARED = PointwiseLoss(
    name="squared", code=1, value=_squared_value,
    d1=lambda z, y: z - y,
    d2=lambda z, y: torch.ones_like(z),
    mean=lambda z: z,
)


# float32 exp overflows at z ~ 88, and the objective sums e^z over rows, so
# the rate is capped at e^30; past the cap the negative log-likelihood
# continues linearly at the capped slope, and d1/d2 are the exact
# derivatives of that linearized objective (d2 = 0 past the cap).
_POISSON_MAX_EXPONENT = 30.0


def _poisson_exp(z: Tensor) -> Tensor:
    return torch.exp(torch.clamp_max(z, _POISSON_MAX_EXPONENT))


def _poisson_value(z: Tensor, y: Tensor) -> Tensor:
    ez = _poisson_exp(z)
    return ez + ez * torch.clamp_min(z - _POISSON_MAX_EXPONENT, 0.0) - y * z


def _poisson_d2(z: Tensor, y: Tensor) -> Tensor:
    return torch.where(
        z <= _POISSON_MAX_EXPONENT, _poisson_exp(z), torch.zeros_like(z)
    )


POISSON = PointwiseLoss(
    name="poisson", code=2, value=_poisson_value,
    d1=lambda z, y: _poisson_exp(z) - y,
    d2=_poisson_d2, mean=_poisson_exp,
)


def _hinge_parts(z: Tensor, y01: Tensor) -> tuple[Tensor, Tensor]:
    y = 2.0 * y01 - 1.0
    return y, y * z


def _smoothed_hinge_value(z: Tensor, y01: Tensor) -> Tensor:
    # Rennie's smoothed hinge: 1/2 - t for t<=0, (1-t)^2/2 for 0<t<1, 0 for t>=1.
    _, t = _hinge_parts(z, y01)
    zero = torch.zeros_like(t)
    return torch.where(
        t <= 0.0, 0.5 - t, torch.where(t < 1.0, 0.5 * (1.0 - t) ** 2, zero)
    )


def _smoothed_hinge_d1(z: Tensor, y01: Tensor) -> Tensor:
    y, t = _hinge_parts(z, y01)
    dt = torch.where(
        t <= 0.0, -torch.ones_like(t),
        torch.where(t < 1.0, t - 1.0, torch.zeros_like(t)),
    )
    return y * dt


def _smoothed_hinge_d2(z: Tensor, y01: Tensor) -> Tensor:
    _, t = _hinge_parts(z, y01)
    return ((t > 0.0) & (t < 1.0)).to(z.dtype)


SMOOTHED_HINGE = PointwiseLoss(
    name="smoothed_hinge", code=3, value=_smoothed_hinge_value,
    d1=_smoothed_hinge_d1, d2=_smoothed_hinge_d2,
    mean=lambda z: (z > 0.0).to(z.dtype),
)

LOSSES: dict[str, PointwiseLoss] = {
    loss.name: loss for loss in (LOGISTIC, SQUARED, POISSON, SMOOTHED_HINGE)
}

TASK_TO_LOSS: dict[str, PointwiseLoss] = {
    "logistic_regression": LOGISTIC,
    "linear_regression": SQUARED,
    "poisson_regression": POISSON,
    "smoothed_hinge_loss_linear_svm": SMOOTHED_HINGE,
}

# Tasks whose labels live in {0, 1} (LIBSVM {-1, +1} labels are mapped).
BINARY_TASKS = ("logistic_regression", "smoothed_hinge_loss_linear_svm")


def get_loss(name: str) -> PointwiseLoss:
    key = name.lower()
    if key in LOSSES:
        return LOSSES[key]
    if key in TASK_TO_LOSS:
        return TASK_TO_LOSS[key]
    raise KeyError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
