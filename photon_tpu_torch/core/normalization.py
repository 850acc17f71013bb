"""Feature normalization applied inside the objective.

Counterpart of ``photon_tpu/core/normalization.py``.  The optimizer works in
the normalized feature space while the data and the stored model stay in
the original space, through the identity

    (x - shift) * factor . w  ==  x . (factor * w) - (shift * factor) . w

so a sparse batch is never densified: normalization costs one elementwise
product on the coefficients and one scalar correction per example.

Types: ``none``, ``scale_with_standard_deviation``,
``scale_with_max_magnitude`` and ``standardization`` (scale by the standard
deviation and shift by the mean; needs an intercept, which keeps factor 1
and shift 0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.core.stats import BasicStatisticalSummary

Tensor = torch.Tensor

NORMALIZATION_TYPES = (
    "none",
    "scale_with_standard_deviation",
    "scale_with_max_magnitude",
    "standardization",
)


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """``factors`` and ``shifts`` (``[d]``, either may be None) in the
    original feature space; ``intercept_id`` names the intercept feature,
    which is never scaled or shifted and takes the margin correction when a
    model returns to the original space."""

    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None
    intercept_id: Optional[int] = None

    def factors_or_ones(self, dim: int, device=None) -> Tensor:
        if self.factors is None:
            return torch.ones(dim, device=device)
        return self.factors

    def to(self, device) -> "NormalizationContext":
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return NormalizationContext(move(self.factors), move(self.shifts),
                                    self.intercept_id)

    def effective_coefficients(self, w: Tensor) -> tuple[Tensor, Tensor]:
        """``(factor * w, (shift * factor) . w)`` for the margin identity."""
        w_eff = w if self.factors is None else w * self.factors
        if self.shifts is None:
            correction = torch.zeros((), dtype=w.dtype, device=w.device)
        else:
            correction = torch.dot(self.shifts, w_eff)
        return w_eff, correction

    def _require_intercept(self) -> int:
        if self.intercept_id is None:
            raise ValueError("shift-based normalization requires an intercept")
        return self.intercept_id

    def model_to_original_space(self, w: Tensor) -> Tensor:
        """Coefficients learned in the normalized space, in the original
        one: ``factor * w``, the intercept less ``(shift * factor) . w``."""
        w_eff, correction = self.effective_coefficients(w)
        if self.shifts is not None:
            w_eff = w_eff.clone()
            w_eff[self._require_intercept()] -= correction
        return w_eff

    def model_to_normalized_space(self, w_orig: Tensor) -> Tensor:
        """The inverse of :meth:`model_to_original_space` (warm starts from a
        stored model); exact because the intercept has factor 1, shift 0."""
        w = w_orig / self.factors_or_ones(w_orig.shape[0], w_orig.device)
        if self.shifts is not None:
            w[self._require_intercept()] += torch.dot(self.shifts, w_orig)
        return w

    def variances_to_original_space(self, variances: Optional[Tensor]) -> Optional[Tensor]:
        """Per-coefficient variances alongside :meth:`model_to_original_space`
        under the diagonal-posterior approximation: ``factor^2 * var``, and the
        intercept adds ``sum((shift * factor)^2 * var)``."""
        if variances is None:
            return None
        f = self.factors_or_ones(variances.shape[0], variances.device)
        var = variances * f * f
        if self.shifts is not None:
            sf = self.shifts * f  # 0 at the intercept (its shift is 0)
            var[self._require_intercept()] += torch.dot(sf * sf, variances)
        return var

    @classmethod
    def build(
        cls,
        norm_type: str,
        summary: BasicStatisticalSummary,
        intercept_id: Optional[int] = None,
    ) -> Optional["NormalizationContext"]:
        """The context of one normalization type from a feature summary
        (``None`` for ``none``)."""
        norm_type = norm_type.lower()
        if norm_type not in NORMALIZATION_TYPES:
            raise ValueError(f"unknown normalization type {norm_type!r}")
        if norm_type == "none":
            return None
        shifts = None
        if norm_type == "scale_with_max_magnitude":
            factors = _safe_inverse(torch.maximum(summary.max.abs(), summary.min.abs()))
        else:
            factors = _safe_inverse(torch.sqrt(summary.variance))
        if norm_type == "standardization":
            if intercept_id is None:
                raise ValueError("standardization requires an intercept feature")
            shifts = summary.mean.clone()
        if intercept_id is not None:
            factors[intercept_id] = 1.0
            if shifts is not None:
                shifts[intercept_id] = 0.0
        return cls(factors=factors, shifts=shifts, intercept_id=intercept_id)


def _safe_inverse(x: Tensor) -> Tensor:
    return torch.where(x > 0.0, 1.0 / torch.where(x > 0.0, x, 1.0), 1.0)
