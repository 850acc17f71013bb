"""Training-data validation, a copy of ``photon_tpu/data/validation.py``
(reference: photon-client ``DataValidators`` —
SURVEY.md §2.3): row sanity checks with configurable strictness, run before
training so bad inputs fail loudly instead of corrupting a long fit.

Checks per task type:
- labels finite; binary tasks need labels in {0, 1}; Poisson needs >= 0
- weights finite and > 0 (zero weights are reserved for padding rows)
- offsets finite
- feature values finite
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from photon_tpu_torch.core.losses import BINARY_TASKS


class DataValidationError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class ValidationIssue:
    check: str
    count: int
    detail: str

    def __str__(self) -> str:
        return f"{self.check}: {self.count} rows ({self.detail})"


def _count(mask: np.ndarray) -> int:
    return int(np.count_nonzero(mask))


def validate_columns(
    label: np.ndarray,
    weight: Optional[np.ndarray],
    offset: Optional[np.ndarray],
    task_type: str,
) -> List[ValidationIssue]:
    issues: List[ValidationIssue] = []
    label = np.asarray(label)
    bad = _count(~np.isfinite(label))
    if bad:
        issues.append(ValidationIssue("non_finite_label", bad, "NaN/Inf labels"))
    task = task_type.lower()
    if task in BINARY_TASKS:
        finite = label[np.isfinite(label)]
        bad = _count(~np.isin(finite, (0.0, 1.0)))
        if bad:
            issues.append(
                ValidationIssue(
                    "non_binary_label", bad,
                    "binary task labels must be 0 or 1 "
                    "(normalize -1/+1 on read)",
                )
            )
    elif task == "poisson_regression":
        finite = label[np.isfinite(label)]
        bad = _count(finite < 0)
        if bad:
            issues.append(
                ValidationIssue("negative_label", bad, "Poisson labels must be >= 0")
            )
    if weight is not None:
        weight = np.asarray(weight)
        bad = _count(~np.isfinite(weight) | (weight <= 0))
        if bad:
            issues.append(
                ValidationIssue(
                    "invalid_weight", bad, "weights must be finite and > 0"
                )
            )
    if offset is not None:
        bad = _count(~np.isfinite(np.asarray(offset)))
        if bad:
            issues.append(ValidationIssue("non_finite_offset", bad, "NaN/Inf offsets"))
    return issues


def _feature_issues(values: np.ndarray, where: str) -> List[ValidationIssue]:
    bad_rows = _count(~np.isfinite(values).all(axis=tuple(range(1, values.ndim))))
    if bad_rows:
        return [
            ValidationIssue(
                f"non_finite_features[{where}]", bad_rows, "NaN/Inf feature values"
            )
        ]
    return []


def validate_batch(batch, task_type: str) -> List[ValidationIssue]:
    """Validate a DenseBatch/SparseBatch (photon_tpu_torch.data.batch)."""
    def host(t) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    issues = validate_columns(
        host(batch.label), host(batch.weight), host(batch.offset), task_type,
    )
    values = getattr(batch, "x", None)
    if values is None:
        values = batch.vals
    issues += _feature_issues(host(values), "batch")
    return issues


def validate_game_dataset(data, task_type: str) -> List[ValidationIssue]:
    """Validate a GameDataset (photon_tpu_torch.game.data)."""
    issues = validate_columns(data.label, data.weight, data.offset, task_type)
    for name, shard in data.shards.items():
        from photon_tpu_torch.game.lowp import host_f32

        values = shard.x if hasattr(shard, "x") else shard.vals
        issues += _feature_issues(host_f32(values), name)
    return issues


def apply_validation(issues: List[ValidationIssue], mode: str, logger=None) -> None:
    """``error`` raises on any issue; ``warn`` logs them; ``off`` skips.

    (The reference's configurable validation strictness.)
    """
    if mode == "off" or not issues:
        return
    message = "; ".join(str(i) for i in issues)
    if mode == "error":
        raise DataValidationError(f"data validation failed: {message}")
    if mode == "warn":
        if logger is not None:
            logger.warning("data validation: %s", message)
        return
    raise ValueError(f"unknown validation mode {mode!r} (want error|warn|off)")
