"""Down-samplers: uniform and negative-class, with weight correction.

Counterpart of ``photon_tpu/data/sampling.py``: down-sampling bounds the
fixed-effect training cost on large datasets and re-weights the kept rows
so the objective stays an unbiased estimate of the full-data objective.
Rows are chosen on the host (the device never sees a dropped row) from the
label and weight columns, by numpy generators seeded as the reference seeds
them, so both packages keep the same rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DownSampler:
    """Base: keep every row (rate 1)."""

    rate: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(f"downsampling rate must be in (0, 1], got {self.rate}")

    def down_sample(
        self, label: np.ndarray, weight: np.ndarray, seed: int = 0
    ) -> tuple[np.ndarray, np.ndarray]:
        """(kept row indices, corrected weights for those rows)."""
        rows = np.arange(len(label))
        return rows, np.asarray(weight, np.float32)


@dataclasses.dataclass(frozen=True)
class DefaultDownSampler(DownSampler):
    """Uniform Bernoulli(rate) keep; kept weights scaled by 1/rate."""

    def down_sample(self, label, weight, seed: int = 0):
        if self.rate >= 1.0:
            return super().down_sample(label, weight, seed)
        rng = np.random.default_rng(seed)
        rows = np.nonzero(rng.random(len(label)) < self.rate)[0]
        return rows, (np.asarray(weight, np.float32)[rows] / self.rate)


@dataclasses.dataclass(frozen=True)
class BinaryClassificationDownSampler(DownSampler):
    """Keep every positive; keep negatives at ``rate`` with 1/rate weight
    correction (the reference's imbalanced-binary-data sampler)."""

    def down_sample(self, label, weight, seed: int = 0):
        if self.rate >= 1.0:
            return super().down_sample(label, weight, seed)
        label = np.asarray(label)
        weight = np.asarray(weight, np.float32)
        rng = np.random.default_rng(seed)
        positive = label > 0.5
        keep = positive | (rng.random(len(label)) < self.rate)
        rows = np.nonzero(keep)[0]
        corrected = weight[rows].copy()
        negatives = ~positive[rows]
        corrected[negatives] /= self.rate
        return rows, corrected


def get_down_sampler(kind: str, rate: float) -> DownSampler:
    """``default`` (uniform) or ``binary`` (negative-class only).  The
    reference picks binary for logistic/hinge tasks, default otherwise."""
    key = kind.strip().lower()
    if key == "default":
        return DefaultDownSampler(rate)
    if key == "binary":
        return BinaryClassificationDownSampler(rate)
    raise KeyError(f"unknown down-sampler {kind!r} (want default|binary)")


def down_sampler_for_task(task_type: str, rate: float) -> DownSampler:
    from photon_tpu_torch.core.losses import BINARY_TASKS

    binary = task_type.lower() in BINARY_TASKS
    return get_down_sampler("binary" if binary else "default", rate)
