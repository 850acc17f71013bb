"""Evaluator objects: named metrics with a comparison direction.

Counterpart of ``photon_tpu/evaluation/evaluators.py``.  Names accepted by
:func:`get_evaluator`: ``AUC``, ``RMSE``, ``LOGISTIC_LOSS``,
``POISSON_LOSS``, ``SQUARED_LOSS``, ``SMOOTHED_HINGE_LOSS`` and
``PRECISION@k``.  Sharded (per-entity) evaluators wait in ROADMAP.md
queue 1, item 4.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Sequence

from photon_tpu_torch.evaluation import metrics as M


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """A named metric; ``maximize`` gives the direction (AUC up, losses
    down) used for best-model selection."""

    name: str
    fn: Callable
    maximize: bool

    def evaluate(self, scores, labels, weights=None) -> float:
        return float(self.fn(scores, labels, weights))

    def better_than(self, a: float, b: float) -> bool:
        """Is metric value ``a`` strictly better than ``b``?  NaNs lose."""
        if math.isnan(a):
            return False
        if math.isnan(b):
            return True
        return a > b if self.maximize else a < b


class MultiEvaluator:
    """Evaluate several metrics at once; the first is the selection metric."""

    def __init__(self, evaluators: Sequence[Evaluator]):
        if not evaluators:
            raise ValueError("MultiEvaluator needs at least one evaluator")
        self.evaluators = list(evaluators)

    @property
    def primary(self) -> Evaluator:
        return self.evaluators[0]

    def evaluate(self, scores, labels, weights=None) -> dict:
        return {ev.name: ev.evaluate(scores, labels, weights) for ev in self.evaluators}


_PRECISION_RE = re.compile(r"^precision@(\d+)$")


def get_evaluator(name: str) -> Evaluator:
    key = name.strip().lower()
    if key == "auc":
        return Evaluator("AUC", M.area_under_roc_curve, maximize=True)
    if key == "rmse":
        return Evaluator("RMSE", M.rmse, maximize=False)
    if key == "logistic_loss":
        return Evaluator("LOGISTIC_LOSS", M.logistic_loss_metric, maximize=False)
    if key == "poisson_loss":
        return Evaluator("POISSON_LOSS", M.poisson_loss_metric, maximize=False)
    if key == "squared_loss":
        return Evaluator("SQUARED_LOSS", M.squared_loss_metric, maximize=False)
    if key == "smoothed_hinge_loss":
        return Evaluator(
            "SMOOTHED_HINGE_LOSS", M.smoothed_hinge_loss_metric, maximize=False
        )
    m = _PRECISION_RE.match(key)
    if m:
        k = int(m.group(1))
        return Evaluator(
            f"PRECISION@{k}",
            lambda s, l, w=None, k=k: M.precision_at_k(s, l, w, k),
            maximize=True,
        )
    if key.startswith("sharded_"):
        raise NotImplementedError(
            f"sharded evaluator {name!r} is not ported yet; it waits in "
            f"ROADMAP.md queue 1, item 4"
        )
    raise KeyError(f"unknown evaluator {name!r}")


def default_evaluators_for_task(task_type: str) -> list[Evaluator]:
    """The default evaluators per task type."""
    task = task_type.lower()
    if task == "logistic_regression":
        return [get_evaluator("auc"), get_evaluator("logistic_loss")]
    if task == "linear_regression":
        return [get_evaluator("rmse"), get_evaluator("squared_loss")]
    if task == "poisson_regression":
        return [get_evaluator("poisson_loss")]
    if task == "smoothed_hinge_loss_linear_svm":
        return [get_evaluator("auc"), get_evaluator("smoothed_hinge_loss")]
    raise KeyError(f"unknown task type {task_type!r}")
