"""GameEstimator: the sweep over GAME optimization configurations.

Counterpart of the resident path of ``photon_tpu/game/estimator.py``:
``fit`` runs :class:`CoordinateDescent` once per
:class:`GameOptimizationConfiguration` (the per-coordinate regularization
grid), and :meth:`GameEstimator.select_best` picks the best entry by the
primary evaluator.  Device data is built once per data configuration and
shared by every sweep entry; so is the validation scoring cache.

Streamed and out-of-core fits (ROADMAP.md queue 1, item 9), onboarding and
warm starts (item 5), descent checkpoints (item 6) and the mesh (item 10)
raise.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.evaluation.evaluators import (
    MultiEvaluator,
    default_evaluators_for_task,
)
from photon_tpu_torch.game.coordinate import (
    CoordinateConfig,
    FixedEffectCoordinateConfig,
    FixedEffectDeviceData,
    RandomEffectDeviceData,
    build_coordinate,
)
from photon_tpu_torch.game.data import GameDataset
from photon_tpu_torch.game.descent import CoordinateDescent, DescentResult
from photon_tpu_torch.game.model import DeviceScoringCache, GameModel
from photon_tpu_torch.game.residuals import (
    resolve_residual_mode,
    resolve_validation_mode,
)


@dataclasses.dataclass(frozen=True)
class GameOptimizationConfiguration:
    """One point of the sweep: per-coordinate configs in update order and
    the number of outer coordinate-descent iterations."""

    coordinates: Dict[str, CoordinateConfig]
    descent_iterations: int = 1
    name: str = ""

    def __post_init__(self):
        if not self.coordinates:
            raise ValueError("configuration needs at least one coordinate")
        if self.descent_iterations < 1:
            raise ValueError("descent_iterations must be >= 1")


@dataclasses.dataclass
class GameResult:
    """One fitted sweep entry: (model, metrics, configuration)."""

    model: GameModel
    metrics: Dict[str, float]
    configuration: GameOptimizationConfiguration
    descent: DescentResult


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} waits in ROADMAP.md queue 1, item {item}")


class GameEstimator:
    """Builds the coordinates of each configuration on ``device`` (``cuda``
    by default) and runs the descent sweep."""

    def __init__(
        self,
        task_type: str,
        training_data: GameDataset,
        validation_data: Optional[GameDataset] = None,
        evaluators: Optional[MultiEvaluator] = None,
        device=None,
        logger=None,
        residual_mode: Optional[str] = None,
        validation_mode: Optional[str] = None,
        mesh=None,
        normalization=None,
        stream_chunks: Optional[int] = None,
        spill_dir: Optional[str] = None,
    ):
        if mesh is not None:
            raise _not_ported("the device mesh", 10)
        if normalization:
            raise _not_ported("normalized GAME coordinates", 2)
        if stream_chunks is not None or spill_dir is not None:
            raise _not_ported("streamed (out-of-core) GAME training", 9)
        self.task_type = task_type
        self.training_data = training_data
        self.validation_data = validation_data
        if evaluators is None and validation_data is not None:
            evaluators = MultiEvaluator(default_evaluators_for_task(task_type))
        self.evaluators = evaluators
        self.device = resolve_device(device)
        self.logger = logger or logging.getLogger("photon_tpu_torch.game")
        self.residual_mode = residual_mode
        self.validation_mode = validation_mode
        self._device_data_cache: Dict[tuple, object] = {}
        self._validation_cache: Optional[DeviceScoringCache] = None

    def _validation_scoring_cache(self) -> Optional[DeviceScoringCache]:
        """The shared validation cache when validation runs on the device."""
        if self.validation_data is None or self.evaluators is None:
            return None
        mode = resolve_validation_mode(
            self.validation_mode, resolve_residual_mode(self.residual_mode))
        if mode != "device":
            return None
        if self._validation_cache is None:
            self._validation_cache = DeviceScoringCache(self.validation_data,
                                                        self.device)
        return self._validation_cache

    def device_layout(self, coord_config):
        """The cached device data of one coordinate config, built on first
        use."""
        key = coord_config.data_key
        if key not in self._device_data_cache:
            cls = (FixedEffectDeviceData
                   if isinstance(coord_config, FixedEffectCoordinateConfig)
                   else RandomEffectDeviceData)
            self._device_data_cache[key] = cls(self.training_data, coord_config,
                                               self.device)
        return self._device_data_cache[key]

    def _build_coordinates(self, config: GameOptimizationConfiguration) -> dict:
        return {
            name: build_coordinate(self.training_data, coord_config, self.task_type,
                                   device=self.device,
                                   device_data=self.device_layout(coord_config))
            for name, coord_config in config.coordinates.items()
        }

    def fit(
        self,
        configurations: Sequence[GameOptimizationConfiguration],
        initial_model: Optional[GameModel] = None,
        locked_coordinates: Sequence[str] = (),
        checkpoint_fn=None,
        checkpoint_dir: Optional[str] = None,
        resume: Optional[str] = None,
        max_quarantined: Optional[int] = None,
    ) -> List[GameResult]:
        """One descent run per configuration; ``checkpoint_fn(iteration,
        model)`` is passed to each run."""
        if not configurations:
            raise ValueError("fit() needs at least one configuration")
        if checkpoint_dir is not None or resume:
            raise _not_ported("descent checkpointing (with resume)", 6)
        results = []
        for config in configurations:
            loop = CoordinateDescent(
                self._build_coordinates(config), self.task_type,
                self.training_data, self.validation_data, self.evaluators,
                logger=self.logger, residual_mode=self.residual_mode,
                validation_mode=self.validation_mode,
                validation_cache=self._validation_scoring_cache(),
            )
            descent = loop.run(
                config.descent_iterations, initial_model=initial_model,
                locked_coordinates=locked_coordinates,
                checkpoint_fn=checkpoint_fn, max_quarantined=max_quarantined,
            )
            results.append(GameResult(
                model=descent.best_model, metrics=descent.best_metrics,
                configuration=config, descent=descent,
            ))
        return results

    def select_best(self, results: Sequence[GameResult]) -> GameResult:
        """Best sweep entry by the primary evaluator; without validation the
        first entry wins."""
        if self.evaluators is None or not any(r.metrics for r in results):
            return results[0]
        primary = self.evaluators.primary
        best = results[0]
        for r in results[1:]:
            if r.metrics and primary.better_than(
                r.metrics.get(primary.name, float("nan")),
                best.metrics.get(primary.name, float("nan")),
            ):
                best = r
        return best
