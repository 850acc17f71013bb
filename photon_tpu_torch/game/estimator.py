"""GameEstimator: the sweep over GAME optimization configurations.

Counterpart of the resident path of ``photon_tpu/game/estimator.py``:
``fit`` runs :class:`CoordinateDescent` once per
:class:`GameOptimizationConfiguration` (the per-coordinate regularization
grid), and :meth:`GameEstimator.select_best` picks the best entry by the
primary evaluator.  Device data is built once per data configuration and
shared by every sweep entry; so is the validation scoring cache.
``normalization`` maps a feature shard to its context and applies to the
fixed-effect coordinates on that shard.

``fit`` may start every descent run from an initial model and keep some
coordinates locked at it, checkpoint every descent run under
``checkpoint_dir`` (one ``cfg-NNN`` chain a configuration) and resume from
there; a configuration whose checkpoint covers its last iteration is
rebuilt from it without a fit.  :meth:`GameEstimator.onboard_training_data`
grows the cached device layouts in place for rows appended between fits
(the online loop's growth step).

``stream_chunks`` (rows a chunk) switches every fit to the streamed
descent (``game/stream_descent.py``): the training data and the score
state stay in host memory as row chunks and score tiles, and the chunks
stream to the device one ahead of the compute, so device residency is
bounded by the chunk window, not the dataset.  ``spill_dir`` adds the disk
tier (``game/tile_store.py``): feature chunks and residual tiles in part
files, served through an LRU host cache of ``max_host_mb``, stored under
the ``tile_dtype`` codec.  The mesh (ROADMAP.md queue 1, item 10) raises.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Sequence

from photon_tpu_torch.core.normalization import NormalizationContext
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.evaluation.evaluators import (
    MultiEvaluator,
    default_evaluators_for_task,
)
from photon_tpu_torch.game.coordinate import (
    CoordinateConfig,
    FactoredRandomEffectCoordinateConfig,
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
from photon_tpu_torch.telemetry import NULL_SESSION


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
        telemetry=None,
        max_host_mb: Optional[float] = None,
        tile_dtype: Optional[str] = None,
    ):
        """``spill_dir`` (with ``stream_chunks``) keeps the streamed fit's
        feature chunks and residual tiles in a tile store there, behind a
        host cache of ``max_host_mb`` MB (None: unbounded, still
        disk-backed); ``tile_dtype`` (with ``spill_dir``) is the store's
        codec for feature values and score tiles, ``f32`` (exact, the
        default), ``bf16`` or ``int8``.  The training dataset itself and the
        random-effect bin layouts stay in host memory."""
        from photon_tpu_torch.game.lowp import TILE_DTYPES, check_dtype

        if mesh is not None:
            raise _not_ported("the device mesh", 10)
        if isinstance(normalization, NormalizationContext):
            raise TypeError("pass normalization as {shard_name: NormalizationContext}")
        # Keyed by feature shard; applies to the fixed-effect coordinates on
        # that shard (random-effect coordinates refuse it).
        self.normalization = normalization or {}
        self.stream_chunks = None
        if stream_chunks is not None:
            if int(stream_chunks) < 1:
                raise ValueError(f"stream_chunks must be >= 1, got {stream_chunks}")
            if (residual_mode not in (None, "auto")
                    or validation_mode not in (None, "auto")):
                # An explicitly requested resident engine must not be
                # replaced by the tiled tables without a word.
                raise ValueError(
                    "stream_chunks replaces the residual/validation engines; "
                    "drop the explicit residual_mode/validation_mode (got "
                    f"{residual_mode!r}/{validation_mode!r})")
            self.stream_chunks = int(stream_chunks)
        if spill_dir is not None and not self.stream_chunks:
            raise ValueError(
                "spill_dir (the disk-backed tile store) requires stream_chunks: "
                "the disk tier spills the streamed fit's host working set")
        if max_host_mb is not None:
            if max_host_mb <= 0:
                raise ValueError(f"max_host_mb must be > 0, got {max_host_mb}")
            if spill_dir is None:
                raise ValueError("max_host_mb bounds the spill host cache; set "
                                 "spill_dir (or let the driver derive one)")
        self.spill_dir = spill_dir
        self.max_host_mb = max_host_mb
        self.tile_dtype = check_dtype(tile_dtype, TILE_DTYPES, "tile dtype")
        if self.tile_dtype != "f32" and spill_dir is None:
            raise ValueError("tile_dtype selects the disk tier's storage codec; set "
                             "spill_dir (host-resident tiles are always f32)")
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
        self.telemetry = telemetry or NULL_SESSION
        self._device_data_cache: Dict[tuple, object] = {}
        self._validation_cache: Optional[DeviceScoringCache] = None
        # Streamed mode: the host bin layouts and one chunk streamer, shared
        # across the sweep (its stall and overlap counters accumulate).
        self._stream_data_cache: Dict[tuple, object] = {}
        self._streamer = None
        self._spill = None

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
            if isinstance(coord_config, FixedEffectCoordinateConfig):
                data = FixedEffectDeviceData(self.training_data, coord_config,
                                             self.device)
            else:
                if isinstance(coord_config, FactoredRandomEffectCoordinateConfig):
                    # The factored coordinate shares the unprojected layout.
                    coord_config = coord_config.as_random_config()
                data = RandomEffectDeviceData(self.training_data, coord_config,
                                              self.device)
            self._device_data_cache[key] = data
        return self._device_data_cache[key]

    def _build_coordinates(self, config: GameOptimizationConfiguration) -> dict:
        coords = {
            name: build_coordinate(self.training_data, coord_config, self.task_type,
                                   device=self.device,
                                   normalization=self.normalization.get(
                                       coord_config.shard_name),
                                   device_data=self.device_layout(coord_config))
            for name, coord_config in config.coordinates.items()
        }
        for name, coord in coords.items():
            # The coordinates' own telemetry (bin gauges, warm-start
            # transfers) lands in the run's session under their names.
            coord.name = name
            coord.telemetry = self.telemetry
        return coords

    # -- streamed mode --------------------------------------------------------
    def _stream_plan(self):
        from photon_tpu_torch.game.tiles import ChunkPlan

        return ChunkPlan(self.training_data.num_examples, self.stream_chunks)

    def _stream_streamer(self):
        from photon_tpu_torch.game.tiles import ChunkStreamer

        if self._streamer is None:
            self._streamer = ChunkStreamer(self.telemetry, device=self.device)
        return self._streamer

    def _spill_context(self):
        """The disk tier of a spilled fit, built once an estimator: the
        store, the host cache of ``max_host_mb`` and the chunk source over
        them.  Building it spills the training data's feature chunks,
        unless a run over the same dataset and plan already did (a resume
        reuses the store)."""
        if self.spill_dir is None:
            return None
        if self._spill is None:
            from photon_tpu_torch.game.tile_store import TileStore
            from photon_tpu_torch.game.tiles import (
                HostTileCache,
                SpillContext,
                SpilledChunkSource,
                spill_dataset,
            )

            store = TileStore(self.spill_dir, telemetry=self.telemetry,
                              tile_dtype=self.tile_dtype)
            cache = HostTileCache(
                max_bytes=(None if self.max_host_mb is None
                           else int(self.max_host_mb * (1 << 20))),
                telemetry=self.telemetry)
            plan = self._stream_plan()
            spill_dataset(store, self.training_data, plan, telemetry=self.telemetry)
            self._spill = SpillContext(
                store=store, cache=cache,
                source=SpilledChunkSource(store, plan, cache, telemetry=self.telemetry))
        return self._spill

    def _build_stream_coordinates(self, config: GameOptimizationConfiguration) -> dict:
        """The streamed coordinates: nothing uploads at build time; fixed
        effects stream row chunks, random effects entity sub-blocks of host
        bin layouts cached across the sweep.  Factored coordinates raise."""
        from photon_tpu_torch.game.coordinate import RandomEffectCoordinateConfig
        from photon_tpu_torch.game.stream_descent import (
            StreamedFixedEffectCoordinate,
            StreamedRandomEffectCoordinate,
            StreamedRandomEffectHostData,
        )

        plan, streamer = self._stream_plan(), self._stream_streamer()
        spill = self._spill_context()
        source = spill.source if spill is not None else None
        coords = {}
        for name, cc in config.coordinates.items():
            if isinstance(cc, FixedEffectCoordinateConfig):
                coords[name] = StreamedFixedEffectCoordinate(
                    self.training_data, cc, self.task_type, plan, streamer,
                    normalization=self.normalization.get(cc.shard_name), source=source)
            elif isinstance(cc, FactoredRandomEffectCoordinateConfig):
                raise ValueError(
                    f"coordinate {name!r}: factored_random coordinates have no "
                    "streamed path (the pooled latent solve is whole-dataset); "
                    "train resident")
            elif isinstance(cc, RandomEffectCoordinateConfig):
                if cc.data_key not in self._stream_data_cache:
                    self._stream_data_cache[cc.data_key] = StreamedRandomEffectHostData(
                        self.training_data, cc)
                coords[name] = StreamedRandomEffectCoordinate(
                    self.training_data, cc, self.task_type, plan, streamer,
                    host_data=self._stream_data_cache[cc.data_key], source=source)
            else:
                raise TypeError(f"unknown coordinate config {type(cc)!r}")
        for name, coord in coords.items():
            coord.name = coord.fault_name = name
            coord.telemetry = self.telemetry
        return coords

    def entity_vocabularies(self) -> Dict[str, object]:
        """The current entity vocabulary per id column, from the live
        random-effect layouts (the onboarded state)."""
        return {
            dd.config.entity_column: dd.dataset.keys
            for dd in self._device_data_cache.values()
            if isinstance(dd, RandomEffectDeviceData)
        }

    def onboard_training_data(self, data: GameDataset, absent_tail=None) -> None:
        """Swap in a grown training dataset (rows appended, for new and
        existing entities) between fits.  Every cached random-effect layout
        grows in place (:meth:`RandomEffectDeviceData.onboard`: in-place
        row scatters within a bin's capacity, migrations past it, appended
        bins for new entities; no full rebuild).  Fixed-effect layouts are
        dropped for a lazy rebuild at the grown row count, counted as
        ``estimator.device_data_rebuilds{kind=fixed}``.  ``absent_tail``
        maps an id column to the appended rows that carry no id for it.
        Every layout is validated before any is changed, so a rejected
        batch changes nothing."""
        if data.num_examples < self.training_data.num_examples:
            raise ValueError(
                "onboard_training_data() needs the grown dataset (rows are "
                "append-only)")
        absent_tail = absent_tail or {}
        with self.telemetry.span("estimator.onboard", rows=data.num_examples):
            for dd in self._device_data_cache.values():
                if isinstance(dd, RandomEffectDeviceData):
                    dd.check_onboard(
                        data, absent_tail=absent_tail.get(dd.config.entity_column))
            for key, dd in list(self._device_data_cache.items()):
                if isinstance(dd, RandomEffectDeviceData):
                    before = dd.dataset.num_entities
                    dd.onboard(data, telemetry=self.telemetry,
                               absent_tail=absent_tail.get(dd.config.entity_column))
                    self.telemetry.counter("estimator.entities_onboarded").inc(
                        dd.dataset.num_entities - before)
                else:
                    del self._device_data_cache[key]
                    self.telemetry.counter(
                        "estimator.device_data_rebuilds", kind="fixed").inc()
        # The streamed host layouts have no in-place growth: they rebuild at
        # the grown row count on the next fit, and the grown data spills
        # again under its own fingerprint.
        self._stream_data_cache.clear()
        self._spill = None
        self.training_data = data

    def _expected_fingerprint(self, config: GameOptimizationConfiguration,
                              config_key: str, locked, warm_start: bool) -> dict:
        from photon_tpu_torch.fault.checkpoint import descent_fingerprint
        from photon_tpu_torch.game.stream_descent import stream_fingerprint

        has_validation = (self.validation_data is not None
                          and self.evaluators is not None)
        common = dict(
            config_key=config_key,
            validation_key=self.evaluators.primary.name if has_validation else None,
            locked=locked, warm_start=warm_start,
            coordinate_kinds={name: getattr(cc, "kind", type(cc).__name__)
                              for name, cc in config.coordinates.items()},
        )
        if self.stream_chunks:
            return stream_fingerprint(self.task_type, config.coordinates,
                                      self.training_data.num_examples,
                                      self.stream_chunks, **common)
        return descent_fingerprint(
            self.task_type, config.coordinates, self.training_data.num_examples,
            resolve_residual_mode(self.residual_mode), **common)

    def fit(
        self,
        configurations: Sequence[GameOptimizationConfiguration],
        initial_model: Optional[GameModel] = None,
        locked_coordinates: Sequence[str] = (),
        checkpoint_fn=None,
        checkpoint_dir: Optional[str] = None,
        resume: Optional[str] = None,
        max_quarantined: Optional[int] = None,
        checkpoint_async=None,
        checkpoint_max_staged_mb: Optional[float] = None,
    ) -> List[GameResult]:
        """One descent run per configuration, each from ``initial_model``
        when given, with ``locked_coordinates`` kept at it;
        ``checkpoint_fn(iteration, model)`` is passed to each run.

        ``checkpoint_dir`` checkpoints every run (``cfg-NNN`` a
        configuration, the async publisher unless ``checkpoint_async`` is
        off, ``checkpoint_max_staged_mb`` capping its staged copies);
        ``resume`` is ``auto`` (whatever is saved, else a fresh start),
        ``latest`` (a saved checkpoint required) or one version's path (a
        single configuration).  A mismatched checkpoint raises
        ``CheckpointError``."""
        from photon_tpu_torch.fault.checkpoint import (
            DescentCheckpointer,
            configuration_key,
            require_fingerprint,
        )

        if not configurations:
            raise ValueError("fit() needs at least one configuration")
        if resume and checkpoint_dir is None and resume in ("auto", "latest"):
            raise ValueError(f"resume={resume!r} needs checkpoint_dir")
        if resume and resume not in ("auto", "latest") and len(configurations) > 1:
            raise ValueError(
                "an explicit checkpoint path resumes a single-configuration "
                "fit; use resume='auto' for sweeps")
        results = []
        for i, config in enumerate(configurations):
            label = config.name or f"config-{i}"
            config_key = configuration_key(config.coordinates)
            checkpointer = resume_state = None
            if checkpoint_dir is not None:
                checkpointer = DescentCheckpointer(
                    os.path.join(checkpoint_dir, f"cfg-{i:03d}"),
                    telemetry=self.telemetry, logger=self.logger,
                    async_publish=checkpoint_async,
                    max_staged_mb=checkpoint_max_staged_mb,
                )
            if resume:
                if resume in ("auto", "latest"):
                    resume_state = checkpointer.load(resume, device=self.device)
                else:
                    resume_state = DescentCheckpointer.load_path(
                        resume, device=self.device)
            if resume_state is not None:
                # Checked here, before a completed checkpoint could be
                # returned as this configuration's result.
                require_fingerprint(
                    resume_state,
                    self._expected_fingerprint(config, config_key,
                                               locked_coordinates,
                                               initial_model is not None),
                    f"configuration {label!r}")
            if (resume_state is not None
                    and resume_state.iteration + 1 >= config.descent_iterations):
                best = GameModel(dict(resume_state.best_models), self.task_type)
                descent = DescentResult(
                    best_model=best,
                    last_model=GameModel(dict(resume_state.models), self.task_type),
                    best_metrics=dict(resume_state.best_metrics),
                    history=list(resume_state.history),
                )
                self.telemetry.counter("estimator.configurations_resumed").inc()
                self.logger.info("fit-%s restored from completed checkpoint", label)
                results.append(GameResult(model=best, metrics=descent.best_metrics,
                                          configuration=config, descent=descent))
                continue
            if self.stream_chunks:
                from photon_tpu_torch.game.stream_descent import StreamedCoordinateDescent

                loop = StreamedCoordinateDescent(
                    self._build_stream_coordinates(config), self.task_type,
                    self.training_data, self.validation_data, self.evaluators,
                    plan=self._stream_plan(), streamer=self._stream_streamer(),
                    logger=self.logger, telemetry=self.telemetry,
                    spill=self._spill_context(),
                )
            else:
                loop = CoordinateDescent(
                    self._build_coordinates(config), self.task_type,
                    self.training_data, self.validation_data, self.evaluators,
                    logger=self.logger, residual_mode=self.residual_mode,
                    validation_mode=self.validation_mode,
                    validation_cache=self._validation_scoring_cache(),
                    telemetry=self.telemetry,
                )
            descent = loop.run(
                config.descent_iterations, initial_model=initial_model,
                locked_coordinates=locked_coordinates,
                checkpoint_fn=checkpoint_fn, checkpointer=checkpointer,
                resume_state=resume_state, max_quarantined=max_quarantined,
                config_key=config_key,
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
