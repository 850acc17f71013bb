"""GAME coordinates: the fixed-effect and random-effect training units.

Counterpart of the single-device resident part of
``photon_tpu/game/coordinate.py``.  A coordinate owns one slice of the
model, trains it against the other coordinates' scores (its offsets) and
scores data with it:

- :class:`FixedEffectCoordinate` — one GLM fit over the whole training
  batch (``GlmOptimizationProblem``: L-BFGS or TRON through the route
  ``ops/sparse_grad_select`` picks, K1 on ``fused``, K2 on ``pallas``).
- :class:`RandomEffectCoordinate` — per-entity GLMs, the entities of each
  size bin solved together by the batched damped Newton
  (``game/batched_solve.py``), converged lanes frozen.

Device data (``FixedEffectDeviceData`` / ``RandomEffectDeviceData``) is
built and uploaded once per data configuration and shared across the
regularization sweep and the descent iterations; only the offsets change.
A random-effect ``train`` makes no host read of its own beyond the Newton
loop's: its convergence statistics stay in a device accumulator
(:class:`DeferredSolveStats`) that the descent loop reads once per outer
iteration.

The fixed effect may train on a weight-corrected down-sample of its rows
(``data/sampling.py``) and under a feature normalization: it fits in the
normalized space and stores its model in the original one, and a warm
start re-enters the normalized space.  Random-effect coordinates refuse a
normalization, as the reference's do.

Not carried (each raises, naming its ROADMAP.md queue 1 item): the mesh and
row-split placement (item 10), projections, factored random effects,
onboarding and warm starts from a foreign vocabulary, and L1 entity
solves (item 5).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from photon_tpu_torch.core.normalization import NormalizationContext
from photon_tpu_torch.core.objective import GlmObjective
from photon_tpu_torch.core.optimizers import OptimizationStatesTracker
from photon_tpu_torch.core.problem import GlmOptimizationProblem, ProblemConfig
from photon_tpu_torch.data.batch import DenseBatch, SparseBatch
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game.batched_solve import (
    LaneObjective,
    record_bin_telemetry,
    run_newton_fit,
    solver_route,
)
from photon_tpu_torch.game.data import (
    GameDataset,
    RandomEffectDataset,
    _gather_shard_rows,
    build_random_effect_dataset,
    keys_match,
    merge_buckets,
    pad_bucket_entities,
)
from photon_tpu_torch.game.model import (
    FixedEffectModel,
    RandomEffectModel,
    shard_feats,
    shard_to_batch,
)
from photon_tpu_torch.models.glm import Coefficients, model_for_task

Tensor = torch.Tensor


def _accumulate_solve_stats(acc: Tensor, entity_index: Tensor, num_entities: int,
                            converged: Tensor, iterations: Tensor,
                            good: Tensor) -> Tensor:
    """Fold one bin's solve into the coordinate's ``[6]`` int32 device
    accumulator ``[entities, converged, iterations_max, quarantined,
    cg_iters, cg_entities]``.  Padded entities (``entity_index >=
    num_entities``) count nowhere; a quarantined entity does not count as
    converged.  The Newton route has no inner CG, so the last two stay 0."""
    real = entity_index < num_entities
    real_i = real.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=acc.device)
    return torch.stack([
        acc[0] + real_i.sum(),
        acc[1] + ((converged & good).to(torch.int32) * real_i).sum(),
        torch.maximum(acc[2], torch.where(real, iterations.to(torch.int32), 0).max()),
        acc[3] + ((~good).to(torch.int32) * real_i).sum(),
        acc[4] + zero,
        acc[5] + zero,
    ]).to(torch.int32)


class DeferredSolveStats:
    """A random-effect ``train``'s convergence statistics as one device
    int32 vector, read by the descent loop with everything else of the
    iteration in one host read (:meth:`resolve` takes the fetched vector).
    ``bins`` holds the per-bin solve records (host values)."""

    KEYS = ("entities", "converged", "iterations_max", "quarantined",
            "cg_iters", "cg_entities")

    def __init__(self, device: Tensor, bins: Optional[list] = None):
        self.device = device
        self.bins = list(bins or [])
        self._resolved: Optional[dict] = None

    def resolve(self, host_vec=None) -> dict:
        if self._resolved is None:
            if host_vec is None:
                host_vec = self.device.tolist()
            self._resolved = {k: int(host_vec[i]) for i, k in enumerate(self.KEYS)}
        return self._resolved

    def __getitem__(self, key):
        return self.resolve()[key]

    def __str__(self):
        return (str(self.resolve()) if self._resolved is not None
                else "DeferredSolveStats(pending)")


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinateConfig:
    """A fixed-effect coordinate: its feature shard and fit configuration."""

    kind = "fixed"

    shard_name: str
    problem: ProblemConfig = ProblemConfig()
    downsampling_rate: float = 1.0
    downsampler: str = "default"
    seed: int = 0

    @property
    def data_key(self):
        return ("fixed", self.shard_name, self.downsampling_rate,
                self.downsampler, self.seed)


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinateConfig:
    """A random-effect coordinate: feature shard, entity id column, fit
    configuration and the active-row cap."""

    kind = "random"

    shard_name: str
    entity_column: str
    problem: ProblemConfig = ProblemConfig()
    active_row_cap: Optional[int] = None
    projection: str = "none"
    projected_dim: Optional[int] = None
    seed: int = 0
    row_split: bool = False

    def __post_init__(self):
        if self.projection not in ("none", "index_map", "random"):
            raise ValueError(f"unknown projection {self.projection!r}")
        if self.projection != "none" or self.projected_dim:
            raise NotImplementedError(
                "random-effect feature projections wait with game/projection.py "
                "in ROADMAP.md queue 1, item 5"
            )
        if self.row_split:
            raise NotImplementedError(
                "row-split entity placement needs a device mesh, which waits "
                "in ROADMAP.md queue 1, item 10"
            )

    @property
    def data_key(self):
        return ("random", self.shard_name, self.entity_column,
                self.active_row_cap, self.projection, self.projected_dim,
                self.seed, self.row_split)


CoordinateConfig = Union[FixedEffectCoordinateConfig, RandomEffectCoordinateConfig]


class FixedEffectDeviceData:
    """The fixed-effect training batch on the device, with the static
    layouts its route may reduce over: the attach and its aligned-layout
    gate are the reference's (``coordinate.py:664-676``), so the measured
    ``auto`` sees the same candidates.  With a downsampling rate below 1 the
    batch holds the sampler's rows (``train_rows``) at their corrected
    weights, as the reference's (``coordinate.py:624-631``)."""

    def __init__(self, data: GameDataset, config: FixedEffectCoordinateConfig,
                 device=None, build_fm: bool = True):
        self.device = resolve_device(device)
        shard = data.shard(config.shard_name)
        self.dim = shard.dim
        label, offset, weight = data.label, data.offset, data.weight
        self.train_rows: Optional[np.ndarray] = None
        self._train_rows_dev: Optional[Tensor] = None
        if config.downsampling_rate < 1.0:
            from photon_tpu_torch.data.sampling import get_down_sampler

            sampler = get_down_sampler(config.downsampler, config.downsampling_rate)
            keep, weight = sampler.down_sample(label, weight, seed=config.seed)
            self.train_rows = keep
            shard = _gather_shard_rows(shard, keep)
            label, offset = label[keep], offset[keep]
        self.batch = shard_to_batch(shard, label, offset, weight, device=self.device)
        self.score_feats: Optional[tuple] = None
        if build_fm and isinstance(self.batch, SparseBatch):
            from photon_tpu_torch.data.batch import attach_feature_major
            from photon_tpu_torch.ops.sparse_grad_select import aligned_layout_wanted

            e_total = int(self.batch.ids.numel())
            self.batch = attach_feature_major(
                self.batch,
                aligned_dim=(self.dim if aligned_layout_wanted(e_total, self.device)
                             else None),
            )

    def offsets_to_device(self, offsets) -> Tensor:
        """The residual engine's device vector, or a host vector
        (``--residuals host``) uploaded; at the sampled rows when the batch
        is a down-sample."""
        if not isinstance(offsets, Tensor):
            if self.train_rows is not None:
                offsets = offsets[self.train_rows]
            return torch.as_tensor(np.asarray(offsets, np.float32), device=self.device)
        offsets = offsets.to(self.device)
        if self.train_rows is None:
            return offsets
        if self._train_rows_dev is None:
            self._train_rows_dev = torch.as_tensor(self.train_rows, device=self.device)
        return offsets.index_select(0, self._train_rows_dev)


class RandomEffectDeviceData:
    """The entities of one random-effect data configuration, grouped into
    size bins (``batched_solve.bin_layout``) and uploaded once: per bin the
    ``[E, R, ...]`` features, labels, weights and entity indices.  Padded
    entities (none on one device, where ``pad_bucket_entities`` adds
    nothing) would carry ``entity_index == num_entities``, the coefficient
    table's dummy slot."""

    def __init__(self, data: GameDataset, config: RandomEffectCoordinateConfig,
                 device=None):
        from photon_tpu_torch.game.batched_solve import bin_layout

        self.device = resolve_device(device)
        self.config = config
        self.dataset: RandomEffectDataset = build_random_effect_dataset(
            data, entity_column=config.entity_column, shard_name=config.shard_name,
            active_row_cap=config.active_row_cap, seed=config.seed,
        )
        self.dim = self.dataset.dim
        self.score_feats: Optional[tuple] = None
        self.score_entity_idx: Optional[Tensor] = None
        self.buckets: list = []
        self.device_buckets: list = []
        self.bin_stats: list = []
        raw = self.dataset.buckets
        for group in bin_layout(raw):
            merged = merge_buckets([raw[i] for i in group])
            live_entities = merged.num_entities
            live_rows = int((merged.row_weight > 0).sum())
            merged = pad_bucket_entities(merged, 1, self.dataset.num_entities)
            self.buckets.append(merged)
            self.bin_stats.append({
                "capacity": merged.row_capacity,
                "live_entities": live_entities,
                "total_entities": merged.num_entities,
                "live_rows": live_rows,
            })
            self.device_buckets.append(self._upload(merged))

    def _upload(self, bucket) -> dict:
        dev = self.device
        feats, dense = shard_feats(bucket.features, dev)
        if not dense:  # int64 once here: every lane evaluation gathers by them
            feats = (feats[0].long(), feats[1])
        return {
            "feats": feats, "dense": dense,
            "label": torch.as_tensor(bucket.label, device=dev),
            "weight": torch.as_tensor(bucket.row_weight, device=dev),
            "entity_index": torch.as_tensor(bucket.entity_index, device=dev).long(),
            "solve_dim": self.dim,
            "w0": torch.zeros(bucket.num_entities, self.dim, dtype=torch.float32,
                              device=dev),
        }

    def gather_buffers(self, i: int) -> tuple[Tensor, Tensor]:
        """Bin ``i``'s ``row_index`` and row mask on the device, uploaded on
        first use (a host-mode run never needs them)."""
        dev = self.device_buckets[i]
        if "row_index" not in dev:
            bucket = self.buckets[i]
            dev["row_index"] = torch.as_tensor(bucket.row_index, device=self.device)
            dev["row_mask"] = torch.as_tensor(
                (bucket.row_weight > 0).astype(np.float32), device=self.device)
        return dev["row_index"], dev["row_mask"]

    def bin_offsets(self, i: int, offsets) -> Tensor:
        """Bin ``i``'s ``[E, R]`` training offsets: a device gather of the
        engine's vector, or the host path's fancy index and upload."""
        if isinstance(offsets, Tensor):
            row_index, row_mask = self.gather_buffers(i)
            return offsets[row_index] * row_mask
        bucket = self.buckets[i]
        return torch.as_tensor(
            (offsets[bucket.row_index] * (bucket.row_weight > 0)).astype(np.float32),
            device=self.device)

    def batch_for(self, i: int, offsets_b: Tensor):
        dev = self.device_buckets[i]
        if dev["dense"]:
            return DenseBatch(dev["feats"][0], dev["label"], offsets_b, dev["weight"])
        return SparseBatch(dev["feats"][0], dev["feats"][1], dev["label"],
                           offsets_b, dev["weight"])


class _CountingObjective:
    """A GlmObjective that counts its value-and-gradient evaluations."""

    def __init__(self, objective: GlmObjective):
        self._objective = objective
        self.evaluations = 0

    def value_and_grad(self, w, batch):
        self.evaluations += 1
        return self._objective.value_and_grad(w, batch)

    def __getattr__(self, name):
        return getattr(self._objective, name)


class FixedEffectCoordinate:
    """One GLM fit over the whole training batch."""

    kind = "fixed"

    def __init__(self, data: GameDataset, config: FixedEffectCoordinateConfig,
                 task_type: str, device=None,
                 device_data: Optional[FixedEffectDeviceData] = None,
                 normalization: Optional[NormalizationContext] = None):
        self.data = data
        self.config = config
        self.task_type = task_type
        self.device_data = device_data or FixedEffectDeviceData(data, config, device)
        self.device = self.device_data.device
        self.dim = self.device_data.dim
        if normalization is not None:
            if len(normalization.factors_or_ones(self.dim)) != self.dim:
                raise ValueError(
                    f"normalization context dim mismatch for shard "
                    f"{config.shard_name!r} (expected {self.dim})"
                )
            normalization = normalization.to(self.device)
        self.normalization = normalization
        self.objective = _CountingObjective(GlmObjective.create(
            task_type, config.problem.regularization, normalization))
        self.problem = GlmOptimizationProblem(self.objective, config.problem)

    def train(self, offsets, initial_model: Optional[FixedEffectModel] = None):
        """One fit against the other coordinates' scores as offsets; returns
        ``(model, tracker)``.  The tracker carries ``quarantined``,
        ``evaluations``, ``host_reads`` and ``wall_time_s``."""
        batch = self.device_data.batch
        batch = batch._replace(offset=self.device_data.offsets_to_device(offsets))
        w0 = None
        if initial_model is not None:
            w0 = initial_model.coefficients.means
            if self.normalization is not None:
                w0 = self.normalization.model_to_normalized_space(w0)
        evaluations = self.objective.evaluations
        t0 = time.perf_counter()
        coefficients, result = self.problem.run(batch, w0, dim=self.dim)
        tracker = OptimizationStatesTracker(result, time.perf_counter() - t0)
        tracker.evaluations = self.objective.evaluations - evaluations
        tracker.host_reads = result.host_reads
        means, variances = coefficients.means, coefficients.variances
        # Non-finite guard: a diverged solve keeps the previous iterate (or
        # zeros on a cold start).  The solve has already read the host, so
        # this is a d-sized read, not a new sync in the hot loop.
        tracker.quarantined = 0
        if not bool(torch.isfinite(means).all()):
            tracker.quarantined = 1
            if initial_model is not None:
                prev = initial_model.coefficients
                means, variances = prev.means, prev.variances
            else:
                means, variances = torch.zeros_like(means), None
        model = FixedEffectModel(
            model=model_for_task(self.task_type, Coefficients(means, variances)),
            shard_name=self.config.shard_name,
        )
        return model, tracker

    def score(self, model: FixedEffectModel) -> np.ndarray:
        return model.score(self.data)

    def score_device(self, model: FixedEffectModel) -> Tensor:
        """Training-data margins on the device; the shard's features upload
        once.  A model on another shard scores through its host path."""
        if model.shard_name != self.config.shard_name:
            return torch.as_tensor(model.score(self.data), device=self.device)
        holder = self.device_data
        if holder.score_feats is None:
            holder.score_feats = shard_feats(
                self.data.shard(self.config.shard_name), self.device)
        feats, dense = holder.score_feats
        return model.margins_device(feats, dense)


class RandomEffectCoordinate:
    """Per-entity GLM fits, each size bin's entities solved together by the
    batched damped Newton; early-converging entities freeze while the
    others iterate."""

    kind = "random"

    def __init__(self, data: GameDataset, config: RandomEffectCoordinateConfig,
                 task_type: str, device=None,
                 device_data: Optional[RandomEffectDeviceData] = None):
        self.data = data
        self.config = config
        self.task_type = task_type
        self.device_data = device_data or RandomEffectDeviceData(data, config, device)
        self.device = self.device_data.device
        self.dataset = self.device_data.dataset
        self.dim = self.dataset.dim
        self.objective = LaneObjective.of(
            GlmObjective.create(task_type, config.problem.regularization))
        # Every bin's route is resolved now, so a route the port does not
        # carry raises before any work.
        self.routes = [
            solver_route(config.problem, dev["solve_dim"])
            for dev in self.device_data.device_buckets
        ]
        self.telemetry = None
        record_bin_telemetry(self.telemetry, config.shard_name,
                             self.device_data.bin_stats, self.routes)

    def _initial_table(self, initial_model: RandomEffectModel) -> Tensor:
        """The warm-start table with the dummy row appended.  Descent
        re-passes the model this coordinate trained, whose keys are the
        dataset's own: that stays on the device."""
        if initial_model.dim != self.dim:
            raise ValueError(
                f"warm-start model dim {initial_model.dim} != coordinate dim {self.dim}"
            )
        if not keys_match(initial_model.keys, self.dataset.keys):
            raise NotImplementedError(
                "warm starts from another entity vocabulary wait in "
                "ROADMAP.md queue 1, item 5"
            )
        table = initial_model.table.to(self.device, torch.float32)
        return torch.cat([table, torch.zeros(1, self.dim, dtype=table.dtype,
                                             device=self.device)])

    def train(self, offsets, initial_model: Optional[RandomEffectModel] = None):
        """Solve every entity; returns ``(model, DeferredSolveStats)``."""
        num_entities = self.dataset.num_entities
        dev = self.device
        cfg = self.config.problem
        # The extra dummy row absorbs padded entities' writes.
        table = torch.zeros(num_entities + 1, self.dim, dtype=torch.float32, device=dev)
        var_table = (torch.zeros_like(table)
                     if cfg.variance_computation != "none" else None)
        init_table = (None if initial_model is None
                      else self._initial_table(initial_model))
        acc = torch.zeros(6, dtype=torch.int32, device=dev)
        bins = []
        for i in range(len(self.device_data.buckets)):
            t0 = time.perf_counter()
            batch = self.device_data.batch_for(
                i, self.device_data.bin_offsets(i, offsets))
            bucket = self.device_data.device_buckets[i]
            entity_idx = bucket["entity_index"]
            w0 = bucket["w0"] if init_table is None else init_table[entity_idx]
            coefficients, result = run_newton_fit(
                self.objective, batch, w0, cfg=cfg.optimizer_config,
                variance=cfg.variance_computation,
            )
            means, variances = coefficients.means, coefficients.variances
            # Non-finite guard: entities whose solve diverged keep their
            # previous row (zero on a cold start).  Duplicate indices write
            # only the dummy row, which is dropped.
            good = torch.isfinite(means).all(dim=1)
            fallback = (torch.zeros_like(means) if init_table is None
                        else init_table[entity_idx])
            table[entity_idx] = torch.where(good[:, None], means, fallback)
            if var_table is not None:
                var_table[entity_idx] = torch.where(
                    good[:, None], variances, torch.zeros_like(variances))
            acc = _accumulate_solve_stats(acc, entity_idx, num_entities,
                                          result.converged, result.iterations, good)
            stats = self.device_data.bin_stats[i]
            # Host clock to the Newton loop's last read: the polish and the
            # table write run on into the next bin's time.
            bins.append({
                "bin": i, "entities": stats["live_entities"],
                "capacity": stats["capacity"], "route": self.routes[i],
                "newton_iterations": result.loop_iterations,
                "host_reads": result.host_reads,
                "seconds": time.perf_counter() - t0,
            })
        model = RandomEffectModel(
            table=table[:num_entities], keys=self.dataset.keys,
            entity_column=self.config.entity_column,
            shard_name=self.config.shard_name, task_type=self.task_type,
            variances=None if var_table is None else var_table[:num_entities],
        )
        return model, DeferredSolveStats(acc, bins)

    def score(self, model: RandomEffectModel) -> np.ndarray:
        return model.score(self.data)

    def score_device(self, model: RandomEffectModel) -> Tensor:
        """Training-data margins on the device: a gather-join against the
        cached per-row entity index (a model on another shard or column,
        or another vocabulary, scores through its host path)."""
        if (model.shard_name != self.config.shard_name
                or model.entity_column != self.config.entity_column
                or not keys_match(model.keys, self.dataset.keys)):
            return torch.as_tensor(model.score(self.data), device=self.device)
        holder = self.device_data
        if holder.score_feats is None:
            holder.score_feats = shard_feats(
                self.data.shard(self.config.shard_name), self.device)
            holder.score_entity_idx = torch.as_tensor(
                self.dataset.entity_idx_per_row, device=self.device)
        feats, dense = holder.score_feats
        return model.margins_device(holder.score_entity_idx, feats, dense)


def build_coordinate(data: GameDataset, config: CoordinateConfig, task_type: str,
                     device=None, normalization: Optional[NormalizationContext] = None,
                     device_data=None):
    if isinstance(config, FixedEffectCoordinateConfig):
        return FixedEffectCoordinate(data, config, task_type, device, device_data,
                                     normalization)
    if isinstance(config, RandomEffectCoordinateConfig):
        if normalization is not None:
            raise ValueError(
                "normalization is not supported for random-effect coordinates "
                f"(coordinate on shard {config.shard_name!r})"
            )
        return RandomEffectCoordinate(data, config, task_type, device, device_data)
    raise TypeError(f"unknown coordinate config type {type(config)!r}")

