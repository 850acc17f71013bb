"""Streamed GAME coordinate descent (out-of-core training).

Counterpart of ``photon_tpu/game/stream_descent.py``.  The resident
:class:`~photon_tpu_torch.game.descent.CoordinateDescent` holds every
coordinate's training data and the ``[C, n]`` score tables on the device.
Here the dataset and the score state stay in host memory
(``game/tiles.py``), and each coordinate's train, re-score and validate
loop maps over fixed-size row chunks streamed to the device:

- **Fixed effect**: the port's host-loop L-BFGS (``data/streaming.
  streaming_lbfgs``), every objective evaluation one pass over the chunks.
  Each chunk's data value and gradient come from the row-major
  ``autodiff`` route (``_fast_data_value_and_grad``; the reference keeps
  bare streamed chunks off its fused kernel too) and land, copied
  ``non_blocking`` into one pinned buffer, in the reference's host float64
  Neumaier accumulator: one wait a pass, and the chunk count does not move
  the fit.
- **Random effect**: each size bin's entities are solved in budget-sized
  sub-blocks uploaded through the same streamer, along the bin's route
  (``game/batched_solve.solver_route``: Newton, Newton-CG or the lane
  solvers).  Every lane's arithmetic is its own, so the block split cannot
  move an entity.
- **Re-score and validate**: per-chunk margins land in the host score
  tiles; validation evaluates the tiled composite on the host.

Solve statistics keep the resident contract: the random-effect
accumulators stay on the device and drain in one read at the iteration
boundary.  A checkpointed run resolves each coordinate's statistics as it
finishes, so that its mid-epoch snapshot carries the quarantine count.

Mid-epoch restart: after every coordinate the full restart state (models,
the score rows, the **chunk cursor** and per-chunk **tile digests**) goes
to the checkpointer, so a fit killed mid-epoch resumes at that coordinate
boundary with the same tiles (the digests are checked at load).  The
``descent:kill`` fault site fires both at the iteration boundary and before
each coordinate.  The checkpoint is the reference's format: either package
resumes the other's.

With a ``SpillContext`` (``spill``) the residual tiles and the feature
chunks live one tier lower, in the part files of ``game/tile_store.py``
behind the budgeted host cache; the loop keeps its shape.  Chunk loads
read disk -> host -> device, the dirty tiles are written back at the end of
every sweep and before every checkpoint, and a spilled checkpoint carries
no score rows: its tile digests reference the tiles on disk.  A resume
adopts them when their digests match, rebuilds them from the checkpointed
models when they are stale, and refuses a corrupt part file
(``CorruptTileError``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.data.batch import DenseBatch, SparseBatch
from photon_tpu_torch.fault import QuarantineBudgetError
from photon_tpu_torch.fault.checkpoint import (
    CheckpointError,
    DescentState,
    descent_fingerprint,
    require_fingerprint,
)
from photon_tpu_torch.fault.injection import consume_nan_injection, fault_point
from photon_tpu_torch.game.batched_solve import (
    LaneObjective,
    bin_layout,
    record_bin_telemetry,
    run_lane_fit,
    run_newton_cg_fit,
    run_newton_fit,
    solver_route,
)
from photon_tpu_torch.game.coordinate import (
    DeferredSolveStats,
    _accumulate_solve_stats,
    _align_foreign_table,
)
from photon_tpu_torch.game.data import (
    DenseShard,
    EntityBucket,
    GameDataset,
    SparseShard,
    build_random_effect_dataset,
    entity_index_for,
    keys_match,
    merge_buckets,
    pad_bucket_entities,
)
from photon_tpu_torch.game.descent import DescentResult, _coordinate_record
from photon_tpu_torch.game.model import FixedEffectModel, GameModel, RandomEffectModel
from photon_tpu_torch.game.tiles import (
    ChunkPlan,
    ChunkStreamer,
    HostBuffer,
    NeumaierAccumulator,
    ResidentChunkSource,
    SpillContext,
    SpilledResidualTable,
    TiledResidualTable,
    TiledValidationTable,
    cached_entity_index,
    entity_index_cache,
    per_row_bytes,
    score_model_chunks,
)
from photon_tpu_torch.telemetry import NULL_SESSION

# The streamed-mode marker in checkpoint fingerprints: a streamed fit's
# numerics depend on the chunked accumulation order, so its checkpoints
# resume only streamed runs of the same chunk size, never a resident fit.
STREAM_RESIDUAL_MODE = "stream"


def stream_fingerprint(task_type, coordinate_names, num_examples: int,
                       chunk_rows: int, config_key=None, validation_key=None,
                       locked=(), warm_start: bool = False,
                       coordinate_kinds=None) -> dict:
    """The streamed descent's checkpoint fingerprint: the resident one with
    ``residual_mode == "stream"`` and the chunk size (chunk boundaries fix
    the fixed effect's accumulation order, so another ``chunk_rows`` is
    refused)."""
    fp = descent_fingerprint(
        task_type, coordinate_names, num_examples, STREAM_RESIDUAL_MODE,
        config_key=config_key, validation_key=validation_key, locked=locked,
        warm_start=warm_start, coordinate_kinds=coordinate_kinds,
    )
    fp["stream"] = {"chunk_rows": int(chunk_rows)}
    return fp


def _require_streamable_problem(config, what: str) -> None:
    """Refuse, at build time, what the streamed solvers do not compute."""
    if config.problem.variance_computation != "none":
        raise ValueError(
            f"{what}: variance computation is not supported under "
            "--stream-chunks (the streamed solvers return means only)")


# ---------------------------------------------------------------------------
# Streamed fixed-effect coordinate
# ---------------------------------------------------------------------------


class _StreamedObjective:
    """``streaming_lbfgs``'s surface: every evaluation is one streamed pass
    against offsets fixed for the train."""

    def __init__(self, coord, offsets: list):
        self.coord = coord
        self.offsets = offsets
        self.evaluations = 0

    def value_and_grad(self, w):
        self.evaluations += 1
        return self.coord._streamed_value_and_grad(w, self.offsets)


class StreamedFixedEffectCoordinate:
    """A whole-dataset GLM fit that never holds the dataset on the device:
    a host-loop L-BFGS whose every evaluation maps the per-chunk value and
    gradient over the chunk stream and reduces across chunks."""

    kind = "fixed"

    def __init__(self, data: GameDataset, config, task_type: str,
                 plan: ChunkPlan, streamer: ChunkStreamer, normalization=None,
                 source=None):
        from photon_tpu_torch.core.objective import GlmObjective

        if config.downsampling_rate < 1.0:
            raise ValueError(
                "streamed GAME does not support fixed-effect downsampling "
                "(chunk layouts are contiguous row windows); train resident "
                "or drop downsample=")
        if config.problem.optimizer.lower() not in ("lbfgs", "l-bfgs"):
            raise ValueError(
                "streamed GAME fixed effect supports the lbfgs optimizer "
                f"(got {config.problem.optimizer!r}); OWL-QN/TRON have no "
                "streamed host loop yet")
        if normalization is not None:
            raise ValueError(
                "streamed GAME does not support fixed-effect normalization "
                "(the per-chunk objective is the plain one)")
        _require_streamable_problem(config, "streamed fixed effect")
        self.data = data
        self.config = config
        self.task_type = task_type
        self.plan = plan
        self.streamer = streamer
        self.device = streamer.device
        shard = data.shard(config.shard_name)
        self.dim = shard.dim
        self._dense = isinstance(shard, DenseShard)
        self.objective = GlmObjective.create(task_type, config.problem.regularization)
        self.fault_name: Optional[str] = None
        # Where the chunks' features come from: host slices of ``data``, or
        # the spilled disk tier through the host cache.
        self.source = source or ResidentChunkSource(data, plan)

    def _chunk_batch(self, k: int, offsets: list):
        """Worker-side chunk load: chunk ``k``'s rows and this coordinate's
        training offsets, host arrays."""
        sub = self.source.chunk(k)
        shard = sub.shard(self.config.shard_name)
        if self._dense:
            return DenseBatch(shard.x, sub.label, offsets[k], sub.weight)
        return SparseBatch(shard.ids, shard.vals, sub.label, offsets[k], sub.weight)

    def _streamed_value_and_grad(self, w: torch.Tensor, offsets: list):
        """One pass: each chunk's data value and gradient on the device,
        copied into one host buffer, then the reference's compensated
        float64 reduce over the chunks in order, and the L2 term in float64
        on the host."""
        data_obj = dataclasses.replace(self.objective, l2_weight=0.0, l1_weight=0.0)
        n_chunks = self.plan.num_chunks
        rows = HostBuffer((n_chunks + 1, self.dim + 1), self.device)
        rows.buf[n_chunks, 1:].copy_(w, non_blocking=True)
        kernel = None if self._dense else "autodiff"
        k = 0
        for chunk in self.streamer.stream(lambda j: self._chunk_batch(j, offsets),
                                          n_chunks):
            v, g = data_obj._fast_data_value_and_grad(w, chunk, kernel)
            rows.buf[k].copy_(torch.cat([v.reshape(1).float(), g.float()]),
                              non_blocking=True)
            k += 1
        host = rows.read()
        acc = NeumaierAccumulator(self.dim)
        for j in range(n_chunks):
            acc.add(float(host[j, 0]), host[j, 1:])
        total_v, total_g = acc.value, acc.grad
        l2 = self.objective.l2_weight
        if l2:
            w_host = host[n_chunks, 1:].astype(np.float64)
            total_v += 0.5 * l2 * float(w_host @ w_host)
            total_g = total_g + l2 * w_host
        # The value stays on the host (the loop reads it as a float); the
        # gradient goes back from pinned memory without a wait.
        g = torch.from_numpy(total_g.astype(np.float32))
        if w.device.type == "cuda":
            g = g.pin_memory().to(w.device, non_blocking=True)
        return torch.tensor(np.float32(total_v)), g

    def train(self, offsets, initial_model: Optional[FixedEffectModel] = None):
        """One streamed GLM fit against the tiled offsets (``offsets.chunk(k)``
        per chunk, fixed for the train); returns ``(model, tracker)``."""
        from photon_tpu_torch.core.optimizers import OptimizationStatesTracker
        from photon_tpu_torch.data.streaming import streaming_lbfgs
        from photon_tpu_torch.models.glm import Coefficients, model_for_task

        sobj = _StreamedObjective(
            self, [offsets.chunk(k) for k in range(self.plan.num_chunks)])
        w0 = torch.zeros(self.dim, dtype=torch.float32, device=self.device)
        if initial_model is not None:
            w0 = initial_model.coefficients.means.to(self.device, torch.float32)
        t0 = time.perf_counter()
        result = streaming_lbfgs(sobj, w0, self.config.problem.optimizer_config)
        tracker = OptimizationStatesTracker(result, time.perf_counter() - t0)
        tracker.evaluations = tracker.host_reads = sobj.evaluations
        means = result.w
        if consume_nan_injection(self.fault_name):
            means = means.clone()
            means[0] = float("nan")
        # Non-finite guard: a poisoned solve keeps the previous iterate
        # (the loop read the host every pass; this is a d-sized reduce).
        tracker.quarantined = 0
        # host-sync: the non-finite guard of the streamed fixed effect.
        if not bool(torch.isfinite(means).all()):
            tracker.quarantined = 1
            means = (w0 if initial_model is not None else torch.zeros_like(means))
        model = FixedEffectModel(
            model=model_for_task(self.task_type, Coefficients(means, None)),
            shard_name=self.config.shard_name)
        return model, tracker

    def score_stream(self, model: FixedEffectModel) -> np.ndarray:
        """Training-data margins assembled chunk by chunk (host ``[n]``)."""
        if model.shard_name != self.config.shard_name:
            return np.asarray(model.score(self.data), np.float32)
        return score_model_chunks(model, self.data, self.plan, self.streamer,
                                  source=self.source)


# ---------------------------------------------------------------------------
# Streamed random-effect coordinate
# ---------------------------------------------------------------------------


class StreamedRandomEffectHostData:
    """Host-side bucketed layout of one random-effect coordinate: the
    resident layout's entity grouping and size-binned merge, the padded
    ``[E, R, ...]`` bins kept in host memory (the train uploads entity
    sub-blocks through the streamer).  Shared across sweep configurations
    by the estimator."""

    def __init__(self, data: GameDataset, config):
        self.config = config
        self.dataset = build_random_effect_dataset(
            data, entity_column=config.entity_column, shard_name=config.shard_name,
            active_row_cap=config.active_row_cap, seed=config.seed,
        )
        self.dim = self.dataset.dim
        raw = self.dataset.buckets
        self.bins = [merge_buckets([raw[i] for i in group])
                     for group in bin_layout(raw)]
        self.bin_stats = [{
            "capacity": b.row_capacity, "live_entities": b.num_entities,
            "total_entities": b.num_entities,
            "live_rows": int((b.row_weight > 0).sum()),
        } for b in self.bins]
        # Foreign warm-start joins (``coordinate._foreign_src_idx``).
        self._warm_join_cache: dict = {}

    def entity_bytes(self, bucket: EntityBucket) -> int:
        """Bytes one entity of ``bucket`` occupies (features, label, weight
        and offsets, and its int64 table index): the sub-block sizing
        unit."""
        feats = bucket.features
        if isinstance(feats, DenseShard):
            per = feats.x.dtype.itemsize * feats.x.shape[2]
        else:
            per = (feats.ids.dtype.itemsize + feats.vals.dtype.itemsize) * feats.ids.shape[2]
        return bucket.row_capacity * (per + 12) + 8


def _slice_bucket(bucket: EntityBucket, e0: int, e1: int) -> EntityBucket:
    """Entity-axis window ``[e0, e1)`` of a host bucket (numpy views)."""
    feats = bucket.features
    if isinstance(feats, DenseShard):
        feats = DenseShard(feats.x[e0:e1])
    else:
        feats = SparseShard(feats.ids[e0:e1], feats.vals[e0:e1], feats.dim_)
    return EntityBucket(
        row_capacity=bucket.row_capacity,
        entity_index=bucket.entity_index[e0:e1],
        row_index=bucket.row_index[e0:e1],
        row_weight=bucket.row_weight[e0:e1],
        label=bucket.label[e0:e1],
        features=feats,
    )


class StreamedRandomEffectCoordinate:
    """Per-entity GLM fits whose bin blocks stream through the chunk
    budget: each size bin's entities are solved in fixed-size sub-blocks
    (the last padded to the bin's block shape), uploaded while the previous
    block solves.  Row-split placement is refused by its configuration
    (``RandomEffectCoordinateConfig``, item 10)."""

    kind = "random"

    def __init__(self, data: GameDataset, config, task_type: str, plan: ChunkPlan,
                 streamer: ChunkStreamer,
                 host_data: Optional[StreamedRandomEffectHostData] = None,
                 source=None):
        from photon_tpu_torch.core.objective import GlmObjective

        if config.projection != "none":
            raise ValueError(
                "streamed GAME random effects support projection=none only "
                f"(got {config.projection!r}); projected solves are a "
                "resident-mode feature")
        _require_streamable_problem(config, "streamed random effect")
        self.data = data
        self.config = config
        self.task_type = task_type
        self.plan = plan
        self.streamer = streamer
        self.device = streamer.device
        self.source = source  # the spilled chunk features, for re-scoring
        self.device_data = host_data or StreamedRandomEffectHostData(data, config)
        self.dataset = self.device_data.dataset
        self.dim = self.dataset.dim
        # The chunk budget in bytes bounds each in-flight entity block as it
        # bounds a row chunk.
        self.block_budget = max(1, plan.chunk_rows * per_row_bytes(data))
        self.objective = LaneObjective.of(
            GlmObjective.create(task_type, config.problem.regularization))
        self.name = config.shard_name
        self.fault_name: Optional[str] = None
        self.telemetry = NULL_SESSION
        self._bins_recorded = False

    def bin_blocks(self) -> list:
        """The block schedule ``[(bin, e0, e1, block_entities)]``: every
        bin's entity axis cut into budget-sized windows, the last window of
        a bin padded up to ``block_entities`` (one shape a bin)."""
        blocks = []
        for i, bucket in enumerate(self.device_data.bins):
            e_bytes = self.device_data.entity_bytes(bucket)
            e_sub = max(1, min(bucket.num_entities,
                               self.block_budget // max(1, e_bytes)))
            for e0 in range(0, bucket.num_entities, e_sub):
                blocks.append((i, e0, min(bucket.num_entities, e0 + e_sub), e_sub))
        return blocks

    @property
    def routes(self) -> list:
        """Each bin's route (``batched_solve.solver_route``)."""
        return [solver_route(self.config.problem, self.dim)
                for _ in self.device_data.bins]

    def _load_block(self, block, offsets_full: np.ndarray):
        """Worker-side block load: slice and pad the host bin and gather the
        block's training offsets from the tiled offsets vector."""
        i, e0, e1, e_sub = block
        sub = _slice_bucket(self.device_data.bins[i], e0, e1)
        if sub.num_entities < e_sub:
            sub = pad_bucket_entities(sub, e_sub, self.dataset.num_entities)
        off = (offsets_full[sub.row_index] * (sub.row_weight > 0)).astype(np.float32)
        feats = sub.features
        if isinstance(feats, DenseShard):
            batch = DenseBatch(feats.x, sub.label, off, sub.row_weight)
        else:
            batch = SparseBatch(feats.ids, feats.vals, sub.label, off, sub.row_weight)
        return batch, sub.entity_index.astype(np.int64)

    def _solve_block(self, route: str, batch, w0: torch.Tensor):
        cfg = self.config.problem
        if route == "newton":
            return run_newton_fit(self.objective, batch, w0, cfg=cfg.optimizer_config,
                                  variance="none")
        if route == "newton_cg":
            return run_newton_cg_fit(self.objective, batch, w0,
                                     cfg=cfg.optimizer_config, variance="none")
        return run_lane_fit(self.objective, batch, w0, optimizer=cfg.optimizer,
                            cfg=cfg.optimizer_config, variance="none")

    def _initial_table(self, initial_model: RandomEffectModel) -> torch.Tensor:
        """The key-aligned warm-start table with the dummy row; a foreign
        vocabulary joins on the host (cached per keys object)."""
        if initial_model.dim != self.dim:
            raise ValueError(
                f"warm-start model dim {initial_model.dim} != coordinate dim {self.dim}")
        if keys_match(initial_model.keys, self.dataset.keys):
            table = initial_model.table.to(self.device, torch.float32)
            return torch.cat([table, torch.zeros(1, self.dim, dtype=table.dtype,
                                                 device=self.device)])
        return torch.as_tensor(_align_foreign_table(self, initial_model),
                               device=self.device)

    def train(self, offsets, initial_model: Optional[RandomEffectModel] = None):
        """Solve every entity, streaming bin sub-blocks through the chunk
        budget; returns ``(model, DeferredSolveStats)``, the statistics on
        the device for the descent's boundary read."""
        num_entities = self.dataset.num_entities
        dev = self.device
        offsets_full = offsets.full()
        table = torch.zeros(num_entities + 1, self.dim, dtype=torch.float32, device=dev)
        init_table = (None if initial_model is None
                      else self._initial_table(initial_model))
        acc = torch.zeros(6, dtype=torch.int32, device=dev)
        inject_nan = consume_nan_injection(self.fault_name)
        routes = self.routes
        if not self._bins_recorded:
            record_bin_telemetry(self.telemetry, self.name, self.device_data.bin_stats,
                                 routes)
            self._bins_recorded = True
        blocks = self.bin_blocks()
        records = []
        t0 = time.perf_counter()
        for j, (batch, entity_idx) in enumerate(self.streamer.stream(
                lambda b: self._load_block(blocks[b], offsets_full), len(blocks))):
            i, e0, e1, _ = blocks[j]
            if isinstance(batch, SparseBatch):
                # int64 once a block: every lane evaluation gathers by them.
                batch = batch._replace(ids=batch.ids.long())
            w0 = (torch.zeros(entity_idx.shape[0], self.dim, dtype=torch.float32,
                              device=dev)
                  if init_table is None else init_table[entity_idx])
            coefficients, result = self._solve_block(routes[i], batch, w0)
            means = coefficients.means
            if inject_nan and j == 0:
                means = means.clone()
                means[0] = float("nan")
            # Non-finite guard: a diverged entity keeps its previous row
            # (zero on a cold start); pads write the dropped dummy row.
            good = torch.isfinite(means).all(dim=1)
            fallback = torch.zeros_like(means) if init_table is None else w0
            table[entity_idx] = torch.where(good[:, None], means, fallback)
            acc = _accumulate_solve_stats(acc, entity_idx, num_entities,
                                          result.converged, result.iterations, good,
                                          result.cg_iterations)
            now = time.perf_counter()
            records.append({
                "bin": i, "block": [e0, e1], "entities": e1 - e0,
                "capacity": self.device_data.bins[i].row_capacity, "route": routes[i],
                "solve_dim": self.dim, "loop_iterations": result.loop_iterations,
                "host_reads": result.host_reads, "seconds": now - t0,
            })
            t0 = now
        model = RandomEffectModel(
            table=table[:num_entities], keys=self.dataset.keys,
            entity_column=self.config.entity_column,
            shard_name=self.config.shard_name, task_type=self.task_type,
        )
        return model, DeferredSolveStats(acc, records)

    def score_stream(self, model: RandomEffectModel) -> np.ndarray:
        """Training-data margins assembled chunk by chunk (host ``[n]``)."""
        if (model.shard_name != self.config.shard_name
                or model.entity_column != self.config.entity_column):
            return np.asarray(model.score(self.data), np.float32)
        if keys_match(model.keys, self.dataset.keys):
            idx = self.dataset.entity_idx_per_row
        else:
            idx = entity_index_for(self.data.id_columns[self.config.entity_column],
                                   np.asarray(model.keys))
        return score_model_chunks(model, self.data, self.plan, self.streamer,
                                  entity_idx=idx, source=self.source)


# ---------------------------------------------------------------------------
# The streamed descent loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _TiledOffsets:
    """A coordinate's view of its tiled training offsets: ``chunk(k)`` for
    the fixed effect's chunks, ``full()`` for the random effect's row
    gather (the same values either way)."""

    table: TiledResidualTable
    name: str

    def chunk(self, k: int) -> np.ndarray:
        return self.table.offsets_chunk(self.name, k)

    def full(self) -> np.ndarray:
        return self.table.offsets_full(self.name)


class StreamedCoordinateDescent:
    """Coordinate descent over the chunk stream: the resident loop's
    contract (update order, residual passing, validation, the quarantine
    budget, preemption, checkpoint and resume) with the score state in host
    tiles.  Built by :class:`~photon_tpu_torch.game.estimator.GameEstimator`
    when ``stream_chunks`` is set."""

    def __init__(self, coordinates: Dict[str, object], task_type: str,
                 training_data: GameDataset,
                 validation_data: Optional[GameDataset] = None, evaluators=None,
                 plan: Optional[ChunkPlan] = None,
                 streamer: Optional[ChunkStreamer] = None, logger=None,
                 telemetry=None, spill: Optional[SpillContext] = None):
        if not coordinates:
            raise ValueError("StreamedCoordinateDescent needs at least one coordinate")
        self.coordinates = dict(coordinates)
        self.task_type = task_type
        self.training_data = training_data
        self.validation_data = validation_data
        self.evaluators = evaluators
        self.logger = logger or logging.getLogger("photon_tpu_torch.game.stream")
        self.telemetry = telemetry or NULL_SESSION
        n = training_data.num_examples
        self.plan = plan or ChunkPlan(n, max(1, n))
        self.streamer = streamer or ChunkStreamer(self.telemetry)
        self.spill = spill
        self._val_idx_cache = entity_index_cache()

    # -- helpers -------------------------------------------------------------
    def _fingerprint(self, config_key=None, locked=(), warm_start=False) -> dict:
        has_validation = self.validation_data is not None and self.evaluators is not None
        return stream_fingerprint(
            self.task_type, self.coordinates, self.training_data.num_examples,
            self.plan.chunk_rows, config_key=config_key,
            validation_key=self.evaluators.primary.name if has_validation else None,
            locked=locked, warm_start=warm_start,
            coordinate_kinds={name: getattr(c, "kind", type(c).__name__)
                              for name, c in self.coordinates.items()},
        )

    def _val_plan(self) -> ChunkPlan:
        return ChunkPlan(self.validation_data.num_examples, self.plan.chunk_rows)

    def _score_validation(self, model) -> np.ndarray:
        """One coordinate model's margins over the validation rows, streamed
        per chunk (entity joins cached per vocabulary)."""
        idx = None
        if isinstance(model, RandomEffectModel):
            idx = cached_entity_index(self._val_idx_cache, self.validation_data,
                                      model.entity_column, model.keys)
        return score_model_chunks(model, self.validation_data, self._val_plan(),
                                  self.streamer, entity_idx=idx)

    def _evaluate(self, val_table: TiledValidationTable) -> Dict[str, float]:
        """The evaluators over the tiled composite margin, on the host."""
        data = self.validation_data
        scores = torch.as_tensor(val_table.composite_full())
        label, weight = torch.as_tensor(data.label), torch.as_tensor(data.weight)
        return {ev.name: float(ev.fn(scores, label, weight))
                for ev in self.evaluators.evaluators}

    def _snapshot(self, iteration: int, cursor: int, num_iterations: int, models,
                  best_model, best_metrics, best_iteration, history, residuals,
                  quarantined: int, fp: dict) -> DescentState:
        # A checkpoint sequence monotonic across epoch and cursor: mid-epoch
        # snapshots of iteration i+1 (cursor 1..C) sort after the
        # end-of-iteration-i one (cursor 0) and before i+1's.
        seq = (iteration + 1) * (len(self.coordinates) + 1) + cursor
        return DescentState(
            iteration=iteration, num_iterations=num_iterations,
            task_type=self.task_type, models=dict(models),
            best_models=dict(best_model.coordinates) if best_model is not None else {},
            best_metrics=dict(best_metrics), best_iteration=best_iteration,
            history=list(history), residual_rows=residuals.snapshot_rows(),
            quarantined=quarantined, fingerprint=fp,
            stream={"chunk_rows": int(self.plan.chunk_rows), "cursor": int(cursor),
                    "seq": int(seq), "tile_digests": residuals.tile_digests(),
                    # Informational: a spilled snapshot's rows are empty and
                    # its digests reference the tiles on disk.
                    "spilled": self.spill is not None},
        )

    # -- run -----------------------------------------------------------------
    def run(self, num_iterations: int, initial_model: Optional[GameModel] = None,
            locked_coordinates: Sequence[str] = (), checkpoint_fn=None,
            checkpointer=None, resume_state: Optional[DescentState] = None,
            max_quarantined: Optional[int] = None,
            config_key: Optional[str] = None) -> DescentResult:
        """As :meth:`CoordinateDescent.run`; a ``checkpointer`` also saves
        after every coordinate (the chunk-cursor snapshot)."""
        from photon_tpu_torch.fault.watchdog import complete

        try:
            result = self._run(num_iterations, initial_model, locked_coordinates,
                               checkpoint_fn, checkpointer, resume_state,
                               max_quarantined, config_key)
        except BaseException:
            if checkpointer is not None:
                checkpointer.drain(reraise=False)
            raise
        finally:
            complete("descent.iteration")
        if checkpointer is not None:
            with self.telemetry.span("descent.checkpoint.drain"):
                checkpointer.drain()
        return result

    def _resume(self, resume_state: DescentState, residuals, val_table):
        """Restore ``resume_state`` into the tables; returns its models.

        Saved rows load into the tiles, and must match the checkpoint's
        digests (else ``CheckpointError``).  A spilled checkpoint saves
        none: a spilled table adopts the tiles on disk (a corrupt one
        raises ``CorruptTileError``).  Where those disagree with the
        digests (a kill in the middle of a write-back, another residency
        than the writer's), the tiles are rebuilt from the checkpointed
        models, a pure function of them.  Rebuilt tiles that still differ
        from the digests were scored by other arithmetic than the writer's
        (the JAX package's, which does not write back before a mid-epoch
        checkpoint, or another device): they are kept, counted in
        ``tiles.rebuilt_unverified``, where the reference refuses."""
        stream_meta = resume_state.stream or {}
        models = dict(resume_state.models)
        rows = resume_state.residual_rows
        if rows:
            residuals.load_rows(rows)
        elif isinstance(residuals, SpilledResidualTable):
            residuals.attach_resume()
        saved = stream_meta.get("tile_digests")
        if saved is not None and residuals.tile_digests() != list(saved):
            if rows:
                raise CheckpointError(
                    "score-tile digests do not match the checkpoint's (per-chunk "
                    "state diverged); refusing to resume")
            self.telemetry.counter("tiles.rebuilt").inc()
            self.logger.info("the score tiles do not match the checkpoint; "
                             "rebuilding them from the checkpointed models")
            if isinstance(residuals, SpilledResidualTable):
                # Dropping the part files is the zero state.
                residuals.reset_store()
            else:
                residuals.clear()
            for name, model in models.items():
                residuals.update(name, self.coordinates[name].score_stream(model))
            residuals.drain_guard_flags()  # checkpointed rows were guarded
            if residuals.tile_digests() != list(saved):
                self.telemetry.counter("tiles.rebuilt_unverified").inc()
                self.logger.warning(
                    "the rebuilt score tiles differ from the checkpoint's digests "
                    "(another package's or device's arithmetic); resuming from the "
                    "rebuild")
        if val_table is not None:
            # The validation tiles are not saved: the saved models re-score
            # them exactly as the uninterrupted run did.
            for name, model in models.items():
                val_table.update(name, self._score_validation(model))
            val_table.drain_guard_flags()
        return models

    def _run(self, num_iterations, initial_model, locked_coordinates, checkpoint_fn,
             checkpointer, resume_state, max_quarantined, config_key) -> DescentResult:
        from photon_tpu_torch.fault.preemption import (
            PreemptedError,
            consume_preempt_injection,
            preemption_reason,
            preemption_requested,
        )
        from photon_tpu_torch.fault.watchdog import heartbeat

        locked = set(locked_coordinates)
        unknown = locked - set(self.coordinates)
        if unknown:
            raise KeyError(f"locked coordinates not in update sequence: {sorted(unknown)}")
        if locked and initial_model is None:
            raise ValueError("locked coordinates require an initial model")
        for name in locked:
            if name not in initial_model.coordinates:
                raise KeyError(f"locked coordinate {name!r} missing from initial model")
        telemetry = self.telemetry
        fp = self._fingerprint(config_key, locked=locked,
                               warm_start=initial_model is not None)
        models: Dict[str, object] = {}
        with telemetry.span("descent.residuals.init", mode=STREAM_RESIDUAL_MODE,
                            spilled=self.spill is not None):
            if self.spill is not None:
                residuals = SpilledResidualTable(
                    self.training_data.offset, names=list(self.coordinates),
                    plan=self.plan, store=self.spill.store, cache=self.spill.cache,
                    telemetry=telemetry)
                if resume_state is None:
                    # A fresh fit must not read a previous run's tiles as its
                    # zero state.
                    residuals.reset_store()
            else:
                residuals = TiledResidualTable(self.training_data.offset,
                                               names=list(self.coordinates),
                                               plan=self.plan, telemetry=telemetry)
        val_table = None
        if self.validation_data is not None and self.evaluators is not None:
            val_table = TiledValidationTable(self.validation_data.offset,
                                             names=list(self.coordinates),
                                             plan=self._val_plan(), telemetry=telemetry)
        best_model: Optional[GameModel] = None
        best_metrics: Dict[str, float] = {}
        best_iteration = -1
        history: list = []
        start_iteration = resume_cursor = quarantined_total = 0

        if resume_state is not None:
            require_fingerprint(resume_state, fp, "this streamed descent")
            with telemetry.span("descent.resume", iteration=resume_state.iteration):
                models = self._resume(resume_state, residuals, val_table)
                if resume_state.best_models:
                    best_model = GameModel(dict(resume_state.best_models), self.task_type)
                best_metrics = dict(resume_state.best_metrics)
                best_iteration = resume_state.best_iteration
                history = list(resume_state.history)
                quarantined_total = resume_state.quarantined
                start_iteration = resume_state.iteration + 1
                resume_cursor = int((resume_state.stream or {}).get("cursor", 0))
            telemetry.counter("descent.resumes").inc()
            self.logger.info("resumed streamed descent at iteration %d coordinate "
                             "cursor %d", start_iteration, resume_cursor)
        elif initial_model is not None:
            for name, coord_model in initial_model.coordinates.items():
                if name not in self.coordinates:
                    continue
                models[name] = coord_model
                residuals.update(name, self.coordinates[name].score_stream(coord_model))
                if val_table is not None:
                    val_table.update(name, self._score_validation(coord_model))
            from photon_tpu_torch.game.coordinate import prefetch_warm_joins

            prefetch_warm_joins(self.coordinates, initial_model, telemetry)

        # A rejected seed row belongs to the initial model: the coordinate
        # cold-starts instead.
        seed_rejected = set(residuals.poll_quarantined())
        if val_table is not None:
            seed_rejected |= set(val_table.poll_quarantined())
        bad_locked = sorted(seed_rejected & locked)
        if bad_locked:
            raise ValueError(
                f"locked coordinate(s) {bad_locked} produced non-finite scores from "
                "the initial model; a locked coordinate cannot be quarantined")
        for name in sorted(seed_rejected):
            telemetry.counter("descent.quarantined", coordinate=name, stage="seed").inc()
            quarantined_total += 1
            models.pop(name, None)
            self.logger.info("coordinate %s: non-finite scores from the initial "
                             "model quarantined (cold start instead)", name)

        def check_budget():
            if max_quarantined is not None and quarantined_total > max_quarantined:
                raise QuarantineBudgetError(
                    f"{quarantined_total} quarantined solves/score rows exceed "
                    f"--max-quarantined {max_quarantined}")

        check_budget()
        if start_iteration >= num_iterations:
            last = GameModel(dict(models), self.task_type)
            return DescentResult(best_model=best_model if best_model is not None else last,
                                 last_model=last, best_metrics=best_metrics,
                                 history=history)

        def preempt_exit(where: str):
            telemetry.counter("descent.preempted").inc()
            if checkpointer is not None:
                with telemetry.span("descent.checkpoint.drain"):
                    checkpointer.drain()
                hint = "resume with --resume auto"
            else:
                hint = ("no checkpointer configured — a restart begins from "
                        "scratch (set --checkpoint-dir)")
            raise PreemptedError(f"preempted ({preemption_reason()}) {where}; {hint}")

        def save(state: DescentState, **where) -> None:
            # The write-back first: the checkpoint's digests must describe
            # tiles a resume can read.
            writeback(where.get("iteration"))
            with telemetry.span("descent.checkpoint.save", **where):
                checkpointer.save(state)

        def writeback(iteration) -> None:
            if isinstance(residuals, SpilledResidualTable):
                with telemetry.span("tiles.writeback_flush", iteration=iteration):
                    residuals.flush()

        def record(name: str, info) -> None:
            nonlocal quarantined_total
            rec = _coordinate_record(info)
            q = int(rec.get("quarantined", 0))
            if q:
                telemetry.counter("descent.quarantined", coordinate=name,
                                  stage="solve").inc(q)
                quarantined_total += q
            solver[name] = rec
            self.logger.info("iter %d coordinate %s: %s", it, name, rec)

        order = list(self.coordinates)
        game_model = GameModel(dict(models), self.task_type)
        for it in range(start_iteration, num_iterations):
            fault_point("descent:kill", iteration=it)
            consume_preempt_injection(it)
            if preemption_requested():
                preempt_exit(f"before iteration {it}")
            heartbeat("descent.iteration")
            t_iter = time.perf_counter()
            solver: Dict[str, dict] = {}
            deferred: Dict[str, DeferredSolveStats] = {}
            trained = 0
            updates0 = residuals.updates
            skip = resume_cursor if it == start_iteration else 0
            with telemetry.span("descent.iteration", iteration=it,
                                mode=STREAM_RESIDUAL_MODE) as iter_span:
                for pos, name in enumerate(order):
                    if name in locked or pos < skip:
                        continue
                    coord = self.coordinates[name]
                    # Mid-epoch kill and preemption points: the chunk-cursor
                    # checkpoint below makes a coordinate boundary a restart
                    # line.
                    fault_point("descent:kill", iteration=it, coordinate=name)
                    if preemption_requested():
                        preempt_exit(f"mid-epoch before coordinate {name!r} of "
                                     f"iteration {it}")
                    prev = models.get(name)
                    model, info = coord.train(_TiledOffsets(residuals, name),
                                              initial_model=prev)
                    models[name] = model
                    residuals.update(name, coord.score_stream(model))
                    rejected = set(residuals.poll_quarantined())
                    if val_table is not None and name not in rejected:
                        val_table.update(name, self._score_validation(model))
                        rejected |= set(val_table.poll_quarantined())
                    if name in rejected:
                        # A non-finite score row: roll the model back to the
                        # previous iterate (drop it on a cold start) and
                        # re-sync both tables, at once (a host check).
                        telemetry.counter("descent.quarantined", coordinate=name,
                                          stage="score_row").inc()
                        quarantined_total += 1
                        if prev is not None:
                            models[name] = prev
                            residuals.update(name, coord.score_stream(prev))
                            if val_table is not None:
                                val_table.update(name, self._score_validation(prev))
                        else:
                            models.pop(name, None)
                            residuals.update(name, np.zeros(self.plan.n, np.float32))
                            if val_table is not None:
                                val_table.update(name, np.zeros(val_table.n, np.float32))
                        residuals.drain_guard_flags()
                        if val_table is not None:
                            val_table.drain_guard_flags()
                        self.logger.info("iter %d coordinate %s: non-finite scores "
                                         "quarantined (previous iterate kept)", it, name)
                    trained += 1
                    if isinstance(info, DeferredSolveStats) and checkpointer is None:
                        deferred[name] = info
                    else:
                        # A checkpointed run resolves the statistics now (one
                        # [6] read): the mid-epoch snapshot below must carry
                        # this coordinate's solve quarantines.
                        record(name, info)
                    telemetry.counter("descent.coordinate_updates", coordinate=name).inc()
                    check_budget()
                    if checkpointer is not None:
                        state = self._snapshot(it - 1, pos + 1, num_iterations, models,
                                               best_model, best_metrics, best_iteration,
                                               history, residuals, quarantined_total, fp)
                        save(state, iteration=it, cursor=pos + 1)
                if deferred:
                    # host-sync: the iteration's one read of the deferred
                    # solve statistics.
                    host = torch.cat([ds.device.long() for ds in deferred.values()]).tolist()
                    telemetry.counter("descent.host_syncs", kind="stats").inc()
                    for i, (name, ds) in enumerate(deferred.items()):
                        ds.resolve(host[6 * i: 6 * i + 6])
                        record(name, ds)
                check_budget()
                game_model = GameModel(dict(models), self.task_type)
                if checkpoint_fn is not None:
                    with telemetry.span("descent.checkpoint", iteration=it):
                        checkpoint_fn(it, game_model)
                metrics: Dict[str, float] = {}
                with telemetry.span("descent.validate", iteration=it):
                    if val_table is not None:
                        telemetry.counter("validation.score_reuse").inc(
                            (len(self.coordinates) - trained)
                            * self.validation_data.num_examples)
                        metrics = self._evaluate(val_table)
                if metrics:
                    self.logger.info("iter %d validation %s", it, metrics)
                    iter_span.set_attribute("metrics", metrics)
                    for key, value in metrics.items():
                        telemetry.gauge("descent.validation_metric", metric=key).set(value)
            # The sweep's write-back: every tile its updates dirtied, once.
            writeback(it)
            telemetry.counter("descent.iterations").inc()
            # The chunk-budget residency gauge: the streamer's measured
            # in-flight peak is the device footprint of the streamed data.
            telemetry.gauge("residuals.device_bytes").set(self.streamer.peak_in_flight_bytes)
            history.append({
                "iteration": it, "metrics": metrics,
                "coordinates": {name: str(rec) for name, rec in solver.items()},
                "solver": solver,
                "residual_updates": residuals.updates - updates0,
                "seconds": time.perf_counter() - t_iter,
                "host_syncs": {"stats": int(bool(deferred)),
                               "validation": int(val_table is not None)},
            })
            if not metrics:
                best_model, best_metrics, best_iteration = game_model, metrics, it
            else:
                primary = self.evaluators.primary
                if best_model is None or primary.better_than(
                        metrics[primary.name], best_metrics[primary.name]):
                    best_model, best_metrics, best_iteration = game_model, metrics, it
            if checkpointer is not None:
                state = self._snapshot(it, 0, num_iterations, models, best_model,
                                       best_metrics, best_iteration, history, residuals,
                                       quarantined_total, fp)
                save(state, iteration=it)
        assert best_model is not None
        return DescentResult(best_model=best_model, last_model=game_model,
                             best_metrics=best_metrics, history=history)
