"""GAME coordinates: the fixed-effect and random-effect training units.

Counterpart of the single-device resident part of
``photon_tpu/game/coordinate.py``.  A coordinate owns one slice of the
model, trains it against the other coordinates' scores (its offsets) and
scores data with it:

- :class:`FixedEffectCoordinate` — one GLM fit over the whole training
  batch (``GlmOptimizationProblem``: L-BFGS or TRON through the route
  ``ops/sparse_grad_select`` picks, K1 on ``fused``, K2 on ``pallas``).
- :class:`RandomEffectCoordinate` — per-entity GLMs, the entities of each
  size bin solved together along the bin's route (``game/batched_solve.py``:
  the batched damped Newton, the matrix-free Newton-CG, or the problem's
  own optimizer batched over lanes), converged lanes frozen; optionally in
  a projected feature space (``game/projection.py``: per-entity index maps
  or one random matrix), lifted back into the global table.
- :class:`FactoredRandomEffectCoordinate` — per-entity coefficients
  ``w_e = L z_e`` in a shared rank-``r`` subspace: lane L-BFGS solves of
  the ``z_e`` alternate with one pooled L-BFGS solve of ``L``.

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

A warm start from a model with another entity vocabulary (one loaded from
disk) joins the two by key on the host, once per keys object
(:func:`_foreign_src_idx`), and may be scheduled while the fixed effect
trains (:func:`prefetch_warm_joins`).

Onboarding (``RandomEffectDeviceData.onboard``) grows a random-effect
layout in place for rows appended between fits: rows of an existing entity
scatter into its bin's row-capacity headroom on the host and the device (no
shape changes), an entity past its headroom migrates to an appended bin at
the next power-of-two capacity, and new entities arrive as appended bins.
The fixed-effect batch is rebuilt at its exact row count.

Not carried: the mesh and row-split placement (they raise, naming
ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import concurrent.futures
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
from photon_tpu_torch.game import lowp
from photon_tpu_torch.game.batched_solve import (
    LaneObjective,
    record_bin_telemetry,
    run_lane_fit,
    run_newton_cg_fit,
    run_newton_fit,
    solver_route,
)
from photon_tpu_torch.game.data import (
    DenseShard,
    EntityBucket,
    GameDataset,
    RandomEffectDataset,
    _gather_shard_rows,
    build_random_effect_dataset,
    entity_index_for,
    keys_match,
    merge_buckets,
    pad_bucket_entities,
)
from photon_tpu_torch.game.projection import (
    IndexMapBucketProjection,
    build_index_map_projection,
    build_random_projection,
)
from photon_tpu_torch.game.model import (
    FixedEffectModel,
    RandomEffectModel,
    shard_feats,
    shard_to_batch,
)
from photon_tpu_torch.models.glm import Coefficients, model_for_task
from photon_tpu_torch.telemetry import NULL_SESSION

Tensor = torch.Tensor


def _accumulate_solve_stats(acc: Tensor, entity_index: Tensor, num_entities: int,
                            converged: Tensor, iterations: Tensor, good: Tensor,
                            cg_iterations: Optional[Tensor] = None) -> Tensor:
    """Fold one bin's solve into the coordinate's ``[6]`` int32 device
    accumulator ``[entities, converged, iterations_max, quarantined,
    cg_iters, cg_entities]``.  Padded entities (``entity_index >=
    num_entities``) count nowhere; a quarantined entity does not count as
    converged.  ``cg_iterations`` (per-entity inner CG steps, the routes
    with an inner CG) sums into ``cg_iters`` and the same bins' entities
    into ``cg_entities``; other routes add 0 to both."""
    real = entity_index < num_entities
    real_i = real.to(torch.int32)
    if cg_iterations is None:
        cg = cg_entities = torch.zeros((), dtype=torch.int32, device=acc.device)
    else:
        cg, cg_entities = (cg_iterations.to(torch.int32) * real_i).sum(), real_i.sum()
    return torch.stack([
        acc[0] + real_i.sum(),
        acc[1] + ((converged & good).to(torch.int32) * real_i).sum(),
        torch.maximum(acc[2], torch.where(real, iterations.to(torch.int32), 0).max()),
        acc[3] + ((~good).to(torch.int32) * real_i).sum(),
        acc[4] + cg,
        acc[5] + cg_entities,
    ]).to(torch.int32)


class DeferredSolveStats:
    """A random-effect ``train``'s convergence statistics as one device
    int32 vector, read by the descent loop with everything else of the
    iteration in one host read (:meth:`resolve` takes the fetched vector).
    ``bins`` holds the per-bin solve records and ``extra`` static entries
    (the factored coordinate's ``latent_iterations``), host values."""

    KEYS = ("entities", "converged", "iterations_max", "quarantined",
            "cg_iters", "cg_entities")

    def __init__(self, device: Tensor, bins: Optional[list] = None,
                 extra: Optional[dict] = None):
        self.device = device
        self.bins = list(bins or [])
        self.extra = dict(extra or {})
        self._resolved: Optional[dict] = None

    def resolve(self, host_vec=None) -> dict:
        if self._resolved is None:
            if host_vec is None:
                host_vec = self.device.tolist()
            stats = {k: int(host_vec[i]) for i, k in enumerate(self.KEYS)}
            stats.update(self.extra)
            self._resolved = stats
        return self._resolved

    def __getitem__(self, key):
        return self.resolve()[key]

    def __str__(self):
        return (str(self.resolve()) if self._resolved is not None
                else "DeferredSolveStats(pending)")


_JOIN_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _join_pool() -> concurrent.futures.ThreadPoolExecutor:
    """One host thread for the prefetched warm-start key joins."""
    global _JOIN_POOL
    if _JOIN_POOL is None:
        _JOIN_POOL = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="photon-warm-join")
    return _JOIN_POOL


def _cache_join(cache: dict, model_keys, src_idx) -> None:
    if len(cache) >= 8:
        cache.pop(next(iter(cache)))
    cache[id(model_keys)] = (model_keys, src_idx)


def _foreign_src_idx(device_data, model_keys) -> np.ndarray:
    """The cached foreign-vocabulary join: ``src_idx[e]`` is the row of
    ``model_keys`` holding this dataset's entity ``e`` (-1 = absent).  Keyed
    by the keys object's identity on the shared device data (the entry pins
    the keys, so the id cannot be recycled): a sweep that re-passes one
    warm-start model joins once.  An entry may hold the future of a join
    :func:`prefetch_warm_joins` scheduled; the first use resolves it."""
    cache = device_data._warm_join_cache
    hit = cache.get(id(model_keys))
    if hit is not None and hit[0] is model_keys:
        src_idx = hit[1]
        if isinstance(src_idx, concurrent.futures.Future):
            src_idx = src_idx.result()
            cache[id(model_keys)] = (model_keys, src_idx)
        return src_idx
    src_idx = entity_index_for(device_data.dataset.keys, np.asarray(model_keys))
    _cache_join(cache, model_keys, src_idx)
    return src_idx


def prefetch_warm_joins(coordinates, initial_model, telemetry=None) -> int:
    """Schedule the first foreign-vocabulary warm-start key joins on a host
    thread, so they run while the fixed effect trains instead of blocking
    the first random-effect ``train``.  A coordinate whose warm-start model
    carries its own vocabulary needs no join.  Returns the number scheduled
    (``descent.warm_join_prefetch`` counts them)."""
    telemetry = telemetry or NULL_SESSION
    scheduled = 0
    for name, coord in coordinates.items():
        device_data = getattr(coord, "device_data", None)
        dataset = getattr(device_data, "dataset", None)
        model = initial_model.coordinates.get(name)
        if dataset is None or not isinstance(model, RandomEffectModel):
            continue
        if keys_match(model.keys, dataset.keys):
            continue
        hit = device_data._warm_join_cache.get(id(model.keys))
        if hit is not None and hit[0] is model.keys:
            continue  # joined, or scheduled, already
        future = _join_pool().submit(entity_index_for, dataset.keys,
                                     np.asarray(model.keys))
        _cache_join(device_data._warm_join_cache, model.keys, future)
        scheduled += 1
        telemetry.counter("descent.warm_join_prefetch", coordinate=name).inc()
    return scheduled


def _align_foreign_table(coord, initial_model) -> np.ndarray:
    """The key-aligned host ``[E + 1, dim]`` table of a foreign warm-start
    model (unseen entities zero; the last row is the dummy slot of padded
    entities), its host traffic counted as ``descent.host_transfer_bytes``
    ``path=warm_start``."""
    telemetry = getattr(coord, "telemetry", NULL_SESSION)
    aligned = np.zeros((coord.dataset.num_entities + 1, coord.dim), np.float32)
    src_idx = _foreign_src_idx(coord.device_data, initial_model.keys)
    found = src_idx >= 0
    table = initial_model.table.detach().cpu().numpy()
    telemetry.counter("descent.host_transfer_bytes", direction="d2h",
                      path="warm_start").inc(table.nbytes)
    aligned[:-1][found] = table[src_idx[found]]
    telemetry.counter("descent.host_transfer_bytes", direction="h2d",
                      path="warm_start").inc(aligned.nbytes)
    return aligned


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
        if self.projection == "random" and not self.projected_dim:
            raise ValueError("random projection needs projected_dim")
        if self.row_split and self.projection == "index_map":
            # Each entity's index map comes from its own rows; a row slice
            # per shard would give each shard another projection.
            raise ValueError("row_split does not support index_map projection")
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


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectCoordinateConfig:
    """A latent-factor random effect: per-entity coefficients in a shared
    ``latent_dim``-rank subspace, ``w_e = L z_e`` with ``L [d, r]`` learned
    on the pooled data and ``z_e`` per entity; ``latent_iterations``
    alternations of the ``z`` solves and the ``L`` solve."""

    kind = "factored_random"

    shard_name: str
    entity_column: str
    latent_dim: int = 4
    problem: ProblemConfig = ProblemConfig()
    latent_iterations: int = 2
    active_row_cap: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.latent_dim < 1:
            raise ValueError("latent_dim must be >= 1")
        if self.latent_iterations < 2:
            # One alternation would fit z against the random L and never
            # solve L.
            raise ValueError("latent_iterations must be >= 2 (z,L,...,z)")
        if self.problem.variance_computation != "none":
            raise ValueError(
                "variance computation is not supported for factored random "
                "effects (z-space variances do not transport to w = L z)"
            )
        if self.problem.regularization.l1_weight > 0 or (
                self.problem.optimizer.lower() not in ("lbfgs", "l-bfgs")):
            raise ValueError(
                "factored random effects support lbfgs with none/l2 "
                "regularization only (the pooled projection solve is a "
                "smooth L-BFGS problem)"
            )

    @property
    def data_key(self):
        # The device data of the unprojected random coordinate: the latent
        # projection is learned, so the bins hold raw features.
        return self.as_random_config().data_key

    def as_random_config(self) -> RandomEffectCoordinateConfig:
        return RandomEffectCoordinateConfig(
            shard_name=self.shard_name, entity_column=self.entity_column,
            problem=self.problem, active_row_cap=self.active_row_cap,
            seed=self.seed,
        )


CoordinateConfig = Union[FixedEffectCoordinateConfig, RandomEffectCoordinateConfig,
                         FactoredRandomEffectCoordinateConfig]


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
        if self.train_rows is not None:
            if self._train_rows_dev is None:
                self._train_rows_dev = torch.as_tensor(self.train_rows,
                                                       device=self.device)
            offsets = offsets.index_select(0, self._train_rows_dev)
        return offsets


class RandomEffectDeviceData:
    """The entities of one random-effect data configuration, grouped into
    size bins (``batched_solve.bin_layout``) and uploaded once: per bin the
    ``[E, R, ...]`` features (projected when the configuration asks for a
    projection), labels, weights and entity indices.  Padded entities (none
    on one device, where ``pad_bucket_entities`` adds nothing) would carry
    ``entity_index == num_entities``, the coefficient table's dummy slot."""

    def __init__(self, data: GameDataset, config: RandomEffectCoordinateConfig,
                 device=None):
        self.device = resolve_device(device)
        self.config = config
        self.dataset: RandomEffectDataset = build_random_effect_dataset(
            data, entity_column=config.entity_column, shard_name=config.shard_name,
            active_row_cap=config.active_row_cap, seed=config.seed,
        )
        self.dim = self.dataset.dim
        # One global random matrix, the reference's numpy draw.
        self.random_matrix = None
        if config.projection == "random":
            self.random_matrix = build_random_projection(
                self.dim, config.projected_dim, seed=config.seed)
        self.score_feats: Optional[tuple] = None
        self.score_entity_idx: Optional[Tensor] = None
        # Foreign warm-start joins: keys-object identity -> src_idx.
        self._warm_join_cache: dict = {}
        self.buckets: list = []
        self.device_buckets: list = []
        self.bin_stats: list = []
        # Per-entity placement (bin, slot, used rows) for onboarding, built
        # lazily and dropped whenever the layout changes.
        self._locator = None
        self._append_bins(self.dataset.buckets)

    def _append_bins(self, raw_buckets) -> None:
        """Bin ``raw_buckets`` (host buckets over this dataset's entity
        indices), upload them and append them to the layout: the shared
        path of ``__init__`` and :meth:`onboard`."""
        from photon_tpu_torch.game.batched_solve import bin_layout

        for group in bin_layout(raw_buckets):
            merged = merge_buckets([raw_buckets[i] for i in group])
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
        proj = None
        if self.config.projection == "index_map":
            proj = build_index_map_projection(bucket)
        elif self.config.projection == "random":
            proj = self.random_matrix
        features = bucket.features if proj is None else proj.project(bucket.features)
        feats, dense = shard_feats(features, dev)
        if not dense:  # int64 once here: every lane evaluation gathers by them
            feats = (feats[0].long(), feats[1])
        solve_dim = self.dim if proj is None else proj.projected_dim
        return {
            "feats": feats, "dense": dense,
            "label": torch.as_tensor(bucket.label, device=dev),
            "weight": torch.as_tensor(bucket.row_weight, device=dev),
            "entity_index": torch.as_tensor(bucket.entity_index, device=dev).long(),
            "proj": proj,
            "solve_dim": solve_dim,
            "w0": torch.zeros(bucket.num_entities, solve_dim, dtype=torch.float32,
                              device=dev),
        }

    def projection_buffers(self, i: int) -> tuple:
        """Bin ``i``'s projection on the device, uploaded on first use:
        ``(ids [E, p] int64, mask [E, p])`` of an index map, or ``(R [d, p],
        1 / diag(R^T R) [p])`` of the random matrix."""
        dev = self.device_buckets[i]
        if "proj_buffers" not in dev:
            proj = dev["proj"]
            if isinstance(proj, IndexMapBucketProjection):
                ids, mask = proj.scatter_args()
                dev["proj_buffers"] = (
                    torch.as_tensor(ids, device=self.device).long(),
                    torch.as_tensor(mask, device=self.device))
            else:
                col_norms = (proj.matrix ** 2).sum(axis=0)
                dev["proj_buffers"] = (
                    torch.as_tensor(proj.matrix, device=self.device),
                    torch.as_tensor((1.0 / np.maximum(col_norms, 1e-12)).astype(np.float32),
                                    device=self.device))
        return dev["proj_buffers"]

    def restrict_device(self, i: int, table: Tensor) -> Tensor:
        """Bin ``i``'s warm start in its solve space, on the device: the
        local coefficients of the globally gathered ``[E_b, dim]`` rows (an
        index map's active columns, or the random matrix's column-normalized
        least-squares pullback, ``RandomProjectionMatrix.restrict_table``)."""
        if self.device_buckets[i]["proj"] is None:
            return table
        a, b = self.projection_buffers(i)
        if isinstance(self.device_buckets[i]["proj"], IndexMapBucketProjection):
            return torch.gather(table, 1, a) * b
        return (table @ a) * b

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

    # -- onboarding ----------------------------------------------------------
    def check_onboard(self, data: GameDataset, absent_tail=None) -> None:
        """Validate :meth:`onboard`'s preconditions without changing
        anything, so a caller growing several layouts can reject a batch
        before any is grown."""
        old = self.dataset
        n_old = len(old.entity_idx_per_row)
        if data.num_examples < n_old:
            raise ValueError(
                f"onboard() needs the GROWN dataset: got {data.num_examples} "
                f"rows, the layout was built from {n_old}")
        if self.config.entity_column not in data.id_columns:
            raise KeyError(
                f"grown dataset lacks id column {self.config.entity_column!r}")
        shard = data.shard(self.config.shard_name)
        if shard.dim != self.dim:
            raise ValueError(
                f"appended shard {self.config.shard_name!r} has dim "
                f"{shard.dim}; the layout was built at dim {self.dim}")
        if self.buckets:
            built_dense = isinstance(self.buckets[0].features, DenseShard)
            if isinstance(shard, DenseShard) != built_dense:
                raise ValueError(
                    f"grown shard {self.config.shard_name!r} is "
                    f"{'dense' if not built_dense else 'sparse'} but the "
                    f"layout was built {'dense' if built_dense else 'sparse'}; "
                    "coerce the appended rows to the layout's storage (the "
                    "online merge does) or rebuild")
        n_tail = data.num_examples - n_old
        if absent_tail is not None and len(absent_tail) != n_tail:
            raise ValueError(
                f"absent_tail mask covers {len(absent_tail)} rows, the "
                f"appended tail has {n_tail}")

    def _entity_locator(self):
        """``[bin_of, slot_of, used]`` per entity of the current layout:
        the bin holding it, its slot there and its live (weight > 0) rows."""
        if self._locator is None:
            n_entities = self.dataset.num_entities
            bin_of = np.full(n_entities, -1, np.int32)
            slot_of = np.zeros(n_entities, np.int32)
            used = np.zeros(n_entities, np.int32)
            for i, bucket in enumerate(self.buckets):
                idx = bucket.entity_index
                live = idx < n_entities  # skip padded and migrated-away slots
                if not live.any():
                    continue
                slots = np.nonzero(live)[0].astype(np.int32)
                bin_of[idx[live]] = i
                slot_of[idx[live]] = slots
                used[idx[live]] = (bucket.row_weight[slots] > 0).sum(axis=1)
            self._locator = [bin_of, slot_of, used]
        return self._locator

    def _plan_append_buckets(self, data, entities, rows_by_entity, corrections):
        """Host buckets for appended entities (new or migrating):
        ``entities`` in the merged vocabulary, ``rows_by_entity[i]`` their
        kept row ids, ``corrections[i]`` the active-cap weight correction.
        Capacities are the next power of two past each row count."""
        from photon_tpu_torch.game.model import pow2_at_least

        if not entities:
            return []
        shard = data.shard(self.config.shard_name)
        counts = np.array([len(r) for r in rows_by_entity], np.int64)
        caps = np.array([pow2_at_least(int(c)) for c in counts], np.int64)
        buckets = []
        for capacity in np.unique(caps):
            members = np.nonzero(caps == capacity)[0]
            n_e = len(members)
            row_index = np.zeros((n_e, capacity), np.int64)
            mask = np.zeros((n_e, capacity), np.float32)
            corr = np.ones(n_e, np.float32)
            for k, m in enumerate(members):
                rr = rows_by_entity[m]
                row_index[k, : len(rr)] = rr
                mask[k, : len(rr)] = 1.0
                corr[k] = corrections[m]
            buckets.append(EntityBucket(
                row_capacity=int(capacity),
                entity_index=np.array([entities[m] for m in members], np.int32),
                row_index=row_index,
                row_weight=(data.weight[row_index] * mask
                            * corr[:, None]).astype(np.float32),
                label=(data.label[row_index] * mask).astype(np.float32),
                features=_gather_shard_rows(shard, row_index),
            ))
        return buckets

    def _grow_bin_in_place(self, i: int, slots, pos, rows, data) -> None:
        """Write appended rows into bin ``i``'s row-capacity headroom, on
        the host and on the device: no shape changes."""
        bucket = self.buckets[i]
        shard = data.shard(self.config.shard_name)
        w = data.weight[rows].astype(np.float32)
        lab = data.label[rows].astype(np.float32)
        bucket.row_index[slots, pos] = rows
        bucket.row_weight[slots, pos] = w
        bucket.label[slots, pos] = lab
        feats = bucket.features
        if isinstance(feats, DenseShard):
            new_x = shard.x[rows]
            feats.x[slots, pos] = new_x
        else:
            # Wider rows were routed to migration; narrower rows pad up
            # (zero ids and values are inert).
            k_block, k_shard = feats.ids.shape[-1], shard.ids.shape[1]
            new_ids, new_vals = shard.ids[rows], shard.vals[rows]
            if k_shard < k_block:
                widths = [(0, 0), (0, k_block - k_shard)]
                new_ids, new_vals = np.pad(new_ids, widths), np.pad(new_vals, widths)
            feats.ids[slots, pos] = new_ids
            feats.vals[slots, pos] = new_vals
        dev = self.device_buckets[i]
        put = lambda a: torch.as_tensor(np.asarray(a), device=self.device)  # noqa: E731
        sl, po = put(slots.astype(np.int64)), put(pos.astype(np.int64))
        dev["label"][sl, po] = put(lab)
        dev["weight"][sl, po] = put(w)
        if dev["dense"]:
            dev["feats"][0][sl, po] = lowp.feature_tensor(new_x, self.device)
        else:
            dev["feats"][0][sl, po] = put(new_ids.astype(np.int64))
            dev["feats"][1][sl, po] = lowp.feature_tensor(new_vals, self.device)
        if "row_index" in dev:
            dev["row_index"][sl, po] = put(rows.astype(np.int64))
            dev["row_mask"][sl, po] = 1.0
        self.bin_stats[i]["live_rows"] += int(len(rows))

    def _neutralize_slot(self, i: int, slot: int, dummy: int, used: int) -> None:
        """Retire a migrated entity's old slot: the dummy entity index (its
        scatter lands on the table's absorbing row) and zero row weights."""
        bucket = self.buckets[i]
        bucket.entity_index[slot] = dummy
        bucket.row_weight[slot, :] = 0.0
        dev = self.device_buckets[i]
        dev["entity_index"][slot] = dummy
        dev["weight"][slot] = 0.0
        if "row_mask" in dev:
            dev["row_mask"][slot] = 0.0
        self.bin_stats[i]["live_rows"] -= int(used)
        self.bin_stats[i]["live_entities"] -= 1

    def _record_headroom(self, telemetry) -> None:
        """Per bin: padded row cells, live rows and the headroom between."""
        col = self.config.entity_column
        for i, st in enumerate(self.bin_stats):
            cells = st["capacity"] * st["total_entities"]
            telemetry.gauge("onboard.bin_row_capacity", column=col, bin=i).set(cells)
            telemetry.gauge("onboard.bin_rows_live", column=col, bin=i).set(
                st["live_rows"])
            telemetry.gauge("onboard.bin_row_headroom", column=col, bin=i).set(
                cells - st["live_rows"])

    def onboard(self, data: GameDataset, telemetry=None, absent_tail=None) -> None:
        """Extend the layout with rows appended to the training data, for
        new and existing entities, without a full rebuild (the reference's
        ``coordinate.py:1043-1374``).  ``data``'s first rows are the rows
        the layout was built from.  Existing entities' rows land in their
        bin's headroom in place; an entity past its headroom or the active
        row cap, or under a projection, migrates (its old slot neutralized,
        its rows re-bucketed at the next power of two); new entities arrive
        as appended bins.  ``absent_tail`` marks appended rows that carry
        no id for this column.  A batch that fails validation changes
        nothing: every rejection comes before the first write."""
        telemetry = telemetry or NULL_SESSION
        self.check_onboard(data, absent_tail=absent_tail)
        old = self.dataset
        n_old = len(old.entity_idx_per_row)
        n_tail = data.num_examples - n_old
        if n_tail == 0:
            return
        col = self.config.entity_column
        raw_tail = data.id_columns[col][n_old:]
        present = np.ones(n_tail, bool)
        if absent_tail is not None:
            present &= ~np.asarray(absent_tail).astype(bool)
        sel = np.nonzero(present)[0]
        raw_present = raw_tail[sel]

        # ---- plan: nothing changes until every input is validated ----
        old_idx = (entity_index_for(raw_present, old.keys)
                   if len(raw_present) else np.zeros(0, np.int32))
        new_mask = old_idx < 0
        new_raw = raw_present[new_mask]
        merged_keys = (np.unique(np.concatenate([old.keys, np.unique(new_raw)]))
                       if len(new_raw) else old.keys)
        grew = len(merged_keys) != len(old.keys)
        dummy = len(merged_keys)
        remap_full = None
        if grew:
            # Old index -> merged index; the old dummy slot -> the new one.
            remap_full = np.concatenate(
                [entity_index_for(old.keys, merged_keys), [dummy]]).astype(np.int32)
        tail_idx = np.full(n_tail, -1, np.int32)
        if len(raw_present):
            tail_idx[sel] = entity_index_for(raw_present, merged_keys)
        tail_global = n_old + sel

        bin_of, slot_of, used_of = self._entity_locator()
        cap = self.config.active_row_cap
        shard = data.shard(self.config.shard_name)
        shard_k = None if isinstance(shard, DenseShard) else shard.ids.shape[1]

        def width_fits(i: int) -> bool:
            return shard_k is None or shard_k <= self.buckets[i].features.ids.shape[-1]

        append_entities: list = []
        append_rows: list = []
        append_corr: list = []
        in_place: dict = {}  # bin -> [(slot, used, rows)]
        neutralize: list = []  # (bin, slot, used)
        in_place_rows = migrated_rows = n_migrated = 0
        exist_pos = np.nonzero(~new_mask)[0]
        if len(exist_pos):
            ents_old = old_idx[exist_pos]
            order = np.argsort(ents_old, kind="stable")
            ents_sorted = ents_old[order]
            rows_sorted = tail_global[exist_pos[order]]
            uniq, starts = np.unique(ents_sorted, return_index=True)
            bounds = np.append(starts, len(ents_sorted))
            # True base row counts (a bin may hold a subsample of them).
            full_counts = np.bincount(
                old.entity_idx_per_row[old.entity_idx_per_row >= 0],
                minlength=len(old.keys))
            migrating: list = []
            for j, e_old in enumerate(uniq):
                rr = rows_sorted[bounds[j]: bounds[j + 1]]
                i = int(bin_of[e_old])
                u = int(used_of[e_old])
                total = int(full_counts[e_old]) + len(rr)
                fits = (i >= 0 and int(full_counts[e_old]) <= u
                        and (cap is None or total <= cap)
                        and u + len(rr) <= self.buckets[i].row_capacity
                        and self.config.projection == "none"
                        and width_fits(i))
                if fits:
                    in_place.setdefault(i, []).append((int(slot_of[e_old]), u, rr))
                    in_place_rows += len(rr)
                else:
                    migrating.append((int(e_old), rr, i, int(slot_of[e_old]), u))
            n_migrated = len(migrating)
            for e_old, rr, i, slot, u in migrating:
                all_rows = np.concatenate(
                    [np.nonzero(old.entity_idx_per_row == e_old)[0], rr])
                corr = 1.0
                if cap is not None and len(all_rows) > cap:
                    rng = np.random.default_rng((self.config.seed, 0x6F6E6C, e_old))
                    keep = np.sort(rng.choice(len(all_rows), size=cap, replace=False))
                    corr = len(all_rows) / cap
                    all_rows = all_rows[keep]
                append_entities.append(int(remap_full[e_old]) if grew else e_old)
                append_rows.append(all_rows)
                append_corr.append(corr)
                migrated_rows += len(rr)
                if i >= 0:
                    neutralize.append((i, slot, u))
        n_new_entities = 0
        if new_mask.any():
            ents_new = tail_idx[sel[new_mask]]
            rows_new = tail_global[new_mask]
            order = np.argsort(ents_new, kind="stable")
            es, rs = ents_new[order], rows_new[order]
            uniq, starts = np.unique(es, return_index=True)
            bounds = np.append(starts, len(es))
            n_new_entities = len(uniq)
            for j, e in enumerate(uniq):
                rr = rs[bounds[j]: bounds[j + 1]]
                corr = 1.0
                if cap is not None and len(rr) > cap:
                    rng = np.random.default_rng((self.config.seed, 0x6F6E6C, int(e)))
                    keep = np.sort(rng.choice(len(rr), size=cap, replace=False))
                    corr = len(rr) / cap
                    rr = rr[keep]
                append_entities.append(int(e))
                append_rows.append(rr)
                append_corr.append(corr)
        append_buckets = self._plan_append_buckets(
            data, append_entities, append_rows, append_corr)

        # ---- apply: writes only, nothing below rejects input ----
        if grew:
            remap_dev = torch.as_tensor(remap_full, device=self.device).long()
            for i, bucket in enumerate(self.buckets):
                self.buckets[i] = dataclasses.replace(
                    bucket, entity_index=remap_full[bucket.entity_index])
                dev = self.device_buckets[i]
                dev["entity_index"] = remap_dev[dev["entity_index"]]
            old_per_row = np.where(
                old.entity_idx_per_row >= 0,
                remap_full[np.maximum(old.entity_idx_per_row, 0)], -1,
            ).astype(np.int32)
        else:
            old_per_row = old.entity_idx_per_row
        for i, writes in sorted(in_place.items()):
            slots = np.concatenate([np.full(len(rr), s, np.int32) for s, _, rr in writes])
            pos = np.concatenate([u + np.arange(len(rr), dtype=np.int32)
                                  for _, u, rr in writes])
            rows = np.concatenate([rr for _, _, rr in writes])
            self._grow_bin_in_place(i, slots, pos, rows, data)
        for i, slot, u in neutralize:
            self._neutralize_slot(i, slot, dummy, u)
        self.dataset = dataclasses.replace(
            old, keys=merged_keys, buckets=tuple(self.buckets),
            entity_idx_per_row=np.concatenate([old_per_row, tail_idx]),
        )
        if append_buckets:
            self._append_bins(append_buckets)
            self.dataset = dataclasses.replace(self.dataset, buckets=tuple(self.buckets))
        # The row count and vocabulary changed: drop the scoring caches, the
        # warm-start joins and the placement index (rebuilt lazily).
        self.score_feats = None
        self.score_entity_idx = None
        self._warm_join_cache.clear()
        self._locator = None
        for name, value in (("onboard.rows_in_place", in_place_rows),
                            ("onboard.rows_migrated", migrated_rows),
                            ("onboard.entities_migrated", n_migrated),
                            ("onboard.entities_new", n_new_entities),
                            ("onboard.rows_absent", n_tail - len(sel))):
            if value:
                telemetry.counter(name, column=col).inc(value)
        self._record_headroom(telemetry)


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
    """Per-entity GLM fits, each size bin's entities solved together along
    the bin's route; early-converging entities freeze while the others
    iterate."""

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
        # The estimator names the coordinate and hands it the run's session.
        self.name = config.shard_name
        self.telemetry = NULL_SESSION
        self._bins_recorded = None

    @property
    def routes(self) -> list:
        """Each bin's route (``batched_solve.solver_route``)."""
        return [solver_route(self.config.problem, dev["solve_dim"])
                for dev in self.device_data.device_buckets]

    def _solve_bin(self, route: str, batch, w0: Tensor):
        """One bin's batched solve along its route: the batched Newton
        (small smooth bins), the matrix-free Newton-CG, or the problem's own
        optimizer batched over lanes (``vmapped``).  Row-split placement
        (item 10) raises where its configuration is made."""
        cfg = self.config.problem
        if route == "newton":
            return run_newton_fit(self.objective, batch, w0, cfg=cfg.optimizer_config,
                                  variance=cfg.variance_computation)
        if route == "newton_cg":
            return run_newton_cg_fit(self.objective, batch, w0,
                                     cfg=cfg.optimizer_config,
                                     variance=cfg.variance_computation)
        return run_lane_fit(self.objective, batch, w0, optimizer=cfg.optimizer,
                            cfg=cfg.optimizer_config,
                            variance=cfg.variance_computation)

    def _initial_table(self, initial_model: RandomEffectModel) -> Tensor:
        """The warm-start table aligned onto this dataset's vocabulary, with
        the dummy row appended; entities the model lacks start at zero.
        Descent re-passes the model this coordinate trained, whose keys are
        the dataset's own: that stays on the device.  A foreign vocabulary
        (a model from disk) joins by key on the host, cached per keys
        object (:func:`_align_foreign_table`)."""
        if initial_model.dim != self.dim:
            raise ValueError(
                f"warm-start model dim {initial_model.dim} != coordinate dim {self.dim}"
            )
        if keys_match(initial_model.keys, self.dataset.keys):
            table = initial_model.table.to(self.device, torch.float32)
            return torch.cat([table, torch.zeros(1, self.dim, dtype=table.dtype,
                                                 device=self.device)])
        return torch.as_tensor(_align_foreign_table(self, initial_model),
                               device=self.device)

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
        routes = self.routes
        if self._bins_recorded != len(routes):
            # The layout is static: its gauges are set once a coordinate.
            record_bin_telemetry(self.telemetry, self.name,
                                 self.device_data.bin_stats, routes)
            self._bins_recorded = len(routes)
        acc = torch.zeros(6, dtype=torch.int32, device=dev)
        bins = []
        for i in range(len(self.device_data.buckets)):
            t0 = time.perf_counter()
            batch = self.device_data.batch_for(
                i, self.device_data.bin_offsets(i, offsets))
            bucket = self.device_data.device_buckets[i]
            entity_idx = bucket["entity_index"]
            proj = bucket["proj"]
            prev_rows = None if init_table is None else init_table[entity_idx]
            w0 = (bucket["w0"] if prev_rows is None
                  else self.device_data.restrict_device(i, prev_rows))
            coefficients, result = self._solve_bin(routes[i], batch, w0)
            means, variances = coefficients.means, coefficients.variances
            # Non-finite guard: entities whose solve diverged keep their
            # previous row (zero on a cold start).  Duplicate indices write
            # only the dummy row, which is dropped.
            good = torch.isfinite(means).all(dim=1)
            if proj is None or not isinstance(proj, IndexMapBucketProjection):
                if proj is not None:  # the random matrix: the exact lift R w
                    matrix, _ = self.device_data.projection_buffers(i)
                    means = means @ matrix.T
                    if variances is not None:
                        variances = variances @ (matrix.T ** 2)
                fallback = torch.zeros_like(means) if prev_rows is None else prev_rows
                table[entity_idx] = torch.where(good[:, None], means, fallback)
                if var_table is not None:
                    # Quarantined entities get zero variance.
                    var_table[entity_idx] = torch.where(
                        good[:, None], variances, torch.zeros_like(variances))
            else:
                # Each local slot adds back onto its global column; slots are
                # unique per entity and masked pad slots add exactly 0.  A
                # quarantined entity adds zeros, then its previous row.
                ids, mask = self.device_data.projection_buffers(i)
                rows = entity_idx[:, None].expand_as(ids)
                safe = torch.where(good[:, None], means, torch.zeros_like(means))
                table.index_put_((rows, ids), safe * mask, accumulate=True)
                if prev_rows is not None:
                    table.index_add_(0, entity_idx, (~good).to(table.dtype)[:, None]
                                     * prev_rows)
                if var_table is not None:
                    var_table.index_put_(
                        (rows, ids), torch.where(good[:, None], variances,
                                                 torch.zeros_like(variances)) * mask,
                        accumulate=True)
            acc = _accumulate_solve_stats(acc, entity_idx, num_entities,
                                          result.converged, result.iterations, good,
                                          result.cg_iterations)
            stats = self.device_data.bin_stats[i]
            # Host clock to the solver's last read: the polish and the table
            # write run on into the next bin's time.
            bins.append({
                "bin": i, "entities": stats["live_entities"],
                "capacity": stats["capacity"], "route": routes[i],
                "solve_dim": bucket["solve_dim"],
                "loop_iterations": result.loop_iterations,
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
        return _random_score_device(self, model)


def _random_score_device(coord, model: RandomEffectModel) -> Tensor:
    """Training-data margins on the device: a gather-join against the
    cached per-row entity index (a model on another shard or column, or
    another vocabulary, scores through its host path)."""
    if (model.shard_name != coord.config.shard_name
            or model.entity_column != coord.config.entity_column
            or not keys_match(model.keys, coord.dataset.keys)):
        return torch.as_tensor(model.score(coord.data), device=coord.device)
    holder = coord.device_data
    if holder.score_feats is None:
        holder.score_feats = shard_feats(
            coord.data.shard(coord.config.shard_name), coord.device)
        holder.score_entity_idx = torch.as_tensor(
            coord.dataset.entity_idx_per_row, device=coord.device)
    feats, dense = holder.score_feats
    return model.margins_device(holder.score_entity_idx, feats, dense)


class FactoredRandomEffectCoordinate:
    """A latent-factor random effect: lane L-BFGS solves of the per-entity
    ``z_e`` (dim ``r``, on the bins' features projected by ``L``: ``x @ L``)
    alternate with one pooled L-BFGS solve of the shared ``L`` (the margin
    ``x_i L z_{e(i)}`` is linear in ``L``).  Exports a plain
    :class:`RandomEffectModel` with ``w_e = L z_e``, so scoring, model I/O
    and warm starts are the unfactored ones."""

    kind = "factored_random"

    def __init__(self, data: GameDataset, config: FactoredRandomEffectCoordinateConfig,
                 task_type: str, device=None,
                 device_data: Optional[RandomEffectDeviceData] = None):
        self.data = data
        self.config = config
        self.task_type = task_type
        self.device_data = device_data or RandomEffectDeviceData(
            data, config.as_random_config(), device)
        self.device = self.device_data.device
        self.dataset = self.device_data.dataset
        self.dim = self.dataset.dim
        self.r = config.latent_dim
        glm = GlmObjective.create(task_type, config.problem.regularization)
        self.objective = LaneObjective.of(glm)
        self.name = config.shard_name
        self.telemetry = NULL_SESSION
        # The pooled solve's rows on the device, uploaded once.
        dev = self.device
        shard = data.shard(config.shard_name)
        self._label = torch.as_tensor(np.asarray(data.label, np.float32), device=dev)
        self._weight = torch.as_tensor(np.asarray(data.weight, np.float32), device=dev)
        self._dense = isinstance(shard, DenseShard)
        if self._dense:
            self._x = lowp.feature_tensor(shard.x, dev)
        else:
            self._ids = torch.as_tensor(shard.ids, device=dev).long()
            self._vals = lowp.feature_tensor(shard.vals, dev)
        self._entity_of_row = torch.as_tensor(self.dataset.entity_idx_per_row,
                                              device=dev).long()

    def _project_bucket(self, dev: dict, latent: Tensor) -> Tensor:
        """A bin's features projected by ``L``: ``[E, R, r]`` (bf16 features
        widen before the product)."""
        if dev["dense"]:
            return torch.einsum("erd,dk->erk", dev["feats"][0].to(latent.dtype), latent)
        ids, vals = dev["feats"]
        return torch.einsum("ernk,ern->erk", latent[ids], vals.to(latent.dtype))

    def _latent_value_and_grad(self, flat: Tensor, z_rows: Tensor,
                               offsets: Tensor) -> tuple[Tensor, Tensor]:
        """The pooled objective over ``vec(L)`` with every ``z`` fixed: its
        value and gradient ``X^T (weight * loss') Z`` (the sparse scatter in
        float64), both from float64 margins, as the ``z`` lanes' are
        (:class:`LaneObjective`)."""
        latent = flat.view(self.dim, self.r)
        loss, l2 = self.objective.loss, self.objective.l2_weight
        if self._dense:
            xl = self._x.to(latent.dtype) @ latent
        else:
            xl = torch.einsum("njk,nj->nk", latent[self._ids], self._vals.to(latent.dtype))
        z = torch.sum(xl.double() * z_rows.double(), dim=-1) + offsets.double()
        value = torch.sum(self._weight.double() * loss.value(z, self._label.double()))
        per_row = self._weight * loss.d1(z, self._label.double()).float()
        if self._dense:
            grad = self._x.to(per_row.dtype).T @ (per_row[:, None] * z_rows)
        else:
            terms = (per_row[:, None] * self._vals)[..., None] * z_rows[:, None, :]
            grad = torch.zeros(self.dim, self.r, dtype=torch.float64, device=flat.device)
            grad.index_add_(0, self._ids.reshape(-1),
                            terms.reshape(-1, self.r).double())
            grad = grad.float()
        grad = grad.reshape(-1)
        if l2 != 0.0:
            value = value + 0.5 * l2 * torch.dot(flat.double(), flat.double())
            grad = grad + l2 * flat
        return value, grad

    def _solve_latent(self, z_rows: Tensor, offsets: Tensor, latent0: Tensor) -> Tensor:
        """``L`` with every entity's ``z`` fixed: one L-BFGS fit over
        ``vec(L)``."""
        from photon_tpu_torch.core.optimizers import lbfgs

        result = lbfgs(lambda w: self._latent_value_and_grad(w, z_rows, offsets),
                       latent0.reshape(-1), self.config.problem.optimizer_config)
        return result.w.view(self.dim, self.r)

    def _warm_start(self, initial_model: RandomEffectModel):
        """``(L, z, previous table)`` from a model's full-dim table by a
        rank-r SVD on the host (the reference's numpy code): the key-aligned
        table is also the quarantine fallback."""
        aligned = _align_foreign_table(self, initial_model)
        u, s, vt = np.linalg.svd(aligned, full_matrices=False)
        r = self.r
        sq = np.sqrt(s[:r])
        latent = (vt[:r].T * sq[None, :]).astype(np.float32)  # [d, r]
        z = (u[:, :r] * sq[None, :]).astype(np.float32)  # [E + 1, r]
        dev = self.device
        return (torch.as_tensor(latent, device=dev), torch.as_tensor(z, device=dev),
                aligned[:-1])

    def train(self, offsets, initial_model: Optional[RandomEffectModel] = None):
        """The alternation; returns ``(model, DeferredSolveStats)`` whose
        counts cover the last ``z`` pass."""
        num_entities = self.dataset.num_entities
        dev = self.device
        cfg = self.config.problem
        rng = np.random.default_rng(self.config.seed)
        latent = torch.as_tensor(
            (rng.standard_normal((self.dim, self.r)) / np.sqrt(self.dim)).astype(np.float32),
            device=dev)
        offsets_all = torch.as_tensor(offsets, dtype=torch.float32, device=dev)
        z_table = torch.zeros(num_entities + 1, self.r, dtype=torch.float32, device=dev)
        prev_table = None
        if initial_model is not None:
            latent, z_table, prev_table = self._warm_start(initial_model)
            # The warm-started L is informed already: refresh it from the new
            # offsets before the first z solve.
            latent = self._solve_latent(z_table[self._entity_of_row], offsets_all, latent)
        acc = torch.zeros(6, dtype=torch.int32, device=dev)
        bins = []
        for it in range(self.config.latent_iterations):
            acc = torch.zeros(6, dtype=torch.int32, device=dev)
            bins = []
            for i in range(len(self.device_data.buckets)):
                t0 = time.perf_counter()
                bucket = self.device_data.device_buckets[i]
                batch = DenseBatch(self._project_bucket(bucket, latent), bucket["label"],
                                   self.device_data.bin_offsets(i, offsets),
                                   bucket["weight"])
                entity_idx = bucket["entity_index"]
                coefficients, result = run_lane_fit(
                    self.objective, batch, z_table[entity_idx], optimizer="lbfgs",
                    cfg=cfg.optimizer_config, variance="none")
                z_table[entity_idx] = coefficients.means
                acc = _accumulate_solve_stats(
                    acc, entity_idx, num_entities, result.converged, result.iterations,
                    torch.ones_like(result.converged))
                stats = self.device_data.bin_stats[i]
                bins.append({
                    "bin": i, "entities": stats["live_entities"],
                    "capacity": stats["capacity"], "route": "vmapped",
                    "solve_dim": self.r, "loop_iterations": result.loop_iterations,
                    "host_reads": result.host_reads,
                    "seconds": time.perf_counter() - t0,
                })
            if it != self.config.latent_iterations - 1:
                latent = self._solve_latent(z_table[self._entity_of_row], offsets_all,
                                            latent)
        # w_e = L z_e (the dummy row drops).  Non-finite rows fall back to
        # the warm-start model's (zero on a cold start) and count as
        # quarantined.
        table = z_table[:num_entities] @ latent.T
        good = torch.isfinite(table).all(dim=1)
        acc = acc.clone()
        acc[3] += (~good).sum().to(torch.int32)
        prev = (torch.zeros_like(table) if prev_table is None
                else torch.as_tensor(prev_table, device=dev))
        table = torch.where(good[:, None], table, prev)
        model = RandomEffectModel(
            table=table, keys=self.dataset.keys,
            entity_column=self.config.entity_column,
            shard_name=self.config.shard_name, task_type=self.task_type,
        )
        return model, DeferredSolveStats(
            acc, bins, extra={"latent_iterations": self.config.latent_iterations})

    def score(self, model: RandomEffectModel) -> np.ndarray:
        return model.score(self.data)

    def score_device(self, model: RandomEffectModel) -> Tensor:
        return _random_score_device(self, model)


def build_coordinate(data: GameDataset, config: CoordinateConfig, task_type: str,
                     device=None, normalization: Optional[NormalizationContext] = None,
                     device_data=None):
    if isinstance(config, FixedEffectCoordinateConfig):
        return FixedEffectCoordinate(data, config, task_type, device, device_data,
                                     normalization)
    if isinstance(config, (RandomEffectCoordinateConfig,
                           FactoredRandomEffectCoordinateConfig)):
        if normalization is not None:
            raise ValueError(
                "normalization is not supported for random-effect coordinates "
                f"(coordinate on shard {config.shard_name!r})"
            )
        if isinstance(config, FactoredRandomEffectCoordinateConfig):
            return FactoredRandomEffectCoordinate(data, config, task_type, device,
                                                  device_data)
        return RandomEffectCoordinate(data, config, task_type, device, device_data)
    raise TypeError(f"unknown coordinate config type {type(config)!r}")

