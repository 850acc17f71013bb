"""GAME data pipeline: feature shards, entity grouping, bucketed datasets.

A copy of ``photon_tpu/game/data.py`` (numpy only; the port imports
nothing of the JAX package).  Host-side and columnar:

- :class:`GameDataset` holds one row per example (the row index is the
  unique sample id), per-coordinate feature shards (dense ``[n, d]`` or
  padded-sparse ``[n, k]``) and raw entity-id columns.
- :class:`RandomEffectDataset` groups rows by entity once and packs the
  entities into power-of-two row-capacity buckets, each a dense
  ``[E, R, ...]`` block whose padded rows carry weight 0.
- ``active_row_cap`` subsamples entities over the cap (seeded, without
  replacement) and scales their weights by ``count / cap``.

Entity order, bucket capacities, the size-bin plan and the cap's draws are
the reference's exactly: the port's tests hold every array to it.  Feature
values are float32, or bf16 after :func:`dataset_astype`, held as their
``uint16`` bit patterns (``game/lowp.py``): every row gather, slice, pad and
merge here moves them unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Union

import numpy as np

Float = np.float32


class DenseShard(NamedTuple):
    """A feature shard stored dense: ``x[i]`` is row i's feature vector."""

    x: np.ndarray  # [n, d] float32, or bf16 bits (uint16)

    @property
    def dim(self) -> int:
        return self.x.shape[1]


class SparseShard(NamedTuple):
    """A feature shard in padded-COO layout (see data.batch.SparseBatch)."""

    ids: np.ndarray  # [n, k] int32
    vals: np.ndarray  # [n, k] float32, or bf16 bits (uint16)
    dim_: int

    @property
    def dim(self) -> int:
        return self.dim_


Shard = Union[DenseShard, SparseShard]


def _gather_shard_rows(shard: Shard, row_index: np.ndarray) -> Shard:
    """Index a shard's per-row arrays with an arbitrary-shape row index."""
    if isinstance(shard, DenseShard):
        return DenseShard(shard.x[row_index])
    return SparseShard(shard.ids[row_index], shard.vals[row_index], shard.dim_)


@dataclasses.dataclass(frozen=True)
class GameDataset:
    """Columnar GAME training/scoring data (host side).

    The row index plays the reference's ``UniqueSampleId`` role: scores,
    offsets, and labels all align on it.
    """

    label: np.ndarray  # [n] float32
    offset: np.ndarray  # [n] float32
    weight: np.ndarray  # [n] float32
    shards: Dict[str, Shard]
    id_columns: Dict[str, np.ndarray]  # raw per-row entity keys

    def __post_init__(self):
        n = self.num_examples
        for name, col in self.id_columns.items():
            if len(col) != n:
                raise ValueError(f"id column {name!r} has {len(col)} rows, want {n}")
        for name, shard in self.shards.items():
            rows = shard.x.shape[0] if isinstance(shard, DenseShard) else shard.ids.shape[0]
            if rows != n:
                raise ValueError(f"feature shard {name!r} has {rows} rows, want {n}")

    @property
    def num_examples(self) -> int:
        return len(self.label)

    def shard(self, name: str) -> Shard:
        if name not in self.shards:
            raise KeyError(
                f"unknown feature shard {name!r}; available: {sorted(self.shards)}"
            )
        return self.shards[name]

    @classmethod
    def create(
        cls,
        label: np.ndarray,
        shards: Dict[str, Shard],
        id_columns: Optional[Dict[str, np.ndarray]] = None,
        offset: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
    ) -> "GameDataset":
        n = len(label)
        return cls(
            label=np.asarray(label, Float),
            offset=np.zeros(n, Float) if offset is None else np.asarray(offset, Float),
            weight=np.ones(n, Float) if weight is None else np.asarray(weight, Float),
            shards=dict(shards),
            id_columns={} if id_columns is None else dict(id_columns),
        )


def dataset_astype(data: GameDataset, dtype) -> GameDataset:
    """Re-store every shard's FEATURE VALUES in ``dtype`` (``"bfloat16"`` or
    ``"float32"``, or the torch dtype).

    The GAME counterpart of ``data/batch.batch_astype`` (the reference's
    ``dataset_astype``): labels, offsets, weights and all arithmetic stay
    float32; only the stored value stream shrinks, so every coordinate's
    blocks and gathers move 2 bytes a value.  bf16 values are held as their
    ``uint16`` bit patterns, rounded to nearest even (the reference's
    ``ml_dtypes`` bits); uploads view them as ``torch.bfloat16``."""
    import torch

    from photon_tpu_torch.data.batch import value_dtype
    from photon_tpu_torch.game.lowp import encode_bf16, host_f32, is_bf16_bits

    target = value_dtype(dtype)

    def cast(values: np.ndarray) -> np.ndarray:
        if target == torch.float32:
            return host_f32(values)
        return values if is_bf16_bits(values) else encode_bf16(values)

    shards: Dict[str, Shard] = {}
    for name, shard in data.shards.items():
        if isinstance(shard, DenseShard):
            shards[name] = DenseShard(cast(shard.x))
        else:
            shards[name] = SparseShard(shard.ids, cast(shard.vals), shard.dim_)
    return dataclasses.replace(data, shards=shards)


def take_rows(data: GameDataset, rows: np.ndarray) -> GameDataset:
    """Row-subset view of a GameDataset (train/validation splits)."""
    return GameDataset(
        label=data.label[rows],
        offset=data.offset[rows],
        weight=data.weight[rows],
        shards={n: _gather_shard_rows(s, rows) for n, s in data.shards.items()},
        id_columns={n: c[rows] for n, c in data.id_columns.items()},
    )


def split_game_dataset(
    data: GameDataset, validation_fraction: float, seed: int = 0
) -> tuple[GameDataset, GameDataset]:
    """Random train/validation row split (the reference takes a separate
    validation path; a fraction split covers single-file workflows)."""
    if not 0.0 < validation_fraction < 1.0:
        raise ValueError("validation_fraction must be in (0, 1)")
    n = data.num_examples
    if n < 2:
        raise ValueError("cannot split a dataset with fewer than 2 rows")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = min(n - 1, max(1, int(round(n * validation_fraction))))
    val_rows = np.sort(perm[:n_val])
    train_rows = np.sort(perm[n_val:])
    return take_rows(data, train_rows), take_rows(data, val_rows)


@dataclasses.dataclass(frozen=True)
class EntityBucket:
    """One row-capacity cohort of a random-effect dataset.

    Every entity in the bucket owns exactly ``row_capacity`` (padded) rows.
    Padded rows carry ``weight == 0`` (invisible to objectives); their
    ``row_index`` points at row 0, which is safe because weight masks them.
    """

    row_capacity: int
    entity_index: np.ndarray  # [E] int32 — global entity index
    row_index: np.ndarray  # [E, R] int64 — original dataset row
    row_weight: np.ndarray  # [E, R] float32 — 0 on padding; includes cap correction
    label: np.ndarray  # [E, R] float32
    features: Shard  # x: [E, R, d]  or  ids/vals: [E, R, k]

    @property
    def num_entities(self) -> int:
        return len(self.entity_index)


@dataclasses.dataclass(frozen=True)
class RandomEffectDataset:
    """Per-entity training data for one random-effect coordinate.

    ``keys`` is the sorted entity vocabulary; a global entity index is its
    position in ``keys``.  ``entity_idx_per_row`` maps every dataset row to
    its entity index (the scoring-side join the reference does with a
    shuffle).
    """

    entity_column: str
    shard_name: str
    dim: int
    keys: np.ndarray  # [num_entities] sorted unique entity keys
    buckets: tuple[EntityBucket, ...]
    entity_idx_per_row: np.ndarray  # [n] int32

    @property
    def num_entities(self) -> int:
        return len(self.keys)

    def entity_index_for(self, raw_keys: np.ndarray) -> np.ndarray:
        """Map raw entity keys to this dataset's entity indices (-1 = unseen).

        The scoring-time equivalent of the reference's data-model JOIN by
        entity id (SURVEY.md §3.3): unseen entities score zero from this
        coordinate.
        """
        return entity_index_for(raw_keys, self.keys)


def entity_index_for(raw_keys: np.ndarray, vocab_keys: np.ndarray) -> np.ndarray:
    """Vectorized key→index lookup against a sorted vocabulary; -1 = missing.

    Raw keys are coerced to the vocabulary's dtype kind first: Avro id
    columns arrive as strings while a saved model's entity keys may have been
    restored as integers (game.model_io), and comparing across kinds would
    silently match nothing.
    """
    raw = np.asarray(raw_keys)
    if len(vocab_keys) and len(raw) and raw.dtype.kind != vocab_keys.dtype.kind:
        if vocab_keys.dtype.kind in "iu" and raw.dtype.kind in "US":
            try:
                raw = raw.astype(np.int64)
            except (ValueError, OverflowError) as e:
                raise ValueError(
                    "entity id column holds strings that are not valid int64 "
                    "values but the vocabulary is integer-typed"
                ) from e
        else:
            # astype(str) keeps each value's natural width; casting to the
            # vocabulary's fixed-width dtype would truncate longer keys into
            # false matches.
            raw = raw.astype(str)
    pos = np.searchsorted(vocab_keys, raw)
    pos = np.clip(pos, 0, len(vocab_keys) - 1)
    found = vocab_keys[pos] == raw if len(vocab_keys) else np.zeros(len(raw), bool)
    return np.where(found, pos, -1).astype(np.int32)


#: Missing-id marker of int64 entity columns (narrower int columns use
#: their own dtype's minimum, strings ""; see :func:`missing_key`).
MISSING_INT64 = np.int64(np.iinfo(np.int64).min)


def missing_key(dtype):
    """The missing-id fill value for an entity column of ``dtype``: the
    dtype's OWN minimum for signed ints, its maximum for unsigned ints (0 is a real id), "" for strings."""
    dt = np.dtype(dtype)
    if dt.kind == "i":
        return dt.type(np.iinfo(dt).min)
    if dt.kind == "u":
        return dt.type(np.iinfo(dt).max)
    return ""


def missing_mask(values: np.ndarray) -> np.ndarray:
    """Bool mask of the values that carry the missing-id marker of their
    dtype (:func:`missing_key`)."""
    v = np.asarray(values)
    if len(v) == 0:
        return np.zeros(0, bool)
    if v.dtype.kind in "iu":
        return v == missing_key(v.dtype)
    return v == ""


def keys_match(keys, ref, ref_array: Optional[np.ndarray] = None) -> bool:
    """Is ``keys`` the same vocabulary as ``ref``?  Identity first — a model
    trained in THIS run carries the dataset's own keys object, so the O(E)
    host value compare runs only for foreign vocabularies (warm starts
    loaded from disk).  ``ref_array`` is ``ref`` pre-coerced to numpy when
    the caller caches it."""
    if keys is ref:
        return True
    return np.array_equal(
        np.asarray(keys), ref if ref_array is None else ref_array
    )


def build_random_effect_dataset(
    data: GameDataset,
    entity_column: str,
    shard_name: str,
    active_row_cap: Optional[int] = None,
    seed: int = 0,
    vocab: Optional[np.ndarray] = None,
    missing_marker="auto",
) -> RandomEffectDataset:
    """Group rows by entity and pack them into row-capacity buckets.

    This is the one-time host-side replacement for the reference's
    ``RandomEffectDataset`` build (groupByKey + partitionBy shuffle —
    SURVEY.md §2.6).  ``vocab`` pins the entity vocabulary (e.g. when
    bucketing validation data against a training vocabulary); by default the
    vocabulary is the sorted unique keys present in ``data``.

    ``missing_marker`` keeps missing-id rows OUT of the vocabulary: rows
    carrying the marker map to per-row entity index -1 (zero margin, no
    bin membership) instead of materializing a marker "entity" that trains
    its own random effect.  ``"auto"`` resolves the dtype-relative marker
    via :func:`missing_key` — the value ``merge_append`` fills when an
    append batch omits the id column — so a cold rebuild over a merged
    dataset reproduces the incremental path's semantics.  Pass ``None``
    to disable, or an explicit value to override.
    """
    if entity_column not in data.id_columns:
        raise KeyError(
            f"unknown id column {entity_column!r}; available: "
            f"{sorted(data.id_columns)}"
        )
    shard = data.shard(shard_name)
    raw = data.id_columns[entity_column]

    if isinstance(missing_marker, str) and missing_marker == "auto":
        marker = missing_key(raw.dtype) if raw.dtype.kind in "iuUS" else None
    else:
        marker = missing_marker

    if vocab is None:
        keys = np.unique(raw)
        if marker is not None:
            try:
                keys = keys[keys != keys.dtype.type(marker)]
            except (ValueError, OverflowError, TypeError):
                pass  # marker not representable in this dtype: nothing to drop
    else:
        # entity_index_for requires a sorted unique vocabulary; normalize the
        # caller's array (index = position in the SORTED keys, everywhere).
        keys = np.unique(np.asarray(vocab))
    entity_idx_per_row = entity_index_for(raw, keys)

    # Group row indices by entity (stable order = original row order).
    present = entity_idx_per_row >= 0
    order = np.argsort(entity_idx_per_row[present], kind="stable")
    rows_in_order = np.nonzero(present)[0][order]
    counts = np.bincount(entity_idx_per_row[present], minlength=len(keys))
    starts = np.concatenate([[0], np.cumsum(counts)])

    rng = np.random.default_rng(seed)
    # Per-entity kept rows: an index into rows_in_order for the common
    # (uncapped) case, so the cohort assembly below can gather VECTORIZED
    # over all entities of a capacity at once — the Python-loop-per-entity
    # build capped entity counts in the tens of thousands.  Only entities
    # OVER the active-row cap take the per-entity subsample path (seeded
    # draws in entity order, byte-identical to the historical loop).
    kept_counts = counts.copy()
    capped_rows: Dict[int, np.ndarray] = {}
    if active_row_cap is not None:
        for e in np.nonzero(counts > active_row_cap)[0]:
            entity_rows = rows_in_order[starts[e] : starts[e + 1]]
            # Active-set subsample with unbiased weight correction (the
            # reference's numActiveDataPointsUpperBound down-sampling).
            entity_rows = rng.choice(
                entity_rows, size=active_row_cap, replace=False
            )
            entity_rows.sort()
            capped_rows[int(e)] = entity_rows
            kept_counts[e] = active_row_cap

    present_entities = np.nonzero(counts > 0)[0]
    # Padded power-of-two row capacity per entity.
    kept = kept_counts[present_entities]
    capacities = 1 << np.maximum(
        0, np.ceil(np.log2(np.maximum(kept, 1))).astype(np.int64)
    )

    buckets = []
    for capacity in np.unique(capacities):
        members = present_entities[capacities == capacity]
        n_e = len(members)
        entity_index = members.astype(np.int32)
        row_index = np.zeros((n_e, capacity), np.int64)
        mask = (
            np.arange(capacity)[None, :] < kept_counts[members][:, None]
        ).astype(Float)
        corrections = np.ones(n_e, Float)
        uncapped = np.nonzero(counts[members] <= kept_counts[members])[0]
        if len(uncapped):
            m = members[uncapped]
            # Gather each uncapped entity's contiguous rows_in_order slice:
            # clamp keeps the index in range; mask zeroes the padding.
            idx = starts[m][:, None] + np.arange(capacity)[None, :]
            row_index[uncapped] = np.where(
                mask[uncapped] > 0,
                rows_in_order[np.minimum(idx, len(rows_in_order) - 1)],
                0,
            )
        for i in np.nonzero(counts[members] > kept_counts[members])[0]:
            e = int(members[i])
            row_index[i, : kept_counts[e]] = capped_rows[e]
            corrections[i] = counts[e] / kept_counts[e]
        row_weight = data.weight[row_index] * mask * corrections[:, None]
        buckets.append(
            EntityBucket(
                row_capacity=int(capacity),
                entity_index=entity_index,
                row_index=row_index,
                row_weight=row_weight.astype(Float),
                label=(data.label[row_index] * mask).astype(Float),
                features=_gather_shard_rows(shard, row_index),
            )
        )

    return RandomEffectDataset(
        entity_column=entity_column,
        shard_name=shard_name,
        dim=shard.dim,
        keys=keys,
        buckets=tuple(buckets),
        entity_idx_per_row=entity_idx_per_row,
    )


def plan_size_bins(
    buckets: tuple,
    max_bins: int = 4,
    waste_cap: float = 2.0,
) -> list:
    """Group row-capacity buckets into at most ``max_bins`` SIZE BINS.

    The power-of-two buckets bound per-entity padding to 2x, but each bucket
    is a separate batched solve: at production entity counts the
    O(buckets) solves and their host reads are the scaling cap.  A size bin
    merges adjacent capacities into ONE padded block solved by a single
    batched call — entities of a smaller bucket get their row axis padded
    (weight-0 rows) up to the bin's capacity.

    Policy: walk capacities from LARGEST to smallest, greedily absorbing a
    smaller bucket into the current bin while the bin's padded row cells
    stay within ``waste_cap`` × its live (bucket-padded) row cells; then, if
    more than ``max_bins`` bins remain, merge the adjacent pair that adds
    the fewest padded cells until the count fits.  Deterministic in the
    bucket list alone.

    Returns a list of bucket-index groups, each ascending, ordered by
    ascending capacity — ``merge_buckets`` turns a group into the padded
    block.
    """
    if max_bins < 1:
        raise ValueError("max_bins must be >= 1")
    stats = [
        (i, bucket.row_capacity, bucket.num_entities)
        for i, bucket in enumerate(buckets)
    ]

    def padded(members, cap):
        return cap * sum(n for _, _, n in members)

    def base(members):
        return sum(c * n for _, c, n in members)

    bins: list = []  # descending capacity; each a list of (idx, cap, n)
    for entry in sorted(stats, key=lambda t: -t[1]):
        if bins:
            members = bins[-1] + [entry]
            cap = members[0][1]
            if padded(members, cap) <= waste_cap * base(members):
                bins[-1] = members
                continue
        bins.append([entry])
    while len(bins) > max_bins:
        costs = []
        for j in range(len(bins) - 1):
            members = bins[j] + bins[j + 1]
            cap = members[0][1]
            grown = padded(members, cap)
            costs.append(
                grown - padded(bins[j], bins[j][0][1])
                - padded(bins[j + 1], bins[j + 1][0][1])
            )
        j = int(np.argmin(costs))
        bins[j : j + 2] = [bins[j] + bins[j + 1]]
    return [sorted(i for i, _, _ in members) for members in reversed(bins)]


def merge_buckets(buckets: list) -> EntityBucket:
    """Merge one size bin's buckets into a single padded ``EntityBucket``.

    Every member's row axis is padded (weight-0 rows, ``row_index`` 0 — the
    bucket convention) up to the bin capacity, then the entity axes
    concatenate; member order is the given order (ascending capacity from
    :func:`plan_size_bins`), entities keeping their within-bucket order.
    """
    if len(buckets) == 1:
        return buckets[0]
    capacity = max(b.row_capacity for b in buckets)
    padded = [pad_bucket_rows(b, capacity) for b in buckets]

    def cat(field):
        return np.concatenate([getattr(b, field) for b in padded])

    features = [b.features for b in padded]
    if isinstance(features[0], DenseShard):
        merged_features: Shard = DenseShard(
            np.concatenate([f.x for f in features])
        )
    else:
        merged_features = SparseShard(
            np.concatenate([f.ids for f in features]),
            np.concatenate([f.vals for f in features]),
            features[0].dim_,
        )
    return EntityBucket(
        row_capacity=capacity,
        entity_index=cat("entity_index"),
        row_index=cat("row_index"),
        row_weight=cat("row_weight"),
        label=cat("label"),
        features=merged_features,
    )


def pad_bucket_rows(bucket: EntityBucket, multiple: int) -> EntityBucket:
    """Pad a bucket's per-entity ROW capacity to a multiple (for row-split
    sharding: each mesh shard takes ``row_capacity / multiple`` rows of every
    entity — parallel/distributed.solve_entities_row_split).  Padded rows
    carry zero weight and row_index 0, the bucket's usual convention."""
    r = bucket.row_capacity
    target = ((r + multiple - 1) // multiple) * multiple
    if target == r:
        return bucket
    pad = target - r

    def pad1(a: np.ndarray) -> np.ndarray:
        widths = [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)
        return np.pad(a, widths)

    features = bucket.features
    if isinstance(features, DenseShard):
        features = DenseShard(pad1(features.x))
    else:
        features = SparseShard(pad1(features.ids), pad1(features.vals), features.dim_)
    return EntityBucket(
        row_capacity=target,
        entity_index=bucket.entity_index,
        row_index=pad1(bucket.row_index),
        row_weight=pad1(bucket.row_weight),
        label=pad1(bucket.label),
        features=features,
    )


def pad_bucket_entities(bucket: EntityBucket, multiple: int, num_entities: int) -> EntityBucket:
    """Pad a bucket's entity axis to a multiple (for even mesh sharding).

    Padded entities carry zero row weights and ``entity_index ==
    num_entities`` — a scatter into the coefficient table's dummy slot (the
    table is allocated with ``num_entities + 1`` rows; see
    RandomEffectCoordinate).
    """
    n_e = bucket.num_entities
    target = ((n_e + multiple - 1) // multiple) * multiple
    if target == n_e:
        return bucket
    pad = target - n_e

    def pad0(a: np.ndarray) -> np.ndarray:
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths)

    features = bucket.features
    if isinstance(features, DenseShard):
        features = DenseShard(pad0(features.x))
    else:
        features = SparseShard(pad0(features.ids), pad0(features.vals), features.dim_)
    return EntityBucket(
        row_capacity=bucket.row_capacity,
        entity_index=np.concatenate(
            [bucket.entity_index, np.full(pad, num_entities, np.int32)]
        ),
        row_index=pad0(bucket.row_index),
        row_weight=pad0(bucket.row_weight),
        label=pad0(bucket.label),
        features=features,
    )
