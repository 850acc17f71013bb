"""Append-batch delta: which coordinates and entities a batch touches.

A copy of ``photon_tpu/online/delta.py``.  The online-learning loop
exploits the GAME decomposition:
appended rows touch a small set of coordinates/entities, so a warm-started
partial refresh — touched coordinates retrain, the rest stay locked on the
serving model — is dramatically cheaper than a full fit (Snap ML,
1803.06333, makes the same argument for hierarchical incremental GLMs).
This module computes that delta on host numpy, before any device work:

- :func:`merge_append` concatenates an append batch onto the base training
  dataset (append-only).  A batch may OMIT an id column — records that
  carry no id for a random effect simply do not participate in it (the
  reference's ``GameDatum`` semantics); the merged column is filled with a
  dtype-appropriate missing marker and the bool mask of filled rows rides
  back so device-data growth skips them (per-row entity index -1: zero
  margin, no bin membership).
- :func:`compute_delta` classifies every coordinate of a configuration:
  touched or not, and a touched one's NEW vs EXISTING entity keys against
  the current vocabularies — the lock list and the growth summary of one
  refresh round.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from photon_tpu_torch.game.data import (
    DenseShard,
    GameDataset,
    Shard,
    SparseShard,
    entity_index_for,
)
# The marker definitions live next to the dataset builders (the cold
# rebuild resolves them too); re-exported here.
from photon_tpu_torch.game.data import (  # noqa: F401
    MISSING_INT64,
    missing_key,
    missing_mask,
)


def _to_base_layout(base: Shard, b: Shard) -> Shard:
    """Coerce an append shard to the base's storage layout.  Avro parts
    arrive padded-COO sparse while a base built from dense blocks stores
    dense (and vice versa); the conversion touches only the DELTA's rows."""
    if type(base) is type(b):
        return b
    if isinstance(base, DenseShard):
        # sparse append -> dense rows (padding ids are 0 with val 0: inert;
        # add.at folds duplicate ids like the sparse margin kernel's sum).
        x = np.zeros((b.ids.shape[0], b.dim), np.float32)
        np.add.at(x, (np.arange(len(b.ids))[:, None], b.ids), b.vals)
        return DenseShard(x)
    n = b.x.shape[0]
    counts = (b.x != 0).sum(axis=1)
    k = max(int(counts.max()) if n else 1, 1)
    ids = np.zeros((n, k), np.int32)
    vals = np.zeros((n, k), np.float32)
    for i in range(n):  # delta-sized loop (appended rows only)
        nz = np.nonzero(b.x[i])[0]
        ids[i, : len(nz)] = nz
        vals[i, : len(nz)] = b.x[i][nz]
    return SparseShard(ids, vals, base.dim_)


def _concat_shards(name: str, a: Shard, b: Shard) -> Shard:
    """Row-concatenate two feature shards, coercing the append side to the
    base's layout first.  Sparse shards may differ in padded-COO nonzero
    width (Avro parts pad to their own max); the narrower pads up — zero
    ids/vals are inert."""
    if a.dim != b.dim:
        raise ValueError(
            f"append batch shard {name!r} has dim {b.dim}, base has {a.dim}"
        )
    b = _to_base_layout(a, b)
    if isinstance(a, DenseShard):
        return DenseShard(np.concatenate([a.x, b.x]))
    k = max(a.ids.shape[1], b.ids.shape[1])

    def pad(arr):
        if arr.shape[1] == k:
            return arr
        return np.pad(arr, [(0, 0), (0, k - arr.shape[1])])

    return SparseShard(
        np.concatenate([pad(a.ids), pad(b.ids)]),
        np.concatenate([pad(a.vals), pad(b.vals)]),
        a.dim_,
    )


def merge_append(
    base: GameDataset, batch: GameDataset
) -> tuple[GameDataset, Dict[str, np.ndarray]]:
    """Append ``batch``'s rows onto ``base`` (append-only merge).

    Returns ``(merged, absent_tail)`` where ``absent_tail`` maps each id
    column to a bool mask over the APPENDED rows marking rows that carry no
    id for that column — either because the batch omitted the column
    entirely (filled with the missing marker here) or because the batch
    itself shipped marker values.  The mask is what
    ``GameEstimator.onboard_training_data`` forwards into device-data
    growth.  Every feature shard of the base must ride along (all rows
    train the fixed effect); unknown shards or id columns in the batch are
    refused loudly.
    """
    unknown = set(batch.shards) - set(base.shards)
    if unknown:
        raise ValueError(
            f"append batch carries unknown feature shard(s) "
            f"{sorted(unknown)}; base has {sorted(base.shards)}"
        )
    missing_shards = set(base.shards) - set(batch.shards)
    if missing_shards:
        raise ValueError(
            f"append batch must carry every feature shard (appended rows "
            f"train the fixed effect too); missing {sorted(missing_shards)}"
        )
    unknown_cols = set(batch.id_columns) - set(base.id_columns)
    if unknown_cols:
        raise ValueError(
            f"append batch carries unknown id column(s) "
            f"{sorted(unknown_cols)}; base has {sorted(base.id_columns)}"
        )
    n_tail = batch.num_examples
    shards = {
        name: _concat_shards(name, shard, batch.shards[name])
        for name, shard in base.shards.items()
    }
    id_columns = {}
    absent_tail: Dict[str, np.ndarray] = {}
    for name, col in base.id_columns.items():
        if name in batch.id_columns:
            # host-sync: id columns are host numpy by construction.
            tail = np.asarray(batch.id_columns[name])
            if len(tail) and tail.dtype.kind != col.dtype.kind:
                # The coercion entity_index_for applies, done once at merge:
                # mixed-kind concatenation would silently stringify ints.
                if col.dtype.kind in "iu":
                    tail = tail.astype(np.int64)
                else:
                    tail = tail.astype(str)
            if (len(tail) and col.dtype.kind in "iu"
                    and tail.dtype != col.dtype):
                # The merged column keeps the BASE dtype forever: letting
                # np.concatenate promote (int32 base + int64 tail) would
                # strand earlier rounds' missing markers as valid-looking
                # ids.  The tail's own markers translate to the base
                # dtype's marker; real ids must fit the base dtype.
                marker = missing_mask(tail)
                info = np.iinfo(col.dtype)
                bad = ~marker & ((tail < info.min) | (tail > info.max))
                if bad.any():
                    raise ValueError(
                        f"append batch id column {name!r} carries values "
                        f"outside the base column's {col.dtype} range"
                    )
                tail = tail.astype(col.dtype)
                tail[marker] = missing_key(col.dtype)
            absent_tail[name] = missing_mask(tail)
        else:
            tail = np.full(n_tail, missing_key(col.dtype))
            tail = tail.astype(col.dtype) if col.dtype.kind in "iu" else tail
            absent_tail[name] = np.ones(n_tail, bool)
        id_columns[name] = np.concatenate([col, tail])
    merged = GameDataset(
        label=np.concatenate([base.label, batch.label]),
        offset=np.concatenate([base.offset, batch.offset]),
        weight=np.concatenate([base.weight, batch.weight]),
        shards=shards,
        id_columns=id_columns,
    )
    return merged, absent_tail


@dataclasses.dataclass(frozen=True)
class CoordinateDelta:
    """One coordinate's slice of an append batch."""

    name: str
    kind: str  # fixed | random | factored_random
    touched: bool
    new_keys: np.ndarray       # entity keys NOT in the current vocabulary
    existing_keys: np.ndarray  # entity keys already in the vocabulary

    @property
    def rows_grow_existing(self) -> bool:
        return len(self.existing_keys) > 0


_EMPTY = np.zeros(0, np.int64)


@dataclasses.dataclass(frozen=True)
class BatchDelta:
    """What one append batch touches, per coordinate of a configuration."""

    rows: int
    coordinates: Dict[str, CoordinateDelta]

    @property
    def touched(self) -> list:
        return [n for n, c in self.coordinates.items() if c.touched]

    @property
    def untouched(self) -> list:
        return [n for n, c in self.coordinates.items() if not c.touched]


def compute_delta(
    coordinate_configs: Dict[str, object],
    vocabs: Dict[str, np.ndarray],
    batch: GameDataset,
    absent_tail: Optional[Dict[str, np.ndarray]] = None,
) -> BatchDelta:
    """Classify every coordinate of a configuration against one append
    batch.  ``vocabs`` maps entity column -> current entity vocabulary;
    ``absent_tail`` (as returned by :func:`merge_append`) masks rows that
    carry no id for a column.  A fixed-effect coordinate is touched by any
    row (every row enters its batch); a random coordinate is touched when
    at least one appended row carries an id for its column."""
    n = batch.num_examples
    absent_tail = absent_tail or {}
    out: Dict[str, CoordinateDelta] = {}
    for name, cc in coordinate_configs.items():
        kind = getattr(cc, "kind", "fixed")
        column = getattr(cc, "entity_column", None)
        if column is None:
            out[name] = CoordinateDelta(name, kind, n > 0, _EMPTY, _EMPTY)
            continue
        if column not in batch.id_columns:
            out[name] = CoordinateDelta(name, kind, False, _EMPTY, _EMPTY)
            continue
        # host-sync: id columns are host numpy by construction.
        tail = np.asarray(batch.id_columns[column])
        mask = absent_tail.get(column)
        live = tail[~mask] if mask is not None else tail[~missing_mask(tail)]
        if len(live) == 0:
            out[name] = CoordinateDelta(name, kind, False, _EMPTY, _EMPTY)
            continue
        vocab = vocabs.get(column)
        if vocab is not None and len(vocab):
            idx = entity_index_for(live, vocab)
        else:
            idx = np.full(len(live), -1, np.int32)
        out[name] = CoordinateDelta(
            name, kind, True,
            np.unique(live[idx < 0]), np.unique(live[idx >= 0]),
        )
    return BatchDelta(rows=n, coordinates=out)


def merge_deltas(deltas: list) -> BatchDelta:
    """Union of several batches' deltas (one refresh round may drain more
    than one pending batch)."""
    if not deltas:
        return BatchDelta(0, {})
    rows = sum(d.rows for d in deltas)
    names = list(deltas[0].coordinates)
    coordinates = {}
    for name in names:
        parts = [d.coordinates[name] for d in deltas]
        coordinates[name] = CoordinateDelta(
            name, parts[0].kind,
            any(p.touched for p in parts),
            np.unique(np.concatenate([p.new_keys for p in parts]))
            if any(len(p.new_keys) for p in parts) else _EMPTY,
            np.unique(np.concatenate([p.existing_keys for p in parts]))
            if any(len(p.existing_keys) for p in parts) else _EMPTY,
        )
    return BatchDelta(rows=rows, coordinates=coordinates)
