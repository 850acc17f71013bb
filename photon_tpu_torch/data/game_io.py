"""GAME training data in Avro: records -> :class:`GameDataset` + index maps.

Counterpart of the Python path of ``photon_tpu/data/game_io.py``.  A
training record (``TrainingExampleAvro``) carries ``response``, optional
``offset``/``weight``/``uid``, one array of name/term/value records per
feature bag, and one string field per entity-id column.  Reading indexes
each bag's (name, term) keys through a per-shard :class:`IndexMap` (built in
first-seen order, or given) and packs the rows into padded-COO
:class:`SparseShard` blocks, the intercept last in every row.  The files are
the reference's, so each package reads what the other writes.

One pass over the records, decoded lazily and never kept: host memory is
bounded by the flat CSR accumulators.  The reference's native columnar
decoder (``photon_tpu/native/avro_native.py``) and its retry/fault sites
wait in ROADMAP.md queue 1, items 5 and 6.
"""

from __future__ import annotations

import glob as _glob
import os
from array import array
from typing import Dict, Optional, Sequence

import numpy as np

from photon_tpu_torch.data import avro_codec
from photon_tpu_torch.data.batch import pad_row_capacity
from photon_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap, feature_key
from photon_tpu_torch.game.data import GameDataset, SparseShard

FEATURE_SCHEMA = {
    "type": "record",
    "name": "FeatureAvro",
    "namespace": "photon_tpu.generated",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}


class NoRecordsError(ValueError):
    """An input yielded zero records."""


def _id_field(col: str, bag_fields: Sequence[str]) -> str:
    """Record field holding entity-id column ``col``; suffixed when the name
    collides with a feature-bag field."""
    return f"{col}__id" if col in bag_fields else col


def training_example_schema(
    feature_bags: Sequence[str], id_columns: Sequence[str]
) -> dict:
    """Schema of one training record: response/offset/weight/uid, one
    array-of-FeatureAvro field per bag, one string field per id column."""
    fields = [
        {"name": "response", "type": "double"},
        {"name": "offset", "type": ["null", "double"], "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "uid", "type": ["null", "string"], "default": None},
    ]
    for i, bag in enumerate(feature_bags):
        items = FEATURE_SCHEMA if i == 0 else "FeatureAvro"
        fields.append({"name": bag, "type": {"type": "array", "items": items}})
    for col in id_columns:
        fields.append({"name": _id_field(col, feature_bags), "type": "string"})
    return {
        "type": "record",
        "name": "TrainingExampleAvro",
        "namespace": "photon_tpu.generated",
        "fields": fields,
    }


def _input_files(path: str) -> list[str]:
    """A file, a directory of part files, or a glob -> sorted file list
    (dot- and underscore-prefixed names excluded)."""
    if os.path.isdir(path):
        pattern = os.path.join(path, "*")
    elif os.path.isfile(path):
        return [path]
    else:
        pattern = path
    files = sorted(
        p
        for p in _glob.glob(pattern)
        if os.path.isfile(p) and not os.path.basename(p).startswith((".", "_"))
    )
    if not files:
        raise FileNotFoundError(f"no input files match {path!r}")
    return files


def is_avro_dir(spec: str) -> bool:
    """True when ``spec`` is a directory holding ``.avro`` part files."""
    return os.path.isdir(spec) and any(
        f.endswith(".avro") for f in os.listdir(spec)
    )


def narrow_avro_dir(spec: str) -> str:
    """An Avro directory -> its ``*.avro`` glob; any other spec passes."""
    if is_avro_dir(spec):
        return os.path.join(spec, "*.avro")
    return spec


def write_game_avro(
    path: str,
    dataset: GameDataset,
    index_maps: Dict[str, IndexMap],
    feature_bags: Optional[Dict[str, str]] = None,
) -> None:
    """Write a GameDataset as TrainingExampleAvro records, zeros and the
    intercept left out (readers add the intercept back per row).

    ``feature_bags`` maps shard name -> record field name (default: the
    shard name itself).  Records are generated one at a time."""
    feature_bags = feature_bags or {name: name for name in dataset.shards}
    id_cols = sorted(dataset.id_columns)
    bag_fields = [feature_bags[s] for s in sorted(feature_bags)]
    schema = training_example_schema(bag_fields, id_cols)
    id_fields = [(_id_field(col, bag_fields), dataset.id_columns[col])
                 for col in id_cols]

    def bag_rows(shard, imap: IndexMap):
        """Per row, the bag's name/term/value records (zeros skipped)."""
        names = []
        for fid in range(len(imap)):
            key = imap.get_key(fid)
            name, _, term = key.partition("\x01")
            names.append(None if key == INTERCEPT_KEY else (name, term))
        if isinstance(shard, SparseShard):
            ids, vals = shard.ids, shard.vals
        else:
            x = shard.x
            ids = np.broadcast_to(np.arange(x.shape[1]), x.shape)
            vals = x
        for r_ids, r_vals in zip(ids.tolist(), vals.tolist()):
            yield [
                {"name": names[f][0], "term": names[f][1], "value": v}
                for f, v in zip(r_ids, r_vals)
                if v != 0.0 and names[f] is not None
            ]

    bags = {
        field: bag_rows(dataset.shard(shard_name), index_maps[shard_name])
        for shard_name, field in feature_bags.items()
    }
    label = dataset.label.tolist()
    offset = dataset.offset.tolist()
    weight = dataset.weight.tolist()

    def records():
        for i in range(dataset.num_examples):
            rec = {
                "response": label[i], "offset": offset[i],
                "weight": weight[i], "uid": str(i),
            }
            for field, rows in bags.items():
                rec[field] = next(rows)
            for field, col in id_fields:
                rec[field] = str(col[i])
            yield rec

    avro_codec.write_container(path, schema, records())


def read_game_avro(
    path: str,
    feature_bags: Dict[str, str],
    id_columns: Sequence[str],
    index_maps: Optional[Dict[str, IndexMap]] = None,
    intercept: bool = True,
) -> tuple[GameDataset, Dict[str, IndexMap]]:
    """Read TrainingExampleAvro file(s) into a GameDataset.

    ``feature_bags`` maps shard name -> the record field holding its
    features.  Without ``index_maps`` the maps are built from the data in
    first-seen order, the intercept last; with them (the fixed-index path)
    features absent from a map are dropped and every row keeps the map's
    intercept.  Entity ids come back as strings."""
    files = _input_files(narrow_avro_dir(path))
    build_maps = index_maps is None
    label = array("f")
    offset = array("f")
    weight = array("f")
    ids_cols: Dict[str, list] = {c: [] for c in id_columns}
    vocab: Dict[str, Dict[str, int]] = {s: {} for s in feature_bags}
    flat_ids: Dict[str, array] = {s: array("i") for s in feature_bags}
    flat_vals: Dict[str, array] = {s: array("f") for s in feature_bags}
    nnz: Dict[str, array] = {s: array("i") for s in feature_bags}

    i = 0
    for fpath in files:
        fh, schema, named, sync = avro_codec.open_container(fpath)
        with fh:
            for rec in avro_codec.iter_records(fh, schema, named, sync, fpath):
                label.append(rec["response"])
                offset.append(rec.get("offset") or 0.0)
                weight.append(1.0 if rec.get("weight") is None else rec["weight"])
                for col in id_columns:
                    field = f"{col}__id" if f"{col}__id" in rec else col
                    if field not in rec:
                        raise KeyError(f"record {i} missing id column {col!r}")
                    ids_cols[col].append(rec[field])
                for shard_name, field in feature_bags.items():
                    f_ids, f_vals = flat_ids[shard_name], flat_vals[shard_name]
                    m = 0
                    if build_maps:
                        seen = vocab[shard_name]
                        for ntv in rec.get(field, ()):
                            key = feature_key(ntv["name"], ntv["term"])
                            if key == INTERCEPT_KEY:
                                continue  # added once per row below
                            f_ids.append(seen.setdefault(key, len(seen)))
                            f_vals.append(ntv["value"])
                            m += 1
                        if intercept:
                            f_ids.append(-1)  # patched once the map is built
                            f_vals.append(1.0)
                            m += 1
                    else:
                        imap = index_maps[shard_name]
                        for ntv in rec.get(field, ()):
                            key = feature_key(ntv["name"], ntv["term"])
                            if key == INTERCEPT_KEY:
                                continue
                            fid = imap.get_id(key)
                            if fid >= 0:  # absent from a fixed map: dropped
                                f_ids.append(fid)
                                f_vals.append(ntv["value"])
                                m += 1
                        if imap.intercept_id is not None:
                            f_ids.append(imap.intercept_id)
                            f_vals.append(1.0)
                            m += 1
                    nnz[shard_name].append(m)
                i += 1
    if i == 0:
        raise NoRecordsError(f"no records in {path!r}")
    if build_maps:
        index_maps = {
            s: IndexMap.build(list(vocab[s]), intercept=intercept)
            for s in feature_bags
        }

    shards: Dict[str, SparseShard] = {}
    for shard_name in feature_bags:
        imap = index_maps[shard_name]
        counts = np.asarray(nnz[shard_name], dtype=np.int32).astype(np.int64)
        ids_f = np.array(flat_ids[shard_name], dtype=np.int32)
        vals_f = np.asarray(flat_vals[shard_name], dtype=np.float32)
        if build_maps and imap.intercept_id is not None:
            ids_f[ids_f < 0] = imap.intercept_id
        k = pad_row_capacity(counts)
        ids = np.zeros((i, k), np.int32)
        vals = np.zeros((i, k), np.float32)
        row_idx = np.repeat(np.arange(i, dtype=np.int64), counts)
        starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
        col_idx = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(
            starts, counts
        )
        ids[row_idx, col_idx] = ids_f
        vals[row_idx, col_idx] = vals_f
        shards[shard_name] = SparseShard(ids, vals, len(imap))

    dataset = GameDataset(
        label=np.asarray(label, dtype=np.float32),
        offset=np.asarray(offset, dtype=np.float32),
        weight=np.asarray(weight, dtype=np.float32),
        shards=shards,
        id_columns={c: np.asarray(v) for c, v in ids_cols.items()},
    )
    return dataset, index_maps
