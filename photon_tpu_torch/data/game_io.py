"""GAME training data in Avro: records -> :class:`GameDataset` + index maps.

Counterpart of the Python path of ``photon_tpu/data/game_io.py``.  A
training record (``TrainingExampleAvro``) carries ``response``, optional
``offset``/``weight``/``uid``, one array of name/term/value records per
feature bag, and one string field per entity-id column.  Reading indexes
each bag's (name, term) keys through a per-shard :class:`IndexMap` (built in
first-seen order, or given) and packs the rows into padded-COO
:class:`SparseShard` blocks, the intercept last in every row.  The files are
the reference's, so each package reads what the other writes.

The read takes the native columnar decoder first (``native/avro_native.py``
over ``native/src/avro_game.cpp``, the reference's ``_read_native``): it
decodes every file into flat streams in C++ and assigns feature ids from a
vocabulary-sized loop, giving the same arrays as the Python reader bit for
bit.  Files outside its subset (a non-null codec, unexpected field types,
a missing id column), an unbuilt host library, or
``PHOTON_TPU_NO_NATIVE_AVRO=1`` take the Python reader: one pass over the
records, decoded lazily and never kept, host memory bounded by the flat CSR
accumulators.  ``last_reader`` names the reader of the last
:func:`read_game_avro` (``"native"`` or ``"python"``).  Each file's read
sits behind the ``io:read`` fault site and retries transient IO errors
with backoff, as the reference's does (a whole-file decode changes nothing
when it fails).
"""

from __future__ import annotations

import glob as _glob
import logging
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


last_reader: Optional[str] = None


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
    global last_reader
    files = _input_files(narrow_avro_dir(path))
    build_maps = index_maps is None
    native = _read_native(files, feature_bags, id_columns, index_maps, intercept)
    last_reader = "python" if native is None else "native"
    logging.getLogger("photon_tpu_torch.data").info(
        "read %d Avro file(s) of %r with the %s reader", len(files), path, last_reader)
    if native is not None:
        label, offset, weight, ids_cols, flat_ids, flat_vals, nnz, vocab, n = native
        return _assemble_game_read(
            path, n, label, offset, weight, ids_cols, flat_ids, flat_vals, nnz,
            vocab if build_maps else None, feature_bags, index_maps, intercept,
        )

    label = array("f")
    offset = array("f")
    weight = array("f")
    ids_cols: Dict[str, list] = {c: [] for c in id_columns}
    vocab: Dict[str, Dict[str, int]] = {s: {} for s in feature_bags}
    flat_ids: Dict[str, array] = {s: array("i") for s in feature_bags}
    flat_vals: Dict[str, array] = {s: array("f") for s in feature_bags}
    nnz: Dict[str, array] = {s: array("i") for s in feature_bags}

    from photon_tpu_torch.fault.injection import fault_point
    from photon_tpu_torch.fault.retry import retry_call

    def open_records(fpath):
        fault_point("io:read", path=fpath)
        return avro_codec.open_container(fpath)

    i = 0
    for fpath in files:
        fh, schema, named, sync = retry_call(lambda p=fpath: open_records(p),
                                             site="avro:read")
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
    return _assemble_game_read(
        path, i, label, offset, weight, ids_cols, flat_ids, flat_vals, nnz,
        vocab if build_maps else None, feature_bags, index_maps, intercept,
    )


def _read_native(files, feature_bags, id_columns, index_maps, intercept):
    """The columnar native decode of all files, as the Python loop's
    accumulators, or None whenever a file falls outside the native subset
    (or the host library is not built, or ``PHOTON_TPU_NO_NATIVE_AVRO`` is
    set): the Python reader then runs.

    The decoder interns (name, term) pairs in first-seen entry order, so a
    vocabulary-sized loop plus numpy remaps assign the Python loop's ids,
    values and order (the intercept last in each record) exactly.  A
    header-only pass over every file decides the fallback before any
    decode.  Files decode one after another, in file order."""
    if os.environ.get("PHOTON_TPU_NO_NATIVE_AVRO", "") not in ("", "0"):
        return None
    from photon_tpu_torch.native import avro_native
    from photon_tpu_torch.native.build import get_lib

    if get_lib() is None:
        return None
    build_maps = index_maps is None
    bag_fields = set(feature_bags.values())
    plans = []
    try:
        for fp in files:
            with open(fp, "rb") as f:
                schema, meta, sync = avro_codec.read_header_meta(f, fp)
                data_offset = f.tell()
            if meta.get("avro.codec", b"null") not in (b"null", b""):
                return None
            if not isinstance(schema, dict):
                return None
            fields = {fld["name"] for fld in schema.get("fields", [])}
            id_field_of = {}
            for col in id_columns:
                field = f"{col}__id" if f"{col}__id" in fields else col
                if field not in fields:
                    return None  # the Python path raises the canonical KeyError
                id_field_of[col] = field
            compiled = avro_native.compile_schema(
                schema, bag_fields, set(id_field_of.values()),
                opt_defaults={"offset": 0.0, "weight": 1.0},
                dbl_fields={"response", "offset", "weight"},
            )
            if compiled is None or "response" not in compiled.dbl_slots:
                return None
            plans.append((fp, data_offset, sync, compiled, id_field_of))
    except ValueError:
        return None  # a malformed header: the Python reader gives the error

    labels, offsets, weights = [], [], []
    idcols_out: Dict[str, list] = {c: [] for c in id_columns}
    flat_parts: Dict[str, tuple] = {s: ([], [], []) for s in feature_bags}
    gvocab = {s: {} for s in feature_bags} if build_maps else None
    skip = -2  # a removed entry: the intercept in the data, or off a fixed map
    n_total = 0
    from photon_tpu_torch.fault.injection import fault_point
    from photon_tpu_torch.fault.retry import retry_call

    def decode(fp, data_offset, sync, compiled):
        fault_point("io:read", path=fp)
        return avro_native.decode_file(fp, data_offset, sync, compiled)

    for fp, data_offset, sync, compiled, id_field_of in plans:
        decoded = retry_call(lambda: decode(fp, data_offset, sync, compiled),
                             site="avro:read")
        if decoded is None:
            return None
        n = decoded.n
        n_total += n
        labels.append(decoded.doubles["response"].astype(np.float32))
        off = decoded.doubles.get("offset")
        offsets.append(np.zeros(n, np.float32) if off is None else off.astype(np.float32))
        wgt = decoded.doubles.get("weight")
        weights.append(np.ones(n, np.float32) if wgt is None else wgt.astype(np.float32))
        for col in id_columns:
            idcols_out[col].extend(decoded.id_columns[id_field_of[col]].tolist())
        for shard_name, field in feature_bags.items():
            nnz_f, pair_ids, vals, pairs = decoded.bags[field]
            nnz_f = nnz_f.astype(np.int64)
            # Pairs come in first-seen entry order, so setdefault over them
            # assigns the Python loop's per-entry first-seen ids.
            lut = np.empty(max(len(pairs), 1), np.int64)
            if build_maps:
                seen = gvocab[shard_name]
                for pi, (nm, tm) in enumerate(pairs):
                    key = feature_key(nm, tm)
                    lut[pi] = skip if key == INTERCEPT_KEY else seen.setdefault(
                        key, len(seen))
            else:
                imap = index_maps[shard_name]
                for pi, (nm, tm) in enumerate(pairs):
                    key = feature_key(nm, tm)
                    fid = -1 if key == INTERCEPT_KEY else imap.get_id(key)
                    lut[pi] = fid if fid >= 0 else skip
            entry_fids = lut[pair_ids] if len(pair_ids) else np.empty(0, np.int64)
            keep = entry_fids != skip
            nnz_kept = nnz_f
            if not keep.all():
                row_idx = np.repeat(np.arange(n, dtype=np.int64), nnz_f)
                nnz_kept = nnz_f - np.bincount(row_idx[~keep], minlength=n)
            kept_fids = entry_fids[keep]
            kept_vals = vals[keep]
            add_intercept = (build_maps and intercept) or (
                not build_maps and index_maps[shard_name].intercept_id is not None)
            if add_intercept:
                # Scatter the kept entries to their final positions, then
                # fill each record's tail slot with the intercept.
                final_nnz = nnz_kept + 1
                total = int(final_nnz.sum())
                out_ids = np.empty(total, np.int64)
                out_vals = np.empty(total, np.float32)
                starts = np.concatenate(([0], np.cumsum(final_nnz)))[:-1]
                kept_rows = np.repeat(np.arange(n, dtype=np.int64), nnz_kept)
                kept_starts = np.concatenate(([0], np.cumsum(nnz_kept)))[:-1]
                idx_in_row = np.arange(int(nnz_kept.sum()), dtype=np.int64) - np.repeat(
                    kept_starts, nnz_kept)
                pos = starts[kept_rows] + idx_in_row
                out_ids[pos] = kept_fids
                out_vals[pos] = kept_vals
                tail = starts + nnz_kept
                out_ids[tail] = -1 if build_maps else index_maps[shard_name].intercept_id
                out_vals[tail] = 1.0
            else:
                final_nnz, out_ids, out_vals = nnz_kept, kept_fids, kept_vals
            fids_l, vals_l, nnz_l = flat_parts[shard_name]
            fids_l.append(out_ids.astype(np.int32))
            vals_l.append(out_vals.astype(np.float32))
            nnz_l.append(final_nnz.astype(np.int32))

    def _cat(parts, dtype):
        return (np.concatenate(parts) if parts else np.empty(0, dtype)).astype(
            dtype, copy=False)

    flat_ids = {s: _cat(flat_parts[s][0], np.int32) for s in feature_bags}
    flat_vals = {s: _cat(flat_parts[s][1], np.float32) for s in feature_bags}
    nnz = {s: _cat(flat_parts[s][2], np.int32) for s in feature_bags}
    return (_cat(labels, np.float32), _cat(offsets, np.float32),
            _cat(weights, np.float32), idcols_out, flat_ids, flat_vals, nnz,
            gvocab, n_total)


def _assemble_game_read(path, n, label, offset, weight, ids_cols, flat_ids,
                        flat_vals, nnz, vocab, feature_bags, index_maps, intercept):
    """The shared tail of both readers: vocabularies -> index maps, flat
    CSR -> padded-COO shards, the dataset.  ``vocab`` is not None exactly
    when the maps are built from the data."""
    if n == 0:
        raise NoRecordsError(f"no records in {path!r}")
    build_maps = vocab is not None
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
        ids = np.zeros((n, k), np.int32)
        vals = np.zeros((n, k), np.float32)
        row_idx = np.repeat(np.arange(n, dtype=np.int64), counts)
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
