"""ctypes binding + schema compiler for the native GAME Avro decoder
(``src/avro_game.cpp``), the counterpart of ``photon_tpu/native/avro_native.py``.

``decode_file`` returns the columnar streams of one container file —
scalar doubles, interned id-column strings, and per-bag CSR entries with
a (name, term) pair vocab in first-seen ENTRY order (the exact id-
assignment order of the pure-Python reader's ``setdefault`` loop) — or
None whenever the file/schema falls outside the native subset, in which
case callers use the Python reader (``photon_tpu_torch/data/game_io.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
from typing import Optional

import numpy as np

from photon_tpu_torch.native.build import get_lib

# Opcodes — must match avro_game.cpp.
_OP_DOUBLE = 1
_OP_OPT_DOUBLE = 2
_OP_STRING = 3
_OP_SKIP_STRING = 4
_OP_SKIP_OPT_STRING = 5
_OP_BAG = 6
_OP_SKIP_BAG = 7
_OP_SKIP_DOUBLE = 8
_OP_SKIP_OPT_DOUBLE = 9

@dataclasses.dataclass
class CompiledSchema:
    """Flat opcode program + the slot each consumed field landed in."""

    descriptor: bytes
    dbl_slots: dict  # field name -> double-stream slot
    str_slots: dict  # field name -> string-stream slot
    bag_slots: dict  # field name -> bag slot


def _is_feature_record(items, named: dict) -> bool:
    if isinstance(items, str):
        items = named.get(items)
    if not isinstance(items, dict) or items.get("type") != "record":
        return False
    fields = items.get("fields", [])
    return (
        len(fields) == 3
        and [f["name"] for f in fields] == ["name", "term", "value"]
        and [f["type"] for f in fields] == ["string", "string", "double"]
    )


def compile_schema(
    schema: dict, bag_fields: set, id_fields: set,
    opt_defaults: Optional[dict] = None,
    dbl_fields: Optional[set] = None,
) -> Optional[CompiledSchema]:
    """Record schema -> opcode descriptor; None when any field falls
    outside the native subset (caller then uses the Python reader).

    ``opt_defaults`` maps field name -> value substituted for null in
    ``["null", "double"]`` unions (0.0 when unlisted — matching the Python
    reader's ``rec.get(...) or 0.0`` for offset; weight passes 1.0).
    ``dbl_fields`` limits which PLAIN double fields are decoded (others
    are skipped without storage); None decodes all of them.
    """
    if not isinstance(schema, dict) or schema.get("type") != "record":
        return None
    named: dict = {}

    def register(s):
        if isinstance(s, dict):
            if s.get("type") in ("record", "enum") and "name" in s:
                named[s["name"]] = s
            if s.get("type") == "record":
                for f in s.get("fields", []):
                    register(f["type"])
            elif s.get("type") == "array":
                register(s.get("items"))
        elif isinstance(s, list):
            for b in s:
                register(b)

    register(schema)
    opt_defaults = opt_defaults or {}
    out = bytearray()
    dbl_slots: dict = {}
    str_slots: dict = {}
    bag_slots: dict = {}
    n_dbl = n_str = n_bag = 0
    for field in schema.get("fields", []):
        name, ftype = field["name"], field["type"]
        if isinstance(ftype, dict) and ftype.get("type") == "array":
            if not _is_feature_record(ftype.get("items"), named):
                return None
            if name in bag_fields:
                out.append(_OP_BAG)
                bag_slots[name] = n_bag
                n_bag += 1
            else:
                out.append(_OP_SKIP_BAG)
            continue
        if isinstance(ftype, list):
            if len(ftype) != 2 or "null" not in ftype:
                return None
            null_branch = ftype.index("null")
            other = ftype[1 - null_branch]
            if other == "double":
                if name in id_fields:
                    return None  # id columns must be plain strings
                # Consume fields with a known null-default; skip the rest.
                if name in opt_defaults:
                    out.append(_OP_OPT_DOUBLE)
                    out.append(null_branch)
                    out.extend(struct.pack("<d", float(opt_defaults[name])))
                    dbl_slots[name] = n_dbl
                    n_dbl += 1
                else:
                    out.append(_OP_SKIP_OPT_DOUBLE)
                    out.append(null_branch)
            elif other == "string":
                if name in id_fields:
                    return None
                out.append(_OP_SKIP_OPT_STRING)
                out.append(null_branch)
            else:
                return None
            continue
        if ftype == "double":
            if dbl_fields is None or name in dbl_fields:
                out.append(_OP_DOUBLE)
                dbl_slots[name] = n_dbl
                n_dbl += 1
            else:
                out.append(_OP_SKIP_DOUBLE)
            continue
        if ftype == "string":
            if name in id_fields:
                out.append(_OP_STRING)
                str_slots[name] = n_str
                n_str += 1
            else:
                out.append(_OP_SKIP_STRING)
            continue
        return None  # anything else: Python reader
    if not bag_fields.issubset(bag_slots) or not id_fields.issubset(str_slots):
        return None
    return CompiledSchema(bytes(out), dbl_slots, str_slots, bag_slots)


@dataclasses.dataclass
class DecodedFile:
    n: int
    doubles: dict  # field -> np.float64 [n]
    id_columns: dict  # field -> np object array [n] of str
    bags: dict  # field -> (nnz[n] i32, pair_ids[e] i32, vals[e] f32, pairs)
    # pairs: list[(name, term)] in first-seen entry order


def decode_file(
    path: str, data_offset: int, sync: bytes, compiled: CompiledSchema
) -> Optional[DecodedFile]:
    """Run the native decoder over one container file's data blocks."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.gav_open(
        path.encode(), data_offset, sync, compiled.descriptor,
        len(compiled.descriptor),
    )
    if not handle:
        return None
    try:
        n = lib.gav_decode(handle)
        if n < 0:
            raise ValueError(
                f"{path}: native Avro decode failed: "
                f"{lib.gav_error(handle).decode()}"
            )

        def _i32ptr(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        doubles = {}
        for field, slot in compiled.dbl_slots.items():
            a = np.empty(n, np.float64)
            lib.gav_doubles(
                handle, slot, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            )
            doubles[field] = a
        id_columns = {}
        for field, slot in compiled.str_slots.items():
            idx = np.empty(n, np.int32)
            lib.gav_string_ids(handle, slot, _i32ptr(idx))
            vs = int(lib.gav_string_vocab_size(handle, slot))
            vb = int(lib.gav_string_vocab_bytes(handle, slot))
            lens = np.empty(max(vs, 1), np.int32)
            raw = ctypes.create_string_buffer(max(vb, 1))
            lib.gav_string_vocab(handle, slot, _i32ptr(lens), raw)
            vocab, off = [], 0
            for ln in lens[:vs]:
                vocab.append(raw.raw[off:off + ln].decode("utf-8"))
                off += int(ln)
            id_columns[field] = np.array(vocab, dtype=object)[idx] \
                if vs else np.empty(n, object)
        bags = {}
        for field, slot in compiled.bag_slots.items():
            nnz = np.empty(n, np.int32)
            lib.gav_bag_nnz(handle, slot, _i32ptr(nnz))
            e = int(lib.gav_bag_entries(handle, slot))
            pair_ids = np.empty(max(e, 1), np.int32)
            vals = np.empty(max(e, 1), np.float32)
            lib.gav_bag_pairs(handle, slot, _i32ptr(pair_ids))
            lib.gav_bag_vals(
                handle, slot, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            )
            vs = int(lib.gav_pair_vocab_size(handle, slot))
            vb = int(lib.gav_pair_vocab_bytes(handle, slot))
            lens = np.empty(max(2 * vs, 1), np.int32)
            raw = ctypes.create_string_buffer(max(vb, 1))
            lib.gav_pair_vocab(handle, slot, _i32ptr(lens), raw)
            pairs, off = [], 0
            for i in range(vs):
                nl, tl = int(lens[2 * i]), int(lens[2 * i + 1])
                pairs.append((
                    raw.raw[off:off + nl].decode("utf-8"),
                    raw.raw[off + nl:off + nl + tl].decode("utf-8"),
                ))
                off += nl + tl
            bags[field] = (nnz, pair_ids[:e], vals[:e], pairs)
        return DecodedFile(n=int(n), doubles=doubles, id_columns=id_columns,
                           bags=bags)
    finally:
        lib.gav_close(handle)
