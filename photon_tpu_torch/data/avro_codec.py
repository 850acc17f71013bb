"""Minimal pure-Python Avro binary codec (subset).

A copy of ``photon_tpu/data/avro_codec.py`` trimmed to what model files
and GAME training data need, so the port reads and writes the same Avro
files as the JAX package without importing it.  Written from the public Avro 1.x format
spec:

- primitives: null, boolean, int/long (zigzag varint), float, double,
  string, bytes
- complex: record, array, map, union, enum
- Object Container Files (magic ``Obj\\x01``, metadata map with schema
  JSON, null codec, sync-marker-delimited blocks), read whole
  (:func:`read_container`) or record by record (:func:`open_container`,
  :func:`iter_records`, :func:`iter_container`) for the GAME training
  reader
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, BinaryIO

MAGIC = b"Obj\x01"


# --------------------------------------------------------------------------
# primitive encoders
# --------------------------------------------------------------------------
def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_long(buf: BinaryIO, n: int) -> None:
    z = _zigzag_encode(n) & 0xFFFFFFFFFFFFFFFF
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def read_long(buf: BinaryIO) -> int:
    shift = 0
    acc = 0
    while True:
        byte = buf.read(1)
        if not byte:
            raise EOFError("truncated varint")
        b = byte[0]
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _zigzag_decode(acc)
        shift += 7


def write_string(buf: BinaryIO, s: str) -> None:
    raw = s.encode("utf-8")
    write_long(buf, len(raw))
    buf.write(raw)


def read_string(buf: BinaryIO) -> str:
    n = read_long(buf)
    return buf.read(n).decode("utf-8")


def write_bytes(buf: BinaryIO, b: bytes) -> None:
    write_long(buf, len(b))
    buf.write(b)


def read_bytes(buf: BinaryIO) -> bytes:
    return buf.read(read_long(buf))


# --------------------------------------------------------------------------
# schema-driven datum encoder/decoder
# --------------------------------------------------------------------------
class _Named:
    """Registry of named types within one schema (records/enums by name)."""

    def __init__(self):
        self.types: dict[str, Any] = {}


def _resolve(schema: Any, named: _Named) -> Any:
    if isinstance(schema, str) and schema in named.types:
        return named.types[schema]
    return schema


def _register_named(schema: Any, named: _Named) -> None:
    """Walk a schema and register every named type up front, so by-name
    references resolve even when the defining occurrence writes/reads no
    data first (e.g. an empty array of records followed by a by-name
    reference in a later field)."""
    if isinstance(schema, list):
        for branch in schema:
            _register_named(branch, named)
        return
    if not isinstance(schema, dict):
        return
    t = schema.get("type")
    if t in ("record", "enum") and "name" in schema:
        if schema["name"] in named.types:
            return  # already walked (guards recursive schemas)
        named.types[schema["name"]] = schema
    if t == "record":
        for field in schema["fields"]:
            _register_named(field["type"], named)
    elif t == "array":
        _register_named(schema["items"], named)
    elif t == "map":
        _register_named(schema["values"], named)


def write_datum(buf: BinaryIO, datum: Any, schema: Any, named: _Named | None = None) -> None:
    if named is None:
        named = _Named()
        _register_named(schema, named)
    schema = _resolve(schema, named)
    if isinstance(schema, str):
        t = schema
        if t == "null":
            return
        if t == "boolean":
            buf.write(b"\x01" if datum else b"\x00")
        elif t in ("int", "long"):
            write_long(buf, int(datum))
        elif t == "float":
            buf.write(struct.pack("<f", float(datum)))
        elif t == "double":
            buf.write(struct.pack("<d", float(datum)))
        elif t == "string":
            write_string(buf, datum)
        elif t == "bytes":
            write_bytes(buf, datum)
        else:
            raise ValueError(f"unsupported primitive {t!r}")
        return
    if isinstance(schema, list):  # union: pick first matching branch
        for i, branch in enumerate(schema):
            if _matches(datum, branch, named):
                write_long(buf, i)
                write_datum(buf, datum, branch, named)
                return
        raise ValueError(f"datum {datum!r} matches no union branch {schema}")
    t = schema["type"]
    if t == "record":
        for field in schema["fields"]:
            write_datum(buf, datum[field["name"]], field["type"], named)
    elif t == "array":
        items = datum
        if len(items):
            write_long(buf, len(items))
            for item in items:
                write_datum(buf, item, schema["items"], named)
        write_long(buf, 0)
    elif t == "map":
        entries = list(datum.items())
        if entries:
            write_long(buf, len(entries))
            for k, v in entries:
                write_string(buf, k)
                write_datum(buf, v, schema["values"], named)
        write_long(buf, 0)
    elif t == "enum":
        write_long(buf, schema["symbols"].index(datum))
    else:
        # {"type": "string"}-style wrapping of primitives
        write_datum(buf, datum, t, named)


def _matches(datum: Any, branch: Any, named: _Named) -> bool:
    branch = _resolve(branch, named)
    if branch == "null":
        return datum is None
    if datum is None:
        return False
    if isinstance(branch, dict) and branch.get("type") == "array":
        return isinstance(datum, (list, tuple))
    if isinstance(branch, dict) and branch.get("type") in ("record", "map"):
        return isinstance(datum, dict)
    if branch == "string":
        return isinstance(datum, str)
    if branch in ("int", "long"):
        return isinstance(datum, int)
    if branch in ("float", "double"):
        return isinstance(datum, (int, float))
    if branch == "boolean":
        return isinstance(datum, bool)
    return True


def read_datum(buf: BinaryIO, schema: Any, named: _Named | None = None) -> Any:
    if named is None:
        named = _Named()
        _register_named(schema, named)
    schema = _resolve(schema, named)
    if isinstance(schema, str):
        t = schema
        if t == "null":
            return None
        if t == "boolean":
            return buf.read(1) != b"\x00"
        if t in ("int", "long"):
            return read_long(buf)
        if t == "float":
            return struct.unpack("<f", buf.read(4))[0]
        if t == "double":
            return struct.unpack("<d", buf.read(8))[0]
        if t == "string":
            return read_string(buf)
        if t == "bytes":
            return read_bytes(buf)
        raise ValueError(f"unsupported primitive {t!r}")
    if isinstance(schema, list):
        idx = read_long(buf)
        return read_datum(buf, schema[idx], named)
    t = schema["type"]
    if t == "record":
        return {
            f["name"]: read_datum(buf, f["type"], named) for f in schema["fields"]
        }
    if t == "array":
        out = []
        while True:
            n = read_long(buf)
            if n == 0:
                return out
            if n < 0:  # block with byte size prefix
                read_long(buf)
                n = -n
            for _ in range(n):
                out.append(read_datum(buf, schema["items"], named))
    if t == "map":
        out = {}
        while True:
            n = read_long(buf)
            if n == 0:
                return out
            if n < 0:
                read_long(buf)
                n = -n
            for _ in range(n):
                k = read_string(buf)
                out[k] = read_datum(buf, schema["values"], named)
    if t == "enum":
        return schema["symbols"][read_long(buf)]
    return read_datum(buf, t, named)


# --------------------------------------------------------------------------
# Object Container Files
# --------------------------------------------------------------------------
def write_container(path: str, schema: dict, records, sync: bytes | None = None) -> None:
    """Write ``records`` (any iterable, consumed once) as one block of an
    Object Container File with the null codec."""
    sync = sync or os.urandom(16)
    with open(path, "wb") as f:
        f.write(MAGIC)
        meta_buf = io.BytesIO()
        meta = {
            "avro.schema": json.dumps(schema).encode(),
            "avro.codec": b"null",
        }
        write_long(meta_buf, len(meta))
        for k, v in meta.items():
            write_string(meta_buf, k)
            write_bytes(meta_buf, v)
        write_long(meta_buf, 0)
        f.write(meta_buf.getvalue())
        f.write(sync)
        named = _Named()
        _register_named(schema, named)
        block = io.BytesIO()
        count = 0
        for rec in records:
            write_datum(block, rec, schema, named)
            count += 1
        if count:
            payload = block.getvalue()
            hdr = io.BytesIO()
            write_long(hdr, count)
            write_long(hdr, len(payload))
            f.write(hdr.getvalue())
            f.write(payload)
            f.write(sync)


def read_header_meta(f, path: str) -> tuple[dict, dict, bytes]:
    """Parse the container header; returns (schema, metadata map, sync).
    Leaves ``f`` positioned at the first data block."""
    if f.read(4) != MAGIC:
        raise ValueError(f"{path}: not an Avro container file")
    meta = {}
    while True:
        n = read_long(f)
        if n == 0:
            break
        if n < 0:
            read_long(f)
            n = -n
        for _ in range(n):
            k = read_string(f)
            meta[k] = read_bytes(f)
    schema = json.loads(meta["avro.schema"].decode())
    sync = f.read(16)
    if len(sync) != 16:
        raise ValueError(f"{path}: truncated container header (sync marker)")
    return schema, meta, sync


def _read_header(f, path: str) -> tuple[dict, _Named, bytes]:
    """Parse the container header; returns (schema, named registry, sync)."""
    schema, meta, sync = read_header_meta(f, path)
    codec = meta.get("avro.codec", b"null")
    if codec != b"null":
        raise ValueError(f"{path}: codec {codec!r} is not supported (null only)")
    named = _Named()
    _register_named(schema, named)
    return schema, named, sync


def open_container(path: str):
    """Open a container and parse its header at once; returns ``(open file,
    schema, named registry, sync)``.  The caller closes the file; pair it
    with :func:`iter_records`."""
    f = open(path, "rb")
    try:
        schema, named, sync = _read_header(f, path)
    except BaseException:
        f.close()
        raise
    return f, schema, named, sync


def iter_records(f, schema: dict, named: _Named, sync: bytes, path: str):
    """Yield records one at a time from an :func:`open_container` result
    (a container positioned just past its header)."""
    while True:
        try:
            count = read_long(f)
        except EOFError:
            break
        read_long(f)  # byte size (unused, codec is null)
        for _ in range(count):
            yield read_datum(f, schema, named)
        if f.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch")


def iter_container(path: str):
    """Yield records from an Avro container file one at a time, keeping
    none: host memory stays bounded by the caller's own accumulators."""
    f, schema, named, sync = open_container(path)
    with f:
        yield from iter_records(f, schema, named, sync, path)


def read_container(path: str) -> tuple[dict, list]:
    """(schema, records) of an Object Container File with the null codec."""
    with open(path, "rb") as f:
        schema, named, sync = _read_header(f, path)
        return schema, list(iter_records(f, schema, named, sync, path))
