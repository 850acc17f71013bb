"""Disk-backed tile store: the third tier of out-of-core GAME training.

Counterpart of ``photon_tpu/game/tile_store.py``, in the same file format,
so a store written by either package reads back bit for bit in the other.
The streamed descent (``game/tiles.py``) bounds device memory; this module
bounds host memory one tier down: per-chunk **part files** hold a chunk's
feature block and its ``[C, rows_k]`` score tile with its Neumaier
partials, an LRU host cache (``tiles.HostTileCache``) holds the host's
working set to ``--max-host-mb``, and the chunk pipeline becomes disk ->
host -> device.

Part files (one container a chunk a role: ``feat-NNNNNN.pt`` is the
feature block, written once at spill time; ``tile-<path>-NNNNNN.pt`` the
score tile and partials, written back once a sweep):

    8 bytes   magic ``PHTILE01``
    8 bytes   header length (uint64 little-endian)
    header    JSON: per array its name, dtype, shape, encoding, codec,
              offset, byte count and sha256, and the caller's meta
    payload   the encoded arrays, concatenated

Durability: a write builds a temp file in the store directory, fsyncs it
and publishes with one atomic rename (``fault/atomic.atomic_write_bytes``),
so a kill leaves the previous part file or the new one, never a mix.  A
read checks every array's sha256 and refuses corruption with
:class:`CorruptTileError`, which is not an ``OSError``: the retry layer
must not spend its budget re-reading bit rot.  Every read and write goes
through ``fault/retry.retry_call`` at the sites ``tile:read`` and
``tile:write``.

Lossless encodings: ``raw``; with ``PHOTON_TILE_COMPRESS=1`` multi-byte
arrays are delta-coded at their item width (wraparound unsigned
subtraction, exactly invertible), byte-shuffled and zlib-deflated
(``dsz``), one-byte arrays only deflated (``z``), and an encoding that does
not shrink falls back to ``raw`` per array.

Lossy codecs (``tile_dtype``): ``bf16`` (round to nearest even) and
``int8`` (per-row absmax, an f32 scale row beside the int8 grid, at the
re-encode fixed point of ``lowp.quantize_int8_canonical``).  Their digests
cover the encoded payload, so a flipped bit in a scale row is refused
before a decode could rescale a row; both re-encode their own decode to the
same bytes, so write-back never drifts; an array a codec cannot hold
(non-f32, NaN or infinity, an int8 quantization off its fixed point) is
stored exact under the ``f32`` codec.

bf16 feature values: the port holds them on the host as ``uint16`` bit
patterns (``game/lowp.py``).  The store writes every ``uint16`` array
under the reference's ``name:bfloat16`` token and reads that token back as
``uint16`` bits: the same bytes, the same digests, and a dtype the JAX
package resolves to its own bfloat16.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from photon_tpu_torch.telemetry import NULL_SESSION

MAGIC = b"PHTILE01"
COMPRESS_VAR = "PHOTON_TILE_COMPRESS"

# Store roles: one immutable feature block and one mutable score tile a
# chunk, in part files of their own (a tile write-back never rewrites the
# larger feature payload).
FEATURES = "feat"
TILES = "tile"

# The dtype token of bf16 arrays, the reference's (``name:`` plus the
# ml_dtypes name), and their host form here.
BF16_TOKEN = "name:bfloat16"
BF16_HOST = np.dtype(np.uint16)


class CorruptTileError(RuntimeError):
    """A part file failed its digest check or is structurally torn.  Not an
    ``OSError``: a retry cannot heal bit rot."""


def _dtype_token(dtype: np.dtype) -> str:
    """Serializable dtype identity: ``dtype.str``, except the port's host
    bf16 bits (``uint16``), written by the reference's name token."""
    dtype = np.dtype(dtype)
    if dtype == BF16_HOST:
        return BF16_TOKEN
    return dtype.str


def _resolve_dtype(token: str) -> np.dtype:
    if token == BF16_TOKEN:
        return BF16_HOST
    if token.startswith("name:"):
        return np.dtype(token[5:])
    return np.dtype(token)


def compress_enabled(override: Optional[bool] = None) -> bool:
    """The ``PHOTON_TILE_COMPRESS`` gate (default off; an explicit
    ``override`` wins)."""
    if override is not None:
        return bool(override)
    return os.environ.get(COMPRESS_VAR, "").strip().lower() in (
        "1", "on", "true", "shuffle", "delta")


# ---------------------------------------------------------------------------
# Array codecs: raw | z | dsz (lossless), and the lossy bf16 / int8 payloads
# ---------------------------------------------------------------------------

LOSSY_CODECS = ("bf16", "int8")


def _lossy_payload(arr: np.ndarray, codec: str) -> Optional[bytes]:
    """One array's encoded payload under a lossy codec, or None when it
    falls back to lossless storage (non-f32 or empty arrays, NaN or
    infinity, an int8 quantization that did not reach its fixed point)."""
    if arr.dtype != np.float32 or arr.ndim == 0 or arr.size == 0:
        return None
    if not np.isfinite(arr).all():
        return None
    if codec == "bf16":
        from photon_tpu_torch.game.lowp import encode_bf16

        return np.ascontiguousarray(encode_bf16(arr)).tobytes()
    if codec == "int8":
        from photon_tpu_torch.game.lowp import quantize_int8_canonical

        q, scale, converged = quantize_int8_canonical(arr)
        if not converged:
            return None
        # The scale rows first: the split point follows from the header's
        # shape (float32 scales of shape[:-1], then the int8 grid).
        return np.ascontiguousarray(scale).tobytes() + q.tobytes()
    raise ValueError(f"unknown lossy codec {codec!r}")


def _lossy_decode(raw: bytes, codec: str, dtype: np.dtype, shape: tuple) -> np.ndarray:
    """The float32 decode of a lossy payload; a size that disagrees with
    the shape is corruption."""
    if np.dtype(dtype) != np.float32:
        raise CorruptTileError(f"lossy codec {codec!r} on non-f32 dtype {dtype!r}")
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if codec == "bf16":
        from photon_tpu_torch.game.lowp import decode_bf16

        if len(raw) != 2 * n:
            raise CorruptTileError(f"bf16 payload is {len(raw)} bytes, want {2 * n}")
        # (a writable copy: torch refuses to share a read-only buffer)
        return decode_bf16(np.frombuffer(raw, np.uint16).reshape(shape).copy())
    if codec == "int8":
        from photon_tpu_torch.game.lowp import dequantize_int8_rows

        scale_shape = tuple(shape[:-1])
        scale_n = int(np.prod(scale_shape, dtype=np.int64)) if scale_shape else 1
        if len(raw) != 4 * scale_n + n:
            raise CorruptTileError(
                f"int8 payload is {len(raw)} bytes, want {4 * scale_n + n}")
        scale = np.frombuffer(raw[: 4 * scale_n], np.float32).reshape(scale_shape)
        q = np.frombuffer(raw[4 * scale_n:], np.int8).reshape(shape)
        return dequantize_int8_rows(q, scale)
    raise CorruptTileError(f"unknown array codec {codec!r}")


def codec_roundtrip(arr: np.ndarray, codec: Optional[str]) -> np.ndarray:
    """``arr`` as it will decode from disk under ``codec``: write-back
    rounds a tile through it before deriving partials, digests and the
    cached copy, so memory and disk agree bit for bit."""
    arr = np.ascontiguousarray(arr)
    if codec in (None, "f32"):
        return arr
    payload = _lossy_payload(arr, codec)
    if payload is None:
        return arr
    return _lossy_decode(payload, codec, arr.dtype, arr.shape)


def _encode(arr: np.ndarray, compress: bool) -> Tuple[bytes, str]:
    raw = arr.tobytes()
    if not compress or arr.size == 0:
        return raw, "raw"
    itemsize = arr.dtype.itemsize
    if itemsize in (2, 4, 8):
        flat = np.frombuffer(raw, dtype=np.dtype(f"<u{itemsize}"))
        delta = np.empty_like(flat)
        delta[0] = flat[0]
        np.subtract(flat[1:], flat[:-1], out=delta[1:])
        shuffled = delta.view(np.uint8).reshape(-1, itemsize).T.copy().tobytes()
        encoding = "dsz"
    else:
        shuffled = raw
        encoding = "z"
    packed = zlib.compress(shuffled, 1)
    if len(packed) >= len(raw):
        return raw, "raw"
    return packed, encoding


def _decode(buf: bytes, dtype: np.dtype, shape: tuple, encoding: str) -> np.ndarray:
    """A writable array (cached tiles are changed in place)."""
    if encoding == "raw":
        return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    raw = zlib.decompress(buf)
    if encoding == "z":
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    if encoding != "dsz":
        raise CorruptTileError(f"unknown array encoding {encoding!r}")
    itemsize = np.dtype(dtype).itemsize
    width = np.dtype(f"<u{itemsize}")
    shuffled = np.frombuffer(raw, dtype=np.uint8)
    delta = np.ascontiguousarray(shuffled.reshape(itemsize, -1).T).view(width)
    flat = np.cumsum(delta, dtype=width)  # the wraparound inverse of the delta
    return flat.view(np.uint8).view(dtype).reshape(shape).copy()


# ---------------------------------------------------------------------------
# The part-file container
# ---------------------------------------------------------------------------


def _pack(arrays: Dict[str, np.ndarray], meta: dict, compress: bool,
          digests: Optional[Dict[str, str]] = None,
          codecs: Optional[Dict[str, str]] = None) -> bytes:
    """``digests`` passes sha256 hexes of arrays' raw bytes a caller has
    already computed; ``codecs`` maps array names to a lossy codec, whose
    digests cover the encoded payload (and ignore ``digests``)."""
    entries = []
    payloads = []
    offset = 0
    digests = digests or {}
    codecs = codecs or {}
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        codec = codecs.get(name) or "f32"
        payload = _lossy_payload(arr, codec) if codec != "f32" else None
        if payload is None:
            codec = "f32"
            buf, encoding = _encode(arr, compress)
            sha = digests.get(name) or hashlib.sha256(arr.tobytes()).hexdigest()
        else:
            sha = hashlib.sha256(payload).hexdigest()
            buf, encoding = payload, "raw"
            if compress:
                # A lossy payload (scales and grid) has no single item
                # width: zlib only, or nothing.
                packed = zlib.compress(payload, 1)
                if len(packed) < len(payload):
                    buf, encoding = packed, "z"
        entries.append({
            "name": name,
            "dtype": _dtype_token(arr.dtype),
            "shape": list(arr.shape),
            "encoding": encoding,
            "codec": codec,
            "offset": offset,
            "nbytes": len(buf),
            "sha256": sha,
        })
        payloads.append(buf)
        offset += len(buf)
    header = json.dumps({"version": 1, "arrays": entries, "meta": meta or {}}).encode()
    return b"".join([MAGIC, struct.pack("<Q", len(header)), header, *payloads])


def _read_header(f) -> dict:
    magic = f.read(len(MAGIC))
    if magic != MAGIC:
        raise CorruptTileError(f"bad part-file magic {magic!r} (torn or foreign file)")
    raw_len = f.read(8)
    if len(raw_len) != 8:
        raise CorruptTileError("part file truncated inside the header length field")
    (hlen,) = struct.unpack("<Q", raw_len)
    try:
        return json.loads(f.read(hlen).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CorruptTileError(f"unreadable part-file header: {e}") from None


def _unpack(path: str, verify: bool = True,
            names=None) -> Tuple[Dict[str, np.ndarray], dict]:
    """Decode a part file, or only the arrays in ``names`` (the header's
    offsets let a selective read skip the other payloads)."""
    with open(path, "rb") as f:
        header = _read_header(f)
        base = f.tell()
        arrays: Dict[str, np.ndarray] = {}
        for entry in header["arrays"]:
            if names is not None and entry["name"] not in names:
                continue
            f.seek(base + entry["offset"])
            buf = f.read(entry["nbytes"])
            if len(buf) != entry["nbytes"]:
                raise CorruptTileError(f"{path}: truncated payload for {entry['name']!r}")
            codec = entry.get("codec", "f32")
            if codec != "f32":
                # Check the digest of the encoded payload before decoding:
                # a corrupt scale row is refused before it rescales a row.
                try:
                    if entry["encoding"] not in ("raw", "z"):
                        raise ValueError(
                            f"encoding {entry['encoding']!r} invalid for codec {codec!r}")
                    raw = zlib.decompress(buf) if entry["encoding"] == "z" else buf
                except (zlib.error, ValueError) as e:
                    raise CorruptTileError(
                        f"{path}: undecodable payload for {entry['name']!r} ({e}); "
                        "on-disk tile corrupted") from None
                if verify and hashlib.sha256(raw).hexdigest() != entry["sha256"]:
                    raise CorruptTileError(
                        f"{path}: content digest mismatch in {entry['name']!r} "
                        f"({codec} payload, e.g. a corrupt scale row); refusing the read")
                arrays[entry["name"]] = _lossy_decode(
                    raw, codec, _resolve_dtype(entry["dtype"]), tuple(entry["shape"]))
                continue
            try:
                arr = _decode(buf, _resolve_dtype(entry["dtype"]),
                              tuple(entry["shape"]), entry["encoding"])
            except (zlib.error, ValueError, TypeError) as e:
                # A flipped bit in a compressed payload, or a header and a
                # payload that disagree: corruption, not retried.
                raise CorruptTileError(
                    f"{path}: undecodable payload for {entry['name']!r} ({e}); "
                    "on-disk tile corrupted") from None
            if verify and hashlib.sha256(arr.tobytes()).hexdigest() != entry["sha256"]:
                raise CorruptTileError(
                    f"{path}: content digest mismatch in {entry['name']!r} (on-disk "
                    "tile corrupted); refusing the read")
            arrays[entry["name"]] = arr
    return arrays, header.get("meta", {})


class TileStore:
    """The disk tier: per-chunk part files under one directory, published
    atomically, read digest-checked, every IO retried, and
    ``tiles.disk_bytes`` accounted.

    Reads and writes of distinct ``(kind, chunk)`` part files may run at
    once (prefetch workers against the write-back on the descent thread);
    the byte accounting takes a lock.  Two writers of the same part file
    are last-publish-wins: the descent writes a tile from one place at a
    time."""

    def __init__(self, root: str, telemetry=None, compress: Optional[bool] = None,
                 tile_dtype: Optional[str] = None):
        from photon_tpu_torch.game.lowp import TILE_DTYPES, check_dtype

        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.telemetry = telemetry or NULL_SESSION
        self.compress = compress_enabled(compress)
        # The store's codec for lossy-eligible arrays (feature values, score
        # tiles); callers choose which arrays are eligible per write.
        self.tile_dtype = check_dtype(tile_dtype, TILE_DTYPES, "tile dtype")
        self._lock = threading.Lock()
        self._file_bytes: Dict[str, int] = {}
        for name in os.listdir(self.root):
            if name.endswith(".pt"):
                try:
                    self._file_bytes[name] = os.path.getsize(os.path.join(self.root, name))
                except OSError:
                    continue
        self._publish_bytes_gauge()

    # -- paths and accounting -------------------------------------------------
    def path(self, kind: str, k: int) -> str:
        return os.path.join(self.root, f"{kind}-{int(k):06d}.pt")

    def has(self, kind: str, k: int) -> bool:
        return os.path.isfile(self.path(kind, k))

    @property
    def disk_bytes(self) -> int:
        with self._lock:
            return sum(self._file_bytes.values())

    def _note_file(self, name: str, nbytes: Optional[int]) -> None:
        with self._lock:
            if nbytes is None:
                self._file_bytes.pop(name, None)
            else:
                self._file_bytes[name] = nbytes
        self._publish_bytes_gauge()

    def _publish_bytes_gauge(self) -> None:
        self.telemetry.gauge("tiles.disk_bytes").set(self.disk_bytes)

    def lossy_codecs(self, names) -> Dict[str, str]:
        """The ``codecs`` dict that applies the store's tier to ``names``
        (empty at f32, whose writes are unchanged)."""
        if self.tile_dtype == "f32":
            return {}
        return {str(name): self.tile_dtype for name in names}

    # -- guarded IO -----------------------------------------------------------
    def write(self, kind: str, k: int, arrays: Dict[str, np.ndarray],
              meta: Optional[dict] = None, digests: Optional[Dict[str, str]] = None,
              codecs: Optional[Dict[str, str]] = None) -> None:
        """Publish one part file atomically (temp, fsync, rename, directory
        fsync); the attempt retries as a unit at ``tile:write``."""
        from photon_tpu_torch.fault.atomic import atomic_write_bytes
        from photon_tpu_torch.fault.injection import fault_point
        from photon_tpu_torch.fault.retry import retry_call

        final = self.path(kind, k)
        blob = _pack(arrays, meta, self.compress, digests=digests, codecs=codecs)

        def attempt():
            fault_point("tile:write", kind=kind, chunk=k)
            atomic_write_bytes(final, blob)

        retry_call(attempt, site="tile:write", telemetry=self.telemetry)
        self.telemetry.counter("tiles.store_writes", kind=kind).inc()
        self.telemetry.counter("tiles.store_write_bytes", kind=kind).inc(len(blob))
        self._note_file(os.path.basename(final), len(blob))

    def read(self, kind: str, k: int, verify: bool = True,
             names=None) -> Tuple[Dict[str, np.ndarray], dict]:
        """One part file's arrays (only ``names``, when given) and meta,
        digest-checked.  Transient failures retry at ``tile:read``;
        corruption raises :class:`CorruptTileError` at once."""
        from photon_tpu_torch.fault.injection import fault_point
        from photon_tpu_torch.fault.retry import retry_call

        path = self.path(kind, k)

        def attempt():
            fault_point("tile:read", kind=kind, chunk=k)
            return _unpack(path, verify=verify, names=names)

        arrays, meta = retry_call(attempt, site="tile:read", telemetry=self.telemetry)
        self.telemetry.counter("tiles.store_reads", kind=kind).inc()
        return arrays, meta

    def read_meta(self, kind: str, k: int) -> dict:
        """The header's meta alone (no payload decoded)."""
        from photon_tpu_torch.fault.injection import fault_point
        from photon_tpu_torch.fault.retry import retry_call

        path = self.path(kind, k)

        def attempt():
            fault_point("tile:read", kind=kind, chunk=k)
            with open(path, "rb") as f:
                return _read_header(f).get("meta", {})

        return retry_call(attempt, site="tile:read", telemetry=self.telemetry)

    def delete(self, kind: str, k: int) -> None:
        path = self.path(kind, k)
        try:
            os.remove(path)
        except FileNotFoundError:
            pass
        self._note_file(os.path.basename(path), None)

    def reset_tiles(self, num_chunks: int, kind: str = TILES) -> None:
        """Drop every part file of ``kind`` (a fresh fit must not read a
        previous run's tiles as its zero state)."""
        for k in range(num_chunks):
            self.delete(kind, k)

    def reset_all(self) -> None:
        """Drop every part file and the dataset identity (a foreign or stale
        spill directory: another plan may have used other chunk ids)."""
        for name in list(os.listdir(self.root)):
            if name.endswith(".pt"):
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass
                self._note_file(name, None)
        try:
            os.remove(self.dataset_meta_path())
        except OSError:
            pass

    # -- dataset identity -----------------------------------------------------
    _DATASET_META = "dataset.json"

    def dataset_meta_path(self) -> str:
        return os.path.join(self.root, self._DATASET_META)

    def read_dataset_meta(self) -> Optional[dict]:
        """The spilled dataset's identity, or None (missing or unreadable
        means "not this dataset": a fresh spill)."""
        try:
            with open(self.dataset_meta_path()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def write_dataset_meta(self, meta: dict) -> None:
        from photon_tpu_torch.fault.atomic import atomic_write_json
        from photon_tpu_torch.fault.retry import retry_call

        retry_call(lambda: atomic_write_json(self.dataset_meta_path(), meta),
                   site="tile:write", telemetry=self.telemetry)
