"""Device-resident GAME scorer: one CUDA graph per bucket.

Counterpart of ``photon_tpu/serving/scorer.py``.  A :class:`GameScorer`
loads a GAME model once into tables on the device (a weight vector per
fixed effect, one ``[capacity, dim]`` gather table per random effect whose
rows past the vocabulary are zero) and serves request micro-batches padded
to a small power-of-two bucket ladder.

One program per bucket is one CUDA graph per bucket.  :meth:`warmup`
captures the whole ladder; after it, a shape off the ladder raises instead
of capturing (``serving.compilations`` counts captures).  Each bucket owns
static buffers: one pinned host staging buffer and one device buffer that
hold every request input as views (the features, the entity rows as int32,
the offset, ``n_valid`` as a device scalar), and one device output holding
the scores and the cold counts.  A batch is one host-to-device copy, one
graph replay, one device-to-host copy into pinned memory and ONE host
wait, on an event (``serving.host_syncs`` == 1 per batch; no other call
on the path synchronizes, as ``torch.cuda.set_sync_debug_mode("error")``
checks on the card).  The captured body
syncs nothing: padding rows are masked by ``arange(bucket) < n_valid`` and
unknown entities (row -1) gather the zero row, whose index is a device
value in the scorer's buffers, never a constant in the graph.

Each scorer captures on its own stream with ``capture_error_mode=
"thread_local"`` (a fleet warms a replacement while other replicas serve)
into one private graph memory pool shared by its buckets; one lock orders
its batches, so the buckets' graphs never replay concurrently.  A graph
holds its tables' addresses, so :meth:`GameScorer.swap_model` publishes a
retrained model by copying its tables into the captured buffers on the
serving stream under that lock: every batch scores against one model's
tables and vocabulary.  A vocabulary that grows within the capacity swaps
in place; a change of capacity, dim or dtype refuses.

On the CPU there is no graph: each bucket's program is the same body on
preallocated buffers, built once and counted the same way.  On ``cuda`` a
capture or replay that fails raises; nothing falls back to eager.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game.data import DenseShard, GameDataset, entity_index_for
from photon_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    pow2_at_least,
    serving_fixed_margins,
    serving_gather_margins,
)

DEFAULT_MAX_BATCH = 256
DEFAULT_MIN_BUCKET = 8


def bucket_ladder(
    buckets: Optional[Tuple[int, ...]], max_batch: int, min_bucket: int
) -> Tuple[int, ...]:
    """The ONE bucket-ladder construction: an explicit ladder is
    deduped/sorted, a default one is the powers of two from
    ``min_bucket`` through ``pow2(max_batch)``."""
    if buckets is None:
        b, ladder = max(1, pow2_at_least(min_bucket)), []
        max_bucket = pow2_at_least(max_batch)
        while b < max_bucket:
            ladder.append(b)
            b *= 2
        ladder.append(max_bucket)
        buckets = tuple(ladder)
    return tuple(sorted(set(int(b) for b in buckets)))


def padded_cost(n: int, buckets: Tuple[int, ...]) -> int:
    """Device rows an ``n``-row request actually COSTS through the bucket
    ladder: the smallest holding bucket, with oversize requests chunked
    into max-bucket slabs first (exactly what ``score_batch`` does).  The
    admission projection charges queue wait in these padded rows."""
    n = int(n)
    if n <= 0:
        return 0
    max_bucket = buckets[-1]
    full, rem = divmod(n, max_bucket)
    cost = full * max_bucket
    if rem:
        cost += next(b for b in buckets if rem <= b)
    return cost


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Fixed request layout of one feature shard: the dense width, or the
    sparse padded-COO nonzero width.  Part of the scorer's identity: every
    bucket's buffers are built at this shape."""

    kind: str  # "dense" | "sparse"
    dim: int
    nnz: int = 0  # padded-COO width (sparse only)

    @property
    def dense(self) -> bool:
        return self.kind == "dense"


@dataclasses.dataclass(frozen=True)
class ScoringRequest:
    """One scoring request: per-shard feature rows, raw per-row entity keys
    for each id column a random coordinate joins on, and an optional
    per-row offset — a :class:`~photon_tpu_torch.game.data.GameDataset`
    minus labels/weights.  All arrays are host-side; the scorer owns
    placement.  ``model`` routes a request in a multi-model fleet; a
    single-model :class:`GameScorer` ignores it."""

    features: Dict[str, object]  # shard -> [n, d] dense | (ids, vals) sparse
    entity_ids: Dict[str, np.ndarray]  # id column -> [n] raw keys
    offset: Optional[np.ndarray] = None  # [n] float32
    model: Optional[object] = None  # None | str | [n] object array

    @property
    def num_rows(self) -> int:
        for leaf in self.features.values():
            arr = leaf[0] if isinstance(leaf, tuple) else leaf
            return int(arr.shape[0])
        for col in self.entity_ids.values():
            return int(len(col))
        return 0


def request_spec_for_model(model: GameModel) -> Dict[str, ShardSpec]:
    """Dense request layout straight from the model's own dimensions."""
    spec: Dict[str, ShardSpec] = {}
    for coord in model.coordinates.values():
        if isinstance(coord, FixedEffectModel):
            spec[coord.shard_name] = ShardSpec(
                "dense", int(len(coord.coefficients.means))
            )
        else:
            spec[coord.shard_name] = ShardSpec("dense", int(coord.dim))
    return spec


def request_spec_for_dataset(
    model: GameModel, data: GameDataset
) -> Dict[str, ShardSpec]:
    """Request layout matching a concrete dataset's shard storage (Avro
    input arrives as padded-COO sparse shards, whose nonzero width fixes
    the buffers' shape)."""
    spec: Dict[str, ShardSpec] = {}
    for coord in model.coordinates.values():
        shard = data.shard(coord.shard_name)
        if isinstance(shard, DenseShard):
            spec[coord.shard_name] = ShardSpec("dense", int(shard.dim))
        else:
            spec[coord.shard_name] = ShardSpec(
                "sparse", int(shard.dim), nnz=int(shard.ids.shape[1])
            )
    return spec


def request_from_dataset(data: GameDataset, model: GameModel) -> ScoringRequest:
    """The whole dataset as one request; only the shards/id-columns the
    model joins ride."""
    features: Dict[str, object] = {}
    entity_ids: Dict[str, np.ndarray] = {}
    for coord in model.coordinates.values():
        shard = data.shard(coord.shard_name)
        features[coord.shard_name] = (
            shard.x if isinstance(shard, DenseShard) else (shard.ids, shard.vals)
        )
        if isinstance(coord, RandomEffectModel):
            entity_ids[coord.entity_column] = data.id_columns[coord.entity_column]
    return ScoringRequest(
        features=features, entity_ids=entity_ids, offset=data.offset
    )


def request_model_rows(model, n: int):
    """One request's model-id routing as per-row values: ``None``/scalar
    ids broadcast over the rows; a per-row array passes through."""
    if model is None or isinstance(model, str):
        return np.full(n, model, dtype=object)
    return np.asarray(model, dtype=object)


def slice_request(req: ScoringRequest, lo: int, hi: int) -> ScoringRequest:
    """Row window ``[lo, hi)`` of a request (oversize-batch chunking)."""
    def cut(leaf):
        if isinstance(leaf, tuple):
            return tuple(a[lo:hi] for a in leaf)
        return leaf[lo:hi]

    model = req.model
    if model is not None and not isinstance(model, str):
        model = np.asarray(model, dtype=object)[lo:hi]
    return ScoringRequest(
        features={k: cut(v) for k, v in req.features.items()},
        entity_ids={k: v[lo:hi] for k, v in req.entity_ids.items()},
        offset=None if req.offset is None else req.offset[lo:hi],
        model=model,
    )


def concat_requests(requests: List[ScoringRequest]) -> ScoringRequest:
    """Coalesce requests into one micro-batch (the batcher's merge step).
    Every request must carry the same shards/id-columns; offsets default to
    zero rows so requests with and without offsets can share a batch."""
    if len(requests) == 1:
        return requests[0]
    first = requests[0]

    def cat(key):
        leaves = [r.features[key] for r in requests]
        if isinstance(leaves[0], tuple):
            return tuple(
                np.concatenate([leaf[i] for leaf in leaves])
                for i in range(len(leaves[0]))
            )
        return np.concatenate(leaves)

    offsets = []
    for r in requests:
        offsets.append(
            np.zeros(r.num_rows, np.float32) if r.offset is None
            else np.asarray(r.offset, np.float32)
        )
    # Model-id routing survives coalescing: all-same scalars stay scalar;
    # any mix widens to a per-row id array.
    model = None
    scalars = set()
    for r in requests:
        m = r.model
        scalars.add(m if (m is None or isinstance(m, str)) else False)
    if scalars != {None}:
        if len(scalars) == 1 and False not in scalars:
            model = next(iter(scalars))
        else:
            model = np.concatenate([
                request_model_rows(r.model, r.num_rows) for r in requests
            ])
    return ScoringRequest(
        features={k: cat(k) for k in first.features},
        entity_ids={
            k: np.concatenate([r.entity_ids[k] for r in requests])
            for k in first.entity_ids
        },
        offset=np.concatenate(offsets),
        model=model,
    )


def request_windows(n_rows: int, sizes, start: int = 0) -> List[np.ndarray]:
    """Consecutive row windows of the given sizes, wrapping modulo the
    dataset — the ONE definition of the request-stream cut, shared by the
    served requests and the host oracle that checks them."""
    out: List[np.ndarray] = []
    pos = start
    for size in sizes:
        out.append(np.arange(pos, pos + int(size)) % n_rows)
        pos = (pos + int(size)) % n_rows
    return out


def build_requests(
    data: GameDataset, model: GameModel, sizes, start: int = 0
) -> List[ScoringRequest]:
    """Cut a dataset into a request stream over :func:`request_windows`."""
    whole = request_from_dataset(data, model)
    out: List[ScoringRequest] = []
    for rows in request_windows(data.num_examples, sizes, start=start):

        def take(leaf):
            if isinstance(leaf, tuple):
                return tuple(a[rows] for a in leaf)
            return leaf[rows]

        out.append(
            ScoringRequest(
                features={k: take(v) for k, v in whole.features.items()},
                entity_ids={k: v[rows] for k, v in whole.entity_ids.items()},
                offset=None if whole.offset is None else whole.offset[rows],
            )
        )
    return out


@dataclasses.dataclass(frozen=True)
class _CoordPlan:
    """Static per-coordinate scoring plan baked into every bucket program.
    It carries the table CAPACITY (the buffers' shape), not the entity
    count: the zero-row index is published state, so a swap that only
    grows the vocabulary within capacity compares equal.  The storage
    ``dtype`` is part of the plan: the decode is in every program."""

    name: str
    kind: str  # "fixed" | "random"
    shard: str
    column: Optional[str] = None  # random: id column joined on
    capacity: int = 0  # random: table rows (vocabulary + zero-row headroom)
    dtype: str = "f32"  # random: gather-table storage tier (f32|bf16|int8)


_ALIGN = 16


def _packed(fields, device, pin: bool = False):
    """One byte buffer holding every ``(name, dtype, shape)`` field as a
    typed view at a 16-byte-aligned offset: ``(buffer, {name: view})``."""
    spans, total = [], 0
    for _, dtype, shape in fields:
        total = -(-total // _ALIGN) * _ALIGN
        spans.append((total, total + math.prod(shape) * dtype.itemsize))
        total = spans[-1][1]
    buf = torch.zeros(max(total, _ALIGN), dtype=torch.uint8, device=device,
                      pin_memory=pin)
    views = {name: buf[lo:hi].view(dtype).view(shape)
             for (name, dtype, shape), (lo, hi) in zip(fields, spans)}
    return buf, views


class _Program:
    """One bucket's program: its static input and output buffers (pinned
    host staging and device twins; one buffer each on the CPU), the body
    that scores the device inputs into the device outputs, and on the card
    its CUDA graph."""

    def __init__(self, scorer: "GameScorer", rows: int, pin: bool):
        dev = scorer.device
        fields = []
        self.feats = {}
        for c in scorer._plan:
            if c.shard in self.feats:
                continue
            s = scorer.request_spec[c.shard]
            if s.dense:
                fields.append((f"x:{c.shard}", torch.float32, (rows, s.dim)))
                self.feats[c.shard] = ((f"x:{c.shard}",), True)
            else:
                fields.append((f"ids:{c.shard}", torch.int32, (rows, s.nnz)))
                fields.append((f"vals:{c.shard}", torch.float32, (rows, s.nnz)))
                self.feats[c.shard] = ((f"ids:{c.shard}", f"vals:{c.shard}"), False)
        for c in scorer._plan:
            if c.kind == "random":
                fields.append((f"idx:{c.name}", torch.int32, (rows,)))
        fields.append(("offset", torch.float32, (rows,)))
        fields.append(("n_valid", torch.int32, ()))
        n_random = sum(c.kind == "random" for c in scorer._plan)
        out_fields = [("scores", torch.float32, (rows,)),
                      ("cold", torch.int32, (n_random,))]
        self.rows = rows
        self.dev_in, self.inputs = _packed(fields, dev)
        self.dev_out, self.outputs = _packed(out_fields, dev)
        if dev.type == "cuda":
            self.host_in, host_inputs = _packed(fields, "cpu", pin=pin)
            self.host_out, host_outputs = _packed(out_fields, "cpu", pin=pin)
        else:
            self.host_in, host_inputs = self.dev_in, self.inputs
            self.host_out, host_outputs = self.dev_out, self.outputs
        # host-sync: numpy views of host (pinned) staging buffers; no device read
        self.staging = {k: v.numpy() for k, v in host_inputs.items()}
        self.results = {k: v.numpy() for k, v in host_outputs.items()}
        self.arange = torch.arange(rows, dtype=torch.int32, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._scorer = scorer

    def body(self) -> None:
        """Score the device inputs into the device outputs.  No host sync:
        padding is masked on the device, the zero row is a device value."""
        s = self._scorer
        v = self.inputs
        valid = self.arange < v["n_valid"]
        total = v["offset"]
        colds = []
        random_pos = 0
        for c, table in zip(s._plan, s._tables):
            names, dense = self.feats[c.shard]
            feats = tuple(v[name] for name in names)
            if c.kind == "fixed":
                total = total + serving_fixed_margins(table, feats, dense)
            else:
                raw = v[f"idx:{c.name}"]
                safe = torch.where(raw >= 0, raw, s._zero_rows[random_pos])
                random_pos += 1
                total = total + serving_gather_margins(table, safe, feats, dense)
                colds.append(((raw < 0) & valid).sum(dtype=torch.int32))
        self.outputs["scores"].copy_(torch.where(valid, total, 0.0))
        if colds:
            self.outputs["cold"].copy_(torch.stack(colds))

    def capture(self, stream, pool) -> None:
        """Capture the body as this bucket's CUDA graph, after one eager run
        on the capture stream (lazy initialization stays out of the graph)."""
        with torch.cuda.stream(stream):
            self.body()
        # host-sync: warmup, before the capture: the eager run lands first
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.body()
        self.graph = graph

    def run(self) -> None:
        """Inputs up, the program, outputs down, on the current stream."""
        if self.host_in is not self.dev_in:
            self.dev_in.copy_(self.host_in, non_blocking=True)
        if self.graph is not None:
            self.graph.replay()
        else:
            self.body()
        if self.host_out is not self.dev_out:
            self.host_out.copy_(self.dev_out, non_blocking=True)


class GameScorer:
    """Device-resident GAME model + one captured program per bucket.

    Built once per served model on ``device`` (``cuda`` unless the caller
    asks for ``cpu``); :meth:`score_batch` is the request hot path (one
    replay and one host sync per micro-batch) and :meth:`score_dataset`
    the batch route over the same tables.  ``buckets`` is the padded-batch
    ladder; ``max_batch`` caps it (a bigger request is chunked).  After
    :meth:`warmup` a shape outside the captured set is an error.
    """

    def __init__(
        self,
        model: GameModel,
        device=None,
        request_spec: Optional[Dict[str, ShardSpec]] = None,
        buckets: Optional[Tuple[int, ...]] = None,
        max_batch: int = DEFAULT_MAX_BATCH,
        min_bucket: int = DEFAULT_MIN_BUCKET,
        telemetry=None,
        table_capacity_factor: int = 1,
        table_dtype: str = "f32",
    ):
        from photon_tpu_torch.game.lowp import check_dtype
        from photon_tpu_torch.telemetry import NULL_SESSION

        self.device = resolve_device(device)
        self.model = model
        self.table_dtype = check_dtype(table_dtype)
        self.telemetry = telemetry or NULL_SESSION
        self.request_spec = request_spec or request_spec_for_model(model)
        self.buckets = bucket_ladder(buckets, max_batch, min_bucket)
        self.max_bucket = self.buckets[-1]
        self.compilations = 0
        self._warm = False
        self._programs: Dict[Tuple[int, str], _Program] = {}
        self._dataset_buckets: set = set()
        # One lock orders batches, dataset scoring and swaps: a batch reads
        # the vocabulary and replays under it, a swap publishes under it.
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
            self._done = torch.cuda.Event()
        else:
            self._stream = self._pool = self._done = None
        capacities = None
        if int(table_capacity_factor) > 1:
            capacities = {
                name: pow2_at_least(
                    int(table_capacity_factor) * (coord.num_entities + 1)
                )
                for name, coord in model.coordinates.items()
                if isinstance(coord, RandomEffectModel)
            }
        plan, tables, zero_rows, vocab = self._build_tables(
            model, capacities=capacities
        )
        # The captured buffers: programs hold these tensors' addresses, so
        # a swap copies into them and never rebinds them.
        self._plan = tuple(plan)
        self._tables = tuple(tables)
        self._zero_rows = zero_rows.to(self.device)
        self._vocab = vocab
        self._record_model_gauges(model)

    def _stream_ctx(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _wait(self) -> None:
        """Block the host until the serving stream's work so far is done:
        an event recorded on the stream, then waited on.  Waiting on an
        event is the one synchronizing call that
        ``torch.cuda.set_sync_debug_mode`` does not flag, so under its
        ``"error"`` mode any other sync on the serving path raises."""
        if self._stream is not None:
            self._done.record(self._stream)
            # host-sync: the batch's one event wait
            self._done.synchronize()

    def _build_tables(self, model: GameModel,
                      capacities: Optional[Dict[str, int]] = None):
        """One model's serving state on the device: the static plan, the
        table tuple (an int8 table is a ``(q, scale)`` pair), the zero-row
        index vector (one int32 per random coordinate, in plan order, on
        the host) and the host vocabularies the ingest join runs against.  Shared by
        ``__init__`` and :meth:`swap_model` so the two can never build
        differently."""
        plan: List[_CoordPlan] = []
        tables: List[object] = []
        zero_rows: List[int] = []
        vocab: Dict[str, np.ndarray] = {}
        for name, coord in model.coordinates.items():
            if isinstance(coord, FixedEffectModel):
                plan.append(_CoordPlan(name, "fixed", coord.shard_name))
                tables.append(coord.serving_weights(self.device))
            elif isinstance(coord, RandomEffectModel):
                capacity = (capacities or {}).get(
                    name, coord.serving_capacity
                )
                plan.append(
                    _CoordPlan(
                        name, "random", coord.shard_name,
                        column=coord.entity_column,
                        capacity=int(capacity),
                        dtype=self.table_dtype,
                    )
                )
                tables.append(
                    coord.serving_table(
                        capacity=capacity, dtype=self.table_dtype,
                        device=self.device,
                    )
                )
                zero_rows.append(coord.num_entities)
                vocab[name] = np.asarray(coord.keys)
            else:
                raise TypeError(
                    f"cannot serve a {type(coord).__name__} coordinate"
                )
            if coord.shard_name not in self.request_spec:
                raise ValueError(
                    f"request spec is missing shard {coord.shard_name!r}"
                )
        return plan, tables, torch.tensor(zero_rows, dtype=torch.int32), vocab

    def _table_leaves(self, tables=None) -> List[torch.Tensor]:
        out = []
        for table in self._tables if tables is None else tables:
            out.extend(table if isinstance(table, tuple) else (table,))
        return out

    def _record_model_gauges(self, model: GameModel) -> None:
        """Publish the SERVED model's residency/entity gauges."""
        for name, coord in model.coordinates.items():
            if isinstance(coord, RandomEffectModel):
                self.telemetry.gauge(
                    "serving.entities", coordinate=name
                ).set(coord.num_entities)
                self.telemetry.gauge(
                    "serving.table_capacity", coordinate=name
                ).set(next(
                    c.capacity for c in self._plan if c.name == name
                ))
        total_bytes = sum(
            leaf.numel() * leaf.element_size() for leaf in self._table_leaves()
        )
        self.telemetry.gauge("serving.model_bytes").set(total_bytes)
        # The precision tier's headline gauge: gather-table bytes under the
        # served storage dtype.
        self.telemetry.gauge(
            "serving.table_bytes", dtype=self.table_dtype
        ).set(total_bytes)

    def swap_model(self, model: GameModel,
                   table_dtype: Optional[str] = None) -> None:
        """Publish a retrained model under live traffic without recapture.
        The new tables are built and checked off to the side (same plan,
        same leaf shapes and dtypes, or refuse); then, under the scorer's
        lock, they are copied into the captured buffers on the serving
        stream with the zero-row vector, and the host vocabulary reference
        is swapped.  A batch takes the same lock to read the vocabulary and
        replay, so every batch scores against ONE model.  A grown
        vocabulary that fits the served capacity swaps in place; growth
        past it, or a changed dim/coordinate set, refuses.  Counted as
        ``serving.swaps``.

        ``table_dtype``, when given, asserts the caller's expected storage
        tier: the decode is part of the captured programs, so a model
        published for a different dtype refuses."""
        if table_dtype is not None and table_dtype != self.table_dtype:
            raise ValueError(
                f"swap_model: model published at table dtype "
                f"{table_dtype!r} but this scorer's warmed programs decode "
                f"{self.table_dtype!r}; the storage tier is baked into the "
                "captured bucket ladder — rebuild the scorer to change it"
            )
        plan, tables, zero_rows, vocab = self._side_build(model)
        if tuple(plan) != self._plan:
            raise ValueError(
                "swap_model: the new model's serving plan does not match "
                f"the captured programs (served {self._plan}, new "
                f"{tuple(plan)}); a changed coordinate layout, table "
                "capacity, or storage dtype requires a new GameScorer"
            )
        # The plan fixes each table's storage form (an int8 table is a
        # pair), so the leaves line up; their shapes must match too.
        new_leaves = self._table_leaves(tables)
        for new, old in zip(new_leaves, self._table_leaves()):
            if new.shape != old.shape or new.dtype != old.dtype:
                raise ValueError(
                    "swap_model: table shape/dtype changed "
                    f"({tuple(old.shape)}/{old.dtype} -> "
                    f"{tuple(new.shape)}/{new.dtype}); a changed table "
                    "layout requires a new GameScorer"
                )
        with self._lock:
            if self._stream is not None:
                # The side build ran on the caller's stream.
                self._stream.wait_stream(torch.cuda.current_stream(self.device))
            if self._stream is not None:
                # Pinned, so the copy is asynchronous and syncs nothing.
                zero_rows = zero_rows.pin_memory()
            with self._stream_ctx():
                for dst, src in zip(self._table_leaves(), new_leaves):
                    dst.copy_(src)
                self._zero_rows.copy_(zero_rows, non_blocking=True)
            # The sources die with this call: the copies finish first.
            self._wait()
            self._vocab = vocab
            self.model = model
        self._record_model_gauges(model)
        self.telemetry.counter("serving.swaps").inc()

    def _side_build(self, model: GameModel):
        """A swap's off-to-the-side build of ``model``'s serving state at
        the served capacities (:meth:`_build_tables`)."""
        capacities = {
            c.name: c.capacity for c in self._plan if c.kind == "random"
        }
        return self._build_tables(model, capacities=capacities)

    def _stage_swap(self) -> None:
        """Make a swap's device allocations once, at warmup, and free them:
        a model of the served one's shapes (as a child's artifact load
        allocates it) and the side build of its tables.  The caching
        allocator keeps those blocks for the caller's stream, so a later
        swap of a model that fits the served capacities reuses them and
        allocates no segment after warmup."""
        if self._stream is None:
            return
        incoming = [torch.empty_like(t) for t in _model_tensors(self.model)]
        staged = self._side_build(self.model)
        del incoming, staged

    # -- bucket policy -------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket holding ``n`` rows (n <= max_bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} rows exceeds max bucket "
                         f"{self.max_bucket}; chunk it (score_batch does)")

    def padded_rows(self, n: int) -> int:
        """Padded device rows ``n`` request rows cost through this ladder
        (the admission projection's cost unit)."""
        return padded_cost(n, self.buckets)

    def warmup(self) -> "GameScorer":
        """Capture every ladder bucket's program.  After this no arrival
        pattern captures: each micro-batch replays one of these graphs,
        and an off-ladder shape raises."""
        with self.telemetry.span("serving.warmup", buckets=len(self.buckets)):
            with self._lock:
                for b in self.buckets:
                    self._program(b)
            self._stage_swap()
        self._warm = True
        return self

    def _program(self, bucket: int, layout: str = "request") -> _Program:
        """The bucket's program: cached per request bucket (captured on the
        card); a ``dataset`` layout runs uncaptured on buffers of its own,
        counted once per bucket size."""
        program = self._programs.get((bucket, layout))
        if program is not None:
            return program
        if self._warm and layout == "request":
            raise RuntimeError(
                f"no captured program for bucket {bucket} after warmup "
                f"(captured: {sorted(b for b, l in self._programs if l == 'request')}); "
                "widen `buckets` or chunk the batch — serving must never "
                "recompile"
            )
        program = _Program(self, bucket, pin=layout == "request")
        new = True
        if layout == "request":
            if self._stream is not None:
                program.capture(self._stream, self._pool)
            self._programs[(bucket, layout)] = program
        else:
            new = bucket not in self._dataset_buckets
            self._dataset_buckets.add(bucket)
        if new:
            self.compilations += 1
            self.telemetry.counter("serving.compilations").inc()
        return program

    # -- request staging (host side, the ingest edge) -------------------------
    def _stage(self, request: ScoringRequest, program: _Program, n: int,
               vocab: Dict[str, np.ndarray]) -> None:
        """Validate one request and write it, padded, into the program's
        staging buffers: padding rows carry zero features, entity row -1
        (masked from the cold counts by ``n_valid``) and a zero offset.
        Every write is a copy, so no caller array is ever aliased."""
        st = program.staging
        staged = set()
        for c in self._plan:
            if c.shard in staged:
                continue
            staged.add(c.shard)
            s = self.request_spec[c.shard]
            leaf = request.features.get(c.shard)
            if leaf is None:
                raise ValueError(f"request is missing shard {c.shard!r}")
            if s.dense:
                x = np.asarray(leaf, np.float32)
                if x.shape != (n, s.dim):
                    raise ValueError(
                        f"shard {c.shard!r}: got {x.shape}, want {(n, s.dim)}"
                    )
                _fill(st[f"x:{c.shard}"], x, n)
            else:
                ids, vals = leaf
                ids = np.asarray(ids, np.int32)
                vals = np.asarray(vals, np.float32)
                if ids.shape != (n, s.nnz) or vals.shape != (n, s.nnz):
                    raise ValueError(
                        f"shard {c.shard!r}: got {ids.shape}/{vals.shape}, "
                        f"want {(n, s.nnz)}"
                    )
                _fill(st[f"ids:{c.shard}"], ids, n)
                _fill(st[f"vals:{c.shard}"], vals, n)
        for c in self._plan:
            if c.kind != "random":
                continue
            keys = request.entity_ids.get(c.column)
            if keys is None:
                raise ValueError(
                    f"request is missing id column {c.column!r}"
                )
            # The key->row join against the sorted vocabulary; unknown keys
            # become -1 -> the zero row.
            _fill(st[f"idx:{c.name}"], entity_index_for(keys, vocab[c.name]),
                  n, pad=-1)
        if request.offset is None:
            st["offset"][:] = 0.0
        else:
            _fill(st["offset"], np.asarray(request.offset, np.float32), n)
        st["n_valid"][...] = n

    # -- scoring -------------------------------------------------------------
    def score_batch(self, request: ScoringRequest) -> np.ndarray:
        """Score one request micro-batch; returns ``[n]`` float32 raw
        scores (offset + every coordinate's margin; unknown entities get
        the fixed-effect-only fallback).  One replay and ONE host sync;
        requests wider than the bucket ladder are chunked."""
        n = request.num_rows
        if n == 0:
            return np.zeros(0, np.float32)
        if n > self.max_bucket:
            return np.concatenate([
                self.score_batch(slice_request(request, lo,
                                               min(lo + self.max_bucket, n)))
                for lo in range(0, n, self.max_bucket)
            ])
        return self._score_padded(request, self.bucket_for(n), n)

    def score_dataset(self, data: GameDataset) -> np.ndarray:
        """Batch scoring through the SAME tables and body: the dataset is
        one request padded to the next power of two, run uncaptured on
        buffers of its own (allowed after warmup, counted once per
        size)."""
        req = request_from_dataset(data, self.model)
        n = req.num_rows
        if n == 0:
            return np.zeros(0, np.float32)
        return self._score_padded(req, pow2_at_least(n), n, layout="dataset")

    def _score_padded(self, request: ScoringRequest, bucket: int,
                      n: int, layout: str = "request") -> np.ndarray:
        t0 = time.monotonic()
        with self._lock:
            program = self._program(bucket, layout=layout)
            self._stage(request, program, n, self._vocab)
            with self._stream_ctx():
                program.run()
            # The one per-batch host sync: scores and cold counts are in
            # pinned memory after it.  On the host there is nothing to
            # wait for, and the count is of the one read of the outputs,
            # as the reference counts its one fetch on every backend.
            self._wait()
            t = self.telemetry
            t.counter("serving.host_syncs").inc()
            scores = program.results["scores"][:n].copy()
            cold = program.results["cold"].copy()
        t.counter("serving.batches", bucket=bucket).inc()
        t.counter("serving.rows").inc(n)
        t.histogram("serving.batch_rows").observe(n)
        t.histogram("serving.bucket_occupancy", bucket=bucket).observe(
            n / bucket
        )
        t.histogram("serving.padded_fraction").observe((bucket - n) / bucket)
        t.histogram("serving.score_seconds").observe(time.monotonic() - t0)
        cold_plan = [c for c in self._plan if c.kind == "random"]
        for c, count in zip(cold_plan, cold):
            if count:
                t.counter("serving.cold_entities", coordinate=c.name).inc(
                    int(count)
                )
        return scores


def _model_tensors(model: GameModel) -> List[torch.Tensor]:
    """The tensors a served model holds and a model artifact carries: each
    fixed coordinate's means and each random coordinate's table."""
    out = []
    for coord in model.coordinates.values():
        if isinstance(coord, FixedEffectModel):
            out.append(coord.coefficients.means)
        elif isinstance(coord, RandomEffectModel):
            out.append(coord.table)
    return out


def _fill(dst: np.ndarray, src: np.ndarray, n: int, pad=0) -> None:
    """Copy ``src`` into the first ``n`` rows of a staging view and ``pad``
    into the rest."""
    dst[:n] = src
    dst[n:] = pad
