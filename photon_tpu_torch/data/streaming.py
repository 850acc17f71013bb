"""Large inputs: chunked batches, sharded files, streamed training.

Counterpart of ``photon_tpu/data/streaming.py``.  By dataset size:

1. **Fits on the device** — one :class:`~photon_tpu_torch.data.batch.
   SparseBatch` (every other path of the package).
2. **Fits on the device, its intermediates do not** —
   :class:`ChunkedBatch`: the batch stacked as ``[chunks, rows, ...]``;
   :class:`ChunkedGlmObjective` folds the chunks in a loop, bounding the
   per-evaluation intermediates at one chunk, and exposes the objective's
   surface so the resident optimizers run on it unchanged.
3. **Host memory only** — :class:`LibsvmFileSource` +
   :func:`stream_chunks` + :func:`streaming_lbfgs`: part files parsed on
   a bounded host-IO pool (``utils/io_pool.map_ordered``, delivery in file
   order), each chunk copied to the card from pinned memory on a side CUDA
   stream one chunk ahead of the compute, and a host-loop L-BFGS whose every
   objective evaluation is one streamed pass over the files.

Multi-process: :func:`shard_files_for_process` gives each rank its files
(the rank and world size of an initialized ``torch.distributed``, else 0 and
1) and :class:`StreamingObjective` sums across ranks through its
``all_reduce``.  :func:`make_global_batch` (a mesh-sharded global batch)
waits in ROADMAP.md queue 1, item 10.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Iterable, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.core.optimizers.base import (
    ConvergenceReason,
    OptimizerConfig,
    OptimizerResult,
)
from photon_tpu_torch.data.batch import SparseBatch
from photon_tpu_torch.fault.injection import fault_point

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Tier 2: a device-resident chunked batch
# ---------------------------------------------------------------------------


class ChunkedBatch(NamedTuple):
    """A sparse batch stacked into fixed-size chunks: ids/vals
    ``[C, R, k]``, label/offset/weight ``[C, R]``; pad rows carry zero
    weight."""

    ids: Tensor
    vals: Tensor
    label: Tensor
    offset: Tensor
    weight: Tensor

    @property
    def num_chunks(self) -> int:
        return int(self.ids.shape[0])

    @property
    def num_examples(self) -> int:
        # Physical rows, pads included; objectives ignore zero-weight rows.
        return int(self.ids.shape[0] * self.ids.shape[1])

    def chunk(self, c: int) -> SparseBatch:
        return SparseBatch(self.ids[c], self.vals[c], self.label[c],
                           self.offset[c], self.weight[c])


def chunk_batch(batch: SparseBatch, rows_per_chunk: int) -> ChunkedBatch:
    """Stack a flat SparseBatch into ``[C, rows_per_chunk, ...]`` chunks."""
    n, k = batch.ids.shape
    c = max(1, -(-n // rows_per_chunk))
    pad = c * rows_per_chunk - n

    def pad_rows(a: Tensor) -> Tensor:
        widths = [0, 0] * (a.ndim - 1) + [0, pad]
        return torch.nn.functional.pad(a, widths)

    return ChunkedBatch(
        ids=pad_rows(batch.ids).reshape(c, rows_per_chunk, k),
        vals=pad_rows(batch.vals).reshape(c, rows_per_chunk, k),
        label=pad_rows(batch.label).reshape(c, rows_per_chunk),
        offset=pad_rows(batch.offset).reshape(c, rows_per_chunk),
        weight=pad_rows(batch.weight).reshape(c, rows_per_chunk),
    )


def _data_only(objective):
    """The objective without regularization: the per-chunk data terms."""
    return dataclasses.replace(objective, l2_weight=0.0, l1_weight=0.0)


@dataclasses.dataclass(frozen=True)
class ChunkedGlmObjective:
    """A GlmObjective over a :class:`ChunkedBatch`: each method folds the
    objective's data term chunk by chunk (the row-major ``autodiff`` route,
    as the reference's folded autodiff) and adds the L2 term once."""

    objective: object  # GlmObjective

    @property
    def l1_weight(self) -> float:
        return self.objective.l1_weight

    @property
    def l2_weight(self) -> float:
        return self.objective.l2_weight

    def _fold(self, fn, chunks: ChunkedBatch):
        acc = None
        for c in range(chunks.num_chunks):
            out = fn(chunks.chunk(c))
            acc = out if acc is None else (
                tuple(a + o for a, o in zip(acc, out)) if isinstance(out, tuple)
                else acc + out)
        return acc

    def value(self, w: Tensor, chunks: ChunkedBatch) -> Tensor:
        data = _data_only(self.objective)
        v = self._fold(lambda c: data.data_value(w, c), chunks)
        if self.l2_weight:
            v = v + 0.5 * self.l2_weight * torch.dot(w, w)
        return v

    def value_and_grad(self, w: Tensor, chunks: ChunkedBatch) -> tuple[Tensor, Tensor]:
        data = _data_only(self.objective)
        v, g = self._fold(
            lambda c: data._fast_data_value_and_grad(w, c, "autodiff"), chunks)
        if self.l2_weight:
            v = v + 0.5 * self.l2_weight * torch.dot(w, w)
            g = g + self.l2_weight * w
        return v, g

    def grad(self, w: Tensor, chunks: ChunkedBatch) -> Tensor:
        return self.value_and_grad(w, chunks)[1]

    def hessian_vector(self, w: Tensor, v: Tensor, chunks: ChunkedBatch) -> Tensor:
        data = _data_only(self.objective)
        hv = self._fold(lambda c: data.hessian_vector(w, v, c), chunks)
        return hv + self.l2_weight * v

    def hessian_diagonal(self, w: Tensor, chunks: ChunkedBatch) -> Tensor:
        data = _data_only(self.objective)
        return self._fold(lambda c: data.hessian_diagonal(w, c), chunks) + self.l2_weight

    def hessian_matrix(self, w: Tensor, chunks: ChunkedBatch) -> Tensor:
        data = _data_only(self.objective)
        h = self._fold(lambda c: data.hessian_matrix(w, c), chunks)
        return h + self.l2_weight * torch.eye(w.shape[0], dtype=w.dtype, device=w.device)


# ---------------------------------------------------------------------------
# Tier 3: host streaming
# ---------------------------------------------------------------------------


def shard_files_for_process(
    files: Sequence[str],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[str]:
    """This rank's slice of the file list (round robin over the sorted
    list); the rank and world size default to an initialized
    ``torch.distributed``'s, else 0 and 1."""
    dist = torch.distributed
    live = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if live else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if live else 1) if process_count is None else process_count
    return [f for i, f in enumerate(sorted(files)) if i % pc == pi]


def map_batch_tensors(batch, fn):
    """``batch`` with ``fn`` applied to every tensor it holds, its layouts'
    included (tuples, lists, named tuples and dataclasses are rebuilt; host
    arrays and scalars pass through)."""
    if isinstance(batch, Tensor):
        return fn(batch)
    if isinstance(batch, tuple):
        items = [map_batch_tensors(v, fn) for v in batch]
        return type(batch)(*items) if hasattr(batch, "_fields") else tuple(items)
    if isinstance(batch, list):
        return [map_batch_tensors(v, fn) for v in batch]
    if dataclasses.is_dataclass(batch) and not isinstance(batch, type):
        return dataclasses.replace(batch, **{
            f.name: map_batch_tensors(getattr(batch, f.name), fn)
            for f in dataclasses.fields(batch) if f.init
        })
    return batch


def batch_tensors(batch) -> list:
    """Every tensor of ``batch`` (see :func:`map_batch_tensors`)."""
    out: list = []
    map_batch_tensors(batch, lambda t: out.append(t) or t)
    return out


@dataclasses.dataclass
class StreamStats:
    """One streamed pass, as the consumer saw it: chunks and rows delivered,
    host seconds blocked waiting for a parsed chunk (``parse_wait_s``), the
    bytes copied to the card, and on the card the copies' device time and
    the compute stream's wait for them (CUDA events, resolved by
    :meth:`resolve` once the pass's work is done), and the process's
    resident set sampled at each chunk (``rss_peak_bytes``)."""

    chunks: int = 0
    rows: int = 0
    parse_wait_s: float = 0.0
    copy_bytes: int = 0
    copy_ms: float = 0.0
    copy_stall_ms: float = 0.0
    rss_start_bytes: int = 0
    rss_peak_bytes: int = 0
    events: list = dataclasses.field(default_factory=list, repr=False)

    def resolve(self) -> "StreamStats":
        """Turn the recorded events into ``copy_ms`` and ``copy_stall_ms``
        (waits for the last one)."""
        if self.events:
            self.events[-1][2].synchronize()
            for start, done, need in self.events:
                self.copy_ms += start.elapsed_time(done)
                # How long the compute stream had to wait for this copy.
                self.copy_stall_ms += max(0.0, need.elapsed_time(done))
            self.events = []
        return self


def rss_bytes() -> int:
    """The process's current resident set (``/proc/self/statm``), 0 where it
    cannot be read."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    """The one copy stream of ``device`` that every streamed pass shares:
    the caching allocator keeps freed blocks per stream, so a new stream a
    pass would allocate every pass's chunks anew."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _SIDE_STREAMS.get(index)
    if stream is None:
        stream = _SIDE_STREAMS.setdefault(index, torch.cuda.Stream(index))
    return stream


class _Uploader:
    """Host chunks to the card: each chunk's tensors (pinned by the loader)
    are copied ``non_blocking`` on the device's side stream, and one event
    marks the copy done.  :meth:`ready` makes the compute stream wait for
    that event and records the compute stream on every copied tensor, so
    the caching allocator cannot hand a chunk's memory to another
    allocation while kernels that read it are still queued."""

    def __init__(self, device: torch.device, stats: Optional[StreamStats]):
        self.device = device
        self.side = _side_stream(device)
        self.stats = stats

    def upload(self, host):
        timing = self.stats is not None
        start = torch.cuda.Event(enable_timing=timing)
        done = torch.cuda.Event(enable_timing=timing)
        with torch.cuda.stream(self.side):
            start.record(self.side)
            dev = map_batch_tensors(
                host, lambda t: t.to(self.device, non_blocking=True))
            done.record(self.side)
        if timing:
            self.stats.copy_bytes += sum(t.nbytes for t in batch_tensors(host))
        return dev, start, done

    def ready(self, staged):
        dev, start, done = staged
        compute = torch.cuda.current_stream(self.device)
        if self.stats is not None:
            need = torch.cuda.Event(enable_timing=True)
            need.record(compute)
            self.stats.events.append((start, done, need))
        compute.wait_event(done)
        for t in batch_tensors(dev):
            t.record_stream(compute)
        return dev


def _host_chunks(load_chunk, num_chunks: int, prefetch: int) -> Iterator:
    """``load_chunk(i)`` for i in order, ``None`` results skipped: on the
    host-IO pool's shared executor (one across passes) when it has more
    than one worker, else on one prefetching thread.  A worker's error re-raises at its position; abandoning the
    iterator cancels the loads not yet started."""
    from photon_tpu_torch.utils.io_pool import io_threads, map_ordered

    workers = io_threads()
    # The pool needs a window of at least 2 to beat the single prefetching
    # thread (a window of 1 would serialize load and compute).
    if workers > 1 and num_chunks > 1 and prefetch >= 2:
        yield from (c for c in map_ordered(
            load_chunk, range(num_chunks),
            workers=min(workers, prefetch), window=prefetch, persistent=True,
        ) if c is not None)
        return
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for i in range(num_chunks):
                if stop.is_set() or not put(load_chunk(i)):
                    return
        except BaseException as e:  # surface the worker's error to the consumer
            put(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            if item is not None:
                yield item
    finally:
        stop.set()
        # Drain so that a blocked worker sees the stop event and exits.
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


class DeviceWindow:
    """A bound on the chunks :func:`stream_chunks` holds on a card, and the
    most bytes it held, kept across the passes it serves.

    A chunk handed to the consumer is released once the compute stream has
    passed the consumer's return from the chunk after it: by then the
    consumer has dropped the chunk, and the allocator's release event for
    it (``record_stream``), queued before the next chunk's work, has
    completed.  A pass's end releases every chunk it holds.  :meth:`admit`
    runs before a chunk's copy is allocated: it polls the oldest release,
    waits for it while ``chunks`` would be live, and records the bytes live
    then.  So ``peak_bytes`` comes from the events, not from the bound: a
    consumer that ran ahead of the card would show in it.  ``chunks`` is at
    least 3 (the chunk being consumed, the one staged behind it and the new
    one), so the card has a chunk's work queued while the host waits."""

    def __init__(self, chunks: int):
        if chunks < 3:
            raise ValueError(f"a device window holds at least 3 chunks, got {chunks}")
        self.chunks = int(chunks)
        self.peak_bytes = 0
        self.waits = 0  # admissions that waited for the card
        self._live: deque = deque()  # [nbytes, release event or None], upload order

    def admit(self, nbytes: int) -> None:
        live = self._live
        while live and live[0][1] is not None:
            if not live[0][1].query():
                if len(live) < self.chunks:
                    break
                # host-sync: the residency bound, a wait for the card to
                # pass the oldest chunk's release.
                live[0][1].synchronize()
                self.waits += 1
            live.popleft()
        live.append([nbytes, None])
        self.peak_bytes = max(self.peak_bytes, sum(b for b, _ in live))

    def release(self, stream, every: bool = False) -> None:
        """Release the oldest unreleased chunk (``every``: all of them) at
        ``stream``'s current point."""
        event = torch.cuda.Event()
        event.record(stream)
        for entry in self._live:
            if entry[1] is None:
                entry[1] = event
                if not every:
                    return


def stream_chunks(
    load_chunk: Callable[[int], Optional[object]],
    num_chunks: int,
    prefetch: int = 2,
    device: Optional[torch.device] = None,
    stats: Optional[StreamStats] = None,
    window: Optional[DeviceWindow] = None,
) -> Iterator:
    """Chunks ``load_chunk(0..num_chunks-1)`` in order, loaded ahead of the
    consumer.

    ``load_chunk`` runs on worker threads (``PHOTON_IO_THREADS`` of them, at
    most ``prefetch`` in flight, delivery in order; one prefetching thread
    when pooling is off) and returns a host chunk, or None to skip.  With a
    CUDA ``device`` each host chunk (its tensors pinned by the loader) is
    copied to the card on a side stream as soon as it arrives, so the copy
    of chunk i+1 overlaps the kernels of chunk i; the compute stream waits
    for a chunk's copy only when it reaches it.  Without a device the host
    chunks are yielded as they are.  ``stats`` records the pass
    (:class:`StreamStats`).  A ``window`` (:class:`DeviceWindow`) bounds
    the chunks on the card: the host waits before a copy rather than
    queue the copies of a whole pass ahead of the card's work."""
    host = _host_chunks(load_chunk, num_chunks, prefetch)
    compute = None
    if stats is not None:
        stats.rss_start_bytes = stats.rss_peak_bytes = rss_bytes()

    def arrivals():
        while True:
            t0 = time.perf_counter()
            try:
                chunk = next(host)
            except StopIteration:
                return
            if stats is not None:
                stats.parse_wait_s += time.perf_counter() - t0
                stats.chunks += 1
                stats.rows += int(getattr(chunk, "num_examples", 0) or 0)
                stats.rss_peak_bytes = max(stats.rss_peak_bytes, rss_bytes())
            yield chunk

    try:
        if device is None or torch.device(device).type != "cuda":
            for chunk in arrivals():
                yield chunk if device is None else map_batch_tensors(
                    chunk, lambda t: t.to(device))
            return
        uploader = _Uploader(torch.device(device), stats)
        compute = torch.cuda.current_stream(uploader.device)
        pending = None
        handed = 0
        for chunk in arrivals():
            if window is not None:
                window.admit(sum(t.nbytes for t in batch_tensors(chunk)))
            staged = uploader.upload(chunk)
            del chunk
            if pending is not None:
                yield uploader.ready(pending)
                handed += 1
                if window is not None and handed > 1:
                    window.release(compute)
            pending = staged
        if pending is not None:
            staged, pending = pending, None
            yield uploader.ready(staged)
    finally:
        if window is not None and compute is not None:
            window.release(compute, every=True)
        host.close()


@dataclasses.dataclass
class StreamingObjective:
    """An objective whose every evaluation is one streamed pass.

    ``chunk_iter_factory`` yields device chunks (typically
    :meth:`LibsvmFileSource.chunk_iter_factory`); each chunk's data term
    runs on the route its layouts and the selection give it (resolved per
    chunk, as the reference's), the row-major ``autodiff`` route when none
    applies: a streamed chunk never takes the fused kernel, which the
    reference keeps off its streamed path.  ``all_reduce`` sums the totals
    across ranks.  ``last_kernel`` is the route the last pass's first chunk
    ran."""

    objective: object  # GlmObjective
    chunk_iter_factory: Callable[[], Iterable[SparseBatch]]
    all_reduce: Optional[Callable[[Tensor], Tensor]] = None
    last_kernel: Optional[str] = None

    def value_and_grad(self, w: Tensor) -> tuple[Tensor, Tensor]:
        data_obj = _data_only(self.objective)
        d = int(w.shape[0])
        total_v = torch.zeros((), dtype=w.dtype, device=w.device)
        total_g = torch.zeros_like(w)
        first = True
        for chunk in self.chunk_iter_factory():
            kernel = data_obj._sparse_kernel(chunk, d)
            if kernel in (None, "fused"):
                kernel = "autodiff"
            if first:
                first = False
                self.last_kernel = kernel
            v, g = data_obj._fast_data_value_and_grad(w, chunk, kernel)
            total_v = total_v + v
            total_g = total_g + g
        if self.all_reduce is not None:
            total_v = self.all_reduce(total_v)
            total_g = self.all_reduce(total_g)
        l2 = self.objective.l2_weight
        if l2:
            total_v = total_v + 0.5 * l2 * torch.dot(w, w)
            total_g = total_g + l2 * w
        return total_v, total_g


def _two_loop_direction(g: Tensor, S: Tensor, Y: Tensor, rho: Tensor,
                        num_pairs: int, insert_pos: int, gamma: float,
                        m: int) -> Tensor:
    """``-H g`` by the L-BFGS two-loop recursion over the ring buffer
    (slots valid for j < num_pairs, the newest at ``insert_pos - 1``)."""
    q = g
    alphas = {}
    for j in range(num_pairs):
        idx = (insert_pos - 1 - j) % m
        alphas[idx] = rho[idx] * torch.dot(S[idx], q)
        q = q - alphas[idx] * Y[idx]
    r = gamma * q
    for j in range(num_pairs):
        idx = (insert_pos - num_pairs + j) % m
        beta = rho[idx] * torch.dot(Y[idx], r)
        r = r + (alphas[idx] - beta) * S[idx]
    return -r


def streaming_lbfgs(
    objective: StreamingObjective,
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    checkpointer=None,
    checkpoint_every: int = 1,
    resume_state=None,
    fingerprint: Optional[dict] = None,
) -> OptimizerResult:
    """Host-loop L-BFGS for data that fits only on the host.

    The reference's streamed loop step for step: the two-loop direction,
    Armijo backtracking from 1 (from 1/max(|g|, 1) without pairs), the
    cautious pair update, the tolerance checks; every evaluation is a
    streamed pass.  ``checkpointer`` (a :class:`~photon_tpu_torch.fault.
    checkpoint.StreamCheckpointer`) publishes the whole loop state —
    iterate, gradient, pair ring buffer, history and the host scalars —
    every ``checkpoint_every`` iterations (``completed`` False) and once at
    the end (``completed`` True), in the reference's format.
    ``resume_state`` restores either: a mid-fit state continues exactly
    where the interrupted fit stopped (no pass already run is repeated,
    the initial evaluation included); a completed one rebuilds the result
    without a pass, unless it stopped at ``MAX_ITERATIONS`` below a larger
    budget, when the loop continues.  ``fingerprint`` is stamped into each
    snapshot; checking it is the caller's."""
    from photon_tpu_torch.fault.checkpoint import StreamState
    from photon_tpu_torch.fault.preemption import (
        PreemptedError,
        consume_preempt_injection,
        preemption_reason,
        preemption_requested,
    )
    from photon_tpu_torch.fault.watchdog import complete, heartbeat

    m = config.history_length
    d = int(w0.shape[0])
    dtype, dev = w0.dtype, w0.device

    if resume_state is not None and resume_state.completed:
        if (_stream_converged(resume_state.reason)
                or resume_state.reason == ConvergenceReason.OBJECTIVE_NOT_IMPROVING
                or resume_state.iteration >= config.max_iterations):
            return _result_from_stream_state(resume_state, dev)

    def put(a) -> Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev).clone()

    if resume_state is not None:
        arrays, scalars = resume_state.arrays, resume_state.scalars
        w, g, S, Y, rho = (put(arrays[k]) for k in ("w", "g", "S", "Y", "rho"))
        hv, hg, hvalid = (np.array(arrays[k]) for k in ("hv", "hg", "hvalid"))
        f, gnorm0 = float(scalars["f"]), float(scalars["gnorm0"])
        num_pairs = int(scalars["num_pairs"])
        insert_pos = int(scalars["insert_pos"])
        gamma = float(scalars["gamma"])
        it = resume_state.iteration
        if hv.shape[0] < config.max_iterations + 1:
            # A larger budget than the snapshot's: the history grows.
            grow = config.max_iterations + 1 - hv.shape[0]
            hv = np.concatenate([hv, np.zeros(grow, hv.dtype)])
            hg = np.concatenate([hg, np.zeros(grow, hg.dtype)])
            hvalid = np.concatenate([hvalid, np.zeros(grow, hvalid.dtype)])
        reason = ConvergenceReason.NOT_CONVERGED
    else:
        w = w0
        f_t, g = objective.value_and_grad(w)
        f, gnorm0 = float(f_t), float(torch.linalg.vector_norm(g))
        n_hist = config.max_iterations + 1
        hv = np.zeros(n_hist, np.float32)
        hg = np.zeros(n_hist, np.float32)
        hvalid = np.zeros(n_hist, bool)
        hv[0], hg[0], hvalid[0] = f, gnorm0, True
        S = torch.zeros(m, d, dtype=dtype, device=dev)
        Y = torch.zeros_like(S)
        rho = torch.zeros(m, dtype=dtype, device=dev)
        num_pairs, insert_pos, gamma = 0, 0, 1.0
        reason = ConvergenceReason.NOT_CONVERGED
        it = 0
        if gnorm0 == 0.0:
            reason = ConvergenceReason.GRADIENT_TOLERANCE

    def snapshot(completed: bool) -> StreamState:
        # The history buffers are the loop's scratch: copied, so that the
        # publisher serializes this iteration's, not a later one's.
        return StreamState(
            iteration=it,
            arrays={"w": w, "g": g, "S": S, "Y": Y, "rho": rho,
                    "hv": hv.copy(), "hg": hg.copy(), "hvalid": hvalid.copy()},
            scalars={"f": f, "gnorm0": gnorm0, "num_pairs": num_pairs,
                     "insert_pos": insert_pos, "gamma": gamma},
            completed=completed, reason=int(reason),
            fingerprint=fingerprint or {},
        )

    try:
        while reason == ConvergenceReason.NOT_CONVERGED:
            # The streamed fit's kill site: a killed fit restarts from the
            # last published mid-fit snapshot.
            fault_point("stream:kill", iteration=it)
            # Preemption (SIGTERM, or the injected ``preempt`` site): the
            # loop state is whole here, so it is published now, off the
            # checkpoint_every cadence if need be, and the fit stops with
            # the error the driver maps to exit code 75.
            consume_preempt_injection(it)
            if preemption_requested():
                if checkpointer is not None:
                    checkpointer.save(snapshot(completed=False))
                    checkpointer.drain()
                    hint = "resume with --resume auto"
                else:
                    hint = ("no checkpointer configured — a restart begins "
                            "from scratch (set --checkpoint-dir)")
                raise PreemptedError(
                    f"preempted ({preemption_reason()}) before streamed "
                    f"L-BFGS iteration {it}; {hint}")
            heartbeat("stream.iteration")
            reason, w, f, g, num_pairs, insert_pos, gamma, it = _stream_lbfgs_step(
                objective, config, m, reason, w, f, g, gnorm0, S, Y, rho,
                num_pairs, insert_pos, gamma, it, hv, hg, hvalid,
            )
            if (checkpointer is not None and checkpoint_every
                    and reason == ConvergenceReason.NOT_CONVERGED
                    and it % checkpoint_every == 0):
                checkpointer.save(snapshot(completed=False))
    except BaseException:
        if checkpointer is not None:
            checkpointer.drain(reraise=False)
        raise
    finally:
        # A finished (or dead) fit going quiet is no stall.
        complete("stream.iteration")
    if checkpointer is not None:
        # The final snapshot: a resume rebuilds the result without a pass.
        checkpointer.save(snapshot(completed=True))
        checkpointer.drain()
    return OptimizerResult(
        w=w, value=f, grad_norm=float(torch.linalg.vector_norm(g)),
        iterations=it, converged=_stream_converged(reason), reason=int(reason),
        history_value=hv, history_grad_norm=hg, history_valid=hvalid,
    )


def _stream_converged(reason) -> bool:
    """The one definition of a converged streamed fit, shared by the loop's
    result and the completed-checkpoint rebuild."""
    return reason in (ConvergenceReason.GRADIENT_TOLERANCE,
                      ConvergenceReason.FUNCTION_VALUES_TOLERANCE)


def _result_from_stream_state(state, device) -> OptimizerResult:
    """The OptimizerResult of a completed stream snapshot."""
    reason = int(state.reason)
    g = np.asarray(state.arrays["g"])
    return OptimizerResult(
        w=torch.as_tensor(np.asarray(state.arrays["w"]), device=device).clone(),
        value=float(state.scalars["f"]),
        grad_norm=float(np.linalg.norm(g)),
        iterations=int(state.iteration),
        converged=_stream_converged(reason), reason=reason,
        history_value=np.asarray(state.arrays["hv"]),
        history_grad_norm=np.asarray(state.arrays["hg"]),
        history_valid=np.asarray(state.arrays["hvalid"]).astype(bool),
    )


def _stream_lbfgs_step(objective, config, m, reason, w, f, g, gnorm0, S, Y,
                       rho, num_pairs, insert_pos, gamma, it, hv, hg, hvalid):
    """One host-loop L-BFGS iteration (direction, line search, pair update,
    convergence check); ``S``, ``Y``, ``rho`` and the history arrays change
    in place."""
    dvec = _two_loop_direction(g, S, Y, rho, num_pairs, insert_pos, gamma, m)
    dir_deriv = float(torch.dot(g, dvec))
    if dir_deriv >= 0.0:
        dvec = -g
        dir_deriv = -float(torch.dot(g, g))
    t = 1.0 if num_pairs else 1.0 / max(float(torch.linalg.vector_norm(g)), 1.0)
    for _ in range(config.max_line_search):
        w_try = w + t * dvec
        f_try, g_try = objective.value_and_grad(w_try)
        f_try = float(f_try)
        if np.isfinite(f_try) and f_try <= f + 1e-4 * t * dir_deriv:
            break
        t *= 0.5
    else:
        return (ConvergenceReason.OBJECTIVE_NOT_IMPROVING, w, f, g, num_pairs,
                insert_pos, gamma, it)
    svec = w_try - w
    yvec = g_try - g
    sy = float(torch.dot(svec, yvec))
    if sy > 1e-10:
        S[insert_pos] = svec
        Y[insert_pos] = yvec
        rho[insert_pos] = 1.0 / sy
        num_pairs = min(num_pairs + 1, m)
        insert_pos = (insert_pos + 1) % m
        gamma = sy / max(float(torch.dot(yvec, yvec)), 1e-30)
    gnorm_new = float(torch.linalg.vector_norm(g_try))
    it += 1
    if it < hv.shape[0]:
        hv[it], hg[it], hvalid[it] = f_try, gnorm_new, True
    # The tolerance semantics of base.check_convergence, in double.
    if gnorm_new <= config.gradient_tolerance * max(gnorm0, 1.0):
        reason = ConvergenceReason.GRADIENT_TOLERANCE
    elif abs(f - f_try) / max(abs(f), 1e-12) <= config.tolerance:
        reason = ConvergenceReason.FUNCTION_VALUES_TOLERANCE
    elif it >= config.max_iterations:
        reason = ConvergenceReason.MAX_ITERATIONS
    return reason, w_try, f_try, g_try, num_pairs, insert_pos, gamma, it


def _scan_rows_nnz(path: str) -> tuple[int, int]:
    """(row count, max nonzeros a row) without parsing values: the metadata
    pass when the feature dimension is known (the native line indexer, else
    a Python line scan)."""
    from photon_tpu_torch.native import libsvm_native

    meta = libsvm_native.scan_meta(path)
    if meta is not None:
        return meta
    rows, max_nnz = 0, 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.split(b"#", 1)[0].strip()
            if not line:
                continue
            rows += 1
            max_nnz = max(max_nnz, line.count(b":"))
    return rows, max_nnz


class LibsvmFileSource:
    """Streamed LIBSVM input: one chunk per file, re-parsed every pass.

    A metadata pass fixes the global feature dimension and row capacity up
    front, so every chunk shares one padded width.  Each evaluation then
    re-streams the files: the native parse on the host-IO pool, the route's
    cached layouts attached (``data/stream_layouts.py``), the tensors
    pinned, and the copy to ``device`` overlapped with the compute
    (:func:`stream_chunks`).  ``last_pass`` holds the last pass's
    :class:`StreamStats`.
    """

    def __init__(
        self,
        files: Sequence[str],
        intercept: bool = True,
        binary_labels: bool = True,
        feature_dim: Optional[int] = None,
        telemetry=None,
        device=None,
    ):
        """The metadata covers the GLOBAL file list (a multi-process run
        restricts the stream afterwards with :meth:`with_files`).  With
        ``feature_dim`` (e.g. from a feature-indexing run) only a row/nnz
        line scan runs; otherwise each file is parsed once for its largest
        feature id.  ``telemetry`` receives the ``io.retries`` of the
        retried chunk loads."""
        from photon_tpu_torch.device import resolve_device

        if not files:
            raise ValueError("LibsvmFileSource needs at least one file")
        self.files = list(files)
        self.intercept = intercept
        self.binary_labels = binary_labels
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self.last_pass: Optional[StreamStats] = None
        dim, capacity, total = feature_dim or 0, 1, 0
        if feature_dim is None:
            from photon_tpu_torch.utils.io_pool import io_threads, map_ordered

            def _meta(f):
                # Reduced inside the worker: the pool's window then holds
                # three ints a file, not whole parses.
                from photon_tpu_torch.data.libsvm import parse_csr_or_none, parse_libsvm

                csr = parse_csr_or_none(f)
                if csr is not None:
                    _, row_ptr, _, _, fdim = csr
                    counts = np.diff(row_ptr)
                    cap = int(counts.max()) if counts.size else 1
                    return fdim, max(cap, 1), int(row_ptr.shape[0]) - 1
                data = parse_libsvm(f)
                cap = max((len(r[0]) for r in data.rows), default=1)
                return data.dim, cap, data.num_examples

            # Each parse in flight holds a whole file: at most 4 at once.
            for fdim, fcap, fn_rows in map_ordered(
                    _meta, self.files, workers=min(io_threads(), 4)):
                dim = max(dim, fdim)
                capacity = max(capacity, fcap)
                total += fn_rows
        else:
            for f in self.files:
                rows, max_nnz = _scan_rows_nnz(f)
                capacity = max(capacity, max_nnz)
                total += rows
        self.feature_dim = dim
        self.capacity = capacity + (1 if intercept else 0)
        self.num_examples = total
        self.dim = dim + (1 if intercept else 0)

    def with_files(self, files: Sequence[str]) -> "LibsvmFileSource":
        """The same (global) metadata over a restricted file list: each rank
        passes its :func:`shard_files_for_process` slice."""
        import copy

        out = copy.copy(self)
        out.files = list(files)
        return out

    def load_host_chunk(self, i: int) -> SparseBatch:
        """File ``i`` parsed and padded on the host (retried on transient
        IO errors), with the streamed route's cached layouts attached."""
        from photon_tpu_torch.data.libsvm import load_sparse_batch
        from photon_tpu_torch.data.stream_layouts import attach_stream_aux, stream_kernel
        from photon_tpu_torch.fault.retry import retry_call

        def _load():
            fault_point("io:read", path=self.files[i])
            return load_sparse_batch(
                self.files[i], dim=self.feature_dim, intercept=self.intercept,
                capacity=self.capacity, binary_labels=self.binary_labels,
                device="cpu",
            )

        batch, _, _ = retry_call(_load, site="libsvm:read", telemetry=self.telemetry)
        if stream_kernel() != "autodiff":
            batch = attach_stream_aux(batch, self.dim, self.files[i])
        return batch

    def _load_chunk(self, i: int) -> SparseBatch:
        batch = self.load_host_chunk(i)
        if self.device.type == "cuda":
            # Pinned here, on the worker thread, so that the copy to the card
            # can run beside the compute.
            batch = map_batch_tensors(batch, lambda t: t.pin_memory())
        return batch

    def chunk_iter_factory(self) -> Iterable[SparseBatch]:
        """One pass over the files as device chunks.  ``PHOTON_STREAM_PREFETCH``
        is the number of chunks loading ahead of the compute, and so the
        pool's width.  Its default is the host-IO width (``io_threads()``, at
        least 2) where the reference's is 2: the reference holds each chunk
        in flight on the device, the port in pinned host memory (a chunk
        reaches the card only one chunk ahead of its kernels), and a pass is
        bound by the parse."""
        from photon_tpu_torch.utils.env import env_int
        from photon_tpu_torch.utils.io_pool import io_threads

        self.last_pass = StreamStats()
        return stream_chunks(
            self._load_chunk, len(self.files),
            prefetch=env_int("PHOTON_STREAM_PREFETCH", max(2, io_threads()), minimum=1),
            device=self.device, stats=self.last_pass,
        )


def make_global_batch(*args, **kwargs):
    """Not ported: the mesh-sharded global batch of per-process rows waits
    with the multi-device paths in ROADMAP.md queue 1, item 10."""
    raise NotImplementedError(
        "make_global_batch (a mesh-sharded global batch) waits in ROADMAP.md "
        "queue 1, item 10")

