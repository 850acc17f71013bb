"""Bounded, ordered host-IO thread pool.

A copy of ``photon_tpu/utils/io_pool.py`` (the port imports nothing of the
JAX package).

The reference gets per-host decode parallelism from Spark executor threads
(each partition parsed on its own core — SURVEY.md §2.6); the analog here
is a small thread pool over FILES/CHUNKS whose native decode calls (ctypes
releases the GIL) run concurrently while results are consumed strictly in
submission order — so vocabularies built by first-seen interning stay
byte-identical to the sequential read.

``PHOTON_IO_THREADS`` sets the pool width (default: the host CPU count,
capped at 8; 1 disables pooling entirely).  The in-flight window is
bounded, so memory never scales with the number of files.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")

_worker_ctx = threading.local()


def in_pool_worker() -> bool:
    """True when the current thread is executing a :func:`map_ordered`
    call — lets nested pooled work (e.g. route colorings inside a
    streamed chunk attach) cap itself to one level instead of
    oversubscribing cores.  Precise by construction (an explicit
    thread-local set around each pooled call), unlike thread-name
    sniffing, which both over-matches foreign executors and misses
    renamed ones."""
    return bool(getattr(_worker_ctx, "active", False))


def io_threads() -> int:
    """Configured host-IO parallelism (>= 1); unset/invalid falls back to
    the host CPU count, capped at 8."""
    from photon_tpu_torch.utils.env import env_int

    default = max(1, min(os.cpu_count() or 1, 8))
    return env_int("PHOTON_IO_THREADS", default, minimum=1)


_submit_pools: dict = {}
_submit_lock = threading.Lock()

# Named background pools: each distinct overlap workload gets its own
# small bounded executor, so e.g. the disk→host tile prefetch of a spilled
# streamed fit cannot starve the warm-start key-join prefetch (both are
# "one short job beside device compute" patterns, but with very different
# blocking profiles — key joins are CPU, tile prefetches are disk IO).
_POOL_WORKERS = {"default": 2, "tile-prefetch": 2}


def submit(fn: Callable[[], R], pool: str = "default"):
    """Fire one background call on a small shared io-pool executor and
    return its Future — the overlap primitive for host work that should run
    beside device compute (e.g. the foreign-vocabulary warm-start key join
    prefetched while the fixed-effect coordinate trains, or a spilled
    chunk's disk→host read warmed one stage ahead of its h2d upload).
    Pools are lazily created, bounded (2 threads each — these are
    occasional short jobs, not the bulk pipelines ``map_ordered`` serves),
    and process-lifetime; submitted work must be short and must not block
    indefinitely."""
    with _submit_lock:
        ex = _submit_pools.get(pool)
        if ex is None:
            ex = _submit_pools[pool] = ThreadPoolExecutor(
                max_workers=_POOL_WORKERS.get(pool, 2),
                thread_name_prefix=f"photon-io-submit-{pool}",
            )
        return ex.submit(fn)


_shared_pools: dict = {}


def shared_pool(workers: int) -> ThreadPoolExecutor:
    """A process-lifetime executor of ``workers`` threads, for pipelines
    that map once a pass (a streamed fit maps its chunk loads at every
    objective evaluation): a pool a pass would start its threads anew each
    time, and a thread's first pinned allocation costs milliseconds."""
    with _submit_lock:
        ex = _shared_pools.get(workers)
        if ex is None:
            ex = _shared_pools[workers] = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix=f"photon-io-shared-{workers}")
        return ex


def map_ordered(
    fn: Callable[[T], R],
    items: Sequence[T] | Iterable[T],
    workers: Optional[int] = None,
    window: Optional[int] = None,
    retry_site: Optional[str] = None,
    telemetry=None,
    persistent: bool = False,
) -> Iterator[R]:
    """``map(fn, items)`` with up to ``workers`` concurrent calls, results
    yielded strictly in input order, and at most ``window`` calls in flight
    (default ``2 * workers``) so memory stays bounded.

    With ``retry_site`` set, each per-item call retries transient IO
    failures (OSError) with jittered exponential backoff on its worker
    thread (``photon_tpu_torch.fault.retry``), counted as
    ``io.retries{site=retry_site}`` on ``telemetry`` — a flaky part file
    costs backoff, not the whole pooled read.

    With ``telemetry`` given, the pool's live shape lands in the run
    report: ``io_pool.workers`` (configured width), ``io_pool.in_flight``
    (submitted-but-unharvested calls, updated as the window slides) and
    ``io_pool.in_flight_peak`` (the high-water mark — how much of the
    window a read actually used).

    With ``workers <= 1`` (or a single item) this degrades to a plain lazy
    map — no threads, no queueing.  An exception from any call is re-raised
    at its in-order position.  Abandoning the iterator cancels calls that
    have not started; calls already RUNNING keep running on pool threads
    (their results are discarded) and, like any executor thread, are joined
    at interpreter exit — so ``fn`` should not block indefinitely.

    Concurrency/memory tradeoff is the caller's: up to ``window`` call
    RESULTS are resident at once (plus ``workers`` in-progress calls'
    transient memory) — map memory-heavy work through a reducer so the
    window holds summaries, not payloads.

    ``persistent`` runs the calls on :func:`shared_pool` instead of a pool
    of this call's own; ``fn`` must then not map on the same pool itself.
    """
    items = list(items)
    if retry_site is not None:
        from photon_tpu_torch.fault.retry import retry_call

        inner = fn

        def fn(item):
            return retry_call(
                lambda: inner(item), site=retry_site, telemetry=telemetry
            )

    if workers is None:
        workers = io_threads()
    if workers <= 1 or len(items) <= 1:
        for it in items:
            yield fn(it)
        return
    if window is None:
        window = 2 * workers
    window = max(window, 1)
    def run_marked(item: T) -> R:
        _worker_ctx.active = True
        try:
            return fn(item)
        finally:
            _worker_ctx.active = False

    if telemetry is not None:
        telemetry.gauge("io_pool.workers").set(workers)
    in_flight_peak = 0

    def _note_in_flight(n: int) -> None:
        nonlocal in_flight_peak
        if telemetry is None:
            return
        telemetry.gauge("io_pool.in_flight").set(n)
        if n > in_flight_peak:
            in_flight_peak = n
            telemetry.gauge("io_pool.in_flight_peak").set(n)

    ex = shared_pool(workers) if persistent else ThreadPoolExecutor(max_workers=workers)
    futs: deque = deque()
    try:
        idx = 0
        while futs or idx < len(items):
            while idx < len(items) and len(futs) < window:
                futs.append(ex.submit(run_marked, items[idx]))
                idx += 1
            _note_in_flight(len(futs))
            result = futs.popleft().result()
            _note_in_flight(len(futs))
            yield result
    finally:
        if persistent:
            for f in futs:
                f.cancel()
        else:
            ex.shutdown(wait=False, cancel_futures=True)
