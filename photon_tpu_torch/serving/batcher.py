"""Async request batcher: coalesce concurrent scoring requests on a thread.

A copy of ``photon_tpu/serving/batcher.py``.  ONE dedicated
batcher thread sits between callers and the :class:`GameScorer`.  Callers
``submit()`` a request and get a ``concurrent.futures.Future``; the thread
coalesces whatever is queued under a max-delay/max-batch policy — the first
queued request opens a window of ``max_delay_s``, and the batch closes when
the window expires or ``max_batch`` rows have accumulated, whichever is
first — merges the requests into one micro-batch, scores it (one compiled
dispatch, one host sync), and resolves every future with its own row slice.

Coalescing is what buys the device's throughput back from small requests:
at 1-row requests and an 8-wide bucket the dispatch cost is amortized 8x
before padding even enters.  ``serving.requests`` / ``serving.batches``
count both sides of that ratio; ``serving.request_latency_s`` is the
submit→resolve distribution (the p50/p99 the bench reports), and
``serving.coalesced`` the requests-per-batch distribution.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional

from photon_tpu_torch.serving.scorer import (
    GameScorer,
    ScoringRequest,
    concat_requests,
    padded_cost,
)
from photon_tpu_torch.telemetry.distributed import attach_trace, span_of

DEFAULT_MAX_DELAY_S = 0.002


def resolve_once(future: Future, value=None,
                 exc: Optional[BaseException] = None) -> None:
    """Resolve a pending future exactly once — the shared guard for every
    path where two resolvers can race the same future: a future abandoned
    by the supervisor (a hung replica torn down mid-batch) may already
    carry its ReplicaDeadError when the wedged batcher thread finally
    comes back, and an async transport future can be failed by the
    submit-side send error, the reader's decode, and the dead-connection
    sweep.  The loser's write must be a no-op, not an InvalidStateError
    that kills the resolving thread."""
    try:
        if future.cancelled():
            return
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(value)
    except InvalidStateError:
        pass


_resolve = resolve_once  # internal alias for the call sites below


class _Pending:
    __slots__ = ("request", "future", "enqueued", "rows", "padded")

    def __init__(self, request: ScoringRequest, padded: int):
        self.request = request
        self.future: Future = Future()
        self.enqueued = time.monotonic()
        self.rows = request.num_rows
        self.padded = padded


class RequestBatcher:
    """Depth-1 batcher thread over a :class:`GameScorer`.

    Context-manager lifecycle: ``with RequestBatcher(scorer) as b: ...``
    drains the queue and stops the thread on exit.  A scorer failure is
    delivered through the affected futures, never swallowed; submits after
    ``close()`` raise.
    """

    def __init__(
        self,
        scorer: GameScorer,
        max_batch: Optional[int] = None,
        max_delay_s: float = DEFAULT_MAX_DELAY_S,
        telemetry=None,
    ):
        from photon_tpu_torch.telemetry import NULL_SESSION

        self.scorer = scorer
        self.max_batch = int(max_batch or scorer.max_bucket)
        self.max_delay_s = float(max_delay_s)
        self.telemetry = telemetry or scorer.telemetry or NULL_SESSION
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._stop = False
        # Rows accepted but not yet resolved (queued + in the batch being
        # scored): the queue-depth signal the fleet router dispatches and
        # sheds on.  Kept under the SAME lock as the queue so a router
        # reading depth mid-submit can never see a torn count.  The padded
        # twin charges each request at its bucket-ladder cost — the unit
        # the admission projection estimates wait in.
        self._inflight_rows = 0
        self._inflight_padded = 0
        self._current: List[_Pending] = []
        self._thread = threading.Thread(
            target=self._loop, name="serving-batcher", daemon=True
        )
        self._thread.start()

    def _padded_cost(self, n: int) -> int:
        try:
            return padded_cost(n, self.scorer.buckets)
        except Exception:  # a scorer stub without a ladder: raw rows
            return int(n)

    # -- caller side ---------------------------------------------------------
    def submit(self, request: ScoringRequest) -> Future:
        """Enqueue one request; the returned future resolves to its ``[n]``
        float32 scores (or raises the scorer's failure)."""
        pending = _Pending(request, self._padded_cost(request.num_rows))
        with self._cond:
            if self._stop:
                raise RuntimeError("batcher is closed")
            self._queue.append(pending)
            self._inflight_rows += pending.rows
            self._inflight_padded += pending.padded
            self._cond.notify()
        self.telemetry.counter("serving.requests").inc()
        return pending.future

    def pending_rows(self) -> int:
        """Rows submitted but not yet resolved (queued + scoring) — the
        per-replica queue depth the fleet router's admission projection and
        least-loaded dispatch read."""
        with self._cond:
            return self._inflight_rows

    def pending_padded_rows(self) -> int:
        """Pending work at its PADDED bucket-ladder cost — the unit the
        admission projection multiplies by the per-row pace EWMA (padded
        rows cost compute too; raw rows under-project near saturation)."""
        with self._cond:
            return self._inflight_padded

    def close(self) -> None:
        """Drain queued requests (they still get scored) and stop.  The
        join is bounded: a batcher whose scorer is wedged (a hung replica
        being torn down) must not wedge close() too."""
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join(timeout=10.0)

    def abandon(self, exc: BaseException) -> None:
        """Fail every pending request — queued AND the batch being scored —
        with ``exc`` and stop accepting work: the dead/hung-replica
        teardown.  The router's done-callbacks then reroute each failed
        future exactly once.  Unlike :meth:`close`, abandon never joins the
        batcher thread (it may be wedged inside the hung scorer call); the
        thread is daemonic and its late resolutions are guarded no-ops."""
        with self._cond:
            self._stop = True
            victims = list(self._current) + list(self._queue)
            self._queue.clear()
            self._inflight_rows = 0
            self._inflight_padded = 0
            self._cond.notify()
        for p in victims:
            _resolve(p.future, exc=exc)

    def __enter__(self) -> "RequestBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- batcher thread ------------------------------------------------------
    def _take_batch(self) -> List[_Pending]:
        """Block for the first request, hold the window open until
        max-delay/max-batch closes it, then pop the batch."""
        with self._cond:
            while not self._queue and not self._stop:
                self._cond.wait()
            if not self._queue:
                return []
            deadline = self._queue[0].enqueued + self.max_delay_s
            while not self._stop:
                queued = sum(p.rows for p in self._queue)
                remaining = deadline - time.monotonic()
                if queued >= self.max_batch or remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch: List[_Pending] = []
            rows = 0
            # Whole requests only: a request larger than max_batch goes out
            # alone (the scorer chunks it); otherwise stop before the batch
            # would spill past max_batch.
            while self._queue:
                head = self._queue[0]
                if batch and rows + head.rows > self.max_batch:
                    break
                batch.append(self._queue.popleft())
                rows += head.rows
            self._current = batch
            return batch

    def _retire(self, batch: List[_Pending]) -> None:
        with self._cond:
            # max(0, …): an abandon() already zeroed the counts (and failed
            # these futures); the late retire must not drive them negative.
            self._inflight_rows = max(
                0, self._inflight_rows - sum(p.rows for p in batch)
            )
            self._inflight_padded = max(
                0, self._inflight_padded - sum(p.padded for p in batch)
            )
            self._current = []

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return
            # Traced requests: stamp the coalesce window onto each root
            # span, and let the merged micro-batch carry the first traced
            # request's context so a subprocess scorer links its child hop
            # (the batch IS one device dispatch — one representative trace
            # is the honest granularity).
            spans = [sp for sp in (span_of(p.request) for p in batch) if sp]
            batch_rows = sum(p.rows for p in batch)
            for sp in spans:
                sp.event("batch_close", coalesced=len(batch),
                         batch_rows=batch_rows)
            try:
                merged = concat_requests([p.request for p in batch])
                if spans:
                    attach_trace(merged, spans[0].context())
                    for sp in spans:
                        sp.event("score_begin")
                scores = self.scorer.score_batch(merged)
                for sp in spans:
                    sp.event("score_end")
            except BaseException as e:  # surface through every waiter
                self._retire(batch)
                for p in batch:
                    _resolve(p.future, exc=e)
                continue
            self.telemetry.histogram("serving.coalesced").observe(len(batch))
            self._retire(batch)
            lo = 0
            now = time.monotonic()
            for p in batch:
                hi = lo + p.rows
                self.telemetry.histogram("serving.request_latency_s").observe(
                    now - p.enqueued
                )
                _resolve(p.future, scores[lo:hi])
                lo = hi


def run_closed_loop(
    batcher: RequestBatcher,
    requests: List[ScoringRequest],
    clients: int = 4,
):
    """Drive a request list through the batcher with ``clients`` closed-loop
    workers (each submits its next request only after its previous response
    lands — the concurrent-users arrival model the bench and the serve_game
    driver share).  Returns ``(scores, latencies_s, wall_s)`` with scores
    in request order."""
    results: List = [None] * len(requests)
    latencies: List = [None] * len(requests)
    errors: List[BaseException] = []

    def worker(tid: int) -> None:
        for i in range(tid, len(requests), clients):
            t0 = time.monotonic()
            try:
                results[i] = batcher.submit(requests[i]).result()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                return
            latencies[i] = time.monotonic() - t0

    clients = max(1, min(int(clients), len(requests) or 1))
    threads = [
        threading.Thread(target=worker, args=(t,), daemon=True)
        for t in range(clients)
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    return results, latencies, wall
