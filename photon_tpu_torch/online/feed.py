"""Append-only feeds for the online-learning service.

A copy of ``photon_tpu/online/feed.py``.  Two sources produce
:class:`AppendBatch`es — appended row sets the service ingests, grows
device data with, and refreshes from:

- :class:`QueueFeed` — an in-process producer/consumer queue: callers
  ``append()`` ready-made :class:`~photon_tpu_torch.game.data.GameDataset`
  batches (tests, embedded pipelines).
- :class:`DirectoryFeed` — a directory watch over part files (Avro/LIBSVM
  or anything the caller's ``loader`` reads): new files become pending
  batches, read under the ``retry_call``/watchdog triangle with the
  ``online:ingest`` fault site, and a DURABLE consumed cursor
  (``_consumed.txt``, atomic temp+fsync+rename) makes the feed restart-
  safe — a service killed mid-refresh re-ingests exactly the parts it
  never published.

Both speak the same peek/commit protocol: :meth:`poll` returns the pending
batches WITHOUT consuming them; :meth:`mark_consumed` commits them only
after the refresh that ingested them has published.  A refresh that dies
between the two leaves its batches pending — the crash-consistency
contract the mid-refresh kill tests pin.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, List, Optional

from photon_tpu_torch.game.data import GameDataset

CURSOR_NAME = "_consumed.txt"


@dataclasses.dataclass
class AppendBatch:
    """One appended row set: the data, when it arrived (monotonic clock —
    the base of the append→serving refresh-latency measurement), and the
    source token the feed's consumed cursor records."""

    data: GameDataset
    appended_at: float
    source: str = "queue"


class QueueFeed:
    """In-process append feed (producer threads → the service's loop)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: List[AppendBatch] = []
        self._seq = 0

    def append(self, data: GameDataset, source: Optional[str] = None
               ) -> AppendBatch:
        with self._lock:
            self._seq += 1
            batch = AppendBatch(
                data=data,
                appended_at=time.monotonic(),
                source=source or f"queue-{self._seq:06d}",
            )
            self._pending.append(batch)
            return batch

    def poll(self) -> List[AppendBatch]:
        with self._lock:
            return list(self._pending)

    def mark_consumed(self, batches: List[AppendBatch]) -> None:
        consumed = {id(b) for b in batches}
        with self._lock:
            self._pending = [
                b for b in self._pending if id(b) not in consumed
            ]

    def pending_rows(self) -> int:
        with self._lock:
            return sum(b.data.num_examples for b in self._pending)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)


class DirectoryFeed:
    """Directory-watch append feed over part files.

    ``loader(path) -> GameDataset`` reads one part (the driver wires the
    Avro/LIBSVM readers through it); ``suffixes`` filters which files are
    parts.  Files are ingested in sorted-name order — the deterministic
    replay order a killed-and-restarted service reproduces exactly.
    """

    def __init__(
        self,
        path: str,
        loader: Callable[[str], GameDataset],
        suffixes: tuple = (".avro", ".libsvm", ".txt"),
        telemetry=None,
        logger=None,
    ):
        from photon_tpu_torch.telemetry import NULL_SESSION

        self.path = path
        self.loader = loader
        self.suffixes = tuple(suffixes)
        self.telemetry = telemetry or NULL_SESSION
        self.logger = logger
        self._lock = threading.Lock()
        self._loaded: dict = {}  # name -> AppendBatch (pending)
        self._consumed = self._read_cursor()

    # -- durable cursor ------------------------------------------------------
    def _cursor_path(self) -> str:
        return os.path.join(self.path, CURSOR_NAME)

    def _read_cursor(self) -> set:
        try:
            with open(self._cursor_path()) as f:
                return {line.strip() for line in f if line.strip()}
        except FileNotFoundError:
            return set()

    def _write_cursor(self) -> None:
        """Atomic cursor publish (``fault.atomic.atomic_write_bytes`` —
        mkstemp + fsync + rename + directory fsync): a kill mid-write
        leaves the previous complete cursor, never a torn one — worst case
        the restarted service re-ingests an already-published part, and the
        refresh it drives is idempotent training work, not corruption."""
        from photon_tpu_torch.fault.atomic import atomic_write_bytes

        atomic_write_bytes(
            self._cursor_path(),
            ("\n".join(sorted(self._consumed)) + "\n").encode(),
        )

    def consumed_sources(self) -> List[str]:
        """Source tokens (part-file names) already published, in sorted
        order — what a RESTARTED owner must re-merge into its base
        training data to reconstruct the full dataset (the feed skips
        them; the merged training data itself is not durable)."""
        with self._lock:
            return sorted(self._consumed)

    # -- feed protocol -------------------------------------------------------
    def _part_names(self) -> List[str]:
        # "_"/"."-prefixed names are bookkeeping (the consumed cursor, temp
        # files mid-rename), never parts — the Hadoop part-file convention.
        return sorted(
            name for name in os.listdir(self.path)
            if name.endswith(self.suffixes)
            and not name.startswith(("_", "."))
        )

    def poll(self) -> List[AppendBatch]:
        """Pending batches, loading any newly arrived parts.  Part reads go
        through ``retry_call`` (site ``online:ingest``): transient IO
        faults retry with backoff under the watchdog's per-attempt stall
        timeout — the same triangle every other ingest edge rides.  The
        (potentially slow, multi-attempt) loads run OUTSIDE the feed lock,
        so ``mark_consumed``/``pending_rows`` callers never stall behind a
        faulting part; only the bookkeeping reads/writes lock."""
        from photon_tpu_torch.fault.injection import fault_point
        from photon_tpu_torch.fault.retry import retry_call

        with self._lock:
            fresh = [
                name for name in self._part_names()
                if name not in self._consumed and name not in self._loaded
            ]
        for name in fresh:
            path = os.path.join(self.path, name)

            def attempt(path=path, name=name):
                fault_point("online:ingest", path=name)
                return self.loader(path)

            data = retry_call(
                attempt, site="online:ingest",
                telemetry=self.telemetry, logger=self.logger,
            )
            batch = AppendBatch(
                data=data, appended_at=time.monotonic(), source=name
            )
            with self._lock:
                # A concurrent poll may have raced us to this part; first
                # writer wins (the losing load is dropped, not doubled).
                if name not in self._loaded and name not in self._consumed:
                    self._loaded[name] = batch
                    self.telemetry.counter("online.parts_ingested").inc()
        with self._lock:
            return [self._loaded[n] for n in sorted(self._loaded)]

    def mark_consumed(self, batches: List[AppendBatch]) -> None:
        with self._lock:
            for batch in batches:
                self._consumed.add(batch.source)
                self._loaded.pop(batch.source, None)
            self._write_cursor()

    def pending_rows(self) -> int:
        with self._lock:
            return sum(b.data.num_examples for b in self._loaded.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._loaded)
