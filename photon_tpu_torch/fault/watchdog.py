"""Run watchdog: stall detection for iteration and IO progress.

A copy of ``photon_tpu/fault/watchdog.py``.  The retry layer handles IO that FAILS; nothing handled IO that
HANGS — a wedged NFS read or a stuck container open blocks its thread
forever and the run looks "busy" while doing nothing.  This module closes
the retry/timeout/backoff triangle:

- **Heartbeats.**  Progress points call :func:`heartbeat(name)` — the
  descent loop once per outer iteration, the streamed L-BFGS loop once per
  host iteration, :func:`~photon_tpu_torch.fault.retry.retry_call` once per IO
  attempt.  A heartbeat is one monotonic-clock store; the hot loops pay
  nanoseconds.
- **The watchdog thread** (:class:`Watchdog`, started by the drivers when
  ``--stall-timeout`` > 0) polls the heartbeat table and, when a site's
  age exceeds the stall timeout, emits ``watchdog.stalled{site=...}``
  telemetry and a log line — once per stall episode, again only after the
  site recovers and stalls anew.  The run report then says WHERE a hung
  run stopped making progress, instead of requiring a py-spy autopsy.
- **Escalation.**  With a stall timeout configured, guarded IO calls run
  under :func:`call_with_timeout`: the call executes on a daemon worker
  thread and a hang longer than the timeout raises
  :class:`IOStallTimeoutError` — an ``OSError``, so the retry layer treats
  a hung call exactly like a failed one (backoff, ``io.retries``, fresh
  attempt).  The abandoned worker thread is daemonic and unblocks (or
  leaks) in the background; that is the honest trade for progress — Python
  cannot safely interrupt a thread stuck in a C-level read.

Configuration: ``--stall-timeout SECONDS`` on every driver (0 disables,
the default), or ``PHOTON_STALL_TIMEOUT_S`` process-wide.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional, TypeVar

from photon_tpu_torch.telemetry import NULL_SESSION

T = TypeVar("T")


class IOStallTimeoutError(OSError):
    """A guarded IO call exceeded the stall timeout.  An ``OSError`` on
    purpose: the retry layer's backoff-and-reattempt policy applies to a
    hung call exactly as to a failed one."""


# -- heartbeat table ---------------------------------------------------------
#
# One process-wide table: {site: last-progress monotonic time}.  Writers are
# the training loops and retry_call (including IO-pool worker threads); the
# reader is the watchdog thread.  Every access takes the lock — a
# first-time-site insert during the reader's iteration would otherwise be a
# "dictionary changed size during iteration" crash on the watchdog thread.

_beats: Dict[str, float] = {}
_beats_lock = threading.Lock()
_stall_timeout_override: Optional[float] = None


def heartbeat(name: str) -> None:
    """Record progress for ``name`` (cheap: one clock read + locked dict
    store)."""
    with _beats_lock:
        _beats[name] = time.monotonic()


def complete(name: str) -> None:
    """Retire ``name`` from the heartbeat table: the activity FINISHED —
    silence from a finished site is not a stall.  The loops call this when
    they exit and retry_call when an attempt sequence ends, so a healthy
    run never false-alarms during later phases that simply don't touch the
    site anymore."""
    with _beats_lock:
        _beats.pop(name, None)


def progress_ages() -> Dict[str, float]:
    """Seconds since each LIVE site's last heartbeat (a snapshot)."""
    now = time.monotonic()
    with _beats_lock:
        return {name: now - t for name, t in _beats.items()}


def age_of(name: str) -> Optional[float]:
    """Seconds since ``name``'s last heartbeat, or None when the site has
    no live heartbeat (never marked, or retired by :func:`complete`).  The
    fleet supervisor's hang check reads single replica sites through this
    instead of snapshotting the whole table every probe."""
    with _beats_lock:
        t = _beats.get(name)
    return None if t is None else time.monotonic() - t


def clear_heartbeats() -> None:
    """Drop all recorded heartbeats (run scoped: a finished run's stale
    sites must not look stalled to the next run's watchdog)."""
    with _beats_lock:
        _beats.clear()


def set_stall_timeout(seconds: Optional[float]) -> None:
    """Install (or clear, with None) the run-scoped stall timeout — the
    driver flag's value; overrides ``PHOTON_STALL_TIMEOUT_S``."""
    global _stall_timeout_override
    _stall_timeout_override = seconds


def stall_timeout() -> float:
    """The operative stall timeout in seconds (0 = disabled): the driver
    flag when installed, else ``PHOTON_STALL_TIMEOUT_S``, else 0."""
    if _stall_timeout_override is not None:
        return max(0.0, float(_stall_timeout_override))
    raw = os.environ.get("PHOTON_STALL_TIMEOUT_S", "").strip()
    try:
        return max(0.0, float(raw)) if raw else 0.0
    except ValueError:
        return 0.0


# -- escalation --------------------------------------------------------------


def call_with_timeout(fn: Callable[[], T], timeout_s: float,
                      site: str = "io") -> T:
    """Run ``fn()`` on a daemon worker thread; raise
    :class:`IOStallTimeoutError` if it has not finished within
    ``timeout_s``.  ``timeout_s <= 0`` calls ``fn`` inline (no thread)."""
    if timeout_s <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # re-raised on the caller thread below
            box["error"] = e
        finally:
            done.set()

    worker = threading.Thread(
        target=run, name=f"io-guard-{site}", daemon=True
    )
    worker.start()
    if not done.wait(timeout_s):
        # The worker stays parked on the hung call (daemonic, abandoned);
        # the caller gets a retriable timeout and a FRESH attempt.
        raise IOStallTimeoutError(
            f"guarded IO at {site!r} made no progress for {timeout_s:g}s"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


# -- the watchdog thread -----------------------------------------------------


class Watchdog:
    """Background thread that turns missing heartbeats into telemetry.

    Polls the heartbeat table every ``poll_interval_s`` (default: a quarter
    of the stall timeout, floored at 0.05s) and, when a site's age crosses
    ``stall_timeout_s``, increments ``watchdog.stalled{site=...}`` and sets
    the ``watchdog.stall_age_seconds{site=...}`` gauge — once per stall
    episode (the gauge keeps updating while the stall lasts; the counter
    fires again only after the site makes progress and stalls anew).
    """

    def __init__(self, stall_timeout_s: float, telemetry=None, logger=None,
                 poll_interval_s: Optional[float] = None):
        if stall_timeout_s <= 0:
            raise ValueError("Watchdog needs stall_timeout_s > 0")
        self.stall_timeout_s = float(stall_timeout_s)
        self.telemetry = telemetry or NULL_SESSION
        self.logger = logger
        self.poll_interval_s = (
            max(0.05, self.stall_timeout_s / 4.0)
            if poll_interval_s is None else poll_interval_s
        )
        self._stalled: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # One pass over the heartbeat table (extracted so tests can drive the
    # detection logic without timing a real thread).
    def check_once(self) -> list:
        newly_stalled = []
        ages = progress_ages()
        self._stalled &= set(ages)  # retired sites leave the episode set
        for name, age in ages.items():
            if age > self.stall_timeout_s:
                self.telemetry.gauge(
                    "watchdog.stall_age_seconds", site=name
                ).set(age)
                if name not in self._stalled:
                    self._stalled.add(name)
                    self.telemetry.counter(
                        "watchdog.stalled", site=name
                    ).inc()
                    newly_stalled.append(name)
                    if self.logger is not None:
                        self.logger.warning(
                            "watchdog: %s made no progress for %.1fs "
                            "(stall timeout %.1fs)", name, age,
                            self.stall_timeout_s,
                        )
            else:
                self._stalled.discard(name)
        return newly_stalled

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — detection must outlive a
                # bad poll (a telemetry hiccup must not silently kill
                # stall detection for the rest of the run).
                pass

    def start(self) -> "Watchdog":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="photon-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
