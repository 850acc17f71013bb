"""Retry with jittered, capped exponential backoff for transient IO.

A copy of ``photon_tpu/fault/retry.py``.

The reference rides Spark task re-execution for transient storage hiccups;
here every guarded read/write path (Avro and LIBSVM file reads, checkpoint
IO) routes through :func:`retry_call`, which retries ``OSError``-class
failures with exponential backoff — jittered so a fleet of workers hitting
the same flaky store does not retry in lockstep, capped so backoff never
stalls a run, and telemetry-counted (``io.retries{site=...}``) so recovered
faults stay visible in the run report instead of vanishing into a log line.

Hangs, not just failures: with a stall timeout configured (``--stall-
timeout`` / ``PHOTON_STALL_TIMEOUT_S``), each attempt runs under
:func:`photon_tpu_torch.fault.watchdog.call_with_timeout` — a call that makes no
progress for the timeout raises
:class:`~photon_tpu_torch.fault.watchdog.IOStallTimeoutError` (an ``OSError``),
which this module then retries like any transient failure
(``io.stall_timeouts{site=...}`` counts the escalations).  Every attempt
also heartbeats its site, so the run watchdog can tell a slow-but-alive IO
path from a wedged one.

Knobs: ``PHOTON_IO_RETRIES`` (retries after the first attempt, default 4),
``PHOTON_IO_RETRY_BASE_S`` (first backoff, default 0.05s; tests set 0),
``PHOTON_STALL_TIMEOUT_S`` (per-attempt stall timeout, default 0 = off).
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from collections import Counter
from typing import Callable, Optional, Tuple, Type, TypeVar

from photon_tpu_torch.telemetry import NULL_SESSION

T = TypeVar("T")

# Process-wide recovered-retry totals by site: introspection for paths that
# run without a telemetry session (streamed readers, library use).
RETRY_TOTALS: Counter = Counter()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` is the TOTAL number of tries (1 disables retrying).

    ``stall_timeout_s`` > 0 bounds each attempt's wall clock: a hung call
    is escalated to a retriable :class:`~photon_tpu_torch.fault.watchdog.
    IOStallTimeoutError` instead of blocking the run forever."""

    attempts: int = 5
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)
    stall_timeout_s: float = 0.0

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Backoff before retry ``attempt`` (0-based): exponential, capped,
        with up to ``jitter`` fractional noise on top.  ``rng`` defaults to
        the module RNG so out-of-loop callers (the fleet supervisor's
        respawn backoff) can reuse the one backoff shape."""
        # min(attempt, 62): 2.0**attempt overflows float range past ~1024
        # attempts (long-lived callers like the supervisor's respawn loop);
        # the cap is far past where max_delay_s saturates anyway.
        base = min(self.max_delay_s,
                   self.base_delay_s * (2.0 ** min(attempt, 62)))
        roll = rng.random() if rng is not None else random.random()
        return base * (1.0 + self.jitter * roll)


def default_policy() -> RetryPolicy:
    from photon_tpu_torch.fault.watchdog import stall_timeout
    from photon_tpu_torch.utils.env import env_int

    retries = env_int("PHOTON_IO_RETRIES", 4, minimum=0)
    raw = os.environ.get("PHOTON_IO_RETRY_BASE_S")
    try:
        base = 0.05 if raw is None else max(0.0, float(raw))
    except ValueError:
        base = 0.05
    return RetryPolicy(
        attempts=retries + 1, base_delay_s=base,
        stall_timeout_s=stall_timeout(),
    )


def retry_call(
    fn: Callable[[], T],
    *,
    site: str,
    telemetry=None,
    policy: Optional[RetryPolicy] = None,
    logger=None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """``fn()`` with up to ``policy.attempts`` tries.

    Each RECOVERED failure (one that a later attempt follows) increments the
    ``io.retries{site=}`` counter and the module :data:`RETRY_TOTALS`; the
    final failure re-raises untouched, so callers see the real error with
    its real traceback.  InjectedIOError from the fault plan is an OSError
    and retries like any other transient fault — that is the point.
    """
    import threading

    from photon_tpu_torch.fault.watchdog import (
        IOStallTimeoutError,
        call_with_timeout,
        complete,
        heartbeat,
    )

    policy = policy or default_policy()
    t = telemetry or NULL_SESSION
    rng = random.Random()
    attempt = 0
    # Per-CALL heartbeat identity (site + calling thread): concurrent
    # IO-pool workers share a site name, and a per-site key would let one
    # worker's completion retire the mark while another worker of the same
    # site is still wedged — hiding that hang from the watchdog.
    site_key = f"io.{site}@t{threading.get_ident()}"
    try:
        while True:
            try:
                # Every attempt is watchdog-visible progress (retired once
                # the call sequence ends — on ANY exit, including
                # non-retriable errors; silence from finished IO is not a
                # stall); with a stall timeout the attempt runs on a
                # guarded worker thread and a hang escalates to a
                # retriable timeout (the retry/timeout/backoff triangle).
                heartbeat(site_key)
                if policy.stall_timeout_s > 0:
                    # The per-attempt budget DOUBLES each retry: a wedged
                    # call is abandoned fast, while IO legitimately slower
                    # than the configured timeout earns enough budget to
                    # finish before the attempts run out (1x, 2x, 4x, ...).
                    return call_with_timeout(
                        fn, policy.stall_timeout_s * (2.0 ** attempt),
                        site=site,
                    )
                return fn()
            except policy.retry_on as e:
                if isinstance(e, IOStallTimeoutError):
                    t.counter("io.stall_timeouts", site=site).inc()
                if attempt >= policy.attempts - 1:
                    raise
                t.counter("io.retries", site=site).inc()
                RETRY_TOTALS[site] += 1
                delay = policy.delay(attempt, rng)
                if logger is not None:
                    logger.info(
                        "retrying %s after %s: %s (attempt %d/%d, "
                        "backoff %.3fs)",
                        site, type(e).__name__, e, attempt + 2,
                        policy.attempts, delay,
                    )
                if delay > 0:
                    sleep(delay)
                attempt += 1
    finally:
        complete(site_key)
