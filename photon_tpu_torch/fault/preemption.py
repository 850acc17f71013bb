"""Preemption-aware shutdown: turn SIGTERM into one last checkpoint.

A copy of ``photon_tpu/fault/preemption.py``.

Preemptible/spot capacity does not crash — it WARNS: the scheduler sends
SIGTERM and gives the process a grace window before SIGKILL.  The reference
rides Spark's driver re-submission and loses the in-flight work; here the
warning is converted into a clean iteration-boundary exit:

1. A signal handler (installed by the drivers under ``--on-preempt
   checkpoint``, the default) sets a process-wide flag — signal-safe: the
   handler does nothing but record the request.
2. The training loops (GAME coordinate descent and the streamed-GLM
   L-BFGS host loop) poll :func:`preemption_requested` at their iteration
   boundaries — the exact points where the checkpoint state is consistent —
   force a final synchronous save through the existing ``AsyncPublisher``
   drain, and raise :class:`PreemptedError`.
3. The driver maps :class:`PreemptedError` to the distinct exit code
   :data:`PREEMPTED_EXIT_CODE` (75, ``EX_TEMPFAIL``: "try again later" —
   schedulers and wrappers can tell a preemption from a crash), after the
   telemetry run report is finalized with status ``preempted``.

``--on-preempt ignore`` leaves the default signal behavior untouched
(SIGTERM kills mid-iteration; the atomic checkpoint protocol still
guarantees the previous published checkpoint survives — preemption
handling narrows the loss window from one iteration to zero).

CI-testability: the ``preempt`` fault site (``--faults preempt:iter=k``)
sets the same flag at the top of loop iteration ``k`` — no signals
involved, so the full preempt → final-save → exit-code → resume-parity
path runs as an ordinary deterministic test.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

# EX_TEMPFAIL: the conventional "transient, retry me" exit status — distinct
# from 1 (crash) so run wrappers can resubmit preempted runs automatically.
PREEMPTED_EXIT_CODE = 75

_requested = threading.Event()
_reason: Optional[str] = None


class PreemptedError(RuntimeError):
    """The run stopped at an iteration boundary because preemption was
    requested (SIGTERM/SIGINT under ``--on-preempt checkpoint``, or the
    injected ``preempt`` fault site).  The last completed iteration's
    checkpoint is published by the time this propagates; the driver exits
    with :data:`PREEMPTED_EXIT_CODE`."""


def request_preemption(reason: str = "signal") -> None:
    """Record a preemption request (signal-safe: sets a flag, nothing
    else).  The training loops act on it at their next iteration
    boundary."""
    global _reason
    _reason = reason
    _requested.set()


def preemption_requested() -> bool:
    return _requested.is_set()


def preemption_reason() -> Optional[str]:
    return _reason


def clear_preemption() -> None:
    """Reset the flag (run scoped: drivers clear on entry so one run's
    late signal cannot preempt the next run in the same process)."""
    global _reason
    _reason = None
    _requested.clear()


def consume_preempt_injection(iteration: int) -> None:
    """The CI face of preemption: when the active fault plan has a
    ``preempt`` rule matching this iteration (``--faults preempt:iter=k``),
    set the preemption flag exactly as the signal handler would."""
    from photon_tpu_torch.fault.injection import active_plan

    plan = active_plan()
    if plan is not None and plan.consume(
        "preempt", iteration=iteration
    ) is not None:
        request_preemption(f"injected at iteration {iteration}")


class PreemptionHandler:
    """Context manager installing SIGTERM/SIGINT handlers that set the
    preemption flag; previous handlers are restored on exit.

    Installation is a no-op off the main thread (Python only allows signal
    handlers there — e.g. drivers invoked from a test worker thread) and
    under ``mode='ignore'``.  The flag is cleared on entry either way, so
    every run starts un-preempted.

    Only drivers whose loops actually POLL the flag install this (the
    ``preemptible`` gate in ``drivers.common.telemetry_run``): a handler
    that swallows SIGINT in a driver nothing ever polls would make that
    driver uninterruptible.  A SECOND signal is the operator insisting:
    the previous handlers are restored and the signal re-raised, so a
    double Ctrl-C always behaves like stock Python even mid-phase (data
    load, compile) before the first boundary check runs.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, mode: str = "checkpoint", logger=None):
        if mode not in ("checkpoint", "ignore"):
            raise ValueError(
                f"--on-preempt must be 'checkpoint' or 'ignore', got {mode!r}"
            )
        self.mode = mode
        self.logger = logger
        self._previous: dict = {}

    def _handle(self, signum, frame):
        del frame
        if preemption_requested():
            # Second signal: stop being polite — restore the previous
            # handlers and deliver this signal through them (default
            # SIGTERM terminates, default SIGINT raises
            # KeyboardInterrupt).
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._previous.clear()
            signal.raise_signal(signum)
            return
        request_preemption(signal.Signals(signum).name)
        if self.logger is not None:
            self.logger.info(
                "%s received: will checkpoint and exit at the next "
                "iteration boundary (signal again to stop immediately)",
                signal.Signals(signum).name,
            )

    def __enter__(self) -> "PreemptionHandler":
        clear_preemption()
        if (self.mode == "checkpoint"
                and threading.current_thread() is threading.main_thread()):
            for sig in self.SIGNALS:
                self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        clear_preemption()
