"""Fault tolerance: fault injection, retry with backoff, the watchdog.

Host-only copies of ``photon_tpu/fault/{injection,retry,watchdog}.py`` (the
port imports nothing of the JAX package):

- :mod:`photon_tpu_torch.fault.injection` — deterministic, seedable
  :class:`FaultPlan` (``PHOTON_FAULTS``) injecting IO errors and replica
  kills at named sites, so the recovery paths are testable.
- :mod:`photon_tpu_torch.fault.retry` — jittered, capped, telemetry-counted
  exponential backoff around guarded IO.
- :mod:`photon_tpu_torch.fault.watchdog` — heartbeats and the guarded-IO
  timeout.

Checkpoints, atomic publication and preemption wait in ROADMAP.md queue 1,
item 6.
"""

from photon_tpu_torch.fault.injection import (  # noqa: F401
    KNOWN_FAULT_SITES,
    FaultPlan,
    InjectedFaultError,
    InjectedIOError,
    InjectedKillError,
    active_plan,
    fault_point,
    install_from_args,
    set_plan,
)
from photon_tpu_torch.fault.retry import (  # noqa: F401
    RETRY_TOTALS,
    RetryPolicy,
    default_policy,
    retry_call,
)
from photon_tpu_torch.fault.watchdog import (  # noqa: F401
    IOStallTimeoutError,
    Watchdog,
    call_with_timeout,
    heartbeat,
)
