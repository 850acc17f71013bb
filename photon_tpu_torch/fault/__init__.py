"""Fault tolerance: checkpoints and resume, fault injection, retry with
backoff, preemption and the watchdog.

Counterparts of ``photon_tpu/fault/`` (the port imports nothing of the JAX
package):

- :mod:`photon_tpu_torch.fault.checkpoint` — per-outer-iteration descent
  checkpoints (atomic, versioned, manifest-hashed, the reference's format)
  and resume; the staged device-to-host copy and the async publisher.
- :mod:`photon_tpu_torch.fault.injection` — deterministic, seedable
  :class:`FaultPlan` (``PHOTON_FAULTS`` / ``--faults``) injecting IO errors,
  kills and preemptions at named sites, so the recovery paths are testable.
- :mod:`photon_tpu_torch.fault.retry` — jittered, capped, telemetry-counted
  exponential backoff around guarded IO.
- :mod:`photon_tpu_torch.fault.atomic` — temp + fsync + rename publication
  and content-hash manifests (a copy).
- :mod:`photon_tpu_torch.fault.preemption` — SIGTERM/SIGINT -> checkpoint at
  the next iteration boundary -> exit code 75 (a copy).
- :mod:`photon_tpu_torch.fault.watchdog` — heartbeats and the guarded-IO
  timeout.

:class:`QuarantineBudgetError` is raised by the descent loop when more
non-finite solves or score rows were quarantined than ``--max-quarantined``
allows.
"""

from photon_tpu_torch.fault.atomic import (  # noqa: F401
    CorruptArtifactError,
    atomic_dir,
    atomic_write_bytes,
    atomic_write_json,
    verify_manifest,
    write_manifest,
)
from photon_tpu_torch.fault.checkpoint import (  # noqa: F401
    AsyncPublisher,
    CheckpointError,
    DescentCheckpointer,
    DescentState,
    StreamCheckpointer,
    StreamState,
    has_published_checkpoint,
    resolve_checkpoint_async,
)
from photon_tpu_torch.fault.injection import (  # noqa: F401
    KNOWN_FAULT_SITES,
    FaultPlan,
    InjectedFaultError,
    InjectedIOError,
    InjectedKillError,
    active_plan,
    consume_nan_injection,
    fault_point,
    install_from_args,
    set_plan,
)
from photon_tpu_torch.fault.preemption import (  # noqa: F401
    PREEMPTED_EXIT_CODE,
    PreemptedError,
    PreemptionHandler,
    clear_preemption,
    consume_preempt_injection,
    preemption_requested,
    request_preemption,
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


class QuarantineBudgetError(RuntimeError):
    """More non-finite solves or score rows were quarantined than the
    ``--max-quarantined`` budget tolerates; the run fails loudly instead of
    silently training a mostly-frozen model."""
