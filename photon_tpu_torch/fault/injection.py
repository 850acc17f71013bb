"""Deterministic fault injection for recovery-path testing.

A copy of ``photon_tpu/fault/injection.py``.

The reference inherits Spark's failure story: lineage re-computation plus
driver-log archaeology, exercised in production only when something actually
breaks.  This module makes failure a first-class, *testable* input instead:
a :class:`FaultPlan` — seedable, parsed from ``PHOTON_FAULTS`` or a driver's
``--faults`` flag — fires injected faults at named sites threaded through
the IO and training stack, so CI can prove the retry/checkpoint/quarantine
paths work rather than hoping they do (SURVEY.md §5 'Failure detection').

Spec grammar (comma-separated rules; tokens within a rule are colon-
separated; the first two tokens name the site, the rest are ``k=v`` params):

    PHOTON_FAULTS="io:read:p=0.3,descent:kill:iter=2,solve:nan:coord=per_item"

Sites and their actions:

- ``io:read`` / ``io:write`` — raise :class:`InjectedIOError` (an
  ``OSError``, so the retry layer treats it like any transient storage
  failure) at guarded read/write call sites.  Params: ``p`` (per-call fire
  probability, default 1.0), ``times`` (max fires, default unlimited).
- ``descent:kill`` — raise :class:`InjectedKillError` at the top of a GAME
  outer iteration, simulating a preempted process between iterations.
  Params: ``iter`` (fire when the iteration counter equals this), ``times``
  (default 1).  ``stream:kill`` is the streamed-GLM analog (top of an
  L-BFGS host-loop iteration).
- ``checkpoint:write`` — raise :class:`InjectedKillError` in the middle of
  a checkpoint write (after payload files, before the manifest/publish),
  the torn-write window the atomic protocol must survive.  Under the async
  publisher this site fires ON THE PUBLISHER THREAD and the failure
  surfaces at the training loop's next save (or final drain).  Params:
  ``times`` (default 1), ``p``.
- ``checkpoint:stage`` — raise :class:`InjectedKillError` at the start of a
  checkpoint's d2h staging step (before anything is written), the other
  async-publish kill window: the previously published checkpoint must stay
  the loadable LATEST.  Params: ``iter``, ``times`` (default 1), ``p``.
- ``solve:nan`` — corrupt a coordinate's solve output with NaNs (consumed
  via :func:`consume_nan_injection`, which returns True instead of
  raising).  Params: ``coord`` (coordinate name, or ``*`` for any),
  ``times`` (default 1).
- ``preempt`` — simulate a preemption WARNING (SIGTERM from a spot/
  preemptible scheduler): sets the process-wide preemption flag
  (:mod:`photon_tpu_torch.fault.preemption`) at the top of a training-loop
  iteration instead of raising, so the loop checkpoints and exits with
  the preemption exit code exactly as under a real signal.  Params:
  ``iter`` (fire when the loop's iteration counter equals this),
  ``times`` (default 1).  A single-token site: the spec is
  ``preempt:iter=2`` — the parser treats a rule whose second token is a
  ``k=v`` pair as scope-only.

Determinism: every rule owns a ``random.Random`` seeded by
``(seed, site, rule index)`` — for a serial sequence of calls, the same
spec + seed fires at the same call positions on every run
(``PHOTON_FAULTS_SEED``, default 0).  When a fault site runs on concurrent
IO-pool workers (e.g. pooled native decodes), the SET of draws is still
seeded but their assignment to files follows thread scheduling — assert on
aggregate fire/retry counts there, not on which file faulted.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
from typing import Dict, Optional


class InjectedFaultError(Exception):
    """Marker base so tests/drivers can recognize injected faults."""


class InjectedIOError(OSError, InjectedFaultError):
    """An injected transient IO failure (retriable: it IS an OSError)."""


class InjectedKillError(RuntimeError, InjectedFaultError):
    """An injected process kill (not retriable; propagates out of the run
    like a preemption would, so the telemetry error-report and checkpoint
    recovery paths see exactly what a real kill leaves behind)."""


# The ONE registry of fault-site names consumed anywhere in the codebase,
# mapping site -> one-line behavior summary.  tests/test_fault_sites.py
# enforces the hygiene contract: every site consumed in code appears here,
# every registered site is documented in README's fault-site table, and
# every registered site is exercised by at least one test — a new site
# cannot land silently untested or undocumented.
KNOWN_FAULT_SITES = {
    "io:read": "transient IOError at guarded data/model reads (retriable)",
    "io:write": "transient IOError at guarded artifact writes (retriable)",
    "descent:kill": "process kill at the top of a GAME outer iteration",
    "stream:kill": "process kill at the top of a streamed L-BFGS iteration",
    "checkpoint:read": "transient IOError inside a checkpoint load "
                       "(retriable)",
    "checkpoint:write": "kill inside the checkpoint torn-write window "
                        "(payload written, manifest/publish not)",
    "checkpoint:stage": "kill at the start of checkpoint d2h staging",
    "solve:nan": "NaN-corrupt a named coordinate's solve output "
                 "(quarantine path)",
    "preempt": "set the preemption flag at a loop iteration boundary "
               "(checkpoint-and-exit path, exit code 75)",
    "tile:read": "transient IOError reading a tile-store part file "
                 "(disk tier of out-of-core GAME; retriable)",
    "tile:write": "transient IOError inside a tile-store publish "
                  "(before the atomic rename; retriable — the previous "
                  "part file stays intact)",
    "serve:replica_kill": "kill a serving replica's scoring path (param "
                          "replica=<id> targets one; the fleet router "
                          "marks it dead and reroutes in-flight work)",
    "transport:read": "transient IOError at a serving-transport frame "
                      "read (retriable: the client reconnects and "
                      "resends — scoring is idempotent)",
    "replica:crash": "hard-exit a serving replica's backing runtime "
                     "(a subprocess child os._exit()s; a thread replica "
                     "latches dead mid-batch) — the supervisor detects "
                     "the crash and resurrects",
    "replica:hang": "wedge a serving replica's scoring path without "
                    "failing it (consumed, not raised: the batch/child "
                    "sleeps) — detection must come from the supervisor's "
                    "probe deadline, exactly like a real hang",
    "replica:spawn": "transient failure spawning/respawning a serving "
                     "replica (retriable: the supervisor retries with "
                     "capped exponential backoff)",
    "online:ingest": "transient IOError reading an append-feed part file "
                     "(online-learning ingest; retriable — the part stays "
                     "pending and re-reads with backoff)",
    "online:refresh:kill": "kill an online refresh between train and "
                           "publish: the restarted service resumes the "
                           "COMPLETED fit from its round checkpoint and "
                           "publishes without retraining",
}


@dataclasses.dataclass
class FaultRule:
    """One parsed rule of a fault plan, with its firing state."""

    site: str
    params: Dict[str, str]
    rng: random.Random
    fires: int = 0

    @property
    def probability(self) -> float:
        return float(self.params.get("p", 1.0))

    @property
    def max_fires(self) -> Optional[int]:
        if "times" in self.params:
            return int(self.params["times"])
        # Probabilistic IO rules default to unlimited; deterministic rules
        # (kill / nan / explicit-iteration) fire once unless told otherwise.
        return None if "p" in self.params else 1

    def matches(self, site: str, ctx: Dict[str, object]) -> bool:
        if site != self.site:
            return False
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if "iter" in self.params:
            if ctx.get("iteration") != int(self.params["iter"]):
                return False
        if "coord" in self.params and self.params["coord"] != "*":
            if ctx.get("coordinate") != self.params["coord"]:
                return False
        if "replica" in self.params and self.params["replica"] != "*":
            if str(ctx.get("replica")) != self.params["replica"]:
                return False
        return True

    def roll(self) -> bool:
        """Consume one deterministic draw; True when the rule fires."""
        p = self.probability
        fired = p >= 1.0 or self.rng.random() < p
        if fired:
            self.fires += 1
        return fired


class FaultPlan:
    """A parsed set of fault rules with deterministic firing state.

    Plans are stateful (``times`` caps, RNG streams): parse one per run.
    """

    def __init__(self, rules, seed: int = 0, spec: str = ""):
        self.rules = list(rules)
        self.seed = seed
        self.spec = spec
        # Fault sites run on IO-pool worker threads too (native decode,
        # streamed chunk loads): the match→roll sequence mutates rule state
        # (fire caps, RNG draws) and must be atomic or `times=` caps
        # overshoot and the seeded fire sequence stops being deterministic.
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        rules = []
        for i, raw in enumerate(t for t in spec.split(",") if t.strip()):
            tokens = raw.strip().split(":")
            if len(tokens) < 2:
                raise ValueError(
                    f"bad fault rule {raw!r}: want scope:action[:k=v...] "
                    "or scope:k=v[...]"
                )
            # The site name is every leading token that is not a ``k=v``
            # parameter: one token (``preempt:iter=2``), the common two
            # (``io:read:p=0.3``), or three (``online:refresh:kill:iter=0``).
            # A 3+-token site must be REGISTERED — otherwise a mistyped
            # parameter (``io:read:oops``) would silently become part of a
            # site name nothing ever consumes.
            end = 1
            while end < len(tokens) and "=" not in tokens[end]:
                end += 1
            site = ":".join(t.strip() for t in tokens[:end])
            if end > 2 and site not in KNOWN_FAULT_SITES:
                raise ValueError(
                    f"bad fault param {tokens[2]!r} in rule {raw!r} "
                    "(want k=v)"
                )
            param_tokens = tokens[end:]
            params = {}
            for tok in param_tokens:
                k, sep, v = tok.partition("=")
                if not sep:
                    raise ValueError(
                        f"bad fault param {tok!r} in rule {raw!r} (want k=v)"
                    )
                params[k.strip()] = v.strip()
            rules.append(
                FaultRule(site, params, random.Random(f"{seed}:{site}:{i}"))
            )
        return cls(rules, seed=seed, spec=spec)

    def consume(self, site: str, **ctx) -> Optional[FaultRule]:
        """The first matching rule that fires for this call, else None."""
        with self._lock:
            for rule in self.rules:
                if rule.matches(site, ctx) and rule.roll():
                    return rule
            return None


# -- active-plan management --------------------------------------------------
#
# One process-wide plan: drivers install from --faults, tests via set_plan,
# and the env var PHOTON_FAULTS covers subprocesses (the plan re-parses only
# when the spec string changes, so the per-call cost with no plan is one
# os.environ.get).

_ENV_VAR = "PHOTON_FAULTS"
_SEED_VAR = "PHOTON_FAULTS_SEED"
_active: Optional[FaultPlan] = None
_env_cache: tuple = ("", 0, None)


def set_plan(plan: Optional[FaultPlan]) -> None:
    """Install (or clear, with None) the process-wide fault plan.  An
    installed plan takes precedence over ``PHOTON_FAULTS``."""
    global _active
    _active = plan


def reset_env_plan() -> None:
    """Drop the cached env-var plan so the next :func:`active_plan` call
    re-parses ``PHOTON_FAULTS`` with fresh rule state (fire caps, RNG
    streams).  Drivers call this at run start: an env plan is scoped per
    run, not per process lifetime."""
    global _env_cache
    _env_cache = ("", 0, None)


def install_from_args(args) -> None:
    """Driver hook: ``--faults SPEC`` (with ``--faults-seed``) overrides the
    env var for this process; without the flag, any env-var plan restarts
    fresh for this run."""
    spec = getattr(args, "faults", None)
    if spec:
        set_plan(FaultPlan.parse(spec, seed=getattr(args, "faults_seed", 0)))
    else:
        reset_env_plan()


def active_plan() -> Optional[FaultPlan]:
    global _env_cache
    if _active is not None:
        return _active
    spec = os.environ.get(_ENV_VAR, "").strip()
    if not spec:
        return None
    seed = int(os.environ.get(_SEED_VAR, "0") or "0")
    if _env_cache[0] != spec or _env_cache[1] != seed:
        _env_cache = (spec, seed, FaultPlan.parse(spec, seed=seed))
    return _env_cache[2]


def fault_point(site: str, **ctx) -> None:
    """Declare an injectable fault site.  No-op without an active plan;
    raises the site's error type when a rule fires.

    ``io:*`` and ``checkpoint:read`` sites raise :class:`InjectedIOError`
    (retriable); ``*:kill``, ``checkpoint:write``, and ``checkpoint:stage``
    raise :class:`InjectedKillError` (fatal — the atomic-write/
    checkpoint-resume machinery, not a retry loop, must absorb these).
    """
    plan = active_plan()
    if plan is None:
        return
    rule = plan.consume(site, **ctx)
    if rule is None:
        return
    scope, _, action = site.partition(":")
    if action.endswith(("kill", "crash")) or site in ("checkpoint:write",
                                                      "checkpoint:stage"):
        raise InjectedKillError(f"injected kill at {site} ({ctx or rule.params})")
    raise InjectedIOError(f"injected IO fault at {site} ({ctx or rule.params})")


def consume_nan_injection(coordinate: Optional[str]) -> bool:
    """True when the plan wants this coordinate's next solve corrupted with
    NaNs (``solve:nan:coord=<name>``); consumes one fire."""
    plan = active_plan()
    if plan is None or coordinate is None:
        return False
    return plan.consume("solve:nan", coordinate=coordinate) is not None


def consume_hang_injection(replica: Optional[str]) -> bool:
    """True when the plan wants this serving replica's path to WEDGE (site
    ``replica:hang:replica=<id>`` — the probe-timeout leg): the consumer
    simulates the hang (a wedged batch, a sleeping child) instead of
    raising, so detection has to come from the supervisor's probe deadline
    exactly as it would for a real hang; consumes one fire."""
    plan = active_plan()
    if plan is None or replica is None:
        return False
    return plan.consume("replica:hang", replica=str(replica)) is not None
