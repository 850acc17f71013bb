"""Seeded traffic generation + replay for the serving fleet bench/driver.

A copy of ``photon_tpu/serving/traffic.py``: the same seed gives the same
request stream.  A seeded GEOMETRIC request-size stream over consecutive
row windows is a fine microbench arrival model and nothing like production
traffic.  This module generates the replayable traffic the
fleet tier is measured under (1612.01437's framing: at scale, the system
overheads around the math dominate — so the bench must model the traffic
that creates them):

- **Power-law entity popularity.**  Each request belongs to one entity
  ("user") drawn from a seeded Zipf-like distribution over the dataset's
  entity vocabulary (rank weight ``(rank+1)^-alpha``); its rows are that
  entity's dataset rows, resampled to the request size.  Hot entities
  dominate exactly the way production key distributions do.
- **Diurnal ramp.**  Arrival times follow a shaped intensity over the
  replay horizon (``1 + amplitude·sin²(π·t/T)`` — trough at the edges,
  peak mid-replay), so offered load sweeps through the fleet's saturation
  point instead of holding one rate.
- **Cold-start storm.**  A contiguous segment of requests whose entity
  keys are OUTSIDE every coordinate's vocabulary, arriving in a burst —
  the new-user stampede that must ride the serving zero-row fallback
  (``serving.cold_entities``) without recompiling or shedding the world.

``popularity="geometric"`` reproduces the geometric stream exactly (sizes from
:func:`photon_tpu_torch.drivers.serve_game.request_sizes`, consecutive row
windows) so the old distribution stays available for bench continuity
(``serve_game --traffic geometric``).

Replay: :func:`replay_open_loop` submits on the generated schedule (the
offered-load model — sheds and deadline misses are the system's problem),
:func:`run_closed_loop_outcomes` drives concurrent closed-loop clients
(the capacity-measurement model).  Both return per-request
:class:`Outcome` records instead of raising on sheds.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from concurrent.futures import wait as futures_wait
from typing import Callable, Dict, List, Optional

import numpy as np

from photon_tpu_torch.serving.router import RequestShedError
from photon_tpu_torch.serving.scorer import ScoringRequest, request_from_dataset


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """One replayable traffic shape (fully determined by its fields +
    the dataset/model it is generated against)."""

    requests: int = 256
    mean_rows: float = 8.0
    max_rows: int = 64
    popularity: str = "powerlaw"  # "powerlaw" | "geometric"
    alpha: float = 1.1  # popularity exponent (rank^-alpha)
    ramp: str = "diurnal"  # "diurnal" | "flat"
    ramp_amplitude: float = 1.0  # peak rate = (1 + amplitude) x trough
    storm_frac: float = 0.0  # fraction of requests in the cold-start storm
    storm_at: float = 0.6  # storm segment start (fraction of the stream)
    target_qps: Optional[float] = None  # None = no arrival schedule
    deadline_ms: Optional[float] = None  # per-request budget (None = none)
    seed: int = 0
    # A/B experiment splits over a multi-model fleet: arm (tenant model
    # id) -> weight.  Each request's USER hashes to one arm —
    # hash(seed:user) → [0,1) against the cumulative weights — so an
    # entity sees one consistent model for the whole replay, assignment is
    # deterministic under the seed, and the split never perturbs the rng
    # stream (the byte-exactness contract).  None = no splits.
    splits: Optional[Dict[str, float]] = None


def split_arm_for(seed: int, user_key, splits: Dict[str, float]) -> str:
    """Deterministic hash-of-user arm assignment: the same (seed, user)
    always lands the same arm, independent of request order and of every
    other draw — re-running a replay reproduces the experiment exactly."""
    if not splits:
        raise ValueError("split_arm_for needs a non-empty splits map")
    digest = hashlib.md5(f"{seed}:{user_key}".encode()).hexdigest()
    u = int(digest, 16) / float(1 << 128)
    total = float(sum(splits.values()))
    if total <= 0:
        raise ValueError("split weights must sum to a positive value")
    acc = 0.0
    for arm, weight in splits.items():
        acc += float(weight) / total
        if u < acc:
            return arm
    return arm  # float-roundoff tail lands in the last arm


@dataclasses.dataclass(frozen=True)
class TimedRequest:
    at_s: float
    request: ScoringRequest
    deadline_s: Optional[float]
    kind: str  # "normal" | "storm"
    arm: Optional[str] = None  # split arm (tenant model id), None = unsplit


@dataclasses.dataclass(frozen=True)
class Traffic:
    items: List[TimedRequest]
    spec: TrafficSpec
    duration_s: float

    @property
    def requests(self) -> List[ScoringRequest]:
        return [item.request for item in self.items]


@dataclasses.dataclass
class Outcome:
    """What happened to one replayed request.  ``finished_at_s`` is the
    completion time relative to the replay's start — the windowed-QPS
    measurements (outage/recovery analysis in the chaos bench) cut on it."""

    status: str  # "ok" | "shed" | "error"
    scores: Optional[np.ndarray]
    latency_s: Optional[float]
    item: TimedRequest
    reason: str = ""
    finished_at_s: Optional[float] = None


def _take_request(whole: ScoringRequest, rows: np.ndarray) -> ScoringRequest:
    def take(leaf):
        if isinstance(leaf, tuple):
            return tuple(a[rows] for a in leaf)
        return leaf[rows]

    return ScoringRequest(
        features={k: take(v) for k, v in whole.features.items()},
        entity_ids={k: v[rows] for k, v in whole.entity_ids.items()},
        offset=None if whole.offset is None else whole.offset[rows],
    )


def _unknown_keys(vocab: np.ndarray, n: int, salt: int) -> np.ndarray:
    """``n`` keys guaranteed OUTSIDE ``vocab`` (the cold-start identities),
    deterministic per salt so a regenerated traffic matches."""
    if vocab.dtype.kind in "iu":
        base = (int(vocab.max()) + 1 if len(vocab) else 0) + salt * n
        return np.arange(base, base + n, dtype=vocab.dtype)
    return np.asarray([f"zz-cold-{salt}-{i}" for i in range(n)])


def geometric_sizes(n_requests: int, mean: float, cap: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Long-tailed request-size draw (geometric, clipped to ``[1, cap]``)
    — THE size distribution, shared with
    :func:`photon_tpu_torch.drivers.serve_game.request_sizes` so the measured
    arrival pattern is the served one.  MUST stay the first draw on a
    freshly seeded ``rng``: that is what keeps ``--traffic geometric``
    byte-exact with the geometric stream (pinned by test)."""
    p = min(1.0, max(1.0 / max(mean, 1.0), 1e-6))
    return np.clip(rng.geometric(p, size=n_requests), 1, max(1, cap))


def _arrival_times(n: int, duration_s: float, spec: TrafficSpec) -> np.ndarray:
    """Request arrival offsets over ``[0, duration_s]`` shaped by the ramp:
    inverse-CDF placement against the intensity profile, so request density
    follows the diurnal curve deterministically."""
    if spec.ramp == "flat" or spec.ramp_amplitude <= 0:
        return np.linspace(0.0, duration_s, n, endpoint=False)
    grid = np.linspace(0.0, 1.0, 1025)
    intensity = 1.0 + spec.ramp_amplitude * np.sin(np.pi * grid) ** 2
    cdf = np.concatenate([[0.0], np.cumsum(
        (intensity[1:] + intensity[:-1]) * 0.5 * np.diff(grid)
    )])
    cdf /= cdf[-1]
    quantiles = (np.arange(n) + 0.5) / n
    return np.interp(quantiles, cdf, grid) * duration_s


def generate_traffic(data, model, spec: TrafficSpec) -> Traffic:
    """Deterministic (seeded) replayable traffic over one dataset+model."""
    from photon_tpu_torch.game.model import RandomEffectModel

    rng = np.random.default_rng(spec.seed)
    n = int(spec.requests)
    whole = request_from_dataset(data, model)
    n_rows = data.num_examples

    sizes = geometric_sizes(n, spec.mean_rows, spec.max_rows, rng)

    user_keys: List[object] = list(range(n))  # split-arm hash identities
    if spec.popularity == "geometric":
        # The geometric stream: consecutive row windows.
        row_sets = []
        pos = 0
        for size in sizes:
            row_sets.append(np.arange(pos, pos + int(size)) % n_rows)
            pos = (pos + int(size)) % n_rows
    elif spec.popularity == "powerlaw":
        random_coords = [
            c for c in model.coordinates.values()
            if isinstance(c, RandomEffectModel)
        ]
        if not random_coords:
            raise ValueError(
                "powerlaw traffic needs a random-effect coordinate to "
                "define entity popularity; use popularity='geometric'"
            )
        col = random_coords[0].entity_column
        uniq, inv = np.unique(data.id_columns[col], return_inverse=True)
        order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=len(uniq))
        starts = np.concatenate([[0], np.cumsum(counts)])
        # Popularity rank is a seeded permutation of the vocabulary (which
        # entity is "hot" is random; HOW hot follows the power law).
        rank_of = rng.permutation(len(uniq))
        weights = (rank_of + 1.0) ** -spec.alpha
        weights /= weights.sum()
        entities = rng.choice(len(uniq), size=n, p=weights)
        # The request's USER is its drawn entity — the split-arm identity
        # (cold-start storms keep the original user: a stormed request is
        # still that user's traffic, just with unseen ids).
        user_keys = [uniq[e] for e in entities]
        row_sets = []
        for e, size in zip(entities, sizes):
            mine = order[starts[e]: starts[e + 1]]
            row_sets.append(rng.choice(mine, size=int(size), replace=True))
    else:
        raise ValueError(f"unknown popularity model {spec.popularity!r}")

    storm_n = int(round(spec.storm_frac * n))
    storm_lo = min(int(spec.storm_at * n), n - storm_n)
    storm = set(range(storm_lo, storm_lo + storm_n))

    vocabs = {
        c.entity_column: np.asarray(c.keys)
        for c in model.coordinates.values()
        if isinstance(c, RandomEffectModel)
    }
    requests: List[ScoringRequest] = []
    for i, rows in enumerate(row_sets):
        req = _take_request(whole, rows)
        if i in storm:
            # Cold-start identities: every id column swapped for keys no
            # coordinate has seen — the zero-row fallback path.
            req = ScoringRequest(
                features=req.features,
                entity_ids={
                    col: _unknown_keys(vocabs.get(col, keys), len(keys), i)
                    for col, keys in req.entity_ids.items()
                },
                offset=req.offset,
            )
        requests.append(req)

    arms: List[Optional[str]] = [None] * n
    if spec.splits:
        # Arm assignment AFTER every rng draw (pure hashing — the rng
        # stream stays byte-exact with unsplit traffic); stamping replaces
        # the frozen request with one routed at its arm's tenant model.
        for i in range(n):
            arms[i] = split_arm_for(spec.seed, user_keys[i], spec.splits)
            requests[i] = dataclasses.replace(requests[i], model=arms[i])

    if spec.target_qps:
        duration = n / float(spec.target_qps)
        at = _arrival_times(n, duration, spec)
        if storm_n:
            # The storm arrives as a BURST: its segment compresses to a
            # quarter of its scheduled span, anchored at the segment start.
            lo, hi = storm_lo, storm_lo + storm_n
            span = at[hi - 1] - at[lo] if hi - 1 > lo else 0.0
            at = at.copy()
            at[lo:hi] = at[lo] + np.linspace(0.0, span * 0.25, hi - lo)
            at = np.maximum.accumulate(at)
    else:
        duration = 0.0
        at = np.zeros(n)

    deadline_s = None if spec.deadline_ms is None else spec.deadline_ms / 1e3
    items = [
        TimedRequest(
            at_s=float(at[i]), request=requests[i], deadline_s=deadline_s,
            kind="storm" if i in storm else "normal", arm=arms[i],
        )
        for i in range(n)
    ]
    return Traffic(items=items, spec=spec, duration_s=float(duration))


# -- replay ------------------------------------------------------------------

def replay_open_loop(
    submit: Callable[..., "object"],
    traffic: Traffic,
    speed: float = 1.0,
    timeout_s: float = 120.0,
) -> List[Outcome]:
    """OPEN-loop replay: submit each request at its scheduled arrival time
    regardless of completions (the offered-load model — queueing and
    shedding are the system's problem, not the generator's).  ``submit``
    is ``router/fleet.submit(request, deadline_s=...)``; a synchronous
    :class:`RequestShedError` (admission fast-fail) becomes a ``shed``
    outcome.  Latency is measured submit→resolve via done-callbacks."""
    items = traffic.items
    outcomes: List[Optional[Outcome]] = [None] * len(items)
    futures = []
    start = time.monotonic()
    for i, item in enumerate(items):
        delay = start + item.at_s / speed - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        t0 = time.monotonic()
        try:
            fut = submit(item.request, deadline_s=item.deadline_s)
        except RequestShedError as e:
            outcomes[i] = Outcome("shed", None, None, item, e.reason,
                                  finished_at_s=t0 - start)
            continue

        def _collect(fut, i=i, item=item, t0=t0):
            now = time.monotonic()
            lat = now - t0
            try:
                outcomes[i] = Outcome("ok", fut.result(), lat, item,
                                      finished_at_s=now - start)
            except RequestShedError as e:
                outcomes[i] = Outcome("shed", None, lat, item, e.reason,
                                      finished_at_s=now - start)
            except BaseException as e:  # noqa: BLE001 — recorded, not raised
                outcomes[i] = Outcome(
                    "error", None, lat, item, f"{type(e).__name__}: {e}",
                    finished_at_s=now - start,
                )

        fut.add_done_callback(_collect)
        futures.append(fut)
    futures_wait(futures, timeout=timeout_s)
    for i, out in enumerate(outcomes):
        if out is None:
            outcomes[i] = Outcome("error", None, None, items[i], "timeout")
    return outcomes  # type: ignore[return-value]


def run_closed_loop_outcomes(
    score_fn_factory: Callable[[int], Callable[[TimedRequest], np.ndarray]],
    items: List[TimedRequest],
    clients: int = 4,
):
    """CLOSED-loop drive: ``clients`` workers, each scoring its next
    request only after the previous response lands (the capacity-
    measurement model).  ``score_fn_factory(tid)`` builds one synchronous
    scoring callable per worker — a router lambda, or one
    :class:`~photon_tpu_torch.serving.transport.ScoringClient` per thread (a
    client connection is a serial exchange stream).  Returns
    ``(outcomes, wall_s)`` with outcomes in request order."""
    outcomes: List[Optional[Outcome]] = [None] * len(items)
    clients = max(1, min(int(clients), len(items) or 1))

    start = time.monotonic()

    def worker(tid: int) -> None:
        fn = score_fn_factory(tid)
        for i in range(tid, len(items), clients):
            item = items[i]
            t0 = time.monotonic()
            try:
                scores = fn(item)
                outcomes[i] = Outcome(
                    "ok", scores, time.monotonic() - t0, item,
                    finished_at_s=time.monotonic() - start,
                )
            except RequestShedError as e:
                outcomes[i] = Outcome(
                    "shed", None, time.monotonic() - t0, item, e.reason,
                    finished_at_s=time.monotonic() - start,
                )
            except BaseException as e:  # noqa: BLE001 — recorded per request
                outcomes[i] = Outcome(
                    "error", None, time.monotonic() - t0, item,
                    f"{type(e).__name__}: {e}",
                    finished_at_s=time.monotonic() - start,
                )

    threads = [
        threading.Thread(target=worker, args=(t,), daemon=True)
        for t in range(clients)
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outcomes, time.monotonic() - t0
