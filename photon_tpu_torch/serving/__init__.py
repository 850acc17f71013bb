"""Online GAME scoring: device-resident tables, one CUDA graph per bucket.

Counterpart of ``photon_tpu/serving``, in-process on one card:

- :class:`~photon_tpu_torch.serving.scorer.GameScorer` loads a GAME model
  once into tables on the device and keeps one captured program (a CUDA
  graph on the card) per bucket of a power-of-two batch ladder; after
  :meth:`~GameScorer.warmup` nothing captures again.
- :class:`~photon_tpu_torch.serving.batcher.RequestBatcher` coalesces
  concurrent requests on a thread under a max-delay/max-batch window.
- :class:`~photon_tpu_torch.serving.fleet.ServingFleet` puts N scorer
  replicas behind the deadline-aware
  :class:`~photon_tpu_torch.serving.router.FleetRouter`, with canary
  rollout and rollback; :mod:`~photon_tpu_torch.serving.traffic` generates
  the seeded traffic it is driven with.

The subprocess replicas, the supervisor, the socket transport, the arena
and the observability plane wait in ROADMAP.md queue 1, item 7.
"""

from photon_tpu_torch.serving.batcher import (  # noqa: F401
    RequestBatcher,
    resolve_once,
    run_closed_loop,
)
from photon_tpu_torch.serving.fleet import ServingFleet  # noqa: F401
from photon_tpu_torch.serving.router import (  # noqa: F401
    AdmissionPolicy,
    FleetRouter,
    NoHealthyReplicaError,
    ReplicaDeadError,
    RequestShedError,
    RolloutParityError,
    ScorerReplica,
    host_score_request,
    parity_worst,
)
from photon_tpu_torch.serving.scorer import (  # noqa: F401
    GameScorer,
    ScoringRequest,
    ShardSpec,
    bucket_ladder,
    build_requests,
    concat_requests,
    padded_cost,
    request_from_dataset,
    request_spec_for_dataset,
    request_spec_for_model,
    request_windows,
    slice_request,
)
from photon_tpu_torch.serving.traffic import (  # noqa: F401
    Outcome,
    Traffic,
    TrafficSpec,
    generate_traffic,
    geometric_sizes,
    replay_open_loop,
    run_closed_loop_outcomes,
)
