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
- :mod:`~photon_tpu_torch.serving.transport` is the socket ingest
  (``fleet.serve()``, the reference's wire format byte for byte);
  ``ServingFleet(backend="subprocess")`` runs each replica as a child
  process (:mod:`~photon_tpu_torch.serving.replica_proc`: the shared model
  artifact, the frame protocol over loopback, one CUDA context a child);
  ``fleet.supervise()`` attaches the
  :class:`~photon_tpu_torch.serving.supervisor.ReplicaSupervisor` (health
  probes, lease membership, canary-gated resurrection, flap quarantine);
  :mod:`~photon_tpu_torch.serving.netfault` injects seeded network faults
  into the children's sockets.

The observability plane waits in ROADMAP.md queue 1, item 7.4, and the
multi-model arena in item 7.5.
"""

from photon_tpu_torch.serving.batcher import (  # noqa: F401
    RequestBatcher,
    resolve_once,
    run_closed_loop,
)
from photon_tpu_torch.serving.fleet import (  # noqa: F401
    ReplicaRebuildError,
    ServingFleet,
    is_capacity_refusal,
    probe_request_for,
)
from photon_tpu_torch.serving.replica_proc import (  # noqa: F401
    ModelStore,
    ReplicaSpawnError,
    SubprocessReplica,
    load_model_artifact,
    save_model_artifact,
)
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
from photon_tpu_torch.serving.supervisor import (  # noqa: F401
    RejoinParityError,
    ReplicaSupervisor,
    SupervisorPolicy,
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
from photon_tpu_torch.serving.transport import (  # noqa: F401
    AsyncScoringClient,
    ScoringClient,
    ScoringServer,
    TransportError,
)
