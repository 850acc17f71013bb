"""Online learning: continual training with zero-downtime model refresh.

Counterpart of ``photon_tpu/online/``: an append-only feed drains into
in-place device-data growth, a warm-started partial coordinate-descent
refresh, and a canary-gated fleet publish.  See
:mod:`photon_tpu_torch.online.service` for the loop, :mod:`~.feed` for the
sources, :mod:`~.delta` for the touched-coordinate/entity computation.
"""

from photon_tpu_torch.online.delta import (
    BatchDelta,
    CoordinateDelta,
    compute_delta,
    merge_append,
    merge_deltas,
    missing_key,
    missing_mask,
)
from photon_tpu_torch.online.feed import AppendBatch, DirectoryFeed, QueueFeed
from photon_tpu_torch.online.service import (
    OnlineLearningService,
    RefreshPolicy,
    RefreshResult,
)

__all__ = [
    "AppendBatch",
    "BatchDelta",
    "CoordinateDelta",
    "DirectoryFeed",
    "OnlineLearningService",
    "QueueFeed",
    "RefreshPolicy",
    "RefreshResult",
    "compute_delta",
    "merge_append",
    "merge_deltas",
    "missing_key",
    "missing_mask",
]
