"""Feature projection for random-effect solves.

A copy of ``photon_tpu/game/projection.py`` (numpy only; the imports
changed), so the random matrix is the reference's bit for bit.

Rebuild of the reference's projector stack (photon-api ``data/projectors``:
``IndexMapProjection``, ``RandomProjection``, ``ProjectionMatrix`` —
SURVEY.md §2.2 'Feature projection'): each entity sees only a sliver of the
shard's feature space, so its local solve can run in a much smaller
dimension.  The reference projects each entity's LocalDataset before the
local optimizer and maps coefficients back.

TPU-native shape: projection happens **per bucket** at dataset-build time so
every vmapped solve keeps a static shape:

- **index_map**: per-entity active-feature sets, padded to the bucket's
  power-of-two max active count ``p``.  Features gather into local slots;
  trained local coefficients scatter-add back into the global table.  Both
  maps are exact — margins are unchanged.
- **random**: one global sparse-sign matrix ``R [dim, p]``.  Local margins
  ``(Rᵀx)ᵀ w_local`` equal global margins of the lifted model ``R w_local``,
  so lifting is exact for scoring as well (the reference instead stores the
  projected model + matrix; lifting keeps the model format uniform).

Both make the per-entity solve dimension ``p`` instead of ``dim`` — the
regularizer then acts in projected space, exactly as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from photon_tpu_torch.game.data import DenseShard, EntityBucket, Shard, SparseShard
from photon_tpu_torch.game.lowp import host_f32
from photon_tpu_torch.game.model import pow2_at_least as _pow2_at_least


@dataclasses.dataclass(frozen=True)
class IndexMapBucketProjection:
    """Per-entity feature subsetting for one bucket.

    ``proj_ids[e, j]`` is the global feature id behind entity ``e``'s local
    slot ``j`` (sorted; padded slots carry id 0 with ``mask == 0``).
    """

    proj_ids: np.ndarray  # [E, p] int32
    mask: np.ndarray  # [E, p] float32

    @property
    def projected_dim(self) -> int:
        return self.proj_ids.shape[1]

    def project(self, features: Shard) -> Shard:
        if isinstance(features, DenseShard):
            # x_local[e, r, j] = x[e, r, proj_ids[e, j]] (0 on padded slots).
            gathered = np.take_along_axis(
                host_f32(features.x), self.proj_ids[:, None, :], axis=2
            )
            return DenseShard(gathered * self.mask[:, None, :])
        # Sparse: remap global ids to the entity's local slots.  proj_ids
        # rows are sorted and contain every id present in the entity's rows,
        # so searchsorted is exact.
        ids, vals = features.ids, features.vals
        local = np.empty_like(ids)
        for e in range(ids.shape[0]):
            local[e] = np.searchsorted(self.proj_ids[e], ids[e])
        return SparseShard(
            local.astype(np.int32), vals, self.projected_dim
        )

    def restrict_table(self, table: np.ndarray) -> np.ndarray:
        """Global per-entity coefficients [E, dim] -> local [E, p]
        (warm-start restriction; exact)."""
        return (
            np.take_along_axis(table, self.proj_ids, axis=1) * self.mask
        ).astype(np.float32)

    def scatter_args(self):
        """(proj_ids, mask) for the device-side scatter-add of local
        coefficients back into the global table."""
        return self.proj_ids, self.mask


def build_index_map_projection(bucket: EntityBucket) -> Optional[IndexMapBucketProjection]:
    """Active-feature projection for one bucket; None when it cannot shrink
    the solve (dense shards or no savings)."""
    features = bucket.features
    if isinstance(features, DenseShard):
        dim = features.x.shape[2]
        x = host_f32(features.x)
        active = [np.nonzero(np.any(x[e] != 0, axis=0))[0] for e in range(x.shape[0])]
    else:
        dim = features.dim
        active = [np.unique(features.ids[e]) for e in range(features.ids.shape[0])]
    max_active = max((len(a) for a in active), default=0)
    p = _pow2_at_least(max(max_active, 1))
    if p >= dim:
        return None  # projection would not shrink the solve
    n_e = len(active)
    proj_ids = np.zeros((n_e, p), np.int32)
    mask = np.zeros((n_e, p), np.float32)
    for e, ids in enumerate(active):
        s = np.sort(ids)
        proj_ids[e, : len(s)] = s
        if len(s):
            # Pad with the largest active id so the row STAYS SORTED —
            # the sparse remap searchsorts each row, and searchsorted
            # returns the first (real) slot for the duplicated id; padded
            # slots are masked out of restriction and scatter.
            proj_ids[e, len(s):] = s[-1]
        mask[e, : len(s)] = 1.0
    return IndexMapBucketProjection(proj_ids=proj_ids, mask=mask)


@dataclasses.dataclass(frozen=True)
class RandomProjectionMatrix:
    """Global sparse-sign projection ``R [dim, p]`` (Achlioptas: entries
    ``±sqrt(3/p)`` with density 1/3, so ``E[R_ij²] = 1/p`` and projected
    feature norms are preserved in expectation; the reference's
    RandomProjection).

    Methods are array-library-agnostic: they work on numpy (host build time)
    and jax arrays (device lift at train time) alike.
    """

    matrix: np.ndarray  # [dim, p] float32

    @property
    def projected_dim(self) -> int:
        return self.matrix.shape[1]

    def project(self, features: Shard) -> DenseShard:
        if isinstance(features, DenseShard):
            return DenseShard(host_f32(features.x) @ self.matrix)
        # Sparse rows: sum_t vals[t] * R[ids[t]] -> dense [E, R, p].
        gathered = self.matrix[features.ids]  # [E, R, k, p]
        return DenseShard(
            np.einsum("erk,erkp->erp", host_f32(features.vals), gathered).astype(np.float32)
        )

    def restrict_table(self, table: np.ndarray) -> np.ndarray:
        """Warm-start restriction: column-normalized least-squares pullback
        ``w_local ≈ (diag(RᵀR))⁻¹ Rᵀ w_global``, so that
        ``restrict(lift(w)) ≈ w`` — a raw ``Rᵀ w`` would scale warm starts
        by ~dim/p and blow up every descent iteration after the first."""
        col_norms = (self.matrix**2).sum(axis=0)  # diag(RᵀR), [p]
        return ((table @ self.matrix) / np.maximum(col_norms, 1e-12)).astype(
            np.float32
        )

    def lift(self, w_local):
        """Exact margin-preserving lift: w_global = R w_local."""
        return w_local @ self.matrix.T

    def lift_variance(self, var_local):
        """Diagonal-covariance lift: Var[R w]_i = Σ_j R_ij² Var[w_j]."""
        return var_local @ (self.matrix.T**2)


def build_random_projection(
    dim: int, projected_dim: int, seed: int = 0
) -> RandomProjectionMatrix:
    if not 0 < projected_dim < dim:
        raise ValueError(
            f"projected_dim must be in (0, {dim}), got {projected_dim}"
        )
    rng = np.random.default_rng(seed)
    u = rng.random((dim, projected_dim))
    scale = np.sqrt(3.0 / projected_dim)
    # +scale w.p. 1/6, -scale w.p. 1/6, 0 w.p. 2/3  =>  E[R_ij²] = 1/p.
    matrix = np.where(
        u < 1.0 / 6.0, scale, np.where(u < 1.0 / 3.0, -scale, 0.0)
    ).astype(np.float32)
    return RandomProjectionMatrix(matrix=matrix)


BucketProjection = Union[IndexMapBucketProjection, RandomProjectionMatrix]
