"""GLM objective: weighted loss plus L2, with its gradient.

Counterpart of ``photon_tpu/core/objective.py`` for value and gradient.
``value_and_grad`` dispatches a sparse batch to one of the routes of
``ops/sparse_grad_select.py`` — the fused kernel, the slab position-reduce,
or the torch-op ``fm`` / ``autodiff`` reductions — and adds the L2 term
analytically.  No route differentiates through a kernel: each returns the
value and the gradient explicitly.  L1 never enters the smooth objective.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.core.losses import PointwiseLoss, get_loss
from photon_tpu_torch.data.batch import (
    Batch,
    FeatureMajorAux,
    SparseBatch,
    gather_dot,
    margins,
)

Tensor = torch.Tensor


def _fm_segment_grad(per_row: Tensor, fm: FeatureMajorAux, dim: int) -> Tensor:
    """``g[f] = sum_e per_row[row_e] * val_e`` over the feature-major layout
    (entries sorted by feature, so each feature's terms are one run)."""
    contrib = per_row.index_select(0, fm.rows) * fm.vals
    return torch.zeros(dim, dtype=per_row.dtype, device=per_row.device).index_add_(
        0, fm.ids, contrib
    )


def _row_scatter(per_row: Tensor, batch: SparseBatch, dim: int) -> Tensor:
    """``g[ids_ij] += per_row_i * vals_ij``: the unsorted row-major scatter."""
    contrib = (per_row[:, None] * batch.vals).reshape(-1)
    return torch.zeros(dim, dtype=per_row.dtype, device=per_row.device).index_add_(
        0, batch.ids.reshape(-1), contrib
    )


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """L1/L2/elastic-net configuration; ``alpha`` is the elastic-net mix
    (``l1 = alpha * weight``, ``l2 = (1 - alpha) * weight``)."""

    reg_type: str = "none"  # none | l1 | l2 | elastic_net
    reg_weight: float = 0.0
    alpha: float = 0.5

    def __post_init__(self):
        if self.reg_type not in ("none", "l1", "l2", "elastic_net"):
            raise ValueError(f"unknown regularization type {self.reg_type!r}")

    @property
    def l1_weight(self) -> float:
        if self.reg_type == "l1":
            return self.reg_weight
        if self.reg_type == "elastic_net":
            return self.alpha * self.reg_weight
        return 0.0

    @property
    def l2_weight(self) -> float:
        if self.reg_type == "l2":
            return self.reg_weight
        if self.reg_type == "elastic_net":
            return (1.0 - self.alpha) * self.reg_weight
        return 0.0


NO_REG = RegularizationContext()


@dataclasses.dataclass(frozen=True)
class GlmObjective:
    """``sum_i weight_i * loss(margin_i, y_i) + (l2/2) ||w||^2``.

    ``l1_weight`` is carried for OWL-QN but never enters the smooth value
    or gradient.
    """

    loss: PointwiseLoss
    l2_weight: float = 0.0
    l1_weight: float = 0.0

    @classmethod
    def create(
        cls, loss: str | PointwiseLoss, reg: RegularizationContext = NO_REG
    ) -> "GlmObjective":
        if isinstance(loss, str):
            loss = get_loss(loss)
        return cls(loss=loss, l2_weight=reg.l2_weight, l1_weight=reg.l1_weight)

    # -- value -----------------------------------------------------------------
    def data_value(self, w: Tensor, batch: Batch) -> Tensor:
        z = margins(w, batch)
        return torch.sum(batch.weight * self.loss.value(z, batch.label))

    def value(self, w: Tensor, batch: Batch) -> Tensor:
        v = self.data_value(w, batch)
        if self.l2_weight != 0.0:
            v = v + 0.5 * self.l2_weight * torch.dot(w, w)
        return v

    # -- route dispatch --------------------------------------------------------
    def _sparse_kernel(self, batch: Batch) -> Optional[str]:
        """The route for this batch (``None`` for a dense batch)."""
        if not isinstance(batch, SparseBatch):
            return None
        from photon_tpu_torch.ops.sparse_grad_select import select_kernel

        return select_kernel(
            has_fm=batch.fm is not None, has_aligned=batch.al is not None
        )

    def _xu_product(self, kernel: str, u: Tensor, batch: SparseBatch) -> Tensor:
        """Per-row ``X u`` (no offset): through the transposed slab layout
        on the ``pallas`` route when the batch carries one, else the
        row-major gather."""
        if kernel == "pallas" and batch.al_t is not None:
            from photon_tpu_torch.ops.slab_reduce import aligned_segment_grad

            return aligned_segment_grad(u, batch.al_t, batch.num_examples)
        return gather_dot(u, batch.ids, batch.vals)

    def _margins_for_kernel(self, kernel: str, w: Tensor, batch: SparseBatch) -> Tensor:
        return self._xu_product(kernel, w, batch) + batch.offset

    def _segment_grad(
        self, kernel: str, per_row: Tensor, batch: SparseBatch, dim: int
    ) -> Tensor:
        """``g[f] = sum_e per_row[row_e] * val_e`` through the route's layout."""
        if kernel == "pallas":
            from photon_tpu_torch.ops.slab_reduce import aligned_segment_grad

            return aligned_segment_grad(per_row, batch.al, dim)
        if kernel == "fm":
            return _fm_segment_grad(per_row, batch.fm, dim)
        return _row_scatter(per_row, batch, dim)

    def _fast_data_value_and_grad(
        self, w: Tensor, batch: SparseBatch, kernel: str
    ) -> tuple[Tensor, Tensor]:
        """Data term (no regularization) of value and gradient via a route
        that reduces through a layout (``pallas``, ``fm``, ``autodiff``)."""
        z = self._margins_for_kernel(kernel, w, batch)
        v = torch.sum(batch.weight * self.loss.value(z, batch.label))
        dz = batch.weight * self.loss.d1(z, batch.label)
        return v, self._segment_grad(kernel, dz, batch, w.shape[0])

    def value_and_grad(self, w: Tensor, batch: Batch) -> tuple[Tensor, Tensor]:
        kernel = self._sparse_kernel(batch)
        if kernel == "fused":
            from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad

            v, g = fused_value_and_grad(
                self.loss, w, batch.ids, batch.vals,
                batch.label, batch.offset, batch.weight,
            )
        elif kernel is not None:
            v, g = self._fast_data_value_and_grad(w, batch, kernel)
        else:
            z = margins(w, batch)
            v = torch.sum(batch.weight * self.loss.value(z, batch.label))
            g = batch.x.T @ (batch.weight * self.loss.d1(z, batch.label))
        if self.l2_weight != 0.0:
            v = v + 0.5 * self.l2_weight * torch.dot(w, w)
            g = g + self.l2_weight * w
        return v, g

    def grad(self, w: Tensor, batch: Batch) -> Tensor:
        return self.value_and_grad(w, batch)[1]
