"""GLM objective: weighted loss plus L2, with its gradient and its
second-order terms, optionally under feature normalization.

Counterpart of ``photon_tpu/core/objective.py``.  ``value_and_grad``
dispatches a sparse batch to one of the routes of
``ops/sparse_grad_select.py`` — the fused kernel, the slab position-reduce
(with or without the static exchange or the Clos exchange of ``benes``), or
the torch-op ``fm`` / ``autodiff`` reductions — and adds the L2 term
analytically.  No route differentiates through a kernel: each returns the
value and the gradient explicitly, and the Hessian-vector product is the
exact GLM form ``X^T (D(w) * (X v)) + l2 v`` with ``D = weight * d2`` at
the margins, its two matvecs through the route's forward and reduce.  L1
never enters the smooth objective.

Under a :class:`~photon_tpu_torch.core.normalization.NormalizationContext`
the matvecs become those of the normalized features ``F (x - s)``: the
forward ``X (F u) - (s F) . u``, the reduce ``F (X^T r - s sum(r))``, so a
sparse batch stays sparse.  The fused kernel computes unnormalized margins
only, so a normalized objective on the ``fused`` route takes the plain
``autodiff`` reductions, as the reference gates its fused kernel on
``normalization is None``.

A batch may store its feature values in bfloat16 (``data/batch.py``
``batch_astype``): every route reads them as JAX promotes them, widened to
float32 where they meet a float32 operand, and where torch wants one dtype
(the dense products) the values widen right before the product.  Every
result is float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.core.losses import PointwiseLoss, get_loss
from photon_tpu_torch.core.normalization import NormalizationContext
from photon_tpu_torch.data.batch import (
    Batch,
    DenseBatch,
    FeatureMajorAux,
    SparseBatch,
    gather_dot,
    scatter_sum,
)

Tensor = torch.Tensor


def _fm_segment_grad(per_row: Tensor, fm: FeatureMajorAux, dim: int) -> Tensor:
    """``g[f] = sum_e per_row[row_e] * val_e`` over the feature-major layout
    (entries sorted by feature, so each feature's terms are one run)."""
    return scatter_sum(fm.ids, per_row.index_select(0, fm.rows) * fm.vals, dim)


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
    """``sum_i weight_i * loss(margin_i, y_i) + (l2/2) ||w||^2``, with the
    margins of the normalized features when ``normalization`` is set (the
    coefficients then live in the normalized space).

    ``l1_weight`` is carried for OWL-QN but never enters the smooth value
    or gradient.
    """

    loss: PointwiseLoss
    l2_weight: float = 0.0
    l1_weight: float = 0.0
    normalization: Optional[NormalizationContext] = None

    @classmethod
    def create(
        cls, loss: str | PointwiseLoss, reg: RegularizationContext = NO_REG,
        normalization: Optional[NormalizationContext] = None,
    ) -> "GlmObjective":
        if isinstance(loss, str):
            loss = get_loss(loss)
        return cls(loss=loss, l2_weight=reg.l2_weight, l1_weight=reg.l1_weight,
                   normalization=normalization)

    # -- value -----------------------------------------------------------------
    def _margins(self, w: Tensor, batch: Batch) -> Tensor:
        """Margins through the row-major gather (or ``x @ w``)."""
        xu, _ = self._normalized(*_plain_matvecs(batch, w.shape[0]),
                                 w.shape[0], w.device)
        return xu(w) + batch.offset

    def data_value(self, w: Tensor, batch: Batch) -> Tensor:
        z = self._margins(w, batch)
        return torch.sum(batch.weight * self.loss.value(z, batch.label))

    def value(self, w: Tensor, batch: Batch) -> Tensor:
        v = self.data_value(w, batch)
        if self.l2_weight != 0.0:
            v = v + 0.5 * self.l2_weight * torch.dot(w, w)
        return v

    # -- route dispatch --------------------------------------------------------
    def _sparse_kernel(self, batch: Batch, dim: int) -> Optional[str]:
        """The route for this batch and ``dim`` coefficients (``None`` for a
        dense batch); in ``auto`` measured on the batch's device.  Under
        normalization ``fused`` becomes ``autodiff``: the kernel's margins
        are unnormalized."""
        if not isinstance(batch, SparseBatch):
            return None
        from photon_tpu_torch.ops.sparse_grad_select import select_kernel

        n, k = batch.ids.shape
        # A cumsum route (``bounds`` set) reduces without the aligned layout,
        # so a batch may carry it alone (the streamed chunks do); an aligned
        # route reduces over ``al``.
        has_xchg = batch.xchg is not None and (
            batch.al is not None or batch.xchg.bounds is not None)
        kernel = select_kernel(
            n * k, dim, n,
            has_fm=batch.fm is not None, has_aligned=batch.al is not None,
            has_benes=batch.benes is not None and batch.al is not None,
            has_xchg=has_xchg,
            # Baked values move only the dz expansion each step; unbaked
            # ones the whole product stream: the probe times the variant
            # the batch carries.
            xchg_baked=has_xchg and batch.xchg.vals_dest is not None,
            device=batch.ids.device,
        )
        if kernel == "fused" and self.normalization is not None:
            return "autodiff"
        return kernel

    def _xu_product(self, kernel: str, u: Tensor, batch: SparseBatch) -> Tensor:
        """Per-row ``X u`` (no offset), the one forward of margins and of
        Hv's ``X v``: the slab gather and the Clos exchange on ``benes``;
        the transposed slab layout on the ``pallas`` and ``xchg`` routes
        when the batch carries one; else the row-major gather."""
        if kernel == "benes":
            from photon_tpu_torch.ops.benes import benes_xu_product

            n, k = batch.ids.shape
            return benes_xu_product(u, batch.al, batch.benes, n, k)
        if kernel in ("pallas", "xchg") and batch.al_t is not None:
            from photon_tpu_torch.ops.slab_reduce import aligned_segment_grad

            return aligned_segment_grad(u, batch.al_t, batch.num_examples)
        return gather_dot(u, batch.ids, batch.vals)

    def _margins_for_kernel(self, kernel: str, w: Tensor, batch: SparseBatch) -> Tensor:
        xu, _ = self._matvecs(kernel, batch, w.shape[0])
        return xu(w) + batch.offset

    def _segment_grad(
        self, kernel: str, per_row: Tensor, batch: SparseBatch, dim: int
    ) -> Tensor:
        """``g[f] = sum_e per_row[row_e] * val_e`` through the route's layout
        (the reduce the gradient and Hv share)."""
        if kernel == "benes":
            from photon_tpu_torch.ops.benes import benes_segment_grad

            return benes_segment_grad(per_row, batch.vals, batch.al, batch.benes, dim)
        if kernel == "xchg":
            from photon_tpu_torch.ops.vperm import xchg_segment_grad

            return xchg_segment_grad(per_row, batch.vals, batch.al, batch.xchg, dim)
        if kernel == "pallas":
            from photon_tpu_torch.ops.slab_reduce import aligned_segment_grad

            return aligned_segment_grad(per_row, batch.al, dim)
        if kernel == "fm":
            return _fm_segment_grad(per_row, batch.fm, dim)
        # The unsorted row-major scatter: the fused route's kernel (its Hv
        # half; K1 fuses value and gradient), else its plain version.
        from photon_tpu_torch.ops.fused_sparse import row_scatter, row_scatter_plain

        scatter = row_scatter if kernel == "fused" else row_scatter_plain
        return scatter(per_row, batch.ids, batch.vals, dim)

    def _normalized(self, xu, xtu, dim: int, device):
        """The matvecs of the normalized features ``F (x - s)`` built on the
        raw ones: ``u -> X (F u) - (s F) . u`` and ``r -> F (X^T r - s sum(r))``
        (the reference's margin identity and gradient algebra)."""
        norm = self.normalization
        if norm is None:
            return xu, xtu
        f = norm.factors_or_ones(dim, device)
        s = norm.shifts

        def nxu(u: Tensor) -> Tensor:
            u_eff = u * f
            out = xu(u_eff)
            return out if s is None else out - torch.dot(s, u_eff)

        def nxtu(r: Tensor) -> Tensor:
            g = xtu(r)
            if s is not None:
                g = g - s * torch.sum(r)
            return g * f

        return nxu, nxtu

    def _matvecs(self, kernel: Optional[str], batch: Batch, dim: int):
        """``(u -> X u, r -> X^T r)`` on the batch's route, normalized when
        the objective is.  ``fused`` and ``autodiff`` take the row-major
        gather and the row scatter, as the JAX package does for a batch
        without a static layout: K1 fuses value and gradient only, and
        ``fused`` scatters through the row scatter kernel."""
        if kernel is None:
            xu, xtu = _plain_matvecs(batch, dim)
        else:
            xu = lambda u: self._xu_product(kernel, u, batch)  # noqa: E731
            xtu = lambda r: self._segment_grad(kernel, r, batch, dim)  # noqa: E731
        return self._normalized(xu, xtu, dim, batch.label.device)

    def _fast_data_value_and_grad(
        self, w: Tensor, batch: Batch, kernel: Optional[str]
    ) -> tuple[Tensor, Tensor]:
        """Data term (no regularization) of value and gradient through the
        route's matvecs (``pallas``, ``xchg``, ``benes``, ``fm``,
        ``autodiff``; ``None`` for a dense batch)."""
        xu, xtu = self._matvecs(kernel, batch, w.shape[0])
        z = xu(w) + batch.offset
        v = torch.sum(batch.weight * self.loss.value(z, batch.label))
        dz = batch.weight * self.loss.d1(z, batch.label)
        return v, xtu(dz)

    def value_and_grad(self, w: Tensor, batch: Batch) -> tuple[Tensor, Tensor]:
        kernel = self._sparse_kernel(batch, w.shape[0])
        if kernel == "fused":
            from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad

            v, g = fused_value_and_grad(
                self.loss, w, batch.ids, batch.vals,
                batch.label, batch.offset, batch.weight,
            )
        else:
            v, g = self._fast_data_value_and_grad(w, batch, kernel)
        if self.l2_weight != 0.0:
            v = v + 0.5 * self.l2_weight * torch.dot(w, w)
            g = g + self.l2_weight * w
        return v, g

    def grad(self, w: Tensor, batch: Batch) -> Tensor:
        return self.value_and_grad(w, batch)[1]

    # -- second order ----------------------------------------------------------
    def _curvature(self, xu, w: Tensor, batch: Batch) -> Tensor:
        """Per-row curvature ``D(w) = weight * d2(margins)``."""
        return batch.weight * self.loss.d2(xu(w) + batch.offset, batch.label)

    def hessian_vector(self, w: Tensor, v: Tensor, batch: Batch) -> Tensor:
        """One exact Hessian-vector product ``H(w) v``."""
        return self.hvp_operator(w, batch)(v)

    def hvp_operator(self, w: Tensor, batch: Batch):
        """The curvature operator at ``w``: ``D(w)`` is computed once (one
        margin pass) and the returned ``v -> X^T (D * (X v)) + l2 v`` costs
        two matvecs per product — the inner loop of TRON and Newton-CG.
        Under normalization both matvecs are the normalized ones, which
        equals the reference's jvp of the normalized gradient."""
        xu, xtu = self._matvecs(self._sparse_kernel(batch, w.shape[0]), batch,
                                w.shape[0])
        d2w = self._curvature(xu, w, batch)
        l2 = self.l2_weight

        def hv(v: Tensor) -> Tensor:
            out = xtu(d2w * xu(v))
            return out + l2 * v if l2 != 0.0 else out

        return hv

    def hessian_vector_product(self, w: Tensor, v: Tensor, batch: Batch) -> Tensor:
        """One matrix-free ``H v``; loops over many ``v`` at one ``w``
        should hold :meth:`hvp_operator` instead."""
        return self.hvp_operator(w, batch)(v)

    def _row_sums(self, per_row: Tensor, batch: Batch, dim: int,
                  square: bool) -> Tensor:
        """``sum_i per_row_i * x_ij`` (``x_ij^2`` with ``square``) per
        feature, without densifying a sparse batch, in the reference's
        order of operations (a dense square in the storage dtype, a sparse
        one in float32 after the coefficient)."""
        if isinstance(batch, DenseBatch):
            x = batch.x * batch.x if square else batch.x
            return x.to(per_row.dtype).T @ per_row
        terms = per_row[:, None] * batch.vals
        if square:
            terms = terms * batch.vals
        return scatter_sum(batch.ids.reshape(-1), terms.reshape(-1), dim)

    def hessian_diagonal(self, w: Tensor, batch: Batch) -> Tensor:
        """``diag(H) = sum_i weight_i * d2_i * x_ij^2 + l2``, the SIMPLE
        variance's input and Newton-CG's Jacobi preconditioner.  Under
        normalization ``f_j^2 (A_j - 2 s_j B_j + s_j^2 C)`` with ``A`` the
        raw diagonal, ``B = X^T d2w`` and ``C = sum d2w``."""
        d = w.shape[0]
        d2w = self.loss.d2(self._margins(w, batch), batch.label) * batch.weight
        diag = self._row_sums(d2w, batch, d, square=True)
        norm = self.normalization
        if norm is not None:
            if norm.shifts is not None:
                s = norm.shifts
                b = self._row_sums(d2w, batch, d, square=False)
                diag = diag - 2.0 * s * b + s * s * torch.sum(d2w)
            f = norm.factors_or_ones(d, w.device)
            diag = diag * f * f
        return diag + self.l2_weight

    def hessian_matrix(self, w: Tensor, batch: Batch) -> Tensor:
        """The full Hessian ``X^T diag(weight * d2) X + l2 I`` (``[d, d]``;
        the FULL variance's input up to its dense limit).  Under
        normalization ``F (A - B s^T - s B^T + C s s^T) F``."""
        d2w = self.loss.d2(self._margins(w, batch), batch.label) * batch.weight
        d = w.shape[0]
        if isinstance(batch, DenseBatch):
            h = batch.x.to(d2w.dtype).T @ (d2w[:, None] * batch.x)
        else:
            c = d2w[:, None, None] * batch.vals[:, :, None] * batch.vals[:, None, :]
            ids = batch.ids.long()
            flat = (ids[:, :, None] * d + ids[:, None, :]).reshape(-1)
            h = scatter_sum(flat, c.reshape(-1), d * d).view(d, d)
        norm = self.normalization
        if norm is not None:
            if norm.shifts is not None:
                s = norm.shifts
                b = self._row_sums(d2w, batch, d, square=False)
                h = (h - b[:, None] * s[None, :] - s[:, None] * b[None, :]
                     + torch.sum(d2w) * s[:, None] * s[None, :])
            f = norm.factors_or_ones(d, w.device)
            h = h * f[:, None] * f[None, :]
        return h + self.l2_weight * torch.eye(d, dtype=w.dtype, device=w.device)


def _plain_matvecs(batch: Batch, dim: int):
    """``(u -> X u, r -> X^T r)`` without a static layout: the dense
    products, or the row-major gather and the plain row scatter."""
    if isinstance(batch, DenseBatch):
        return ((lambda u: batch.x.to(u.dtype) @ u),
                (lambda r: batch.x.to(r.dtype).T @ r))
    from photon_tpu_torch.ops.fused_sparse import row_scatter_plain

    return ((lambda u: gather_dot(u, batch.ids, batch.vals)),
            (lambda r: row_scatter_plain(r, batch.ids, batch.vals, dim)))
