"""Device-resident score tables for GAME coordinate descent.

Counterpart of ``photon_tpu/game/residuals.py`` on one device.  Both engines
keep one stacked ``[C, n]`` float32 table, row ``c`` holding coordinate
``c``'s current scores, beside a Neumaier-compensated column sum
``total``/``comp``:

- :class:`ResidualEngine` (training): coordinate ``c``'s offsets are
  ``base + ((total - scores[c]) + comp)``, one O(n) pass, no host work.
- :class:`ValidationEngine` (validation): the composite margin is
  ``base + (total + comp)``; only the coordinate that just trained is
  re-scored each outer iteration.

The compensation is what holds the float32 engine to the float64 host path
within the validation metrics' 1e-4: ``total + comp`` carries the row sum
to about twice float32's precision.  Eager torch rounds every operation to
float32 in the order written (no reassociation, no fused multiply-add
across kernels), so the compensation term survives as the reference's
does.  A row update writes the row in place and recomputes ``total`` and
``comp`` from the whole table, so no error drifts across iterations; in
place stands for the reference's donation of the table's buffers.

Non-finite guard: an update whose row holds a NaN or Inf is rejected on
the device (the previous row stays) and its flag waits, still on the
device, until the descent loop drains every flag once per outer iteration
(:meth:`drain_guard_flags`).  :class:`HostResiduals` is the float64 host
path, a mode the user picks (``--residuals host``), never a fallback.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


def resolve_residual_mode(mode: Optional[str] = None) -> str:
    """``device`` | ``host``: the explicit ``mode`` over
    ``PHOTON_RESIDUALS`` over the default (``auto`` = ``device``)."""
    resolved = (mode or os.environ.get("PHOTON_RESIDUALS", "").strip().lower()
                or "auto")
    if resolved not in ("auto", "device", "host"):
        raise ValueError(
            f"residual mode must be 'auto', 'device' or 'host', got {resolved!r}"
        )
    return "device" if resolved == "auto" else resolved


def resolve_validation_mode(mode: Optional[str] = None,
                            residual_mode: str = "device") -> str:
    """``device`` | ``host`` for validation: ``auto`` follows the residual
    mode; ``PHOTON_VALIDATION`` or the explicit ``mode`` override."""
    resolved = (mode or os.environ.get("PHOTON_VALIDATION", "").strip().lower()
                or "auto")
    if resolved not in ("auto", "device", "host"):
        raise ValueError(
            f"validation mode must be 'auto', 'device' or 'host', got {resolved!r}"
        )
    if resolved == "auto":
        return "device" if residual_mode == "device" else "host"
    return resolved


def neumaier_rows(scores: Tensor) -> tuple[Tensor, Tensor]:
    """Compensated column sums of the ``[C, n]`` table -> ``(total, comp)``
    (Neumaier's variant of Kahan summation, rows in order)."""
    total = torch.zeros_like(scores[0])
    comp = torch.zeros_like(scores[0])
    for row in scores:
        t = total + row
        lost = torch.where(
            torch.abs(total) >= torch.abs(row), (total - t) + row, (row - t) + total
        )
        total, comp = t, comp + lost
    return total, comp


def offsets_kernel(base: Tensor, total: Tensor, comp: Tensor, scores: Tensor,
                   c: int) -> Tensor:
    """Training offsets of coordinate ``c``: ``base + sum_{k != c}
    scores[k]`` as ``base + ((total - scores[c]) + comp)``."""
    return base + ((total - scores[c]) + comp)


def composite_kernel(base: Tensor, total: Tensor, comp: Tensor) -> Tensor:
    """Composite margin over all coordinates: ``base + (total + comp)``."""
    return base + (total + comp)


class _DeviceScoreTable:
    """The shared table state: ``scores`` ``[C, n]``, ``base`` ``[n]`` (the
    dataset offset, uploaded once) and the compensated ``total``/``comp``.
    ``names`` fixes the row order."""

    def __init__(self, base_offset: np.ndarray, names: Sequence[str], device):
        if not names:
            raise ValueError(f"{type(self).__name__} needs at least one coordinate")
        self.names = list(names)
        self._row = {name: i for i, name in enumerate(self.names)}
        if len(self._row) != len(self.names):
            raise ValueError(f"duplicate coordinate names in {self.names}")
        self.device = torch.device(device)
        self.n = int(len(base_offset))
        self.base = torch.as_tensor(np.asarray(base_offset, np.float32),
                                    device=self.device)
        self.scores = torch.zeros(len(self.names), self.n, dtype=torch.float32,
                                  device=self.device)
        self.total = torch.zeros(self.n, dtype=torch.float32, device=self.device)
        self.comp = torch.zeros_like(self.total)
        self._pending_guard: list = []
        self.updates = 0
        self.nonfinite_rows: dict = {}

    def update(self, name: str, new_scores) -> None:
        """Replace ``name``'s row (a device tensor or host vector of length
        ``n``) and recompute the compensated total; a non-finite row is
        rejected and its flag kept on the device."""
        new_row = torch.as_tensor(new_scores, dtype=torch.float32, device=self.device)
        if new_row.shape != (self.n,):
            raise ValueError(
                f"score vector for {name!r} has shape {tuple(new_row.shape)}, "
                f"want ({self.n},)"
            )
        c = self._row[name]
        ok = torch.isfinite(new_row).all()
        self.scores[c] = torch.where(ok, new_row, self.scores[c])
        self.total, self.comp = neumaier_rows(self.scores)
        self._pending_guard.append((name, ok))
        if len(self._pending_guard) > 4096:  # callers that never drain
            del self._pending_guard[:-4096]
        self.updates += 1

    def drain_guard_flags(self) -> list:
        """The pending ``(name, ok)`` flags (``ok`` still a device bool),
        cleared: the descent loop reads them with its other per-iteration
        values in one host read."""
        pending, self._pending_guard = self._pending_guard, []
        return pending

    def record_rejected(self, bad: Sequence[str]) -> None:
        for name in bad:
            self.nonfinite_rows[name] = self.nonfinite_rows.get(name, 0) + 1

    def poll_quarantined(self) -> list:
        """Names whose updates were rejected since the last poll (one host
        read of the pending flags)."""
        pending = self.drain_guard_flags()
        if not pending:
            return []
        oks = torch.stack([ok for _, ok in pending]).tolist()
        bad = [name for (name, _), ok in zip(pending, oks) if not ok]
        self.record_rejected(bad)
        return bad

    def snapshot_rows(self) -> dict:
        """Device row views ``{name: [n]}`` for a checkpoint: the
        checkpointer stages them with the model tables in one pass, before
        the next in-place ``update`` can overwrite them."""
        return {name: self.scores[self._row[name]] for name in self.names}

    def load_rows(self, rows: dict) -> None:
        """Rebuild the table from checkpointed rows (resume): one guarded
        update a coordinate, the state an uninterrupted run holds after the
        same iterations."""
        for name, row in rows.items():
            if name in self._row:
                self.update(name, np.asarray(row, np.float32))


class ResidualEngine(_DeviceScoreTable):
    """Training-side score table (see the module docstring)."""

    def offsets_for(self, name: str) -> Tensor:
        """Training offsets of ``name``: float32 ``[n]`` on the device."""
        return offsets_kernel(self.base, self.total, self.comp, self.scores,
                              self._row[name])


class ValidationEngine(_DeviceScoreTable):
    """Validation-side score table: incremental re-scoring and the
    composite margin."""

    def composite(self) -> Tensor:
        return composite_kernel(self.base, self.total, self.comp)


class HostResiduals:
    """The float64 host path (``--residuals host``): scores live on the
    host, a coordinate's offsets are accumulated in float64 and cast to
    float32; every coordinate of every outer iteration moves one score
    vector to the host and one offsets vector back."""

    def __init__(self, base_offset: np.ndarray, names: Sequence[str] = (),
                 device=None):
        del names, device  # the engines' signature; the state is host-only
        self.base = np.asarray(base_offset, np.float64)
        self.scores: dict = {}
        self._pending_guard: list = []
        self.updates = 0
        self.nonfinite_rows: dict = {}

    def update(self, name: str, new_scores) -> None:
        """Store ``name``'s scores on the host; non-finite vectors are
        rejected (the previous ones stay) and reported at the next drain."""
        if isinstance(new_scores, Tensor):
            new_scores = new_scores.detach().cpu().numpy()
        host = np.asarray(new_scores, np.float64)
        if host.shape != self.base.shape:
            raise ValueError(
                f"score vector for {name!r} has shape {host.shape}, "
                f"want {self.base.shape}"
            )
        if not np.isfinite(host).all():
            self._pending_guard.append(name)
        else:
            self.scores[name] = host
        self.updates += 1

    def offsets_for(self, name: str) -> np.ndarray:
        offsets = self.base.copy()
        for other, s in self.scores.items():
            if other != name:
                offsets += s
        return offsets.astype(np.float32)

    def drain_guard_flags(self) -> list:
        """Pending ``(name, ok)`` flags (host bools: rejected on update)."""
        bad, self._pending_guard = self._pending_guard, []
        return [(name, False) for name in bad]

    def record_rejected(self, bad) -> None:
        for name in bad:
            self.nonfinite_rows[name] = self.nonfinite_rows.get(name, 0) + 1

    def poll_quarantined(self) -> list:
        bad = [name for name, _ in self.drain_guard_flags()]
        self.record_rejected(bad)
        return bad

    def snapshot_rows(self) -> dict:
        """Host float64 copies of every row: a resumed host-mode fit starts
        from the exact state."""
        return {name: s.copy() for name, s in self.scores.items()}

    def load_rows(self, rows: dict) -> None:
        """Restore checkpointed float64 rows directly (no update: nothing
        crossed from the device)."""
        for name, row in rows.items():
            host = np.asarray(row, np.float64)
            if host.shape != self.base.shape:
                raise ValueError(
                    f"checkpointed row for {name!r} has shape {host.shape}, "
                    f"want {self.base.shape}"
                )
            self.scores[name] = host
