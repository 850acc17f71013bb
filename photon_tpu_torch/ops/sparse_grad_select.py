"""Choice of the sparse value-and-gradient route.

Counterpart of ``photon_tpu/ops/sparse_grad_select.py``, reading the same
``PHOTON_SPARSE_GRAD`` variable (``auto`` by default) and the same probe
knobs.  The routes:

- ``fused`` — the fused kernel (``ops/fused_sparse.py``): margins, loss and
  gradient scatter in one pass over the row-major batch.  It stands in the
  slot of the reference's ``autodiff`` with its fused Pallas pass on
  (``PHOTON_TPU_PALLAS=1``): the route a batch without layouts takes on the
  card.
- ``pallas`` — the slab position-reduce (``ops/slab_reduce.py``): gradient
  over the batch's aligned layout ``al``, margins over its transposed layout
  ``al_t`` when present.  Needs ``attach_feature_major(..., aligned_dim=d)``.
- ``xchg`` — the ``pallas`` route with the per-step ``per_row[rows]`` gather
  replaced by a static exchange routed once on the host (``ops/vperm.py``).
- ``benes`` — the ``pallas`` reduce fed by a static Clos permutation of the
  row-major products into slot order (``ops/benes.py``); explicit opt-in
  only, as in the reference: ``auto`` never measures or builds it.
- ``fm`` — feature-major sorted sum over the batch's ``fm`` layout (torch
  ops only).
- ``autodiff`` — the row-major unsorted scatter (torch ops only): the
  reference's CPU route, and the route below the probe floor on the CPU.

A forced route whose layouts the batch lacks falls back as the reference's
does (``xchg`` and ``benes`` to ``pallas``, then ``fm``, then the base
route: ``fused`` on the card, ``autodiff`` on the CPU).

``auto`` measures, as the reference does.  Below a size floor
(``PHOTON_SPARSE_PROBE_FLOOR``, default 2^20 entries) it takes the base
route without measuring.  Above it, :func:`_measure` times the candidates
once on the live device at a capped probe size
(``PHOTON_SPARSE_PROBE_MAX_ENTRIES``, default 2^21) on synthetic uniform
ids — not the batch's own — and caches the verdict per device, size bucket,
candidate set and exchange configuration; the verdict is then sanitised
against the layouts the batch carries.  On the card the candidates are
``fused``, ``fm`` (when the batch carries it), ``pallas`` (when it carries
``al``) and ``xchg`` (when it carries a route, baked or not as the batch's
is); each hand-written reduce is held to an on-device correctness gate
before it is timed, and one that fails it is excluded with a warning.  On
the CPU the candidates are the reference's CPU set, ``fm`` against
``autodiff``.  In ``auto`` on the card above the floors the attach
(``data/batch.attach_feature_major``) also builds the aligned layouts
(:func:`aligned_layout_wanted`) and the exchange route
(:func:`xchg_route_wanted`), so that the probe has them to choose from.

Departures from the reference, each deliberate:

- The reference pins ``autodiff`` when a probe raises; here a probe that
  fails to build or launch a kernel raises, since that catch would hide the
  device fault this port must show.
- The reference times each candidate's gradient reduce from a given ``dz``.
  ``fused`` computes the margins, the loss and the gradient in one kernel
  and cannot be timed apart, so every candidate is timed as one whole
  value-and-gradient evaluation of the probe batch through its route
  (margins, loss, gradient): the same unit for all.
- Every probe's measurements stay in :data:`PROBE_RECORD`, where the
  reference only logs the verdict.

The measurement is wall-clock: near a crossover two runs can pick different
routes, whose sums differ in rounding.  Pin ``PHOTON_SPARSE_GRAD`` for
bitwise reproducibility.
"""

from __future__ import annotations

import logging
import os
import statistics
import time
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch.utils.env import env_int

ROUTES = ("fused", "pallas", "xchg", "benes", "fm", "autodiff")
_LOG = logging.getLogger("photon_tpu_torch.sparse_grad")

_CACHE: dict = {}
# Every probe's measurements by cache key: the probe's size and device, each
# candidate's gate error (None for a candidate without a gate) and median
# seconds (None when its gate excluded it), the excluded candidates and the
# verdict.
PROBE_RECORD: dict = {}

# Probe arrays are capped so the one-time measurement stays cheap for any
# dataset; relative route cost is stable above this size.
_PROBE_MAX_ENTRIES = 1 << 21
# The gates' tolerance, the reference's: the kernel's f32 sums against a
# float64 scatter of the same terms.
_GATE_RTOL = 2e-4
_GATE_ATOL = 1e-4  # times the largest |gradient| (at least 1)


def _probe_cap() -> int:
    # Clamp at 1: 0 would divide by zero in the ceil, negatives would uncap
    # the probe.
    return env_int("PHOTON_SPARSE_PROBE_MAX_ENTRIES", _PROBE_MAX_ENTRIES, minimum=1)


def _probe_floor() -> int:
    # 0 disables the floor.
    return env_int("PHOTON_SPARSE_PROBE_FLOOR", 1 << 20, minimum=0)


def _bucket(n: int) -> int:
    return max(int(n).bit_length(), 1)


def _mode() -> str:
    mode = os.environ.get("PHOTON_SPARSE_GRAD", "auto")
    if mode not in ROUTES + ("auto",):
        raise ValueError(
            f"PHOTON_SPARSE_GRAD={mode!r}; the port supports "
            f"{', '.join(ROUTES)} or auto"
        )
    return mode


def _device(device=None) -> torch.device:
    """The device the choice is for; ``None`` means the card when there is
    one (the reference's default backend)."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def _on_card(device=None) -> bool:
    return _device(device).type == "cuda"


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def _base(device=None) -> str:
    """The route in the slot of the reference's ``autodiff``."""
    return "fused" if _on_card(device) else "autodiff"


def _gate(name: str, got: torch.Tensor, ref: np.ndarray, record: dict) -> bool:
    """The reference's on-device correctness gate: ``got`` against the
    float64 ``ref`` at ``rtol=2e-4, atol=1e-4 * max(|ref|, 1)``."""
    g = got.double().cpu().numpy()
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(g - ref).max())
    record["candidates"][name] = {"gate_max_abs_err": err, "seconds": None}
    if np.allclose(g, ref, rtol=_GATE_RTOL, atol=_GATE_ATOL * scale):
        return True
    record["excluded"].append(name)
    _LOG.warning("%s kernel FAILED the on-device correctness gate (max abs err "
                 "%.3g); excluded from auto selection", name, err)
    return False


def _measure(e: int, d: int, n: int, with_pallas: bool,
             with_xchg: bool = False, xchg_baked: bool = True,
             with_fm: bool = True, device=None,
             record: Optional[dict] = None) -> str:
    """Time the candidate routes once on ``device`` over a synthetic probe
    batch of ``e`` uniform ids in ``[0, d)`` cut into ``[e // k, k]`` rows
    (``k = e // n``); returns the fastest.  ``record`` (a dict) receives the
    measurements."""
    from photon_tpu_torch.core.losses import get_loss
    from photon_tpu_torch.core.objective import GlmObjective
    from photon_tpu_torch.data.batch import SparseBatch, attach_feature_major
    from photon_tpu_torch.ops import slab_reduce, vperm
    from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad

    dev = _device(device)
    on_card = dev.type == "cuda"
    rec = record if record is not None else {}
    rec.update(entries=e, dim=d, device=str(dev), candidates={}, excluded=[])
    rng = np.random.default_rng(0)
    flat_ids = rng.integers(0, d, size=e, dtype=np.int32)
    flat_vals = rng.standard_normal(e).astype(np.float32)
    # The batch's [n, k] padded-COO convention, so that the layouts built
    # here are representative.
    k = max(e // max(n, 1), 1)
    n_probe = e // k
    ids2d = flat_ids[: n_probe * k].reshape(n_probe, k)
    vals2d = flat_vals[: n_probe * k].reshape(n_probe, k)
    label = (rng.random(n_probe) < 0.5).astype(np.float32)
    w = torch.as_tensor((rng.standard_normal(d) * 0.1).astype(np.float32), device=dev)
    dz = rng.standard_normal(n_probe).astype(np.float32)
    rec["rows"], rec["nnz_per_row"] = n_probe, k
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    batch = SparseBatch(
        ids=put(ids2d), vals=put(vals2d), label=put(label),
        offset=torch.zeros(n_probe, device=dev), weight=torch.ones(n_probe, device=dev),
    )
    if with_fm:
        batch = attach_feature_major(batch)  # fm only: no aligned_dim
    layout = None
    if with_pallas or with_xchg:
        layout = slab_reduce.build_aligned_layout(ids2d, vals2d, d)
        batch = batch._replace(
            al=slab_reduce.device_layout(layout, dev),
            al_t=slab_reduce.device_layout(
                slab_reduce.build_row_aligned_layout(ids2d, vals2d), dev),
        )
    loss = get_loss("logistic")
    objective = GlmObjective.create(loss)

    def evaluation(route: str):
        """One value-and-gradient evaluation through ``route`` at ``w``,
        reduced to a scalar for the host fetch."""
        if route == "fused":
            def run(w):
                v, g = fused_value_and_grad(loss, w, batch.ids, batch.vals,
                                            batch.label, batch.offset, batch.weight)
                return v + g.sum()
        else:
            def run(w):
                v, g = objective._fast_data_value_and_grad(w, batch, route)
                return v + g.sum()
        return run

    def t(fn, reps: int = 3) -> float:
        # The reference's salted method: salt the input of each timed run
        # (prepared outside the timed window) so no run can reuse an earlier
        # result, and end each run in a host fetch of its scalar.
        float(fn(w).item())
        ts = []
        for i in range(reps):
            salted = w + (i + 1) * 1e-12
            if on_card:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            float(fn(salted).item())
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    timings = {}

    def timed(route: str) -> None:
        timings[route] = t(evaluation(route))
        rec["candidates"].setdefault(route, {"gate_max_abs_err": None})
        rec["candidates"][route]["seconds"] = timings[route]

    timed(_base(dev))
    if with_fm:
        timed("fm")
    if with_pallas or with_xchg:
        ref = np.zeros(d, np.float64)
        np.add.at(ref, ids2d.reshape(-1),
                  (dz[:, None] * vals2d).reshape(-1).astype(np.float64))
        dz_t = put(dz)
    if with_pallas:
        # The layout candidates are hand-written kernels: hold the gradient
        # reduce to the float64 scatter, on the device, before timing it.
        got = slab_reduce.aligned_segment_grad(dz_t, batch.al, d)
        if _gate("pallas", got, ref, rec):
            timed("pallas")
    if with_xchg:
        # Baked (the attach's default) moves only the dz expansion each
        # step; unbaked moves the product stream: the probe times the
        # variant the batch carries.
        aux = vperm.build_xchg_aux(layout, ids2d,
                                   vals=vals2d if xchg_baked else None, device=dev,
                                   dim=d)
        batch = batch._replace(xchg=aux)
        got = vperm.xchg_segment_grad(dz_t, batch.vals, batch.al, aux, d)
        if _gate("xchg", got, ref, rec):
            timed("xchg")
    rec["choice"] = min(timings, key=timings.get)
    return rec["choice"]


def select_kernel(
    e_total: int,
    dim: int,
    n_rows: int,
    has_fm: bool = True,
    has_aligned: bool = False,
    has_benes: bool = False,
    has_xchg: bool = False,
    xchg_baked: bool = True,
    device=None,
) -> str:
    """Pick the route — ``fused``, ``pallas``, ``xchg``, ``benes``, ``fm``
    or ``autodiff`` — for a batch of ``e_total`` entries over ``n_rows``
    rows and ``dim`` features on ``device`` (the card when there is one),
    restricted to the layouts the batch carries (``has_xchg`` /
    ``has_benes``: an exchange route and the aligned layout it reduces
    over; ``xchg_baked``: its values are in slot order)."""
    mode = _mode()
    base = _base(device)
    if mode == "autodiff":
        return "autodiff"
    if mode == "fused":
        return "fused"
    if mode == "fm":
        return "fm" if has_fm else base
    if mode == "pallas":
        return "pallas" if has_aligned else ("fm" if has_fm else base)
    if mode == "xchg":
        return "xchg" if has_xchg else (
            "pallas" if has_aligned else ("fm" if has_fm else base))
    if mode == "benes":
        return "benes" if has_benes else (
            "pallas" if has_aligned else ("fm" if has_fm else base))
    # Below the floor the measurement costs more than any route difference
    # could repay.
    if e_total < _probe_floor():
        return base
    dev = _device(device)
    on_card = _on_card(dev)
    with_pallas = has_aligned and on_card
    # xchg needs the card but not the aligned layout, as in the reference:
    # an aligned route reduces over al, which has_xchg then implies; a cumsum
    # route carries its own feature bounds.  The reduce mode (the route's
    # kind) and the baking enter the probe's key.
    with_xchg = has_xchg and on_card
    if not (has_fm or with_pallas or with_xchg):
        return base  # one candidate: nothing to measure
    # The exchange's timing depends on its reduce mode and on whether the
    # values were baked into slot order: both enter the key.
    xchg_cfg = ((os.environ.get("PHOTON_XCHG_REDUCE", "aligned"), bool(xchg_baked))
                if with_xchg else None)
    key = (
        dev.type, _device_name(dev), _bucket(e_total), _bucket(dim),
        with_pallas, with_xchg, xchg_cfg, bool(has_fm),
    )
    if key not in _CACHE:
        scale = max(1, -(-e_total // _probe_cap()))  # ceil: cap the probe size
        e = max(e_total // scale, 1 << 10)
        n = max(n_rows // scale, 64)
        record: dict = {}
        # No catch: a probe that cannot build or launch a kernel raises
        # (the reference pins autodiff here, which would hide the fault).
        _CACHE[key] = _measure(
            e, dim, n, with_pallas, with_xchg, xchg_baked=bool(xchg_baked),
            with_fm=bool(has_fm), device=dev, record=record,
        )
        record["choice"] = _CACHE[key]
        PROBE_RECORD[key] = record
        _LOG.info("sparse-grad route for %s e~2^%d d~2^%d: %s",
                  key[1], key[2], key[3], _CACHE[key])
    choice = _CACHE[key]
    if choice == "xchg" and not has_xchg:
        choice = "pallas" if has_aligned else "fm"
    if choice == "pallas" and not has_aligned:
        choice = "fm"
    if choice == "fm" and not has_fm:
        choice = base
    return choice


def aligned_layout_wanted(e_total: Optional[int] = None, device=None) -> bool:
    """Should the attach pay the host-side aligned-layout build?  When
    the ``pallas``, ``xchg`` or ``benes`` route is forced, or when ``auto``
    could pick ``pallas``: on the card, at or above the probe floor (pass
    the entry count when known)."""
    mode = _mode()
    if mode in ("pallas", "benes", "xchg"):
        return True
    if mode != "auto":
        return False
    if e_total is not None and e_total < _probe_floor():
        return False
    return _on_card(device)


def xchg_route_wanted(e_total: int, device=None) -> bool:
    """Should the attach pay the exchange route's host build (edge
    colorings, the costliest layout build)?  When ``xchg`` is forced; in
    ``auto`` only on the card at or above ``PHOTON_XCHG_FLOOR`` entries
    (default 2^23), unless ``PHOTON_XCHG=0``, and only where the host router
    builds."""
    mode = _mode()
    if mode == "xchg":
        return True
    if mode != "auto" or os.environ.get("PHOTON_XCHG", "1") == "0":
        return False
    if e_total < env_int("PHOTON_XCHG_FLOOR", 1 << 23, minimum=1):
        return False
    if not _on_card(device):
        return False
    from photon_tpu_torch.native.build import get_lib

    return get_lib() is not None


def benes_route_wanted() -> bool:
    """Should the attach pay the Clos routing of the ``benes`` route
    (one edge coloring of the whole entry stream)?  Only when ``benes`` is
    forced, as in the reference: ``auto`` never pays it speculatively."""
    return _mode() == "benes"


def fm_path_wins(e_total: int, dim: int, n_rows: int, device=None) -> bool:
    """Boolean view of :func:`select_kernel` (``fm`` against the base
    route)."""
    return select_kernel(e_total, dim, n_rows, has_fm=True, has_aligned=False,
                         device=device) == "fm"
