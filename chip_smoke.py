#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``photon_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit, torch/CUDA versions; build the CUDA
   kernels from ``photon_tpu_torch/ops/csrc`` and the host library (the
   router, the LIBSVM parser and the Avro decoder) from
   ``photon_tpu_torch/native/src`` and time both builds; a host library
   that does not build fails the run;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes: the fused value+gradient (four losses, ragged row count,
   uniform and zipf ids, zero-weight rows; the hot-set cases of
   ``FUSED_CASES``: zipf exponents 1.1, 1.3 and 2.0, one id in every slot,
   more hot candidates than slots, d = 64, k = 48, phase 6's fixed-effect
   batch shape (n = 239,534, k = 8, d = 19, every id hot), phase 7's
   config-2 batch (squared loss, n = 40,000 dense rows of k = 1024, d =
   1024, all 1024 features hot); a hot set gone stale;
   two calls in one form bit for bit on the hot ids), the row scatter of
   the ``fused`` route's Hv (``ROW_SCATTER_CASES``: both draws, a constant
   r), the slab position-reduce (gradient and forward layouts, uniform and
   zipf ids, padded geometry, phase 6's fixed-effect batch shape and
   phase 7's config-2 batch),
   and the three permutation passes of the ``xchg`` route (K4 chunk, K5
   lane, K6 chunk-expand) over the main path's own routes, each launch bit
   for bit: the route of each id draw (balanced: K6 + K4, and K4 in the
   value bake; colored: K4 + K5 + K4) and, when neither draw takes the
   colored route, one forced on the uniform batch; K4 and K6 in both forms
   (the cluster form ``chunk_form`` picks and the global form), there and
   at the edge shapes of ``chunk_form_edges`` on random in-range planes
   (one chunk, K4's largest cluster chunk and 8 rows above it, ch = 8192,
   K6 at k = 1, 4, 32, 128); then each route's slot
   products bit for bit against the ``pallas`` route's and its gradient
   under the gradient gate; the slab gather (K3) bit for bit on both
   draws' gradient layouts; the ``benes`` route of the uniform batch: its
   two Clos directions composed to the identity and its slot products bit
   for bit against the ``pallas`` route's, its gradient and forward under
   the gradient gate;
3. the main path: ``GlmOptimizationProblem.run`` (L-BFGS, logistic + L2) at
   the headline GLM shape n=2^20, k=32, d=2^18 on the ``fused``, ``pallas``
   and ``xchg`` routes, uniform and zipf ids (and one ``value_and_grad`` on
   a forced colored route, when there is one); each kernel's launch count
   over each run (K4's and K6's per form: every main-path launch must take
   the cluster form), per-evaluation time, steps/s, layout and route build
   seconds, and each kernel's time beside its plain version's, a library
   call's and its bound (K4 and K6 also in the global form; the row
   scatter beside ``index_add_`` in float32 and float64); then TRON
   (Poisson + L2) at the same shape on the ``fused``, ``pallas``, ``xchg``
   and ``benes`` routes (uniform ids) and the first three (zipf ids):
   iterations, CG steps, host reads, seconds per outer iteration,
   milliseconds per Hessian-vector product and each kernel's launches (on
   ``fused`` the row scatter's too);
4. the ``train`` CLI on the a1a fixture, on the card (default route and
   ``xchg``) and with ``--backend cpu``; then with ``--optimizer tron`` on
   the card, with ``--backend cpu`` and on the card under ``benes``; the
   AUCs must agree;
5. the primitive probes: the seven probe kernels (PK1-PK7,
   ``ops/probe_kernels.py``) against their plain versions and a library
   call, bit for bit, at the probe tools' default shapes (E = 2^25, PK1 at
   windows of 128 and 2048, PK2 masked and unmasked and PK3 at every tile
   height and at 262,143 rows; PK5 also at one chunk, ch = 8, 256, 512,
   1024, 4096 and 8192, and with its planes out of range, each in the form
   ``fused_chunk_form`` picks; PK7 at every k and at 262,143 rows), each
   launch counted; PK5 at the tool's shape, PK3, PK2 unmasked and PK7 at
   k = 32 timed in turns with their library calls, medians and spreads and
   the wrapper's host time per call beside their bars (reported, not
   enforced); then the three probe tools' probe functions
   (``photon_tpu_torch/tools``) at E = 2^25 and ``probe_permute``'s rows h
   and i at 2^26 (the headline ``benes`` grid), every probe kernel launched;
   then the measured ``auto`` route probe on phase 2's batches of each id
   draw: each candidate's gate error and median seconds and the choice, no
   candidate excluded, and a 10-iteration L-BFGS fit under ``auto`` held to
   phase 3's fit on the chosen route;
6. GAME: BASELINE.json config 4 (a fixed effect over 18 genre indicators +
   intercept, a per-user random effect over the same 19 columns, logistic)
   at ``bench.py``'s scale for it (``make_movielens_like`` with
   MovieLens-1M's 6040 users and 3700 items, ~300K ratings), written to
   Avro with the port's writer, read once by the native decoder and once
   by the Python reader (each timed, the two held equal bit for bit), and
   trained by the port's ``train_game`` (each run reading through the
   native decoder)
   with ``bench.py``'s arguments (two descent iterations, a 0.2 validation
   split) on the card under ``fused``, ``pallas`` and ``auto`` and with
   ``--backend cpu``, each run with every launch count set to 0 just
   before it; each card run's validation metrics held to the host run's
   within 1e-4 and its coefficients within rtol = atol = 1e-3; K1 must
   launch on the ``fused`` run and K2 on the ``pallas`` run, no probe
   kernel on any; the Avro write and read seconds, seconds per descent
   iteration, rows/s, per-coordinate solver records (L-BFGS evaluations;
   per size bin entities, capacity, route, Newton iterations and host
   reads) and the residual updates and host syncs per iteration; then the
   random-effect path's torch ops (lane value and gradient, the float64
   Hessian scatter, the batched Cholesky step, one line-search block of
   values, the whole Newton fit) per bin, on the first run's dataset, and
   the score table's update and offsets pass, each beside its bytes bound;
7. BASELINE.json config 2 (``bench.py:360-370``): ``make_glm_data``
   linear regression, seed 0, d = 1024 (1023 Gaussian features and the
   intercept), 40,000 training rows and a 20% validation split written as
   LIBSVM and parsed natively, trained through the train CLI's entry point
   (OWL-QN, elastic net, weight 1.0, 100 iterations) on the card under
   ``fused`` (K1 must launch) and under ``pallas`` with standardization (K2
   must launch, K1 must not), then on 8,000 rows on the card and the host,
   the card held to the host (validation RMSE 1e-4 relative, coefficients
   rtol = atol = 1e-3); then the score CLI on the validation file with the
   card's model on the card and the host (scores within 1e-4 of each other,
   RMSE the train summary's to 1e-6);
8. serving on the card, with every kernel's launch count set to 0 just
   before it and read after (the serving path has no hand-written kernel;
   the retrain below runs K1): (a) ``score_game`` on phase 6's ``fused``
   model over its Avro file on the card, on the host and through the host
   oracle, the scores within 1e-5; (b) the ``GameScorer`` at
   ``bench.py``'s serving fixture (20,000 entities, two random coordinates
   and a fixed effect of d = 32, 1500 geometric requests of mean 8 rows,
   cap 128, 16 closed-loop clients) for f32, bf16 and int8: captures and
   allocator segments at warmup and after serving (no new one may appear),
   host syncs against batches (equal), parity against the host oracle
   under ``PARITY_TOL`` (``bench.py``'s window, the worst over all
   requests beside it), table bytes against the reference's bars (bf16
   1.9x, int8 3.5x), QPS, p50 and p99, and per bucket the graph's replay
   and the eager body (CUDA events) beside the bytes bound and the whole
   batch on the host clock; (c) ``serve_game`` with two replicas,
   power-law traffic, a 10% cold-start storm and a deadline, then a
   two-replica fleet under load taking a rollout of phase 6's fit retrained
   with one descent iteration: no request dropped, every response wholly
   one model's, the tail the new model's, nothing captured.

The line before the last is a JSON object with one entry per kernel (the
probe kernels' ``launches`` count the probe tools' run; phases 3 and 6 check
that the training paths launch none of them; K1's and K2's
``game_launches`` count phase 6's runs, ``config2_launches`` phase 7's); the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

N, K, D = 1 << 20, 32, 1 << 18  # headline GLM shape (rows, nnz per row, dim)
LBFGS_ITERATIONS = 10
TRON_ITERATIONS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, data sheet
# Kernel vs plain, on the card, element by element:
#   |kernel - plain| <= rtol * |plain| + SUM_ULPS * 2^-23 * mag,
# where mag is the sum of the magnitudes of the terms behind that element
# (for K1's gradient also sum weight * |val|, which bounds the rounding of
# each row's coefficient).  Two f32 sums of the same terms in two orders
# differ by about one ulp of mag; float atomics sum in a different order
# every run.  Each element is held to its own terms, so a wrong entry fails
# on a cold feature as surely as on the hottest.  The rtol terms cover the
# drift of long sums of one sign (the hottest zipf features): the
# reference's own on-device gradient gate (photon_tpu/ops/
# sparse_grad_select.py _measure) for the gradient, and f32 sums of up to
# 2^20 (value) or 8192 (partials) terms.
VALUE_RTOL = 1e-5
GRAD_RTOL = 2e-4
PARTIAL_RTOL = 2e-5
SUM_ULPS = 16
F32_ULP = 2.0 ** -23
# Final objective of the two routes after the same L-BFGS iterations: the
# same solver on differently ordered f32 sums; the repository's notes put
# two f32 fits of one problem ~1e-4 apart.
ROUTE_RTOL = 1e-4
CLI_AUC_ATOL = 1e-4
# The permutation passes (K4, K5, K6) move data and compute nothing: they are
# held to their plain versions bit for bit (torch.equal), and so are the
# xchg route's slot products to the pallas route's ``dz[rows] * vals``.  The
# two routes' gradients then share K2 and its epilogue, whose index_add_
# sums a key split over several dictionary slots (the hot zipf features)
# with atomics, in another order each run (in float64, rounded once): they
# are held to the gradient gate (GRAD_RTOL plus SUM_ULPS of the key's
# summed magnitudes).
# The same holds for the benes route: the slab gather (one f32 multiply a
# slot), its Clos permutations and its slot products bit for bit; its
# gradient and its forward (per-row sums in another order than the
# row-major gather's) under the gradient gate.
DISTS = ("uniform", "zipf")
BENES_DISTS = ("uniform",)  # the benes route is built for uniform ids only


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, operations: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = operations / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_ids(rng, n: int, k: int, d: int, dist: str, exponent: float = 1.3) -> np.ndarray:
    """Feature ids as the repository's benchmark draws them (id 0 is left
    for the pad slot); ``exponent`` is the zipf draw's."""
    if dist == "zipf":
        return (1 + (rng.zipf(exponent, size=(n, k)) - 1) % (d - 1)).astype(np.int32)
    return rng.integers(1, d, size=(n, k), dtype=np.int32)


def make_batch(dist: str, seed: int, device):
    """The benchmark's synthetic logistic batch at the headline shape."""
    from photon_tpu_torch.data.batch import SparseBatch

    rng = np.random.default_rng(seed)
    ids = make_ids(rng, N, K, D, dist)
    vals = rng.standard_normal((N, K)).astype(np.float32)
    w_true = rng.standard_normal(D).astype(np.float32) * 0.1
    margin = (w_true[ids] * vals).sum(axis=1)
    label = (rng.random(N) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return SparseBatch(
        ids=put(ids), vals=put(vals), label=put(label),
        offset=torch.zeros(N, device=device), weight=torch.ones(N, device=device),
    )


def gate_report(name, got, ref, rtol, mag=None) -> float:
    """Hold ``got`` to ``ref`` element by element (see SUM_ULPS above);
    ``mag`` is the per-element sum of term magnitudes, None for a scalar
    held to ``rtol`` alone.  Returns the largest absolute error."""
    got = got.double().cpu().numpy().reshape(-1)
    ref = ref.double().cpu().numpy().reshape(-1)
    atol = (np.zeros_like(ref) if mag is None
            else SUM_ULPS * F32_ULP * mag.double().cpu().numpy().reshape(-1))
    err = np.abs(got - ref)
    tol = rtol * np.abs(ref) + atol
    ok = bool(np.all(err <= tol))  # NaN fails
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(err == 0, 0.0, err / tol)
    worst = int(np.argmax(ratio))
    log(f"  {name}: max_abs_err={err.max():.3e}; worst element err={err[worst]:.3e}"
        f" against tol={tol[worst]:.3e}, err/tol={ratio[worst]:.3f} (rtol={rtol:g}, "
        f"atol={atol[worst]:.3e}; median atol {np.median(atol):.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return float(err.max())


# The GAME fixed effect's batch (rows, nonzeros per row, d) in phase 6.
GAME_FIXED_SHAPE = (239_534, 8, 19)
# Phase 7, BASELINE.json config 2 (bench.py:360-370): d = 1024 (1023 dense
# Gaussian features and the intercept, so k = 1024), training rows cut from
# bench.py's 200,000 to a fifth for the time limit, a 20% validation split;
# the host runs (and the card runs held to them) on fewer rows.
CONFIG2_ROWS = 40_000
CONFIG2_HOST_ROWS = 8_000
CONFIG2_D = 1024
CONFIG2_SHAPE = (CONFIG2_ROWS, CONFIG2_D, CONFIG2_D)

# K1's cases in phase 2: (loss, ids draw, rows, nonzeros per row, d).  The
# draws beyond the main path's two: zipf exponents 1.1 and 2.0; one id in
# every non-pad slot; 1536 features of one share each, more hot candidates
# than the kernel's slots; d = 64, every feature hot; k = 48, the kernels'
# loop for rows of more than 32 entries; the GAME fixed effect's batch in
# phase 6 (the training split's 239,534 rows, k = 8 with pads, d = 19,
# every feature hot); phase 7's config-2 batch (squared loss, every row ids
# 0..1022 and the intercept 1023, no pads: all 1024 features hot).
FUSED_CASES = (
    *[(loss, "uniform", N, K, D) for loss in
      ("logistic", "squared", "poisson", "smoothed_hinge")],
    ("logistic", "zipf1.3", N, K, D), ("logistic", "uniform", N - 77, K, D),
    ("logistic", "zipf1.1", N, K, D), ("logistic", "zipf2.0", N, K, D),
    ("logistic", "one_id", N, K, D), ("logistic", "candidates", N, K, D),
    ("poisson", "all_hot", N, K, 64), ("logistic", "zipf1.3", 1 << 16, 48, D),
    ("logistic", "all_hot", *GAME_FIXED_SHAPE),
    ("squared", "dense", *CONFIG2_SHAPE),
)


def fused_case_ids(rng, n: int, k: int, d: int, draw: str) -> np.ndarray:
    """The ids of a FUSED_CASES draw (a zipf draw names its exponent)."""
    if draw.startswith("zipf"):
        return make_ids(rng, n, k, d, "zipf", float(draw[4:]))
    if draw == "one_id":
        return np.full((n, k), 7, np.int32)
    if draw == "candidates":
        return rng.integers(1, 1537, size=(n, k), dtype=np.int32)
    if draw == "all_hot":
        return rng.integers(0, d, size=(n, k), dtype=np.int32)
    if draw == "dense":
        return np.tile(np.arange(k, dtype=np.int32), (n, 1))
    return make_ids(rng, n, k, d, draw)


def fused_inputs(rng, loss_name: str, n: int, k: int, d: int, draw: str, dev) -> list:
    """(w, ids, vals, label, offset, weight) on the card: padded row tails
    (id 0, val 0; a dense draw has none and the intercept's value 1 in its
    last slot), labels for the loss, 10% zero-weight rows."""
    ids = fused_case_ids(rng, n, k, d, draw)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    if draw == "dense":
        vals[:, -1] = 1.0
    else:
        cut = rng.integers(1, k + 1, size=n)  # padded row tails
        pad = np.arange(k)[None, :] >= cut[:, None]
        ids[pad], vals[pad] = 0, 0.0
    if loss_name == "poisson":
        label = rng.poisson(1.5, size=n).astype(np.float32)
    elif loss_name == "squared":
        label = rng.standard_normal(n).astype(np.float32)
    else:
        label = (rng.random(n) < 0.5).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32)
    weight[rng.random(n) < 0.1] = 0.0  # zero-weight rows
    offset = (rng.standard_normal(n) * 0.1).astype(np.float32)
    w = (rng.standard_normal(d) * 0.1).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (w, ids, vals, label, offset, weight)]


def gate_fused(tag: str, loss, args, got) -> float:
    """K1's (value, grad) against the plain version's under the value and
    gradient gates; returns the largest absolute error."""
    from photon_tpu_torch.data.batch import gather_dot
    from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad_plain

    v_p, g_p = fused_value_and_grad_plain(loss, *args)
    w_t, ids_t, vals_t, label_t, offset_t, weight_t = args
    coeff = weight_t * loss.d1(gather_dot(w_t, ids_t, vals_t) + offset_t, label_t)
    mag = torch.zeros_like(w_t).index_add_(
        0, ids_t.view(-1),
        ((coeff.abs() + weight_t)[:, None] * vals_t.abs()).view(-1),
    )
    torch.cuda.synchronize()
    return max(gate_report(tag + " value", got[0], v_p, VALUE_RTOL),
               gate_report(tag + " grad", got[1], g_p, GRAD_RTOL, mag))


def hot_ids_equal(tag: str, hot, first: torch.Tensor, second: torch.Tensor) -> None:
    """Two calls' outputs on the hot ids, bit for bit: in one kernel form
    (one grid) the hot slots are summed in a fixed order."""
    if not hot.n_hot:
        return
    at = hot.ids[: hot.n_hot].long()
    same = torch.equal(first[at], second[at])
    log(f"  {tag}: two calls on the {hot.n_hot} hot ids bit for bit "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{tag}: the hot ids' sums differ between two calls")


def check_fused_kernel(dev) -> dict:
    """K1 in every FUSED_CASES case against its plain version, twice: the
    first call on new ids takes the form with every hot slot (the set's size
    is not read yet), the second the form that size picks; the hot ids bit
    for bit between the second call and a third.  The hot set's size is
    held to the draw where it is known: 0 on uniform ids, every slot with more candidates, every
    feature where every feature is hot (d = 64 and the GAME batch's d = 19).  Then a hot set gone stale (ids changed behind the
    version counter) both ways between zipf and uniform ids, and the bad-id
    checks."""
    from photon_tpu_torch.core.losses import get_loss
    from photon_tpu_torch.ops import fused_sparse as fs

    worst = 0.0
    ragged = None
    for i, (loss_name, draw, n, k, d) in enumerate(FUSED_CASES):
        rng = np.random.default_rng(100 + i)
        args = fused_inputs(rng, loss_name, n, k, d, draw, dev)
        loss = get_loss(loss_name)
        first = fs.fused_value_and_grad(loss, *args)
        hot = fs.hot_set(args[1], args[2], d)
        second = fs.fused_value_and_grad(loss, *args)
        third = fs.fused_value_and_grad(loss, *args)
        tag = f"fused_sparse[{loss_name},{draw},n={n},k={k},d={d},n_hot={hot.n_hot}]"
        for call, got in (("first call", first), ("second call", second)):
            worst = max(worst, gate_fused(f"{tag} {call}", loss, args, got))
        hot_ids_equal(tag, hot, second[1], third[1])
        expect_hot = {"uniform": 0, "candidates": fs.HOT_SLOTS, "all_hot": d, "dense": d}
        if expect_hot.get(draw, hot.n_hot) != hot.n_hot or (draw != "uniform" and not hot.n_hot):
            raise AssertionError(f"{tag}: unexpected hot set size {hot.n_hot}")
        if (loss_name, draw, n) == ("logistic", "uniform", N - 77):
            ragged = (loss, args, first[0])
    # A hot set gone stale: ids changed through .data keep their version, so
    # the wrapper keeps the set (and its size) it built for the old ids.
    loss = get_loss("logistic")
    for i, (built_on, changed_to) in enumerate((("zipf1.3", "uniform"),
                                                ("uniform", "zipf1.3"))):
        rng = np.random.default_rng(200 + i)
        args = fused_inputs(rng, "logistic", N, K, D, built_on, dev)
        fs.fused_value_and_grad(loss, *args)
        hot = fs.hot_set(args[1], args[2], D)
        new_ids = fused_case_ids(rng, N, K, D, changed_to)
        new_ids[args[2].cpu().numpy() == 0] = 0
        args[1].data.copy_(torch.as_tensor(new_ids, device=dev))
        if fs.hot_set(args[1], args[2], D) is not hot:
            raise AssertionError("the hot set was rebuilt: the stale case did not arise")
        got = fs.fused_value_and_grad(loss, *args)
        worst = max(worst, gate_fused(
            f"fused_sparse[hot set of {built_on} ids (n_hot={hot.n_hot}) on "
            f"{changed_to} ids]", loss, args, got))
    # An id outside [0, d) raises IndexError, as the plain version does on
    # the CPU: in a new ids tensor, and in one the kernel had already found
    # clean and that was then changed in place.  The kernel reads nothing
    # out of bounds, so the card stays usable: the same call on the clean
    # batch then gives the same value (the loss sum is deterministic, and
    # the ids' hot set is rebuilt, so the call takes the first call's form).
    loss, args, v_k = ragged
    ids_t = args[1]
    n = ids_t.shape[0]
    keep = int(ids_t[n // 2, 0])
    for bad_id, in_place in ((-1, False), (D, False), (D, True)):
        bad = ids_t if in_place else ids_t.clone()
        bad[n // 2, 0] = bad_id
        try:
            fs.fused_value_and_grad(loss, args[0], bad, *args[2:])
        except IndexError as e:
            log(f"  fused_sparse[id {bad_id}, in place {in_place}]: raised "
                f"IndexError ({e}) ok")
        else:
            raise AssertionError(f"fused_sparse: id {bad_id} did not raise")
    ids_t[n // 2, 0] = keep
    v_again, _ = fs.fused_value_and_grad(loss, *args)
    if float(v_again) != float(v_k):
        raise AssertionError("fused_sparse: value changed after a raising call")
    return {"max_abs_err": worst}


# The row scatter's cases in phase 2: (ids draw, r, nonzeros per row).
ROW_SCATTER_CASES = (("uniform", "random", K), ("zipf", "random", K),
                     ("zipf", "constant", K), ("zipf", "random", 48))


def check_row_scatter(dev) -> dict:
    """The row scatter against its plain version under the gradient gate,
    on both draws with a random r and on zipf ids with a constant r (and at
    k = 48), each as K1 is: the first call in the form with every hot slot,
    the second in the form the set's size picks, the hot ids bit for bit
    between the second and a third.  Then an id outside [0, d) raises."""
    from photon_tpu_torch.ops import fused_sparse as fs

    worst = 0.0
    for i, (dist, r_kind, k) in enumerate(ROW_SCATTER_CASES):
        rng = np.random.default_rng(300 + i)
        n = N if k == K else 1 << 16
        ids = make_ids(rng, n, k, D, dist)
        vals = rng.standard_normal((n, k)).astype(np.float32)
        r = (np.full(n, 0.5, np.float32) if r_kind == "constant"
             else rng.standard_normal(n).astype(np.float32))
        ids_t, vals_t, r_t = (torch.as_tensor(a, device=dev) for a in (ids, vals, r))
        first = fs.row_scatter(r_t, ids_t, vals_t, D)
        hot = fs.hot_set(ids_t, vals_t, D)
        second = fs.row_scatter(r_t, ids_t, vals_t, D)
        third = fs.row_scatter(r_t, ids_t, vals_t, D)
        ref = fs.row_scatter_plain(r_t, ids_t, vals_t, D)
        mag = fs.row_scatter_plain(r_t.abs(), ids_t, vals_t.abs(), D)
        torch.cuda.synchronize()
        tag = f"row_scatter[{dist}, {r_kind} r, n={n}, k={k}, n_hot={hot.n_hot}]"
        for call, got in (("first call", first), ("second call", second)):
            worst = max(worst, gate_report(f"{tag} {call}", got, ref, GRAD_RTOL, mag))
        hot_ids_equal(tag, hot, second, third)
        if (hot.n_hot == 0) != (dist == "uniform"):
            raise AssertionError(f"{tag}: unexpected hot set size")
    bad = ids_t.clone()
    bad[3, 1] = D
    try:
        fs.row_scatter(r_t, bad, vals_t, D)
    except IndexError as e:
        log(f"  row_scatter[id {D}]: raised IndexError ({e}) ok")
    else:
        raise AssertionError("row_scatter: an id outside [0, d) did not raise")
    return {"max_abs_err": worst}


def check_position_kernel(dev) -> dict:
    from photon_tpu_torch.ops.slab_reduce import (
        SLAB_POSITIONS,
        build_aligned_layout,
        build_row_aligned_layout,
        device_layout,
        pad_aligned_layout,
        position_partial_sums,
        position_partial_sums_plain,
    )

    rng = np.random.default_rng(7)
    layouts = {}
    for dist in ("uniform", "zipf"):
        ids = make_ids(rng, N, K, D, dist)
        vals = rng.standard_normal((N, K)).astype(np.float32)
        layouts[("grad", dist)] = (build_aligned_layout(ids, vals, D), N)
        layouts[("forward", dist)] = (build_row_aligned_layout(ids, vals), D)
    # The GAME fixed effect's batch (phase 6's pallas run): every id hot.
    n_g, k_g, d_g = GAME_FIXED_SHAPE
    ids = rng.integers(0, d_g, size=(n_g, k_g), dtype=np.int32)
    vals = rng.standard_normal((n_g, k_g)).astype(np.float32)
    pad = np.arange(k_g)[None, :] >= rng.integers(1, k_g + 1, size=n_g)[:, None]
    ids[pad], vals[pad] = 0, 0.0
    game_layouts = {("grad", "game"): (build_aligned_layout(ids, vals, d_g), n_g),
                    ("forward", "game"): (build_row_aligned_layout(ids, vals), d_g)}
    # Phase 7's config-2 batch: dense rows of ids 0..1023, the intercept's
    # value 1 last.
    n_c, k_c, d_c = CONFIG2_SHAPE
    ids = np.tile(np.arange(k_c, dtype=np.int32), (n_c, 1))
    vals = rng.standard_normal((n_c, k_c)).astype(np.float32)
    vals[:, -1] = 1.0
    config2 = (ids, vals)
    t0 = time.monotonic()
    game_layouts[("grad", "config2")] = (build_aligned_layout(ids, vals, d_c), n_c)
    game_layouts[("forward", "config2")] = (build_row_aligned_layout(ids, vals), d_c)
    log(f"  config-2 layouts (n={n_c:,}, k={k_c}, d={d_c}) built in "
        f"{time.monotonic() - t0:.1f} s")
    # Padded geometry: each direction's two layouts padded to the common
    # (slabs, tiles) target, as stacked per-shard layouts are.
    for direction in ("grad", "forward"):
        geo = [layouts[(direction, d)][0] for d in ("uniform", "zipf")]
        s_max = max(l.n_slabs for l in geo)
        t_max = max(l.n_tiles + s_max - l.n_slabs for l in geo) + 3
        for dist in ("uniform", "zipf"):
            lay, payload = layouts[(direction, dist)]
            layouts[(direction, dist + "+padded")] = (
                pad_aligned_layout(lay, s_max + 2, t_max + 2), payload
            )
    layouts.update(game_layouts)
    worst = 0.0
    for (direction, dist), (lay, payload) in layouts.items():
        al = device_layout(lay, dev)
        per = torch.as_tensor(
            rng.standard_normal(payload).astype(np.float32), device=dev
        )
        pv = per.index_select(0, al.rows.view(-1)).view(al.rows.shape) * al.vals
        got = position_partial_sums(al.slab_of_tile, pv, al.lo, al.n_slabs)
        ref = position_partial_sums_plain(al.slab_of_tile, pv, al.lo, al.n_slabs)
        mag = position_partial_sums_plain(
            al.slab_of_tile, pv.abs(), al.lo, al.n_slabs)
        torch.cuda.synchronize()
        worst = max(worst, gate_report(
            f"position_reduce[{direction},{dist},tiles={lay.n_tiles},"
            f"slabs={lay.n_slabs}]", got, ref, PARTIAL_RTOL, mag,
        ))
        if dist.endswith("padded"):
            real = layouts[(direction, dist.split("+")[0])][0].n_slabs
            tail = got.view(-1)[real * SLAB_POSITIONS:]
            if not bool(torch.all(tail == 0)):
                raise AssertionError("pad slabs must come out written as zeros")
        if dist == "config2":
            config2 += (al,)
    return {"max_abs_err": worst, "config2": config2}


def config2_kernel_timings(arrays, dev) -> dict:
    """K1 (squared loss) and K2 (its gradient and forward layouts) timed at
    phase 7's config-2 shape, beside their plain versions and bounds; the
    batch and layouts are phase 2's (``arrays``: ids, vals, the gradient
    and forward device layouts)."""
    from photon_tpu_torch.data.batch import SparseBatch

    ids, vals, al, al_t = arrays
    n, d = ids.shape[0], CONFIG2_D
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    batch = SparseBatch(ids=put(ids), vals=put(vals), label=torch.randn(n, device=dev),
                        offset=torch.zeros(n, device=dev), weight=torch.ones(n, device=dev))
    log(f"  at config 2's shape (n={n:,}, k={ids.shape[1]}, d={d}, squared loss):")
    return kernel_timings(batch, al, al_t, dev, d=d, loss_name="squared")


def kernel_timings(batch, al, al_t, dev, d: int = D, loss_name: str = "logistic") -> dict:
    """Kernel, plain and library times and bounds at the shapes of ``batch``
    (``d`` coefficients) and its layouts ``al``/``al_t``: the main path's,
    or phase 7's config-2 batch."""
    from photon_tpu_torch.core.losses import get_loss
    from photon_tpu_torch.data.batch import scatter_sum
    from photon_tpu_torch.ops.fused_sparse import (
        fused_value_and_grad,
        fused_value_and_grad_plain,
        hot_set,
        row_scatter,
        row_scatter_plain,
    )
    from photon_tpu_torch.ops.slab_reduce import (
        LANES,
        TILE_SUBLANES,
        position_partial_sums,
        position_partial_sums_plain,
    )

    out = {}
    loss = get_loss(loss_name)
    w = torch.randn(d, device=dev) * 0.01
    args = (loss, w, batch.ids, batch.vals, batch.label, batch.offset, batch.weight)
    n, k = batch.ids.shape
    nnz = int((batch.vals != 0).sum())
    t_bound, by = bound(8 * n * k + 12 * n + 8 * d + 4, 4 * nnz + 20 * n)
    saved = fused_value_and_grad.launches, row_scatter.launches
    fused_value_and_grad(*args)  # the hot set and its size, outside the timing
    n_hot = hot_set(batch.ids, batch.vals, d).n_hot
    out["fused_sparse"] = {
        "ms": cuda_ms(lambda: fused_value_and_grad(*args)),
        "plain_ms": cuda_ms(lambda: fused_value_and_grad_plain(*args)),
        "bound_ms": t_bound, "bound_by": by, "library_ms": None, "n_hot": n_hot,
    }
    # The row scatter at the same shape, with its library calls: one
    # index_add_ of the products r_i * vals_ij (formed once, here) in float32
    # and in float64.  The float32 one is the card's rate of random L2
    # atomics on uniform ids (one atomic an entry).
    r = torch.randn(n, device=dev)
    rs_args = (r, batch.ids, batch.vals, d)
    idx = batch.ids.view(-1).long()
    prod = (r[:, None] * batch.vals).view(-1)
    prod64 = prod.double()
    out32 = torch.zeros(d, device=dev)
    out64 = torch.zeros(d, dtype=torch.float64, device=dev)
    # ids and vals read once, r read once, the float32 result written once;
    # one multiply and one add an entry.
    t_bound, by = bound(8 * n * k + 4 * n + 4 * d, 2 * nnz)
    lib32 = cuda_ms(lambda: out32.zero_().index_add_(0, idx, prod))
    out["row_scatter"] = {
        "ms": cuda_ms(lambda: row_scatter(*rs_args)),
        "plain_ms": cuda_ms(lambda: row_scatter_plain(*rs_args)),
        "library_ms": lib32,
        "library_f64_ms": cuda_ms(lambda: out64.zero_().index_add_(0, idx, prod64)),
        "library_atomics_per_s": n * k / (lib32 * 1e-3),
        "bound_ms": t_bound, "bound_by": by, "n_hot": n_hot,
    }
    fused_value_and_grad.launches, row_scatter.launches = saved
    saved = position_partial_sums.launches
    for direction, lay, payload in (("grad", al, n), ("forward", al_t, d)):
        per = torch.randn(payload, device=dev)
        pv = per.index_select(0, lay.rows.view(-1)).view(lay.rows.shape) * lay.vals
        n_tiles = int(lay.slab_of_tile.shape[0])
        tile = torch.arange(n_tiles * TILE_SUBLANES, device=dev) // TILE_SUBLANES
        flat_idx = (
            (lay.slab_of_tile[tile].long()[:, None] * 8 + lay.lo.long()) * LANES
            + torch.arange(LANES, device=dev)[None, :]
        ).view(-1)
        flat_out = torch.zeros(lay.n_slabs * 8 * LANES, device=dev)
        e_pad = pv.numel()
        t_bound, by = bound(8 * e_pad + 4 * n_tiles + 4 * lay.n_slabs * 1024, e_pad)
        partial = position_partial_sums(lay.slab_of_tile, pv, lay.lo, lay.n_slabs)
        out_dim = d if direction == "grad" else n
        out[f"position_reduce[{direction}]"] = {
            # The route's other two stages, torch ops around the kernel: the
            # pv gather and the epilogue into out_dim key sums.
            "gather_ms": cuda_ms(lambda: per.index_select(
                0, lay.rows.view(-1)).view(lay.rows.shape) * lay.vals),
            "epilogue_ms": cuda_ms(lambda: scatter_sum(
                lay.sorted_feats, partial.view(-1).index_select(0, lay.grad_perm),
                out_dim)),
            "ms": cuda_ms(lambda: position_partial_sums(
                lay.slab_of_tile, pv, lay.lo, lay.n_slabs)),
            "plain_ms": cuda_ms(lambda: position_partial_sums_plain(
                lay.slab_of_tile, pv, lay.lo, lay.n_slabs)),
            "library_ms": cuda_ms(
                lambda: flat_out.zero_().index_add_(0, flat_idx, pv.view(-1))
            ),
            "bound_ms": t_bound, "bound_by": by,
            "tiles": n_tiles, "slabs": lay.n_slabs,
        }
    position_partial_sums.launches = saved
    for name, row in out.items():
        lib = row["library_ms"]
        stages = (f", route stages: gather {row['gather_ms']:.4f} ms, epilogue "
                  f"{row['epilogue_ms']:.4f} ms" if "gather_ms" in row else "")
        if "library_f64_ms" in row:
            stages += (f", index_add_ in float64 {row['library_f64_ms']:.4f} ms; "
                       f"float32 index_add_ {row['library_atomics_per_s'] / 1e9:.2f} "
                       f"G atomics/s")
        if "n_hot" in row:
            stages += f", hot set {row['n_hot']} ids"
        log(f"  {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}){stages}")
    return out


def prepare_batches(dev) -> dict:
    """The main path's batches: per id draw, the headline batch and the same
    batch with every layout of the ``pallas`` and ``xchg`` routes attached
    (``attach_feature_major`` under ``PHOTON_SPARSE_GRAD=xchg``: ``al``,
    ``al_t`` and the exchange route with the values baked in).  The route
    is balanced where the block census allows it and colored where it does
    not (zipf ids put a hot key's consecutive entries in one destination
    window).  The uniform batch also carries the ``benes`` routes.  When
    neither draw takes the colored route, the uniform batch gets one too
    (``force_colored``), so that K5 runs on a path."""
    from photon_tpu_torch.data.batch import attach_feature_major
    from photon_tpu_torch.ops import vperm
    from photon_tpu_torch.ops.benes import build_benes_aux
    from photon_tpu_torch.ops.slab_reduce import build_aligned_layout

    out = {}
    os.environ["PHOTON_SPARSE_GRAD"] = "xchg"
    for dist in DISTS:
        batch = make_batch(dist, seed=0, device=dev)
        t0 = time.monotonic()
        attached = attach_feature_major(batch, aligned_dim=D)
        torch.cuda.synchronize()
        attach_s = time.monotonic() - t0
        route = attached.xchg.route
        out[dist] = {
            "batch": batch, "attached": attached,
            "route_kind": route_kind(route), "route_build_s": vperm.route_build_seconds,
            "layout_build_s": attach_s - vperm.route_build_seconds,
        }
        log(f"  {dist}: layouts {out[dist]['layout_build_s']:.2f} s, "
            f"{describe_route(route)} in {vperm.route_build_seconds:.2f} s")
    os.environ.pop("PHOTON_SPARSE_GRAD", None)
    uniform = out["uniform"]
    ids = uniform["batch"].ids.cpu().numpy()
    vals = uniform["batch"].vals.cpu().numpy()
    layout = build_aligned_layout(ids, vals, D)
    for dist in BENES_DISTS:
        # The benes routes between the row-major stream and the slots of
        # the same gradient layout (the builder is deterministic).
        t0 = time.monotonic()
        aux = build_benes_aux(layout, N, K, device=dev)
        torch.cuda.synchronize()
        prep = out[dist]
        prep["benes_build_s"] = time.monotonic() - t0
        if aux.n_slots != prep["attached"].al.lo.numel():
            raise AssertionError("the benes route's slots differ from the batch layout's")
        prep["attached"] = prep["attached"]._replace(benes=aux)
        log(f"  {dist}: benes routes (grid {aux.to_slots.a} x {aux.to_slots.b}, "
            f"{aux.n_slots} slots) in {prep['benes_build_s']:.2f} s")
    if any(out[dist]["route_kind"] == "colored" for dist in DISTS):
        return out
    aux = vperm.build_xchg_aux(layout, ids, vals=vals, force_colored=True,
                               device=dev)
    if aux.route.n_out != uniform["attached"].al.lo.numel():
        raise AssertionError("the colored route's slots differ from the batch layout's")
    out["forced"] = {
        "attached": uniform["attached"]._replace(xchg=aux),
        "route_kind": "colored", "route_build_s": vperm.route_build_seconds,
    }
    log(f"  uniform, forced: {describe_route(aux.route)} in "
        f"{vperm.route_build_seconds:.2f} s")
    return out


def route_names(prepared) -> list:
    return [*DISTS, *(["forced"] if "forced" in prepared else [])]


def route_kind(route) -> str:
    from photon_tpu_torch.ops.vperm import BalancedRoute

    return "balanced" if isinstance(route, BalancedRoute) else "colored"


def describe_route(route) -> str:
    extra = (f", blk={route.blk}, k_expand={route.k_expand}"
             if route_kind(route) == "balanced" else "")
    return (f"{route_kind(route)} route (nc={route.nc}, ch={route.ch}, "
            f"{route.total} slots{extra})")


def route_passes(route, dev) -> list:
    """Every K4/K5/K6 launch of ``route``'s exchange as (kernel, kernel fn,
    plain fn, label, inputs, bytes moved), on random inputs of the launch's
    shape."""
    from photon_tpu_torch.ops import vperm as vp

    nc, ch = route.nc, route.ch
    x = torch.randn(nc * ch, vp.LANES, device=dev)
    rows = nc * ch * vp.LANES
    chunk = ("vperm_chunk", vp.chunk_pass, vp.chunk_pass_plain)
    if route_kind(route) == "balanced":
        # Per evaluation: K6 (stage A), K4 (stage B, when nc > 1); once, at
        # the attach: K4 (stage A of the value bake).
        passes = []
        if route.k_expand:
            width = vp.LANES // route.k_expand
            dz2d = torch.randn(nc * ch, width, device=dev)
            passes.append(("vperm_chunk_expand", vp.chunk_expand_pass,
                           vp.chunk_expand_pass_plain, "stage A (dz)",
                           (dz2d, route.a1, route.a2, route.a3, nc, ch),
                           8 * rows + 4 * nc * ch * width))
        if nc > 1:
            passes.append((*chunk, "stage B",
                           (x, route.b1, route.b2, route.b3, nc, ch), 12 * rows))
        passes.append((*chunk, "stage A (bake)",
                       (x, route.a1, route.a2, route.a3, nc, ch), 12 * rows))
        return passes
    passes = [(*chunk, "R1", (x, route.i1, route.i2, route.i3, nc, ch), 12 * rows)]
    if nc > 1:
        passes += [
            ("vperm_lane", vp.lane_pass, vp.lane_pass_plain, "middle",
             (x, route.c), 9 * rows),
            (*chunk, "R2", (x, route.i4, route.i5, route.i6, nc, ch), 12 * rows),
        ]
    return passes


def pass_library_call(kernel, args):
    """One PyTorch call that computes the same permutation: ``index_select``
    with the source map composed once from the planes (K4, K6), or
    ``torch.gather`` (K5).  The map is built here, outside any timing."""
    if kernel == "vperm_lane":
        x, c = args
        c64 = c.long()
        return lambda: torch.gather(x, 1, c64)
    src, i1, i2, i3, nc, ch = args
    dev = src.device
    row = torch.arange(nc * ch, device=dev)[:, None]
    chunk = row // ch
    c = i3.long()
    r2 = i2.view(-1).long()[(chunk * 128 + c) * ch + (row - chunk * ch)]
    src_row = chunk * ch + r2
    lane = i1.view(-1).long()[src_row * 128 + c]
    width = src.shape[1]
    idx = (src_row * width + lane // (128 // width)).view(-1)
    flat = src.view(-1)
    return lambda: flat.index_select(0, idx).view(nc * ch, 128)


CHUNK_KERNELS = ("vperm_chunk", "vperm_chunk_expand")


def chunk_form_of(args) -> tuple:
    """The form ``chunk_form`` picks for a K4/K6 launch's inputs."""
    from photon_tpu_torch.ops import vperm as vp

    src, *_, nc, ch = args
    return vp.chunk_form(nc, ch, src.shape[1])


def save_vperm_counts():
    """The vperm wrappers' launch counts (total and per form), to restore
    after launches that only check or time a kernel."""
    from photon_tpu_torch.ops import vperm as vp

    fns = (vp.chunk_pass, vp.lane_pass, vp.chunk_expand_pass)
    saved = [(fn.launches, dict(getattr(fn, "form_launches", {}))) for fn in fns]

    def restore():
        for fn, (n, forms) in zip(fns, saved):
            fn.launches = n
            if forms:
                fn.form_launches = forms
    return restore


def check_vperm_kernels(prepared, dev) -> dict:
    """K4, K5 and K6 on the main path's routes against their plain versions
    and one library call, bit for bit, K4 and K6 in both forms (the one
    ``chunk_form`` picks and the global form); then each route's slot
    products against the ``pallas`` route's, bit for bit, and its gradient
    against the ``pallas`` route's under the gradient gate."""
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.ops.slab_reduce import aligned_reduce

    restore = save_vperm_counts()
    seen = set()
    worst = 0.0
    for name in route_names(prepared):
        batch = prepared[name]["attached"]
        for kernel, fn, plain, label, args, _ in route_passes(batch.xchg.route, dev):
            got, ref = fn(*args), plain(*args)
            lib = pass_library_call(kernel, args)()
            forms = {"chosen": got}
            if kernel in CHUNK_KERNELS:
                forms["global"] = vp.run_chunk_form(fn, ("global", 0), *args)
            torch.cuda.synchronize()
            err = max(float((g - ref).abs().max()) for g in forms.values())
            same = all(torch.equal(g, ref) for g in forms.values()) and torch.equal(got, lib)
            form = chunk_form_of(args) if kernel in CHUNK_KERNELS else None
            log(f"  {kernel}[{name} {label}, {tuple(args[0].shape)}"
                + (f", {form[0]} form, CL={form[1]}, and the global form" if form else "")
                + f"]: max_abs_err={err:.3e}, bitwise {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"{kernel} differs from its plain version")
            seen.add(kernel)
        al = batch.al
        dz = torch.randn(N, device=dev)
        pv_x = vp.xchg_slot_products(dz, batch.vals, batch.xchg).view(al.lo.shape)
        pv_p = dz.index_select(0, al.rows.view(-1)).view(al.rows.shape) * al.vals
        torch.cuda.synchronize()
        same = torch.equal(pv_x, pv_p)
        log(f"  xchg_slot_products[{name}] vs pallas dz[rows] * vals: "
            f"max_abs_err={float((pv_x - pv_p).abs().max()):.3e}, bitwise "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{name}: the xchg slot products differ from pallas")
        worst = max(worst, gate_report(
            f"xchg_segment_grad[{name}] vs pallas gradient",
            aligned_reduce(pv_x, al, D), aligned_reduce(pv_p, al, D),
            GRAD_RTOL, aligned_reduce(pv_p.abs(), al, D),
        ))
    restore()
    missing = {"vperm_chunk", "vperm_lane", "vperm_chunk_expand"} - seen
    if missing:
        raise AssertionError(f"no route of the main path runs {sorted(missing)}")
    return {"max_abs_err": 0.0, "gradient_max_abs_err": worst}


def chunk_form_edges() -> list:
    """K4/K6 shapes off the main path that hold each form to its plain
    version: (kernel, nc, ch, k) with k = 0 for K4.  One chunk; the largest
    chunk the cluster form takes and 8 rows above it (the global form), for
    K4 and for K6 at k = 32; the builders' cap, ch = 8192; K6 at k = 1, 4,
    32 and 128."""
    from photon_tpu_torch.ops import vperm as vp

    def largest(width: int) -> int:
        return max(ch for ch in range(8, vp.CH_MAX + 1, 8)
                   if vp.chunk_form(1, ch, width)[0] == "cluster")

    k4, k6 = largest(vp.LANES), largest(vp.LANES // 32)
    return [("vperm_chunk", 1, 2432, 0), ("vperm_chunk", 1, k4, 0),
            ("vperm_chunk", 1, k4 + 8, 0), ("vperm_chunk", 2, vp.CH_MAX, 0),
            *[("vperm_chunk_expand", 1, 2432, k) for k in (1, 4, 32, 128)],
            ("vperm_chunk_expand", 1, k6, 32), ("vperm_chunk_expand", 1, k6 + 8, 32),
            ("vperm_chunk_expand", 2, vp.CH_MAX, 32)]


def check_chunk_form_edges(dev) -> list:
    """Each edge shape with random in-range planes: the form ``chunk_form``
    picks and the global form, each bit for bit against the plain version."""
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.tools.probe_chunk_forms import random_planes

    restore = save_vperm_counts()
    rows = []
    for kernel, nc, ch, k in chunk_form_edges():
        width = vp.LANES // k if k else vp.LANES
        fn, plain = ((vp.chunk_expand_pass, vp.chunk_expand_pass_plain) if k
                     else (vp.chunk_pass, vp.chunk_pass_plain))
        args = (*random_planes(nc, ch, width, seed=ch + k, dev=dev), nc, ch)
        form = vp.chunk_form(nc, ch, width)
        ref = plain(*args)
        same = {f[0]: torch.equal(vp.run_chunk_form(fn, f, *args), ref)
                for f in {form, ("global", 0)}}
        torch.cuda.synchronize()
        row = {"kernel": kernel, "nc": nc, "ch": ch, "k": k, "form": form[0],
               "cluster_blocks": form[1], "bitwise": same}
        rows.append(row)
        log(f"  {kernel}[nc={nc}, ch={ch}" + (f", k={k}" if k else "")
            + f"]: {form[0]} form, CL={form[1]}; bitwise "
            + ", ".join(f"{f} {'ok' if ok else 'FAIL'}" for f, ok in same.items()))
        if not all(same.values()):
            raise AssertionError(f"{kernel} at nc={nc}, ch={ch}, k={k} differs from plain")
    restore()
    return rows


def slab_gather_library_call(w2d, al):
    """Two PyTorch calls that compute K3's function: ``torch.gather`` over
    ``w2d`` by the row index ``slab * 8 + lo`` (composed once, here, outside
    any timing), then the multiply by ``vals``."""
    from photon_tpu_torch.ops.slab_reduce import TILE_SUBLANES

    n_tiles = int(al.slab_of_tile.shape[0])
    tile = torch.arange(n_tiles * TILE_SUBLANES, device=w2d.device) // TILE_SUBLANES
    idx = al.slab_of_tile[tile].long()[:, None] * 8 + al.lo.long()
    return lambda: torch.gather(w2d, 0, idx) * al.vals


def check_slab_gather_kernel(prepared, dev) -> dict:
    """K3 on both draws' gradient layouts against its plain version and the
    library call, bit for bit (one f32 multiply a slot)."""
    from photon_tpu_torch.ops.slab_reduce import (
        LANES,
        aligned_gather_products,
        aligned_gather_products_plain,
    )

    saved = aligned_gather_products.launches
    for dist in DISTS:
        al = prepared[dist]["attached"].al
        w = torch.randn(D, device=dev)
        w2d = w.index_select(0, al.dup_map).view(-1, LANES)
        args = (w2d, al.slab_of_tile, al.lo, al.vals)
        got, ref = aligned_gather_products(*args), aligned_gather_products_plain(*args)
        lib = slab_gather_library_call(w2d, al)()
        torch.cuda.synchronize()
        same = torch.equal(got, ref) and torch.equal(got, lib)
        log(f"  slab_gather[{dist}, {tuple(al.lo.shape)}, tiles="
            f"{al.slab_of_tile.shape[0]}]: max_abs_err="
            f"{float((got - ref).abs().max()):.3e}, bitwise {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError("slab_gather differs from its plain version")
    aligned_gather_products.launches = saved
    return {"max_abs_err": 0.0}


def check_benes(prepared, dev) -> dict:
    """The benes route of each batch that carries one: ``to_slots`` after
    ``to_rows`` is the identity on the grid, bit for bit; the slot products
    equal the ``pallas`` route's ``dz[rows] * vals`` bit for bit; the
    gradient (shared K2 and epilogue) and the forward (per-row sums in
    another order) under the gradient gate."""
    from photon_tpu_torch.data.batch import gather_dot
    from photon_tpu_torch.ops.benes import benes_slot_products, benes_xu_product
    from photon_tpu_torch.ops.clos import apply_clos_grid
    from photon_tpu_torch.ops.slab_reduce import aligned_gather_products, aligned_reduce

    saved = aligned_gather_products.launches
    worst = 0.0
    for dist in BENES_DISTS:
        batch = prepared[dist]["attached"]
        aux, al = batch.benes, batch.al
        x = torch.randn(aux.grid, device=dev)
        back = apply_clos_grid(apply_clos_grid(x, aux.to_rows), aux.to_slots)
        torch.cuda.synchronize()
        same = torch.equal(back, x)
        log(f"  benes[{dist}] to_slots(to_rows(x)) == x on {aux.grid} elements: "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{dist}: the benes routes are not inverse")
        dz = torch.randn(N, device=dev)
        pv_b = benes_slot_products(dz, batch.vals, aux).view(al.lo.shape)
        pv_p = dz.index_select(0, al.rows.view(-1)).view(al.rows.shape) * al.vals
        torch.cuda.synchronize()
        same = torch.equal(pv_b, pv_p)
        log(f"  benes_slot_products[{dist}] vs pallas dz[rows] * vals: max_abs_err="
            f"{float((pv_b - pv_p).abs().max()):.3e}, bitwise {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{dist}: the benes slot products differ from pallas")
        worst = max(worst, gate_report(
            f"benes_segment_grad[{dist}] vs pallas gradient",
            aligned_reduce(pv_b, al, D), aligned_reduce(pv_p, al, D),
            GRAD_RTOL, aligned_reduce(pv_p.abs(), al, D),
        ))
        w = torch.randn(D, device=dev) * 0.1
        worst = max(worst, gate_report(
            f"benes_xu_product[{dist}] vs row-major gather",
            benes_xu_product(w, al, aux, N, K), gather_dot(w, batch.ids, batch.vals),
            GRAD_RTOL, gather_dot(w.abs(), batch.ids, batch.vals.abs()),
        ))
    aligned_gather_products.launches = saved
    return {"gradient_max_abs_err": worst}


def slab_gather_timings(prepared, dev) -> dict:
    """K3's, its plain version's and the library call's times and K3's
    bound on each draw's gradient layout."""
    from photon_tpu_torch.ops.slab_reduce import (
        LANES,
        aligned_gather_products,
        aligned_gather_products_plain,
    )

    saved = aligned_gather_products.launches
    out = {}
    for dist in DISTS:
        al = prepared[dist]["attached"].al
        w2d = torch.randn(D, device=dev).index_select(0, al.dup_map).view(-1, LANES)
        args = (w2d, al.slab_of_tile, al.lo, al.vals)
        n_tiles = int(al.slab_of_tile.shape[0])
        slots = al.lo.numel()
        # Each input read once, the output written once: lo, vals and out
        # (12 bytes a slot), w2d and slab_of_tile; one multiply a slot.
        t_bound, by = bound(12 * slots + 4 * w2d.numel() + 4 * n_tiles, slots)
        row = out[dist] = {
            "ms": cuda_ms(lambda: aligned_gather_products(*args)),
            "plain_ms": cuda_ms(lambda: aligned_gather_products_plain(*args)),
            "library_ms": cuda_ms(slab_gather_library_call(w2d, al)),
            "bound_ms": t_bound, "bound_by": by,
            "slots": slots, "tiles": n_tiles, "slabs": al.n_slabs,
        }
        log(f"  slab_gather [{dist}, {slots} slots, {n_tiles} tiles]: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms (torch.gather + multiply), bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    aligned_gather_products.launches = saved
    return out


def vperm_timings(prepared, dev) -> dict:
    """K4, K5 and K6 times at the main path's shapes, for every launch of
    each route's exchange: ``{route name: [row, ...]}`` in route_passes'
    order (the per-evaluation launches first).  K4 and K6 also carry the
    form ``chunk_form`` picks, its cluster size and
    ``cudaOccupancyMaxActiveClusters``, and the global form's time, taken
    in turn with the others."""
    from photon_tpu_torch.ops import vperm as vp

    restore = save_vperm_counts()
    out = {}
    for name in route_names(prepared):
        rows = out[name] = []
        for kernel, fn, plain, label, args, nbytes in route_passes(
                prepared[name]["attached"].xchg.route, dev):
            t_bound, by = bound(nbytes, 0)
            row = {"kernel": kernel, "ms": cuda_ms(lambda: fn(*args))}
            if kernel in CHUNK_KERNELS:
                form = chunk_form_of(args)
                src, *_, nc, ch = args
                row.update({
                    "form": form[0], "cluster_blocks": form[1],
                    "max_active_clusters": (vp.max_active_clusters(ch, src.shape[1], form[1])
                                            if form[0] == "cluster" else None),
                    "global_form_ms": cuda_ms(
                        lambda: vp.run_chunk_form(fn, ("global", 0), *args)),
                })
            row.update({
                "plain_ms": cuda_ms(lambda: plain(*args)),
                "library_ms": cuda_ms(pass_library_call(kernel, args)),
                "bound_ms": t_bound, "bound_by": by,
                "at": f"{name} {label}, {tuple(args[0].shape)}",
            })
            rows.append(row)
            log(f"  {kernel} [{row['at']}]: kernel {row['ms']:.4f} ms"
                + (f" ({row['form']} form, CL={row['cluster_blocks']}, max active "
                   f"clusters {row['max_active_clusters']}; global form "
                   f"{row['global_form_ms']:.4f} ms)" if "form" in row else "")
                + f", plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    restore()
    return out


def run_main_path(prepared, dev) -> dict:
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import GlmOptimizationProblem, ProblemConfig
    from photon_tpu_torch.ops import probe_kernels as pk
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad, row_scatter
    from photon_tpu_torch.ops.slab_reduce import (
        aligned_gather_products,
        position_partial_sums,
    )

    reg = RegularizationContext("l2", 1.0)
    objective = GlmObjective.create("logistic", reg)
    problem = GlmOptimizationProblem(objective, ProblemConfig(
        regularization=reg,
        optimizer_config=OptimizerConfig(
            max_iterations=LBFGS_ITERATIONS, tolerance=0.0, gradient_tolerance=0.0,
        ),
    ))
    warm = GlmOptimizationProblem(objective, ProblemConfig(
        regularization=reg, optimizer_config=OptimizerConfig(max_iterations=2),
    ))
    counters = {"fused_sparse": fused_value_and_grad, "row_scatter": row_scatter,
                "position_reduce": position_partial_sums,
                "vperm_chunk": vp.chunk_pass, "vperm_lane": vp.lane_pass,
                "vperm_chunk_expand": vp.chunk_expand_pass,
                "slab_gather": aligned_gather_products}
    launches = {name: 0 for name in counters}
    form_launches = {name: {"cluster": 0, "global": 0} for name in CHUNK_KERNELS}
    probe_launches = {fn.__name__: 0 for fn in pk.KERNELS}
    result = {"runs": [], "form_launches": form_launches, "probe_launches": probe_launches}

    def counted(fn):
        """Run ``fn`` with every launch count (K4's and K6's per form too,
        and the probe kernels') set to 0 just before it; returns (its
        result, the counts just after).  Every K4/K6 launch of the main path
        must take the form ``chunk_form`` picks at its shapes: the cluster
        form; no probe kernel may launch."""
        for c in (*counters.values(), *pk.KERNELS):
            c.launches = 0
        for name in CHUNK_KERNELS:
            counters[name].form_launches = {"cluster": 0, "global": 0}
        out = fn()
        torch.cuda.synchronize()
        counts = {name: c.launches for name, c in counters.items()}
        probes = {c.__name__: c.launches for c in pk.KERNELS}
        if any(probes.values()):
            raise AssertionError(f"the training path launched probe kernels: {probes}")
        for name, n in probes.items():
            probe_launches[name] += n
        for name in counts:
            launches[name] += counts[name]
        for name in CHUNK_KERNELS:
            forms = counters[name].form_launches
            if forms["global"]:
                raise AssertionError(f"{name}: {forms['global']} main-path launches "
                                     "took the global form")
            for form, n in forms.items():
                form_launches[name][form] += n
        return out, counts

    def expected(route: str, batch, second_order: bool = False) -> set:
        if route == "fused":
            # Hv's X^T r goes through the row scatter.
            return {"fused_sparse", "row_scatter"} if second_order else {"fused_sparse"}
        if route == "pallas":
            return {"position_reduce"}
        if route == "benes":
            return {"slab_gather", "position_reduce"}
        xr = batch.xchg.route
        if route_kind(xr) == "colored":
            return {"position_reduce", "vperm_chunk"} | (
                {"vperm_lane"} if xr.nc > 1 else set())
        return {"position_reduce"} | (
            {"vperm_chunk_expand"} if xr.k_expand else {"vperm_chunk"}) | (
            {"vperm_chunk"} if xr.nc > 1 else set())

    for dist in DISTS:
        prep = prepared[dist]
        finals = {}
        for route in ("fused", "pallas", "xchg"):
            os.environ["PHOTON_SPARSE_GRAD"] = route
            run_batch = prep["batch"] if route == "fused" else prep["attached"]
            w0 = torch.zeros(D, device=dev)
            # An untimed fit first: CUDA loads each kernel's module at its
            # first launch, so the first fit in a process pays for loading
            # every kernel the optimizer uses; steps/s reads the steady state.
            warm.run(run_batch, w0)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            (coefficients, res), counts = counted(lambda: problem.run(run_batch, w0))
            wall = time.monotonic() - t0
            unlaunched = sorted(k for k in expected(route, run_batch) if not counts[k])
            if unlaunched:
                raise AssertionError(f"{dist}/{route}: never launched {unlaunched}")
            evals = cuda_ms(
                lambda: objective.value_and_grad(coefficients.means, run_batch),
                reps=10,
            )
            # Objective evaluations in the fit: K1 runs once per evaluation,
            # K2 twice (margins over al_t, gradient over al).
            n_evals = counts["fused_sparse"] or counts["position_reduce"] // 2
            rest_ms = (wall * 1e3 - n_evals * evals) / max(res.iterations, 1)
            f0 = float(res.history_value[0])
            if not (np.isfinite(res.value) and res.value < f0):
                raise AssertionError(f"{route}/{dist}: objective did not decrease")
            finals[route] = res.value
            row = {
                "dist": dist, "route": route, "iterations": res.iterations,
                "f0": f0, "final_value": res.value, "grad_norm": res.grad_norm,
                "fit_s": wall, "steps_per_s": res.iterations / wall,
                "value_and_grad_ms": evals, "evaluations": n_evals,
                "outside_objective_ms_per_iteration": rest_ms,
                "layout_build_s": 0.0 if route == "fused" else prep["layout_build_s"],
                "launches": counts,
            }
            if route == "xchg":
                row["route_kind"] = prep["route_kind"]
                row["route_build_s"] = prep["route_build_s"]
            result["runs"].append(row)
            log(f"  {dist}/{route}: {res.iterations} iterations, f {f0:.6g} -> "
                f"{res.value:.9g}, {row['steps_per_s']:.3f} steps/s, "
                f"value_and_grad {evals:.3f} ms x {n_evals}, outside the "
                f"objective {rest_ms:.3f} ms/iteration, layout build "
                f"{row['layout_build_s']:.2f} s"
                + (f", {prep['route_kind']} route build {prep['route_build_s']:.2f} s"
                   if route == "xchg" else "")
                + f", launches { {k: v for k, v in counts.items() if v} }")
            if route == "pallas":
                log(f"  kernel times, {dist} ids:")
                result.setdefault("timings", {})[dist] = kernel_timings(
                    prep["batch"], run_batch.al, run_batch.al_t, dev
                )
        os.environ.pop("PHOTON_SPARSE_GRAD", None)
        for a, b in (("fused", "pallas"), ("pallas", "xchg")):
            rel = abs(finals[a] - finals[b]) / abs(finals[a])
            log(f"  {dist}: {a} vs {b} final value rel diff {rel:.3e} "
                f"(tolerance {ROUTE_RTOL:g}{', exact' if rel == 0 else ''})")
            if rel > ROUTE_RTOL:
                raise AssertionError(f"{dist}: routes {a} and {b} disagree ({rel:.3e})")

    if "forced" in prepared:
        # A colored route forced on the uniform batch: one value_and_grad,
        # against the balanced route's on the same batch.
        os.environ["PHOTON_SPARSE_GRAD"] = "xchg"
        colored = prepared["forced"]["attached"]
        w = torch.randn(D, device=dev) * 0.01
        objective.value_and_grad(w, colored)  # module loads, outside the count
        (v_c, g_c), counts = counted(lambda: objective.value_and_grad(w, colored))
        unlaunched = sorted(k for k in expected("xchg", colored) if not counts[k])
        if unlaunched:
            raise AssertionError(f"colored route: never launched {unlaunched}")
        v_b, _ = objective.value_and_grad(w, prepared["uniform"]["attached"])
        colored_ms = cuda_ms(lambda: objective.value_and_grad(w, colored), reps=5)
        os.environ.pop("PHOTON_SPARSE_GRAD", None)
        rel = abs(float(v_c) - float(v_b)) / abs(float(v_b))
        log(f"  uniform/xchg forced colored route: value_and_grad {colored_ms:.3f} "
            f"ms, launches { {k: v for k, v in counts.items() if v} }, value rel "
            f"diff to the balanced route {rel:.3e} (tolerance {VALUE_RTOL:g})")
        if rel > VALUE_RTOL:
            raise AssertionError("the colored and balanced routes disagree")
        result["forced_colored"] = {
            "value_and_grad_ms": colored_ms, "launches": counts,
            "route_build_s": prepared["forced"]["route_build_s"]}
    log(f"  TRON, Poisson + L2, {TRON_ITERATIONS} outer iterations:")
    result["tron"] = run_tron(prepared, dev, counted, expected)
    log("  permutation kernel times:")
    result["vperm_timings"] = vperm_timings(prepared, dev)
    log("  slab gather times:")
    result["slab_gather_timings"] = slab_gather_timings(prepared, dev)
    result["launches"] = launches
    return result


def poisson_labels(batch, seed: int) -> torch.Tensor:
    """Counts drawn with numpy from exp(x . w*) for a seeded w*."""
    rng = np.random.default_rng(seed)
    ids = batch.ids.cpu().numpy()
    vals = batch.vals.cpu().numpy()
    w_star = (rng.standard_normal(D) * 0.05).astype(np.float32)
    rate = np.exp((w_star[ids] * vals).sum(axis=1))
    return torch.as_tensor(rng.poisson(rate).astype(np.float32), device=batch.ids.device)


def run_tron(prepared, dev, counted, expected) -> list:
    """``GlmOptimizationProblem.run`` with TRON (Poisson + L2 = 1.0, the
    JAX default CG cap) on each route of each draw, on the batches and
    routes phase 2 built with Poisson labels; the final values of one draw's
    routes must agree within ROUTE_RTOL."""
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import GlmOptimizationProblem, ProblemConfig

    reg = RegularizationContext("l2", 1.0)
    objective = GlmObjective.create("poisson", reg)

    def problem(iterations: int):
        return GlmOptimizationProblem(objective, ProblemConfig(
            optimizer="tron", regularization=reg,
            optimizer_config=OptimizerConfig(
                max_iterations=iterations, tolerance=0.0, gradient_tolerance=0.0),
        ))

    runs = []
    for dist in DISTS:
        prep = prepared[dist]
        label = poisson_labels(prep["batch"], seed=11)
        routes = ("fused", "pallas", "xchg") + (("benes",) if dist in BENES_DISTS else ())
        finals = {}
        for route in routes:
            os.environ["PHOTON_SPARSE_GRAD"] = route
            run_batch = (prep["batch"] if route == "fused"
                         else prep["attached"])._replace(label=label)
            if objective._sparse_kernel(run_batch, D) != route:
                raise AssertionError(f"{dist}/{route}: the batch takes another route")
            w0 = torch.zeros(D, device=dev)
            problem(1).run(run_batch, w0)  # module loads, outside the timing
            torch.cuda.synchronize()
            t0 = time.monotonic()
            (coefficients, res), counts = counted(
                lambda: problem(TRON_ITERATIONS).run(run_batch, w0))
            wall = time.monotonic() - t0
            unlaunched = sorted(k for k in expected(route, run_batch, second_order=True)
                                if not counts[k])
            if unlaunched:
                raise AssertionError(f"TRON {dist}/{route}: never launched {unlaunched}")
            f0 = float(res.history_value[0])
            if not (np.isfinite(res.value) and res.value < f0):
                raise AssertionError(f"TRON {dist}/{route}: objective did not decrease")
            w = coefficients.means
            op = objective.hvp_operator(w, run_batch)
            v = torch.randn(D, device=dev)
            hv_ms = cuda_ms(lambda: op(v), reps=10)
            vg_ms = cuda_ms(lambda: objective.value_and_grad(w, run_batch), reps=10)
            # Products: one per CG step; evaluations: one per outer iteration
            # and one at the start.  What remains of the host clock is the
            # loops' own work and their reads.
            rest_ms = (wall * 1e3 - res.cg_iterations * hv_ms
                       - (res.iterations + 1) * vg_ms)
            finals[route] = res.value
            row = {
                "dist": dist, "route": route, "iterations": res.iterations,
                "cg_steps": res.cg_iterations, "host_reads": res.host_reads,
                "f0": f0, "final_value": res.value, "grad_norm": res.grad_norm,
                "fit_s": wall, "s_per_iteration": wall / res.iterations,
                "hv_ms": hv_ms, "value_and_grad_ms": vg_ms,
                "outside_products_ms": rest_ms,
                "outside_products_ms_per_read": rest_ms / res.host_reads,
                "launches": counts,
            }
            runs.append(row)
            log(f"  TRON {dist}/{route}: {res.iterations} iterations, {res.cg_iterations}"
                f" CG steps, {res.host_reads} host reads, f {f0:.6g} -> {res.value:.9g},"
                f" {row['s_per_iteration']:.4f} s/iteration, Hv {hv_ms:.3f} ms,"
                f" value_and_grad {vg_ms:.3f} ms, outside the products "
                f"{rest_ms:.2f} ms ({row['outside_products_ms_per_read']:.4f} ms per "
                f"read), launches { {k: v for k, v in counts.items() if v} }")
        os.environ.pop("PHOTON_SPARSE_GRAD", None)
        for other in routes[1:]:
            rel = abs(finals["fused"] - finals[other]) / abs(finals["fused"])
            log(f"  TRON {dist}: fused vs {other} final value rel diff {rel:.3e} "
                f"(tolerance {ROUTE_RTOL:g}{', exact' if rel == 0 else ''})")
            if rel > ROUTE_RTOL:
                raise AssertionError(f"TRON {dist}: routes fused and {other} disagree")
    return runs


PROBE_E = 1 << 25  # the probe tools' default entry count
CLOS_E = 1 << 26  # the headline benes grid (8192 x 8192) for probe rows h and i
# PK5 off the tool's shape, (ch, rows, planes out of range): one chunk; the
# block form (ch = 8, 256); the cluster form at every other size the rule
# can give (4 and 8 blocks at 512 and 1024; 16 at 4096, one block an SM);
# the global form (8192); each form with every plane out of its range.
PK5_SHAPES = ((2048, 2048, False), (8, PROBE_E // 128, False),
              (256, PROBE_E // 128, False), (512, PROBE_E // 128, False),
              (1024, PROBE_E // 128, False), (4096, PROBE_E // 128, False),
              (8192, PROBE_E // 128, False), (2048, PROBE_E // 128, True),
              (256, PROBE_E // 128, True), (8192, PROBE_E // 128, True))
# The bars phase 5 reports (it fails on a wrong result, not on a time): PK5
# at the tool's shape under index_select's median and at most PK5_BAR_MS;
# PK3 at most PK3_BAR x the median of x * c at every h and row count; PK2
# unmasked at every h and PK7 at k = 32 at least BOUND_SHARE_BAR of their
# bound and no slower than the median of their library call (flip,
# repeat_interleave).
PK5_BAR_MS = 0.30
PK3_BAR = 1.02
BOUND_SHARE_BAR = 0.5
BAR_ROUNDS = 3
PK7_KS = (1, 2, 4, 8, 16, 32, 64, 128)  # every k lane_repeat takes


def pk5_case(dev, ch: int, rows: int, out_of_range: bool, seed: int):
    """PK5's inputs at ``rows`` rows of chunk height ``ch`` (random
    permutation planes; out of range: ``i1 + 128``, ``i2 + ch``, ``i3 -
    128``) and its library call, ``index_select`` by the source map composed
    from the in-range planes."""
    from photon_tpu_torch.ops import probe_kernels as pk
    from photon_tpu_torch.tools.probe_common import generator, row_perms

    L = pk.LANES
    gen = generator(dev, seed)
    x = torch.rand(rows, L, generator=gen, device=dev)
    i1 = row_perms(rows, L, gen, dev)
    i2 = row_perms(rows // ch * L, ch, gen, dev)
    i3 = row_perms(rows, L, gen, dev)
    src = pk.fused_chunk_source(i1, i2, i3, ch).view(-1)
    if out_of_range:
        i1, i2, i3 = i1 + L, i2 + ch, i3 - L
    return (x, i1, i2, i3, ch), lambda: x.view(-1).index_select(0, src).view(rows, L)


def pk7_case(dev, k: int, rows: int, seed: int):
    """PK7's input ``[rows, 128 / k]`` and its library call."""
    from photon_tpu_torch.ops import probe_kernels as pk
    from photon_tpu_torch.tools.probe_common import generator

    narrow = torch.rand(rows, pk.LANES // k, generator=generator(dev, seed), device=dev)
    return (narrow, k), lambda: narrow.repeat_interleave(k, dim=1)


def probe_kernel_cases(dev) -> list:
    """PK1-PK7 at the probe tools' default shapes (E = 2^25): per case the
    kernel's name, the site it replaces, a label, the wrapper, its plain
    version, ``make()`` returning the inputs and a library call, the bytes
    the bound counts and the bar it is held to (None, "pk5", "pk3",
    "share").  The first case of each kernel is its row in the kernels
    line; PK2 (masked and unmasked) and PK3 also run at every tile height
    of probe_tiles and at 262,143 rows, PK5 at ``PK5_SHAPES``, PK7 at every
    k and at 262,143 rows."""
    from photon_tpu_torch.ops import probe_kernels as pk
    from photon_tpu_torch.tools.probe_blocklocal import CH
    from photon_tpu_torch.tools.probe_common import generator, row_perms
    from photon_tpu_torch.tools.probe_tiles import HEIGHTS

    E, L = PROBE_E, pk.LANES
    rows, n_tiles = E // L, E // L // CH
    gen = generator(dev, 50)
    x = torch.rand(rows, L, generator=gen, device=dev)
    lane_idx = row_perms(rows, L, gen, dev)
    xt = torch.rand(L, rows, generator=gen, device=dev)
    win_idx = row_perms(L * n_tiles, CH, gen, dev).view(L, rows)
    mask = (torch.rand(rows, L, generator=gen, device=dev) < 0.5).float()
    sub_idx = torch.randint(0, 8, (rows, L), generator=gen, device=dev,
                            dtype=torch.int32)
    narrow = torch.rand(rows, L // 32, generator=gen, device=dev)
    # Library calls' int64 indices, built once here.
    lane64, win64, sub64 = lane_idx.long(), win_idx.long(), sub_idx.long()
    flip = lambda y: y.view(-1, 4, 32).flip(1).reshape_as(y)  # noqa: E731
    ragged = x[: rows - 1]  # 262,143 rows: a ragged last tile at every h
    permute = "tools/probe_permute.py"
    block = "tools/probe_blocklocal.py"
    tiles = "tools/probe_tiles.py"

    def fixed(args, library):
        return lambda: (args, library)

    def copy_case(a, h):
        return fixed((a, h), lambda: a * pk.SCALE)

    cases = [
        ("window_gather", f"{permute}:110 (body :98-99); {block}:52 (bodies :68, :199)",
         "W=128", pk.window_gather, pk.window_gather_plain,
         fixed((x, lane_idx, L), lambda: torch.gather(x, 1, lane64)), 12 * E, None),
        ("window_gather", None, "W=2048, [128, E/128] view", pk.window_gather,
         pk.window_gather_plain,
         fixed((xt, win_idx, CH), lambda: torch.gather(
             xt.view(-1, CH), 1, win64.view(-1, CH)).view(L, rows)), 12 * E, None),
        ("lane_swap", f"{permute}:166 (body :151-158); {tiles}:53 (swap_kernel :37)",
         "masked, h=512", lambda a, m, h: pk.lane_swap(a, m, h=h),
         lambda a, m, h: pk.lane_swap_plain(a, m, h),
         fixed((x, mask, 512), lambda: torch.where(mask > 0, flip(x), x)), 12 * E, None),
        ("copy_scale", f"{tiles}:53 (copy_kernel :33)", "h=512",
         lambda a, h: pk.copy_scale(a, h=h), pk.copy_scale_plain,
         copy_case(x, 512), 8 * E, "pk3"),
        ("tile_transpose", f"{block}:101 (body)", f"[{CH},128] tiles",
         pk.tile_transpose, pk.tile_transpose_plain,
         fixed((x, CH), lambda: x.view(-1, CH, L).transpose(1, 2).contiguous()),
         8 * E, None),
        ("fused_chunk", f"{block}:146-151 (body)", f"CH={CH}, {n_tiles} chunks",
         pk.fused_chunk, pk.fused_chunk_plain,
         lambda: pk5_case(dev, CH, rows, False, 52), 20 * E, "pk5"),
        ("sublane_gather", f"{block}:245-250 (body)", "[8,128] groups",
         pk.sublane_gather, pk.sublane_gather_plain,
         fixed((x, sub_idx), lambda: x.view(-1, 8, L).gather(
             1, sub64.view(-1, 8, L)).view(rows, L)), 12 * E, None),
        ("lane_repeat", f"{block}:327-328 (body)", "k=32, [E/128,4] -> [E/128,128]",
         pk.lane_repeat, pk.lane_repeat_plain,
         fixed((narrow, 32), lambda: narrow.repeat_interleave(32, dim=1)),
         4 * E + 4 * E // 32, "share"),
    ]
    swap = lambda a, m, h: pk.lane_swap(a, m, h=h)  # noqa: E731
    swap_plain = lambda a, m, h: pk.lane_swap_plain(a, m, h)  # noqa: E731
    for h in HEIGHTS:
        cases.append(("lane_swap", None, f"unmasked, h={h}", swap, swap_plain,
                      fixed((x, None, h), lambda: flip(x)), 8 * E, "share"))
        if h != 512:
            cases.append(("lane_swap", None, f"masked, h={h}", swap, swap_plain,
                          fixed((x, mask, h), lambda: torch.where(mask > 0, flip(x), x)),
                          12 * E, None))
        for a in (x, ragged):
            cases.append(("copy_scale", None, f"h={h}, {a.shape[0]} rows",
                          lambda a, h: pk.copy_scale(a, h=h), pk.copy_scale_plain,
                          copy_case(a, h), 8 * a.numel(), "pk3"))
    ragged_mask = mask[: rows - 1]
    cases += [
        ("lane_swap", None, f"unmasked, h=512, {rows - 1} rows", swap, swap_plain,
         fixed((ragged, None, 512), lambda: flip(ragged)), 8 * ragged.numel(), None),
        ("lane_swap", None, f"masked, h=512, {rows - 1} rows", swap, swap_plain,
         fixed((ragged, ragged_mask, 512),
               lambda: torch.where(ragged_mask > 0, flip(ragged), ragged)),
         12 * ragged.numel(), None),
    ]
    for j, k in enumerate(PK7_KS):
        if k != 32:
            cases.append(("lane_repeat", None, f"k={k}", pk.lane_repeat,
                          pk.lane_repeat_plain,
                          lambda k=k, j=j: pk7_case(dev, k, rows, 70 + j),
                          4 * E + 4 * E // k, None))
    short = narrow[: rows - 1]
    cases.append(("lane_repeat", None, f"k=32, {rows - 1} rows", pk.lane_repeat,
                  pk.lane_repeat_plain,
                  fixed((short, 32), lambda: short.repeat_interleave(32, dim=1)),
                  4 * (rows - 1) * (L + L // 32), None))
    for n, (ch, r, oor) in enumerate(PK5_SHAPES):
        label = f"CH={ch}, {r // ch} chunk{'s' if r > ch else ''}" + (
            f", planes out of range (i1 + 128, i2 + {ch}, i3 - 128)" if oor else "")
        cases.append(("fused_chunk", None, label, pk.fused_chunk, pk.fused_chunk_plain,
                      lambda ch=ch, r=r, oor=oor, n=n: pk5_case(dev, ch, r, oor, 60 + n),
                      20 * r * L, None))
    return cases


def turns(fns: list, rounds: int = BAR_ROUNDS) -> list:
    """``rounds`` turns of the functions in order, each time a CUDA-event
    mean over 20 calls (``cuda_ms``, as every other row); per function (median, spread = max - min,
    the rounds), milliseconds."""
    ts = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(ts, fns):
            t.append(cuda_ms(fn, reps=20))
    return [(float(np.median(t)), max(t) - min(t), t) for t in ts]


def interleaved(fn, library) -> dict:
    """The kernel and its library call in turns: medians and spreads."""
    (k, ks, kr), (lib, ls, lr) = turns([fn, library])
    return {"ms": k, "library_ms": lib, "ms_rounds": kr, "library_ms_rounds": lr,
            "spread_ms": ks, "library_spread_ms": ls}


def check_probe_kernels(dev) -> dict:
    """Phase 5, part 1: every PK case against its plain version and its
    library call, bit for bit; each kernel's launch counter must move (and
    PK5's count of the form ``fused_chunk_form`` picks).  Every case is
    timed (kernel, plain, library) and bounded; the cases under a bar
    (PK5 at the tool's shape, PK3, PK2 unmasked, PK7 at k = 32) take kernel
    and library in turns, ``BAR_ROUNDS`` times, and report medians, spreads,
    the wrapper's host time per call and the bar.  Returns
    ``{kernel: row}``: the kernel's first case, its others under
    ``other_shapes``."""
    from photon_tpu_torch.ops import probe_kernels as pk
    from photon_tpu_torch.tools.probe_common import host_us

    counters = {fn.__name__: fn for fn in pk.KERNELS}
    saved = {name: fn.launches for name, fn in counters.items()}
    rows = {}
    for name, replaces, label, fn, plain, make, nbytes, bar in probe_kernel_cases(dev):
        args, library = make()
        before = counters[name].launches
        form = None
        if name == "fused_chunk":
            x5, ch = args[0], args[-1]
            form = pk.fused_chunk_form(x5.shape[0] // ch, ch)
            forms_before = dict(pk.fused_chunk.form_launches)
        got, ref, lib = fn(*args), plain(*args), library()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        same = torch.equal(got, ref) and torch.equal(got, lib.reshape(got.shape))
        moved = counters[name].launches == before + 1
        if form is not None:
            moved = moved and (pk.fused_chunk.form_launches[form[0]]
                               == forms_before[form[0]] + 1)
        log(f"  {name}[{label}, {tuple(args[0].shape)}]: max_abs_err={err:.3e}, "
            f"bitwise {'ok' if same else 'FAIL'}, launch counted {'ok' if moved else 'FAIL'}"
            + (f", form {form}" if form else ""))
        if not same:
            raise AssertionError(f"{name} [{label}] differs from its plain version")
        if not moved:
            raise AssertionError(f"{name} [{label}]: the launch counter did not move")
        t_bound, by = bound(nbytes, 0)
        row = {"at": label, "max_abs_err": err}
        if bar:
            row.update(interleaved(lambda: fn(*args), library))
            row["plain_ms"] = cuda_ms(lambda: plain(*args))
            row["host_us"] = host_us(lambda: fn(*args))
        else:
            row.update({"ms": cuda_ms(lambda: fn(*args)),
                        "plain_ms": cuda_ms(lambda: plain(*args)),
                        "library_ms": cuda_ms(library)})
        row.update({"bound_ms": t_bound, "bound_by": by})
        if form is not None:
            row["form"] = list(form)
            if form[0] == "cluster":
                row["max_active_clusters"] = pk.fused_chunk_clusters(ch, *form[1:])
        if bar == "pk5":
            row["bar"] = {"below_library": row["ms"] < row["library_ms"],
                          "at_most_ms": PK5_BAR_MS, "met": bool(
                              row["ms"] < row["library_ms"] and row["ms"] <= PK5_BAR_MS)}
        elif bar == "pk3":
            ratio = row["ms"] / row["library_ms"]
            row["bar"] = {"ratio": ratio, "at_most": PK3_BAR, "met": ratio <= PK3_BAR}
        elif bar == "share":
            share = t_bound / row["ms"]
            row["bar"] = {"share_of_bound": share, "at_least": BOUND_SHARE_BAR,
                          "not_slower_than_library": row["ms"] <= row["library_ms"],
                          "met": bool(share >= BOUND_SHARE_BAR
                                      and row["ms"] <= row["library_ms"])}
        log(f"  {name} [{label}]: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
            f"ms, library {row['library_ms']:.4f} ms, bound {t_bound:.4f} ms ({by})"
            + (f"; medians of {BAR_ROUNDS} turns, spread {row['spread_ms']:.4f} / "
               f"{row['library_spread_ms']:.4f} ms; wrapper {row['host_us']:.1f} us "
               f"host a call; bar {json.dumps(row['bar'])}" if bar else ""))
        if replaces is None:  # a further shape of a kernel listed already
            rows[name]["other_shapes"].append(row)
        else:
            rows[name] = {"replaces": replaces, **row, "other_shapes": []}
        del args, library, got, ref, lib
    torch.cuda.empty_cache()
    for name, fn in counters.items():
        fn.launches = saved[name]
    return rows


def run_probe_tools(dev) -> tuple[dict, dict]:
    """Phase 5, part 2: the three probe tools' probe functions at E = 2^25,
    and probe_permute's rows h and i at 2^26, with every PK launch count set
    to 0 just before and read just after.  Returns (seconds by row, launches
    by kernel)."""
    from photon_tpu_torch.ops import probe_kernels as pk
    from photon_tpu_torch.tools import probe_blocklocal, probe_permute, probe_tiles

    for fn in pk.KERNELS:
        fn.launches = 0
    seconds = {}
    log(f"  probe_permute, E={PROBE_E:,}:")
    for probe in probe_permute.PROBES:
        seconds[f"probe_permute.{probe.__name__}"] = probe(PROBE_E, dev)
    log(f"  probe_permute rows h and i at the benes grid, E={CLOS_E:,}:")
    for probe in (probe_permute.probe_rowwise_gather, probe_permute.probe_clos_composite):
        seconds[f"probe_permute.{probe.__name__}@2^26"] = probe(CLOS_E, dev)
    log(f"  probe_tiles, E={PROBE_E:,}:")
    seconds["probe_tiles.elementwise_baseline"] = probe_tiles.elementwise_baseline(
        PROBE_E, dev)
    for probe in (probe_tiles.probe_copy, probe_tiles.probe_swap):
        seconds[f"probe_tiles.{probe.__name__}"] = probe(PROBE_E, dev)
    log(f"  probe_blocklocal, E={PROBE_E:,}:")
    for probe in probe_blocklocal.PROBES:
        seconds[f"probe_blocklocal.{probe.__name__}"] = probe(PROBE_E, dev)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in pk.KERNELS}
    log(f"  probe kernel launches in the tools' run: {launches}")
    unlaunched = sorted(name for name, n in launches.items() if not n)
    if unlaunched:
        raise AssertionError(f"the probe tools never launched {unlaunched}")
    return seconds, launches


def run_route_probe(prepared, main_path, dev) -> dict:
    """Phase 5, part 3: the measured auto route probe on each draw's batch
    from phase 2 (carrying fm, al, al_t and the xchg route): the probe's
    record (each candidate's gate error and median seconds, the choice),
    no candidate excluded by its gate, then a 10-iteration L-BFGS fit under
    auto held to phase 3's fit on the chosen route (fused's when auto picks
    fm, which phase 3 does not run) under ROUTE_RTOL."""
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import GlmOptimizationProblem, ProblemConfig
    from photon_tpu_torch.ops import sparse_grad_select as sel
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad
    from photon_tpu_torch.ops.slab_reduce import position_partial_sums

    reg = RegularizationContext("l2", 1.0)
    objective = GlmObjective.create("logistic", reg)
    problem = GlmOptimizationProblem(objective, ProblemConfig(
        regularization=reg, optimizer_config=OptimizerConfig(
            max_iterations=LBFGS_ITERATIONS, tolerance=0.0, gradient_tolerance=0.0),
    ))
    counters = {"fused_sparse": fused_value_and_grad,
                "position_reduce": position_partial_sums,
                "vperm_chunk": vp.chunk_pass, "vperm_lane": vp.lane_pass,
                "vperm_chunk_expand": vp.chunk_expand_pass}
    phase3 = {(r["dist"], r["route"]): r["final_value"] for r in main_path["runs"]}
    os.environ["PHOTON_SPARSE_GRAD"] = "auto"
    sel._CACHE.clear()
    sel.PROBE_RECORD.clear()
    out = {}
    try:
        for dist in DISTS:
            batch = prepared[dist]["attached"]
            t0 = time.monotonic()
            choice = objective._sparse_kernel(batch, D)
            probe_s = time.monotonic() - t0
            key = list(sel.PROBE_RECORD)[-1]
            record = sel.PROBE_RECORD[key]
            log(f"  {dist}: auto probe (key {key}) in {probe_s:.2f} s: probe batch "
                f"{record['rows']} x {record['nnz_per_row']} on {record['device']}")
            for name, c in record["candidates"].items():
                gate = ("no gate" if c["gate_max_abs_err"] is None
                        else f"gate max_abs_err {c['gate_max_abs_err']:.3e}")
                secs = "excluded" if c["seconds"] is None else f"{c['seconds'] * 1e3:.4f} ms"
                log(f"    {name}: {gate}, median {secs}")
            log(f"    probe verdict {record['choice']}, route for the batch {choice}")
            if record["excluded"]:
                raise AssertionError(f"{dist}: the probe's gate excluded {record['excluded']}")
            expected = {"fused", "fm", "pallas", "xchg"}
            if set(record["candidates"]) != expected:
                raise AssertionError(f"{dist}: the probe timed {sorted(record['candidates'])}"
                                     f", not {sorted(expected)}")
            for c in counters.values():
                c.launches = 0
            w0 = torch.zeros(D, device=dev)
            t0 = time.monotonic()
            _, res = problem.run(batch, w0)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = {name: c.launches for name, c in counters.items()}
            compare = choice if (dist, choice) in phase3 else "fused"
            rel = abs(res.value - phase3[(dist, compare)]) / abs(phase3[(dist, compare)])
            log(f"  {dist}/auto ({choice}): {res.iterations} iterations, f -> "
                f"{res.value:.9g} in {wall:.3f} s, launches "
                f"{ {k: v for k, v in counts.items() if v} }; vs phase 3's {compare} "
                f"rel diff {rel:.3e} (tolerance {ROUTE_RTOL:g})")
            if rel > ROUTE_RTOL:
                raise AssertionError(f"{dist}: auto ({choice}) disagrees with phase 3")
            if choice == "fused" and not counts["fused_sparse"]:
                raise AssertionError(f"{dist}: auto chose fused but K1 never launched")
            if choice in ("pallas", "xchg") and not counts["position_reduce"]:
                raise AssertionError(f"{dist}: auto chose {choice} but K2 never launched")
            out[dist] = {
                "choice": choice, "probe_s": probe_s, "record": record, "fit_s": wall,
                "final_value": res.value, "compared_with": compare, "rel_diff": rel,
                "launches": counts,
            }
    finally:
        os.environ.pop("PHOTON_SPARSE_GRAD", None)
    return out


# (optimizer, backend, PHOTON_SPARSE_GRAD) of each CLI run; None: the default.
CLI_RUNS = (
    ("lbfgs", "gpu", None), ("lbfgs", "cpu", None), ("lbfgs", "gpu", "xchg"),
    ("tron", "gpu", None), ("tron", "cpu", None), ("tron", "gpu", "benes"),
)


def run_cli() -> dict:
    aucs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        for optimizer, backend, route in CLI_RUNS:
            name = backend if route is None else f"{backend}/{route}"
            if optimizer != "lbfgs":
                name = f"{optimizer}:{name}"
            out_dir = os.path.join(tmp, name.replace("/", "_").replace(":", "_"))
            cmd = [
                sys.executable, "-m", "photon_tpu_torch.drivers.train",
                "--input", "tests/fixtures/a1a.libsvm",
                "--validation-input", "tests/fixtures/a1a.t.libsvm",
                "--task", "logistic_regression", "--optimizer", optimizer,
                "--reg-type", "l2", "--reg-weights", "0.1,1,10",
                "--evaluators", "AUC,LOGISTIC_LOSS",
                "--output-dir", out_dir, "--backend", backend,
            ]
            env = {k: v for k, v in os.environ.items() if k != "PHOTON_SPARSE_GRAD"}
            if route is not None:
                env["PHOTON_SPARSE_GRAD"] = route
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                                  env=env)
            if proc.returncode != 0:
                raise RuntimeError(f"train CLI ({name}) failed:\n{proc.stderr[-4000:]}")
            with open(os.path.join(out_dir, "training_summary.json")) as f:
                summary = json.load(f)
            best = next(e for e in summary["sweep"]
                        if e["lambda"] == summary["best_lambda"])
            aucs[name] = best["metrics"]["AUC"]
            log(f"  train CLI --optimizer {optimizer} --backend {backend}, route "
                f"{route or 'default'}: "
                f"best lambda {summary['best_lambda']:g}, AUC {aucs[name]:.6f}, "
                f"device {summary['device']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for base, other in (("gpu", "cpu"), ("gpu", "gpu/xchg"),
                        ("tron:gpu", "tron:cpu"), ("tron:gpu", "tron:gpu/benes")):
        diff = abs(aucs[base] - aucs[other])
        log(f"  AUC {base} vs {other}: |diff| {diff:.2e} (tolerance {CLI_AUC_ATOL:g})")
        if diff > CLI_AUC_ATOL:
            raise AssertionError(f"the CLI's AUC differs between {base} and {other}")
    return aucs


# Phase 6: BASELINE.json config 4 at bench.py's "big" scale (bench.py:402-423):
# MovieLens-1M's user and item counts, ~300K ratings.
GAME_FIXTURE = dict(n_users=6040, n_items=3700, mean_ratings=50)
GAME_DESCENT_ITERATIONS = 2
# (name, PHOTON_SPARSE_GRAD, --backend) of each train_game run; None: auto.
GAME_RUNS = (("fused", "fused", "gpu"), ("pallas", "pallas", "gpu"),
             ("auto", None, "gpu"), ("cpu", None, "cpu"))
# Card against host: the validation metrics under the reference's
# device-vs-host residual bound (tests/test_residuals.py:260-265), the
# coefficients under its mesh-vs-single-device bound (tests/test_game.py:
# 377-385).
GAME_METRIC_ATOL = 1e-4
GAME_COEF_TOL = 1e-3


def game_cli_args(avro: str, out: str, backend: str) -> list:
    return [
        "--input", avro, "--feature-bags", "global=global,per_user=per_user",
        "--id-columns", "userId,itemId",
        "--coordinate", "fixed:type=fixed,shard=global,max_iters=30",
        "--coordinate", "per_user:type=random,shard=per_user,entity=userId,max_iters=20",
        "--descent-iterations", str(GAME_DESCENT_ITERATIONS),
        "--validation-split", "0.2", "--output-dir", out, "--backend", backend,
    ]


def game_op_timings(data, dev) -> dict:
    """The random-effect path's torch ops and the score-table update on the
    card, at the training split's own bins (of ``data``, the dataset the
    first run read from the Avro file): per bin the lane objective's
    value and gradient, its Hessian (a float64 scatter), one batched
    Cholesky step, one line-search block of values and the whole Newton
    fit, each beside the time its bytes
    take at the card's memory rate; then one residual-engine update and one
    offsets pass over the table."""
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.optimizers.newton import newton_step
    from photon_tpu_torch.core.problem import ProblemConfig
    from photon_tpu_torch.game.batched_solve import LaneObjective, run_newton_fit
    from photon_tpu_torch.game.coordinate import (
        RandomEffectCoordinateConfig,
        RandomEffectDeviceData,
    )
    from photon_tpu_torch.game.data import split_game_dataset
    from photon_tpu_torch.game.residuals import ResidualEngine

    train, _ = split_game_dataset(data, 0.2)
    reg = RegularizationContext("l2", 1.0)
    problem = ProblemConfig(regularization=reg,
                            optimizer_config=OptimizerConfig(max_iterations=20))
    dd = RandomEffectDeviceData(
        train, RandomEffectCoordinateConfig("per_user", "userId", problem), dev)
    lane = LaneObjective.of(GlmObjective.create("logistic_regression", reg))
    rows = []
    for i, stats in enumerate(dd.bin_stats):
        batch = dd.batch_for(i, torch.zeros_like(dd.device_buckets[i]["weight"]))
        bsz, r, k = batch.ids.shape
        d = dd.dim
        w = torch.zeros(bsz, d, device=dev)
        h = lane.hessian_matrix(w, batch)
        _, g = lane.value_and_grad(w, batch)
        ts = torch.ones(bsz, 9, device=dev)
        inputs = batch.ids.numel() * 8 + bsz * r * 12 + bsz * d * 4
        row = {
            "bin": i, "entities": stats["live_entities"], "capacity": r, "k": k,
            "value_and_grad_ms": cuda_ms(lambda: lane.value_and_grad(w, batch)),
            "value_and_grad_bound_ms": (inputs + bsz * (d + 1) * 4) / HBM_BYTES_PER_S * 1e3,
            "hessian_ms": cuda_ms(lambda: lane.hessian_matrix(w, batch)),
            "hessian_bound_ms": (inputs + bsz * d * d * 4) / HBM_BYTES_PER_S * 1e3,
            "cholesky_step_ms": cuda_ms(lambda: newton_step(h, g)),
            # The line search's first block: t = 0 and 8 step sizes.
            "line_values_ms": cuda_ms(lambda: lane.line_values(w, g, ts, batch)),
            "line_values_bound_ms": (inputs + bsz * (2 * d + 9) * 4) / HBM_BYTES_PER_S * 1e3,
            "newton_fit_ms": cuda_ms(lambda: run_newton_fit(
                lane, batch, w, cfg=problem.optimizer_config, variance="none"),
                reps=2, warmup=1),
        }
        rows.append(row)
        log(f"    bin {i}: {stats['live_entities']} entities x {r} rows x k={k}: "
            f"value_and_grad {row['value_and_grad_ms']:.3f} ms (bytes bound "
            f"{row['value_and_grad_bound_ms']:.4f}), hessian {row['hessian_ms']:.3f} ms "
            f"(bound {row['hessian_bound_ms']:.4f}), cholesky step "
            f"{row['cholesky_step_ms']:.3f} ms, line-search block "
            f"{row['line_values_ms']:.3f} ms (bound {row['line_values_bound_ms']:.4f}), "
            f"whole Newton fit "
            f"{row['newton_fit_ms']:.2f} ms")
    n = train.num_examples
    engine = ResidualEngine(train.offset, ["fixed", "per_user"], dev)
    scores = torch.randn(n, device=dev)
    table = {
        "rows": n,
        "update_ms": cuda_ms(lambda: engine.update("fixed", scores)),
        "offsets_ms": cuda_ms(lambda: engine.offsets_for("per_user")),
        # update: read the row and the [2, n] table, write the row, total, comp.
        "update_bound_ms": (n * 4 * 6) / HBM_BYTES_PER_S * 1e3,
        "offsets_bound_ms": (n * 4 * 5) / HBM_BYTES_PER_S * 1e3,
    }
    engine.drain_guard_flags()
    log(f"    residual engine over {n:,} rows: update {table['update_ms']:.3f} ms "
        f"(bound {table['update_bound_ms']:.4f}), offsets {table['offsets_ms']:.3f} "
        f"ms (bound {table['offsets_bound_ms']:.4f})")
    return {"bins": rows, "residuals": table}


def game_reads(avro: str) -> dict:
    """The Avro file read by the native decoder and by the Python reader
    (``PHOTON_TPU_NO_NATIVE_AVRO=1``), each timed; the two held equal bit
    for bit: labels, offsets, weights, ids, values, entity ids, index maps."""
    from photon_tpu_torch.data import game_io

    bags = {"global": "global", "per_user": "per_user"}
    cols = ["userId", "itemId"]
    reads = {}
    for name, flag in (("native", None), ("python", "1")):
        before = os.environ.pop("PHOTON_TPU_NO_NATIVE_AVRO", None)
        if flag is not None:
            os.environ["PHOTON_TPU_NO_NATIVE_AVRO"] = flag
        try:
            t0 = time.monotonic()
            data, maps = game_io.read_game_avro(avro, bags, cols)
            seconds = time.monotonic() - t0
        finally:
            os.environ.pop("PHOTON_TPU_NO_NATIVE_AVRO", None)
            if before is not None:
                os.environ["PHOTON_TPU_NO_NATIVE_AVRO"] = before
        if game_io.last_reader != name:
            raise AssertionError(f"GAME: the {name} read ran the {game_io.last_reader} reader")
        reads[name] = (data, maps, seconds)
    (nat, nat_maps, _), (py, py_maps, _) = reads["native"], reads["python"]
    same = all(np.array_equal(getattr(nat, f), getattr(py, f))
               for f in ("label", "offset", "weight"))
    same &= all(np.array_equal(nat.id_columns[c], py.id_columns[c]) for c in cols)
    for shard in bags:
        same &= np.array_equal(nat.shard(shard).ids, py.shard(shard).ids)
        same &= np.array_equal(nat.shard(shard).vals, py.shard(shard).vals)
        same &= list(nat_maps[shard].keys()) == list(py_maps[shard].keys())
    log(f"  Avro read: native {reads['native'][2]:.2f} s, Python {reads['python'][2]:.2f} s; "
        f"the two bit for bit {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("GAME: the native and Python Avro reads differ")
    return {"native_s": reads["native"][2], "python_s": reads["python"][2]}


def run_game(dev, tmp: str) -> dict:
    """Phase 6: the port's ``train_game`` on config 4, on the card under
    ``fused``, ``pallas`` and ``auto`` and on the host, each run with every
    launch count set to 0 just before it and read just after; card and host
    held to each other; then the random-effect path's torch ops timed.  The
    Avro file and every run's output directory stay in ``tmp`` for phase 8
    (``out["avro"]``, ``out["run_dirs"]``)."""
    from photon_tpu_torch.data import game_io
    from photon_tpu_torch.data.fixtures import make_movielens_like
    from photon_tpu_torch.data.game_io import write_game_avro
    from photon_tpu_torch.drivers import train_game
    from photon_tpu_torch.game.model_io import load_game_model
    from photon_tpu_torch.ops import probe_kernels as pk
    from photon_tpu_torch.ops import sparse_grad_select as sel
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad, row_scatter
    from photon_tpu_torch.ops.slab_reduce import (
        aligned_gather_products,
        position_partial_sums,
    )

    counters = {"fused_sparse": fused_value_and_grad, "row_scatter": row_scatter,
                "position_reduce": position_partial_sums,
                "vperm_chunk": vp.chunk_pass, "vperm_lane": vp.lane_pass,
                "vperm_chunk_expand": vp.chunk_expand_pass,
                "slab_gather": aligned_gather_products}
    out = {"runs": {}}
    t0 = time.monotonic()
    data, maps = make_movielens_like(**GAME_FIXTURE)
    out["generate_s"] = time.monotonic() - t0
    avro = os.path.join(tmp, "movielens.avro")
    out["avro"] = avro
    out["run_dirs"] = {name: os.path.join(tmp, name) for name, _, _ in GAME_RUNS}
    t0 = time.monotonic()
    write_game_avro(avro, data, maps)
    out["avro_write_s"] = time.monotonic() - t0
    n_rows = data.num_examples
    users = len(np.unique(data.id_columns["userId"]))
    out.update(rows=n_rows, users=users, avro_bytes=os.path.getsize(avro))
    log(f"  config 4: {n_rows:,} ratings, {users} users, "
        f"{len(np.unique(data.id_columns['itemId']))} items; Avro write "
        f"{out['avro_write_s']:.2f} s ({out['avro_bytes'] / 2**20:.1f} MiB)")
    del data
    out["avro_read_s"] = game_reads(avro)
    # The first run's dataset, as read from the Avro file, is kept for the
    # torch-op timings below.
    read = []
    load = train_game._load_game_data

    def load_and_keep(*args, **kwargs):
        loaded = load(*args, **kwargs)
        if not read:
            read.append(loaded[0])
        return loaded

    train_game._load_game_data = load_and_keep
    for name, route, backend in GAME_RUNS:
        env_before = os.environ.get("PHOTON_SPARSE_GRAD")
        if route is None:
            os.environ.pop("PHOTON_SPARSE_GRAD", None)
        else:
            os.environ["PHOTON_SPARSE_GRAD"] = route
        probes_before = set(sel.PROBE_RECORD)
        for c in (*counters.values(), *pk.KERNELS):
            c.launches = 0
        run_dir = os.path.join(tmp, name)
        try:
            t0 = time.monotonic()
            summary = train_game.run(train_game.build_parser().parse_args(
                game_cli_args(avro, run_dir, backend)))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        finally:
            if env_before is None:
                os.environ.pop("PHOTON_SPARSE_GRAD", None)
            else:
                os.environ["PHOTON_SPARSE_GRAD"] = env_before
            train_game._load_game_data = load
        counts = {k: c.launches for k, c in counters.items()}
        probes = {c.__name__: c.launches for c in pk.KERNELS}
        if any(probes.values()):
            raise AssertionError(f"GAME {name}: probe kernels launched: {probes}")
        if game_io.last_reader != "native":
            raise AssertionError(f"GAME {name}: the Avro file was read by the "
                                 f"{game_io.last_reader} reader")
        model, _ = load_game_model(os.path.join(run_dir, "best_model"), device="cpu")
        fit_s = sum(v for k, v in summary["phase_times"].items()
                    if k.startswith("fit-"))
        history = summary["sweep"][0]["history"]
        iteration_s = [h["seconds"] for h in history]
        run = {
            "backend": backend, "route": route or "auto", "wall_s": wall,
            "phase_times": summary["phase_times"],
            "epoch_s": wall / GAME_DESCENT_ITERATIONS,
            "descent_iteration_s": iteration_s,
            # The fit phase outside its descent iterations: the device
            # data (bucketing, size bins, layouts) and the uploads.
            "fit_setup_s": fit_s - sum(iteration_s),
            "fit_s_per_descent_iteration": fit_s / GAME_DESCENT_ITERATIONS,
            "rows_per_s": GAME_DESCENT_ITERATIONS * n_rows / wall,
            "launches": {k: v for k, v in counts.items() if v},
            "history": history,
            "best_metrics": summary["best_metrics"], "device": summary["device"],
        }
        probe = [sel.PROBE_RECORD[key] for key in sel.PROBE_RECORD
                 if key not in probes_before]
        if probe:
            run["auto_probe"] = probe
        out["runs"][name] = (run, model)
        log(f"  train_game {name} ({backend}, route {route or 'auto'}): "
            f"{wall:.2f} s, of them the native Avro read (load-data) "
            f"{summary['phase_times']['load-data']:.2f} s "
            f"({run['epoch_s']:.3f} s per descent iteration as "
            f"bench.py counts it, fit {run['fit_s_per_descent_iteration']:.3f} s "
            f"per descent iteration: set-up {run['fit_setup_s']:.3f} s, iterations "
            f"{[round(t, 4) for t in iteration_s]} s; {run['rows_per_s']:,.0f} "
            f"rows/s), phases "
            f"{ {k: round(v, 3) for k, v in summary['phase_times'].items()} }, "
            f"metrics {summary['best_metrics']}, launches {run['launches']}")
        for p in probe:
            log(f"    auto probe: choice {p.get('choice')}, "
                f"{json.dumps(p, default=str)}")
        for h in run["history"]:
            fixed, per_user = h["solver"]["fixed"], h["solver"]["per_user"]
            ms_each = 1e3 * fixed["seconds"] / max(fixed["evaluations"], 1)
            log(f"    iteration {h['iteration']}: {h['seconds']:.3f} s; fixed effect "
                f"{fixed['iterations']} "
                f"L-BFGS iterations, {fixed['evaluations']} evaluations, "
                f"{ms_each:.3f} ms each, {fixed['host_reads']} host reads; "
                f"residual updates {h['residual_updates']}, descent host syncs "
                f"{h['host_syncs']}; metrics {h['metrics']}")
            for b in per_user["bins"]:
                log(f"      per_user bin {b['bin']}: {b['entities']} entities, "
                    f"capacity {b['capacity']}, route {b['route']}, "
                    f"{b['newton_iterations']} Newton iterations, "
                    f"{b['host_reads']} host reads, {1e3 * b['seconds']:.2f} ms")
    cpu_run, cpu_model = out["runs"]["cpu"]
    for name in ("fused", "pallas", "auto"):
        run, model = out["runs"][name]
        for h, hc in zip(run["history"], cpu_run["history"]):
            for metric, ref in hc["metrics"].items():
                diff = abs(h["metrics"][metric] - ref)
                if diff > GAME_METRIC_ATOL:
                    raise AssertionError(
                        f"GAME {name}: {metric} at iteration {h['iteration']} "
                        f"differs from the host run by {diff:.3e}")
        pairs = (
            ("fixed", model.coordinate("fixed").coefficients.means,
             cpu_model.coordinate("fixed").coefficients.means),
            ("per_user", model.coordinate("per_user").table,
             cpu_model.coordinate("per_user").table),
        )
        errs = {}
        for coord, got, want in pairs:
            if not torch.allclose(got, want, rtol=GAME_COEF_TOL, atol=GAME_COEF_TOL):
                raise AssertionError(f"GAME {name}: {coord} coefficients differ "
                                     "from the host run")
            errs[coord] = float((got - want).abs().max())
        run["coefficient_max_abs_diff_vs_cpu"] = errs
        log(f"  {name} vs cpu: metrics within {GAME_METRIC_ATOL:g}, coefficients "
            f"max |diff| {errs} (tolerance rtol = atol = {GAME_COEF_TOL:g})")
    # Phase 2 held K1 and K2 at the fixed effect's batch shape: the auto
    # run's probe saw it.
    seen = [(p["rows"], p["nnz_per_row"], p["dim"])
            for p in out["runs"]["auto"][0].get("auto_probe", [])]
    if seen != [GAME_FIXED_SHAPE]:
        raise AssertionError(f"GAME: the fixed effect's batch {seen} is not phase "
                             f"2's GAME_FIXED_SHAPE {GAME_FIXED_SHAPE}")
    for name, kernel in (("fused", "fused_sparse"), ("pallas", "position_reduce")):
        if not out["runs"][name][0]["launches"].get(kernel):
            raise AssertionError(f"GAME {name}: {kernel} never launched")
    log("  the random-effect path's torch ops and the score table:")
    out["ops"] = game_op_timings(read[0], dev)
    out["runs"] = {name: run for name, (run, _) in out["runs"].items()}
    return out


# Phase 7: (name, PHOTON_SPARSE_GRAD, --backend, --normalization, files).
# The card's timed runs on the full files; the host runs, and the card runs
# held to them, on the host files.
CONFIG2_RUNS = (
    ("card_fused", "fused", "gpu", "none", "full"),
    ("card_pallas_norm", "pallas", "gpu", "standardization", "full"),
    ("card_fused_host_rows", "fused", "gpu", "none", "host"),
    ("card_pallas_norm_host_rows", "pallas", "gpu", "standardization", "host"),
    ("cpu_fused_host_rows", "fused", "cpu", "none", "host"),
    ("cpu_pallas_norm_host_rows", "pallas", "cpu", "standardization", "host"),
)
# Card against host: the validation RMSE within 1e-4 relative, the
# coefficients within rtol = atol = 1e-3 (phase 6's bounds); the card's and
# the host's scores within 1e-4, their RMSE the train summary's to 1e-6.
CONFIG2_RMSE_RTOL = 1e-4
CONFIG2_COEF_TOL = 1e-3
CONFIG2_SCORE_ATOL = 1e-4
CONFIG2_SCORE_RMSE_RTOL = 1e-6


def config2_args(files: dict, out: str, backend: str, normalization: str) -> list:
    """The train CLI's arguments for config 2, as bench.py passes them."""
    return [
        "--input", files["train"], "--validation-input", files["val"],
        "--task", "linear_regression", "--optimizer", "owlqn",
        "--reg-type", "elastic_net", "--reg-weights", "1.0",
        "--max-iterations", "100", "--normalization", normalization,
        "--output-dir", out, "--backend", backend,
    ]


def run_config2() -> dict:
    """Phase 7: BASELINE.json config 2 (linear regression, elastic net,
    OWL-QN) through the train CLI's entry point, on the card under
    ``fused`` and under ``pallas`` with standardization, and on the host;
    then the scoring CLI on the validation file, on the card and the host.
    Every launch count is set to 0 just before each run and read just
    after: K1 must launch on the ``fused`` card runs, K2 and not K1 on the
    normalized ``pallas`` ones."""
    from photon_tpu_torch.data.synthetic import make_glm_data, write_libsvm
    from photon_tpu_torch.drivers import score, train
    from photon_tpu_torch.native import libsvm_native
    from photon_tpu_torch.ops import probe_kernels as pk
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad, row_scatter
    from photon_tpu_torch.ops.slab_reduce import (
        aligned_gather_products,
        position_partial_sums,
    )

    counters = {"fused_sparse": fused_value_and_grad, "row_scatter": row_scatter,
                "position_reduce": position_partial_sums,
                "vperm_chunk": vp.chunk_pass, "vperm_lane": vp.lane_pass,
                "vperm_chunk_expand": vp.chunk_expand_pass,
                "slab_gather": aligned_gather_products}
    n, d = CONFIG2_ROWS, CONFIG2_D
    n_val, n_host = n // 5, CONFIG2_HOST_ROWS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_config2_")
    out = {"rows": n, "validation_rows": n_val, "host_rows": n_host, "dim": d,
           "runs": {}}
    try:
        t0 = time.monotonic()
        batch, _ = make_glm_data(n + n_val, d, task="linear_regression", seed=0,
                                 device="cpu")
        x, y = batch.x.numpy()[:, :-1], batch.label.numpy()
        out["generate_s"] = time.monotonic() - t0
        files = {"full": {}, "host": {}}
        t0 = time.monotonic()
        for kind, rows in (("train", slice(0, n)), ("val", slice(n, n + n_val))):
            files["full"][kind] = os.path.join(tmp, f"{kind}.libsvm")
            write_libsvm(files["full"][kind], x[rows], y[rows])
        out["write_s"] = time.monotonic() - t0
        for kind, rows in (("train", slice(0, n_host)),
                           ("val", slice(n, n + n_host // 5))):
            files["host"][kind] = os.path.join(tmp, f"{kind}_host.libsvm")
            write_libsvm(files["host"][kind], x[rows], y[rows])
        out["train_file_bytes"] = os.path.getsize(files["full"]["train"])
        del batch, x, y
        t0 = time.monotonic()
        csr = libsvm_native.parse_file_csr(files["full"]["train"])
        out["parse_s"] = time.monotonic() - t0
        if csr is None or csr[2].size != n * (d - 1):
            raise AssertionError("config 2: the native LIBSVM parse did not run")
        del csr
        log(f"  config 2: {n:,} + {n_val:,} rows x {d - 1} features + intercept; LIBSVM "
            f"write {out['write_s']:.2f} s ({out['train_file_bytes'] / 2**20:.0f} MiB "
            f"training file), native parse {out['parse_s']:.2f} s")
        models = {}
        for name, route, backend, norm, which in CONFIG2_RUNS:
            run_dir = os.path.join(tmp, name)
            env_before = os.environ.get("PHOTON_SPARSE_GRAD")
            os.environ["PHOTON_SPARSE_GRAD"] = route
            for c in (*counters.values(), *pk.KERNELS):
                c.launches = 0
            try:
                t0 = time.monotonic()
                summary = train.run(train.build_parser().parse_args(
                    config2_args(files[which], run_dir, backend, norm)))
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            finally:
                if env_before is None:
                    os.environ.pop("PHOTON_SPARSE_GRAD", None)
                else:
                    os.environ["PHOTON_SPARSE_GRAD"] = env_before
            counts = {k: c.launches for k, c in counters.items() if c.launches}
            probes = {c.__name__: c.launches for c in pk.KERNELS if c.launches}
            entry = summary["sweep"][0]
            fit_s = entry["wall_time_s"]
            run = {
                "backend": backend, "route": route, "normalization": norm,
                "rows": n if which == "full" else n_host, "wall_s": wall,
                "phase_times": summary["phase_times"], "reader": summary["input_reader"],
                "iterations": entry["iterations"], "evaluations": entry["evaluations"],
                "host_reads": entry["host_reads"], "reason": entry["convergence_reason"],
                "fit_s": fit_s, "steps_per_s": entry["iterations"] / fit_s,
                "s_per_evaluation": fit_s / entry["evaluations"],
                "final_value": entry["final_value"], "metrics": entry["metrics"],
                "zero_coefficients": entry["zero_coefficients"], "launches": counts,
                "device": summary["device"],
            }
            out["runs"][name] = run
            log(f"  train {name} (--backend {backend}, route {route}, normalization "
                f"{norm}, {run['rows']:,} rows): {wall:.2f} s; {run['iterations']} OWL-QN "
                f"iterations ({run['reason']}), {run['evaluations']} evaluations, "
                f"{run['host_reads']} host reads, fit {fit_s:.3f} s = "
                f"{run['steps_per_s']:.2f} steps/s, {1e3 * run['s_per_evaluation']:.3f} "
                f"ms per evaluation; {run['zero_coefficients']} exact-zero "
                f"coefficients; validation {run['metrics']}; launches {counts}; "
                f"{run['reader']} parser; phases "
                f"{ {k: round(v, 3) for k, v in summary['phase_times'].items()} }")
            if probes:
                raise AssertionError(f"config 2 {name}: probe kernels launched: {probes}")
            if run["reader"] != "native":
                raise AssertionError(f"config 2 {name}: the {run['reader']} parser ran")
            if backend == "gpu":
                k1, k2 = counts.get("fused_sparse", 0), counts.get("position_reduce", 0)
                if route == "fused" and not k1:
                    raise AssertionError(f"config 2 {name}: K1 never launched")
                if route == "pallas" and (not k2 or k1):
                    raise AssertionError(f"config 2 {name}: K2 {k2} and K1 {k1} launches")
            models[name] = run_dir
        for card, host in (("card_fused_host_rows", "cpu_fused_host_rows"),
                           ("card_pallas_norm_host_rows", "cpu_pallas_norm_host_rows")):
            got, want = out["runs"][card], out["runs"][host]
            rel = abs(got["metrics"]["RMSE"] - want["metrics"]["RMSE"]) / want["metrics"]["RMSE"]
            w_card = config2_means(models[card])
            w_host = config2_means(models[host])
            coef = float(np.abs(w_card - w_host).max())
            ok = rel <= CONFIG2_RMSE_RTOL and np.allclose(
                w_card, w_host, rtol=CONFIG2_COEF_TOL, atol=CONFIG2_COEF_TOL)
            got["vs_host"] = {"rmse_rel_diff": rel, "coefficient_max_abs_diff": coef}
            log(f"  {card} vs {host}: RMSE relative diff {rel:.2e} (tolerance "
                f"{CONFIG2_RMSE_RTOL:g}), coefficients max |diff| {coef:.2e} (rtol = atol = "
                f"{CONFIG2_COEF_TOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"config 2: {card} disagrees with {host}")
        out["score"] = score_config2(files["full"]["val"], models["card_fused"],
                                     out["runs"]["card_fused"], counters, tmp, score)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def config2_means(run_dir: str) -> np.ndarray:
    """A run's saved model's means, in feature-index order."""
    from photon_tpu_torch.data.index_map import IndexMap
    from photon_tpu_torch.data.model_io import load_glm_model

    imap = IndexMap.load(os.path.join(run_dir, "feature_index.json"))
    model = load_glm_model(os.path.join(run_dir, "best_model.avro"), imap, device="cpu")
    return model.coefficients.means.numpy()


def score_config2(val: str, model_dir: str, train_run: dict, counters: dict,
                  tmp: str, score) -> dict:
    """The scoring CLI's entry point on the validation file with the card
    ``fused`` run's model, on the card and on the host: the scores within
    CONFIG2_SCORE_ATOL of each other, each RMSE the train summary's."""
    out = {}
    scores = {}
    for backend in ("gpu", "cpu"):
        for c in counters.values():
            c.launches = 0
        score_dir = os.path.join(tmp, f"score_{backend}")
        t0 = time.monotonic()
        res = score.run(score.build_parser().parse_args([
            "--input", val, "--model", os.path.join(model_dir, "best_model.avro"),
            "--evaluators", "RMSE", "--output-dir", score_dir, "--backend", backend]))
        wall = time.monotonic() - t0
        scores[backend] = np.loadtxt(os.path.join(score_dir, "scores.txt"))
        rmse = res["metrics"]["RMSE"]
        rel = abs(rmse - train_run["metrics"]["RMSE"]) / train_run["metrics"]["RMSE"]
        out[backend] = {"wall_s": wall, "rows": res["num_scored"], "rmse": rmse,
                        "rmse_rel_diff_vs_train": rel, "reader": res["input_reader"],
                        "phase_times": res["phase_times"],
                        "launches": {k: c.launches for k, c in counters.items()
                                     if c.launches}}
        log(f"  score --backend {backend}: {res['num_scored']:,} rows in {wall:.2f} s, "
            f"RMSE {rmse:.7f} (train summary {train_run['metrics']['RMSE']:.7f}, "
            f"relative diff {rel:.2e}, tolerance {CONFIG2_SCORE_RMSE_RTOL:g}), "
            f"{res['input_reader']} parser")
        if rel > CONFIG2_SCORE_RMSE_RTOL or res["input_reader"] != "native":
            raise AssertionError(f"config 2 score ({backend}) disagrees with training")
    diff = float(np.abs(scores["gpu"] - scores["cpu"]).max())
    out["score_max_abs_diff"] = diff
    log(f"  scores card vs host: max |diff| {diff:.2e} (tolerance {CONFIG2_SCORE_ATOL:g})")
    if not diff <= CONFIG2_SCORE_ATOL:
        raise AssertionError("config 2: card and host scores differ")
    return out


# Phase 8, serving on the card.  (b) is bench.py's serving fixture at its
# accelerator size (bench.py:1319-1367 and its _bench_serving): 20,000
# entities, two random coordinates of d = 32 and a fixed effect of d = 32
# over make_game_dataset(20000, 20, 32, 32, seed=0), seeded tables, 1500
# geometric requests of mean 8 rows, cap 128, 16 closed-loop clients.
SERVING_FIXTURE = dict(n_entities=20_000, rows_mean=20, dim=32)
SERVING_REQUESTS = 1500
SERVING_MEAN_ROWS = 8.0
SERVING_MAX_BATCH = 128
SERVING_CLIENTS = 16
SERVING_PASSES = 2
SERVING_TIMING_REPS = 50
# The reference's table-bytes bars against f32 (tests/test_lowp.py).
TABLE_BYTES_BARS = {"bf16": 1.9, "int8": 3.5}
# Parity: each dtype's worst |delta| against the host oracle, under
# PARITY_TOL, over every request for f32 and int8.  bf16 is gated as
# bench.py's serving bench gates it (bench.py:1487-1506), over the first
# 100 requests: later in this stream the reference's own bf16 tables (bit
# for bit the port's) pass 5e-2 (tests/test_torch_lowp.py::
# test_bench_fixture_parity_per_dtype).  The worst over every request is
# reported for every dtype.
PARITY_WINDOW = 100
WINDOWED_PARITY = ("bf16",)
# (a): the card's scores against the host's and the host oracle's.
SCORE_GAME_ATOL = 1e-5
# (c): serve_game's stream, and the rollout's, on phase 6's model.
FLEET_REQUESTS = 600
FLEET_DEADLINE_MS = 50.0
ROLLOUT_REQUESTS = 600
ROLLOUT_ATOL = 1e-4
GAME_BAGS = ["--feature-bags", "global=global,per_user=per_user",
             "--id-columns", "userId,itemId"]


def kernel_wrappers() -> list:
    """Every hand-written kernel's wrapper; each counts its launches."""
    from photon_tpu_torch.ops import probe_kernels as pk
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad, row_scatter
    from photon_tpu_torch.ops.slab_reduce import (
        aligned_gather_products,
        position_partial_sums,
    )

    return [fused_value_and_grad, row_scatter, position_partial_sums, vp.chunk_pass,
            vp.lane_pass, vp.chunk_expand_pass, aligned_gather_products, *pk.KERNELS]


def counter_total(session, name: str) -> float:
    return sum(m["value"] for m in session.registry.snapshot()["counters"]
               if m["name"] == name)


@contextlib.contextmanager
def no_stray_syncs():
    """Inside, every synchronizing CUDA call but an event wait raises
    (``torch.cuda.set_sync_debug_mode``, process-wide, so the serving
    threads are held to it too): the scorer's one wait a batch is an
    event's, so a batch that syncs anywhere else fails."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def check_sync_guard(dev) -> None:
    """The guard is live: inside it ``.item()`` raises and an event wait
    does not."""
    x = torch.ones(1, device=dev)
    with no_stray_syncs():
        try:
            x.item()
        except RuntimeError:
            pass
        else:
            raise AssertionError("sync debug mode did not flag .item()")
        done = torch.cuda.Event()
        done.record()
        done.synchronize()


def allocator_segments(dev) -> int:
    """Device memory segments the caching allocator has ever allocated."""
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(dev).get("segment.all.allocated", 0))


def serving_fixture():
    """bench.py's serving model and request source, the model on the host
    (each scorer builds its own tables on the card from it)."""
    from photon_tpu_torch.data.synthetic import make_game_dataset
    from photon_tpu_torch.game.model import game_model_from_numpy

    f = SERVING_FIXTURE
    data, _ = make_game_dataset(f["n_entities"], f["rows_mean"], f["dim"], f["dim"],
                                seed=0, n_random_coords=2)
    rng = np.random.default_rng(7)
    coords = {"fixed": {"type": "fixed", "shard_name": "global",
                        "means": rng.standard_normal(f["dim"]).astype(np.float32)}}
    for name in ("re0", "re1"):
        keys = np.unique(data.id_columns[name])
        coords[name] = {"type": "random", "shard_name": name, "entity_column": name,
                        "keys": keys, "table": rng.standard_normal(
                            (len(keys), f["dim"])).astype(np.float32)}
    return game_model_from_numpy("logistic_regression", coords, device="cpu"), data


def stream_ms(fn, stream, reps: int = SERVING_TIMING_REPS, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn`` on ``stream`` (CUDA events)."""
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(reps):
            fn()
        end.record(stream)
    stream.synchronize()
    return start.elapsed_time(end) / reps


def bucket_bound(scorer, program) -> tuple:
    """The least time one bucket's program could take: its request inputs
    read once, the table rows its rows gather (and the fixed weights) read
    once, its outputs written once, against the multiply-adds."""
    bucket = program.rows
    nbytes = sum(v.numel() * v.element_size() for v in program.inputs.values())
    nbytes += sum(v.numel() * v.element_size() for v in program.outputs.values())
    ops = 0
    for c, table in zip(scorer._plan, scorer._tables):
        leaves = table if isinstance(table, tuple) else (table,)
        dim = leaves[0].shape[-1]
        if c.kind == "fixed":
            nbytes += leaves[0].numel() * 4
        else:
            nbytes += bucket * sum(
                (leaf.shape[1] if leaf.dim() == 2 else 1) * leaf.element_size()
                for leaf in leaves)
        ops += 2 * bucket * dim
    return bound(nbytes, ops) + (nbytes,)


def serving_bucket_timings(scorer, request) -> list:
    """Per bucket: the captured graph's replay and the same body run eagerly,
    and the batch's device work (copy up, replay, copy down), on CUDA events
    on the scorer's stream; the whole batch on the host clock (staging,
    copies, replay, the one wait); beside the bytes bound."""
    from photon_tpu_torch.serving import slice_request

    rows = []
    for bucket in scorer.buckets:
        program = scorer._programs[(bucket, "request")]
        if program.graph is None:
            raise AssertionError(f"serving: bucket {bucket} has no captured graph")
        req = slice_request(request, 0, bucket)
        with scorer._lock:
            scorer._stage(req, program, bucket, scorer._vocab)
            with torch.cuda.stream(scorer._stream):
                program.dev_in.copy_(program.host_in)
            replay_ms = stream_ms(program.graph.replay, scorer._stream)
            eager_ms = stream_ms(program.body, scorer._stream)
            device_ms = stream_ms(program.run, scorer._stream)
        t0 = time.perf_counter()
        for _ in range(SERVING_TIMING_REPS):
            scorer.score_batch(req)
        batch_ms = (time.perf_counter() - t0) * 1e3 / SERVING_TIMING_REPS
        bound_ms, bound_by, nbytes = bucket_bound(scorer, program)
        rows.append({"bucket": bucket, "replay_ms": replay_ms, "eager_ms": eager_ms,
                     "batch_device_ms": device_ms, "batch_host_ms": batch_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes})
    return rows


def run_serving_fixture(dev) -> dict:
    """(b): one scorer per table dtype at bench.py's serving size, driven by
    the closed-loop batcher; after warmup no capture and no new allocator
    segment, one host sync a batch and no other (the loops run inside
    :func:`no_stray_syncs`), parity within PARITY_TOL of the host oracle,
    the table-bytes bars met."""
    from photon_tpu_torch.drivers.serve_game import request_sizes
    from photon_tpu_torch.game.lowp import PARITY_TOL, TABLE_DTYPES
    from photon_tpu_torch.serving import (
        GameScorer,
        RequestBatcher,
        build_requests,
        concat_requests,
        host_score_request,
        request_spec_for_dataset,
        run_closed_loop,
    )
    from photon_tpu_torch.telemetry import TelemetrySession

    t0 = time.monotonic()
    model, data = serving_fixture()
    sizes = request_sizes(SERVING_REQUESTS, SERVING_MEAN_ROWS, SERVING_MAX_BATCH, seed=0)
    requests = build_requests(data, model, sizes)
    oracle = np.split(host_score_request(model, concat_requests(requests)),
                      np.cumsum(sizes)[:-1])
    spec = request_spec_for_dataset(model, data)
    out = {"setup_s": time.monotonic() - t0, "rows": int(sizes.sum()),
           "requests": len(requests), "dataset_rows": data.num_examples, "legs": {}}
    log(f"  (b) fixture: {data.num_examples:,} rows, {SERVING_REQUESTS} requests "
        f"({out['rows']:,} rows), set-up {out['setup_s']:.1f} s")
    check_sync_guard(dev)
    for dtype in TABLE_DTYPES:
        session = TelemetrySession(f"serving-{dtype}")
        t0 = time.monotonic()
        scorer = GameScorer(model, device=dev, request_spec=spec,
                            max_batch=SERVING_MAX_BATCH, telemetry=session,
                            table_dtype=dtype).warmup()
        torch.cuda.synchronize()
        warmup_s = time.monotonic() - t0
        captures = scorer.compilations
        segments = allocator_segments(dev)
        passes = []
        with no_stray_syncs(), RequestBatcher(
                scorer, max_batch=SERVING_MAX_BATCH, max_delay_s=0.001,
                telemetry=session) as batcher:
            for _ in range(SERVING_PASSES):
                passes.append(run_closed_loop(batcher, requests, clients=SERVING_CLIENTS))
        segments_after = allocator_segments(dev)
        _, latencies, wall = min(passes, key=lambda p: p[2])
        deltas = [[float(np.abs(got - want).max()) for got, want in zip(p[0], oracle)]
                  for p in passes]
        worst_all = max(max(d) for d in deltas)
        window = PARITY_WINDOW if dtype in WINDOWED_PARITY else SERVING_REQUESTS
        worst = max(max(d[:window]) for d in deltas)
        batches = counter_total(session, "serving.batches")
        syncs = counter_total(session, "serving.host_syncs")
        lat_ms = np.sort(np.asarray(latencies, np.float64)) * 1e3
        leg = {
            "captures_at_warmup": captures,
            "captures_after_serving": scorer.compilations,
            "segments_at_warmup": segments, "segments_after_serving": segments_after,
            "batches": batches, "host_syncs": syncs, "worst_parity": worst,
            "parity_requests": window, "worst_parity_all_requests": worst_all,
            "parity_tol": PARITY_TOL[dtype],
            "table_bytes": session.registry.gauge("serving.table_bytes",
                                                  dtype=dtype).value,
            "qps": len(requests) / wall, "rows_per_s": out["rows"] / wall,
            "wall_s": wall, "walls_s": [p[2] for p in passes],
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "warmup_s": warmup_s,
        }
        per_bucket = {int(m["labels"]["bucket"]): m["value"]
                      for m in session.registry.snapshot()["counters"]
                      if m["name"] == "serving.batches"}
        leg["buckets"] = serving_bucket_timings(scorer, concat_requests(requests[:40]))
        # An estimate of the card's busy share over the closed loops, not a
        # trace: each bucket's device work a batch (copies and replay, timed
        # apart above) times its batches in the loops, over their wall.
        device = {row["bucket"]: row["batch_device_ms"] for row in leg["buckets"]}
        leg["busy_share_estimate"] = sum(
            device[b] * count for b, count in per_bucket.items()) / (
            1e3 * sum(p[2] for p in passes))
        out["legs"][dtype] = leg
        log(f"  (b) {dtype}: captures {captures} at warmup, {scorer.compilations} after "
            f"serving; allocator segments {segments} -> {segments_after}; host syncs "
            f"{syncs:.0f} for {batches:.0f} batches, no other sync; worst parity "
            f"{worst:.3e} over the first {window} requests (tolerance "
            f"{PARITY_TOL[dtype]:g}), {worst_all:.3e} over all; table bytes {leg['table_bytes']:.0f}; "
            f"{leg['qps']:.1f} requests/s ({leg['rows_per_s']:,.0f} rows/s), p50 "
            f"{leg['p50_ms']:.3f} ms, p99 {leg['p99_ms']:.3f} ms (best of "
            f"{[round(w, 3) for w in leg['walls_s']]} s); warmup {warmup_s:.2f} s; "
            f"busy share estimate (device ms a batch x batches / wall) "
            f"{leg['busy_share_estimate']}")
        for row in leg["buckets"]:
            log(f"    bucket {row['bucket']}: replay {row['replay_ms']:.4f} ms, eager body "
                f"{row['eager_ms']:.4f} ms, copies and replay "
                f"{row['batch_device_ms']:.4f} ms, bound {row['bound_ms'] * 1e3:.4f} us "
                f"({row['bound_by']}, {row['bytes']:,} bytes), whole batch on the host "
                f"clock {row['batch_host_ms']:.4f} ms")
        if scorer.compilations != captures:
            raise AssertionError(f"serving {dtype}: captured after warmup")
        if segments_after != segments:
            raise AssertionError(f"serving {dtype}: new allocator segments after warmup")
        if syncs != batches or not batches:
            raise AssertionError(f"serving {dtype}: {syncs} host syncs for {batches} batches")
        if not worst <= PARITY_TOL[dtype]:
            raise AssertionError(f"serving {dtype}: parity {worst:.3e} past its tolerance")
    f32_bytes = out["legs"]["f32"]["table_bytes"]
    for dtype, bar in TABLE_BYTES_BARS.items():
        ratio = f32_bytes / out["legs"][dtype]["table_bytes"]
        out["legs"][dtype]["bytes_ratio_vs_f32"] = ratio
        log(f"  (b) {dtype} tables {ratio:.3f}x smaller than f32 (bar {bar}x)")
        if ratio < bar:
            raise AssertionError(f"serving {dtype}: table bytes {ratio:.3f}x under {bar}x")
    return out


def run_score_game(game: dict) -> dict:
    """(a): score_game on phase 6's ``fused`` model over its Avro file, on
    the card, on the host, and through the host oracle
    (``PHOTON_BATCH_SCORER=host``), the scores within SCORE_GAME_ATOL."""
    from photon_tpu_torch.drivers import score_game

    model_dir = os.path.join(game["run_dirs"]["fused"], "best_model")
    runs, scores = {}, {}
    for name, backend, scorer in (("gpu", "gpu", None), ("cpu", "cpu", None),
                                  ("host_oracle", "cpu", "host")):
        before = os.environ.pop("PHOTON_BATCH_SCORER", None)
        if scorer is not None:
            os.environ["PHOTON_BATCH_SCORER"] = scorer
        out_dir = os.path.join(os.path.dirname(game["avro"]), f"score_{name}")
        try:
            t0 = time.monotonic()
            res = score_game.run(score_game.build_parser().parse_args([
                "--input", game["avro"], "--model", model_dir, *GAME_BAGS,
                "--evaluators", "AUC,LOGISTIC_LOSS", "--backend", backend,
                "--output-dir", out_dir]))
            wall = time.monotonic() - t0
        finally:
            os.environ.pop("PHOTON_BATCH_SCORER", None)
            if before is not None:
                os.environ["PHOTON_BATCH_SCORER"] = before
        scores[name] = np.loadtxt(os.path.join(out_dir, "scores.txt"))
        runs[name] = {"wall_s": wall, "rows": res["num_scored"], "metrics": res["metrics"],
                      "phase_times": res["phase_times"]}
        log(f"  (a) score_game {name}: {res['num_scored']:,} rows in {wall:.2f} s, "
            f"phases { {k: round(v, 3) for k, v in res['phase_times'].items()} }, "
            f"metrics {res['metrics']}")
    for other in ("cpu", "host_oracle"):
        diff = float(np.abs(scores["gpu"] - scores[other]).max())
        runs[f"gpu_vs_{other}_max_abs_diff"] = diff
        log(f"  (a) card against {other}: max |diff| {diff:.2e} "
            f"(tolerance {SCORE_GAME_ATOL:g})")
        if not diff <= SCORE_GAME_ATOL:
            raise AssertionError(f"score_game: the card's scores differ from {other}")
    return runs


def run_serve_game(game: dict) -> dict:
    """(c), first half: serve_game on phase 6's model, two replicas,
    power-law traffic with a 10% cold-start storm and a deadline."""
    import json as _json

    from photon_tpu_torch.drivers import serve_game

    out_dir = os.path.join(os.path.dirname(game["avro"]), "served")
    summary = serve_game.run(serve_game.build_parser().parse_args([
        "--model", os.path.join(game["run_dirs"]["fused"], "best_model"),
        "--input", game["avro"], *GAME_BAGS, "--requests", str(FLEET_REQUESTS),
        "--clients", str(SERVING_CLIENTS), "--replicas", "2", "--traffic", "powerlaw",
        "--storm-frac", "0.1", "--deadline-ms", str(FLEET_DEADLINE_MS),
        "--max-batch", str(SERVING_MAX_BATCH), "--max-delay-ms", "1",
        "--backend", "gpu", "--output-dir", out_dir]))
    with open(os.path.join(out_dir, "telemetry", "run_report.json")) as f:
        counters = {}
        for m in _json.load(f)["metrics"]["counters"]:
            counters[m["name"]] = counters.get(m["name"], 0) + m["value"]
    summary["host_syncs"] = counters.get("serving.host_syncs", 0)
    summary["batches"] = counters.get("serving.batches", 0)
    log(f"  (c) serve_game: {summary['served']}/{summary['requests']} served, "
        f"{summary['shed']} shed, {summary['cold_entities']} cold entities, "
        f"{summary['qps']} requests/s, p50 {summary['latency_p50_ms']} ms, p99 "
        f"{summary['latency_p99_ms']} ms, {summary['compiled_programs']} programs "
        f"captured, {summary['host_syncs']:.0f} host syncs for {summary['batches']:.0f} "
        f"batches")
    if summary["served"] + summary["shed"] != FLEET_REQUESTS or not summary["served"]:
        raise AssertionError("serve_game: requests lost")
    if summary["host_syncs"] != summary["batches"] or not summary["cold_entities"]:
        raise AssertionError("serve_game: host syncs or the cold-start storm wrong")
    return summary


def retrain(game: dict) -> str:
    """Phase 6's ``fused`` fit retrained with one descent iteration in
    place of two: the same data, split and layout, other coefficients."""
    from photon_tpu_torch.drivers import train_game

    out_dir = os.path.join(os.path.dirname(game["avro"]), "retrained")
    args = game_cli_args(game["avro"], out_dir, "gpu")
    args[args.index("--descent-iterations") + 1] = "1"
    before = os.environ.get("PHOTON_SPARSE_GRAD")
    os.environ["PHOTON_SPARSE_GRAD"] = "fused"
    try:
        train_game.run(train_game.build_parser().parse_args(args))
    finally:
        if before is None:
            os.environ.pop("PHOTON_SPARSE_GRAD", None)
        else:
            os.environ["PHOTON_SPARSE_GRAD"] = before
    return os.path.join(out_dir, "best_model")


def run_rollout(game: dict, dev) -> dict:
    """(c), second half: a two-replica fleet on phase 6's ``fused`` model
    under closed-loop power-law traffic; midway, a rollout of that fit
    retrained (the same layout, other coefficients), the canary held to
    the host oracle on a host copy of it.  No request may be dropped, every
    response is wholly one model's, the tail is the new model's, nothing
    captures, and traffic and rollout sync nothing but the scorers' one
    wait a batch and a swap (inside :func:`no_stray_syncs`)."""
    from photon_tpu_torch.data.game_io import read_game_avro
    from photon_tpu_torch.game.model_io import load_game_model
    from photon_tpu_torch.serving import (
        ServingFleet,
        TrafficSpec,
        generate_traffic,
        host_score_request,
        request_spec_for_dataset,
        run_closed_loop_outcomes,
    )
    from photon_tpu_torch.telemetry import TelemetrySession

    old, maps = load_game_model(os.path.join(game["run_dirs"]["fused"], "best_model"),
                                device=dev)
    retrained = retrain(game)
    new, _ = load_game_model(retrained, device=dev)
    new_host, _ = load_game_model(retrained, device="cpu")
    data, _ = read_game_avro(game["avro"], {"global": "global", "per_user": "per_user"},
                             ["userId", "itemId"], index_maps=maps)
    items = generate_traffic(data, old, TrafficSpec(
        requests=ROLLOUT_REQUESTS, mean_rows=SERVING_MEAN_ROWS,
        max_rows=SERVING_MAX_BATCH, storm_frac=0.1, seed=1)).items
    session = TelemetrySession("rollout")
    fleet = ServingFleet(old, replicas=2, device=dev,
                         request_spec=request_spec_for_dataset(old, data),
                         max_batch=SERVING_MAX_BATCH, max_delay_s=0.001,
                         telemetry=session).warmup()
    captures = fleet.compilations
    result = {}

    def drive():
        result["outcomes"], result["wall"] = run_closed_loop_outcomes(
            lambda tid: (lambda item: fleet.score(item.request)), items,
            clients=SERVING_CLIENTS)

    driver = threading.Thread(target=drive)
    try:
        with no_stray_syncs():
            driver.start()
            admitted = session.registry.counter("serving.admitted")
            while admitted.value < ROLLOUT_REQUESTS // 3 and driver.is_alive():
                time.sleep(0.001)
            t0 = time.monotonic()
            fleet.rollout(new, probe_oracle=lambda req: host_score_request(new_host, req))
            rollout_s = time.monotonic() - t0
            driver.join(timeout=600)
    finally:
        fleet.close()
    if driver.is_alive():
        raise AssertionError("rollout: the traffic did not finish")
    outcomes = result["outcomes"]
    verdicts = []
    for o in outcomes:
        if o.status != "ok":
            raise AssertionError(f"rollout: a request was dropped ({o.status}: {o.reason})")
        req = o.item.request
        is_old = np.allclose(o.scores, host_score_request(old, req), rtol=0, atol=ROLLOUT_ATOL)
        is_new = np.allclose(o.scores, host_score_request(new, req), rtol=0, atol=ROLLOUT_ATOL)
        if not (is_old or is_new):
            raise AssertionError("rollout: a response matches neither model")
        verdicts.append((o.finished_at_s, "new" if is_new and not is_old else
                         "old" if is_old and not is_new else "both"))
    verdicts.sort()
    counts = {k: sum(v == k for _, v in verdicts) for k in ("old", "new", "both")}
    out = {"requests": len(outcomes), "rollout_s": rollout_s, "wall_s": result["wall"],
           "responses": counts, "captures": captures,
           "captures_after": fleet.compilations,
           "host_syncs": counter_total(session, "serving.host_syncs"),
           "batches": counter_total(session, "serving.batches"),
           "swaps": counter_total(session, "serving.swaps")}
    log(f"  (c) rollout under load: {len(outcomes)} requests, none dropped, responses "
        f"{counts}, rollout {rollout_s * 1e3:.1f} ms, swaps {out['swaps']:.0f}, captures "
        f"{captures} -> {fleet.compilations}, host syncs {out['host_syncs']:.0f} for "
        f"{out['batches']:.0f} batches, no other sync")
    if verdicts[-1][1] == "old" or not counts["old"] or out["swaps"] != 2:
        raise AssertionError("rollout: the stream's tail is not the new model's")
    if fleet.compilations != captures or out["host_syncs"] != out["batches"]:
        raise AssertionError("rollout: captured after warmup, or syncs != batches")
    return out


def run_serving(game: dict, dev) -> dict:
    """Phase 8: (a) score_game, (b) the scorer at bench.py's serving size
    per table dtype, (c) serve_game and a rollout under load."""
    out = {}
    t0 = time.monotonic()
    out["score_game"] = run_score_game(game)
    out["score_game_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["scorer"] = run_serving_fixture(dev)
    out["scorer_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["serve_game"] = run_serve_game(game)
    out["rollout"] = run_rollout(game, dev)
    out["fleet_s"] = time.monotonic() - t0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from photon_tpu_torch.native import build as native_build
    from photon_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t_start = time.monotonic()

    log("phase 1: build kernels")
    _build.build_all()
    log(f"  built {_build.sources()} in {_build.build_seconds:.2f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")
    if native_build.get_lib() is None:
        raise RuntimeError(f"the host library did not build: {native_build.build_error()}")
    log(f"  built the host library ({[os.path.basename(p) for p in native_build.sources()]}: "
        f"the router, the LIBSVM parser, the Avro decoder; {native_build.lib_path()}) in "
        f"{native_build.build_seconds:.2f} s")

    log("phase 2: kernels against their plain versions")
    k1 = check_fused_kernel(dev)
    krs = check_row_scatter(dev)
    k2 = check_position_kernel(dev)
    k_config2 = config2_kernel_timings(k2.pop("config2"), dev)
    log(f"  the main path's layouts and exchange routes, n={N}, k={K}, d={D}:")
    prepared = prepare_batches(dev)
    kv = check_vperm_kernels(prepared, dev)
    log("  K4 and K6 off the main path, random in-range planes:")
    edges = check_chunk_form_edges(dev)
    k3 = check_slab_gather_kernel(prepared, dev)
    kb = check_benes(prepared, dev)

    log(f"phase 3: main path, L-BFGS and TRON at n={N}, k={K}, d={D}")
    main_path = run_main_path(prepared, dev)

    log("phase 4: train CLI on a1a")
    run_cli()

    t5 = time.monotonic()
    log(f"phase 5: the probe kernels, the probe tools and the auto route probe")
    log(f"  PK1-PK7 against their plain versions at E={PROBE_E:,}:")
    pk_rows = check_probe_kernels(dev)
    probe_seconds, probe_launches = run_probe_tools(dev)
    log("  the auto route probe on the main path's batches:")
    auto = run_route_probe(prepared, main_path, dev)
    del prepared
    torch.cuda.empty_cache()
    log(f"  phase 5 took {time.monotonic() - t5:.1f} s")

    game_tmp = tempfile.mkdtemp(prefix="chip_smoke_game_")
    try:
        t6 = time.monotonic()
        log("phase 6: GAME, config 4 (fixed + per-user random effect) through train_game")
        game = run_game(dev, game_tmp)
        game["seconds"] = time.monotonic() - t6
        log(f"  phase 6 took {game['seconds']:.1f} s")

        t7 = time.monotonic()
        log("phase 7: BASELINE.json config 2 (linear elastic net, OWL-QN) through the "
            "train and score CLIs")
        config2 = run_config2()
        config2["seconds"] = time.monotonic() - t7
        log(f"  phase 7 took {config2['seconds']:.1f} s")

        t8 = time.monotonic()
        log("phase 8: serving on the card (score_game, the scorer per table dtype, "
            "serve_game and a rollout under load)")
        kernel_counters = kernel_wrappers()
        for c in kernel_counters:
            c.launches = 0
        serving = run_serving(game, dev)
        serving["kernel_launches"] = {c.__name__: c.launches for c in kernel_counters
                                      if c.launches}
        serving["seconds"] = time.monotonic() - t8
        log(f"  phase 8 launched {serving['kernel_launches'] or 'no hand-written kernel'} "
            "(the serving path has none; the retrain runs K1)")
        log(f"  phase 8 took {serving['seconds']:.1f} s")
    finally:
        shutil.rmtree(game_tmp, ignore_errors=True)

    timings = main_path["timings"]["uniform"]
    zipf = main_path["timings"]["zipf"]
    grad_row = timings["position_reduce[grad]"]
    vt = main_path["vperm_timings"]
    kernels = [
        {
            "name": "fused_sparse", "route": "cuda",
            "source": "photon_tpu_torch/ops/csrc/fused_sparse.cu",
            "replaces": "photon_tpu/ops/pallas_sparse.py:159",
            "launches": main_path["launches"]["fused_sparse"],
            "max_abs_err": k1["max_abs_err"],
            **{key: timings["fused_sparse"][key] for key in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "zipf": zipf["fused_sparse"], "n_hot": timings["fused_sparse"]["n_hot"],
            "game_launches": {name: run["launches"].get("fused_sparse", 0)
                              for name, run in game["runs"].items()},
            "config2_launches": {name: run["launches"].get("fused_sparse", 0)
                                 for name, run in config2["runs"].items()},
            "config2": k_config2["fused_sparse"],
            "card": card,
        },
        {
            # The fused route's Hv scatter, in the JAX package an XLA scatter
            # (no pl.pallas_call).
            "name": "row_scatter", "route": "cuda",
            "source": "photon_tpu_torch/ops/csrc/fused_sparse.cu",
            "replaces": "photon_tpu/core/objective.py:420",
            "launches": main_path["launches"]["row_scatter"],
            "max_abs_err": krs["max_abs_err"],
            **{key: timings["row_scatter"][key] for key in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_f64_ms", "library_atomics_per_s", "n_hot")},
            "zipf": zipf["row_scatter"], "card": card,
        },
        {
            "name": "position_reduce", "route": "cuda",
            "source": "photon_tpu_torch/ops/csrc/position_reduce.cu",
            "replaces": "photon_tpu/ops/pallas_gather.py:635",
            "launches": main_path["launches"]["position_reduce"],
            "max_abs_err": k2["max_abs_err"],
            **{key: grad_row[key] for key in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "forward": timings["position_reduce[forward]"],
            "zipf": {"grad": zipf["position_reduce[grad]"],
                     "forward": zipf["position_reduce[forward]"]},
            "game_launches": {name: run["launches"].get("position_reduce", 0)
                              for name, run in game["runs"].items()},
            "config2_launches": {name: run["launches"].get("position_reduce", 0)
                                 for name, run in config2["runs"].items()},
            "config2": {"grad": k_config2["position_reduce[grad]"],
                        "forward": k_config2["position_reduce[forward]"]},
        },
    ]
    for name, replaces in (("vperm_chunk", "photon_tpu/ops/vperm.py:309"),
                           ("vperm_lane", "photon_tpu/ops/vperm.py:328"),
                           ("vperm_chunk_expand", "photon_tpu/ops/vperm.py:860")):
        # The first per-evaluation launch on the uniform route where it runs
        # the kernel, else on the first route that does; every other launch
        # of the kernel beside it.
        timed = [row for rows in vt.values() for row in rows if row["kernel"] == name]
        entry = {
            "name": name, "route": "cuda",
            "source": "photon_tpu_torch/ops/csrc/vperm.cu", "replaces": replaces,
            "launches": main_path["launches"][name],
            "max_abs_err": kv["max_abs_err"],
            **{key: timed[0][key] for key in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at")},
            "other_launches": timed[1:],
        }
        if name in CHUNK_KERNELS:
            entry.update({key: timed[0][key] for key in
                          ("form", "cluster_blocks", "max_active_clusters", "global_form_ms")})
            entry["form_launches"] = main_path["form_launches"][name]
            entry["edge_shapes"] = [e for e in edges if e["kernel"] == name]
            entry["card"] = card
        kernels.append(entry)
    k3_rows = main_path["slab_gather_timings"]
    kernels.append({
        "name": "slab_gather", "route": "cuda",
        "source": "photon_tpu_torch/ops/csrc/slab_gather.cu",
        "replaces": "photon_tpu/ops/pallas_gather.py:521",
        "launches": main_path["launches"]["slab_gather"],
        "max_abs_err": k3["max_abs_err"],
        **{key: k3_rows["uniform"][key] for key in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library_calls": "torch.gather + multiply",
        "zipf": k3_rows["zipf"],
        "benes_gradient_max_abs_err": kb["gradient_max_abs_err"],
    })
    for name, row in pk_rows.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "photon_tpu_torch/ops/csrc/probes.cu",
            # The probe tools are this slice's path; the training main path
            # (phases 3 and 4) never launches a probe kernel.
            "launches": probe_launches[name],
            "training_path_launches": main_path["probe_launches"][name],
            **{key: value for key, value in row.items() if key != "other_shapes"},
            "other_shapes": row["other_shapes"], "card": card,
        })
    log(f"probe tool seconds: {json.dumps(probe_seconds)}")
    log(f"auto route probe: {json.dumps(auto, default=str)}")
    log(f"main path runs: {json.dumps(main_path['runs'])}")
    log(f"TRON runs: {json.dumps(main_path['tron'])}")
    log(f"GAME runs: {json.dumps({k: {f: v for f, v in r.items() if f != 'history'} for k, r in game['runs'].items()}, default=str)}")
    log(f"GAME ops: {json.dumps(game['ops'])}")
    log(f"GAME Avro reads: {json.dumps(game['avro_read_s'])}")
    log(f"config 2: {json.dumps(config2, default=str)}")
    log(f"serving: {json.dumps(serving, default=str)}")
    if "forced_colored" in main_path:
        log(f"forced colored route: {json.dumps(main_path['forced_colored'])}")
    log(f"total seconds: {time.monotonic() - t_start:.1f}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
