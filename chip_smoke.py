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
   the gradient gate; CS, the compensated scan of the ``cumsum`` reduce, and
   its plain version each held to a float64 prefix (``|hi + lo - c64| <=
   2^-40 C``, C the float64 prefix of |x|) at 2^25 elements and the edge
   lengths 1, 31, 32, 33, 4095, 4096, 4097 and 2^25 + 3, timed beside its
   bound, ``torch.cumsum(x, 0, dtype=torch.float64)`` (the one PyTorch call
   that computes its function, held to the same gate) and the float32
   ``torch.cumsum``; and the bf16 forms on bf16 inputs against their plain
   versions on the same inputs: K1 and the row scatter on the inputs of
   ``BF16_FUSED_CASES`` and ``BF16_ROW_SCATTER_CASES`` with the values
   rounded to bf16, under their f32 forms' gates and against the f32 form
   on the widened values; K3 bit for bit on both draws' layouts, K4-K6 bit
   for bit against the plain version and the library call on the main
   path's routes (K4 and K6 in both forms) and at the edge shapes
   (``check_bf16_forms``).  The main path's layouts and routes build in
   background threads beside the first checks;
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
   AUCs must agree; the first run also writes a ``--profile-dir`` trace of
   each lambda's train phase, each of which must name K1's kernel;
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
   one model's, the tail the new model's, nothing captured;
9. the rest of GAME training through ``train_game`` at config 4's width on
   phase 6's Avro file and split, each run on the card and with
   ``--backend cpu``, every launch count set to 0 just before each run and
   read after, the card held to the host under phase 6's gates: (9a) on
   ``fused`` (K1 must launch), a fixed effect, an elastic-net per-user
   effect (the ``vmapped`` route, lane OWL-QN) and a factored per-item
   effect (rank 4, two alternations), its card model then scored by
   ``score_game`` on the card; (9b) on ``pallas`` with
   ``PHOTON_SOLVE_NEWTON=off``, warm-started from 9a's card model with the
   fixed effect locked (its coefficients 9a's bit for bit; no kernel
   launches, the locked coordinate being the one that reaches one), a
   per-user TRON effect (lane TRON) and an index-map per-item effect; per
   run the routes, solver iterations, host reads and ms of every bin;
   (9c) ``bench.py``'s high-dimension entity leg on its fixture: d = 64,
   256 and 1024 at 384, 160 and 32 entities and d = 256 at 10,000,
   ``RandomEffectCoordinate.train`` on the Newton-CG route
   (``PHOTON_NEWTON_MAX_DIM=0``) and on the vmapped L-BFGS route: every
   bin routed ``newton_cg``, the routes within p99 5e-3 and max 5e-2 of
   each other, solves/s per route and ms per lane Hv beside its bytes
   bound, and at the first three points the card held to the host.
10. fault-tolerant resident training and online learning at config 4's
   width, every launch count set to 0 just before each run and read
   after: (a) ``train_game`` on phase 6's file and split, three descent
   iterations, on ``fused`` and ``pallas``: uninterrupted, checkpointed
   (the descent's host syncs the same as without, the staged bytes and ms
   an iteration beside their PCIe bound, the publish ms), stopped by
   ``--faults preempt:iter=1`` (a subprocess on ``fused``, which must exit
   75 with iteration 0 published; in this process on ``pallas``) and by
   ``descent:kill:iter=2`` in a subprocess, and resumed (``--resume latest``
   / ``auto``): each resumed card model within 1e-6 of the uninterrupted
   card run of its route (metrics 1e-7), K1 launched on the ``fused``
   resumes and K2 on the ``pallas`` one; (b) ``bench.py``'s online fixture
   (2,000 entities, two random effects, linear, 3 iterations a refresh):
   two refresh rounds into a two-replica fleet, the refreshed model
   within 1e-4 of a full retrain on the merged data, no random-effect
   layout rebuilt and rows grown in place, no capture and no allocator
   segment added by either publish; (c) ``online_game`` on phase 6's file
   cut into an initial part and three appends (~10% of the rows each, 5%
   of the users in the appends only) on the card (K1 must launch) and the
   host, the final models held to each other under phase 6's gates.
11. streamed GLM training and scoring on the JAX package's stream scenario
   (``bench.py``'s ``_stream_scale_spec``: 64 LIBSVM part files, k = 16, d =
   2^17, logistic + L2 1.0) cut from 10,000,000 rows to 2^21 (2^25 entries
   a pass), every launch count set to 0 just before each run and read
   after: (a) the whole set on ``autodiff`` and its first 32 files (2^20
   rows) on ``pallas``, a warm pass and two timed passes equal bit for bit
   under the sync debug mode "warn": rows/s, seconds a pass, the consumer's
   wait for parses, the copies' device time and the compute stream's wait
   for them, the host RSS, and an ``autodiff`` pass with the reference's
   window of 2 chunks; (b) on the first 8 files (2^18 rows), ``fm``,
   ``pallas``, ``xchg`` aligned and ``xchg``
   ``cumsum`` against ``autodiff`` under the reference's gates, the layout
   builds of the first pass and none for a fresh source, each route's
   launches (K2, K4, CS), and a 10-iteration streamed L-BFGS on ``pallas``
   and ``xchg`` ``cumsum`` against the resident L-BFGS on the same rows; (c)
   ``train --stream`` on ``pallas`` uninterrupted, preempted (exit 75) and
   resumed to the uninterrupted model exactly, ``score --stream`` over four
   part files against ``score`` on their rows, and ``score_game --stream``
   over phase 6's Avro file in four parts against phase 8's resident
   ``score_game``, each within 1e-6.
12. streamed GAME training, every launch count set to 0 just before each
   fit or run and read after (the path runs no hand-written kernel: each
   must read 0): (a) the JAX package's out-of-core scenario at its
   accelerator size (``bench.py``'s ``_game_bench_fixture`` and
   ``_bench_ooc``: ``make_game_dataset(20_000, 50, 32, 8)``, ~1M rows,
   logistic, two descent iterations, chunks of n // 8 rows), one resident
   and one streamed ``GameEstimator`` each timed on its second fit: rows/s
   and their ratio, the stall and prefetch-overlap seconds, the peak device
   bytes in flight against the ``(PREFETCH_DEPTH + 1)``-chunk bound (a
   gate), ``torch.cuda.max_memory_allocated`` in each fit, host syncs a
   chunk (the warm-up fit under the sync debug mode), the scores' and the
   training AUC's gap to the resident fit, the streamed fit finite (a
   gate); (b) ``train_game --stream-chunks 50000`` on phase 6's Avro file
   and split (5 chunks) on the card and the host, held to each other under
   phase 6's gates and reported beside phase 6's resident agreement; three
   iterations uninterrupted, then killed by ``descent:kill`` before the
   random effect of iteration 1 and resumed with ``--resume auto``: the
   resumed model equal to the uninterrupted one (a gate); and one
   ``--max-resident-mb`` run whose budget turns streaming on.
13. bf16 feature storage and the half-width exchange payload, every count
   (the bf16 forms' apart) set to 0 just before each fit or run and read
   after: (a) right after phase 3, on phase 2's batches converted by
   ``batch_astype`` (no layout or route rebuilt): per draw and route
   (``BF16_ROUTES``: ``fused``, ``pallas``, ``xchg`` with the float32 and
   then the bfloat16 payload, ``benes`` on uniform ids) the value, gradient
   and one Hv with the kernels against the plain versions on the bf16 batch
   (phase 2's gates), then 10 L-BFGS and 5 TRON (Poisson) iterations on the
   f32 and the bf16 batch in turns (``BF16_TURNS``, medians): steps/s, s an
   iteration, ms a ``value_and_grad`` and an Hv, launches; each bf16 fit
   within 2e-2 of the f32 fit, the f32-payload routes' bf16 fits within
   phase 3's route gate of ``fused``; every bf16 form launched; then the
   bf16 forms' times beside their plain versions, a library call, their
   bounds and the f32 form's time in the same call; (b) ``train --dtype
   bfloat16`` on a1a on the card against ``--dtype float32`` (final values
   2e-2, AUC 0.05), ``train --stream --dtype bfloat16`` raising; (c)
   ``train_game --dtype bfloat16`` on phase 6's Avro file and split,
   resident on ``fused`` and ``pallas`` and ``--stream-chunks 50000``, each
   on the card and the host: card and host under phase 6's gates, the AUC
   within 0.05 of the f32 run (phase 6's, phase 12's), the value streams'
   and a chunk's bytes f32 against bf16.  (b) and (c) run after phase 12.
14. the disk tier of streamed GAME training, every launch count set to 0
   just before each fit or run and read after (each must read 0), the
   stores under a temporary directory: (a) phase 12 (a)'s dataset and plan
   spilled to a tile store, its host cache budgeted at three chunks'
   entries so every pass evicts: a warm-up and a timed fit at f32, rows/s
   against phase 12's streamed fit, the stall and prefetch-overlap seconds
   of each tier, the cache's hits, misses and evictions, its peak bytes
   within the budget (or one larger entry; a gate), the store's bytes, the
   write-back seconds a sweep, the device bytes in flight within phase
   12's three-chunk bound (a gate), both fits equal to phase 12's streamed
   fits bit for bit (a gate, or within the spread of those two if they
   differ); then one fit each at the bf16 and int8 tiers, disk bytes
   against f32's, training AUC within ``tile_metric_tol_for`` (a gate), and
   one with ``PHOTON_TILE_COMPRESS=1`` equal to the uncompressed fit (a
   gate); (b) ``train_game --stream-chunks 50000 --spill-dir`` on phase 6's
   Avro file and split on the card and the host under phase 6's gates, the
   card run equal to phase 12 (b)'s card run (a gate); killed by
   ``descent:kill`` and resumed with ``--resume auto`` at f32 and int8,
   equal to the uninterrupted run with the tiles adopted (a gate); one tile
   byte flipped (``CorruptTileError``, a gate) and one tile deleted (rebuilt
   once, equal; a gate) on copies of the killed f32 state; and
   ``--max-host-mb 20`` alone turning streaming and spilling on (a gate).
15. the self-healing subprocess fleet over TCP on phase 6's ``fused``
   model, every launch count set to 0 just before and read after (each
   must read 0): (a) ``serve_game --transport tcp --replica-backend
   subprocess --replicas 2 --supervise`` with phase 8 (c)'s traffic, storm
   and deadline: every request served or shed exactly once (``scores.txt``
   walked against each request's host oracle), the served scores within
   ``PARITY_TOL["f32"]``, each child on ``cuda`` with no capture and no
   allocator segment after warmup and one host sync a batch; requests/s,
   p50 and p99 beside phase 8 (c)'s thread fleet, each child's spawn
   seconds and card memory; (b) a supervised two-child fleet under a
   closed loop, child r0 SIGKILLed a third of the way in: every request
   answered once within the f32 gate, the reroutes counted, the death
   declared, the child respawned, its rejoin probe passed and readmitted
   (the timeline and the seconds from the kill to the rejoin); (c) on that
   fleet under load, a rollout of phase 8's retrained model with the
   parity gate, then ``rollout_with_rebuild`` of it grown by 2200 users
   past the per-user table's capacity: no request lost, every response
   wholly one model's, the tail the grown model's, two new children; (d)
   a 0.6 s partition of r0's links, shorter than the lease: a lease miss
   counted, no death declared, the requests sent into it answered; every
   child of (b)-(d), the two that took (c)'s rollout swap among them,
   holds its warmup's allocator segments.
16. the fleet observability plane, every launch count set to 0 just
   before (b) and read after (a), in this process and, from their stats
   frames, in the children (each must read 0): (b) on phase 15's fleet
   after (d), ``fleet.observe`` at sample_rate 1.0 behind ``fleet.serve()``
   and an ``AsyncScoringClient(observer=)``: untraced and traced TCP turns
   in turns (requests/s, p50, p99), every traced request's trace over the
   client, the router and a child in another process, its critical path
   reconciled (stage sum against total within 1e-6 s, total within the
   request's wall plus 0.05 s), the served scores within
   ``PARITY_TOL["f32"]``, the six stages' median and p90; then one child
   SIGKILLed under traced load, supervised: every request answered once,
   its flight dump collected into the flight directory holding the child's
   ring, its unfinished spans adopted as ``lost``, every trace one tree;
   each child with no capture, no segment and one host sync a batch; (c)
   before the kill, ``/metrics`` and the JSON snapshot from the plane and
   ``python -m photon_tpu_torch.telemetry.live --once`` in a subprocess:
   both children on the plane, each with a p99; (a) a two-replica thread
   fleet on phase 8's model and phase 8 (c)'s traffic under the sync guard,
   three turns each of no observer, an observer at 0.01 and one at 1.0
   (medians of requests/s, p50, p99): at 1.0 one merged trace per admitted
   request, every path reconciled, every shed request's trace with its
   shed event, every served root span with the served version; no
   capture, no segment and one host sync a batch.

The line before the last is a JSON object with one entry per kernel (the
probe kernels' ``launches`` count the probe tools' run; phases 3 and 6 check
that the training paths launch none of them; K1's and K2's
``game_launches`` count phase 6's runs, ``config2_launches`` phase 7's,
``phase9_launches`` phase 9's, ``phase10_launches`` phase 10's, every
kernel's ``phase11_launches`` phase 11's, ``phase12_launches`` phase
12's, ``phase14_launches`` phase 14's, ``phase15_launches`` phase
15's and ``phase16_launches`` phase 16's; CS's ``launches`` count phase 11, its main path; the bf16 forms'
entries, ``*_bf16``, count phase 13 (a), their main path); the last
line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import concurrent.futures
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


def gate_report(name, got, ref, rtol, mag=None, ulp=SUM_ULPS * F32_ULP,
                extra=None) -> float:
    """Hold ``got`` to ``ref`` element by element (see SUM_ULPS above);
    ``mag`` is the per-element sum of term magnitudes, None for a scalar
    held to ``rtol`` alone; ``ulp`` the share of it a term's rounding may
    move; ``extra`` a per-element amount by which the two sides' terms are
    known to differ.  Returns the largest absolute error."""
    got = got.double().cpu().numpy().reshape(-1)
    ref = ref.double().cpu().numpy().reshape(-1)
    atol = (np.zeros_like(ref) if mag is None
            else ulp * mag.double().cpu().numpy().reshape(-1))
    if extra is not None:
        atol = atol + extra.double().cpu().numpy().reshape(-1)
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


# CS, the compensated scan of the xchg route's cumsum reduce, in phase 2: the
# main path's length (a pass of phase 11 moves 2^25 products) and the edges:
# one element, one warp and one more, one tile (4096) and either side of it,
# and 2^25 + 3.  Gate: |hi + lo - c64| <= 2^-40 * C elementwise, c64 the
# float64 prefix and C the float64 prefix of |x|; the kernel and its plain
# version each, and a plain float32 cumsum must fail it at 2^25.
SCAN_E = 1 << 25
SCAN_EDGES = (1, 31, 32, 33, 4095, 4096, 4097, SCAN_E, SCAN_E + 3)
SCAN_GATE = 2.0 ** -40


def scan_input(n: int, seed: int, dev) -> torch.Tensor:
    """Products like the cumsum reduce's (standard normal) on a mean of 1,
    so that the prefix grows to n and a float32 running sum loses bits."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(n, generator=g, device=dev) + 1.0


def scan_gate(name: str, hi, lo, c64, mag) -> float:
    """Largest |hi + lo - c64| / (2^-40 * C); raises above 1."""
    err = (hi.double() + lo.double() - c64).abs()
    ratio = float((err / (SCAN_GATE * mag)).max())
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: |hi + lo - c64| reaches {ratio:.3g} x 2^-40 C")
    return ratio


def check_compensated_scan(dev) -> dict:
    from photon_tpu_torch.ops.vperm import compensated_cumsum, compensated_scan

    worst, edges = 0.0, []
    for i, n in enumerate(SCAN_EDGES):
        x = scan_input(n, 40 + i, dev)
        x64 = x.double()
        c64, mag = torch.cumsum(x64, 0), torch.cumsum(x64.abs(), 0)
        before = compensated_scan.launches
        hi, lo = compensated_scan(x)
        if compensated_scan.launches != before + 1:
            raise AssertionError("compensated_scan did not launch its kernel")
        phi, plo = compensated_cumsum(x)
        kernel = scan_gate(f"CS n={n}", hi, lo, c64, mag)
        plain = scan_gate(f"CS plain n={n}", phi, plo, c64, mag)
        diff = float((hi.double() + lo.double() - phi.double() - plo.double()).abs().max())
        worst = max(worst, diff)
        row = {"n": n, "kernel_gate_ratio": kernel, "plain_gate_ratio": plain,
               "max_abs_err": diff, "lo_nonzero": int((lo != 0).sum())}
        if n >= SCAN_E:
            f32 = torch.cumsum(x, 0)
            row["float32_cumsum_gate_ratio"] = float(
                ((f32.double() - c64).abs() / (SCAN_GATE * mag)).max())
            if row["float32_cumsum_gate_ratio"] <= 1.0:
                raise AssertionError("CS gate cannot tell a plain float32 cumsum apart")
            if row["lo_nonzero"] == 0:
                raise AssertionError("CS: lo is all zero, the compensation is gone")
        edges.append(row)
        log(f"  CS n={n:,}: |hi+lo-c64|/(2^-40 C) kernel {kernel:.3g}, plain {plain:.3g}; "
            f"kernel vs plain max |diff| {diff:.3e}"
            + (f"; float32 cumsum {row['float32_cumsum_gate_ratio']:.3g}"
               if "float32_cumsum_gate_ratio" in row else ""))
        del x, x64, c64, mag, hi, lo, phi, plo
    x = scan_input(SCAN_E, 50, dev)
    # The one PyTorch call that computes CS's function: a float64 prefix,
    # whose hi/lo split is a rounding of it (held to the same gate).
    x64 = x.double()
    c64 = torch.cumsum(x64, 0, dtype=torch.float64)
    lib_hi = c64.float()
    f64_gate = scan_gate("torch.cumsum float64 at 2^25", lib_hi,
                         (c64 - lib_hi.double()).float(), c64,
                         torch.cumsum(x64.abs(), 0))
    del x64, c64, lib_hi
    ms = cuda_ms(lambda: compensated_scan(x))
    plain_ms = cuda_ms(lambda: compensated_cumsum(x), reps=3, warmup=1)
    library_ms = cuda_ms(lambda: torch.cumsum(x, 0, dtype=torch.float64))
    float32_ms = cuda_ms(lambda: torch.cumsum(x, 0))
    # Read 4 bytes and write 8 an element; 8 float adds an element.
    bound_ms, bound_by = bound(12.0 * SCAN_E, 8.0 * SCAN_E)
    del x
    torch.cuda.empty_cache()
    log(f"  CS at 2^25: {ms:.3f} ms (bound {bound_ms:.3f} ms, {bound_by}; "
        f"{bound_ms / ms:.0%} of it), plain {plain_ms:.3f} ms, "
        f"torch.cumsum(x, 0, dtype=torch.float64) {library_ms:.3f} ms (gate ratio "
        f"{f64_gate:.3g}), float32 torch.cumsum {float32_ms:.3f} ms (not CS's function)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_gate_ratio": f64_gate, "float32_cumsum_ms": float32_ms,
            "edges": edges}


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


def gate_fused(tag: str, loss, args, got, ref=None) -> float:
    """K1's (value, grad) against the plain version's (or ``ref``'s) under
    the value and gradient gates; returns the largest absolute error."""
    from photon_tpu_torch.data.batch import gather_dot
    from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad_plain

    v_p, g_p = fused_value_and_grad_plain(loss, *args) if ref is None else ref
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

    worst = worst_bf16 = 0.0
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
        if (loss_name, draw, n, k, d) in BF16_FUSED_CASES:
            worst_bf16 = max(worst_bf16, check_fused_bf16(tag, loss, args))
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
    return {"max_abs_err": worst, "bf16_max_abs_err": worst_bf16}


def check_fused_bf16(tag: str, loss, args) -> float:
    """K1's bf16 form on a case's own inputs with the values rounded to
    bf16: against its plain version on the same bf16 inputs, first and
    second call, and against the f32 form on the widened values, under
    K1's gates."""
    from photon_tpu_torch.ops import fused_sparse as fs

    b16 = [*args[:2], args[2].to(torch.bfloat16), *args[3:]]
    wide = [*args[:2], b16[2].float(), *args[3:]]
    before = fs.fused_value_and_grad.bf16_launches
    first = fs.fused_value_and_grad(loss, *b16)
    second = fs.fused_value_and_grad(loss, *b16)
    f32 = fs.fused_value_and_grad(loss, *wide)
    if fs.fused_value_and_grad.bf16_launches - before != 2:
        raise AssertionError(f"{tag}: the bf16 form did not launch")
    worst = max(gate_fused(f"{tag} bf16 {call}", loss, b16, got)
                for call, got in (("first call", first), ("second call", second)))
    return max(worst, gate_fused(f"{tag} bf16 vs the f32 form on the widened values",
                                 loss, wide, second, f32))


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

    worst = worst_bf16 = 0.0
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
        if r_kind == "random" and (dist, k) in BF16_ROW_SCATTER_CASES:
            # The bf16 form on the same inputs, the values rounded to bf16.
            v16 = vals_t.to(torch.bfloat16)
            ref16 = fs.row_scatter_plain(r_t, ids_t, v16, D)
            mag16 = fs.row_scatter_plain(r_t.abs(), ids_t, v16.abs(), D)
            got16 = [fs.row_scatter(r_t, ids_t, v16, D) for _ in range(2)]
            f32 = fs.row_scatter(r_t, ids_t, v16.float(), D)
            torch.cuda.synchronize()
            for call, got, want in (("first call", got16[0], ref16),
                                    ("second call", got16[1], ref16),
                                    ("vs the f32 form on the widened values", got16[1], f32)):
                worst_bf16 = max(worst_bf16, gate_report(
                    f"{tag} bf16 {call}", got, want, GRAD_RTOL, mag16))
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
    return {"max_abs_err": worst, "bf16_max_abs_err": worst_bf16}


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
    (``force_colored``), so that K5 runs on a path.  The builds run side by
    side in workers (``main`` runs this beside phase 2's first checks), so
    the seconds each reports overlap the others'."""
    from photon_tpu_torch.data.batch import attach_feature_major
    from photon_tpu_torch.ops import vperm
    from photon_tpu_torch.ops.benes import build_benes_aux
    from photon_tpu_torch.ops.slab_reduce import build_aligned_layout

    # Each attach's route build timed in its own thread (the builds overlap,
    # so vperm.route_build_seconds, one global, cannot tell them apart).
    route_seconds: dict = {}
    build_xchg_aux = vperm.build_xchg_aux

    def timed_build(*args, **kwargs):
        t0 = time.monotonic()
        aux = build_xchg_aux(*args, **kwargs)
        route_seconds[threading.get_ident()] = time.monotonic() - t0
        return aux

    def attach(dist: str) -> dict:
        batch = make_batch(dist, seed=0, device=dev)
        t0 = time.monotonic()
        attached = attach_feature_major(batch, aligned_dim=D)
        torch.cuda.synchronize()
        attach_s = time.monotonic() - t0
        route_s = route_seconds[threading.get_ident()]
        route = attached.xchg.route
        log(f"  {dist}: layouts {attach_s - route_s:.2f} s, {describe_route(route)} in "
            f"{route_s:.2f} s")
        return {"batch": batch, "attached": attached, "route_kind": route_kind(route),
                "route_build_s": route_s, "layout_build_s": attach_s - route_s}

    def benes_build(dist: str) -> dict:
        """The benes routes between the draw's row-major stream and the
        slots of its gradient layout (the batch and the layout builder are
        deterministic: the same batch and layout as the attach's)."""
        batch = make_batch(dist, seed=0, device=dev)
        t0 = time.monotonic()
        ids = batch.ids.cpu().numpy()
        vals = batch.vals.cpu().numpy()
        layout = build_aligned_layout(ids, vals, D)
        aux = build_benes_aux(layout, N, K, device=dev)
        torch.cuda.synchronize()
        return {"layout": layout, "ids": ids, "vals": vals, "aux": aux,
                "seconds": time.monotonic() - t0}

    # Each draw's attach and each benes build in a worker of its own: most
    # of each is one thread's native edge coloring or numpy, so they run
    # side by side; their seconds overlap.
    os.environ["PHOTON_SPARSE_GRAD"] = "xchg"
    vperm.build_xchg_aux = timed_build
    try:
        with concurrent.futures.ThreadPoolExecutor(len(DISTS) + len(BENES_DISTS)) as pool:
            attaches = {dist: pool.submit(attach, dist) for dist in DISTS}
            benes = {dist: pool.submit(benes_build, dist) for dist in BENES_DISTS}
            out = {dist: future.result() for dist, future in attaches.items()}
            benes = {dist: future.result() for dist, future in benes.items()}
    finally:
        vperm.build_xchg_aux = build_xchg_aux
        os.environ.pop("PHOTON_SPARSE_GRAD", None)
    for dist, built in benes.items():
        aux, prep = built["aux"], out[dist]
        prep["benes_build_s"] = built["seconds"]
        if aux.n_slots != prep["attached"].al.lo.numel():
            raise AssertionError("the benes route's slots differ from the batch layout's")
        prep["attached"] = prep["attached"]._replace(benes=aux)
        log(f"  {dist}: benes routes (grid {aux.to_slots.a} x {aux.to_slots.b}, "
            f"{aux.n_slots} slots) in {prep['benes_build_s']:.2f} s")
    uniform = out["uniform"]
    layout, ids, vals = (benes["uniform"][key] for key in ("layout", "ids", "vals"))
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


def route_passes(route, dev, dtype=torch.float32) -> list:
    """Every K4/K5/K6 launch of ``route``'s exchange as (kernel, kernel fn,
    plain fn, label, inputs, bytes moved), on random inputs of the launch's
    shape in ``dtype`` (float32, or bfloat16: the 2-byte forms of the
    half-width payload).  Bytes: the moved elements, and the index planes
    (1 + 2 + 1 bytes a slot for K4 and K6, 1 for K5)."""
    from photon_tpu_torch.ops import vperm as vp

    nc, ch = route.nc, route.ch
    e = torch.tensor([], dtype=dtype).element_size()
    x = torch.randn(nc * ch, vp.LANES, device=dev).to(dtype)
    rows = nc * ch * vp.LANES
    chunk = ("vperm_chunk", vp.chunk_pass, vp.chunk_pass_plain)
    if route_kind(route) == "balanced":
        # Per evaluation: K6 (stage A), K4 (stage B, when nc > 1); once, at
        # the attach: K4 (stage A of the value bake).
        passes = []
        if route.k_expand:
            width = vp.LANES // route.k_expand
            dz2d = torch.randn(nc * ch, width, device=dev).to(dtype)
            passes.append(("vperm_chunk_expand", vp.chunk_expand_pass,
                           vp.chunk_expand_pass_plain, "stage A (dz)",
                           (dz2d, route.a1, route.a2, route.a3, nc, ch),
                           (4 + e) * rows + e * nc * ch * width))
        if nc > 1:
            passes.append((*chunk, "stage B",
                           (x, route.b1, route.b2, route.b3, nc, ch), (4 + 2 * e) * rows))
        passes.append((*chunk, "stage A (bake)",
                       (x, route.a1, route.a2, route.a3, nc, ch), (4 + 2 * e) * rows))
        return passes
    passes = [(*chunk, "R1", (x, route.i1, route.i2, route.i3, nc, ch),
               (4 + 2 * e) * rows)]
    if nc > 1:
        passes += [
            ("vperm_lane", vp.lane_pass, vp.lane_pass_plain, "middle",
             (x, route.c), (1 + 2 * e) * rows),
            (*chunk, "R2", (x, route.i4, route.i5, route.i6, nc, ch), (4 + 2 * e) * rows),
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
    """The vperm wrappers' launch counts (total, per form and the 2-byte
    forms'), to restore after launches that only check or time a kernel."""
    from photon_tpu_torch.ops import vperm as vp

    fns = (vp.chunk_pass, vp.lane_pass, vp.chunk_expand_pass)
    saved = [(fn.launches, fn.bf16_launches, dict(getattr(fn, "form_launches", {})))
             for fn in fns]

    def restore():
        for fn, (n, n16, forms) in zip(fns, saved):
            fn.launches, fn.bf16_launches = n, n16
            if forms:
                fn.form_launches = forms
    return restore


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


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


def check_chunk_form_edges(dev, dtype=torch.float32) -> list:
    """Each edge shape with random in-range planes, the source in ``dtype``:
    the form ``chunk_form`` picks and the global form, each bit for bit
    against the plain version."""
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.tools.probe_chunk_forms import random_planes

    restore = save_vperm_counts()
    rows = []
    for kernel, nc, ch, k in chunk_form_edges():
        width = vp.LANES // k if k else vp.LANES
        fn, plain = ((vp.chunk_expand_pass, vp.chunk_expand_pass_plain) if k
                     else (vp.chunk_pass, vp.chunk_pass_plain))
        src, *planes = random_planes(nc, ch, width, seed=ch + k, dev=dev)
        args = (src.to(dtype), *planes, nc, ch)
        form = vp.chunk_form(nc, ch, width)
        ref = plain(*args)
        same = {f[0]: torch.equal(vp.run_chunk_form(fn, f, *args), ref)
                for f in {form, ("global", 0)}}
        torch.cuda.synchronize()
        row = {"kernel": kernel, "nc": nc, "ch": ch, "k": k, "form": form[0],
               "cluster_blocks": form[1], "bitwise": same}
        rows.append(row)
        log(f"  {kernel}[{dtype_name(dtype)}, nc={nc}, ch={ch}" + (f", k={k}" if k else "")
            + f"]: {form[0]} form, CL={form[1]}; bitwise "
            + ", ".join(f"{f} {'ok' if ok else 'FAIL'}" for f, ok in same.items()))
        if not all(same.values()):
            raise AssertionError(f"{kernel} at nc={nc}, ch={ch}, k={k} differs from plain")
    restore()
    return rows


def slab_gather_library_call(w2d, al, vals=None):
    """Two PyTorch calls that compute K3's function: ``torch.gather`` over
    ``w2d`` by the row index ``slab * 8 + lo`` (composed once, here, outside
    any timing), then the multiply by ``vals`` (the layout's by default; a
    bf16 stream widens in the multiply)."""
    from photon_tpu_torch.ops.slab_reduce import TILE_SUBLANES

    vals = al.vals if vals is None else vals
    n_tiles = int(al.slab_of_tile.shape[0])
    tile = torch.arange(n_tiles * TILE_SUBLANES, device=w2d.device) // TILE_SUBLANES
    idx = al.slab_of_tile[tile].long()[:, None] * 8 + al.lo.long()
    return lambda: torch.gather(w2d, 0, idx) * vals


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


# Phase 2's bf16 forms of K1 and RS run on these FUSED_CASES and
# ROW_SCATTER_CASES inputs (random r), the values rounded to bf16: the main
# path's two draws, a second loss, the kernel's loop for rows of more than
# 32 entries, and the GAME fixed effect's batch (every id hot).
BF16_FUSED_CASES = (
    ("logistic", "uniform", N, K, D), ("logistic", "zipf1.3", N, K, D),
    ("poisson", "uniform", N, K, D), ("logistic", "zipf1.3", 1 << 16, 48, D),
    ("logistic", "all_hot", *GAME_FIXED_SHAPE),
)
BF16_ROW_SCATTER_CASES = (("uniform", K), ("zipf", K), ("zipf", 48))


def check_bf16_forms(prepared, dev) -> dict:
    """Phase 2, the bf16 forms of K3-K6 against their plain versions on the
    card, on the same bf16 inputs (K1's and RS's run in their own checks):
    K3 bit for bit (one multiply after an exact widening) on both draws'
    gradient layouts; K4-K6 bit for bit (pure data movement) against the
    plain version and the library call, K4 and K6 in both forms, over the
    main path's routes and at the edge shapes."""
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.ops.slab_reduce import (
        LANES,
        aligned_gather_products,
        aligned_gather_products_plain,
    )

    bf16 = torch.bfloat16
    saved = (aligned_gather_products.launches, aligned_gather_products.bf16_launches)
    restore = save_vperm_counts()
    for dist in DISTS:
        al = prepared[dist]["attached"].al
        w2d = torch.randn(D, device=dev).index_select(0, al.dup_map).view(-1, LANES)
        args = (w2d, al.slab_of_tile, al.lo, al.vals.to(bf16))
        got = aligned_gather_products(*args)
        same = (torch.equal(got, aligned_gather_products_plain(*args))
                and torch.equal(got, slab_gather_library_call(w2d, al, args[3])()))
        log(f"  slab_gather[bf16, {dist}, {tuple(al.lo.shape)}]: bitwise against the "
            f"plain version and torch.gather + multiply {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError("slab_gather's bf16 form differs from its plain version")
    seen = set()
    for name in route_names(prepared):
        route = prepared[name]["attached"].xchg.route
        for kernel, fn, plain, label, args, _ in route_passes(route, dev, bf16):
            got, ref = fn(*args), plain(*args)
            lib = pass_library_call(kernel, args)()
            forms = {"chosen": got}
            if kernel in CHUNK_KERNELS:
                forms["global"] = vp.run_chunk_form(fn, ("global", 0), *args)
            torch.cuda.synchronize()
            same = (all(torch.equal(g, ref) for g in forms.values())
                    and torch.equal(got, lib) and got.dtype == bf16)
            form = chunk_form_of(args) if kernel in CHUNK_KERNELS else None
            log(f"  {kernel}[bf16, {name} {label}, {tuple(args[0].shape)}"
                + (f", {form[0]} form, CL={form[1]}, and the global form" if form else "")
                + f"]: bitwise {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"{kernel}'s 2-byte form differs from its plain version")
            seen.add(kernel)
    missing = {"vperm_chunk", "vperm_lane", "vperm_chunk_expand"} - seen
    if missing:
        raise AssertionError(f"no route of the main path runs {sorted(missing)} in bf16")
    log("  K4 and K6 in bf16 off the main path, random in-range planes:")
    edges = check_chunk_form_edges(dev, bf16)
    restore()
    aligned_gather_products.launches, aligned_gather_products.bf16_launches = saved
    return {"edges": edges}


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


def vperm_timings(prepared, dev, dtype=torch.float32) -> dict:
    """K4, K5 and K6 times at the main path's shapes, for every launch of
    each route's exchange, in their ``dtype`` forms: ``{route name: [row,
    ...]}`` in route_passes' order (the per-evaluation launches first).  K4
    and K6 also carry the form ``chunk_form`` picks, its cluster size and
    ``cudaOccupancyMaxActiveClusters``, and the global form's time, taken in
    turn with the others."""
    from photon_tpu_torch.ops import vperm as vp

    restore = save_vperm_counts()
    out = {}
    for name in route_names(prepared):
        rows = out[name] = []
        for kernel, fn, plain, label, args, nbytes in route_passes(
                prepared[name]["attached"].xchg.route, dev, dtype):
            t_bound, by = bound(nbytes, 0)
            row = {"kernel": kernel, "ms": cuda_ms(lambda: fn(*args))}
            if kernel in CHUNK_KERNELS:
                form = chunk_form_of(args)
                src, *_, nc, ch = args
                row.update({
                    "form": form[0], "cluster_blocks": form[1],
                    "max_active_clusters": (
                        vp.max_active_clusters(ch, src.shape[1], form[1],
                                               bf16=dtype == torch.bfloat16)
                        if form[0] == "cluster" else None),
                    "global_form_ms": cuda_ms(
                        lambda: vp.run_chunk_form(fn, ("global", 0), *args)),
                })
            if dtype != torch.float32:
                # The float32 form on the same values, timed in the same call.
                wide = (args[0].float(), *args[1:])
                row["f32_ms"] = cuda_ms(lambda: fn(*wide))
            row.update({
                "plain_ms": cuda_ms(lambda: plain(*args)),
                "library_ms": cuda_ms(pass_library_call(kernel, args)),
                "bound_ms": t_bound, "bound_by": by,
                "at": f"{name} {label}, {tuple(args[0].shape)} {dtype_name(dtype)}",
            })
            rows.append(row)
            log(f"  {kernel} [{row['at']}]: kernel {row['ms']:.4f} ms"
                + (f" ({row['form']} form, CL={row['cluster_blocks']}, max active "
                   f"clusters {row['max_active_clusters']}; global form "
                   f"{row['global_form_ms']:.4f} ms)" if "form" in row else "")
                + (f", f32 form {row['f32_ms']:.4f} ms" if "f32_ms" in row else "")
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
# The first run also writes a torch.profiler trace of each lambda's train
# phase (--profile-dir), which must name K1's kernel.
PROFILE_K1_KERNEL = "fused_value_grad_kernel"


def profiled_kernels(profile_dir: str) -> dict:
    """Each ``--profile-dir`` trace file's bytes, and whether it names K1's
    CUDA kernel."""
    out = {}
    for name in sorted(os.listdir(profile_dir)):
        with open(os.path.join(profile_dir, name)) as f:
            text = f.read()
        out[name] = {"bytes": len(text), "names_k1": PROFILE_K1_KERNEL in text}
    return out


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
            profile_dir = None
            if (optimizer, backend, route) == CLI_RUNS[0]:
                # The default route on the card is fused: K1 in the trace.
                profile_dir = os.path.join(out_dir, "profile")
                cmd += ["--profile-dir", profile_dir]
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
            if profile_dir is not None:
                traces = profiled_kernels(profile_dir)
                log(f"  --profile-dir: {json.dumps(traces)}")
                if len(traces) != 3 or not all(t["names_k1"] for t in traces.values()):
                    raise AssertionError(f"train CLI --profile-dir: a trace per lambda "
                                         f"naming {PROFILE_K1_KERNEL} expected, got {traces}")
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
    value and gradient (also with the vmapped route's float64 values), its
    Hessian (a float64 scatter), one batched Cholesky step, one line-search
    block of values (also in float64) and the whole Newton fit, each beside
    the time its bytes take at the card's memory rate; then one
    residual-engine update and one offsets pass over the table."""
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
            # The vmapped route's float64 values, beside the Newton route's.
            "value_and_grad_f64_ms": cuda_ms(
                lambda: lane.value_and_grad(w, batch, torch.float64)),
            "hessian_ms": cuda_ms(lambda: lane.hessian_matrix(w, batch)),
            "hessian_bound_ms": (inputs + bsz * d * d * 4) / HBM_BYTES_PER_S * 1e3,
            "cholesky_step_ms": cuda_ms(lambda: newton_step(h, g)),
            # The line search's first block: t = 0 and 8 step sizes.
            "line_values_ms": cuda_ms(lambda: lane.line_values(w, g, ts, batch)),
            "line_values_bound_ms": (inputs + bsz * (2 * d + 9) * 4) / HBM_BYTES_PER_S * 1e3,
            "line_values_f64_ms": cuda_ms(
                lambda: lane.line_values(w, g, ts, batch, torch.float64)),
            "newton_fit_ms": cuda_ms(lambda: run_newton_fit(
                lane, batch, w, cfg=problem.optimizer_config, variance="none"),
                reps=2, warmup=1),
        }
        rows.append(row)
        log(f"    bin {i}: {stats['live_entities']} entities x {r} rows x k={k}: "
            f"value_and_grad {row['value_and_grad_ms']:.3f} ms (bytes bound "
            f"{row['value_and_grad_bound_ms']:.4f}; float64 values "
            f"{row['value_and_grad_f64_ms']:.3f}), hessian {row['hessian_ms']:.3f} ms "
            f"(bound {row['hessian_bound_ms']:.4f}), cholesky step "
            f"{row['cholesky_step_ms']:.3f} ms, line-search block "
            f"{row['line_values_ms']:.3f} ms (bound {row['line_values_bound_ms']:.4f}; "
            f"float64 {row['line_values_f64_ms']:.3f}), "
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
                    f"{b['loop_iterations']} Newton iterations, "
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
    from photon_tpu_torch import ops

    return ops.kernel_wrappers()


def reset_launches(wrappers: list) -> None:
    """Set every kernel wrapper's launch counts (its bf16 form's too) to 0."""
    for wrapper in wrappers:
        wrapper.launches = 0
        if hasattr(wrapper, "bf16_launches"):
            wrapper.bf16_launches = 0


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


# Phase 9: the rest of GAME training at config 4's width, on phase 6's data
# and split.  9a trains an elastic-net per-user effect (the vmapped route,
# lane OWL-QN) and a factored per-item effect on `fused`; 9b warm-starts
# from 9a's card model with the fixed effect locked, per-user TRON (the
# vmapped route, PHOTON_SOLVE_NEWTON=off) and an index-map per-item effect.
# Each on the card and the host, held to phase 6's gates.  9a's lanes run
# with tolerance=0 and max_iters=20 (9b's with max_iters=20), to the
# gradient tolerance or the cap: at the default relative tolerance (1e-7)
# a lane stops ~1e-2 from its optimum, at an iteration that a last-digit
# difference between the card's and the host's arithmetic can move, and
# the factored coordinate's pooled L solve carries such a difference to
# every item.  9a_default is 9a at the spec's defaults (the stopping rule a
# train_game user gets): its metrics are held, its coefficients' card-host
# gap is printed and recorded, not gated.
RUN_9A = [
    "--coordinate", "fixed:type=fixed,shard=global,max_iters=30",
    "--coordinate", "per_user:type=random,shard=per_user,entity=userId,"
                    "reg_type=elastic_net,alpha=0.5,max_iters=20,tolerance=0",
    "--coordinate", "per_item:type=factored_random,shard=per_user,entity=itemId,"
                    "latent_dim=4,latent_iterations=2,max_iters=20",
]
RUN_9A_DEFAULT = [
    "--coordinate", "fixed:type=fixed,shard=global,max_iters=30",
    "--coordinate", "per_user:type=random,shard=per_user,entity=userId,"
                    "reg_type=elastic_net,alpha=0.5",
    "--coordinate", "per_item:type=factored_random,shard=per_user,entity=itemId,"
                    "latent_dim=4,latent_iterations=2",
]
RUN_9B = [
    "--coordinate", "fixed:type=fixed,shard=global,max_iters=30",
    "--coordinate", "per_user:type=random,shard=per_user,entity=userId,optimizer=tron,"
                    "max_iters=20",
    "--coordinate", "per_item:type=random,shard=per_user,entity=itemId,"
                    "projection=index_map,max_iters=20",
]
# (run, PHOTON_SPARSE_GRAD, PHOTON_SOLVE_NEWTON, coordinates, the kernel it
# must launch, coefficients gated).  9b locks the fixed effect, the one
# coordinate whose fit reaches a kernel, so it launches none and sets no
# sparse-gradient route: phase 9 drives K2 nowhere.
PHASE9_RUNS = (("9a", "fused", None, RUN_9A, "fused_value_and_grad", True),
               ("9a_default", "fused", None, RUN_9A_DEFAULT, "fused_value_and_grad",
                False),
               ("9b", None, "off", RUN_9B, None, True))
# 9c: bench.py's high-dimension points (_bench_entities_hidim: dim,
# entities) and d = 256 at 10,000 entities; the first three also on the host.
HIDIM_POINTS = ((64, 384), (256, 160), (1024, 32), (256, 10_000))
HIDIM_HOST_POINTS = 3
HIDIM_P99, HIDIM_MAX = 5e-3, 5e-2
# _hidim_solve_env: the Newton-CG route at every dim, and the vmapped L-BFGS.
HIDIM_ENVS = {
    "newton_cg": {"PHOTON_SOLVE_BINNING": "on", "PHOTON_SOLVE_NEWTON": "on",
                  "PHOTON_SOLVE_NEWTON_CG": "on", "PHOTON_NEWTON_MAX_DIM": "0",
                  "PHOTON_NEWTON_CG_MAX_DIM": "1024"},
    "lbfgs": {"PHOTON_SOLVE_BINNING": "on", "PHOTON_SOLVE_NEWTON": "off",
              "PHOTON_SOLVE_NEWTON_CG": "off"},
}


@contextlib.contextmanager
def env_set(values: dict):
    """``os.environ`` updated with ``values`` (None deletes) inside."""
    before = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def log_solver_records(name: str, history: list) -> None:
    """Per descent iteration and coordinate: the routes the bins took, the
    lane solvers' iterations, host reads and ms a bin."""
    for h in history:
        for coord, rec in h["solver"].items():
            if "bins" not in rec:
                log(f"    {name} iteration {h['iteration']} {coord}: "
                    f"{rec['iterations']} iterations, {rec['evaluations']} evaluations, "
                    f"{rec['host_reads']} host reads, {1e3 * rec['seconds']:.1f} ms")
                continue
            extra = {k: rec[k] for k in ("cg_iters", "cg_entities", "latent_iterations")
                     if rec.get(k)}
            log(f"    {name} iteration {h['iteration']} {coord}: {rec['entities']} "
                f"entities, {rec['converged']} converged, iterations_max "
                f"{rec['iterations_max']}, quarantined {rec['quarantined']} {extra}")
            for b in rec["bins"]:
                log(f"      bin {b['bin']}: {b['entities']} entities x capacity "
                    f"{b['capacity']}, dim {b['solve_dim']}, route {b['route']}, "
                    f"{b['loop_iterations']} solver iterations, {b['host_reads']} host "
                    f"reads, {1e3 * b['seconds']:.2f} ms")


def models_agree(name: str, model, ref, tol: float, gate: bool = True) -> dict:
    """Every coordinate of ``model`` against ``ref``'s within rtol = atol =
    ``tol``; returns the max |diff| per coordinate and, under
    ``"rows_past"``, the rows past the tolerance per coordinate; with
    ``gate`` a coordinate past it raises."""
    errs, bad, past = {}, [], {}
    for coord, m in model.coordinates.items():
        r = ref.coordinate(coord)
        got, want = ((m.coefficients.means, r.coefficients.means)
                     if hasattr(m, "coefficients") else (m.table, r.table))
        errs[coord] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            over = (got - want).abs() > tol + tol * want.abs()
            rows = over.reshape(over.shape[0], -1).any(-1) if over.dim() > 1 else over
            past[coord] = f"{int(rows.sum())} of {rows.numel()}"
            bad.append(f"{coord} (max |diff| {errs[coord]:.3e}, {past[coord]} rows past "
                       "the tolerance)")
    if bad and gate:
        raise AssertionError(f"{name}: coefficients differ from the host run: "
                             f"{'; '.join(bad)}")
    return {**errs, "rows_past": past}


def run_game_rest(game: dict) -> dict:
    """Phase 9a and 9b: ``train_game`` on the card and with ``--backend cpu``,
    every launch count set to 0 just before each run and read after; the
    card held to the host (metrics GAME_METRIC_ATOL every iteration,
    coefficients GAME_COEF_TOL, reported only for 9a_default); 9b's locked
    coordinate bit for bit 9a's; 9a's card model scored through
    ``score_game`` on the card."""
    from photon_tpu_torch.drivers import score_game, train_game
    from photon_tpu_torch.game.model_io import load_game_model

    counters = kernel_wrappers()
    out = {}
    root = os.path.dirname(game["avro"])
    for name, route, newton, coords, kernel, gated in PHASE9_RUNS:
        models = {}
        for backend in ("gpu", "cpu"):
            run_dir = os.path.join(root, f"phase{name}_{backend}")
            args = ["--input", game["avro"], *GAME_BAGS, *coords,
                    "--descent-iterations", str(GAME_DESCENT_ITERATIONS),
                    "--validation-split", "0.2", "--output-dir", run_dir,
                    "--backend", backend]
            if name == "9b":
                args += ["--initial-model", os.path.join(root, "phase9a_gpu", "best_model"),
                         "--locked-coordinates", "fixed"]
            for c in counters:
                c.launches = 0
            with env_set({"PHOTON_SPARSE_GRAD": route, "PHOTON_SOLVE_NEWTON": newton}):
                t0 = time.monotonic()
                summary = train_game.run(train_game.build_parser().parse_args(args))
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            launches = {c.__name__: c.launches for c in counters if c.launches}
            history = summary["sweep"][0]["history"]
            models[backend] = load_game_model(os.path.join(run_dir, "best_model"),
                                              device="cpu")[0]
            out[f"{name}_{backend}"] = {
                "wall_s": wall, "phase_times": summary["phase_times"],
                "descent_iteration_s": [h["seconds"] for h in history],
                "launches": launches, "best_metrics": summary["best_metrics"],
                "history": history,
            }
            log(f"  {name} train_game ({backend}, route {route or 'unset'}, PHOTON_SOLVE_NEWTON "
                f"{newton or 'on'}): {wall:.2f} s, descent iterations "
                f"{[round(h['seconds'], 3) for h in history]} s, metrics "
                f"{summary['best_metrics']}, launches {launches}")
            log_solver_records(f"{name} {backend}", history)
            if backend == "gpu" and (not launches.get(kernel) if kernel
                                     else any(launches.values())):
                raise AssertionError(f"phase {name}: launches {launches}, expected "
                                     f"{kernel or 'none'}")
        card, host = out[f"{name}_gpu"], out[f"{name}_cpu"]
        for h, hc in zip(card["history"], host["history"]):
            for metric, ref in hc["metrics"].items():
                diff = abs(h["metrics"][metric] - ref)
                if diff > GAME_METRIC_ATOL:
                    raise AssertionError(f"phase {name}: {metric} at iteration "
                                         f"{h['iteration']} differs from the host by "
                                         f"{diff:.3e}")
        card["coefficient_max_abs_diff_vs_cpu"] = models_agree(
            f"phase {name}", models["gpu"], models["cpu"], GAME_COEF_TOL, gate=gated)
        log(f"  {name} card vs host: metrics within {GAME_METRIC_ATOL:g}, coefficients "
            f"max |diff| {card['coefficient_max_abs_diff_vs_cpu']} (rtol = atol = "
            f"{GAME_COEF_TOL:g}{'' if gated else ', reported, not gated'})")
        out[f"{name}_models"] = models
    for backend in ("gpu", "cpu"):
        locked = out["9b_models"][backend].coordinate("fixed").coefficients.means
        if not torch.equal(locked, out["9a_models"]["gpu"].coordinate("fixed")
                           .coefficients.means):
            raise AssertionError(f"phase 9b ({backend}): the locked fixed effect moved")
    log("  9b: the locked fixed effect equals 9a's bit for bit (card and host runs)")
    score_dir = os.path.join(root, "phase9a_scores")
    t0 = time.monotonic()
    res = score_game.run(score_game.build_parser().parse_args([
        "--input", game["avro"], "--model", os.path.join(root, "phase9a_gpu", "best_model"),
        *GAME_BAGS, "--evaluators", "AUC,LOGISTIC_LOSS", "--backend", "gpu",
        "--output-dir", score_dir]))
    scores = np.loadtxt(os.path.join(score_dir, "scores.txt"))
    out["9a_score_game"] = {"wall_s": time.monotonic() - t0, "rows": res["num_scored"],
                            "metrics": res["metrics"]}
    log(f"  9a's factored model through score_game on the card: {res['num_scored']:,} "
        f"rows in {out['9a_score_game']['wall_s']:.2f} s, metrics {res['metrics']}")
    if len(scores) != res["num_scored"] or not np.isfinite(scores).all():
        raise AssertionError("phase 9a: score_game's scores are not finite")
    for name, *_ in PHASE9_RUNS:
        del out[f"{name}_models"]
    for run in out.values():
        run.pop("history", None)
    return out


def hidim_point(dim: int, n_entities: int, dev, on_host: bool) -> dict:
    """One 9c point: ``RandomEffectCoordinate.train`` on bench.py's fixture
    on the Newton-CG route and the vmapped L-BFGS route (a warm-up train,
    then the best of two timed), held as bench.py holds them; per route
    solves/s and, on the Newton-CG route, ms per lane Hv beside its bytes
    bound; with ``on_host`` the same trains on the host, the card held to
    them."""
    from photon_tpu_torch.core.objective import RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import ProblemConfig
    from photon_tpu_torch.data.fixtures import make_entities_dataset
    from photon_tpu_torch.game.coordinate import (
        RandomEffectCoordinate,
        RandomEffectCoordinateConfig,
    )

    data = make_entities_dataset(n_entities, rows_mean=6, dim=dim, seed=5)
    config = RandomEffectCoordinateConfig(
        "re0", "re0", problem=ProblemConfig(
            regularization=RegularizationContext("l2", 1.0),
            optimizer_config=OptimizerConfig(max_iterations=50)))
    offsets = np.zeros(data.num_examples, np.float32)
    row = {"dim": dim, "entities": n_entities, "rows": data.num_examples}
    tables = {}
    for path, env in HIDIM_ENVS.items():
        for where in (("card", "host") if on_host else ("card",)):
            with env_set(env):
                coord = RandomEffectCoordinate(data, config, "logistic_regression",
                                               device=dev if where == "card" else "cpu")
                coord.train(offsets)
                best = float("inf")
                for _ in range(2):
                    t0 = time.monotonic()
                    model, stats = coord.train(offsets)
                    model.table.sum().item()
                    best = min(best, time.monotonic() - t0)
            tables[path, where] = model.table.cpu()
            if where == "host":
                continue
            row[f"{path}_routes"] = sorted({b["route"] for b in stats.bins})
            row[f"{path}_s"] = best
            row[f"{path}_solves_per_s"] = n_entities / best
            row[f"{path}_host_reads_per_bin"] = [b["host_reads"] for b in stats.bins]
            row[f"{path}_loop_iterations"] = [b["loop_iterations"] for b in stats.bins]
            if path == "newton_cg":
                row["cg_iters_per_entity"] = stats["cg_iters"] / max(stats["cg_entities"], 1)
                hv_rows = []
                for i, bucket in enumerate(coord.device_data.device_buckets):
                    batch = coord.device_data.batch_for(i, torch.zeros_like(bucket["weight"]))
                    bsz, r, d = batch.x.shape
                    w = torch.zeros(bsz, d, device=dev)
                    v = torch.randn(bsz, d, device=dev)
                    hv = coord.objective.hvp_operator(w, batch)
                    # X v and X^T (D X v): x read twice, v, D and the output.
                    nbytes = 4 * (2 * bsz * r * d + 2 * bsz * d + bsz * r)
                    hv_rows.append({"bin": i, "lanes": bsz, "rows": r,
                                    "ms": cuda_ms(lambda: hv(v)),
                                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
                row["hv"] = hv_rows
    if row["newton_cg_routes"] != ["newton_cg"]:
        raise AssertionError(f"9c d={dim}: bins routed {row['newton_cg_routes']}, "
                             "not all newton_cg")
    diff = np.abs(tables["newton_cg", "card"].numpy() - tables["lbfgs", "card"].numpy())
    row["p99_cross_route_diff"] = float(np.quantile(diff, 0.99))
    row["max_cross_route_diff"] = float(diff.max())
    if row["p99_cross_route_diff"] > HIDIM_P99 or row["max_cross_route_diff"] > HIDIM_MAX:
        raise AssertionError(f"9c d={dim}: newton_cg vs lbfgs p99 "
                             f"{row['p99_cross_route_diff']:.3e}, max "
                             f"{row['max_cross_route_diff']:.3e}")
    if on_host:
        row["card_vs_host_max_abs_diff"] = {}
        for path in HIDIM_ENVS:
            got, want = tables[path, "card"], tables[path, "host"]
            if not torch.allclose(got, want, rtol=GAME_COEF_TOL, atol=GAME_COEF_TOL):
                raise AssertionError(f"9c d={dim} {path}: the card differs from the host "
                                     f"by {float((got - want).abs().max()):.3e}")
            row["card_vs_host_max_abs_diff"][path] = float((got - want).abs().max())
    log(f"  9c d={dim}, {n_entities:,} entities ({row['rows']:,} rows): newton_cg "
        f"{row['newton_cg_solves_per_s']:,.0f} solves/s ({row['newton_cg_s'] * 1e3:.1f} ms, "
        f"{row['cg_iters_per_entity']:.1f} CG steps an entity, host reads a bin "
        f"{row['newton_cg_host_reads_per_bin']}), lbfgs {row['lbfgs_solves_per_s']:,.0f} "
        f"solves/s ({row['lbfgs_s'] * 1e3:.1f} ms, host reads a bin "
        f"{row['lbfgs_host_reads_per_bin']}); routes p99 {row['p99_cross_route_diff']:.2e}, "
        f"max {row['max_cross_route_diff']:.2e}; card vs host "
        f"{row.get('card_vs_host_max_abs_diff', 'not run')}")
    for h in row["hv"]:
        log(f"    lane Hv, bin {h['bin']} ({h['lanes']} lanes x {h['rows']} rows): "
            f"{h['ms']:.4f} ms (bytes bound {h['bound_ms']:.5f})")
    return row


def run_hidim(dev) -> list:
    """Phase 9c: bench.py's high-dimension entity leg on the card."""
    return [hidim_point(dim, n, dev, i < HIDIM_HOST_POINTS)
            for i, (dim, n) in enumerate(HIDIM_POINTS)]


# Phase 10: fault-tolerant resident training and online learning at config
# 4's width, on phase 6's Avro file and split.  (a) train_game runs of three
# descent iterations on `fused` and `pallas`: uninterrupted, checkpointed
# (staging measured), stopped by an injected preemption (exit 75) and by an
# injected kill in a subprocess, and resumed; each resumed card model held
# to the uninterrupted card run of its route.  (b) bench.py's online
# fixture (bench.py:2834-2925): two refresh rounds into a two-replica fleet.
# (c) online_game on phase 6's file cut into an initial part and three
# appends, on the card and the host.
PHASE10_ITERATIONS = 3
# The publish paths' timing runs (plain, async and sync, interleaved): more
# iterations, so each run has several warm ones.
PHASE10_TIMED_ITERATIONS = 8
# The reference's kill/resume bound (tests/test_fault_injection.py:242) on
# coefficients; the validation metrics to 1e-7.
RESUME_ATOL = 1e-6
RESUME_METRIC_ATOL = 1e-7
# PCIe Gen5 x16, one direction (the H100 SXM data sheet's 128 GB/s is both
# directions): the bound of a checkpoint's device-to-host copy.
PCIE_BYTES_PER_S = 64e9
# bench.py's online fixture (bench.py:2864-2881).
ONLINE_ENTITIES = 2000
ONLINE_RETRAIN_TOL = 1e-4
# online_game on phase 6's file: three appends of ~10% of the rows each,
# 5% of the users in the appends only.
ONLINE_PARTS = 3
ONLINE_PART_SHARE = 0.1
ONLINE_LATE_USERS = 0.05


def phase10_args(avro: str, out: str, backend: str = "gpu") -> list:
    args = game_cli_args(avro, out, backend)
    args[args.index("--descent-iterations") + 1] = str(PHASE10_ITERATIONS)
    return args


def run_report_metrics(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "telemetry", "run_report.json")) as f:
        return json.load(f)["metrics"]


def metric(metrics: dict, section: str, name: str, **labels):
    rows = [m for m in metrics[section] if m["name"] == name
            and all(m["labels"].get(k) == v for k, v in labels.items())]
    return rows[0] if rows else None


def resumed_agrees(name: str, run_dir: str, ref_dir: str, summary: dict,
                   ref_summary: dict) -> dict:
    """A resumed card model against the uninterrupted card run: every
    coefficient within RESUME_ATOL (rtol 0), every best metric within
    RESUME_METRIC_ATOL; returns the largest differences."""
    from photon_tpu_torch.game.model_io import load_game_model

    model = load_game_model(os.path.join(run_dir, "best_model"), device="cpu")[0]
    ref = load_game_model(os.path.join(ref_dir, "best_model"), device="cpu")[0]
    coef = {}
    for coord, m in model.coordinates.items():
        r = ref.coordinate(coord)
        got, want = ((m.coefficients.means, r.coefficients.means)
                     if hasattr(m, "coefficients") else (m.table, r.table))
        coef[coord] = float((got - want).abs().max())
    metrics = {k: abs(summary["best_metrics"][k] - v)
               for k, v in ref_summary["best_metrics"].items()}
    log(f"  {name}: coefficients max |diff| {coef}, metrics |diff| {metrics}")
    if (max(coef.values()) > RESUME_ATOL
            or max(metrics.values()) > RESUME_METRIC_ATOL):
        raise AssertionError(f"{name}: the resumed model differs from the uninterrupted "
                             f"run (coefficients {coef}, metrics {metrics})")
    return {"coefficients": coef, "metrics": metrics}


def run_fault_tolerance(game: dict) -> dict:
    """Phase 10 (a): every run's launch counts set to 0 just before it and
    read after; the stopped runs publish a checkpoint, the preempted one
    exits 75, and each resume matches the uninterrupted run of its route."""
    from photon_tpu_torch.drivers import train_game
    from photon_tpu_torch.fault.checkpoint import DescentCheckpointer

    counters = kernel_wrappers()
    root = os.path.join(os.path.dirname(game["avro"]), "phase10")
    out = {"runs": {}}

    def in_process(name, route, *extra, expect_exit=None):
        run_dir = os.path.join(root, name)
        for c in counters:
            c.launches = 0
        with env_set({"PHOTON_SPARSE_GRAD": route}):
            t0 = time.monotonic()
            try:
                train_game.main([*phase10_args(game["avro"], run_dir), *extra])
                code = 0
            except SystemExit as e:
                code = e.code
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        launches = {c.__name__: c.launches for c in counters if c.launches}
        if code != (expect_exit or 0):
            raise AssertionError(f"phase 10 {name}: exit {code}, expected {expect_exit or 0}")
        run = {"wall_s": wall, "launches": launches, "exit": code, "dir": run_dir}
        if code == 0:
            with open(os.path.join(run_dir, "training_summary.json")) as f:
                run["summary"] = json.load(f)
        out["runs"][name] = run
        log(f"  {name} ({route}): exit {code}, {wall:.2f} s, launches {launches}")
        return run

    def subprocess_run(name, route, *extra):
        run_dir = os.path.join(root, name)
        env = dict(os.environ, PHOTON_SPARSE_GRAD=route,
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "photon_tpu_torch.drivers.train_game",
             *phase10_args(game["avro"], run_dir), *extra],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.monotonic() - t0
        out["runs"][name] = {"wall_s": wall, "exit": proc.returncode, "dir": run_dir}
        log(f"  {name} ({route}, a subprocess): exit {proc.returncode}, {wall:.2f} s; "
            f"{proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else ''}")
        return proc

    def published(ckpt, expect):
        chains = [os.path.join(ckpt, d, "cfg-000") for d in os.listdir(ckpt)]
        latest = DescentCheckpointer(chains[0]).latest_path()
        if latest is None or not latest.endswith(expect):
            raise AssertionError(f"phase 10: {ckpt} holds {latest}, expected {expect}")
        DescentCheckpointer.load_path(latest, device="cpu")  # the manifest verifies

    for route in ("fused", "pallas"):
        in_process(f"{route}_plain", route)
    in_process("fused_checkpointed", "fused", "--checkpoint-dir",
               os.path.join(root, "ckpt_full"))
    # A preemption: exit 75 after the last completed iteration's checkpoint
    # is published; then --resume latest completes the run.
    ck1 = os.path.join(root, "ckpt_preempt")
    proc = subprocess_run("fused_preempted", "fused", "--checkpoint-dir", ck1,
                          "--faults", "preempt:iter=1")
    if proc.returncode != 75:
        raise AssertionError(f"phase 10: the preempted run exited {proc.returncode}, "
                             f"not 75: {proc.stderr[-2000:]}")
    published(ck1, "ckpt-000000")
    in_process("fused_resumed_preempt", "fused", "--checkpoint-dir", ck1, "--resume", "latest")
    # A kill at the top of iteration 2, in a process of its own; --resume
    # auto completes it.
    ck2 = os.path.join(root, "ckpt_kill")
    proc = subprocess_run("fused_killed", "fused", "--checkpoint-dir", ck2,
                          "--faults", "descent:kill:iter=2")
    if proc.returncode in (0, 75) or "InjectedKillError" not in proc.stderr:
        raise AssertionError(f"phase 10: the killed run exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    published(ck2, "ckpt-000001")
    in_process("fused_resumed_kill", "fused", "--checkpoint-dir", ck2, "--resume", "auto")
    # On pallas (K2): a preemption in this process, then the resume.
    ck3 = os.path.join(root, "ckpt_pallas")
    in_process("pallas_preempted", "pallas", "--checkpoint-dir", ck3, "--faults",
               "preempt:iter=1", expect_exit=75)
    published(ck3, "ckpt-000000")
    in_process("pallas_resumed", "pallas", "--checkpoint-dir", ck3, "--resume", "latest")
    runs = out["runs"]
    for name, ref in (("fused_checkpointed", "fused_plain"),
                      ("fused_resumed_preempt", "fused_plain"),
                      ("fused_resumed_kill", "fused_plain"),
                      ("pallas_resumed", "pallas_plain")):
        runs[name]["vs_uninterrupted"] = resumed_agrees(
            f"phase 10 {name}", runs[name]["dir"], runs[ref]["dir"],
            runs[name]["summary"], runs[ref]["summary"])
    for name, kernel in (("fused_resumed_preempt", "fused_value_and_grad"),
                         ("fused_resumed_kill", "fused_value_and_grad"),
                         ("pallas_resumed", "position_partial_sums")):
        if not runs[name]["launches"].get(kernel):
            raise AssertionError(f"phase 10 {name}: {kernel} never launched")
    # Staging: the descent's host syncs with checkpointing on and off, the
    # staged bytes and ms an iteration beside the PCIe bound, the publish.
    on, off = (run_report_metrics(runs[n]["dir"]) for n in ("fused_checkpointed",
                                                            "fused_plain"))
    syncs_on = metric(on, "counters", "descent.host_syncs", kind="stats")["value"]
    syncs_off = metric(off, "counters", "descent.host_syncs", kind="stats")["value"]
    saves = metric(on, "counters", "checkpoint.saves")["value"]
    ckpt_syncs_on = metric(on, "counters", "descent.host_syncs", kind="checkpoint")
    ckpt_syncs_off = metric(off, "counters", "descent.host_syncs", kind="checkpoint")
    # The device-to-host bytes (none on the host, where staging clones).
    staged = (metric(on, "counters", "descent.host_transfer_bytes", path="checkpoint")
              or {"value": 0})["value"]
    snapshot_bytes = metric(on, "gauges", "checkpoint.staged_bytes")["value"]
    stage = metric(on, "histograms", "checkpoint.stage_seconds")
    publish = metric(on, "histograms", "checkpoint.publish_seconds")
    loop_side = metric(on, "histograms", "checkpoint.write_seconds")
    per_save = staged / saves
    out["staging"] = {
        "host_syncs_per_iteration": {
            "stats": {"on": syncs_on / PHASE10_ITERATIONS,
                      "off": syncs_off / PHASE10_ITERATIONS},
            "checkpoint": {"on": (ckpt_syncs_on or {"value": 0})["value"]
                           / PHASE10_ITERATIONS,
                           "off": (ckpt_syncs_off or {"value": 0})["value"]
                           / PHASE10_ITERATIONS}},
        "saves": saves, "d2h_bytes_per_iteration": per_save,
        "snapshot_bytes": snapshot_bytes,
        "stage_ms": {k: 1e3 * stage[k] for k in ("mean", "min", "max")},
        "bound_ms": 1e3 * per_save / PCIE_BYTES_PER_S,
        "loop_side_ms": {k: 1e3 * loop_side[k] for k in ("mean", "max")},
        "publish_ms": {k: 1e3 * publish[k] for k in ("mean", "min", "max")},
    }
    log(f"  staging: {json.dumps(out['staging'])}")
    if syncs_on != syncs_off or syncs_on != PHASE10_ITERATIONS:
        raise AssertionError(f"phase 10: the descent synced {syncs_on} times with "
                             f"checkpoints and {syncs_off} without")
    if (ckpt_syncs_off is not None or ckpt_syncs_on is None
            or ckpt_syncs_on["value"] != saves or saves != PHASE10_ITERATIONS):
        raise AssertionError(f"phase 10: {ckpt_syncs_on} checkpoint staging waits for "
                             f"{saves} saves ({ckpt_syncs_off} without checkpoints)")
    out["publish_paths"] = run_publish_paths(in_process, root)
    for run in runs.values():
        run.pop("summary", None)
    return out


def loop_walls(run_dir: str, summary: dict) -> tuple:
    """``(walls, drain)``: each descent iteration's loop wall, s, its
    history seconds (start to the metrics read) plus its checkpoint save on
    the loop (staging, and the publish itself on the sync path); and the
    end's wait for the last publish, s."""
    saves, drain = {}, 0.0
    with open(os.path.join(run_dir, "telemetry", "spans.jsonl")) as f:
        for line in f:
            sp = json.loads(line)
            if sp["name"] == "descent.checkpoint.save":
                saves[sp["attributes"]["iteration"]] = sp["duration_s"]
            elif sp["name"] == "descent.checkpoint.drain":
                drain += sp["duration_s"]
    return ([h["seconds"] + saves.get(h["iteration"], 0.0)
             for h in summary["sweep"][0]["history"]], drain)


def run_publish_paths(in_process, root: str) -> dict:
    """The async and the sync publish path timed beside plain runs, in the
    order plain, async, sync, sync, async, plain, each of
    PHASE10_TIMED_ITERATIONS iterations; both paths' models held to the
    plain run's, and the sync path's staging counted like the async one's."""
    runs = {}
    for name, mode in (("plain_a", None), ("async_a", "on"), ("sync_a", "off"),
                       ("sync_b", "off"), ("async_b", "on"), ("plain_b", None)):
        extra = ["--descent-iterations", str(PHASE10_TIMED_ITERATIONS)]
        if mode is not None:
            extra += ["--checkpoint-dir", os.path.join(root, f"ckpt_{name}"),
                      "--checkpoint-async", mode]
        runs[name] = in_process(f"timed_{name}", "fused", *extra)
    for name in ("async_a", "sync_a"):
        resumed_agrees(f"phase 10 timed_{name}", runs[name]["dir"], runs["plain_a"]["dir"],
                       runs[name]["summary"], runs["plain_a"]["summary"])
    sync = run_report_metrics(runs["sync_a"]["dir"])
    ckpt_syncs = metric(sync, "counters", "descent.host_syncs", kind="checkpoint")
    if ckpt_syncs is None or ckpt_syncs["value"] != PHASE10_TIMED_ITERATIONS:
        raise AssertionError(f"phase 10: the sync path staged {ckpt_syncs} times in "
                             f"{PHASE10_TIMED_ITERATIONS} iterations")
    out = {"iterations": PHASE10_TIMED_ITERATIONS, "loop_wall_s": {}}
    for path in ("plain", "async", "sync"):
        walls, drains = zip(*(loop_walls(runs[f"{path}_{r}"]["dir"],
                                         runs[f"{path}_{r}"]["summary"]) for r in "ab"))
        warm = sorted(w for run in walls for w in run[1:])
        out["loop_wall_s"][path] = {
            "per_run": walls, "warm_median": warm[len(warm) // 2],
            "warm_mean": sum(warm) / len(warm), "final_drain": drains}
    publish = metric(sync, "histograms", "checkpoint.publish_seconds")
    out["sync_publish_ms"] = {k: 1e3 * publish[k] for k in ("mean", "min", "max")}
    log(f"  publish paths: {json.dumps(out)}")
    return out


def phase10_launches(fault: dict, kernel: str) -> dict:
    """A kernel's launches in each phase-10 run."""
    runs = {name: run["launches"].get(kernel, 0)
            for name, run in fault["resume"]["runs"].items() if "launches" in run}
    runs["online_fixture"] = fault["online_fixture"]["launches"].get(kernel, 0)
    for backend in ("gpu", "cpu"):
        runs[f"online_game_{backend}"] = fault["online_game"][backend]["launches"].get(kernel, 0)
    return runs


def run_online_fixture(dev) -> dict:
    """Phase 10 (b): bench.py's online fixture and its in-bench checks."""
    from photon_tpu_torch.core.objective import RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import ProblemConfig
    from photon_tpu_torch.data.synthetic import make_game_data
    from photon_tpu_torch.game.coordinate import (
        FixedEffectCoordinateConfig,
        RandomEffectCoordinateConfig,
    )
    from photon_tpu_torch.game.data import DenseShard, GameDataset
    from photon_tpu_torch.game.estimator import (
        GameEstimator,
        GameOptimizationConfiguration,
    )
    from photon_tpu_torch.game.model import GameModel
    from photon_tpu_torch.online import OnlineLearningService, QueueFeed, RefreshPolicy
    from photon_tpu_torch.serving import ServingFleet, request_spec_for_dataset
    from photon_tpu_torch.telemetry import TelemetrySession

    def problem(lam, iters):
        return ProblemConfig(regularization=RegularizationContext("l2", lam),
                             optimizer_config=OptimizerConfig(max_iterations=iters))

    coords = {"fixed": FixedEffectCoordinateConfig("global", problem(0.01, 5))}
    for i in range(2):
        coords[f"re{i}"] = RandomEffectCoordinateConfig(f"re{i}", f"re{i}", problem(1.0, 4))
    config = GameOptimizationConfiguration(coordinates=coords, descent_iterations=3)
    task = "linear_regression"

    def cut(n_ent, seed, keep=None):
        raw = make_game_data(n_ent, 6, 32, 8, seed=seed, n_random_coords=2)
        sel = slice(None) if keep is None else keep(raw["entity_ids"]["re0"])
        return GameDataset.create(raw["label"][sel], {
            "global": DenseShard(raw["x_fixed"][sel]),
            "re0": DenseShard(raw["x_random"]["re0"][sel]),
            "re1": DenseShard(raw["x_random"]["re1"][sel]),
        }, id_columns={c: raw["entity_ids"][c][sel] for c in ("re0", "re1")})

    n = ONLINE_ENTITIES
    base = cut(n, 0)
    session = TelemetrySession("online")
    counters = kernel_wrappers()
    for c in counters:
        c.launches = 0
    estimator = GameEstimator(task, base, device=dev, telemetry=session)
    model0 = estimator.fit([config])[0].model
    fleet = ServingFleet(model0, replicas=2, device=dev,
                         request_spec=request_spec_for_dataset(model0, base),
                         telemetry=session, table_capacity_factor=2).warmup()
    captures = fleet.compilations
    # Allocator segments each publish adds (every pool: a swap copies into
    # the captured tables and allocates nothing that stays).
    publish_segments = []
    rollout = fleet.rollout

    def counted_rollout(model, **kw):
        torch.cuda.synchronize()
        before = allocator_segments(dev)
        rollout(model, **kw)
        torch.cuda.synchronize()
        publish_segments.append(allocator_segments(dev) - before)

    fleet.rollout = counted_rollout
    feed = QueueFeed()
    service = OnlineLearningService(estimator, config, feed, model=model0, fleet=fleet,
                                    policy=RefreshPolicy(refresh_iterations=3),
                                    telemetry=session)
    grow = int(n * 1.05)
    keep = lambda ids: (ids < n // 10) | (ids >= n)  # noqa: E731
    rounds = []
    try:
        for seed in (1, 2):
            feed.append(cut(grow, seed, keep))
            t0 = time.monotonic()
            result = service.refresh_once()
            torch.cuda.synchronize()
            rounds.append({"latency_s": result.latency_s,
                           "host_s": time.monotonic() - t0,
                           "rows": result.rows, "locked": result.locked,
                           "published": result.published})
            if seed == 1:
                merged1, model1 = estimator.training_data, result.model
        captures_after = fleet.compilations
    finally:
        fleet.close()
    launches = {c.__name__: c.launches for c in counters if c.launches}
    fresh = GameEstimator(task, merged1, device=dev)
    warm = GameModel({name: (m.with_entities(fresh.device_layout(config.coordinates[name])
                                             .dataset.keys)
                             if hasattr(m, "with_entities") else m)
                      for name, m in model0.coordinates.items()}, task)
    full = fresh.fit([config], initial_model=warm)[0].model
    parity = float(np.abs(model1.score(merged1) - full.score(merged1)).max())
    random_rebuilds = counter_total_labeled(session, "estimator.device_data_rebuilds",
                                            kind="random")
    in_place = counter_total(session, "onboard.rows_in_place")
    out = {"rounds": rounds, "parity_vs_full_retrain": parity,
           "random_rebuilds": random_rebuilds, "rows_in_place": in_place,
           "rows_migrated": counter_total(session, "onboard.rows_migrated"),
           "entities_new": counter_total(session, "onboard.entities_new"),
           "captures": [captures, captures_after],
           "segments_added_by_publish": publish_segments,
           "launches": launches}
    log(f"  (b) bench.py's online fixture: {json.dumps(out)}")
    if not all(r["published"] for r in rounds) or parity > ONLINE_RETRAIN_TOL:
        raise AssertionError(f"phase 10 (b): refresh parity {parity} vs a full retrain")
    if random_rebuilds or not in_place:
        raise AssertionError("phase 10 (b): a random-effect layout was rebuilt, or no row "
                             "grew in place")
    if captures_after != captures or len(publish_segments) != 2 or any(publish_segments):
        raise AssertionError(f"phase 10 (b): serving captured ({captures} -> "
                             f"{captures_after}) or allocated segments "
                             f"({publish_segments}) across the publishes")
    return out


def counter_total_labeled(session, name: str, **labels) -> float:
    return sum(m["value"] for m in session.registry.snapshot()["counters"]
               if m["name"] == name and all(m["labels"].get(k) == v
                                            for k, v in labels.items()))


def run_online_game(game: dict) -> dict:
    """Phase 10 (c): ``online_game`` on phase 6's file cut into an initial
    part and ONLINE_PARTS appends, on the card (K1 must launch) and on the
    host; the final models held to each other under phase 6's gates (their
    metrics over the whole file within GAME_METRIC_ATOL, coefficients
    GAME_COEF_TOL)."""
    from photon_tpu_torch.data.game_io import read_game_avro, write_game_avro
    from photon_tpu_torch.drivers import online_game
    from photon_tpu_torch.evaluation.evaluators import get_evaluator
    from photon_tpu_torch.game.data import take_rows
    from photon_tpu_torch.game.model_io import load_game_model

    root = os.path.join(os.path.dirname(game["avro"]), "phase10_online")
    data, maps = read_game_avro(game["avro"], {"global": "global", "per_user": "per_user"},
                                ["userId", "itemId"])
    rng = np.random.default_rng(10)
    users = data.id_columns["userId"]
    uniq = np.unique(users)
    late = np.isin(users, rng.choice(uniq, int(len(uniq) * ONLINE_LATE_USERS), replace=False))
    part = np.where(rng.random(len(users)) < ONLINE_PARTS * ONLINE_PART_SHARE,
                    rng.integers(1, ONLINE_PARTS + 1, len(users)), 0)
    part = np.where(late, rng.integers(1, ONLINE_PARTS + 1, len(users)), part)
    t0 = time.monotonic()
    os.makedirs(root, exist_ok=True)
    write_game_avro(os.path.join(root, "initial.avro"), take_rows(data, np.nonzero(part == 0)[0]),
                    maps)
    out = {"rows": {"initial": int((part == 0).sum()),
                    "appends": [int((part == k).sum()) for k in range(1, ONLINE_PARTS + 1)],
                    "late_users": int(len(np.unique(users[late])))}}
    for backend in ("gpu", "cpu"):
        appends = os.path.join(root, f"appends_{backend}")
        os.makedirs(appends, exist_ok=True)
        for k in range(1, ONLINE_PARTS + 1):
            path = os.path.join(appends, f"part-{k:03d}.avro")
            if backend == "gpu":
                write_game_avro(path, take_rows(data, np.nonzero(part == k)[0]), maps)
            else:
                shutil.copy(os.path.join(root, "appends_gpu", f"part-{k:03d}.avro"), path)
    out["write_s"] = time.monotonic() - t0
    counters = kernel_wrappers()
    models = {}
    for backend in ("gpu", "cpu"):
        run_dir = os.path.join(root, backend)
        args = ["--input", os.path.join(root, "initial.avro"),
                "--append-dir", os.path.join(root, f"appends_{backend}"), *GAME_BAGS,
                "--coordinate", "fixed:type=fixed,shard=global,max_iters=30",
                "--coordinate", "per_user:type=random,shard=per_user,entity=userId,"
                "max_iters=20", "--replicas", "2",
                "--checkpoint-dir", os.path.join(root, f"ckpt_{backend}"),
                "--output-dir", run_dir, "--backend", backend]
        for c in counters:
            c.launches = 0
        # Both on `fused` (the host runs K1's plain version): the two runs
        # differ in the card's arithmetic only, not in the route.
        with env_set({"PHOTON_SPARSE_GRAD": "fused"}):
            t0 = time.monotonic()
            summary = online_game.run(online_game.build_parser().parse_args(args))
            wall = time.monotonic() - t0
        launches = {c.__name__: c.launches for c in counters if c.launches}
        models[backend] = load_game_model(summary["model_dir"], device="cpu")[0]
        out[backend] = {"wall_s": wall, "launches": launches,
                        **{k: summary[k] for k in ("rounds", "rows_ingested", "published",
                                                   "refresh_latency_s", "compiled_programs",
                                                   "phase_times", "locked_per_round")}}
        log(f"  (c) online_game ({backend}): {wall:.2f} s, {summary['rounds']} rounds, "
            f"{summary['rows_ingested']} rows, refresh latency "
            f"{summary['refresh_latency_s']}, launches {launches}")
        # The three parts wait in the directory together: one round drains
        # them all.
        if (summary["rounds"] != 1 or summary["published"] != 1
                or summary["rows_ingested"] != sum(out["rows"]["appends"])):
            raise AssertionError(f"phase 10 (c) {backend}: {summary['rounds']} rounds, "
                                 f"{summary['rows_ingested']} rows ingested")
    if not out["gpu"]["launches"].get("fused_value_and_grad"):
        raise AssertionError("phase 10 (c): K1 never launched in online_game on the card")
    metrics = {}
    for name in ("AUC", "LOGISTIC_LOSS"):
        ev = get_evaluator(name)
        vals = [float(ev.fn(torch.as_tensor(models[b].score(data)), torch.as_tensor(data.label),
                            torch.as_tensor(data.weight))) for b in ("gpu", "cpu")]
        metrics[name] = vals
        if abs(vals[0] - vals[1]) > GAME_METRIC_ATOL:
            raise AssertionError(f"phase 10 (c): {name} card {vals[0]} host {vals[1]}")
    out["metrics"] = metrics
    out["coefficients_vs_cpu"] = models_agree("phase 10 (c)", models["gpu"], models["cpu"],
                                              GAME_COEF_TOL)
    log(f"  (c) card vs host: metrics {metrics}, coefficients max |diff| "
        f"{out['coefficients_vs_cpu']}")
    return out


# Phase 11: streamed GLM training and scoring on the JAX package's stream
# scenario (bench.py:3364-3375 _stream_scale_spec with the generator
# _generate_stream_files, bench.py:3154): 64 LIBSVM part files, k = 16 ids a
# row (one per stride of d / k), d = 2^17, logistic + L2 1.0.  Rows are cut
# from the scenario's 10,000,000 to 2^21, so that one pass holds 2^25
# entries, the headline's, and the phase fits the time limit.  Two more cuts
# for the time limit (phase 11 took 193 s on an H100 with 16 files in (b)
# and (c) and 64 on (a)'s `pallas`): (a)'s `pallas` passes run on the first
# STREAM_RATE_PALLAS_FILES files (2^20 rows; each file's cached layout moves
# 8x its entries), and (b) and (c) on the first STREAM_KERNEL_FILES files
# (2^18 rows).
STREAM_ROWS = 1 << 21
STREAM_FILES, STREAM_K, STREAM_D = 64, 16, 1 << 17
STREAM_RATE_PALLAS_FILES = 32
STREAM_KERNEL_FILES = 8
STREAM_ITERATIONS = 10
STREAM_RSS_CAP = 4 << 30  # the scenario's host-memory bar (bench.py --stream-scale)
# (b)'s gates, the reference's (tests/test_stream_kernels.py): the value to
# rtol 2e-5, the gradient to rtol 2e-4 and atol 2e-4 x max |g|; L-BFGS
# against the resident fit, tests/test_streaming.py:272-275's value rtol 1e-4
# and coefficients rtol 5e-2 / atol 5e-3; (c)'s scores within 1e-6.
STREAM_VALUE_RTOL = 2e-5
STREAM_GRAD_RTOL = 2e-4
STREAM_FIT_RTOL = 1e-4
STREAM_COEF_RTOL, STREAM_COEF_ATOL = 5e-2, 5e-3
STREAM_SCORE_ATOL = 1e-6
# (b)'s routes: (name, PHOTON_SPARSE_GRAD, PHOTON_XCHG_REDUCE, the kernels it
# must launch).  Streamed chunks carry no baked values, so the balanced
# exchange moves the product stream through K4 (K6 expands baked dz only)
# and K5 runs only on a colored route.
STREAM_ROUTES = (
    ("fm", "fm", None, ()),
    ("pallas", "pallas", None, ("position_partial_sums",)),
    ("xchg_aligned", "xchg", "aligned", ("chunk_pass", "position_partial_sums")),
    ("xchg_cumsum", "xchg", "cumsum", ("chunk_pass", "compensated_scan")),
)


def write_stream_part(job) -> str:
    """One part file, each row formatted by one %-format (a process-pool
    job of :func:`write_stream_parts`)."""
    path, label, ids, vals = job
    k = ids.shape[1]
    cols = np.empty((ids.shape[0], 1 + 2 * k), object)
    cols[:, 0] = label.tolist()
    cols[:, 1::2] = ids.tolist()
    cols[:, 2::2] = vals.astype(np.float64).tolist()
    fmt = "%d" + " %d:%.4f" * k
    with open(path, "w") as f:
        f.write("\n".join(fmt % tuple(r) for r in cols.tolist()))
        f.write("\n")
    return path


def write_stream_parts(out_dir: str, total_rows: int, n_files: int, k: int,
                       d: int, seed: int = 0) -> list:
    """bench.py's _generate_stream_files draw for draw (ids one per stride,
    standard-normal values, labels from a per-stride w_true, in its order),
    the files formatted on a pool of processes instead of its np.char
    loop."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    os.makedirs(out_dir, exist_ok=True)
    rows_per_file = -(-total_rows // n_files)
    stride = d // k
    rng = np.random.default_rng(seed)
    w_true = (rng.standard_normal(k) * 0.5).astype(np.float32)
    jobs = []
    for fi in range(n_files):
        n = min(rows_per_file, total_rows - fi * rows_per_file)
        if n <= 0:
            break
        ids = (np.arange(k, dtype=np.int64)[None, :] * stride
               + rng.integers(0, stride, size=(n, k)) + 1)
        vals = rng.standard_normal((n, k)).astype(np.float32)
        margin = vals @ w_true
        label = np.where(rng.random(n) < 1.0 / (1.0 + np.exp(-margin)), 1, -1)
        jobs.append((os.path.join(out_dir, f"part-{fi:05d}.libsvm"), label, ids, vals))
    # Spawned, not forked: this process holds a CUDA context and threads.
    with ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(write_stream_part, jobs))


def sync_warnings(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the synchronizing calls the mode reported."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message)[:120] for w in caught
                 if "synchroniz" in str(w.message)]


def stream_pass(source, objective, w):
    """One streamed evaluation: seconds (to the card's last kernel), value,
    gradient, the pass's StreamStats and the sync warnings."""
    t0 = time.monotonic()
    (v, g), syncs = sync_warnings(lambda: objective.value_and_grad(w))
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    stats = source.last_pass.resolve()
    return seconds, v, g, stats, syncs


def run_stream_rate(files: list, dev) -> dict:
    """(a): the whole scenario on ``autodiff`` (the default), the first
    STREAM_RATE_PALLAS_FILES files on ``pallas``: one warm pass, then two
    timed passes, equal bit for bit; then one ``autodiff`` pass with the
    reference's window of 2 chunks (``PHOTON_STREAM_PREFETCH=2``) beside the
    port's default."""
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.data import stream_layouts as sl
    from photon_tpu_torch.data.streaming import LibsvmFileSource, StreamingObjective

    out = {}
    counters = kernel_wrappers()
    for route, route_files in (("autodiff", files),
                               ("pallas", files[:STREAM_RATE_PALLAS_FILES])):
        with env_set({"PHOTON_SPARSE_GRAD": route}):
            for c in counters:
                c.launches = 0
            builds0 = dict(sl.build_stats)
            source = LibsvmFileSource(route_files, device=dev)
            objective = StreamingObjective(
                GlmObjective.create("logistic", RegularizationContext("l2", 1.0)),
                source.chunk_iter_factory)
            w = torch.full((source.dim,), 0.01, device=dev)
            warm_s, *_ = stream_pass(source, objective, w)
            passes = [stream_pass(source, objective, w) for _ in range(2)]
        (s1, v1, g1, st1, sy1), (s2, v2, g2, st2, sy2) = passes
        if not (torch.equal(v1, v2) and torch.equal(g1, g2)):
            raise AssertionError(f"phase 11 (a) {route}: two passes differ")
        if not torch.isfinite(g1).all():
            raise AssertionError(f"phase 11 (a) {route}: a non-finite gradient")
        rss_growth = max(st.rss_peak_bytes - st.rss_start_bytes for st in (st1, st2))
        if rss_growth > STREAM_RSS_CAP:
            raise AssertionError(f"phase 11 (a) {route}: a pass grew the host RSS by "
                                 f"{rss_growth / 2**30:.2f} GiB")
        row = {
            "rows": source.num_examples, "files": len(route_files), "last_kernel":
            objective.last_kernel, "warm_pass_s": warm_s,
            "pass_s": [s1, s2], "rows_per_s": [source.num_examples / s for s in (s1, s2)],
            "parse_wait_s": [st1.parse_wait_s, st2.parse_wait_s],
            "copy_ms": [st1.copy_ms, st2.copy_ms],
            "copy_stall_ms": [st1.copy_stall_ms, st2.copy_stall_ms],
            "copy_bytes": st1.copy_bytes, "rss_peak_bytes": max(st1.rss_peak_bytes,
                                                                st2.rss_peak_bytes),
            "rss_growth_bytes": rss_growth, "sync_warnings": sy1 + sy2,
            "layout_builds": sl.build_stats["builds"] - builds0["builds"],
            "layout_build_s": sl.build_stats["seconds"] - builds0["seconds"],
            "launches": {c.__name__: c.launches for c in counters if c.launches},
        }
        if route != objective.last_kernel:
            raise AssertionError(f"phase 11 (a): {route} ran {objective.last_kernel}")
        if route == "pallas" and not row["launches"].get("position_partial_sums"):
            raise AssertionError("phase 11 (a): K2 never launched on pallas")
        out[route] = row
        log(f"  (a) {route}: {source.num_examples:,} rows, passes {s1:.3f} / {s2:.3f} s "
            f"({row['rows_per_s'][0]:,.0f} / {row['rows_per_s'][1]:,.0f} rows/s; warm "
            f"{warm_s:.3f} s with {row['layout_builds']} layout builds in "
            f"{row['layout_build_s']:.2f} s host), parse wait {st1.parse_wait_s:.3f} / "
            f"{st2.parse_wait_s:.3f} s, copies {st1.copy_ms:.1f} / {st2.copy_ms:.1f} ms "
            f"({st1.copy_bytes / 1e6:.0f} MB a pass), compute waited on copies "
            f"{st1.copy_stall_ms:.1f} / {st2.copy_stall_ms:.1f} ms, RSS peak "
            f"{row['rss_peak_bytes'] / 2**30:.2f} GiB (+{rss_growth / 2**30:.2f} GiB), "
            f"sync warnings {len(row['sync_warnings'])}, launches {row['launches']}")
        if route == "autodiff":
            with env_set({"PHOTON_SPARSE_GRAD": route, "PHOTON_STREAM_PREFETCH": "2"}):
                s2w, *_ = stream_pass(source, objective, w)
            row["window2_pass_s"] = s2w
            log(f"  (a) autodiff with the reference's window of 2 chunks: {s2w:.3f} s a pass")
        del source, objective, passes, g1, g2
    return out


def run_stream_kernels(files: list, cache_dir: str, dev) -> dict:
    """(b): each route's streamed pass against ``autodiff``'s, the layout
    cache (built on the first pass, loaded by a fresh source), each route's
    launches, then a streamed L-BFGS on ``pallas`` and ``xchg`` cumsum
    against the resident fit on the same rows."""
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig, lbfgs
    from photon_tpu_torch.data import stream_layouts as sl
    from photon_tpu_torch.data.batch import SparseBatch
    from photon_tpu_torch.data.streaming import (
        LibsvmFileSource,
        StreamingObjective,
        streaming_lbfgs,
    )

    counters = kernel_wrappers()
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 1.0))
    out = {"routes": {}}

    def objective_on(source):
        return StreamingObjective(obj, source.chunk_iter_factory)

    with env_set({"PHOTON_SPARSE_GRAD": "autodiff"}):
        ref_source = LibsvmFileSource(files, device=dev)
        rng = np.random.default_rng(11)
        w = torch.as_tensor((rng.standard_normal(ref_source.dim) * 0.05).astype(np.float32),
                            device=dev)
        _, v_ref, g_ref, _, _ = stream_pass(ref_source, objective_on(ref_source), w)
    scale = max(float(g_ref.abs().max()), 1.0)
    for name, route, mode, must in STREAM_ROUTES:
        with env_set({"PHOTON_SPARSE_GRAD": route, "PHOTON_XCHG_REDUCE": mode,
                      "PHOTON_STREAM_LAYOUT_CACHE": cache_dir}):
            for c in counters:
                c.launches = 0
            builds0 = dict(sl.build_stats)
            source = LibsvmFileSource(files, device=dev)
            objective = objective_on(source)
            first_s, v, g, _, _ = stream_pass(source, objective, w)
            built = sl.build_stats["builds"] - builds0["builds"]
            build_s = sl.build_stats["seconds"] - builds0["seconds"]
            launches = {c.__name__: c.launches for c in counters if c.launches}
            builds1 = dict(sl.build_stats)
            fresh = LibsvmFileSource(files, device=dev)  # as after a restart
            again_s, v2, g2, stats, _ = stream_pass(fresh, objective_on(fresh), w)
            rebuilt = sl.build_stats["builds"] - builds1["builds"]
            loaded = sl.build_stats["loads"] - builds1["loads"]
        value_err = abs(float(v) - float(v_ref)) / abs(float(v_ref))
        grad_err = float(((g - g_ref).abs() - STREAM_GRAD_RTOL * g_ref.abs()).max())
        row = {"last_kernel": objective.last_kernel, "first_pass_s": first_s,
               "layout_builds": built, "layout_build_s": build_s,
               "cached_pass_s": again_s, "fresh_source_builds": rebuilt,
               "fresh_source_loads": loaded, "value_rel_err": value_err,
               "grad_excess_over_rtol": grad_err, "grad_scale": scale,
               "launches": launches, "fresh_equal": bool(torch.equal(g, g2))}
        out["routes"][name] = row
        log(f"  (b) {name}: ran {objective.last_kernel}, first pass {first_s:.3f} s "
            f"({built} builds, {build_s:.2f} s host), a fresh source {again_s:.3f} s "
            f"({rebuilt} builds, {loaded} loads), value rel err {value_err:.2e}, "
            f"gradient excess over rtol {grad_err:.2e} (atol "
            f"{STREAM_GRAD_RTOL * scale:.2e}), launches {launches}")
        if objective.last_kernel != route:
            raise AssertionError(f"phase 11 (b) {name}: ran {objective.last_kernel}")
        if value_err > STREAM_VALUE_RTOL or grad_err > STREAM_GRAD_RTOL * scale:
            raise AssertionError(f"phase 11 (b) {name}: disagrees with autodiff")
        if route != "fm" and (built != len(files) or rebuilt or loaded != len(files)):
            raise AssertionError(f"phase 11 (b) {name}: the layout cache was not used")
        for kernel in must:
            if not launches.get(kernel):
                raise AssertionError(f"phase 11 (b) {name}: {kernel} never launched")
        if launches.get("fused_value_and_grad"):
            raise AssertionError(f"phase 11 (b) {name}: K1 launched on a streamed pass")
        del source, fresh, objective, g, g2
    # The streamed L-BFGS against the resident one on the same rows.
    config = OptimizerConfig(max_iterations=STREAM_ITERATIONS)
    with env_set({"PHOTON_SPARSE_GRAD": "autodiff"}):
        parts = [ref_source.load_host_chunk(i) for i in range(len(files))]
        flat = SparseBatch(*(torch.cat(cols).to(dev) for cols in zip(*(b[:5] for b in parts))))
        del parts
        t0 = time.monotonic()
        resident = lbfgs(lambda x: obj.value_and_grad(x, flat), torch.zeros_like(w), config)
        resident_s = time.monotonic() - t0
        del flat
    out["resident"] = {"value": resident.value, "iterations": resident.iterations,
                       "seconds": resident_s}
    out["lbfgs"] = {}
    for name, route, mode in (("pallas", "pallas", None), ("xchg_cumsum", "xchg", "cumsum")):
        with env_set({"PHOTON_SPARSE_GRAD": route, "PHOTON_XCHG_REDUCE": mode,
                      "PHOTON_STREAM_LAYOUT_CACHE": cache_dir}):
            for c in counters:
                c.launches = 0
            source = LibsvmFileSource(files, device=dev)
            t0 = time.monotonic()
            fit = streaming_lbfgs(objective_on(source), torch.zeros_like(w), config)
            seconds = time.monotonic() - t0
        rel = abs(fit.value - resident.value) / abs(resident.value)
        coef = (fit.w - resident.w).abs() - STREAM_COEF_RTOL * resident.w.abs()
        row = {"value": fit.value, "iterations": fit.iterations, "seconds": seconds,
               "value_rel_err": rel, "coef_excess_over_rtol": float(coef.max()),
               "launches": {c.__name__: c.launches for c in counters if c.launches}}
        out["lbfgs"][name] = row
        log(f"  (b) streamed L-BFGS {name}: {fit.iterations} iterations in {seconds:.2f} s, "
            f"value {fit.value:.8g} vs resident {resident.value:.8g} (rel {rel:.2e}), "
            f"coefficient excess over rtol {row['coef_excess_over_rtol']:.2e}, launches "
            f"{row['launches']}")
        if rel > STREAM_FIT_RTOL or row["coef_excess_over_rtol"] > STREAM_COEF_ATOL:
            raise AssertionError(f"phase 11 (b) L-BFGS {name}: off the resident fit")
    log(f"  (b) resident L-BFGS: {resident.iterations} iterations in {resident_s:.2f} s")
    return out


def stream_cli_args(parts_glob: str, out: str, *extra) -> list:
    return ["--input", parts_glob, "--stream", "--reg-weights", "1.0",
            "--max-iterations", str(STREAM_ITERATIONS), "--output-dir", out, *extra]


def run_stream_cli(files: list, root: str, cache_dir: str, game: dict) -> dict:
    """(c): ``train --stream`` uninterrupted, preempted (exit 75) and resumed
    on ``pallas``; ``score --stream`` against ``score``; ``score_game
    --stream`` over phase 6's Avro file in four parts against phase 8's
    resident ``score_game`` of phase 6's model."""
    from photon_tpu_torch.data.game_io import read_game_avro, write_game_avro
    from photon_tpu_torch.drivers import score, score_game, train
    from photon_tpu_torch.fault.preemption import PREEMPTED_EXIT_CODE, clear_preemption
    from photon_tpu_torch.game.data import take_rows

    counters = kernel_wrappers()
    parts = os.path.join(root, "kernel_parts")
    os.makedirs(parts, exist_ok=True)
    for f in files:
        os.symlink(f, os.path.join(parts, os.path.basename(f)))
    glob = os.path.join(parts, "part-*.libsvm")
    out = {"runs": {}}
    ckpt = os.path.join(root, "ck")
    runs = (("uninterrupted", ()), ("preempted", ("--checkpoint-dir", ckpt,
                                                  "--checkpoint-every", "1",
                                                  "--faults", "preempt:iter=3")),
            ("resumed", ("--checkpoint-dir", ckpt, "--resume", "latest")))
    with env_set({"PHOTON_SPARSE_GRAD": "pallas", "PHOTON_STREAM_LAYOUT_CACHE": cache_dir}):
        for name, extra in runs:
            for c in counters:
                c.launches = 0
            t0 = time.monotonic()
            try:
                train.main(stream_cli_args(glob, os.path.join(root, name), *extra))
                code = 0
            except SystemExit as e:
                code = e.code
            finally:
                clear_preemption()
            run = {"exit": code, "wall_s": time.monotonic() - t0,
                   "launches": {c.__name__: c.launches for c in counters if c.launches}}
            if code == 0:
                with open(os.path.join(root, name, "training_summary.json")) as f:
                    summary = json.load(f)
                run.update(final_value=summary["sweep"][0]["final_value"],
                           iterations=summary["sweep"][0]["iterations"],
                           last_kernel=summary["sweep"][0]["last_kernel"])
            out["runs"][name] = run
            log(f"  (c) train --stream {name}: exit {code} in {run['wall_s']:.2f} s, "
                f"{ {k: v for k, v in run.items() if k not in ('exit', 'wall_s')} }")
    if out["runs"]["preempted"]["exit"] != PREEMPTED_EXIT_CODE:
        raise AssertionError("phase 11 (c): the preempted run did not exit 75")
    if not out["runs"]["uninterrupted"]["launches"].get("position_partial_sums"):
        raise AssertionError("phase 11 (c): K2 never launched in train --stream")
    models = [read_glm_means(os.path.join(root, name)) for name in ("uninterrupted",
                                                                     "resumed")]
    out["resumed_max_abs_diff"] = float(np.abs(models[0] - models[1]).max())
    log(f"  (c) resumed against uninterrupted: max |diff| {out['resumed_max_abs_diff']}")
    if out["resumed_max_abs_diff"] != 0.0:
        raise AssertionError("phase 11 (c): the resumed model differs")
    # score --stream over four part files against score over their rows.
    model = os.path.join(root, "uninterrupted", "best_model.avro")
    joined = os.path.join(root, "four.libsvm")
    with open(joined, "w") as f:
        for path in files[:4]:
            with open(path) as part:
                f.write(part.read())
    four = os.path.join(root, "four_parts")
    os.makedirs(four, exist_ok=True)
    for path in files[:4]:
        os.symlink(path, os.path.join(four, os.path.basename(path)))
    scored = {}
    for name, spec, extra in (("resident", joined, ()), ("streamed", four, ("--stream",))):
        t0 = time.monotonic()
        res = score.run(score.build_parser().parse_args([
            "--input", spec, "--model", model, "--evaluators", "AUC",
            "--output-dir", os.path.join(root, f"score_{name}"), *extra]))
        scored[name] = np.loadtxt(os.path.join(root, f"score_{name}", "scores.txt"))
        out[f"score_{name}"] = {"rows": res["num_scored"], "metrics": res["metrics"],
                                "wall_s": time.monotonic() - t0}
    out["score_max_abs_diff"] = float(np.abs(scored["resident"] - scored["streamed"]).max())
    log(f"  (c) score --stream against score: {out['score_streamed']} vs "
        f"{out['score_resident']}, max |diff| {out['score_max_abs_diff']:.2e}")
    if not out["score_max_abs_diff"] <= STREAM_SCORE_ATOL:
        raise AssertionError("phase 11 (c): score --stream differs from score")
    # score_game --stream: phase 6's file in four parts.
    data, maps = read_game_avro(game["avro"], {"global": "global", "per_user": "per_user"},
                                ["userId", "itemId"])
    game_parts = os.path.join(root, "game_parts")
    os.makedirs(game_parts, exist_ok=True)
    n = data.num_examples
    for i in range(4):
        write_game_avro(os.path.join(game_parts, f"part-{i:05d}.avro"),
                        take_rows(data, np.arange(i * n // 4, (i + 1) * n // 4)), maps)
    del data
    t0 = time.monotonic()
    res = score_game.run(score_game.build_parser().parse_args([
        "--input", game_parts, "--model",
        os.path.join(game["run_dirs"]["fused"], "best_model"), *GAME_BAGS, "--stream",
        "--evaluators", "AUC", "--output-dir", os.path.join(root, "score_game")]))
    streamed = np.loadtxt(os.path.join(root, "score_game", "scores.txt"))
    resident = np.loadtxt(os.path.join(os.path.dirname(game["avro"]), "score_gpu",
                                       "scores.txt"))
    diff = float(np.abs(streamed - resident).max())
    out["score_game"] = {"rows": res["num_scored"], "scorers": res["scorers"],
                         "metrics": res["metrics"], "wall_s": time.monotonic() - t0,
                         "max_abs_diff": diff}
    log(f"  (c) score_game --stream over 4 parts: {out['score_game']}")
    if not diff <= STREAM_SCORE_ATOL:
        raise AssertionError("phase 11 (c): score_game --stream differs from score_game")
    return out


def read_glm_means(run_dir: str) -> np.ndarray:
    from photon_tpu_torch.data.index_map import IndexMap
    from photon_tpu_torch.data.model_io import load_glm_model

    imap = IndexMap.load(os.path.join(run_dir, "feature_index.json"))
    model = load_glm_model(os.path.join(run_dir, "best_model.avro"), imap, device="cpu")
    return model.coefficients.means.numpy()


def run_streamed(dev, game: dict) -> dict:
    """Phase 11; every launch count set to 0 just before each run and read
    after it."""
    root = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        t0 = time.monotonic()
        files = write_stream_parts(os.path.join(root, "parts"), STREAM_ROWS, STREAM_FILES,
                                   STREAM_K, STREAM_D)
        out = {"generate_s": time.monotonic() - t0, "rows": STREAM_ROWS,
               "files": len(files), "bytes": sum(os.path.getsize(f) for f in files)}
        log(f"  wrote {len(files)} part files, {STREAM_ROWS:,} rows, "
            f"{out['bytes'] / 1e6:.0f} MB in {out['generate_s']:.1f} s")
        cache_dir = os.path.join(root, "layouts")
        out["rate"] = run_stream_rate(files, dev)
        out["kernels"] = run_stream_kernels(files[:STREAM_KERNEL_FILES], cache_dir, dev)
        out["cli"] = run_stream_cli(files[:STREAM_KERNEL_FILES], root, cache_dir, game)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase11_launches(stream: dict, kernel: str) -> dict:
    """A kernel's launches in each phase-11 run."""
    runs = {f"rate_{name}": row["launches"].get(kernel, 0)
            for name, row in stream["rate"].items()}
    runs.update({f"pass_{name}": row["launches"].get(kernel, 0)
                 for name, row in stream["kernels"]["routes"].items()})
    runs.update({f"lbfgs_{name}": row["launches"].get(kernel, 0)
                 for name, row in stream["kernels"]["lbfgs"].items()})
    runs.update({f"train_{name}": row["launches"].get(kernel, 0)
                 for name, row in stream["cli"]["runs"].items()})
    return runs


# Phase 12: streamed GAME training.  (a) the JAX package's out-of-core
# scenario at its accelerator size (bench.py:462-507 _game_bench_fixture,
# bench.py:517-570 _bench_ooc): make_game_dataset(20_000, 50, 32, 8, seed 0,
# one random coordinate), ~1M rows, logistic, 2 descent iterations, the
# fixed effect L2 0.01 with 5 iterations, re0 L2 1.0 with 4, chunks of n // 8
# rows; one resident and one streamed estimator, each timed on its second
# fit.  (b) train_game --stream-chunks on phase 6's Avro file and split:
# the card and the host, a mid-epoch kill and --resume auto against the
# uninterrupted run (exact), and a --max-resident-mb budget that turns
# streaming on.
OOC_FIXTURE = dict(n_entities=20_000, rows_per_entity_mean=50, fixed_dim=32,
                   random_dim=8, seed=0, n_random_coords=1)
OOC_ITERATIONS = 2
OOC_CHUNKS = 8
STREAM_GAME_CHUNK_ROWS = 50_000  # 5 chunks of phase 6's 239,534 training rows
STREAM_GAME_ITERATIONS = 3
STREAM_GAME_KILL = "descent:kill:iter=1:coord=per_user"
STREAM_GAME_BUDGET_MB = 20.0
# Where phase 12 (a)'s streamed peak comes from: the whole streamed fit again
# at these chunk counts beside OOC_CHUNKS.
OOC_BREAKDOWN_CHUNKS = (4, 16)


def ooc_config():
    from photon_tpu_torch.core.objective import RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import ProblemConfig
    from photon_tpu_torch.game.coordinate import (
        FixedEffectCoordinateConfig,
        RandomEffectCoordinateConfig,
    )
    from photon_tpu_torch.game.estimator import GameOptimizationConfiguration

    def problem(lam: float, iters: int) -> ProblemConfig:
        return ProblemConfig(regularization=RegularizationContext("l2", lam),
                             optimizer_config=OptimizerConfig(max_iterations=iters))

    return GameOptimizationConfiguration(coordinates={
        "fixed": FixedEffectCoordinateConfig("global", problem(0.01, 5)),
        "re0": RandomEffectCoordinateConfig("re0", "re0", problem(1.0, 4)),
    }, descent_iterations=OOC_ITERATIONS)


def launches_of(counters) -> dict:
    return {c.__name__: c.launches for c in counters if c.launches}


def device_peak(dev, fn) -> dict:
    """``fn()``'s high water over the bytes on the card before it, in the
    allocator's ``allocated`` (tensors held) and ``active`` (held, or freed
    with their streams' work still queued) counts."""
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_stats(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_stats(dev)
    return {kind: after[f"{kind}_bytes.all.peak"] - before[f"{kind}_bytes.all.current"]
            for kind in ("allocated", "active")}


def active_counts_queued_frees(dev) -> bool:
    """Whether the allocator's ``active`` count keeps a tensor freed while
    the stream it was recorded on still has work queued (what the window
    gate below reads)."""
    side, compute = torch.cuda.Stream(dev), torch.cuda.current_stream(dev)
    torch.cuda.synchronize(dev)
    with torch.cuda.stream(side):
        x = torch.empty(1 << 20, device=dev)
    x.record_stream(compute)
    torch.cuda._sleep(20_000_000)  # tens of ms of queued work
    active = torch.cuda.memory_stats(dev)["active_bytes.all.current"]
    del x
    held = torch.cuda.memory_stats(dev)["active_bytes.all.current"] == active
    torch.cuda.synchronize(dev)
    return held


def ooc_residency(dev, data, config, chunk_rows: int, window_bound: int,
                  model) -> dict:
    """Phase 12 (a)'s device bytes, piece by piece: one streamed
    fixed-effect pass with the window and with a window as wide as the pass,
    the workspace of one chunk's value and gradient with the chunk already
    on the card, one random-effect train, one scoring pass, and the whole
    streamed fit at other chunk counts.  Gate: the bounded pass stays within
    the chunk window plus that workspace."""
    import dataclasses as dc

    from photon_tpu_torch.data.batch import DenseBatch
    from photon_tpu_torch.data.streaming import DeviceWindow
    from photon_tpu_torch.game.estimator import GameEstimator
    from photon_tpu_torch.game.stream_descent import (
        StreamedFixedEffectCoordinate,
        StreamedRandomEffectCoordinate,
    )
    from photon_tpu_torch.game.tiles import ChunkPlan, ChunkStreamer

    plan = ChunkPlan(data.num_examples, chunk_rows)
    streamer = ChunkStreamer(device=dev)
    fixed = StreamedFixedEffectCoordinate(data, config.coordinates["fixed"],
                                          "logistic_regression", plan, streamer)
    offsets = [np.zeros(plan.bounds(k)[1] - plan.bounds(k)[0], np.float32)
               for k in range(plan.num_chunks)]
    w = torch.full((fixed.dim,), 0.01, device=dev)
    fixed._streamed_value_and_grad(w, offsets)  # warm the allocator's pools
    out = {"active_counts_queued_frees": active_counts_queued_frees(dev)}
    out["fixed_pass"] = device_peak(dev, lambda: fixed._streamed_value_and_grad(w, offsets))
    bounded = streamer._window
    streamer._window = DeviceWindow(plan.num_chunks + 2)
    out["fixed_pass_unbounded_window"] = device_peak(
        dev, lambda: fixed._streamed_value_and_grad(w, offsets))
    out["unbounded_window_peak_bytes"] = streamer._window.peak_bytes
    streamer._window = bounded
    host = fixed._chunk_batch(0, offsets)
    chunk = DenseBatch(*(torch.as_tensor(a, device=dev) for a in host))
    out["fixed_chunk_bytes"] = sum(t.nbytes for t in chunk)
    data_obj = dc.replace(fixed.objective, l2_weight=0.0, l1_weight=0.0)
    out["fixed_chunk_workspace"] = device_peak(
        dev, lambda: data_obj._fast_data_value_and_grad(w, chunk, None))
    del chunk
    allowance = window_bound + out["fixed_chunk_workspace"]["active"]
    out["fixed_pass_allowance_bytes"] = allowance

    re_coord = StreamedRandomEffectCoordinate(data, config.coordinates["re0"],
                                              "logistic_regression", plan, streamer)
    zeros = np.zeros(data.num_examples, np.float32)

    class Offsets:
        @staticmethod
        def full():
            return zeros

    out["re_blocks"] = len(re_coord.bin_blocks())
    out["re_block_bytes_max"] = max(
        e_sub * re_coord.device_data.entity_bytes(re_coord.device_data.bins[i])
        for i, _, _, e_sub in re_coord.bin_blocks())
    out["re_train"] = device_peak(dev, lambda: re_coord.train(Offsets()))
    out["score_pass"] = device_peak(
        dev, lambda: fixed.score_stream(model.coordinate("fixed")))
    out["window_peak_bytes"] = streamer.peak_in_flight_bytes
    fits = {}
    for chunks in OOC_BREAKDOWN_CHUNKS:
        est = GameEstimator("logistic_regression", data, device=dev,
                            stream_chunks=max(1, data.num_examples // chunks))
        fits[chunks] = device_peak(dev, lambda: est.fit([config]))
        fits[chunks]["window_peak_bytes"] = est._streamer.peak_in_flight_bytes
        del est
    out["fit_by_chunks"] = fits
    mib = 2 ** 20
    log(f"  (a) device bytes over the fit's base (allocated / active MiB): fixed-effect "
        f"pass {out['fixed_pass']['allocated'] / mib:.1f} / "
        f"{out['fixed_pass']['active'] / mib:.1f} (a window of 3 chunks; "
        f"{out['fixed_pass_unbounded_window']['allocated'] / mib:.1f} / "
        f"{out['fixed_pass_unbounded_window']['active'] / mib:.1f} with the window "
        f"open, its events' peak {out['unbounded_window_peak_bytes'] / mib:.1f}); "
        f"fixed chunk {out['fixed_chunk_bytes'] / mib:.1f}, its value-and-gradient "
        f"workspace {out['fixed_chunk_workspace']['active'] / mib:.1f}; random-effect "
        f"train {out['re_train']['allocated'] / mib:.1f} / "
        f"{out['re_train']['active'] / mib:.1f} ({out['re_blocks']} blocks of at most "
        f"{out['re_block_bytes_max'] / mib:.1f}); scoring pass "
        f"{out['score_pass']['allocated'] / mib:.1f} / {out['score_pass']['active'] / mib:.1f}; "
        f"whole fit at " + ", ".join(
            f"{c} chunks {f['allocated'] / mib:.1f} / {f['active'] / mib:.1f} (window "
            f"{f['window_peak_bytes'] / mib:.1f})" for c, f in fits.items())
        + f"; active keeps queued frees: {out['active_counts_queued_frees']}")
    if out["fixed_pass"]["active"] > allowance:
        raise AssertionError(
            f"phase 12 (a): a streamed pass held {out['fixed_pass']['active']} bytes on "
            f"the card, past the {window_bound}-byte window and the "
            f"{out['fixed_chunk_workspace']['active']}-byte workspace of a chunk")
    return out


def run_ooc_scenario(dev, keep: dict | None = None) -> dict:
    """Phase 12 (a); every launch count set to 0 just before each fit.  With
    ``keep``, the dataset, the plan and the streamed fits' weights and
    training scores (warm-up and timed) stay there for phase 14."""
    from photon_tpu_torch.data.synthetic import make_game_dataset
    from photon_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_tpu_torch.game.estimator import GameEstimator
    from photon_tpu_torch.game.tiles import PREFETCH_DEPTH, per_row_bytes
    from photon_tpu_torch.telemetry import TelemetrySession

    counters = kernel_wrappers()
    t0 = time.monotonic()
    data, _ = make_game_dataset(**OOC_FIXTURE)
    n = data.num_examples
    chunk_rows = max(1, n // OOC_CHUNKS)
    window_bound = (PREFETCH_DEPTH + 1) * chunk_rows * per_row_bytes(data)
    out = {"rows": n, "generate_s": time.monotonic() - t0, "chunk_rows": chunk_rows,
           "per_row_bytes": per_row_bytes(data), "window_bound_bytes": window_bound}
    log(f"  (a) {n:,} rows, {OOC_FIXTURE['n_entities']:,} entities, d = "
        f"{OOC_FIXTURE['fixed_dim']} / {OOC_FIXTURE['random_dim']}, chunks of "
        f"{chunk_rows:,} rows; made in {out['generate_s']:.1f} s")
    config = ooc_config()
    label = torch.as_tensor(data.label, device=dev)
    weight = torch.as_tensor(data.weight, device=dev)
    models = {}
    for name, kwargs in (("resident", {"residual_mode": "device"}),
                         ("streamed", {"stream_chunks": chunk_rows})):
        session = TelemetrySession(f"chip-smoke-ooc-{name}")
        est = GameEstimator("logistic_regression", data, device=dev, telemetry=session,
                            **kwargs)
        for c in counters:
            c.launches = 0
        t0 = time.monotonic()
        if name == "streamed":
            # The warm-up fit under the sync debug mode: every synchronizing
            # call of a streamed fit, against the chunks it delivered.
            warm, warned = sync_warnings(lambda: est.fit([config]))
            syncs = [m for m in warned if "called a synchronizing" in m]
            if keep is not None:
                keep["streamed_fits"] = [model_weights(warm[0].model)]
            del warm
        else:
            est.fit([config])
            syncs = None
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        chunks0 = counter_total(session, "stream.chunks")
        stall0 = counter_total(session, "stream.stall_s")
        overlap0 = counter_total(session, "stream.prefetch_overlap_s")
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.monotonic()
        result = est.fit([config])[0]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        run = {"warm_up_s": warm_s, "wall_s": wall, "rows_per_s": OOC_ITERATIONS * n / wall,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
               "launches": launches_of(counters),
               "descent_iteration_s": [h["seconds"] for h in result.descent.history]}
        if name == "streamed":
            chunks = counter_total(session, "stream.chunks") - chunks0
            run.update(
                chunks=chunks, stall_s=counter_total(session, "stream.stall_s") - stall0,
                prefetch_overlap_s=(counter_total(session, "stream.prefetch_overlap_s")
                                    - overlap0),
                peak_in_flight_bytes=est._streamer.peak_in_flight_bytes,
                # Both fits' admissions that waited for the card to release
                # a chunk (the window's bound), a chunk.
                window_waits_per_chunk=(est._streamer._window.waits
                                        / max(counter_total(session, "stream.chunks"), 1)),
                warm_up_syncs=len(syncs), warm_up_chunks=chunks0,
                host_syncs_per_chunk=len(syncs) / max(chunks0, 1),
                sync_sites=sorted(set(syncs))[:5])
        scores = torch.as_tensor(result.model.score(data), device=dev)
        run["finite"] = bool(torch.isfinite(scores).all())
        run["train_auc"] = float(area_under_roc_curve(scores, label, weight))
        models[name] = scores
        if name == "streamed":
            streamed_model = result.model
            if keep is not None:
                keep["streamed_fits"].append(model_weights(result.model))
                keep["streamed_scores"] = scores.cpu().numpy()
        out[name] = run
        log(f"  (a) {name}: warm-up {warm_s:.2f} s, timed fit {wall:.2f} s "
            f"({run['rows_per_s']:,.0f} rows/s; iterations "
            f"{[round(s, 3) for s in run['descent_iteration_s']]} s), peak allocated "
            f"{run['max_memory_allocated_bytes'] / 2**20:.1f} MiB, train AUC "
            f"{run['train_auc']:.6f}, launches {run['launches'] or 'none'}")
        del est, result
    s = out["streamed"]
    gap = (models["streamed"] - models["resident"]).abs()
    out["rows_per_s_ratio"] = s["rows_per_s"] / out["resident"]["rows_per_s"]
    out["score_gap"] = {"max": float(gap.max()),
                        "rms": float(gap.square().mean().sqrt())}
    out["train_auc_gap"] = abs(s["train_auc"] - out["resident"]["train_auc"])
    log(f"  (a) streamed: {s['chunks']:.0f} chunks, stall {s['stall_s']:.3f} s, "
        f"prefetch overlap {s['prefetch_overlap_s']:.3f} s, peak in flight "
        f"{s['peak_in_flight_bytes'] / 2**20:.1f} MiB of the "
        f"{window_bound / 2**20:.1f} MiB bound, {s['window_waits_per_chunk']:.3f} window "
        f"waits a chunk, {s['host_syncs_per_chunk']:.3f} host "
        f"syncs a chunk ({s['warm_up_syncs']} in the warm-up's {s['warm_up_chunks']:.0f} "
        f"chunks); streamed / resident rows/s {out['rows_per_s_ratio']:.3f}; scores "
        f"max |diff| {out['score_gap']['max']:.3e} (RMS {out['score_gap']['rms']:.3e}), "
        f"train AUC |diff| {out['train_auc_gap']:.3e}")
    out["residency"] = ooc_residency(dev, data, config, chunk_rows, window_bound,
                                     streamed_model)
    if not s["finite"]:
        raise AssertionError("phase 12 (a): the streamed fit is not finite")
    if not 0 < s["peak_in_flight_bytes"] <= window_bound:
        raise AssertionError(f"phase 12 (a): {s['peak_in_flight_bytes']} bytes in flight "
                             f"past the {window_bound}-byte window")
    if s["launches"]:
        raise AssertionError(f"phase 12 (a): hand-written kernels launched on the "
                             f"streamed path: {s['launches']}")
    if keep is not None:
        keep.update(data=data, config=config, chunk_rows=chunk_rows,
                    window_bound=window_bound,
                    streamed_rows_per_s=s["rows_per_s"])
    del data, label, weight, models, streamed_model
    torch.cuda.empty_cache()
    return out


def model_weights(model) -> dict:
    """A GAME model's coefficients and tables as host arrays."""
    return {name: (m.table if hasattr(m, "table") else m.coefficients.means)
            .detach().cpu().numpy().copy() for name, m in model.coordinates.items()}


def stream_game_args(avro: str, out: str, backend: str, *extra) -> list:
    return [*game_cli_args(avro, out, backend), *extra]


@contextlib.contextmanager
def pass_values(values: list):
    """Record the streamed fixed effect's objective value at every pass, as
    ``(fit, value)`` (the float32 value its L-BFGS line search compares)."""
    from photon_tpu_torch.game import stream_descent

    cls = stream_descent._StreamedObjective
    inner = cls.value_and_grad
    fits: dict = {}

    def recorded(self, w):
        v, g = inner(self, w)
        values.append((fits.setdefault(id(self), len(fits)), float(v)))
        return v, g

    cls.value_and_grad = recorded
    try:
        yield values
    finally:
        cls.value_and_grad = inner


def pass_split(card: list, host: list) -> list:
    """Each fixed-effect fit's passes on card and host, and the first pass
    whose float32 values differ, by how many float32 ulps."""
    out = []
    for fit in sorted({f for f, _ in card} & {f for f, _ in host}):
        a = [v for f, v in card if f == fit]
        b = [v for f, v in host if f == fit]
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        row = {"fit": fit, "passes": [len(a), len(b)], "first_differing_pass": first}
        if first is not None:
            ulp = float(np.spacing(np.float32(abs(b[first]))))
            row.update(values=[a[first], b[first]], ulps=abs(a[first] - b[first]) / ulp,
                       final=[a[-1], b[-1]], final_ulps=abs(a[-1] - b[-1]) / ulp)
        out.append(row)
    return out


def run_stream_game(game: dict, keep: dict | None = None) -> dict:
    """Phase 12 (b); every launch count set to 0 just before each run.  With
    ``keep``, the card run's weights stay there for phase 14."""
    from photon_tpu_torch.drivers import train_game
    from photon_tpu_torch.fault.checkpoint import DescentCheckpointer
    from photon_tpu_torch.fault.injection import InjectedKillError
    from photon_tpu_torch.game.model_io import load_game_model

    counters = kernel_wrappers()
    root = os.path.join(os.path.dirname(game["avro"]), "phase12")
    chunks = ["--stream-chunks", str(STREAM_GAME_CHUNK_ROWS)]
    iters3 = ["--descent-iterations", str(STREAM_GAME_ITERATIONS)]
    out = {"runs": {}, "pass_values": {}}

    def run(name, backend, *extra, kill=False):
        run_dir = os.path.join(root, name)
        for c in counters:
            c.launches = 0
        t0 = time.monotonic()
        summary = None
        try:
            with pass_values(out["pass_values"].setdefault(name, [])):
                summary = train_game.run(train_game.build_parser().parse_args(
                    stream_game_args(game["avro"], run_dir, backend, *extra)))
            killed = False
        except InjectedKillError:
            killed = True
        if backend == "gpu":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if killed != kill:
            raise AssertionError(f"phase 12 (b) {name}: killed {killed}, expected {kill}")
        row = {"backend": backend, "wall_s": wall, "launches": launches_of(counters),
               "dir": run_dir}
        if summary is not None:
            history = summary["sweep"][0]["history"]
            row.update(best_metrics=summary["best_metrics"],
                       stream_chunks=summary["stream_chunks"],
                       descent_iteration_s=[h["seconds"] for h in history],
                       # The fixed effect's L-BFGS iterations and passes an
                       # iteration: where card and host stop apart.
                       # (None where a resume skipped it).
                       fixed_iterations=[
                           (fixed["iterations"], fixed["evaluations"]) if fixed else None
                           for fixed in ((h.get("solver") or {}).get("fixed")
                                         for h in history)],
                       phase_times=summary["phase_times"])
            metrics = run_report_metrics(run_dir)
            for key in ("stream.stall_s", "stream.prefetch_overlap_s"):
                m = metric(metrics, "counters", key, tier="h2d")
                row[key] = m["value"] if m else None
            peak = metric(metrics, "gauges", "residuals.device_bytes")
            row["peak_in_flight_bytes"] = peak["value"] if peak else None
        if row["launches"]:
            raise AssertionError(f"phase 12 (b) {name}: hand-written kernels launched "
                                 f"on the streamed path: {row['launches']}")
        out["runs"][name] = row
        log(f"  (b) {name} ({backend}): {'killed, ' if killed else ''}{wall:.2f} s"
            + (f", chunk rows {row['stream_chunks']}, iterations "
               f"{[round(s, 3) for s in row['descent_iteration_s']]} s, fixed effect "
               f"(iterations, passes) {row['fixed_iterations']}, metrics "
               f"{row['best_metrics']}, stall {row['stream.stall_s']:.3f} s, overlap "
               f"{row['stream.prefetch_overlap_s']:.3f} s, peak in flight "
               f"{row['peak_in_flight_bytes']}" if summary is not None else ""))
        return row

    def model(name):
        return load_game_model(os.path.join(root, name, "best_model"), device="cpu")[0]

    def diffs(a, b) -> dict:
        out = {}
        for coord, m in a.coordinates.items():
            r = b.coordinate(coord)
            got, want = ((m.coefficients.means, r.coefficients.means)
                         if hasattr(m, "coefficients") else (m.table, r.table))
            out[coord] = float((got - want).abs().max())
        return out

    run("card", "gpu", *chunks)
    run("host", "cpu", *chunks)
    card, host = out["runs"]["card"], out["runs"]["host"]
    for key, ref in host["best_metrics"].items():
        if abs(card["best_metrics"][key] - ref) > GAME_METRIC_ATOL:
            raise AssertionError(f"phase 12 (b): {key} card {card['best_metrics'][key]} "
                                 f"host {ref}")
    card_model = model("card")
    out["card_vs_host"] = diffs(card_model, model("host"))
    if keep is not None:
        keep.update(cli_card_weights=model_weights(card_model),
                    cli_card_vs_host=out["card_vs_host"])
    if max(out["card_vs_host"].values()) > GAME_COEF_TOL:
        raise AssertionError(f"phase 12 (b): card and host differ {out['card_vs_host']}")
    out["pass_split"] = pass_split(out["pass_values"]["card"], out["pass_values"]["host"])
    log(f"  (b) the streamed fixed effect's float32 objective a pass, card against host: "
        f"{out['pass_split']}")
    resident = load_game_model(os.path.join(game["run_dirs"]["fused"], "best_model"),
                               device="cpu")[0]
    out["card_vs_resident_card"] = diffs(card_model, resident)
    out["resident_card_vs_host"] = game["runs"]["fused"]["coefficient_max_abs_diff_vs_cpu"]
    log(f"  (b) card vs host {out['card_vs_host']} (phase 6's resident card vs host "
        f"{out['resident_card_vs_host']}); streamed vs phase 6's resident card model "
        f"{out['card_vs_resident_card']}")
    ck = os.path.join(root, "ckpt")
    run("uninterrupted", "gpu", *chunks, *iters3)
    run("killed", "gpu", *chunks, *iters3, "--checkpoint-dir", ck, "--faults",
        STREAM_GAME_KILL, kill=True)
    chain = os.path.join(ck, os.listdir(ck)[0], "cfg-000")
    state = DescentCheckpointer.load_path(DescentCheckpointer(chain).latest_path(),
                                          device="cpu")
    out["kill_checkpoint"] = {"iteration": state.iteration, **{
        k: state.stream[k] for k in ("cursor", "seq", "chunk_rows")},
        "tile_digests": len(state.stream["tile_digests"])}
    if state.stream["cursor"] != 1:
        raise AssertionError(f"phase 12 (b): the kill left {out['kill_checkpoint']}, "
                             "not a mid-epoch cursor")
    run("resumed", "gpu", *chunks, *iters3, "--checkpoint-dir", ck, "--resume", "auto")
    out["resumed_vs_uninterrupted"] = diffs(model("resumed"), model("uninterrupted"))
    same_metrics = (out["runs"]["resumed"]["best_metrics"]
                    == out["runs"]["uninterrupted"]["best_metrics"])
    log(f"  (b) the kill's checkpoint {out['kill_checkpoint']}; resumed vs uninterrupted "
        f"{out['resumed_vs_uninterrupted']}, metrics equal {same_metrics}")
    if max(out["resumed_vs_uninterrupted"].values()) != 0.0 or not same_metrics:
        raise AssertionError("phase 12 (b): the resumed model differs from the "
                             "uninterrupted one")
    budget = run("max_resident_mb", "gpu", "--max-resident-mb", str(STREAM_GAME_BUDGET_MB))
    est = metric(run_report_metrics(budget["dir"]), "gauges",
                 "stream.resident_estimate_bytes")["value"]
    out["budget"] = {"mb": STREAM_GAME_BUDGET_MB, "resident_estimate_bytes": est,
                     "chunk_rows": budget["stream_chunks"]}
    log(f"  (b) --max-resident-mb {STREAM_GAME_BUDGET_MB:g}: resident estimate "
        f"{est / 2**20:.1f} MiB, chose {budget['stream_chunks']} chunk rows")
    if not budget["stream_chunks"]:
        raise AssertionError("phase 12 (b): --max-resident-mb did not turn streaming on")
    shutil.rmtree(root, ignore_errors=True)
    return out


def run_streamed_game(dev, game: dict, keep: dict | None = None) -> dict:
    """Phase 12 (``keep``: what phase 14 reuses)."""
    return {"ooc": run_ooc_scenario(dev, keep), "cli": run_stream_game(game, keep)}


def phase12_launches(sgame: dict) -> dict:
    """Every hand-written kernel's launches in each phase-12 run."""
    runs = {f"ooc_{name}": sgame["ooc"][name]["launches"]
            for name in ("resident", "streamed")}
    runs.update({f"train_game_{name}": row["launches"]
                 for name, row in sgame["cli"]["runs"].items()})
    return runs

# Phase 14: the disk tier of streamed GAME training.  (a) phase 12 (a)'s
# out-of-core scenario (its dataset and plan, kept from phase 12) spilled to
# a tile store with a host cache of three chunks' entries, so every pass
# evicts: a warm-up and a timed fit at f32 held to phase 12's streamed fits
# bit for bit, then one fit each at the bf16 and int8 tiers (training AUC
# within tile_metric_tol_for of f32) and one with PHOTON_TILE_COMPRESS=1
# (bit for bit).  (b) train_game --stream-chunks --spill-dir on phase 6's
# Avro file and split: card and host under phase 6's gates, the card run
# against phase 12 (b)'s card run bit for bit; a mid-epoch kill and
# --resume auto at f32 and int8 (exact), a flipped tile byte
# (CorruptTileError), a deleted tile (rebuilt, exact) and --max-host-mb
# alone.
SPILL_CACHE_CHUNKS = 3
SPILL_TIERS = ("bf16", "int8")
SPILL_KILL_TIERS = ("f32", "int8")
SPILL_HOST_MB = 20.0  # phase 6's training split estimates ~37 MB on the host


def spill_stats(session, est) -> dict:
    """The disk tier's counters and the cache's and store's shape."""
    tier = {(name, t): counter_total_labeled(session, name, tier=t)
            for name in ("stream.stall_s", "stream.prefetch_overlap_s")
            for t in ("disk", "h2d")}
    return {
        "stall_s": {t: tier[("stream.stall_s", t)] for t in ("disk", "h2d")},
        "prefetch_overlap_s": {t: tier[("stream.prefetch_overlap_s", t)]
                               for t in ("disk", "h2d")},
        **{key: counter_total(session, f"tiles.{key}")
           for key in ("cache_hits", "cache_misses", "cache_evictions",
                       "writeback_flush_s", "store_reads", "store_writes")},
        "chunks": counter_total(session, "stream.chunks"),
        "disk_bytes": est._spill.store.disk_bytes,
        "cache_peak_bytes": est._spill.cache.peak_bytes,
        "cache_largest_entry_bytes": est._spill.cache.largest_entry_bytes,
        "peak_in_flight_bytes": est._stream_streamer().peak_in_flight_bytes,
    }


def delta(after: dict, before: dict) -> dict:
    return {k: (delta(v, before[k]) if isinstance(v, dict) else v - before[k])
            for k, v in after.items()}


def weights_equal(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[name], b[name]) for name in a)


def weights_gap(a: dict, b: dict) -> float:
    return max(float(np.abs(a[name] - b[name]).max()) for name in a)


def run_spill_scenario(dev, keep: dict, root: str) -> dict:
    """Phase 14 (a); every launch count set to 0 just before each fit."""
    from photon_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_tpu_torch.game.estimator import GameEstimator
    from photon_tpu_torch.game.lowp import tile_metric_tol_for
    from photon_tpu_torch.game.tiles import per_row_bytes
    from photon_tpu_torch.telemetry import TelemetrySession

    counters = kernel_wrappers()
    data, config, chunk_rows = keep["data"], keep["config"], keep["chunk_rows"]
    n = data.num_examples
    budget = SPILL_CACHE_CHUNKS * chunk_rows * per_row_bytes(data)
    label = torch.as_tensor(data.label, device=dev)
    weight = torch.as_tensor(data.weight, device=dev)
    # Two host-resident streamed fits of phase 12: where they differ, some
    # card op orders its sums differently from run to run, and the spilled
    # fits are held to that spread instead of to equality.
    ref_warm, ref = keep["streamed_fits"]
    spread = weights_gap(ref_warm, ref)
    out = {"budget_bytes": budget, "rows": n, "chunk_rows": chunk_rows,
           "streamed_fit_spread": spread, "runs": {}}
    log(f"  (a) {n:,} rows in chunks of {chunk_rows:,}, host cache budget {budget:,} B "
        f"({SPILL_CACHE_CHUNKS} chunks' entries); phase 12's two streamed fits differ by "
        f"{spread:.3e}")

    def fit(name: str, tier: str = "f32", timed: bool = False, compress: bool = False):
        session = TelemetrySession(f"chip-smoke-spill-{name}")
        store = os.path.join(root, f"store_{name}")
        if compress:
            os.environ["PHOTON_TILE_COMPRESS"] = "1"
        try:
            est = GameEstimator("logistic_regression", data, device=dev, telemetry=session,
                                stream_chunks=chunk_rows, spill_dir=store,
                                max_host_mb=budget / (1 << 20), tile_dtype=tier)
            t0 = time.monotonic()
            est._spill_context()
            spill_s = time.monotonic() - t0
            row = {"tier": tier, "spill_s": spill_s}
            fits = ["warm_up", "timed"] if timed else ["timed"]
            for which in fits:
                for c in counters:
                    c.launches = 0
                before = spill_stats(session, est)
                t0 = time.monotonic()
                result = est.fit([config])[0]
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                launches = launches_of(counters)
                if launches:
                    raise AssertionError(f"phase 14 (a) {name}: hand-written kernels "
                                         f"launched on the spilled path: {launches}")
                row[f"{which}_weights"] = model_weights(result.model)
                row.update({f"{which}_s": wall, f"{which}_launches": launches})
                if which == "timed":
                    row.update(wall_s=wall, rows_per_s=OOC_ITERATIONS * n / wall,
                               **delta(spill_stats(session, est), before))
                    for key in ("disk_bytes", "cache_peak_bytes",
                                "cache_largest_entry_bytes", "peak_in_flight_bytes"):
                        row[key] = spill_stats(session, est)[key]
                    row["writeback_flush_s_per_sweep"] = (row["writeback_flush_s"]
                                                          / OOC_ITERATIONS)
                    scores = torch.as_tensor(result.model.score(data), device=dev)
                    row["finite"] = bool(torch.isfinite(scores).all())
                    row["train_auc"] = float(area_under_roc_curve(scores, label, weight))
                    row["scores"] = scores.cpu().numpy()
            del est, result
        finally:
            os.environ.pop("PHOTON_TILE_COMPRESS", None)
        weights = row.pop("timed_weights")
        warm_weights = row.pop("warm_up_weights", None)
        scores = row.pop("scores")
        out["runs"][name] = row
        log(f"  (a) {name} ({tier}{', compressed' if compress else ''}): spill "
            f"{row['spill_s']:.2f} s, timed fit {row['wall_s']:.2f} s "
            f"({row['rows_per_s']:,.0f} rows/s; phase 12's streamed fit "
            f"{keep['streamed_rows_per_s']:,.0f}); stall disk {row['stall_s']['disk']:.3f} / "
            f"h2d {row['stall_s']['h2d']:.3f} s, overlap disk "
            f"{row['prefetch_overlap_s']['disk']:.3f} / h2d "
            f"{row['prefetch_overlap_s']['h2d']:.3f} s; cache hits "
            f"{row['cache_hits']:.0f}, misses {row['cache_misses']:.0f}, evictions "
            f"{row['cache_evictions']:.0f}, peak {row['cache_peak_bytes']:,} of "
            f"{budget:,} B; disk {row['disk_bytes']:,} B; write-back "
            f"{row['writeback_flush_s_per_sweep']:.3f} s a sweep; in flight "
            f"{row['peak_in_flight_bytes']:,} of {keep['window_bound']:,} B; train AUC "
            f"{row['train_auc']:.6f}")
        if not row["finite"]:
            raise AssertionError(f"phase 14 (a) {name}: the spilled fit is not finite")
        allowed = max(budget, row["cache_largest_entry_bytes"])
        if row["cache_peak_bytes"] > allowed:
            raise AssertionError(f"phase 14 (a) {name}: the host cache held "
                                 f"{row['cache_peak_bytes']} B past its {allowed} B")
        if not row["cache_evictions"]:
            raise AssertionError(f"phase 14 (a) {name}: the cache never evicted")
        if not 0 < row["peak_in_flight_bytes"] <= keep["window_bound"]:
            raise AssertionError(f"phase 14 (a) {name}: {row['peak_in_flight_bytes']} B "
                                 f"in flight past the {keep['window_bound']} B window")
        return weights, warm_weights, scores

    f32, f32_warm, f32_scores = fit("f32", timed=True)
    gaps = {"timed": weights_gap(f32, ref), "warm_up": weights_gap(f32_warm, ref_warm),
            "scores": float(np.abs(f32_scores - keep["streamed_scores"]).max())}
    out["f32_vs_streamed"] = gaps
    out["rows_per_s_vs_streamed"] = (out["runs"]["f32"]["rows_per_s"]
                                     / keep["streamed_rows_per_s"])
    log(f"  (a) spilled f32 against phase 12's streamed fits: {gaps} (bound {spread:.3e}); "
        f"rows/s spilled / streamed {out['rows_per_s_vs_streamed']:.3f}")
    if max(gaps.values()) > spread:
        raise AssertionError(f"phase 14 (a): the spilled fit is off the host-resident "
                             f"streamed fit by {gaps}")
    auc = out["runs"]["f32"]["train_auc"]
    for tier in SPILL_TIERS:
        weights, _, _ = fit(tier, tier=tier)
        row = out["runs"][tier]
        row["auc_gap"] = abs(row["train_auc"] - auc)
        row["disk_bytes_vs_f32"] = row["disk_bytes"] / out["runs"]["f32"]["disk_bytes"]
        row["weights_gap"] = weights_gap(weights, f32)
        log(f"  (a) {tier}: disk {row['disk_bytes_vs_f32']:.3f} of f32's, training AUC "
            f"|diff| {row['auc_gap']:.3e} (tolerance {tile_metric_tol_for(tier):g}), "
            f"weights |diff| {row['weights_gap']:.3e}")
        if row["auc_gap"] > tile_metric_tol_for(tier):
            raise AssertionError(f"phase 14 (a) {tier}: the AUC is off f32's")
    compressed, _, _ = fit("f32_compressed", compress=True)
    out["compressed_equal"] = weights_equal(compressed, f32)
    log(f"  (a) PHOTON_TILE_COMPRESS=1: disk "
        f"{out['runs']['f32_compressed']['disk_bytes']:,} B, equal to the uncompressed "
        f"fit {out['compressed_equal']}")
    if not out["compressed_equal"]:
        raise AssertionError("phase 14 (a): the compressed fit differs")
    del label, weight
    torch.cuda.empty_cache()
    return out


def run_spill_game(game: dict, keep: dict, root: str) -> dict:
    """Phase 14 (b); every launch count set to 0 just before each run."""
    from photon_tpu_torch.drivers import train_game
    from photon_tpu_torch.fault.injection import InjectedKillError
    from photon_tpu_torch.game.model_io import load_game_model
    from photon_tpu_torch.game.tile_store import CorruptTileError, TileStore
    from photon_tpu_torch.game.tiles import RESIDUAL_TILE_KIND

    counters = kernel_wrappers()
    chunks = ["--stream-chunks", str(STREAM_GAME_CHUNK_ROWS)]
    out = {"runs": {}}

    def run(name, backend, *extra, kill=False, raises=None):
        run_dir = os.path.join(root, name)
        for c in counters:
            c.launches = 0
        t0 = time.monotonic()
        summary, outcome = None, "finished"
        try:
            summary = train_game.run(train_game.build_parser().parse_args(
                stream_game_args(game["avro"], run_dir, backend, *extra)))
        except InjectedKillError:
            outcome = "killed"
        except CorruptTileError:
            outcome = "corrupt"
        if backend == "gpu":
            torch.cuda.synchronize()
        want = "killed" if kill else (raises or "finished")
        if outcome != want:
            raise AssertionError(f"phase 14 (b) {name}: {outcome}, expected {want}")
        row = {"backend": backend, "wall_s": time.monotonic() - t0, "outcome": outcome,
               "launches": launches_of(counters), "dir": run_dir}
        if row["launches"]:
            raise AssertionError(f"phase 14 (b) {name}: hand-written kernels launched on "
                                 f"the spilled path: {row['launches']}")
        if summary is not None:
            metrics = run_report_metrics(run_dir)

            def count(key, **labels):
                m = metric(metrics, "counters", key, **labels)
                return m["value"] if m else 0

            gauge = {m["name"]: m["value"] for m in metrics["gauges"] if not m["labels"]}
            row.update(best_metrics=summary["best_metrics"],
                       stream_chunks=summary["stream_chunks"],
                       descent_iteration_s=[h["seconds"] for h in
                                            summary["sweep"][0]["history"]],
                       stall_s={t: count("stream.stall_s", tier=t) for t in ("disk", "h2d")},
                       rebuilt=count("tiles.rebuilt"),
                       rebuilt_unverified=count("tiles.rebuilt_unverified"),
                       cache_evictions=count("tiles.cache_evictions"),
                       spilled=gauge.get("stream.spilled"),
                       disk_bytes=gauge.get("tiles.disk_bytes"),
                       host_estimate_bytes=gauge.get("stream.host_estimate_bytes"))
        out["runs"][name] = row
        log(f"  (b) {name} ({backend}): {outcome}, {row['wall_s']:.2f} s"
            + (f", chunk rows {row['stream_chunks']}, iterations "
               f"{[round(x, 3) for x in row['descent_iteration_s']]} s, metrics "
               f"{row['best_metrics']}, stall {row['stall_s']}, evictions "
               f"{row['cache_evictions']:.0f}, disk {row['disk_bytes']}, rebuilt "
               f"{row['rebuilt']:.0f}" if summary is not None else ""))
        return row

    def weights(name):
        return model_weights(load_game_model(os.path.join(root, name, "best_model"),
                                             device="cpu")[0])

    def store(name):
        return ["--spill-dir", os.path.join(root, f"store_{name}")]

    os.environ.pop("PHOTON_SPARSE_GRAD", None)
    run("card", "gpu", *chunks, *store("card"))
    run("host", "cpu", *chunks, *store("host"))
    card, host = out["runs"]["card"], out["runs"]["host"]
    for key, ref in host["best_metrics"].items():
        if abs(card["best_metrics"][key] - ref) > GAME_METRIC_ATOL:
            raise AssertionError(f"phase 14 (b): {key} card {card['best_metrics'][key]} "
                                 f"host {ref}")
    card_w = weights("card")
    out["card_vs_host"] = {k: float(np.abs(v - weights("host")[k]).max())
                           for k, v in card_w.items()}
    out["card_vs_streamed_card"] = weights_gap(card_w, keep["cli_card_weights"])
    log(f"  (b) card vs host {out['card_vs_host']} (phase 12 (b)'s streamed: "
        f"{keep['cli_card_vs_host']}); the spilled card run against phase 12 (b)'s "
        f"streamed card run: {out['card_vs_streamed_card']:.3e}")
    if max(out["card_vs_host"].values()) > GAME_COEF_TOL:
        raise AssertionError(f"phase 14 (b): card and host differ {out['card_vs_host']}")
    if out["card_vs_streamed_card"] != 0.0:
        raise AssertionError("phase 14 (b): the spilled card run differs from the "
                             "host-resident streamed one")
    for tier in SPILL_KILL_TIERS:
        codec = ["--tile-dtype", tier]
        ck = ["--checkpoint-dir", os.path.join(root, f"ck_{tier}")]
        base = "card"
        if tier != "f32":
            base = f"card_{tier}"
            run(base, "gpu", *chunks, *store(base), *codec)
        run(f"killed_{tier}", "gpu", *chunks, *store(tier), *codec, *ck, "--faults",
            STREAM_GAME_KILL, kill=True)
        if tier == "f32":
            # Copies of the killed state: one with a tile byte flipped, one
            # with a tile gone.
            for case in ("corrupt", "stale"):
                shutil.copytree(os.path.join(root, "ck_f32"),
                                os.path.join(root, f"ck_{case}"))
                shutil.copytree(os.path.join(root, "store_f32"),
                                os.path.join(root, f"store_{case}"))
        run(f"resumed_{tier}", "gpu", *chunks, *store(tier), *codec, *ck,
            "--resume", "auto")
        gap = weights_gap(weights(f"resumed_{tier}"), weights(base))
        same = out["runs"][f"resumed_{tier}"]["best_metrics"] == out["runs"][base]["best_metrics"]
        out[f"resumed_vs_uninterrupted_{tier}"] = gap
        log(f"  (b) {tier}: resumed against uninterrupted {gap:.3e}, metrics equal {same}, "
            f"rebuilt {out['runs'][f'resumed_{tier}']['rebuilt']:.0f}")
        if gap != 0.0 or not same:
            raise AssertionError(f"phase 14 (b) {tier}: the resumed model differs")
        if out["runs"][f"resumed_{tier}"]["rebuilt"]:
            raise AssertionError(f"phase 14 (b) {tier}: the resume rebuilt flushed tiles")
    tiles = TileStore(os.path.join(root, "store_corrupt"))
    path = tiles.path(RESIDUAL_TILE_KIND, 0)
    with open(path, "r+b") as f:
        f.seek(-5, os.SEEK_END)
        byte = f.read(1)
        f.seek(-5, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0xFF]))
    run("corrupt", "gpu", *chunks, *store("corrupt"),
        "--checkpoint-dir", os.path.join(root, "ck_corrupt"), "--resume", "auto",
        raises="corrupt")
    TileStore(os.path.join(root, "store_stale")).delete(RESIDUAL_TILE_KIND, 1)
    stale = run("stale", "gpu", *chunks, *store("stale"),
                "--checkpoint-dir", os.path.join(root, "ck_stale"), "--resume", "auto")
    out["stale_vs_uninterrupted"] = weights_gap(weights("stale"), weights("card"))
    log(f"  (b) a flipped tile byte: CorruptTileError; a deleted tile: rebuilt "
        f"{stale['rebuilt']:.0f} (unverified {stale['rebuilt_unverified']:.0f}), against "
        f"the uninterrupted run {out['stale_vs_uninterrupted']:.3e}")
    if stale["rebuilt"] != 1 or stale["rebuilt_unverified"]:
        raise AssertionError(f"phase 14 (b): the stale tiles were not rebuilt ({stale})")
    if (out["stale_vs_uninterrupted"] != 0.0
            or stale["best_metrics"] != out["runs"]["card"]["best_metrics"]):
        raise AssertionError("phase 14 (b): the rebuilt resume differs")
    budget = run("max_host_mb", "gpu", "--max-host-mb", str(SPILL_HOST_MB))
    out["max_host_mb"] = {key: budget[key] for key in (
        "stream_chunks", "spilled", "host_estimate_bytes", "disk_bytes", "cache_evictions")}
    out["max_host_mb"]["mb"] = SPILL_HOST_MB
    log(f"  (b) --max-host-mb {SPILL_HOST_MB:g}: {out['max_host_mb']}")
    if not (budget["stream_chunks"] and budget["spilled"] == 1
            and os.path.isdir(os.path.join(budget["dir"], "tile_store"))):
        raise AssertionError("phase 14 (b): --max-host-mb did not turn streaming and "
                             "spilling on")
    return out


def run_spill(dev, game: dict, keep: dict) -> dict:
    """Phase 14, its stores under a temporary directory."""
    root = tempfile.mkdtemp(prefix="phase14-", dir=os.path.dirname(game["avro"]))
    try:
        return {"ooc": run_spill_scenario(dev, keep, os.path.join(root, "a")),
                "cli": run_spill_game(game, keep, os.path.join(root, "b"))}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase14_launches(spill: dict) -> dict:
    """Every hand-written kernel's launches in each phase-14 fit and run."""
    runs = {}
    for name, row in spill["ooc"]["runs"].items():
        for which in ("warm_up", "timed"):
            if f"{which}_launches" in row:
                runs[f"ooc_{name}_{which}"] = row[f"{which}_launches"]
    runs.update({f"train_game_{name}": row["launches"]
                 for name, row in spill["cli"]["runs"].items()})
    return runs

# Phase 15: the self-healing subprocess fleet over TCP, on phase 6's
# ``fused`` model (config 4 at full width), the model phase 8 serves.  (a)
# serve_game --transport tcp --replica-backend subprocess --supervise with
# phase 8 (c)'s traffic, storm and deadline; (b) one child SIGKILLed under
# closed-loop load on a supervised two-child fleet; (c) on that fleet,
# under load, a rollout of phase 8's retrained model, then
# rollout_with_rebuild of it grown past the per-user table's capacity; (d)
# one netfault cell: a partition of FLEET15_PARTITION_S, shorter than the
# lease, that heals with no death declared.
FLEET15_REQUESTS = 600
FLEET15_PROBE_INTERVAL_S = 0.05
FLEET15_PROBE_DEADLINE_S = 1.0
FLEET15_PARTITION_S = 0.6
FLEET15_REJOIN_TIMEOUT_S = 120.0
# New per-user keys for (c): phase 6's 6040 users fill 6041 of the
# 8192-row table, so 2200 more outgrow it and the swap refuses.
FLEET15_NEW_ENTITIES = 2200


def match_served(scores: np.ndarray, oracle: list, tol: float) -> tuple:
    """serve_game's ``scores.txt`` holds the served requests' rows in
    request order: walk it against each request's oracle, taking a request
    as served when its rows come next within ``tol`` and as shed otherwise.
    Returns ``(served, shed, worst, rows_left)``: every request is one or
    the other exactly once when ``rows_left`` is 0 and the counts are the
    summary's."""
    pos, served, shed, worst = 0, 0, 0, 0.0
    for want in oracle:
        got = scores[pos:pos + len(want)]
        gap = float(np.abs(got - want).max()) if len(got) == len(want) else np.inf
        if gap <= tol:
            served += 1
            worst = max(worst, gap)
            pos += len(want)
        else:
            shed += 1
    return served, shed, worst, len(scores) - pos


def card_used_bytes(dev) -> int | None:
    """Bytes in use on the card by every process (``torch.cuda.mem_get_info``);
    None off the card."""
    if dev.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    return int(total - free)


def log_children(tag: str, children: list) -> None:
    for c in children:
        log(f"  {tag} child {c['replica']} (pid {c['pid']}) on {c['device']}: spawn "
            f"{c['spawn_s']:.2f} s (warmup {c['warmup_s']:.2f} s), captures "
            f"{c['captures_at_warmup']} -> {c['captures']}, allocator segments "
            f"{c['segments_at_warmup']} -> {c['segments']}, host syncs "
            f"{c['host_syncs']:.0f} for {c['batches']:.0f} batches, reserved "
            f"{c['memory_reserved']:,} bytes, peak allocated "
            f"{c['max_memory_allocated']:,} bytes")


def run_fleet_serve_game(game: dict, inproc: dict) -> dict:
    """(a): serve_game over TCP with two supervised subprocess replicas on
    phase 8 (c)'s traffic; every request served or shed once, the served
    scores within PARITY_TOL["f32"] of the host oracle, each child on the
    card with no capture, no allocator segment after warmup and one host
    sync a batch."""
    from photon_tpu_torch.drivers import serve_game
    from photon_tpu_torch.drivers.train_game import _load_game_data
    from photon_tpu_torch.game.lowp import PARITY_TOL
    from photon_tpu_torch.game.model_io import load_game_model
    from photon_tpu_torch.serving import generate_traffic, host_score_request

    model_dir = os.path.join(game["run_dirs"]["fused"], "best_model")
    out_dir = os.path.join(os.path.dirname(game["avro"]), "served_tcp")
    args = serve_game.build_parser().parse_args([
        "--model", model_dir, "--input", game["avro"], *GAME_BAGS,
        "--requests", str(FLEET_REQUESTS), "--clients", str(SERVING_CLIENTS),
        "--replicas", "2", "--traffic", "powerlaw", "--storm-frac", "0.1",
        "--deadline-ms", str(FLEET_DEADLINE_MS), "--max-batch", str(SERVING_MAX_BATCH),
        "--max-delay-ms", "1", "--transport", "tcp", "--replica-backend", "subprocess",
        "--supervise", "--probe-interval-ms", "100", "--backend", "gpu",
        "--output-dir", out_dir])
    t0 = time.monotonic()
    summary = serve_game.run(args)
    summary["run_s"] = time.monotonic() - t0
    host, maps = load_game_model(model_dir, device="cpu")
    data, _ = _load_game_data(args.input, args, index_maps=maps)
    items = generate_traffic(data, host, serve_game.traffic_spec(args)).items
    oracle = [host_score_request(host, item.request) for item in items]
    scores = np.atleast_1d(np.loadtxt(os.path.join(out_dir, "scores.txt")))
    served, shed, worst, left = match_served(scores, oracle, PARITY_TOL["f32"])
    summary.update(matched_served=served, matched_shed=shed, worst_parity=worst)
    log(f"  (a) serve_game --transport tcp --replica-backend subprocess --supervise: "
        f"{summary['served']}/{summary['requests']} served, {summary['shed']} shed "
        f"(matched {served} served and {shed} shed against the host oracle, worst "
        f"|delta| {worst:.3e}, tolerance {PARITY_TOL['f32']:g}), {summary['qps']} "
        f"requests/s, p50 {summary['latency_p50_ms']} ms, p99 "
        f"{summary['latency_p99_ms']} ms; in-process thread fleet (phase 8 (c), this "
        f"call): {inproc['qps']} requests/s, p50 {inproc['latency_p50_ms']} ms, p99 "
        f"{inproc['latency_p99_ms']} ms; deaths {summary['replica_deaths']}, run "
        f"{summary['run_s']:.2f} s")
    log_children("(a)", summary["children"])
    if left or served != summary["served"] or shed != summary["shed"] or not served:
        raise AssertionError(f"serve_game tcp: requests not served or shed exactly once "
                             f"({served} served, {shed} shed, {left} rows left)")
    if summary["served"] + summary["shed"] != FLEET_REQUESTS or not summary["supervised"]:
        raise AssertionError("serve_game tcp: requests lost or the fleet unsupervised")
    if len(summary["children"]) != 2 or summary["replica_deaths"]:
        raise AssertionError("serve_game tcp: a child died in a healthy run")
    for c in summary["children"]:
        if not str(c["device"]).startswith("cuda"):
            raise AssertionError(f"serve_game tcp: child {c['replica']} on {c['device']}")
        if c["captures"] != c["captures_at_warmup"] or c["segments"] != c["segments_at_warmup"]:
            raise AssertionError(f"serve_game tcp: child {c['replica']} captured or "
                                 "allocated a segment after warmup")
        if c["host_syncs"] != c["batches"] or not c["batches"]:
            raise AssertionError(f"serve_game tcp: child {c['replica']} host syncs "
                                 f"{c['host_syncs']} for {c['batches']} batches")
    return summary


def supervisor_timeline(session, replica: str) -> list:
    steps = [(m["value"], m["labels"].get("phase"))
             for m in session.registry.snapshot()["gauges"]
             if m["name"] == "serving.supervisor_step" and m["labels"].get("replica") == replica]
    return [phase for _, phase in sorted(steps)]


def new_user_keys(model) -> np.ndarray:
    """FLEET15_NEW_ENTITIES keys past ``model``'s per-user vocabulary, of
    its key type."""
    keys = np.asarray(model.coordinates["per_user"].keys)
    if keys.dtype.kind in "iu":
        return keys.max() + 1 + np.arange(FLEET15_NEW_ENTITIES, dtype=keys.dtype)
    return np.asarray([f"new-user-{i:05d}" for i in range(FLEET15_NEW_ENTITIES)])


def grown_model(model, new_keys: np.ndarray):
    """``model`` with ``new_keys`` as new per-user entities, their rows
    drawn from a seed: the vocabulary outgrows its serving table's
    capacity, and a request for a new user tells the grown model apart."""
    import dataclasses

    from photon_tpu_torch.game.data import entity_index_for

    coord = model.coordinates["per_user"]
    grown = coord.with_entities(np.unique(np.concatenate([np.asarray(coord.keys), new_keys])))
    rows = torch.as_tensor(entity_index_for(new_keys, grown.keys),
                           device=grown.table.device).long()
    values = np.random.default_rng(15).normal(0.0, 0.5, (len(rows), grown.dim))
    table = grown.table.clone()
    table[rows] = torch.as_tensor(values, dtype=table.dtype, device=table.device)
    grown = dataclasses.replace(grown, table=table)
    return dataclasses.replace(model, coordinates={**model.coordinates, "per_user": grown})


def with_new_users(request, new_keys: np.ndarray):
    """``request`` with its users replaced by ``new_keys``."""
    import dataclasses

    users = new_keys[np.arange(request.num_rows) % len(new_keys)]
    return dataclasses.replace(request, entity_ids={**request.entity_ids, "userId": users})


def fleet_load(fleet, items: list, until: threading.Event) -> tuple:
    """Closed loops of SERVING_CLIENTS clients over ``items`` on a thread,
    pass after pass until ``until`` is set; returns ``(thread, result)``:
    ``result`` gets every pass's ``outcomes``, the loops' ``wall`` and the
    ``passes``."""
    from photon_tpu_torch.serving import run_closed_loop_outcomes

    result: dict = {"outcomes": [], "wall": 0.0, "passes": 0}

    def drive():
        while True:
            outcomes, wall = run_closed_loop_outcomes(
                lambda tid: (lambda item: fleet.score(item.request)), items,
                clients=SERVING_CLIENTS)
            result["outcomes"].extend(outcomes)
            result["wall"] += wall
            result["passes"] += 1
            if until.is_set():
                return

    thread = threading.Thread(target=drive)
    thread.start()
    return thread, result


def wait_admitted(session, target: float, thread) -> None:
    admitted = session.registry.counter("serving.admitted")
    while admitted.value < target and thread.is_alive():
        time.sleep(0.001)


def rewire(replica) -> None:
    """Close a child replica's sockets: its next exchange redials through
    ``maybe_shim``, so an installed (or cleared) fault plan takes effect."""
    for chan in ("_data", "_ctrl"):
        try:
            getattr(replica.scorer, chan).close()
        except OSError:
            pass


def run_fleet_chaos(game: dict, dev, observe=None) -> dict:
    """(b)-(d) on one supervised two-child fleet on the card, then
    ``observe`` on it (see :func:`run_subprocess_fleet`)."""
    import argparse

    from photon_tpu_torch.drivers.train_game import _load_game_data
    from photon_tpu_torch.game.lowp import PARITY_TOL
    from photon_tpu_torch.game.model_io import load_game_model
    from photon_tpu_torch.serving import (
        ServingFleet,
        SupervisorPolicy,
        TrafficSpec,
        generate_traffic,
        host_score_request,
        request_spec_for_dataset,
    )
    from photon_tpu_torch.serving.netfault import NetFaultPlan, partition, set_net_plan
    from photon_tpu_torch.telemetry import TelemetrySession

    model_dir = os.path.join(game["run_dirs"]["fused"], "best_model")
    retrained = os.path.join(os.path.dirname(game["avro"]), "retrained", "best_model")
    if not os.path.isdir(retrained):
        retrained = retrain(game)
    old, maps = load_game_model(model_dir, device=dev)
    old_host, _ = load_game_model(model_dir, device="cpu")
    new, _ = load_game_model(retrained, device=dev)
    new_host, _ = load_game_model(retrained, device="cpu")
    args = argparse.Namespace(feature_bags=GAME_BAGS[1], id_columns=GAME_BAGS[3])
    data, _ = _load_game_data(game["avro"], args, index_maps=maps)

    def traffic(seed: int) -> list:
        return generate_traffic(data, old_host, TrafficSpec(
            requests=FLEET15_REQUESTS, mean_rows=SERVING_MEAN_ROWS,
            max_rows=SERVING_MAX_BATCH, storm_frac=0.1, seed=seed)).items

    session = TelemetrySession("fleet15")
    used0 = card_used_bytes(dev)
    t0 = time.monotonic()
    fleet = ServingFleet(old, replicas=2, device=dev, backend="subprocess",
                         request_spec=request_spec_for_dataset(old, data),
                         max_batch=SERVING_MAX_BATCH, max_delay_s=0.001,
                         telemetry=session).warmup()
    out = {"fleet_spawn_s": time.monotonic() - t0}
    used1 = card_used_bytes(dev)
    out["children_card_bytes"] = None if used0 is None else used1 - used0
    log(f"  (b) two children spawned side by side and warm in {out['fleet_spawn_s']:.2f} s; "
        f"the card's used bytes grew by {out['children_card_bytes']} (mem_get_info before "
        f"and after their start: two CUDA contexts, graph pools and tables)")
    sup = fleet.supervise(SupervisorPolicy(
        probe_interval_s=FLEET15_PROBE_INTERVAL_S, probe_deadline_s=FLEET15_PROBE_DEADLINE_S,
        respawn_base_s=0.0, respawn_jitter=0.0))
    try:
        out["crash"] = fleet_crash(fleet, session, traffic(2), old_host, PARITY_TOL["f32"])
        out["rollout"] = fleet_rollout(fleet, session, traffic(3), (old_host, new, new_host))
        sup.stop()
        out["netfault"] = fleet_partition(fleet, sup, session, traffic(4)[:20],
                                          new_host, NetFaultPlan, partition, set_net_plan)
        if observe is not None:
            # The fleet serves (c)'s grown model now.
            grown_host = grown_model(new_host, new_user_keys(new_host))
            out["observe"] = observe(fleet, sup, session,
                                     [item.request for seed in (5, 6)
                                      for item in traffic(seed)], grown_host)
    finally:
        set_net_plan(None)
        fleet.close()
    # Every child the fleet ran: those it let go (the killed one, those a
    # rebuild retired), each at its last stats pull, and those it closed.
    out["children"] = [c for r in fleet.replicas
                       for c in (*r.retired_children, r.child_report())]
    log_children("(b)-(d)", out["children"])
    # Every child of (b)-(d) holds its warmup's allocator segments to its
    # last stats pull: the two that took (c)'s rollout swap among them
    # (the swap's allocations are staged at warmup).
    grown = [c for c in out["children"] if c["segments"] != c["segments_at_warmup"]]
    if grown:
        raise AssertionError("fleet: a child allocated a segment after warmup: "
                             + ", ".join(f"{c['replica']} (pid {c['pid']}) "
                                         f"{c['segments_at_warmup']} -> {c['segments']}"
                                         for c in grown))
    return out


def fleet_crash(fleet, session, items, host_model, tol) -> dict:
    """(b): SIGKILL child r0 a third of the way into a closed loop; every
    request answered once within ``tol`` of the host oracle, the death
    declared, the child respawned, its rejoin probe passed and readmitted."""
    import signal

    from photon_tpu_torch.serving import host_score_request

    r0 = fleet.replicas[0]
    done = threading.Event()
    thread, result = fleet_load(fleet, items, done)
    wait_admitted(session, len(items) // 3, thread)
    pid = r0.child_pid
    r0.pull_stats()  # the child's counts, kernel launches among them, before it dies
    t_kill = time.monotonic()
    os.kill(pid, signal.SIGKILL)
    declared = rejoined = None
    while time.monotonic() - t_kill < FLEET15_REJOIN_TIMEOUT_S:
        if declared is None and not r0.alive:
            declared = time.monotonic()
        if declared is not None and r0.alive:
            rejoined = time.monotonic()
            break
        time.sleep(0.002)
    done.set()
    thread.join(timeout=600)
    if thread.is_alive() or rejoined is None:
        raise AssertionError("fleet crash: the traffic or the rejoin did not finish")
    oracle = {id(item): host_score_request(host_model, item.request) for item in items}
    worst = 0.0
    for o in result["outcomes"]:
        if o.status != "ok":
            raise AssertionError(f"fleet crash: a request failed ({o.status}: {o.reason})")
        worst = max(worst, float(np.abs(o.scores - oracle[id(o.item)]).max()))
    timeline = supervisor_timeline(session, "r0")
    out = {
        "requests": len(result["outcomes"]), "passes": result["passes"],
        "wall_s": result["wall"],
        "worst_parity": worst, "killed_pid": pid, "new_pid": r0.child_pid,
        "declared_after_s": declared - t_kill, "rejoined_after_s": rejoined - t_kill,
        "rerouted": counter_total_labeled(session, "serving.rerouted", replica="r0"),
        "deaths": counter_total_labeled(session, "serving.replica_deaths", replica="r0"),
        "resurrections": counter_total_labeled(session, "serving.replica_resurrections",
                                               replica="r0"),
        "timeline": timeline, "respawn": r0.child_report(),
    }
    log(f"  (b) SIGKILL of child r0 (pid {pid}) a third into a closed loop of "
        f"{len(items)}-request passes ({out['requests']} requests in {out['passes']}): "
        f"every request answered once (worst |delta| {worst:.3e}), {out['rerouted']:.0f} "
        f"rerouted, death declared after {out['declared_after_s']:.3f} s, rejoined after "
        f"{out['rejoined_after_s']:.2f} s (respawn {out['respawn']['spawn_s']:.2f} s) as pid "
        f"{out['new_pid']}; timeline {timeline}; deaths {out['deaths']:.0f}, "
        f"resurrections {out['resurrections']:.0f}; loop {out['wall_s']:.2f} s")
    if worst > tol or out["deaths"] != 1 or out["resurrections"] != 1:
        raise AssertionError("fleet crash: parity, or not one death and one resurrection")
    # A ping can reach the dead child before its exit code does: a lease
    # miss may come first.
    steps = [phase for phase in timeline if phase != "lease-miss"]
    if steps != ["died-crash", "respawn", "rejoin-probe", "rejoined"] or pid == r0.child_pid:
        raise AssertionError(f"fleet crash: timeline {timeline}")
    return out


def fleet_rollout(fleet, session, items, models) -> dict:
    """(c): under a closed loop, a rollout of the retrained model (the
    canary held to its host oracle), then rollout_with_rebuild of it grown
    past the per-user table's capacity (two new children at twice the
    capacity).  No request lost; every response wholly one model's; the
    tail the grown model's."""
    from photon_tpu_torch.serving import host_score_request

    old_host, new, new_host = models
    new_keys = new_user_keys(new_host)
    grown, grown_host = grown_model(new, new_keys), grown_model(new_host, new_keys)
    done = threading.Event()
    thread, result = fleet_load(fleet, items, done)
    wait_admitted(session, session.registry.counter("serving.admitted").value
                  + len(items) // 4, thread)
    t0 = time.monotonic()
    fleet.rollout(new, probe_oracle=lambda req: host_score_request(new_host, req))
    rollout_s = time.monotonic() - t0
    pids = [r.child_pid for r in fleet.replicas]
    t0 = time.monotonic()
    rebuilt = fleet.rollout_with_rebuild(grown)
    rebuild_s = time.monotonic() - t0
    done.set()
    thread.join(timeout=600)
    if thread.is_alive():
        raise AssertionError("fleet rollout: the traffic did not finish")
    oracles = {name: {id(item): host_score_request(m, item.request) for item in items}
               for name, m in (("old", old_host), ("new", new_host), ("grown", grown_host))}
    verdicts = []
    for o in result["outcomes"]:
        if o.status != "ok":
            raise AssertionError(f"fleet rollout: a request failed ({o.status}: {o.reason})")
        hits = [name for name, oracle in oracles.items()
                if np.allclose(o.scores, oracle[id(o.item)], rtol=0, atol=ROLLOUT_ATOL)]
        if not hits:
            raise AssertionError("fleet rollout: a response matches no model")
        verdicts.append(hits)
    counts: dict = {}
    for hits in verdicts:
        counts["/".join(hits)] = counts.get("/".join(hits), 0) + 1
    # The old, new and grown models agree on known users; new users tell
    # the grown model's rows apart.
    probe = with_new_users(items[0].request, new_keys)
    grown_gap = float(np.abs(fleet.score(probe) - host_score_request(grown_host, probe)).max())
    new_gap = float(np.abs(host_score_request(new_host, probe)
                           - host_score_request(grown_host, probe)).max())
    out = {"requests": len(verdicts), "passes": result["passes"], "rollout_s": rollout_s,
           "rebuild_s": rebuild_s,
           "rebuilt": rebuilt, "responses": counts, "pids_before_rebuild": pids,
           "pids_after_rebuild": [r.child_pid for r in fleet.replicas],
           "version": fleet.current_model()[1], "new_users_gap": grown_gap,
           "new_users_gap_to_new_model": new_gap,
           "fleet_rebuilds": counter_total(session, "serving.fleet_rebuilds"),
           "rollbacks": counter_total(session, "serving.rollout_rollbacks")}
    log(f"  (c) under {len(verdicts)} requests ({result['passes']} passes): rollout of the "
        f"retrained model "
        f"{rollout_s:.2f} s, then rollout_with_rebuild past the capacity ({FLEET15_NEW_ENTITIES} "
        f"new users) {rebuild_s:.2f} s (rebuilt {rebuilt}, children {pids} -> "
        f"{out['pids_after_rebuild']}); none lost; responses {counts}; fleet version "
        f"{out['version']}, rollbacks {out['rollbacks']:.0f}; new users against the grown "
        f"model's oracle |delta| {grown_gap:.3e} (the retrained model's oracle is "
        f"{new_gap:.3e} away)")
    # The last pass ends after the cutover: its last response is the grown
    # model's.
    if not rebuilt or "grown" not in verdicts[-1] or out["rollbacks"]:
        raise AssertionError("fleet rollout: the rebuild did not land the grown model")
    if grown_gap > ROLLOUT_ATOL or new_gap <= ROLLOUT_ATOL:
        raise AssertionError("fleet rollout: the fleet does not serve the grown rows")
    if fleet.current_model()[0] is not grown or set(pids) & set(out["pids_after_rebuild"]):
        raise AssertionError("fleet rollout: the fleet does not serve the rebuilt children")
    return out


def fleet_partition(fleet, sup, session, requests, host_model, NetFaultPlan, partition,
                    set_net_plan) -> dict:
    """(d): a partition of both of r0's links, FLEET15_PARTITION_S long and
    shorter than the lease: the supervisor counts a lease miss and declares
    no death; requests sent into the partition are answered after it
    heals."""
    from photon_tpu_torch.serving import host_score_request

    r0 = fleet.replicas[0]
    deaths0 = counter_total(session, "serving.replica_deaths")
    misses0 = counter_total(session, "serving.lease_probe_misses")
    sup.check_once()
    plan = NetFaultPlan([partition("r0:*", 0.0, FLEET15_PARTITION_S)], seed=21)
    r0.scorer.exchange_timeout_s = 0.25
    set_net_plan(plan)
    rewire(r0)
    t0 = time.monotonic()
    futures = [r0.submit(item.request) for item in requests]
    sup.check_once()
    alive_in_partition = r0.alive
    got = [f.result(timeout=60) for f in futures]
    answered_s = time.monotonic() - t0
    time.sleep(max(0.0, FLEET15_PARTITION_S - (time.monotonic() - t0)))
    sup.check_once()
    set_net_plan(None)
    rewire(r0)
    worst = max(float(np.abs(g - host_score_request(host_model, item.request)).max())
                for g, item in zip(got, requests))
    out = {"partition_s": FLEET15_PARTITION_S, "alive_in_partition": alive_in_partition,
           "alive_after": r0.alive, "answered_after_s": answered_s, "worst_parity": worst,
           "lease_misses": counter_total(session, "serving.lease_probe_misses") - misses0,
           "deaths": counter_total(session, "serving.replica_deaths") - deaths0,
           "partitioned_frames": plan.total("partitioned"),
           "resends": counter_total(session, "serving.exchange_resends")}
    log(f"  (d) partition of r0 for {FLEET15_PARTITION_S} s: {out['lease_misses']:.0f} lease "
        f"miss(es), {out['deaths']:.0f} deaths, {out['partitioned_frames']} frames "
        f"black-holed, {out['resends']:.0f} exchange resends; {len(requests)} requests "
        f"sent into it answered after {answered_s:.2f} s (worst |delta| {worst:.3e})")
    if out["deaths"] or not alive_in_partition or not r0.alive or not out["lease_misses"]:
        raise AssertionError("fleet partition: a death declared, or no lease miss counted")
    if worst > ROLLOUT_ATOL or not out["partitioned_frames"]:
        raise AssertionError("fleet partition: parity, or nothing was partitioned")
    return out


def fleet_kernel_launches(fleet15: dict, parent: dict) -> dict:
    """Phase 15's launches of every kernel, gated at 0: this process's
    (``parent``: its counts set to 0 just before the phase and read before
    phase 16 (b) sets them to 0 again) plus every child's.  The scoring
    runs in the children; each starts its counts at 0 and reports them in
    its stats frame, read here at its last pull (a retired child's after
    its drain, the killed child's just before the kill, the others' at the
    fleet's close, after phase 16 (b)-(c))."""
    counts = dict(parent)
    children = fleet15["serve_game"]["children"] + fleet15["children"]
    for c in children:
        if c["kernel_launches"] is None:
            raise AssertionError(f"phase 15: child {c['replica']} (pid {c['pid']}) "
                                 "reported no kernel counts")
        for name, n in c["kernel_launches"].items():
            counts[name] = counts.get(name, 0) + n
    launched = {k: v for k, v in counts.items() if v}
    log(f"  phase 15 launched {launched or 'no hand-written kernel'} in this process and "
        f"its {len(children)} children (pids {[c['pid'] for c in children]}), each "
        "child's counts from its last stats frame")
    if launched:
        raise AssertionError(f"phase 15: the serving fleet launched kernels: {launched}")
    return counts


def observe_kernel_launches(observe16: dict) -> dict:
    """Phase 16's launches of every kernel, gated at 0: this process's
    (its counts set to 0 just before (b)) plus each child's over (b)-(c),
    its stats frame before (b) subtracted from its frame before the kill
    (the killed child's last frame)."""
    from photon_tpu_torch.ops import launch_counts

    counts = launch_counts()
    for rid, child in observe16["tcp"]["children"].items():
        for name, n in child["kernel_launches"].items():
            counts[name] = counts.get(name, 0) + n
    launched = {k: v for k, v in counts.items() if v}
    log(f"  phase 16 launched {launched or 'no hand-written kernel'} in this process and "
        f"its children {sorted(observe16['tcp']['children'])}")
    if launched:
        raise AssertionError(f"phase 16: the observed fleet launched kernels: {launched}")
    return counts


def run_subprocess_fleet(game: dict, serving: dict, dev, observe=None) -> dict:
    """Phase 15: (a) serve_game over TCP with subprocess replicas, (b)-(d)
    a crash, a rollout and rebuild, and a partition on one fleet; then
    ``observe(fleet, sup, session, requests, oracle)`` on that fleet before
    it closes (phase 16 (b)-(c))."""
    out = {"serve_game": run_fleet_serve_game(game, serving["serve_game"])}
    out.update(run_fleet_chaos(game, dev, observe))
    return out


# Phase 16: the fleet observability plane (serving/observe.py) on the card.
# (a) a two-replica thread fleet on phase 6's ``fused`` model (the model
# phase 8 serves) under phase 8 (c)'s traffic, storm and deadline, in
# OBSERVE_TURNS turns of each variant of OBSERVE_RATES: no observer, an
# observer sampling 1% of requests, one tracing every request; (b) phase
# 15's supervised two-child fleet after (d), behind ``fleet.serve()``,
# observed at sample_rate 1.0 through an ``AsyncScoringClient(observer=)``:
# untraced and traced TCP turns in turns, every traced request's critical
# path split into the six stages, then one child SIGKILLed under traced
# load; (c) that fleet's HTTP plane and the console, before the kill.
OBSERVE_TURNS = 3
OBSERVE_RATES = (None, 0.01, 1.0)
OBSERVE_TCP_TURNS = 3  # of each variant, untraced and traced
OBSERVE_TCP_REQUESTS = 100  # a TCP turn's requests
OBSERVE_KILL_REQUESTS = 300
OBSERVE_IN_FLIGHT = SERVING_CLIENTS  # requests the TCP client keeps outstanding
OBSERVE_TRACE_CAPACITY = 4096
# A critical path's stage sum against its total, and its total against the
# caller's wall time (tests/test_observe.py:305-306).
RECONCILE_S = 1e-6
WALL_SLACK_S = 0.05


def fresh_requests(requests: list) -> list:
    """New request objects for a turn: a traced request carries its span
    and trace context as attributes (the batcher stamps the context onto a
    batch of one), so a request object sent again would continue its old
    trace rather than be sampled anew."""
    import dataclasses

    return [dataclasses.replace(r) for r in requests]


def stage_stats(paths: list) -> dict:
    """Median and p90 seconds of each critical-path stage over ``paths``."""
    from photon_tpu_torch.telemetry.distributed import STAGES

    out = {}
    for stage in STAGES:
        values = np.array([next(s["duration_s"] for s in cp["stages"]
                                if s["stage"] == stage) for cp in paths])
        out[stage] = {"p50_s": float(np.median(values)),
                      "p90_s": float(np.quantile(values, 0.9))}
    return out


def reconciled(tag: str, cp: dict, wall_s: float) -> None:
    """Gate one critical path: its stages sum to its total, and the total
    fits the caller's wall time."""
    if cp is None or abs(cp["stage_sum_s"] - cp["total_s"]) > RECONCILE_S:
        raise AssertionError(f"{tag}: a critical path does not reconcile ({cp})")
    if cp["total_s"] > wall_s + WALL_SLACK_S:
        raise AssertionError(f"{tag}: a critical path of {cp['total_s']:.6f} s outlasts "
                             f"its request's {wall_s:.6f} s")


def no_orphans(tag: str, collector) -> None:
    """Every kept trace is one tree: one root, every parent present."""
    for tid in collector.trace_ids():
        spans = collector.trace(tid)
        ids = {d["span_id"] for d in spans}
        roots = [d for d in spans if d.get("parent_id") is None]
        orphans = [d["name"] for d in spans
                   if d.get("parent_id") is not None and d["parent_id"] not in ids]
        if len(roots) != 1 or orphans:
            raise AssertionError(f"{tag}: trace {tid} has {len(roots)} roots and "
                                 f"orphans {orphans}")


def thread_turn(fleet, observer, requests: list) -> dict:
    """One closed loop of SERVING_CLIENTS clients over ``requests`` with
    ``observer`` on the router's hook (None: the unobserved path)."""
    from photon_tpu_torch.serving import run_closed_loop_outcomes

    fleet.router.observer = observer
    try:
        outcomes, wall = run_closed_loop_outcomes(
            lambda tid: (lambda req: fleet.score(req, deadline_s=FLEET_DEADLINE_MS / 1e3)),
            requests, clients=SERVING_CLIENTS)
    finally:
        fleet.router.observer = None
    latencies = np.array([o.latency_s for o in outcomes if o.status == "ok"])
    bad = [o for o in outcomes if o.status not in ("ok", "shed")]
    if bad:
        raise AssertionError(f"phase 16 (a): a request failed ({bad[0].reason})")
    return {"outcomes": outcomes, "wall_s": wall, "ok": int(len(latencies)),
            "shed": len(outcomes) - int(len(latencies)),
            "qps": len(latencies) / wall,
            "p50_ms": float(np.percentile(latencies, 50)) * 1e3,
            "p99_ms": float(np.percentile(latencies, 99)) * 1e3}


def gate_thread_traces(fleet, observer, requests: list, turn: dict) -> dict:
    """(a)'s gates on a turn traced at 1.0: one merged trace per admitted
    request and no other, each critical path reconciled, each shed
    request's trace carrying its shed event, each served root span the
    served model version; plus one request shed at arrival (a deadline of
    0) whose trace must carry it."""
    from photon_tpu_torch.serving import RequestShedError
    from photon_tpu_torch.telemetry.distributed import span_of

    collector = observer.collector
    version = fleet.current_model()[1]
    tids = set()
    paths = []
    for req, o in zip(requests, turn["outcomes"]):
        span = span_of(req)
        if span is None:
            raise AssertionError("phase 16 (a): a request at sample rate 1.0 was not traced")
        tids.add(span.trace_id)
        (root,) = [d for d in collector.trace(span.trace_id) if d.get("parent_id") is None]
        events = {e["name"]: e for e in root["events"]}
        if o.status == "shed":
            if root["status"] != "shed" or events.get("shed", {}).get("reason") != o.reason:
                raise AssertionError(f"phase 16 (a): a shed request's trace lacks its shed "
                                     f"event ({root['status']}, {o.reason})")
            continue
        if root["status"] != "ok" or root["attrs"].get("version") != version:
            raise AssertionError(f"phase 16 (a): a served root span without the served "
                                 f"version {version}: {root['status']}, {root['attrs']}")
        cp = collector.critical_path(span.trace_id)
        reconciled("phase 16 (a)", cp, o.latency_s)
        paths.append(cp)
    forced = fresh_requests(requests[:1])[0]
    fleet.router.observer = observer
    try:
        fleet.submit(forced, deadline_s=0.0)
    except RequestShedError:
        pass
    else:
        raise AssertionError("phase 16 (a): a request past its deadline was admitted")
    finally:
        fleet.router.observer = None
    shed = span_of(forced)
    shed_events = [e for e in shed.events if e["name"] == "shed"]
    if shed.status != "shed" or [e["reason"] for e in shed_events] != ["deadline"]:
        raise AssertionError("phase 16 (a): the deadline shed's trace lacks its event")
    kept = set(collector.trace_ids())
    if len(tids) != len(requests) or kept != tids | {shed.trace_id}:
        raise AssertionError(f"phase 16 (a): {len(tids)} traces for {len(requests)} "
                             f"requests, {len(kept)} kept")
    no_orphans("phase 16 (a)", collector)
    return {"traces": len(kept), "paths": len(paths), "stages": stage_stats(paths)}


def run_observe_threads(game: dict, dev) -> dict:
    """(a): the observer's cost on the thread fleet, in turns, and its
    gates at sample_rate 1.0; the whole loop under the sync guard, with no
    capture and no allocator segment after warmup."""
    from photon_tpu_torch.data.game_io import read_game_avro
    from photon_tpu_torch.game.model_io import load_game_model
    from photon_tpu_torch.serving import (
        FleetObserver,
        ObservePolicy,
        ServingFleet,
        TrafficSpec,
        generate_traffic,
        request_spec_for_dataset,
    )
    from photon_tpu_torch.telemetry import TelemetrySession

    model, maps = load_game_model(os.path.join(game["run_dirs"]["fused"], "best_model"),
                                  device=dev)
    data, _ = read_game_avro(game["avro"], {"global": "global", "per_user": "per_user"},
                             ["userId", "itemId"], index_maps=maps)
    items = generate_traffic(data, model, TrafficSpec(
        requests=ROLLOUT_REQUESTS, mean_rows=SERVING_MEAN_ROWS,
        max_rows=SERVING_MAX_BATCH, storm_frac=0.1, seed=1)).items
    requests = [item.request for item in items]
    session = TelemetrySession("observe16")
    fleet = ServingFleet(model, replicas=2, device=dev,
                         request_spec=request_spec_for_dataset(model, data),
                         max_batch=SERVING_MAX_BATCH, max_delay_s=0.001,
                         telemetry=session).warmup()
    captures, segments = fleet.compilations, allocator_segments(dev)
    turns = {rate: [] for rate in OBSERVE_RATES}
    gates = []
    try:
        with no_stray_syncs():
            for _ in range(OBSERVE_TURNS):
                for rate in OBSERVE_RATES:
                    observer = None if rate is None else FleetObserver(
                        fleet=fleet, policy=ObservePolicy(
                            sample_rate=rate, trace_capacity=OBSERVE_TRACE_CAPACITY))
                    turn_requests = fresh_requests(requests)
                    turn = thread_turn(fleet, observer, turn_requests)
                    turn["traces"] = 0 if observer is None else len(
                        observer.collector.trace_ids())
                    if rate == 1.0:
                        gates.append(gate_thread_traces(fleet, observer, turn_requests, turn))
                    del turn["outcomes"]
                    turns[rate].append(turn)
    finally:
        fleet.close()
    out = {"turns": {str(rate): rows for rate, rows in turns.items()},
           "captures": [captures, fleet.compilations],
           "segments": [segments, allocator_segments(dev)],
           "host_syncs": counter_total(session, "serving.host_syncs"),
           "batches": counter_total(session, "serving.batches"),
           "traced_stages": gates[-1]["stages"]}
    medians = {}
    for rate, rows in turns.items():
        medians[str(rate)] = {key: float(np.median([r[key] for r in rows]))
                              for key in ("qps", "p50_ms", "p99_ms")}
        medians[str(rate)]["traces"] = [r["traces"] for r in rows]
        medians[str(rate)]["shed"] = [r["shed"] for r in rows]
        m = medians[str(rate)]
        label = "no observer" if rate is None else f"observer at sample_rate {rate:g}"
        log(f"  (a) thread fleet, {label}: median of {OBSERVE_TURNS} turns "
            f"{m['qps']:.2f} requests/s, p50 {m['p50_ms']:.3f} ms, p99 {m['p99_ms']:.3f} ms; "
            f"shed {m['shed']}, traces kept {m['traces']}")
    out["medians"] = medians
    base = medians["None"]["qps"]
    log(f"  (a) requests/s against no observer: 0.01 {medians['0.01']['qps'] / base:.3f}x, "
        f"1.0 {medians['1.0']['qps'] / base:.3f}x; captures {captures} -> "
        f"{fleet.compilations}, allocator segments {segments} -> {out['segments'][1]}, host "
        f"syncs {out['host_syncs']:.0f} for {out['batches']:.0f} batches, no other sync")
    log(f"  (a) at 1.0, every turn: one trace per request ({[g['traces'] for g in gates]} "
        f"kept with the deadline shed), every path reconciled; stages (p50 / p90 ms) "
        + ", ".join(f"{k} {v['p50_s'] * 1e3:.3f} / {v['p90_s'] * 1e3:.3f}"
                    for k, v in out["traced_stages"].items()))
    if fleet.compilations != captures or out["segments"][0] != out["segments"][1]:
        raise AssertionError("phase 16 (a): captured or allocated a segment after warmup")
    if out["host_syncs"] != out["batches"] or not out["batches"]:
        raise AssertionError("phase 16 (a): host syncs != batches")
    if any(t != 0 for t in medians["None"]["traces"]):
        raise AssertionError("phase 16 (a): the unobserved path traced")
    return out


def child_snapshots(fleet) -> dict:
    """Each live child's stats pulled now (``child_report``), after a ping
    (which redials a control connection (d)'s rewiring closed)."""
    out = {}
    for r in fleet.replicas:
        if r.alive:
            r.ping(5.0)
            r.pull_stats()
            out[r.replica_id] = r.child_report()
    return out


def tcp_load(client, requests: list) -> dict:
    """Send ``requests`` through the async client, OBSERVE_IN_FLIGHT of them
    outstanding at a time; each request's scores (or error) and its
    send-to-answer seconds."""
    slots = threading.Semaphore(OBSERVE_IN_FLIGHT)
    sent = [0.0] * len(requests)
    done = [0.0] * len(requests)
    futures = []
    t0 = time.monotonic()
    for i, req in enumerate(requests):
        slots.acquire()
        sent[i] = time.monotonic()
        fut = client.submit(req)

        def settle(f, i=i):
            done[i] = time.monotonic()
            slots.release()

        fut.add_done_callback(settle)
        futures.append(fut)
    results = []
    for fut in futures:
        try:
            results.append(fut.result(timeout=120))
        except Exception as e:  # noqa: BLE001 — gated by the caller
            results.append(e)
    wall = time.monotonic() - t0
    latencies = np.array([d - s for d, s in zip(done, sent)])
    return {"results": results, "latencies": latencies, "wall_s": wall,
            "qps": len(requests) / wall,
            "p50_ms": float(np.percentile(latencies, 50)) * 1e3,
            "p99_ms": float(np.percentile(latencies, 99)) * 1e3}


def answered(tag: str, requests: list, load: dict, oracle) -> float:
    """Every request answered once within the f32 gate of ``oracle``."""
    from photon_tpu_torch.game.lowp import PARITY_TOL
    from photon_tpu_torch.serving import host_score_request

    worst = 0.0
    for req, got in zip(requests, load["results"]):
        if isinstance(got, BaseException):
            raise AssertionError(f"{tag}: a request failed ({type(got).__name__}: {got})")
        worst = max(worst, float(np.abs(got - host_score_request(oracle, req)).max()))
    if worst > PARITY_TOL["f32"]:
        raise AssertionError(f"{tag}: served scores {worst:.3e} from the host oracle")
    return worst


def gate_tcp_traces(observer, requests: list, load: dict, parent_pid: int) -> list:
    """(b)'s gates on a traced TCP turn: each request's trace spans the
    client, the router and a child in another process, and its critical
    path reconciles; returns the paths, each with the client span's
    seconds beside it."""
    from photon_tpu_torch.telemetry.distributed import span_of

    collector = observer.collector
    paths = []
    for req, wall in zip(requests, load["latencies"]):
        span = span_of(req)
        if span is None:
            raise AssertionError("phase 16 (b): a request at sample rate 1.0 was not traced")
        processes = collector.processes(span.trace_id)
        kinds = {p.split(":", 1)[0].split("-", 1)[0] for p in processes}
        child_pids = {p.rsplit(":", 1)[-1] for p in processes if p.startswith("replica-")}
        if len(processes) < 3 or not {"client", "router", "replica"} <= kinds \
                or not child_pids or str(parent_pid) in child_pids:
            raise AssertionError(f"phase 16 (b): a trace spans {processes}")
        cp = collector.critical_path(span.trace_id)
        reconciled("phase 16 (b)", cp, float(wall))
        (client_span,) = [d for d in collector.trace(span.trace_id)
                          if d["name"] == "client.request"]
        cp["client_s"] = float(client_span["duration_s"])
        paths.append(cp)
    return paths


def run_observe_tcp(fleet, sup, session, requests: list, oracle, flight_dir: str) -> dict:
    """(b) and (c) on phase 15's fleet after (d): see the phase's comment."""
    import dataclasses
    import signal
    import urllib.request

    from photon_tpu_torch.serving import AsyncScoringClient, ObservePolicy
    from photon_tpu_torch.telemetry.distributed import MergeableHistogram

    t_start = time.monotonic()
    observer = fleet.observe(policy=ObservePolicy(
        sample_rate=1.0, trace_capacity=OBSERVE_TRACE_CAPACITY, http_port=0,
        poll_interval_s=0.1), flight_dir=flight_dir)
    server = fleet.serve()
    clients = {False: AsyncScoringClient(server.address, connections=2, telemetry=session),
               True: AsyncScoringClient(server.address, connections=2, telemetry=session,
                                        observer=observer)}
    out = {"turns": {"untraced": [], "traced": []}}
    try:
        before = child_snapshots(fleet)
        paths = []
        turn = 0
        for _ in range(OBSERVE_TCP_TURNS):
            for traced in (False, True):
                turn_requests = fresh_requests(requests[turn * OBSERVE_TCP_REQUESTS:
                                                        (turn + 1) * OBSERVE_TCP_REQUESTS])
                turn += 1
                fleet.router.observer = observer if traced else None
                load = tcp_load(clients[traced], turn_requests)
                worst = answered("phase 16 (b)", turn_requests, load, oracle)
                if traced:
                    paths.extend(gate_tcp_traces(observer, turn_requests, load, os.getpid()))
                out["turns"]["traced" if traced else "untraced"].append(
                    {k: load[k] for k in ("qps", "p50_ms", "p99_ms")} | {"worst_parity": worst})
        fleet.router.observer = observer
        out["stages"] = stage_stats(paths)
        outside = np.array([cp["client_s"] - cp["total_s"] for cp in paths])
        out["client_outside_router"] = {"p50_s": float(np.median(outside)),
                                        "p90_s": float(np.quantile(outside, 0.9))}
        total = np.array([cp["total_s"] for cp in paths])
        out["router_total"] = {"p50_s": float(np.median(total)),
                               "p90_s": float(np.quantile(total, 0.9))}
        out["traced_requests"] = len(paths)
        out["medians"] = {}
        for variant, rows in out["turns"].items():
            m = {key: float(np.median([r[key] for r in rows]))
                 for key in ("qps", "p50_ms", "p99_ms")}
            out["medians"][variant] = m
            log(f"  (b) over TCP, {variant}, median of {len(rows)} turns of "
                f"{OBSERVE_TCP_REQUESTS}: {m['qps']:.2f} requests/s, p50 {m['p50_ms']:.3f} ms, "
                f"p99 {m['p99_ms']:.3f} ms (turns: "
                + "; ".join(f"{r['qps']:.2f}, {r['p50_ms']:.3f}, {r['p99_ms']:.3f}"
                            for r in rows) + ")")
        log(f"  (b) {len(paths)} traced requests over TCP, each over >= 3 processes, every "
            "path reconciled; stages p50 / p90 ms: "
            + ", ".join(f"{k} {v['p50_s'] * 1e3:.3f} / {v['p90_s'] * 1e3:.3f}"
                        for k, v in out["stages"].items())
            + f"; the router span {out['router_total']['p50_s'] * 1e3:.3f} / "
            f"{out['router_total']['p90_s'] * 1e3:.3f}, the client span beyond it "
            f"{out['client_outside_router']['p50_s'] * 1e3:.3f} / "
            f"{out['client_outside_router']['p90_s'] * 1e3:.3f}")

        # (c) The HTTP plane and the console, both children live.
        child_snapshots(fleet)  # fresh shipped histograms and counters
        observer.poll_once()
        host, port = observer.http_address
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            prom = r.read().decode()
        with urllib.request.urlopen(f"{base}/fleet.json", timeout=10) as r:
            snap = json.loads(r.read().decode())
        console = subprocess.run(
            [sys.executable, "-m", "photon_tpu_torch.telemetry.live", "--url", base, "--once"],
            capture_output=True, text=True, timeout=120)
        rids = [r.replica_id for r in fleet.replicas]
        served = snap["versions"].get(str(fleet.replicas[0].scorer.version), {})
        # Each child's shipped compute histogram, the one the plane merges
        # into the snapshot's ``child_compute``.
        child_p99 = {r.replica_id: MergeableHistogram.merged(
            [h for h in [r.scorer.last_hist_snapshot] if h]).quantile(0.99) for r in fleet.replicas}
        out["http"] = {"metrics_bytes": len(prom), "snapshot": snap,
                       "console_rc": console.returncode, "child_p99_s": child_p99,
                       "children_in_metrics": [rid for rid in rids
                                               if f'replica="{rid}"' in prom]}
        log(f"  (c) /metrics {len(prom):,} bytes naming {out['http']['children_in_metrics']}; "
            f"/fleet.json versions {list(snap['versions'])} (served p99 "
            f"{served.get('p99_s')} s), child compute p99 {snap['child_compute']['p99_s']} s "
            f"over {snap['child_compute']['count']} batches, per child {child_p99}; the "
            f"console (rc {console.returncode}):")
        for line in console.stdout.splitlines():
            log(f"    {line}")
        if console.returncode != 0 or "qps" not in console.stdout:
            raise AssertionError(f"phase 16 (c): the console failed: {console.stderr[-2000:]}")
        if out["http"]["children_in_metrics"] != rids or served.get("p99_s") is None \
                or snap["child_compute"]["p99_s"] is None \
                or any(p is None for p in child_p99.values()):
            raise AssertionError("phase 16 (c): a child is missing from the plane, or no p99")
        after = child_snapshots(fleet)

        # (b) continued: one child SIGKILLed under traced load, supervised.
        victim = fleet.replicas[-1]
        sup.policy = dataclasses.replace(sup.policy, resurrect=False)
        kill_requests = fresh_requests(requests[turn * OBSERVE_TCP_REQUESTS:][
            :OBSERVE_KILL_REQUESTS])
        result: dict = {}
        thread = threading.Thread(target=lambda: result.update(
            tcp_load(clients[True], kill_requests)))
        admitted = session.registry.counter("serving.admitted")
        start = admitted.value
        thread.start()
        while admitted.value < start + len(kill_requests) // 3 and thread.is_alive():
            time.sleep(0.001)
        pid = victim.child_pid
        t_kill = time.monotonic()
        os.kill(pid, signal.SIGKILL)
        while victim.alive and time.monotonic() - t_kill < 30.0:
            sup.check_once()
            time.sleep(0.01)
        declared = time.monotonic() - t_kill
        thread.join(timeout=300)
        if thread.is_alive() or victim.alive:
            raise AssertionError("phase 16 (b): the kill was not declared or the load hung")
        worst = answered("phase 16 (b) kill", kill_requests, result, oracle)
        gate_tcp_traces(observer, kill_requests, result, os.getpid())
        no_orphans("phase 16 (b)", observer.collector)
        dumps = [d for d in observer.flight_dumps if d["replica"] == victim.replica_id]
        if len(dumps) != 1 or not dumps[0]["path"] or not os.path.exists(dumps[0]["path"]):
            raise AssertionError(f"phase 16 (b): no flight dump collected: {dumps}")
        with open(dumps[0]["path"]) as f:
            dump = json.load(f)
        kinds = sorted({r["kind"] for r in (dump.get("child") or {}).get("records", ())})
        lost = [d for tid in observer.collector.trace_ids()
                for d in observer.collector.trace(tid) if d.get("status") == "lost"]
        if not {"frame", "span"} <= set(kinds) or dump["parent"] is None \
                or len(lost) != dumps[0]["lost_spans_recovered"]:
            raise AssertionError(f"phase 16 (b): the dump holds {kinds}; lost stubs "
                                 f"{len(lost)} of {dumps[0]['lost_spans_recovered']}")
        out["kill"] = {"requests": len(kill_requests), "qps": result["qps"],
                       "p50_ms": result["p50_ms"], "p99_ms": result["p99_ms"],
                       "worst_parity": worst, "declared_after_s": declared,
                       "killed_pid": pid, "dump": os.path.basename(dumps[0]["path"]),
                       "dump_bytes": os.path.getsize(dumps[0]["path"]),
                       "child_records": dumps[0]["child_records"], "record_kinds": kinds,
                       "lost_spans": len(lost),
                       "rerouted": counter_total_labeled(session, "serving.rerouted",
                                                         replica=victim.replica_id)}
        k = out["kill"]
        log(f"  (b) SIGKILL of child {victim.replica_id} (pid {pid}) a third into "
            f"{len(kill_requests)} traced requests: declared after {declared:.3f} s, "
            f"{k['rerouted']:.0f} rerouted, every request answered once (worst |delta| "
            f"{worst:.3e}), every trace one tree over >= 3 processes; flight dump "
            f"{k['dump']} ({k['dump_bytes']:,} bytes, {k['child_records']} child records "
            f"of kinds {kinds}), {len(lost)} lost span(s) adopted")
    finally:
        fleet.router.observer = observer
        for client in clients.values():
            client.close()
    out["children"] = {rid: {"captures": [before[rid]["captures"], after[rid]["captures"]],
                             "segments": [before[rid]["segments"], after[rid]["segments"]],
                             "host_syncs": after[rid]["host_syncs"] - before[rid]["host_syncs"],
                             "batches": after[rid]["batches"] - before[rid]["batches"],
                             "kernel_launches": {
                                 name: n - (before[rid]["kernel_launches"] or {}).get(name, 0)
                                 for name, n in (after[rid]["kernel_launches"] or {}).items()}}
                       for rid in before}
    for rid, c in out["children"].items():
        log(f"  (b) child {rid} over (b)-(c) before the kill: captures {c['captures']}, "
            f"segments {c['segments']}, host syncs {c['host_syncs']:.0f} for "
            f"{c['batches']:.0f} batches")
        if c["captures"][0] != c["captures"][1] or c["segments"][0] != c["segments"][1]:
            raise AssertionError(f"phase 16 (b): child {rid} captured or allocated")
        if c["host_syncs"] != c["batches"] or not c["batches"]:
            raise AssertionError(f"phase 16 (b): child {rid} host syncs != batches")
    out["seconds"] = time.monotonic() - t_start
    log(f"  phase 16 (b)-(c) took {out['seconds']:.1f} s")
    return out


def run_fleet_phases(game: dict, serving: dict, dev, tmp: str, t_start: float) -> tuple:
    """Phases 15 and 16 (phase 16 (b)-(c) on phase 15's fleet before it
    closes), each with every launch count set to 0 just before it; returns
    their records."""
    from photon_tpu_torch.ops import launch_counts

    kernel_counters = kernel_wrappers()
    t15 = time.monotonic()
    log("phase 15: the self-healing subprocess fleet over TCP (serve_game --transport "
        "tcp --replica-backend subprocess --supervise, a child killed under load, a "
        "rollout and a rebuild past the capacity, a partition)")
    reset_launches(kernel_counters)
    phase15_parent: dict = {}

    def observe(fleet, sup, session, requests, oracle):
        phase15_parent.update(launch_counts())
        log(f"  phase 15 before phase 16 took {time.monotonic() - t15:.1f} s")
        log("phase 16 (b)-(c): the observability plane on phase 15's fleet (TCP turns "
            "traced at sample_rate 1.0 and untraced, a child killed under traced load, "
            "the HTTP plane and the console)")
        reset_launches(kernel_counters)
        return run_observe_tcp(fleet, sup, session, requests, oracle,
                               os.path.join(tmp, "phase16_flight"))

    fleet15 = run_subprocess_fleet(game, serving, dev, observe)
    fleet15["kernel_launches"] = fleet_kernel_launches(fleet15, phase15_parent)
    observe16 = {"tcp": fleet15.pop("observe")}
    fleet15["seconds"] = time.monotonic() - t15 - observe16["tcp"]["seconds"]
    log(f"  phase 15 took {fleet15['seconds']:.1f} s without phase 16 (b)-(c) "
        f"({observe16['tcp']['seconds']:.1f} s); the script so far "
        f"{time.monotonic() - t_start:.1f} s")

    t16 = time.monotonic()
    log("phase 16 (a): the observer's cost on the thread fleet (phase 8 (c)'s traffic; "
        "no observer, sample_rate 0.01 and 1.0 in turns)")
    observe16["threads"] = run_observe_threads(game, dev)
    observe16["kernel_launches"] = observe_kernel_launches(observe16)
    observe16["seconds"] = observe16["tcp"]["seconds"] + time.monotonic() - t16
    log(f"  phase 16 took {observe16['seconds']:.1f} s; the script so far "
        f"{time.monotonic() - t_start:.1f} s")
    return fleet15, observe16


# Phase 13: bf16 feature storage and the half-width exchange payload.  (a)
# runs right after phase 3 on phase 2's prepared batches: each draw's batch
# converted by batch_astype (no layout or route rebuilt), then per route
# LBFGS_ITERATIONS of L-BFGS and TRON_ITERATIONS of TRON (Poisson) on the
# float32 and the bf16 batch in turns, BF16_TURNS turns, medians; the xchg
# route with the float32 and then the bfloat16 payload.  (b) the train CLI
# with --dtype bfloat16 on a1a; (c) train_game --dtype bfloat16 on phase
# 6's Avro file and split, resident on fused and pallas and streamed, each
# on the card and the host.
BF16_TURNS = 3
BF16_ROUTES = {"uniform": (("fused", None), ("pallas", None), ("xchg", "float32"),
                           ("xchg", "bfloat16"), ("benes", None)),
               "zipf": (("fused", None), ("pallas", None), ("xchg", "float32"),
                        ("xchg", "bfloat16"))}
BF16_FIT_RTOL = 2e-2  # bf16 against f32 storage (tests/test_bf16_storage.py)
BF16_AUC_ATOL = 0.05  # tests/test_bf16_storage.py:108
BF16_GAME_RUNS = (("fused", "fused", ()), ("pallas", "pallas", ()),
                  ("stream", None, ("--stream-chunks", str(STREAM_GAME_CHUNK_ROWS))))


def phase13_wrappers() -> dict:
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad, row_scatter
    from photon_tpu_torch.ops.slab_reduce import (
        aligned_gather_products,
        position_partial_sums,
    )

    return {"fused_sparse": fused_value_and_grad, "row_scatter": row_scatter,
            "position_reduce": position_partial_sums, "vperm_chunk": vp.chunk_pass,
            "vperm_lane": vp.lane_pass, "vperm_chunk_expand": vp.chunk_expand_pass,
            "slab_gather": aligned_gather_products}


def bf16_counted(fn):
    """``fn()`` with every kernel's counts (in all, the bf16 forms', per K4
    and K6 form; the probe kernels') set to 0 just before it; returns (its
    result, the counts just after).  A K4/K6 launch must take the form
    ``chunk_form`` picks (the cluster form) and no probe kernel may launch."""
    from photon_tpu_torch.ops import probe_kernels as pk

    wrappers = phase13_wrappers()
    for c in (*wrappers.values(), *pk.KERNELS):
        c.launches = 0
        if hasattr(c, "bf16_launches"):
            c.bf16_launches = 0
        if hasattr(c, "form_launches"):
            c.form_launches = dict.fromkeys(c.form_launches, 0)
    out = fn()
    torch.cuda.synchronize()
    probes = {c.__name__: c.launches for c in pk.KERNELS if c.launches}
    if probes:
        raise AssertionError(f"phase 13: the training path launched probe kernels: {probes}")
    counts = {}
    for name, c in wrappers.items():
        if c.launches:
            counts[name] = c.launches
        if getattr(c, "bf16_launches", 0):
            counts[name + "_bf16"] = c.bf16_launches
        if getattr(c, "form_launches", {}).get("global"):
            raise AssertionError(f"phase 13: {name} took the global form on the main path")
    return out, counts


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper replaced by its plain PyTorch version for the
    block, on CUDA tensors too: the objective then runs each route's same
    stages with no hand-written kernel."""
    from photon_tpu_torch.ops import fused_sparse as fs
    from photon_tpu_torch.ops import slab_reduce as sr
    from photon_tpu_torch.ops import vperm as vp

    swaps = ((fs, "fused_value_and_grad", fs.fused_value_and_grad_plain),
             (fs, "row_scatter", fs.row_scatter_plain),
             (sr, "position_partial_sums", sr.position_partial_sums_plain),
             (sr, "aligned_gather_products", sr.aligned_gather_products_plain),
             (vp, "chunk_pass", vp.chunk_pass_plain),
             (vp, "chunk_expand_pass", vp.chunk_expand_pass_plain),
             (vp, "lane_pass", vp.lane_pass_plain),
             (vp, "compensated_scan", vp.compensated_cumsum))
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    try:
        for module, name, fn in swaps:
            setattr(module, name, fn)
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def gate_card_plain(tag: str, objective, w, batch, dev,
                    payload_bf16: bool = False) -> tuple[float, list | None]:
    """The objective's value, gradient and one Hv on ``batch`` with the
    kernels against the same with every plain version, at phase 2's gates
    (the magnitudes from the row-major stream).  Returns the largest error
    and, with the half-width payload, the dz rounding flips per exchange.

    The half-width payload casts the exchange's stream to bf16: dz with
    baked values, else the products dz * val.  dz comes out of the route's
    forward (K2 over ``al_t``), whose f32 sums in another order than the
    plain reduce's may differ in dz's last bit, and such an element's bf16
    cast may then round one bf16 ulp apart: a flip.  So the plain exchange
    is first fed the card's own dz, and the two must agree at the gates of
    the float32 payload.  Then the plain side runs on its own dz, and the
    flips are counted and held to exactly their terms: the gates plus, per
    feature, the sum over its flipped elements of |bf16 dz_card - bf16
    dz_plain| * |val| (baked) or |bf16 (dz_card val) - bf16 (dz_plain
    val)|."""
    from photon_tpu_torch.data.batch import gather_dot
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.ops.fused_sparse import row_scatter_plain

    v = torch.randn(D, generator=torch.Generator(device=dev).manual_seed(13), device=dev)
    exchange = vp._exchange
    card_dz, fed_dz, plain_dz = [], [], []

    def recorded(record, feed=None):
        def wrapped(per_row, vals, aux):
            record.append(per_row)
            return exchange(per_row if feed is None else feed[len(record) - 1], vals, aux)
        return wrapped

    def evaluate():
        return (*objective.value_and_grad(w, batch), objective.hvp_operator(w, batch)(v))

    try:
        vp._exchange = recorded(card_dz)
        card = evaluate()
        with plain_kernels():
            vp._exchange = recorded(fed_dz, card_dz if payload_bf16 else None)
            plain = evaluate()
            if payload_bf16:
                vp._exchange = recorded(plain_dz)
                plain_own = evaluate()
    finally:
        vp._exchange = exchange
    if len(card_dz) != len(fed_dz):
        raise AssertionError(f"{tag}: {len(card_dz)} card and {len(fed_dz)} plain exchanges")
    loss, l2 = objective.loss, objective.l2_weight
    ids, vals = batch.ids, batch.vals.abs()
    z = gather_dot(w, batch.ids, batch.vals) + batch.offset
    mag_g = (row_scatter_plain((batch.weight * loss.d1(z, batch.label)).abs(), ids, vals, D)
             + l2 * w.abs())
    d2w = (batch.weight * loss.d2(z, batch.label)).abs()
    mag_h = row_scatter_plain(d2w * gather_dot(v.abs(), ids, vals), ids, vals, D) + l2 * v.abs()
    torch.cuda.synchronize()
    fed = " (the plain exchange fed the card's dz)" if payload_bf16 else ""
    err = max(gate_report(f"{tag} value", card[0], plain[0], VALUE_RTOL),
              gate_report(f"{tag} gradient{fed}", card[1], plain[1], GRAD_RTOL, mag_g),
              gate_report(f"{tag} Hv{fed}", card[2], plain[2], GRAD_RTOL, mag_h))
    if not payload_bf16:
        return err, None
    if len(card_dz) != 2 or len(plain_dz) != 2:
        raise AssertionError(f"{tag}: {len(card_dz)} card and {len(plain_dz)} plain "
                             "exchanges, 2 expected (gradient, Hv)")
    baked = batch.xchg.vals_dest is not None
    stream = "dz rows" if baked else "products"

    def cast(per_row):  # the stream as _exchange casts it
        moved = per_row if baked else per_row[:, None] * batch.vals
        return moved.float().to(torch.bfloat16).float()

    flips, extra = [], []
    for c, p in zip(card_dz, plain_dz):
        delta = (cast(c) - cast(p)).abs()
        flips.append({"rows": c.numel(), "dz_differ": int((c != p).sum()), "stream": stream,
                      "elements": delta.numel(), "cast_differ": int((delta != 0).sum())})
        extra.append(row_scatter_plain(delta, ids, vals, D) if baked else
                     torch.zeros(D, dtype=torch.float64, device=dev).index_add_(
                         0, ids.reshape(-1).long(), delta.reshape(-1).double()))
    log(f"  {tag}: card vs plain dz, rows that differ of {flips[0]['rows']} / {stream} of "
        f"{flips[0]['elements']} that the bf16 cast rounds apart: gradient "
        f"{flips[0]['dz_differ']} / {flips[0]['cast_differ']}, Hv {flips[1]['dz_differ']} / "
        f"{flips[1]['cast_differ']}")
    err = max(err,
              gate_report(f"{tag} gradient, plain dz", card[1], plain_own[1], GRAD_RTOL,
                          mag_g, extra=extra[0]),
              gate_report(f"{tag} Hv, plain dz", card[2], plain_own[2], GRAD_RTOL, mag_h,
                          extra=extra[1]))
    return err, flips


def bf16_kernel_timings(prepared, stores, dev) -> dict:
    """The bf16 forms' times at the main path's shapes beside their plain
    versions, a library call, their bytes bounds and the f32 form's time on
    the same (widened) values in the same call: K1 and RS on each draw's
    bf16 batch, K3 on its bf16 gradient layout, K4-K6 at every launch of the
    routes' exchanges."""
    from photon_tpu_torch.core.losses import get_loss
    from photon_tpu_torch.ops import fused_sparse as fs
    from photon_tpu_torch.ops.slab_reduce import (
        LANES,
        aligned_gather_products,
        aligned_gather_products_plain,
    )

    wrappers = (fs.fused_value_and_grad, fs.row_scatter, aligned_gather_products)
    saved = [(fn.launches, fn.bf16_launches) for fn in wrappers]
    loss = get_loss("logistic")
    out = {}
    for dist in DISTS:
        b16 = stores[dist]["bfloat16"]["row"]
        ids, vals = b16.ids, b16.vals
        n, k = ids.shape
        nnz = int((vals != 0).sum())
        w = torch.randn(D, device=dev) * 0.01
        args = (loss, w, ids, vals, b16.label, b16.offset, b16.weight)
        wide = (loss, w, ids, vals.float(), *args[4:])
        fs.fused_value_and_grad(*args)  # the hot set and its size, outside the timing
        t_bound, by = bound(6 * n * k + 12 * n + 8 * D + 4, 4 * nnz + 20 * n)
        rows = out[dist] = {"fused_sparse": {
            "ms": cuda_ms(lambda: fs.fused_value_and_grad(*args)),
            "f32_ms": cuda_ms(lambda: fs.fused_value_and_grad(*wide)),
            "plain_ms": cuda_ms(lambda: fs.fused_value_and_grad_plain(*args)),
            "library_ms": None, "bound_ms": t_bound, "bound_by": by}}
        r = torch.randn(n, device=dev)
        idx = ids.view(-1).long()
        out32 = torch.zeros(D, device=dev)
        vals32 = vals.float()
        t_bound, by = bound(6 * n * k + 4 * n + 4 * D, 2 * nnz)
        rows["row_scatter"] = {
            "ms": cuda_ms(lambda: fs.row_scatter(r, ids, vals, D)),
            "f32_ms": cuda_ms(lambda: fs.row_scatter(r, ids, vals32, D)),
            "plain_ms": cuda_ms(lambda: fs.row_scatter_plain(r, ids, vals, D)),
            # The upcast and multiply, then one index_add_, in the timing.
            "library_ms": cuda_ms(lambda: out32.zero_().index_add_(
                0, idx, (r[:, None] * vals).view(-1))),
            "bound_ms": t_bound, "bound_by": by}
        al = stores[dist]["bfloat16"]["attached"].al
        w2d = torch.randn(D, device=dev).index_select(0, al.dup_map).view(-1, LANES)
        k3 = (w2d, al.slab_of_tile, al.lo, al.vals)
        slots, n_tiles = al.lo.numel(), int(al.slab_of_tile.shape[0])
        al_vals32 = al.vals.float()
        t_bound, by = bound(10 * slots + 4 * w2d.numel() + 4 * n_tiles, slots)
        rows["slab_gather"] = {
            "ms": cuda_ms(lambda: aligned_gather_products(*k3)),
            "f32_ms": cuda_ms(lambda: aligned_gather_products(*k3[:3], al_vals32)),
            "plain_ms": cuda_ms(lambda: aligned_gather_products_plain(*k3)),
            "library_ms": cuda_ms(slab_gather_library_call(w2d, al)),
            "bound_ms": t_bound, "bound_by": by}
        for name, row in rows.items():
            lib = row["library_ms"]
            log(f"  {name} bf16 [{dist}]: kernel {row['ms']:.4f} ms (f32 form "
                f"{row['f32_ms']:.4f}), plain {row['plain_ms']:.4f} ms, library "
                f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    for fn, (n, n16) in zip(wrappers, saved):
        fn.launches, fn.bf16_launches = n, n16
    out["vperm"] = vperm_timings(prepared, dev, torch.bfloat16)
    return out


def run_bf16_main_path(prepared, dev) -> dict:
    """Phase 13 (a); every count set to 0 just before each fit and read
    just after."""
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import GlmOptimizationProblem, ProblemConfig
    from photon_tpu_torch.data.batch import batch_astype

    reg = RegularizationContext("l2", 1.0)
    logistic = GlmObjective.create("logistic", reg)
    poisson = GlmObjective.create("poisson", reg)

    def problem(objective, optimizer, iterations):
        return GlmOptimizationProblem(objective, ProblemConfig(
            optimizer=optimizer, regularization=reg,
            optimizer_config=OptimizerConfig(max_iterations=iterations, tolerance=0.0,
                                             gradient_tolerance=0.0)))

    lbfgs = problem(logistic, "lbfgs", LBFGS_ITERATIONS)
    tron = problem(poisson, "tron", TRON_ITERATIONS)
    out = {"routes": [], "launches_bf16": {}, "stores": {}}
    stores = {}
    for dist in DISTS:
        prep = prepared[dist]
        t0 = time.monotonic()
        stores[dist] = {"float32": {"row": prep["batch"], "attached": prep["attached"]},
                        "bfloat16": {"row": batch_astype(prep["batch"], torch.bfloat16),
                                     "attached": batch_astype(prep["attached"],
                                                              torch.bfloat16)}}
        torch.cuda.synchronize()
        convert_s = time.monotonic() - t0
        al32, al16 = prep["attached"].al, stores[dist]["bfloat16"]["attached"].al
        nbytes = {
            dtype: sum(t.numel() * t.element_size() for t in (
                b["row"].vals, b["attached"].fm.vals, b["attached"].al.vals,
                b["attached"].al_t.vals,
                *([b["attached"].xchg.vals_dest] if b["attached"].xchg.vals_dest is not None
                  else [])))
            for dtype, b in stores[dist].items()}
        out["stores"][dist] = {"convert_s": convert_s, "value_bytes": nbytes,
                               "al_dtypes": [str(al32.vals.dtype), str(al16.vals.dtype)]}
        log(f"  {dist}: batch_astype of the batch and its layouts {convert_s:.3f} s; "
            f"value streams {nbytes['float32'] / 2**20:.1f} -> "
            f"{nbytes['bfloat16'] / 2**20:.1f} MiB (row-major, fm, al, al_t, vals_dest)")
        label = poisson_labels(prep["batch"], seed=11)
        finals = {}
        for route, payload in BF16_ROUTES[dist]:
            os.environ["PHOTON_SPARSE_GRAD"] = route
            os.environ["PHOTON_XCHG_DTYPE"] = payload or "float32"
            name = route + (f"[{payload} payload]" if payload else "")
            key = "row" if route == "fused" else "attached"
            batches = {dtype: stores[dist][dtype][key] for dtype in ("float32", "bfloat16")}
            w = torch.randn(D, device=dev) * 0.01
            gate, flips = gate_card_plain(f"phase 13 {dist}/{name} bf16, card vs plain",
                                          logistic, w, batches["bfloat16"], dev,
                                          payload == "bfloat16")
            rows = {dtype: {"lbfgs": [], "tron": []} for dtype in batches}
            counts = {dtype: {} for dtype in batches}
            for turn in range(BF16_TURNS):
                order = ("float32", "bfloat16") if turn % 2 == 0 else ("bfloat16", "float32")
                for dtype in order:
                    b = batches[dtype]
                    w0 = torch.zeros(D, device=dev)
                    t0 = time.monotonic()
                    (_, res), c1 = bf16_counted(lambda: lbfgs.run(b, w0))
                    rows[dtype]["lbfgs"].append((time.monotonic() - t0, res))
                    bt = b._replace(label=label)
                    t0 = time.monotonic()
                    (_, rt), c2 = bf16_counted(lambda: tron.run(bt, w0))
                    rows[dtype]["tron"].append((time.monotonic() - t0, rt))
                    for c in (c1, c2):
                        for kname, n in c.items():
                            counts[dtype][kname] = counts[dtype].get(kname, 0) + n
            row = {"dist": dist, "route": route, "payload": payload, "gate_max_abs_err": gate,
                   "dz_flips": flips}
            for dtype, fits in rows.items():
                walls_l = [t for t, _ in fits["lbfgs"]]
                walls_t = [t for t, _ in fits["tron"]]
                res_l, res_t = fits["lbfgs"][-1][1], fits["tron"][-1][1]
                b = batches[dtype]
                wl = torch.randn(D, device=dev) * 0.01
                op = poisson.hvp_operator(wl, b._replace(label=label))
                vv = torch.randn(D, device=dev)
                row[dtype] = {
                    "lbfgs_steps_per_s": float(np.median(
                        [r.iterations / t for t, r in fits["lbfgs"]])),
                    "lbfgs_fit_s": walls_l, "lbfgs_final": res_l.value,
                    "tron_s_per_iteration": float(np.median(
                        [t / r.iterations for t, r in fits["tron"]])),
                    "tron_fit_s": walls_t, "tron_final": res_t.value,
                    "tron_cg_steps": res_t.cg_iterations,
                    "value_and_grad_ms": cuda_ms(lambda: logistic.value_and_grad(wl, b)),
                    "hv_ms": cuda_ms(lambda: op(vv)),
                    "launches": counts[dtype],
                }
                if not (np.isfinite(res_l.value) and np.isfinite(res_t.value)):
                    raise AssertionError(f"phase 13 {dist}/{name} {dtype}: a fit is not finite")
            for kname, n in (*counts["float32"].items(), *counts["bfloat16"].items()):
                if kname.endswith("_bf16"):
                    out["launches_bf16"][kname] = out["launches_bf16"].get(kname, 0) + n
            for solver in ("lbfgs", "tron"):
                f32, b16 = row["float32"][f"{solver}_final"], row["bfloat16"][f"{solver}_final"]
                rel = abs(b16 - f32) / abs(f32)
                row[f"{solver}_bf16_vs_f32"] = rel
                if rel > BF16_FIT_RTOL:
                    raise AssertionError(f"phase 13 {dist}/{name}: the bf16 {solver} fit is "
                                         f"{rel:.3e} off the f32 fit")
            finals[name] = (row["bfloat16"]["lbfgs_final"], row["bfloat16"]["tron_final"])
            out["routes"].append(row)
            s32, s16 = row["float32"], row["bfloat16"]
            log(f"  {dist}/{name}: L-BFGS steps/s f32 {s32['lbfgs_steps_per_s']:.2f}, bf16 "
                f"{s16['lbfgs_steps_per_s']:.2f}; TRON s/iteration f32 "
                f"{s32['tron_s_per_iteration']:.4f}, bf16 {s16['tron_s_per_iteration']:.4f}; "
                f"value_and_grad ms f32 {s32['value_and_grad_ms']:.3f}, bf16 "
                f"{s16['value_and_grad_ms']:.3f}; Hv ms f32 {s32['hv_ms']:.3f}, bf16 "
                f"{s16['hv_ms']:.3f}; bf16 vs f32 final L-BFGS {row['lbfgs_bf16_vs_f32']:.2e},"
                f" TRON {row['tron_bf16_vs_f32']:.2e} (tolerance {BF16_FIT_RTOL:g}); launches "
                f"over {BF16_TURNS} turns f32 {s32['launches']}, bf16 {s16['launches']}")
        # Phase 3's gate between routes, on the bf16 batch: the f32-payload
        # routes' final values (the bf16 payload rounds the products: a
        # different result, held to the f32 fit above).
        for name, (fl, ft) in finals.items():
            if "bfloat16 payload" in name:
                continue
            for solver, got, ref in (("lbfgs", fl, finals["fused"][0]),
                                     ("tron", ft, finals["fused"][1])):
                rel = abs(got - ref) / abs(ref)
                if rel > ROUTE_RTOL:
                    raise AssertionError(f"phase 13 {dist}: bf16 {solver} on {name} is "
                                         f"{rel:.3e} off fused")
        log(f"  {dist}: bf16 routes agree with fused within {ROUTE_RTOL:g}: "
            f"{ {k: v for k, v in finals.items()} }")
    if "forced" in prepared:
        # Neither draw took the colored route: one value_and_grad on the
        # colored route phase 2 forced on the uniform batch, as phase 3 runs
        # it, on the bf16 batch with the bf16 payload (K5's 2-byte form).
        os.environ["PHOTON_SPARSE_GRAD"] = "xchg"
        os.environ["PHOTON_XCHG_DTYPE"] = "bfloat16"
        colored = batch_astype(prepared["forced"]["attached"], torch.bfloat16)
        w = torch.randn(D, device=dev) * 0.01
        gate, flips = gate_card_plain("phase 13 uniform/xchg forced colored route, bf16 "
                                      "payload, card vs plain", logistic, w, colored, dev,
                                      payload_bf16=True)
        _, counts = bf16_counted(lambda: logistic.value_and_grad(w, colored))
        out["forced_colored"] = {"gate_max_abs_err": gate, "dz_flips": flips,
                                 "launches": counts}
        for kname, n in counts.items():
            if kname.endswith("_bf16"):
                out["launches_bf16"][kname] = out["launches_bf16"].get(kname, 0) + n
        log(f"  uniform/xchg forced colored route, bf16 payload: launches {counts}")
    os.environ.pop("PHOTON_SPARSE_GRAD", None)
    os.environ.pop("PHOTON_XCHG_DTYPE", None)
    missing = [k for k in ("fused_sparse_bf16", "row_scatter_bf16", "slab_gather_bf16",
                           "vperm_chunk_bf16", "vperm_lane_bf16", "vperm_chunk_expand_bf16")
               if not out["launches_bf16"].get(k)]
    if missing:
        raise AssertionError(f"phase 13: bf16 forms never launched on the main path: {missing}")
    log("  the bf16 forms' times:")
    out["timings"] = bf16_kernel_timings(prepared, stores, dev)
    return out


def run_bf16_cli() -> dict:
    """Phase 13 (b): the train CLI on a1a with --dtype bfloat16 against
    float32 on the card, and --stream refusing it."""
    from photon_tpu_torch.drivers import train

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_cli_")
    out = {}
    try:
        base = ["--input", "tests/fixtures/a1a.libsvm",
                "--validation-input", "tests/fixtures/a1a.t.libsvm",
                "--task", "logistic_regression", "--reg-weights", "0.1,1,10",
                "--evaluators", "AUC,LOGISTIC_LOSS", "--backend", "gpu"]
        for dtype in ("float32", "bfloat16"):
            t0 = time.monotonic()
            (summary, counts) = bf16_counted(lambda: train.run(train.build_parser().parse_args(
                [*base, "--dtype", dtype, "--output-dir", os.path.join(tmp, dtype)])))
            best = next(e for e in summary["sweep"] if e["lambda"] == summary["best_lambda"])
            out[dtype] = {"wall_s": time.monotonic() - t0, "dtype": summary["dtype"],
                          "auc": best["metrics"]["AUC"],
                          "final_values": [e["final_value"] for e in summary["sweep"]],
                          "launches": counts}
            log(f"  train --dtype {dtype} (card): {out[dtype]['wall_s']:.2f} s, AUC "
                f"{out[dtype]['auc']:.6f}, final values {out[dtype]['final_values']}, "
                f"launches {counts}")
        for f32, b16 in zip(out["float32"]["final_values"], out["bfloat16"]["final_values"]):
            if abs(b16 - f32) > BF16_FIT_RTOL * abs(f32):
                raise AssertionError(f"phase 13 (b): bf16 final value {b16} vs f32 {f32}")
        if abs(out["bfloat16"]["auc"] - out["float32"]["auc"]) > BF16_AUC_ATOL:
            raise AssertionError("phase 13 (b): the bf16 AUC is off the f32 one")
        try:
            train.run(train.build_parser().parse_args(
                ["--stream", "--input", "tests/fixtures/a1a.libsvm", "--dtype", "bfloat16",
                 "--backend", "gpu", "--output-dir", os.path.join(tmp, "stream")]))
        except ValueError as e:
            out["stream_refused"] = str(e)
            log(f"  train --stream --dtype bfloat16: raised ValueError ({e}) ok")
        else:
            raise AssertionError("phase 13 (b): train --stream --dtype bfloat16 ran")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def run_bf16_game(game: dict, sgame: dict) -> dict:
    """Phase 13 (c): train_game --dtype bfloat16 on phase 6's Avro file and
    split, resident on fused and on pallas and streamed in 50,000-row
    chunks, each on the card and the host (every count at 0 just before
    each run): the card within phase 6's gates of the host, the AUC within
    0.05 of the f32 run (phase 6's resident ones, phase 12's streamed
    card run); the value streams' bytes f32 against bf16."""
    from photon_tpu_torch.data.game_io import read_game_avro
    from photon_tpu_torch.drivers import train_game
    from photon_tpu_torch.game.data import dataset_astype, split_game_dataset
    from photon_tpu_torch.game.model_io import load_game_model
    from photon_tpu_torch.game.tiles import per_row_bytes

    root = os.path.join(os.path.dirname(game["avro"]), "phase13")
    f32_runs = {"fused": game["runs"]["fused"], "pallas": game["runs"]["pallas"],
                "stream": sgame["cli"]["runs"]["card"]}
    out = {"runs": {}}
    for name, route, extra in BF16_GAME_RUNS:
        models = {}
        for backend in ("gpu", "cpu"):
            run_dir = os.path.join(root, f"{name}_{backend}")
            if route is None:
                os.environ.pop("PHOTON_SPARSE_GRAD", None)
            else:
                os.environ["PHOTON_SPARSE_GRAD"] = route
            t0 = time.monotonic()
            try:
                summary, counts = bf16_counted(lambda: train_game.run(
                    train_game.build_parser().parse_args(
                        [*game_cli_args(game["avro"], run_dir, backend), *extra,
                         "--dtype", "bfloat16"])))
            finally:
                os.environ.pop("PHOTON_SPARSE_GRAD", None)
            wall = time.monotonic() - t0
            models[backend] = load_game_model(os.path.join(run_dir, "best_model"),
                                              device="cpu")[0]
            out["runs"][f"{name}_{backend}"] = {
                "wall_s": wall, "best_metrics": summary["best_metrics"],
                "stream_chunks": summary["stream_chunks"], "launches": counts,
                "descent_iteration_s": [h["seconds"] for h in summary["sweep"][0]["history"]]}
            log(f"  train_game --dtype bfloat16 {name} ({backend}): {wall:.2f} s, metrics "
                f"{summary['best_metrics']}, chunk rows {summary['stream_chunks']}, "
                f"launches {counts}")
        card, host = out["runs"][f"{name}_gpu"], out["runs"][f"{name}_cpu"]
        for key, ref in host["best_metrics"].items():
            if abs(card["best_metrics"][key] - ref) > GAME_METRIC_ATOL:
                raise AssertionError(f"phase 13 (c) {name}: {key} card "
                                     f"{card['best_metrics'][key]} host {ref}")
        diffs = {}
        for coord, m in models["gpu"].coordinates.items():
            r = models["cpu"].coordinate(coord)
            got, want = ((m.coefficients.means, r.coefficients.means)
                         if hasattr(m, "coefficients") else (m.table, r.table))
            if not torch.allclose(got, want, rtol=GAME_COEF_TOL, atol=GAME_COEF_TOL):
                raise AssertionError(f"phase 13 (c) {name}: {coord} card and host differ")
            diffs[coord] = float((got - want).abs().max())
        auc_f32 = f32_runs[name]["best_metrics"]["AUC"]
        gap = abs(card["best_metrics"]["AUC"] - auc_f32)
        card.update(card_vs_host=diffs, auc_vs_f32=gap)
        log(f"  {name}: card vs host {diffs}; AUC bf16 {card['best_metrics']['AUC']:.6f} "
            f"vs f32 {auc_f32:.6f} (|diff| {gap:.2e}, tolerance {BF16_AUC_ATOL:g})")
        if gap > BF16_AUC_ATOL:
            raise AssertionError(f"phase 13 (c) {name}: the bf16 AUC is off the f32 one")
    if not out["runs"]["fused_gpu"]["launches"].get("fused_sparse_bf16"):
        raise AssertionError("phase 13 (c): K1's bf16 form never launched on fused")
    if not out["runs"]["pallas_gpu"]["launches"].get("position_reduce"):
        raise AssertionError("phase 13 (c): K2 never launched on pallas")
    # The training split's value streams, as the runs hold them.
    data, _ = read_game_avro(game["avro"],
                             train_game.parse_feature_bags("global=global,per_user=per_user"),
                             ["userId", "itemId"])
    train32, _ = split_game_dataset(data, 0.2)
    train16 = dataset_astype(train32, "bfloat16")

    def value_bytes(d) -> int:
        return sum((s.x if hasattr(s, "x") else s.vals).nbytes for s in d.shards.values())

    out["value_bytes"] = {"float32": value_bytes(train32), "bfloat16": value_bytes(train16)}
    out["chunk_bytes"] = {"float32": per_row_bytes(train32) * STREAM_GAME_CHUNK_ROWS,
                          "bfloat16": per_row_bytes(train16) * STREAM_GAME_CHUNK_ROWS}
    log(f"  value stream bytes f32 {out['value_bytes']['float32']:,} bf16 "
        f"{out['value_bytes']['bfloat16']:,}; a {STREAM_GAME_CHUNK_ROWS:,}-row chunk "
        f"f32 {out['chunk_bytes']['float32']:,} bf16 {out['chunk_bytes']['bfloat16']:,}")
    shutil.rmtree(root, ignore_errors=True)
    return out


def bf16_kernel_entries(bf16: dict, kb16: dict, card: str) -> list:
    """The kernels line's entries of the bf16 forms: launches from phase
    13 (a), errors from phase 2, times from phase 13 (a)'s timings."""
    t = bf16["timings"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "f32_ms")
    entries = []
    for name, source, replaces, err, library in (
            ("fused_sparse", "fused_sparse.cu", "photon_tpu/ops/pallas_sparse.py:159",
             kb16["fused_sparse_max_abs_err"], None),
            ("row_scatter", "fused_sparse.cu", "photon_tpu/core/objective.py:420",
             kb16["row_scatter_max_abs_err"], "upcast, multiply, index_add_"),
            ("slab_gather", "slab_gather.cu", "photon_tpu/ops/pallas_gather.py:521", 0.0,
             "torch.gather + multiply")):
        entries.append({
            "name": name + "_bf16", "route": "cuda",
            "source": f"photon_tpu_torch/ops/csrc/{source}", "replaces": replaces,
            "launches": bf16["launches_bf16"].get(name + "_bf16", 0), "max_abs_err": err,
            **{key: t["uniform"][name][key] for key in keys},
            "zipf": t["zipf"][name], "library_call": library, "card": card})
    for name, replaces in (("vperm_chunk", "photon_tpu/ops/vperm.py:309"),
                           ("vperm_lane", "photon_tpu/ops/vperm.py:328"),
                           ("vperm_chunk_expand", "photon_tpu/ops/vperm.py:860")):
        timed = [row for rows in t["vperm"].values() for row in rows if row["kernel"] == name]
        entry = {"name": name + "_bf16", "route": "cuda",
                 "source": "photon_tpu_torch/ops/csrc/vperm.cu", "replaces": replaces,
                 "launches": bf16["launches_bf16"].get(name + "_bf16", 0), "max_abs_err": 0.0,
                 **{key: timed[0][key] for key in (*keys, "at")},
                 "other_launches": timed[1:], "card": card}
        if name in CHUNK_KERNELS:
            entry.update({key: timed[0][key] for key in
                          ("form", "cluster_blocks", "max_active_clusters", "global_form_ms")})
        entries.append(entry)
    return entries


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
    # The main path's layouts and routes (minutes of host work, mostly
    # native) build in the background while the first checks run; the
    # checks time nothing, and the config-2 timings wait for a quiet card.
    log(f"  the main path's layouts and exchange routes, n={N}, k={K}, d={D}, "
        "building beside the checks below:")
    with concurrent.futures.ThreadPoolExecutor(1) as background:
        preparing = background.submit(prepare_batches, dev)
        k1 = check_fused_kernel(dev)
        krs = check_row_scatter(dev)
        k2 = check_position_kernel(dev)
        prepared = preparing.result()
    k_config2 = config2_kernel_timings(k2.pop("config2"), dev)
    kv = check_vperm_kernels(prepared, dev)
    log("  K4 and K6 off the main path, random in-range planes:")
    edges = check_chunk_form_edges(dev)
    k3 = check_slab_gather_kernel(prepared, dev)
    kb = check_benes(prepared, dev)
    log("  CS, the compensated scan of the cumsum reduce, against its plain version "
        "and a float64 prefix:")
    kcs = check_compensated_scan(dev)
    log("  the bf16 forms of K3-K6 against their plain versions:")
    kb16 = check_bf16_forms(prepared, dev)
    kb16.update(fused_sparse_max_abs_err=k1["bf16_max_abs_err"],
                row_scatter_max_abs_err=krs["bf16_max_abs_err"])

    log(f"phase 3: main path, L-BFGS and TRON at n={N}, k={K}, d={D}")
    main_path = run_main_path(prepared, dev)

    t13 = time.monotonic()
    log("phase 13 (a): bf16 storage and the half-width payload on phase 2's batches "
        "(batch_astype; L-BFGS and TRON, f32 and bf16 in turns)")
    bf16 = {"main_path": run_bf16_main_path(prepared, dev)}
    bf16["seconds_a"] = time.monotonic() - t13
    log(f"  phase 13 (a) took {bf16['seconds_a']:.1f} s")

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

        t9 = time.monotonic()
        log("phase 9: the rest of GAME training (lane solves, projections, factored "
            "effects, warm starts, locked coordinates) through train_game")
        rest = run_game_rest(game)
        rest["hidim"] = run_hidim(dev)
        rest["seconds"] = time.monotonic() - t9
        log(f"  phase 9 took {rest['seconds']:.1f} s")

        t10 = time.monotonic()
        log("phase 10: fault-tolerant resident training (checkpoints, preemption, kill "
            "and resume) and online learning with onboarding")
        fault = {"resume": run_fault_tolerance(game)}
        fault["online_fixture"] = run_online_fixture(dev)
        fault["online_game"] = run_online_game(game)
        fault["seconds"] = time.monotonic() - t10
        log(f"  phase 10 took {fault['seconds']:.1f} s")

        t11 = time.monotonic()
        log(f"phase 11: streamed GLM training and scoring ({STREAM_FILES} part files, "
            f"{STREAM_ROWS:,} rows, k={STREAM_K}, d={STREAM_D})")
        stream = run_streamed(dev, game)
        stream["seconds"] = time.monotonic() - t11
        log(f"  phase 11 took {stream['seconds']:.1f} s")

        t12 = time.monotonic()
        log("phase 12: streamed GAME training (the out-of-core scenario, then "
            "train_game --stream-chunks with a mid-epoch kill and resume)")
        keep: dict = {}  # phase 12's data and fits, for phase 14
        sgame = run_streamed_game(dev, game, keep)
        sgame["seconds"] = time.monotonic() - t12
        log(f"  phase 12 took {sgame['seconds']:.1f} s")

        t13 = time.monotonic()
        log("phase 13 (b): train --dtype bfloat16 on a1a; (c): train_game --dtype "
            "bfloat16 on config 4, resident and streamed, card and host")
        bf16["cli"] = run_bf16_cli()
        bf16["game"] = run_bf16_game(game, sgame)
        bf16["seconds_bc"] = time.monotonic() - t13
        log(f"  phase 13 (b) and (c) took {bf16['seconds_bc']:.1f} s; phase 13 in all "
            f"{bf16['seconds_a'] + bf16['seconds_bc']:.1f} s")

        t14 = time.monotonic()
        log("phase 14: the disk tier (the out-of-core scenario spilled at f32, bf16 and "
            "int8, then train_game --spill-dir with kills, a corrupt and a stale tile)")
        spill = run_spill(dev, game, keep)
        del keep
        spill["seconds"] = time.monotonic() - t14
        log(f"  phase 14 took {spill['seconds']:.1f} s; the script so far "
            f"{time.monotonic() - t_start:.1f} s")

        fleet15, observe16 = run_fleet_phases(game, serving, dev, game_tmp, t_start)
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
            "phase9_launches": {name: run["launches"].get("fused_value_and_grad", 0)
                                for name, run in rest.items() if name[:2] in ("9a", "9b")
                                and "launches" in run},
            "config2": k_config2["fused_sparse"],
            "phase10_launches": phase10_launches(fault, "fused_value_and_grad"),
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
            "phase9_launches": {name: run["launches"].get("position_partial_sums", 0)
                                for name, run in rest.items() if name[:2] in ("9a", "9b")
                                and "launches" in run},
            "phase9_note": "phase 9 drives K2 nowhere: 9b's one fixed effect is locked",
            "phase10_launches": phase10_launches(fault, "position_partial_sums"),
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
    kernels.append({
        "name": "compensated_scan", "route": "cuda",
        "source": "photon_tpu_torch/ops/csrc/compensated_scan.cu",
        # An XLA associative_scan in the JAX package (no pl.pallas_call).
        "replaces": "photon_tpu/ops/vperm.py:1332",
        # Its main path is phase 11's cumsum route (phase 3 reduces aligned).
        "launches": sum(phase11_launches(stream, "compensated_scan").values()),
        **{key: kcs[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        "library_call": "torch.cumsum(x, 0, dtype=torch.float64)",
        "library_gate_ratio": kcs["library_gate_ratio"],
        "float32_cumsum_ms": kcs["float32_cumsum_ms"], "edges": kcs["edges"], "card": card,
    })
    kernels.extend(bf16_kernel_entries(bf16["main_path"], kb16, card))
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
    log(f"phase 9: {json.dumps(rest, default=str)}")
    log(f"phase 10: {json.dumps(fault, default=str)}")
    log(f"phase 11: {json.dumps(stream, default=str)}")
    log(f"phase 12: {json.dumps(sgame, default=str)}")
    log(f"phase 13: {json.dumps({k: v for k, v in bf16.items()}, default=str)}")
    log(f"phase 14: {json.dumps(spill, default=str)}")
    log(f"phase 15: {json.dumps(fleet15, default=str)}")
    log(f"phase 16: {json.dumps(observe16, default=str)}")
    log(f"bf16 edge shapes: {json.dumps(kb16['edges'])}")
    wrapper_names = {"fused_sparse": "fused_value_and_grad", "row_scatter": "row_scatter",
                     "position_reduce": "position_partial_sums",
                     "vperm_chunk": "chunk_pass", "vperm_lane": "lane_pass",
                     "vperm_chunk_expand": "chunk_expand_pass",
                     "slab_gather": "aligned_gather_products",
                     "compensated_scan": "compensated_scan"}
    p12 = phase12_launches(sgame)
    p14 = phase14_launches(spill)
    for entry in kernels:
        wrapper = wrapper_names.get(entry["name"], entry["name"])
        entry["phase11_launches"] = phase11_launches(stream, wrapper)
        # The streamed GAME path runs no hand-written kernel (expected 0).
        entry["phase12_launches"] = {run: launches.get(wrapper, 0)
                                     for run, launches in p12.items()}
        # The disk tier runs no hand-written kernel either (expected 0).
        entry["phase14_launches"] = {run: launches.get(wrapper, 0)
                                     for run, launches in p14.items()}
        # Nor does the subprocess fleet (phase 15 gates 0); a bf16 form
        # counts its wrapper's bf16 launches.
        base = entry["name"].removesuffix("_bf16")
        entry["phase15_launches"] = fleet15["kernel_launches"].get(
            wrapper_names.get(base, base) + entry["name"][len(base):], 0)
        # Nor does the observed fleet (phase 16 gates 0).
        entry["phase16_launches"] = observe16["kernel_launches"].get(
            wrapper_names.get(base, base) + entry["name"][len(base):], 0)
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
