#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``photon_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit, torch/CUDA versions; build the kernels
   from ``photon_tpu_torch/ops/csrc`` and time the build;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes: the fused value+gradient (four losses, ragged row count,
   uniform and zipf ids, zero-weight rows) and the slab position-reduce
   (gradient and forward layouts, uniform and zipf ids, padded geometry);
3. the main path: ``GlmOptimizationProblem.run`` (L-BFGS, logistic + L2) at
   the headline GLM shape n=2^20, k=32, d=2^18 on the ``fused`` route and on
   the ``pallas`` route, uniform and zipf ids; each kernel's launch count
   over the run, per-evaluation time, steps/s, layout build seconds, and
   each kernel's time beside its plain version's, a library call's and its
   bound;
4. the ``train`` CLI on the a1a fixture, on the card and with
   ``--backend cpu``; the two AUCs must agree.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N, K, D = 1 << 20, 32, 1 << 18  # headline GLM shape (rows, nnz per row, dim)
LBFGS_ITERATIONS = 10
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


def make_ids(rng, n: int, k: int, d: int, dist: str) -> np.ndarray:
    """Feature ids as the repository's benchmark draws them (id 0 is left
    for the pad slot)."""
    if dist == "zipf":
        return (1 + (rng.zipf(1.3, size=(n, k)) - 1) % (d - 1)).astype(np.int32)
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


def check_fused_kernel(dev) -> dict:
    from photon_tpu_torch.core.losses import get_loss
    from photon_tpu_torch.data.batch import gather_dot
    from photon_tpu_torch.ops.fused_sparse import (
        fused_value_and_grad,
        fused_value_and_grad_plain,
    )

    worst = 0.0
    cases = [(loss, "uniform", N) for loss in
             ("logistic", "squared", "poisson", "smoothed_hinge")]
    cases += [("logistic", "zipf", N), ("logistic", "uniform", N - 77)]
    for i, (loss_name, dist, n) in enumerate(cases):
        rng = np.random.default_rng(100 + i)
        ids = make_ids(rng, n, K, D, dist)
        vals = rng.standard_normal((n, K)).astype(np.float32)
        cut = rng.integers(1, K + 1, size=n)  # padded row tails
        pad = np.arange(K)[None, :] >= cut[:, None]
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
        w = (rng.standard_normal(D) * 0.1).astype(np.float32)
        args = [torch.as_tensor(a, device=dev)
                for a in (w, ids, vals, label, offset, weight)]
        loss = get_loss(loss_name)
        v_k, g_k = fused_value_and_grad(loss, *args)
        v_p, g_p = fused_value_and_grad_plain(loss, *args)
        w_t, ids_t, vals_t, label_t, offset_t, weight_t = args
        coeff = weight_t * loss.d1(gather_dot(w_t, ids_t, vals_t) + offset_t, label_t)
        mag = torch.zeros_like(w_t).index_add_(
            0, ids_t.view(-1),
            ((coeff.abs() + weight_t)[:, None] * vals_t.abs()).view(-1),
        )
        torch.cuda.synchronize()
        tag = f"fused_sparse[{loss_name},{dist},n={n}]"
        worst = max(worst, gate_report(tag + " value", v_k, v_p, VALUE_RTOL))
        worst = max(worst, gate_report(tag + " grad", g_k, g_p, GRAD_RTOL, mag))
    # An id outside [0, d) raises IndexError, as the plain version does on
    # the CPU: in a new ids tensor, and in one the kernel had already found
    # clean and that was then changed in place.  The kernel reads nothing
    # out of bounds, so the card stays usable: the same call on the clean
    # batch then gives the same value (the loss sum is deterministic).
    ids_t = args[1]
    keep = int(ids_t[n // 2, 0])
    for bad_id, in_place in ((-1, False), (D, False), (D, True)):
        bad = ids_t if in_place else ids_t.clone()
        bad[n // 2, 0] = bad_id
        try:
            fused_value_and_grad(loss, args[0], bad, *args[2:])
        except IndexError as e:
            log(f"  fused_sparse[id {bad_id}, in place {in_place}]: raised "
                f"IndexError ({e}) ok")
        else:
            raise AssertionError(f"fused_sparse: id {bad_id} did not raise")
    ids_t[n // 2, 0] = keep
    v_again, _ = fused_value_and_grad(loss, *args)
    if float(v_again) != float(v_k):
        raise AssertionError("fused_sparse: value changed after a raising call")
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
    return {"max_abs_err": worst}


def kernel_timings(batch, al, al_t, dev) -> dict:
    """Kernel, plain and library times and bounds at the main path's
    shapes (``batch`` and its layouts ``al``/``al_t``)."""
    from photon_tpu_torch.core.losses import get_loss
    from photon_tpu_torch.ops.fused_sparse import (
        fused_value_and_grad,
        fused_value_and_grad_plain,
    )
    from photon_tpu_torch.ops.slab_reduce import (
        LANES,
        TILE_SUBLANES,
        position_partial_sums,
        position_partial_sums_plain,
    )

    out = {}
    loss = get_loss("logistic")
    w = torch.randn(D, device=dev) * 0.01
    args = (loss, w, batch.ids, batch.vals, batch.label, batch.offset, batch.weight)
    n, k = batch.ids.shape
    nnz = int((batch.vals != 0).sum())
    t_bound, by = bound(8 * n * k + 12 * n + 8 * D + 4, 4 * nnz + 20 * n)
    saved = fused_value_and_grad.launches
    out["fused_sparse"] = {
        "ms": cuda_ms(lambda: fused_value_and_grad(*args)),
        "plain_ms": cuda_ms(lambda: fused_value_and_grad_plain(*args)),
        "bound_ms": t_bound, "bound_by": by, "library_ms": None,
    }
    fused_value_and_grad.launches = saved
    saved = position_partial_sums.launches
    for direction, lay, payload in (("grad", al, N), ("forward", al_t, D)):
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
        out_dim = D if direction == "grad" else N
        out[f"position_reduce[{direction}]"] = {
            # The route's other two stages, torch ops around the kernel: the
            # pv gather and the epilogue into out_dim key sums.
            "gather_ms": cuda_ms(lambda: per.index_select(
                0, lay.rows.view(-1)).view(lay.rows.shape) * lay.vals),
            "epilogue_ms": cuda_ms(lambda: torch.zeros(out_dim, device=dev).index_add_(
                0, lay.sorted_feats, partial.view(-1).index_select(0, lay.grad_perm))),
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
        log(f"  {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}){stages}")
    return out


def run_main_path(dev) -> dict:
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import GlmOptimizationProblem, ProblemConfig
    from photon_tpu_torch.data.batch import attach_feature_major
    from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad
    from photon_tpu_torch.ops.slab_reduce import position_partial_sums

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
    counters = {"fused_sparse": fused_value_and_grad,
                "position_reduce": position_partial_sums}
    launches = {name: 0 for name in counters}
    result = {"runs": []}
    for dist in ("uniform", "zipf"):
        batch = make_batch(dist, seed=0, device=dev)
        finals = {}
        for route in ("fused", "pallas"):
            if route == "pallas":
                os.environ["PHOTON_SPARSE_GRAD"] = "pallas"
                t0 = time.monotonic()
                run_batch = attach_feature_major(batch, aligned_dim=D)
                torch.cuda.synchronize()
                layout_s = time.monotonic() - t0
            else:
                os.environ.pop("PHOTON_SPARSE_GRAD", None)
                run_batch, layout_s = batch, 0.0
            w0 = torch.zeros(D, device=dev)
            # An untimed fit first: CUDA loads each kernel's module at its
            # first launch, so the first fit in a process pays for loading
            # every kernel the optimizer uses; steps/s reads the steady state.
            warm.run(run_batch, w0)
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.monotonic()
            coefficients, res = problem.run(run_batch, w0)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = {name: fn.launches for name, fn in counters.items()}
            for name in counts:
                launches[name] += counts[name]
            kernel = "fused_sparse" if route == "fused" else "position_reduce"
            if counts[kernel] == 0:
                raise AssertionError(f"route {route} never launched {kernel}")
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
                "layout_build_s": layout_s,
                "launches": counts,
            }
            result["runs"].append(row)
            log(f"  {dist}/{route}: {res.iterations} iterations, f {f0:.6g} -> "
                f"{res.value:.9g}, {row['steps_per_s']:.3f} steps/s, "
                f"value_and_grad {evals:.3f} ms x {n_evals}, outside the "
                f"objective {rest_ms:.3f} ms/iteration, layout build {layout_s:.2f} s, "
                f"launches {counts}")
            if route == "pallas":
                log(f"  kernel times, {dist} ids:")
                result.setdefault("timings", {})[dist] = kernel_timings(
                    batch, run_batch.al, run_batch.al_t, dev
                )
            del run_batch
        os.environ.pop("PHOTON_SPARSE_GRAD", None)
        rel = abs(finals["fused"] - finals["pallas"]) / abs(finals["fused"])
        log(f"  {dist}: fused vs pallas final value rel diff {rel:.3e} "
            f"(tolerance {ROUTE_RTOL:g})")
        if rel > ROUTE_RTOL:
            raise AssertionError(f"{dist}: routes disagree ({rel:.3e})")
        del batch
        torch.cuda.empty_cache()
    result["launches"] = launches
    return result


def run_cli() -> dict:
    aucs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        for backend in ("gpu", "cpu"):
            out_dir = os.path.join(tmp, backend)
            cmd = [
                sys.executable, "-m", "photon_tpu_torch.drivers.train",
                "--input", "tests/fixtures/a1a.libsvm",
                "--validation-input", "tests/fixtures/a1a.t.libsvm",
                "--task", "logistic_regression", "--optimizer", "lbfgs",
                "--reg-type", "l2", "--reg-weights", "0.1,1,10",
                "--evaluators", "AUC,LOGISTIC_LOSS",
                "--output-dir", out_dir, "--backend", backend,
            ]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"train CLI ({backend}) failed:\n{proc.stderr[-4000:]}")
            with open(os.path.join(out_dir, "training_summary.json")) as f:
                summary = json.load(f)
            best = next(e for e in summary["sweep"]
                        if e["lambda"] == summary["best_lambda"])
            aucs[backend] = best["metrics"]["AUC"]
            log(f"  train CLI --backend {backend}: best lambda "
                f"{summary['best_lambda']:g}, AUC {aucs[backend]:.6f}, "
                f"device {summary['device']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diff = abs(aucs["gpu"] - aucs["cpu"])
    log(f"  AUC gpu vs cpu: |diff| {diff:.2e} (tolerance {CLI_AUC_ATOL:g})")
    if diff > CLI_AUC_ATOL:
        raise AssertionError("the CLI's AUC differs between gpu and cpu")
    return aucs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
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

    log("phase 2: kernels against their plain versions")
    k1 = check_fused_kernel(dev)
    k2 = check_position_kernel(dev)

    log(f"phase 3: main path, L-BFGS at n={N}, k={K}, d={D}")
    main_path = run_main_path(dev)

    log("phase 4: train CLI on a1a")
    run_cli()

    timings = main_path["timings"]["uniform"]
    zipf = main_path["timings"]["zipf"]
    grad_row = timings["position_reduce[grad]"]
    kernels = [
        {
            "name": "fused_sparse", "route": "cuda",
            "source": "photon_tpu_torch/ops/csrc/fused_sparse.cu",
            "replaces": "photon_tpu/ops/pallas_sparse.py:159",
            "launches": main_path["launches"]["fused_sparse"],
            "max_abs_err": k1["max_abs_err"],
            **{key: timings["fused_sparse"][key] for key in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "zipf": zipf["fused_sparse"],
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
        },
    ]
    log(f"main path runs: {json.dumps(main_path['runs'])}")
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
