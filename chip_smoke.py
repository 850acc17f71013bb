#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``photon_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit, torch/CUDA versions; build the CUDA
   kernels from ``photon_tpu_torch/ops/csrc`` and the host router from
   ``photon_tpu_torch/native/src`` and time both builds;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes: the fused value+gradient (four losses, ragged row count,
   uniform and zipf ids, zero-weight rows), the slab position-reduce
   (gradient and forward layouts, uniform and zipf ids, padded geometry),
   and the three permutation passes of the ``xchg`` route (K4 chunk, K5
   lane, K6 chunk-expand) over the main path's own routes, each launch bit
   for bit: the route of each id draw (balanced: K6 + K4, and K4 in the
   value bake; colored: K4 + K5 + K4) and, when neither draw takes the
   colored route, one forced on the uniform batch; then each route's slot
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
   over each run, per-evaluation time, steps/s, layout and route build
   seconds, and each kernel's time beside its plain version's, a library
   call's and its bound; then TRON (Poisson + L2) at the same shape on the
   ``fused``, ``pallas``, ``xchg`` and ``benes`` routes (uniform ids) and
   the first three (zipf ids): iterations, CG steps, host reads, seconds
   per outer iteration, milliseconds per Hessian-vector product and each
   kernel's launches;
4. the ``train`` CLI on the a1a fixture, on the card (default route and
   ``xchg``) and with ``--backend cpu``; then with ``--optimizer tron`` on
   the card, with ``--backend cpu`` and on the card under ``benes``; the
   AUCs must agree.

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
    from photon_tpu_torch.data.batch import scatter_sum
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


def check_vperm_kernels(prepared, dev) -> dict:
    """K4, K5 and K6 on the main path's routes against their plain versions
    and one library call, bit for bit; then each route's slot products
    against the ``pallas`` route's, bit for bit, and its gradient against
    the ``pallas`` route's under the gradient gate."""
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.ops.slab_reduce import aligned_reduce

    counters = (vp.chunk_pass, vp.lane_pass, vp.chunk_expand_pass)
    saved = [fn.launches for fn in counters]
    seen = set()
    worst = 0.0
    for name in route_names(prepared):
        batch = prepared[name]["attached"]
        for kernel, fn, plain, label, args, _ in route_passes(batch.xchg.route, dev):
            got, ref = fn(*args), plain(*args)
            lib = pass_library_call(kernel, args)()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            same = torch.equal(got, ref) and torch.equal(got, lib)
            log(f"  {kernel}[{name} {label}, {tuple(args[0].shape)}]: "
                f"max_abs_err={err:.3e}, bitwise {'ok' if same else 'FAIL'}")
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
    for fn, n in zip(counters, saved):
        fn.launches = n
    missing = {"vperm_chunk", "vperm_lane", "vperm_chunk_expand"} - seen
    if missing:
        raise AssertionError(f"no route of the main path runs {sorted(missing)}")
    return {"max_abs_err": 0.0, "gradient_max_abs_err": worst}


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
    order (the per-evaluation launches first)."""
    from photon_tpu_torch.ops import vperm as vp

    counters = (vp.chunk_pass, vp.lane_pass, vp.chunk_expand_pass)
    saved = [fn.launches for fn in counters]
    out = {}
    for name in route_names(prepared):
        rows = out[name] = []
        for kernel, fn, plain, label, args, nbytes in route_passes(
                prepared[name]["attached"].xchg.route, dev):
            t_bound, by = bound(nbytes, 0)
            row = {
                "kernel": kernel,
                "ms": cuda_ms(lambda: fn(*args)),
                "plain_ms": cuda_ms(lambda: plain(*args)),
                "library_ms": cuda_ms(pass_library_call(kernel, args)),
                "bound_ms": t_bound, "bound_by": by,
                "at": f"{name} {label}, {tuple(args[0].shape)}",
            }
            rows.append(row)
            log(f"  {kernel} [{row['at']}]: kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    for fn, n in zip(counters, saved):
        fn.launches = n
    return out


def run_main_path(prepared, dev) -> dict:
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import GlmOptimizationProblem, ProblemConfig
    from photon_tpu_torch.ops import vperm as vp
    from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad
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
    counters = {"fused_sparse": fused_value_and_grad,
                "position_reduce": position_partial_sums,
                "vperm_chunk": vp.chunk_pass, "vperm_lane": vp.lane_pass,
                "vperm_chunk_expand": vp.chunk_expand_pass,
                "slab_gather": aligned_gather_products}
    launches = {name: 0 for name in counters}
    result = {"runs": []}

    def counted(fn):
        """Run ``fn`` with every launch count set to 0 just before it;
        returns (its result, the counts just after)."""
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: c.launches for name, c in counters.items()}
        for name in counts:
            launches[name] += counts[name]
        return out, counts

    def expected(route: str, batch) -> set:
        if route == "fused":
            return {"fused_sparse"}
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
            if route == "fused":
                os.environ.pop("PHOTON_SPARSE_GRAD", None)
                run_batch = prep["batch"]
            else:
                os.environ["PHOTON_SPARSE_GRAD"] = route
                run_batch = prep["attached"]
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
            if objective._sparse_kernel(run_batch) != route:
                raise AssertionError(f"{dist}/{route}: the batch takes another route")
            w0 = torch.zeros(D, device=dev)
            problem(1).run(run_batch, w0)  # module loads, outside the timing
            torch.cuda.synchronize()
            t0 = time.monotonic()
            (coefficients, res), counts = counted(
                lambda: problem(TRON_ITERATIONS).run(run_batch, w0))
            wall = time.monotonic() - t0
            unlaunched = sorted(k for k in expected(route, run_batch) if not counts[k])
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
        raise RuntimeError(f"the host router did not build: {native_build.build_error()}")
    log(f"  built the host router ({native_build.lib_path()}) in "
        f"{native_build.build_seconds:.2f} s")

    log("phase 2: kernels against their plain versions")
    k1 = check_fused_kernel(dev)
    k2 = check_position_kernel(dev)
    log(f"  the main path's layouts and exchange routes, n={N}, k={K}, d={D}:")
    prepared = prepare_batches(dev)
    kv = check_vperm_kernels(prepared, dev)
    k3 = check_slab_gather_kernel(prepared, dev)
    kb = check_benes(prepared, dev)

    log(f"phase 3: main path, L-BFGS and TRON at n={N}, k={K}, d={D}")
    main_path = run_main_path(prepared, dev)
    del prepared
    torch.cuda.empty_cache()

    log("phase 4: train CLI on a1a")
    run_cli()

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
    for name, replaces in (("vperm_chunk", "photon_tpu/ops/vperm.py:309"),
                           ("vperm_lane", "photon_tpu/ops/vperm.py:328"),
                           ("vperm_chunk_expand", "photon_tpu/ops/vperm.py:860")):
        # The first per-evaluation launch on the uniform route where it runs
        # the kernel, else on the first route that does; every other launch
        # of the kernel beside it.
        timed = [row for rows in vt.values() for row in rows if row["kernel"] == name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "photon_tpu_torch/ops/csrc/vperm.cu", "replaces": replaces,
            "launches": main_path["launches"][name],
            "max_abs_err": kv["max_abs_err"],
            **{key: timed[0][key] for key in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at")},
            "other_launches": timed[1:],
        })
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
    log(f"main path runs: {json.dumps(main_path['runs'])}")
    log(f"TRON runs: {json.dumps(main_path['tron'])}")
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
