"""Every form of the chunk permutation kernels K4 and K6 at the main path's
chunk shapes, on the card.

For each case below the tool builds random in-range planes (each i1/i3 row a
permutation of the 128 lanes, each i2 row one of the chunk's rows: the
access pattern of stage A and of the colored route's passes), runs every
form the card can launch there (the global form and the cluster form at
every cluster size of 1, 2, 4, 8, 16 whose blocks fit), holds each to the
plain version bit for bit, and prints its time (CUDA events, the mean of
``--reps`` launches after a warm-up), ``cudaOccupancyMaxActiveClusters``,
the bound (bytes at 3.35 TB/s) and one ``index_select`` by the source map
composed once.  ``*`` marks the form :func:`ops.vperm.chunk_form` picks.

  K4 balanced   nc = 128, ch = 2432 (uniform ids: stage B, the bake)
  K4 colored    nc = 128, ch = 4096 (zipf ids: R1, R2)
  K6 balanced   nc = 128, ch = 2432, k = 32 (uniform ids: stage A)
  K4 small      nc = 811, ch = 384: about the balanced route's slots in
                chunks that two blocks hold, so the cluster sizes differ
                only in how many blocks share a chunk

With ``--route`` it also builds the balanced route of the headline batch
(n = 2^20 rows, k = 32 uniform ids of d = 2^18, numpy seed 0, as
``chip_smoke.py`` draws it; a minute of host time) and times every form on
its own planes: stage A as K6 (the dz tile) and as K4 (the value bake), and
stage B as K4.

Run on a machine with a CUDA card::

    python -m photon_tpu_torch.tools.probe_chunk_forms [--reps N] [--route]
"""

from __future__ import annotations

import argparse
import sys

import torch

from photon_tpu_torch.ops import vperm as vp
from photon_tpu_torch.tools.probe_common import bound_ms, card_line

CASES = (
    ("K4 balanced", 128, 2432, 0),
    ("K4 colored", 128, 4096, 0),
    ("K6 balanced", 128, 2432, 32),
    ("K4 small", 811, 384, 0),
)


def cuda_ms(fn, reps: int) -> float:
    for _ in range(3):
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


def random_planes(nc: int, ch: int, width: int, seed: int, dev):
    """src ``[nc*ch, width]`` and per-row permutation planes i1, i2, i3."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def perms(rows: int, n: int, dtype) -> torch.Tensor:
        keys = torch.rand(rows, n, generator=g, device=dev)
        return torch.argsort(keys, dim=1).to(dtype).contiguous()

    src = torch.randn(nc * ch, width, generator=g, device=dev)
    return (src, perms(nc * ch, vp.LANES, torch.int8),
            perms(nc * vp.LANES, ch, torch.int16),
            perms(nc * ch, vp.LANES, torch.int8))


def index_select_call(src, i1, i2, i3, nc: int, ch: int):
    """One ``index_select`` computing the same pass, its map composed here."""
    dev = src.device
    row = torch.arange(nc * ch, device=dev)[:, None]
    chunk = row // ch
    c = i3.long()
    r2 = i2.view(-1).long()[(chunk * vp.LANES + c) * ch + (row - chunk * ch)]
    src_row = chunk * ch + r2
    lane = i1.view(-1).long()[src_row * vp.LANES + c]
    width = src.shape[1]
    idx = (src_row * width + lane // (vp.LANES // width)).view(-1)
    flat = src.view(-1)
    return lambda: flat.index_select(0, idx).view(nc * ch, vp.LANES)


def candidate_forms(ch: int, width: int) -> list:
    return [("global", 0)] + [("cluster", cl) for cl in vp.CLUSTER_SIZES
                              if vp.cluster_fits(ch, width, cl)]


def route_planes(dev) -> list:
    """Cases on the planes of the headline batch's balanced route."""
    import numpy as np

    from photon_tpu_torch.ops.slab_reduce import build_aligned_layout

    n, k, d = 1 << 20, 32, 1 << 18
    rng = np.random.default_rng(0)
    ids = rng.integers(1, d, size=(n, k), dtype=np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    route = vp.build_balanced_aligned_route(build_aligned_layout(ids, vals, d), ids, dev)
    nc, ch = route.nc, route.ch
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    x = torch.randn(nc * ch, vp.LANES, generator=g, device=dev)
    dz = torch.randn(nc * ch, vp.LANES // route.k_expand, generator=g, device=dev)
    return [
        (f"route stage A (dz), k={route.k_expand}", nc, ch, route.k_expand,
         (dz, route.a1, route.a2, route.a3)),
        ("route stage A (bake)", nc, ch, 0, (x, route.a1, route.a2, route.a3)),
        ("route stage B", nc, ch, 0, (x, route.b1, route.b2, route.b3)),
    ]


def probe_case(label: str, nc: int, ch: int, k: int, reps: int, dev,
               args=None) -> bool:
    width = vp.LANES // k if k else vp.LANES
    wrapper, plain = ((vp.chunk_expand_pass, vp.chunk_expand_pass_plain) if k
                      else (vp.chunk_pass, vp.chunk_pass_plain))
    if args is None:
        args = random_planes(nc, ch, width, seed=nc + ch + k, dev=dev)
    ref = plain(*args, nc, ch)
    slots = nc * ch * vp.LANES
    nbytes = (8 * slots + 4 * nc * ch * width) if k else 12 * slots
    chosen = vp.chunk_form(nc, ch, width)
    lib = index_select_call(*args, nc, ch)
    print(f"{label}: nc={nc}, ch={ch}, width={width}, bound "
          f"{bound_ms(nbytes):.4f} ms (bytes), index_select "
          f"{cuda_ms(lib, reps):.4f} ms, plain {cuda_ms(lambda: plain(*args, nc, ch), reps):.4f} ms",
          flush=True)
    ok = True
    for form in candidate_forms(ch, width):
        got = vp.run_chunk_form(wrapper, form, *args, nc, ch)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        ok &= same
        ms = cuda_ms(lambda: vp.run_chunk_form(wrapper, form, *args, nc, ch), reps)
        active = (vp.max_active_clusters(ch, width, form[1])
                  if form[0] == "cluster" else "-")
        print(f"  {'*' if form == chosen else ' '} {form[0]:7s} CL={form[1]:2d}: "
              f"{ms:.4f} ms, max active clusters {active}, bit for bit "
              f"{'ok' if same else 'FAIL'}", flush=True)
    return ok


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--route", action="store_true",
                        help="also time the headline balanced route's own planes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_chunk_forms: needs a CUDA card (torch.cuda.is_available() is False)")
    from photon_tpu_torch.ops import _build

    dev = torch.device("cuda")
    print(f"card: {card_line()}", flush=True)
    _build.build_all()
    for line in _build.build_logs.get("vperm", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  [vperm] {line.strip()}")
    ok = all([probe_case(*case, args.reps, dev) for case in CASES])
    if args.route:
        ok &= all([probe_case(label, nc, ch, k, args.reps, dev, planes)
                   for label, nc, ch, k, planes in route_planes(dev)])
    if not ok:
        sys.exit("probe_chunk_forms: a form differs from its plain version")


if __name__ == "__main__":
    main()
