"""PK2 (``lane_swap``) and PK7 (``lane_repeat``) on the card: every shape
their launch takes, bit for bit, and their times in turns with the PyTorch
call that computes the same function.

At E = ``--entries`` (default 2^25, ``rows = E / 128``):

  PK2  unmasked and masked at every tile height of ``probe_tiles`` and at
       ``rows - 1`` rows (a short last unit of the 8-row launch);
  PK7  at every k (1, 2, 4, ..., 128), at ``rows - 1`` rows and on an input
       view that is only 4-byte aligned.

Each case must equal its plain version and its library call (``flip``,
``torch.where`` + ``flip``, ``repeat_interleave``) bit for bit and move the
launch counter.  Then PK2 (h = 512; the launch is the same at every h) and
PK7 at every k take turns with their library calls: ``--rounds`` turns,
each a CUDA-event mean over ``--reps`` calls, medians and spreads, beside
the bound (bytes at 3.35 TB/s) and the wrapper's host microseconds per
call (``time.perf_counter`` over 200 calls, no synchronize between).

Last, the stores: ``probes.cu`` is built once more with the one 16-byte
store of ``lane_swap_kernel`` and of ``lane_repeat_kernel`` spelled the
other way (a plain store and ``__stcs``, the streaming store: the line each
kernel has becomes the other one), held to the plain versions, and timed in
turns with the kernels as they stand (PK2 unmasked and masked, PK7 at k =
32).

Run on a machine with a CUDA card::

    python -m photon_tpu_torch.tools.probe_lane_kernels [--entries E] [--reps N] [--rounds R]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import statistics
import subprocess
import sys

import torch

from photon_tpu_torch.ops import probe_kernels as pk
from photon_tpu_torch.tools.probe_chunk_forms import cuda_ms
from photon_tpu_torch.tools.probe_common import bound_ms, card_line, generator, host_us
from photon_tpu_torch.tools.probe_tiles import HEIGHTS

L = pk.LANES
KS = (1, 2, 4, 8, 16, 32, 64, 128)
# The two spellings of each kernel's output store: plain, and streaming
# (evict first).
STORES = {
    "lane_swap_kernel": ("dst[f] = s;", "__stcs(dst + f, s);"),
    "lane_repeat_kernel": ("dst[f] = v[u];", "__stcs(dst + f, v[u]);"),
}


def flip(x: torch.Tensor) -> torch.Tensor:
    return x.view(-1, 4, 32).flip(1).reshape_as(x)


def check(label: str, fn, plain, library, counter) -> bool:
    before = counter.launches
    got, ref, lib = fn(), plain(), library()
    torch.cuda.synchronize()
    same = torch.equal(got, ref) and torch.equal(got, lib)
    moved = counter.launches == before + 1
    print(f"  {label}: bitwise {'ok' if same else 'FAIL'}, launch counted "
          f"{'ok' if moved else 'FAIL'}", flush=True)
    return same and moved


def turns(fns: list, reps: int, rounds: int) -> list:
    """Per function (median, spread) of ``rounds`` turns, milliseconds."""
    ts = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(ts, fns):
            t.append(cuda_ms(fn, reps))
    return [(statistics.median(t), max(t) - min(t)) for t in ts]


def timed_row(label: str, fn, library, name: str, nbytes: float, reps: int,
              rounds: int) -> None:
    (k, ks), (lib, ls) = turns([fn, library], reps, rounds)
    b = bound_ms(nbytes)
    print(f"  {label}: kernel {k:.4f} ms (spread {ks:.4f}), {name} {lib:.4f} ms "
          f"(spread {ls:.4f}), bound {b:.4f} ms, {b / k:.0%} of it; wrapper "
          f"{host_us(fn):.1f} us host a call", flush=True)


def store_variant():
    """``probes.cu`` built with the store of each kernel in ``STORES`` spelled
    the other way; returns (library, {kernel: (its store, the variant's)})."""
    from photon_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "probes.cu")) as f:
        src = f.read()
    spelled = {}
    for kernel, pair in STORES.items():
        start = src.index(f"{kernel}(")
        end = src.index("\n}\n", start)
        body = src[start:end]
        shipped = next(s for s in pair if s in body)
        if body.count(shipped) != 1:
            raise RuntimeError(f"{kernel} has {body.count(shipped)} stores {shipped!r}")
        other = pair[1 - pair.index(shipped)]
        src = src[:start] + body.replace(shipped, other) + src[end:]
        spelled[kernel] = (shipped, other)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, f"probes_store_{tag}.cu")
    lib = os.path.join(_build.BUILD_DIR, f"libprobes_store_{tag}.so")
    if not os.path.exists(lib):
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                       check=True, capture_output=True)
    return ctypes.CDLL(lib), spelled


def variant_call(lib, name: str, argtypes: list, x: torch.Tensor, *args) -> torch.Tensor:
    """``photon_probe_<name>(x, *args, out, rows, last, stream)`` of the
    variant library into a new ``[rows, 128]`` output."""
    from photon_tpu_torch.ops import _build

    fn = getattr(lib, f"photon_probe_{name}")
    fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(x.shape[0], L, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    *ptrs, last = args
    _build.check(fn(x.data_ptr(), *ptrs, out.data_ptr(), x.shape[0], last, stream),
                 f"probes_store.{name}")
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--entries", type=int, default=1 << 25)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_lane_kernels: needs a CUDA card (torch.cuda.is_available() is False)")
    from photon_tpu_torch.ops import _build

    dev = torch.device("cuda")
    print(f"card: {card_line()}", flush=True)
    _build.build_all()
    for line in _build.build_logs.get("probes", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  [probes] {line.strip()}")
    rows = args.entries // L
    gen = generator(dev, 70)
    x = torch.rand(rows, L, generator=gen, device=dev)
    mask = (torch.rand(rows, L, generator=gen, device=dev) < 0.5).float()
    narrow = {k: torch.rand(rows, L // k, generator=gen, device=dev) for k in KS}
    flat = torch.rand(rows * (L // 32) + 1, generator=gen, device=dev)
    shifted = flat[1:].view(rows, L // 32)  # 4 bytes past a 16-byte boundary

    ok = True
    for n in (rows, rows - 1):
        a, m = x[:n], mask[:n]
        for h in HEIGHTS:
            ok &= check(f"PK2 unmasked h={h}, {n} rows", lambda: pk.lane_swap(a, h=h),
                        lambda: pk.lane_swap_plain(a, None, h), lambda: flip(a),
                        pk.lane_swap)
            ok &= check(f"PK2 masked h={h}, {n} rows", lambda: pk.lane_swap(a, m, h=h),
                        lambda: pk.lane_swap_plain(a, m, h),
                        lambda: torch.where(m > 0, flip(a), a), pk.lane_swap)
    cases = [(f"k={k}", narrow[k], k) for k in KS] + [
        (f"k=32, {rows - 1} rows", narrow[32][: rows - 1], 32),
        ("k=32, x 4 bytes past a 16-byte boundary", shifted, 32)]
    for label, a, k in cases:
        ok &= check(f"PK7 {label}", lambda: pk.lane_repeat(a, k),
                    lambda: pk.lane_repeat_plain(a, k),
                    lambda: a.repeat_interleave(k, dim=1), pk.lane_repeat)

    print(f"turns with the library call: medians of {args.rounds}, each a CUDA-event "
          f"mean over {args.reps} calls", flush=True)
    E = rows * L
    timed_row("PK2 unmasked", lambda: pk.lane_swap(x, h=512), lambda: flip(x), "flip",
              8 * E, args.reps, args.rounds)
    timed_row("PK2 masked", lambda: pk.lane_swap(x, mask, h=512),
              lambda: torch.where(mask > 0, flip(x), x), "where + flip", 12 * E,
              args.reps, args.rounds)
    for k in KS:
        a = narrow[k]
        timed_row(f"PK7 k={k}", lambda: pk.lane_repeat(a, k),
                  lambda: a.repeat_interleave(k, dim=1), "repeat_interleave",
                  4 * E + 4 * E // k, args.reps, args.rounds)

    lib, spelled = store_variant()
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    swap_args = [ptr] * 3 + [i64, i32]
    a = narrow[32]
    variants = [
        ("lane_swap_kernel", "PK2 unmasked", lambda: pk.lane_swap(x, h=512),
         lambda: variant_call(lib, "lane_swap", swap_args, x, None, 512),
         lambda: pk.lane_swap_plain(x)),
        ("lane_swap_kernel", "PK2 masked", lambda: pk.lane_swap(x, mask, h=512),
         lambda: variant_call(lib, "lane_swap", swap_args, x, mask.data_ptr(), 512),
         lambda: pk.lane_swap_plain(x, mask)),
        ("lane_repeat_kernel", "PK7 k=32", lambda: pk.lane_repeat(a, 32),
         lambda: variant_call(lib, "lane_repeat", [ptr] * 2 + [i64, i32], a, 32),
         lambda: pk.lane_repeat_plain(a, 32)),
    ]
    print("the stores, kernel as it stands against the variant:", flush=True)
    for kernel, label, fn, variant, plain in variants:
        same = torch.equal(variant(), plain())
        ok &= same
        (ks, kss), (vs, vss) = turns([fn, variant], args.reps, args.rounds)
        shipped, other = spelled[kernel]
        print(f"  {label}: {shipped!r} {ks:.4f} ms (spread {kss:.4f}), {other!r} "
              f"{vs:.4f} ms (spread {vss:.4f}); variant bitwise "
              f"{'ok' if same else 'FAIL'}", flush=True)
    if not ok:
        sys.exit("probe_lane_kernels: a case differs from its plain version or library call")


if __name__ == "__main__":
    main()
