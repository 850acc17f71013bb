"""Shared harness of the primitive probes.

Counterpart of ``tools/probe_common.py``.  A probe chains its operation
``CHAIN`` times with a data dependency from each step to the next, ends the
chain in one scalar and fetches that scalar to the host (``.item()``): no
step can be skipped or served from an earlier result, and the timed window
holds no copy of the payload.  :func:`timed` reports the median wall time
of 5 such runs after one untimed run; a probe divides it by ``CHAIN``.
PyTorch runs each operation as its own launch, so a chain of elementwise
steps needs no barrier against fusion.

On the CPU (``--device cpu``) the kernels' plain versions run: the tables
then check the code paths, and their times say nothing of the card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from photon_tpu_torch.device import resolve_device

CHAIN = 8
LANES = 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet


def timed(fn, *args, reps: int = 5) -> float:
    """Median wall seconds of ``fn(*args)``, each run ending in a host fetch
    of the scalar tensor it returns."""
    fn(*args).item()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args).item()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn`` on the card (``time.perf_counter``
    over ``calls`` calls, no synchronize between them): where it nears the
    kernel's time, back-to-back launches time the host, not the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def bound_ms(nbytes: float) -> float:
    """The least milliseconds the card could take to move ``nbytes`` through
    device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def row_perms(rows: int, width: int, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """``[rows, width]`` int32: an independent random permutation of
    ``range(width)`` in each row (random routing times like real routing)."""
    keys = torch.rand(rows, width, generator=gen, device=device)
    return torch.argsort(keys, dim=1).to(torch.int32)


def kernel_row(label: str, t: float, elems: int, nbytes: float,
               library_t: float, library: str) -> str:
    """The tail of a kernel row: rate, bound and the library call's time."""
    return (f"{label}  {t * 1e3:8.3f} ms  {elems / t / 1e6:9.1f} Melem/s  "
            f"bound {bound_ms(nbytes):.3f} ms  library ({library}) "
            f"{library_t * 1e3:.3f} ms")


def parse_args(description: str) -> tuple[int, torch.device]:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--entries", type=int, default=1 << 25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) runs the kernels on the card; cpu "
                    "runs their plain versions (timings meaningless)")
    args = ap.parse_args()
    return args.entries, resolve_device(args.device)


def header(device: torch.device, E: int) -> None:
    if device.type == "cuda":
        print(f"device={torch.cuda.get_device_name(device)} ({card_line()}) "
              f"E={E:,}")
    else:
        print(f"device=cpu (plain versions, timings meaningless) E={E:,}")


def run_all(probes, E: int, device: torch.device) -> None:
    """Run each probe; one that fails prints FAILED and the rest still run
    (partial output is still evidence)."""
    for probe in probes:
        try:
            probe(E, device)
        except Exception as e:  # noqa: BLE001 - report and continue
            print(f"{probe.__name__} FAILED: {type(e).__name__}: {str(e)[:160]}")
