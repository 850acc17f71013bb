"""Tile-height probe: the same kernel at varying tile heights.

Counterpart of ``tools/probe_tiles.py``.  The reference timed a minimal
copy-scale kernel and the swap-stage kernel over a sweep of tile heights at
a fixed total size, to ask whether the TPU's time per element depended on
the grid step.  Here ``h`` is the height of the tiles of 128 lanes that the
rows are cut into.  Both kernels here, PK3 copy-scale and PK2's unmasked
lane swap (``ops/probe_kernels.py``), only validate ``h``: each launch is
the same at every ``h`` (blocks of 8 rows, ``rows / 8`` of them), so the
rows of a sweep differ by noise alone and say nothing about tiles on this
card.
Each row also prints its bound and the time of one PyTorch call that
computes the same function.  Run::

    python -m photon_tpu_torch.tools.probe_tiles [--entries E] [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from photon_tpu_torch.ops import probe_kernels as pk
from photon_tpu_torch.tools.probe_common import (
    CHAIN,
    LANES,
    bound_ms,
    generator,
    header,
    parse_args,
    timed,
)

HEIGHTS = (8, 32, 128, 512, 2048, 8192)


def copy_library(x: torch.Tensor) -> torch.Tensor:
    return x * pk.SCALE


def swap_library(x: torch.Tensor) -> torch.Tensor:
    return x.view(-1, 4, 32).flip(1).reshape_as(x)


def copy_kernel(x: torch.Tensor, h: int) -> torch.Tensor:
    return pk.copy_scale(x, h=h)


def swap_kernel(x: torch.Tensor, h: int) -> torch.Tensor:
    return pk.lane_swap(x, h=h)


def _chain(step):
    def g(x):
        y = x
        for _ in range(CHAIN):
            y = step(y)
        return y.sum()
    return g


def sweep(kernel, library, name: str, E: int, device) -> dict:
    """``{h: seconds}`` of ``kernel`` at each tile height that divides the
    rows."""
    rows = E // LANES
    x0 = torch.rand(rows, LANES, generator=generator(device, 0), device=device)
    t_lib = timed(_chain(library), x0) / CHAIN
    out = {}
    for h in HEIGHTS:
        if rows % h:
            continue
        n_tiles = rows // h
        t = timed(_chain(lambda y, h=h: kernel(y, h)), x0) / CHAIN
        out[h] = t
        print(f"{name} h={h:<5} tiles={n_tiles:<6} {t*1e3:8.3f} ms  "
              f"{E/t/1e6:9.1f} Melem/s  {E*4*2/t/1e9:7.2f} GB/s r+w  "
              f"{t/n_tiles*1e6:8.3f} us/tile  bound {bound_ms(8 * E):.3f} ms  "
              f"library {t_lib*1e3:.3f} ms")
    return out


def elementwise_baseline(E: int, device) -> float:
    x0 = torch.rand(E // LANES, LANES, generator=generator(device, 1), device=device)
    # Every step is its own launch in PyTorch: no barrier needed against a
    # fused chain.
    t = timed(_chain(copy_library), x0) / CHAIN
    print(f"torch elementwise baseline     {t*1e3:8.3f} ms  "
          f"{E/t/1e6:9.1f} Melem/s  {E*4*2/t/1e9:7.2f} GB/s r+w")
    return t


def probe_copy(E: int, device) -> dict:
    return sweep(copy_kernel, copy_library, "copy (PK3)", E, device)


def probe_swap(E: int, device) -> dict:
    return sweep(swap_kernel, swap_library, "swap (PK2)", E, device)


def main() -> None:
    E, device = parse_args(__doc__.splitlines()[0])
    header(device, E)
    elementwise_baseline(E, device)
    for probe in (probe_copy, probe_swap):
        try:
            probe(E, device)
        except Exception as e:  # noqa: BLE001 - the probe reports, never crashes
            print(f"{probe.__name__} FAILED: {type(e).__name__}: {str(e)[:90]}")


if __name__ == "__main__":
    main()
