"""Hand-written kernels and their plain PyTorch versions.

Each kernel's wrapper counts its launches in ``launches`` (a bf16 form's
also in ``bf16_launches``).  :func:`kernel_wrappers` lists every wrapper and
:func:`launch_counts` reads them, so a process can report which kernels it
ran (a serving child does, in its ready file and stats frame).
"""

from __future__ import annotations


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
            vp.lane_pass, vp.chunk_expand_pass, aligned_gather_products,
            vp.compensated_scan, *pk.KERNELS]


def launch_counts() -> dict:
    """This process's launches of every kernel, by wrapper name; a bf16
    form's launches under the name plus ``_bf16``."""
    counts = {}
    for wrapper in kernel_wrappers():
        counts[wrapper.__name__] = int(wrapper.launches)
        if hasattr(wrapper, "bf16_launches"):
            counts[wrapper.__name__ + "_bf16"] = int(wrapper.bf16_launches)
    return counts
