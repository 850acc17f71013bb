"""FULL variances without the dense Hessian: ``diag(H^-1)`` from CG solves.

Counterpart of ``photon_tpu/core/variance.py``.  Up to
``FULL_DENSE_MAX_DIM`` the FULL variance inverts the dense Hessian
(``core/problem.py``); above it, a dense ``[d, d]`` Hessian is out of
reach (256 GB at d = 2^18), so ``diag(H^-1)`` is estimated matrix-free:
conjugate-gradient solves against the Hessian-vector product and the
Hutchinson estimator ``diag(H^-1) ~ E_z[z * H^-1 z]`` over Rademacher
probes ``z``.  The estimate is exact for a diagonal Hessian and otherwise
converges as 1/sqrt(probes).

The probes come from an explicit ``torch.Generator`` seeded by ``seed``
(on the host, then moved to the device), or are passed in as ``probes``:
the JAX package draws them from ``jax.random``, whose bits no torch
generator gives, so tests hand both sides the same numpy probes or hold
both to the dense answer.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

Tensor = torch.Tensor

FULL_DENSE_MAX_DIM = 8192


def cg_solve(hvp: Callable[[Tensor], Tensor], b: Tensor, tol: float = 1e-6,
             max_iterations: int = 250) -> Tensor:
    """Conjugate gradient for ``H x = b`` (H SPD) until ``|r| <= tol |b|``
    or the iteration cap; one host read per step (the stop test)."""
    b_norm = float(torch.linalg.vector_norm(b))
    limit = tol * max(b_norm, 1e-30)
    x = torch.zeros_like(b)
    r, p = b, b
    rs = torch.dot(b, b)
    it = 0
    while float(torch.sqrt(rs)) > limit and it < max_iterations:
        hp = hvp(p)
        alpha = rs / torch.clamp(torch.dot(p, hp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * hp
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
        it += 1
    return x


def rademacher_probes(dim: int, num_probes: int, seed: int = 0,
                      device=None) -> Tensor:
    """``[num_probes, dim]`` float32 entries of +-1 from a seeded
    ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.randint(0, 2, (num_probes, dim), generator=gen, dtype=torch.int8)
    return (2.0 * z.float() - 1.0).to(device)


def hutchinson_diag_inverse(
    hvp: Callable[[Tensor], Tensor],
    dim: int,
    seed: int = 0,
    num_probes: int = 32,
    cg_tol: float = 1e-5,
    cg_max_iterations: int = 250,
    jitter: float = 1e-9,
    device=None,
    probes: Optional[np.ndarray | Tensor] = None,
) -> Tensor:
    """Estimate ``diag(H^-1)`` from Rademacher probes and CG solves.

    ``probes`` (``[num_probes, dim]``) replaces the seeded draw.  The
    ``jitter * I`` term keeps CG defined where H is singular (no
    regularization and unreached features), as the dense path's jitter
    does."""
    if probes is None:
        probes = rademacher_probes(dim, num_probes, seed, device)
    else:
        probes = torch.as_tensor(np.asarray(probes, np.float32), device=device)
    total = torch.zeros(dim, dtype=torch.float32, device=probes.device)
    for z in probes:
        x = cg_solve(lambda v: hvp(v) + jitter * v, z, tol=cg_tol,
                     max_iterations=cg_max_iterations)
        total = total + z * x
    # H is SPD, so diag(H^-1) > 0; clamp estimator noise.
    return torch.clamp(total / probes.shape[0], min=0.0)
