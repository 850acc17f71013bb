"""Port parity: photon_tpu_torch.ops.slab_reduce against
photon_tpu.ops.pallas_gather.

The host layout builders are copies, so their arrays must be bit-identical
to the reference's on the same ids.  The plain position-reduce is held
against the Pallas kernel ``_position_partial_sums`` in interpret mode, and
the forward and gradient against ``aligned_segment_grad`` in interpret
mode, with the tolerance of tests/test_pallas_gather.py (rtol 2e-5, atol
1e-6): two float32 sums over the same slots in different orders.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops import pallas_gather as jg
from photon_tpu_torch.ops import slab_reduce as tg

RTOL, ATOL = 2e-5, 1e-6


def _coo(n=1024, k=8, d=512, seed=0, dist="uniform"):
    rng = np.random.default_rng(seed)
    if dist == "zipf":
        ids = ((rng.zipf(1.3, size=(n, k)) - 1) % d).astype(np.int32)
    else:
        ids = rng.integers(0, d, size=(n, k), dtype=np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    cut = rng.integers(1, k + 1, size=n)
    mask = np.arange(k)[None, :] < cut[:, None]
    return np.where(mask, ids, 0), np.where(mask, vals, 0.0).astype(np.float32)


def _assert_same_layout(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_layout_builders_bit_identical(dist):
    ids, vals = _coo(dist=dist, seed=1)
    _assert_same_layout(
        tg.build_aligned_layout(ids, vals, 512), jg.build_aligned_layout(ids, vals, 512)
    )
    _assert_same_layout(
        tg.build_row_aligned_layout(ids, vals), jg.build_row_aligned_layout(ids, vals)
    )
    lay_t = tg.build_aligned_layout(ids, vals, 512)
    lay_j = jg.build_aligned_layout(ids, vals, 512)
    target = (lay_t.n_slabs + 2, lay_t.n_tiles + 5)
    _assert_same_layout(
        tg.pad_aligned_layout(lay_t, *target), jg.pad_aligned_layout(lay_j, *target)
    )
    dev_t = tg.device_layout(lay_t, "cpu")
    dev_j = jg.device_layout(lay_j)
    for name in ("grad_perm", "sorted_feats", "dup_map", "slab_of_tile"):
        np.testing.assert_array_equal(
            getattr(dev_t, name).numpy(), np.asarray(getattr(dev_j, name)), name
        )


def test_builders_reject_out_of_range_and_handle_empty():
    with pytest.raises(ValueError, match="out of range"):
        tg.build_aligned_layout(np.array([[0, 5]], np.int32), np.ones((1, 2), np.float32), 4)
    lay = tg.build_aligned_layout(np.zeros((4, 3), np.int32), np.zeros((4, 3), np.float32), 64)
    assert lay.n_entries == 0 and lay.n_tiles == 1
    with pytest.raises(ValueError):
        tg.pad_aligned_layout(lay, 3, 2)  # two pad slabs need two pad tiles


@pytest.mark.parametrize("dist,padded", [("uniform", False), ("zipf", False), ("zipf", True)])
def test_plain_position_reduce_matches_pallas(dist, padded):
    ids, vals = _coo(dist=dist, seed=2)
    lay = tg.build_aligned_layout(ids, vals, 512)
    if padded:
        lay = tg.pad_aligned_layout(lay, lay.n_slabs + 2, lay.n_tiles + 3)
    rng = np.random.default_rng(3)
    pv = (rng.standard_normal(lay.vals.shape) * (lay.vals != 0)).astype(np.float32)
    got = tg.position_partial_sums(
        torch.as_tensor(lay.slab_of_tile), torch.as_tensor(pv),
        torch.as_tensor(lay.lo), lay.n_slabs,
    )
    want = jg._position_partial_sums(
        jnp.asarray(lay.slab_of_tile), jnp.asarray(pv), jnp.asarray(lay.lo),
        n_slabs=lay.n_slabs, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if padded:  # every pad slab comes out written, as zeros
        assert not got[-2 * tg.SUBLANES:].any()
    assert tg.position_partial_sums.launches == 0  # CPU tensors: plain version


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
@pytest.mark.parametrize("direction", ["gradient", "forward"])
def test_aligned_segment_grad_matches_pallas(dist, direction):
    n, d = 1024, 512
    ids, vals = _coo(n=n, d=d, dist=dist, seed=4)
    rng = np.random.default_rng(5)
    if direction == "gradient":
        lay, out_dim = tg.build_aligned_layout(ids, vals, d), d
        per_row = rng.standard_normal(n).astype(np.float32)
    else:
        lay, out_dim = tg.build_row_aligned_layout(ids, vals), n
        per_row = rng.standard_normal(d).astype(np.float32)
    got = tg.aligned_segment_grad(
        torch.as_tensor(per_row), tg.device_layout(lay, "cpu"), out_dim
    )
    want = jg.aligned_segment_grad(
        jnp.asarray(per_row), jg.device_layout(lay), out_dim, interpret=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_wrapper_checks_inputs():
    slab = torch.zeros(1, dtype=torch.int32)
    pv = torch.zeros(tg.TILE_SUBLANES, tg.LANES)
    lo = torch.zeros(tg.TILE_SUBLANES, tg.LANES, dtype=torch.int32)
    with pytest.raises(ValueError):
        tg.position_partial_sums(slab, pv[:8], lo, 1)
    with pytest.raises(TypeError):
        tg.position_partial_sums(slab, pv.double(), lo, 1)
    with pytest.raises(TypeError):
        tg.position_partial_sums(slab, pv, lo.long(), 1)
