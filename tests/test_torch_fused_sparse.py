"""Port parity: the plain version of the fused value+gradient kernel
(photon_tpu_torch.ops.fused_sparse) against the Pallas kernel
photon_tpu.ops.pallas_sparse.fused_value_and_grad in interpret mode.

Tolerances are those of tests/test_pallas_sparse.py: value rtol 2e-5;
gradient rtol 1e-3, atol 1e-4.  CPU tensors take the plain version, which
is also what the CUDA kernel is held against on the card (chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core.losses import get_loss as jax_loss
from photon_tpu.ops.pallas_sparse import fused_value_and_grad as jax_fused
from photon_tpu_torch.core.losses import get_loss
from photon_tpu_torch.ops import fused_sparse
from photon_tpu_torch.ops.fused_sparse import fused_value_and_grad


def _inputs(n=700, k=6, d=128, seed=0, poisson=False, zero_weight_frac=0.0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, d, size=(n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    cut = rng.integers(1, k + 1, size=n)  # padded row tails: id 0, val 0
    pad = np.arange(k)[None, :] >= cut[:, None]
    ids[pad], vals[pad] = 0, 0.0
    if poisson:
        label = rng.poisson(1.5, size=n).astype(np.float32)
    else:
        label = (rng.random(n) < 0.5).astype(np.float32)
    offset = (rng.standard_normal(n) * 0.1).astype(np.float32)
    weight = (rng.random(n) + 0.5).astype(np.float32)
    weight[rng.random(n) < zero_weight_frac] = 0.0
    w = (rng.standard_normal(d) * 0.2).astype(np.float32)
    return w, ids, vals, label, offset, weight


def _both(loss_name, arrays, block_rows):
    v_j, g_j = jax_fused(
        jax_loss(loss_name), *(jnp.asarray(a) for a in arrays),
        block_rows=block_rows, interpret=True,
    )
    v_t, g_t = fused_value_and_grad(
        get_loss(loss_name), *(torch.as_tensor(a) for a in arrays)
    )
    return (float(v_t), g_t.numpy()), (float(v_j), np.asarray(g_j))


@pytest.mark.parametrize(
    "loss_name", ["logistic", "squared", "poisson", "smoothed_hinge"]
)
def test_plain_matches_pallas_per_loss(loss_name):
    arrays = _inputs(poisson=loss_name == "poisson", seed=len(loss_name))
    (v, g), (v_ref, g_ref) = _both(loss_name, arrays, 256)
    np.testing.assert_allclose(v, v_ref, rtol=2e-5)
    np.testing.assert_allclose(g, g_ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n,block_rows", [(130, 64), (3, 1024)])
def test_plain_matches_pallas_with_row_padding(n, block_rows):
    """Row counts that are not a multiple of the Pallas block."""
    arrays = _inputs(n=n, k=4, d=64, seed=3, zero_weight_frac=0.2)
    (v, g), (v_ref, g_ref) = _both("logistic", arrays, block_rows)
    np.testing.assert_allclose(v, v_ref, rtol=2e-5)
    np.testing.assert_allclose(g, g_ref, rtol=1e-3, atol=1e-4)


def test_zero_weight_rows_contribute_nothing():
    w, ids, vals, label, offset, weight = _inputs(n=64, k=4, d=32, seed=5)
    weight[::2] = 0.0
    t = [torch.as_tensor(a) for a in (w, ids, vals, label, offset, weight)]
    v, g = fused_value_and_grad(get_loss("logistic"), *t)
    keep = slice(1, None, 2)
    v2, g2 = fused_value_and_grad(
        get_loss("logistic"), t[0], *(a[keep] for a in t[1:])
    )
    assert float(v) == pytest.approx(float(v2), rel=1e-6)
    np.testing.assert_allclose(g.numpy(), g2.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad_id", [-1, 32])
def test_ids_outside_dim_raise_index_error(bad_id):
    """The plain version raises on an id outside [0, d); the kernel's wrapper
    raises the same exception from the kernel's flag (chip_smoke.py)."""
    w, ids, vals, label, offset, weight = _inputs(n=16, k=4, d=32, seed=6)
    ids[5, 1] = bad_id
    t = [torch.as_tensor(a) for a in (w, ids, vals, label, offset, weight)]
    with pytest.raises(IndexError):
        fused_value_and_grad(get_loss("logistic"), *t)


def test_checked_ids_are_keyed_by_tensor_version_and_dim():
    """The card reads the kernel's id flag only for ids tensors it has not
    found clean yet; a new tensor, another d or an in-place change reads it
    again, and a freed tensor leaves no entry."""
    ids = torch.zeros((4, 2), dtype=torch.int32)
    assert not fused_sparse._ids_checked(ids, 8)
    fused_sparse._mark_ids_checked(ids, 8)
    assert fused_sparse._ids_checked(ids, 8)
    assert not fused_sparse._ids_checked(ids, 4)
    assert not fused_sparse._ids_checked(ids.clone(), 8)
    ids[0, 0] = 9
    assert not fused_sparse._ids_checked(ids, 8)
    key = id(ids)
    del ids
    assert key not in fused_sparse._CHECKED_IDS


def test_empty_batch_and_input_checks():
    loss = get_loss("logistic")
    w = torch.zeros(16)
    empty = (torch.zeros((0, 3), dtype=torch.int32), torch.zeros((0, 3)),
             torch.zeros(0), torch.zeros(0), torch.zeros(0))
    v, g = fused_value_and_grad(loss, w, *empty)
    assert float(v) == 0.0 and not g.any()
    with pytest.raises(TypeError):
        fused_value_and_grad(loss, w, empty[0].long(), *empty[1:])
    with pytest.raises(ValueError):
        fused_value_and_grad(loss, w, *empty[:2], torch.zeros(2), *empty[3:])
