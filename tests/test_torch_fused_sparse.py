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


# -- the hot set and the row scatter ------------------------------------------
# The card's kernels route each id through its hot slot or its atomic; the
# hot set decides only the speed, so on the CPU it is held to its
# definition: the HOT_SLOTS most frequent ids among the entries with an id
# in [0, d) and a non-zero value, largest count first and the lower id first
# among equal counts, that hold at least ceil(entries / HOT_SHARE) entries.


def _hot_reference(ids, vals, d):
    flat, v = ids.reshape(-1), vals.reshape(-1)
    counts = np.bincount(flat[(flat >= 0) & (flat < d) & (v != 0)], minlength=d)[:d]
    order = np.argsort(-counts, kind="stable")[: fused_sparse.HOT_SLOTS]
    threshold = max(1, -(-flat.size // fused_sparse.HOT_SHARE))
    return order[counts[order] >= threshold]


def _hot_ids(hot):
    n_hot = int(hot[fused_sparse.HOT_SLOTS])
    assert (hot[n_hot:fused_sparse.HOT_SLOTS] == -1).all()
    return hot[:n_hot].numpy()


def _padded(rng, ids):
    """Values for ``ids`` with padded row tails (id 0, value 0)."""
    n, k = ids.shape
    vals = rng.standard_normal((n, k)).astype(np.float32)
    pad = np.arange(k)[None, :] >= rng.integers(1, k + 1, size=n)[:, None]
    ids[pad], vals[pad] = 0, 0.0
    return vals


@pytest.mark.parametrize("exponent", [1.1, 1.3, 2.0])
def test_hot_set_is_the_top_of_a_zipf_draw_and_deterministic(exponent):
    rng = np.random.default_rng(int(exponent * 10))
    d = 1 << 14
    ids = (1 + (rng.zipf(exponent, size=(4096, 32)) - 1) % (d - 1)).astype(np.int32)
    vals = _padded(rng, ids)
    t, tv = torch.as_tensor(ids), torch.as_tensor(vals)
    hot = fused_sparse.build_hot_set(t, tv, d)
    assert hot.dtype == torch.int32 and hot.shape == (fused_sparse.HOT_SLOTS + 1,)
    want = _hot_reference(ids, vals, d)
    assert 0 < want.size <= fused_sparse.HOT_SLOTS and 0 not in want
    np.testing.assert_array_equal(_hot_ids(hot), want)
    assert torch.equal(fused_sparse.build_hot_set(t.clone(), tv.clone(), d), hot)


@pytest.mark.parametrize("padded", [False, True])
def test_hot_set_is_empty_on_uniform_ids(padded):
    """Uniform ids make no feature hot, and neither do the pad slots."""
    rng = np.random.default_rng(21)
    d = 1 << 20  # about a sixteenth of an entry per feature: far below the share
    ids = rng.integers(1, d, size=(8192, 32), dtype=np.int32)
    vals = _padded(rng, ids) if padded else np.ones(ids.shape, np.float32)
    hot = fused_sparse.build_hot_set(torch.as_tensor(ids), torch.as_tensor(vals), d)
    assert int(hot[fused_sparse.HOT_SLOTS]) == 0
    assert (hot[:fused_sparse.HOT_SLOTS] == -1).all()


@pytest.mark.parametrize("d", [64, 2048])
def test_hot_set_of_a_small_dim_and_of_more_candidates_than_slots(d):
    """d = 64: every feature is hot; d = 2048: every feature passes the
    threshold, and the set keeps the HOT_SLOTS most frequent."""
    rng = np.random.default_rng(d)
    ids = rng.integers(0, d, size=(8192, 32), dtype=np.int32)
    vals = rng.standard_normal(ids.shape).astype(np.float32)
    hot = _hot_ids(fused_sparse.build_hot_set(torch.as_tensor(ids), torch.as_tensor(vals), d))
    assert hot.size == min(d, fused_sparse.HOT_SLOTS)
    np.testing.assert_array_equal(hot, _hot_reference(ids, vals, d))


def test_hot_set_counts_only_scattered_entries():
    """Ids outside [0, d) and entries with value 0 are not counted."""
    ids = np.zeros((64, 4), np.int32)
    ids[:, 1:] = [[-1, 7, 9]]
    vals = np.ones((64, 4), np.float32)
    hot = fused_sparse.build_hot_set(torch.as_tensor(ids), torch.as_tensor(vals), 8)
    np.testing.assert_array_equal(_hot_ids(hot), [0, 7])
    vals[:, 0] = 0.0
    hot = fused_sparse.build_hot_set(torch.as_tensor(ids), torch.as_tensor(vals), 8)
    np.testing.assert_array_equal(_hot_ids(hot), [7])


def test_hot_set_is_cached_per_tensor_version_and_dim():
    ids = torch.as_tensor(np.random.default_rng(3).zipf(1.5, size=(256, 8))
                          .clip(max=63).astype(np.int32))
    vals = torch.ones(ids.shape)
    first = fused_sparse.hot_set(ids, vals, 64)
    assert fused_sparse.hot_set(ids, vals, 64) is first
    assert fused_sparse.hot_set(ids, vals, 128) is not first
    again = fused_sparse.hot_set(ids, vals, 64)
    ids[:] = 5  # every entry now holds feature 5: the set is rebuilt
    rebuilt = fused_sparse.hot_set(ids, vals, 64)
    assert rebuilt is not again
    np.testing.assert_array_equal(_hot_ids(rebuilt.ids), [5])
    key = id(ids)
    del ids, first, again, rebuilt
    assert key not in fused_sparse._HOT_SETS


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_row_scatter_plain_matches_the_xla_scatter(dist):
    """The CPU path of the row scatter (the kernel's plain version) against
    the JAX package's ``zeros(d).at[ids].add(r[:, None] * vals)``, which
    sums in float32 (rtol 1e-5 of each feature's summed magnitudes)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    n, k, d = 600, 12, 96
    if dist == "zipf":
        ids = np.minimum(rng.zipf(1.3, size=(n, k)) - 1, d - 1).astype(np.int32)
    else:
        ids = rng.integers(0, d, size=(n, k), dtype=np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    r = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(jnp.zeros(d, jnp.float32).at[jnp.asarray(ids)].add(
        jnp.asarray(r)[:, None] * jnp.asarray(vals)))
    got = fused_sparse.row_scatter(torch.as_tensor(r), torch.as_tensor(ids),
                                   torch.as_tensor(vals), d)
    mag = np.zeros(d)
    np.add.at(mag, ids.reshape(-1), np.abs(r[:, None] * vals).reshape(-1))
    assert got.dtype == torch.float32
    np.testing.assert_array_less(np.abs(got.numpy() - ref), 1e-5 * mag + 1e-30)


def test_row_scatter_checks_and_bad_ids():
    r, vals = torch.ones(4), torch.ones(4, 3)
    ids = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_sparse.row_scatter(torch.ones(5), ids, vals, 8)
    with pytest.raises(ValueError):
        fused_sparse.row_scatter(r, ids, torch.ones(4, 2), 8)
    for bad in (-1, 8):
        ids[2, 1] = bad
        with pytest.raises(IndexError):
            fused_sparse.row_scatter(r, ids, vals, 8)
