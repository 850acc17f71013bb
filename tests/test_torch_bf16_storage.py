"""Port parity for bf16 feature storage and the half-width exchange payload.

The port's bf16 against the JAX package's bf16 on the same numpy inputs, at
the f32 parity tolerances of tests/test_torch_objective.py (value rtol 1e-5;
gradient rtol 2e-4, atol 1e-5): both compute on the same bf16-rounded values
in float32.  The port's bf16 against the port's f32 at the reference's own
bounds (tests/test_bf16_storage.py: value rtol 2e-2; gradient rtol 5e-2,
atol 2e-2; AUC within 0.05).  The GAME fits at tests/test_torch_ooc_game.py's
tolerances.  The half-width payload at tests/test_vperm.py's bound (atol
2e-2 of the gradient's scale, the knob engaged).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxOpt
from photon_tpu.core.problem import ProblemConfig as JaxProblem
from photon_tpu.data.batch import SparseBatch as JaxBatch
from photon_tpu.data.batch import attach_feature_major as jax_attach
from photon_tpu.data.batch import batch_astype as jax_astype
from photon_tpu.data.batch import dense_batch as jax_dense_batch
from photon_tpu.data.synthetic import make_game_dataset as jax_make_game_dataset
from photon_tpu.game import coordinate as jcoord
from photon_tpu.game.data import DenseShard as JaxDenseShard
from photon_tpu.game.data import GameDataset as JaxGameDataset
from photon_tpu.game.data import SparseShard as JaxSparseShard
from photon_tpu.game.data import dataset_astype as jax_dataset_astype
from photon_tpu.game.data import split_game_dataset as jax_split
from photon_tpu.game.estimator import GameEstimator as JaxEstimator
from photon_tpu.game.estimator import GameOptimizationConfiguration as JaxConfig
from photon_tpu.ops.vperm import build_xchg_sorted_route as jax_sorted_route
from photon_tpu.ops.vperm import xchg_segment_grad as jax_xchg_segment_grad
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.data.batch import (
    DenseBatch,
    SparseBatch,
    attach_feature_major,
    batch_astype,
    dense_batch,
    pad_batch,
)
from photon_tpu_torch.drivers import train, train_game
from photon_tpu_torch.game import coordinate as tcoord
from photon_tpu_torch.game import lowp
from photon_tpu_torch.game.data import (
    DenseShard,
    GameDataset,
    SparseShard,
    dataset_astype,
    merge_buckets,
    pad_bucket_rows,
    take_rows,
)
from photon_tpu_torch.game.estimator import GameEstimator, GameOptimizationConfiguration
from photon_tpu_torch.game.tiles import per_row_bytes
from photon_tpu_torch.ops import fused_sparse, slab_reduce
from photon_tpu_torch.ops import vperm as tv

VALUE_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-4, 1e-5  # tests/test_torch_objective.py
REF_VALUE_RTOL, REF_GRAD_RTOL, REF_GRAD_ATOL = 2e-2, 5e-2, 2e-2  # tests/test_bf16_storage.py
AUC_TOL = 0.05  # tests/test_bf16_storage.py:108
RMS_TOL, MAX_TOL, METRIC_TOL = 1e-4, 5e-4, 1e-4  # tests/test_torch_ooc_game.py
D = 48


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PHOTON_ROUTE_CACHE", "0")  # the JAX side's disk cache
    for var in ("PHOTON_XCHG_REDUCE", "PHOTON_XCHG_DTYPE", "PHOTON_SPARSE_GRAD"):
        monkeypatch.delenv(var, raising=False)


def _arrays(n=512, k=6, d=D, seed=0):
    """tests/test_bf16_storage.py's batch (ids from 1; no pads) with offsets
    and weights."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, d, size=(n, k), dtype=np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    label = (rng.random(n) < 0.5).astype(np.float32)
    offset = (rng.standard_normal(n) * 0.1).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return ids, vals, label, offset, weight


def _w(seed=1, d=D):
    return (np.random.default_rng(seed).standard_normal(d) * 0.3).astype(np.float32)


def _batches(arrays, aligned: bool):
    """(JAX f32, JAX bf16, port f32, port bf16), each attached as the route
    set in the environment wants (layouts and routes built before the
    conversion, as the drivers build them)."""
    jb = jax_attach(JaxBatch(*(jnp.asarray(a) for a in arrays)),
                    aligned_dim=D if aligned else None)
    tb = attach_feature_major(SparseBatch(*(torch.as_tensor(a) for a in arrays)),
                              aligned_dim=D if aligned else None)
    return jb, jax_astype(jb, jnp.bfloat16), tb, batch_astype(tb, torch.bfloat16)


# Each route of the port with bf16 values: (PHOTON_SPARSE_GRAD, reduce,
# payload, k).  At k = 8 (k divides 128) the balanced exchange expands dz
# inside stage A (K6); at k = 6 the repeated stream rides K4.
ROUTES = [
    ("fused", None, None, 6), ("fm", None, None, 6), ("autodiff", None, None, 6),
    ("pallas", None, None, 6), ("benes", None, None, 6),
    ("xchg", "aligned", "float32", 6), ("xchg", "aligned", "bfloat16", 6),
    ("xchg", "aligned", "float32", 8), ("xchg", "aligned", "bfloat16", 8),
    ("xchg", "cumsum", "float32", 6), ("xchg", "cumsum", "bfloat16", 6),
]


@pytest.mark.usefixtures("native_router")
@pytest.mark.parametrize("route,reduce,payload,k", ROUTES,
                         ids=["-".join(str(x) for x in r if x) for r in ROUTES])
def test_bf16_value_grad_hv_match_jax_and_track_f32(monkeypatch, route, reduce, payload, k):
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", route)
    if reduce:
        monkeypatch.setenv("PHOTON_XCHG_REDUCE", reduce)
        monkeypatch.setenv("PHOTON_XCHG_DTYPE", payload)
    jb, jb16, tb, tb16 = _batches(_arrays(k=k), aligned=route != "fused")
    if route == "xchg" and reduce == "aligned":
        assert bool(getattr(tb16.xchg.route, "k_expand", 0)) == (k == 8)
    assert tb16.vals.dtype == torch.bfloat16 and tb16.label.dtype == torch.float32
    if tb16.fm is not None:
        assert tb16.fm.vals.dtype == torch.bfloat16
    if route in ("pallas", "xchg", "benes"):
        assert tb16.al.vals.dtype == torch.bfloat16
    if tb16.xchg is not None and tb16.xchg.vals_dest is not None:
        assert tb16.xchg.vals_dest.dtype == torch.bfloat16
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 1.0))
    jobj = JaxObjective.create("logistic", JaxReg("l2", 1.0))
    assert obj._sparse_kernel(tb16, D) == route
    w = _w()
    v16, g16 = obj.value_and_grad(torch.as_tensor(w), tb16)
    assert v16.dtype == torch.float32 and g16.dtype == torch.float32
    jv16, jg16 = jobj.value_and_grad(jnp.asarray(w), jb16)
    np.testing.assert_allclose(float(v16), float(jv16), rtol=VALUE_RTOL)
    np.testing.assert_allclose(g16.numpy(), np.asarray(jg16), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    v32, g32 = obj.value_and_grad(torch.as_tensor(w), tb)
    np.testing.assert_allclose(float(v16), float(v32), rtol=REF_VALUE_RTOL)
    np.testing.assert_allclose(g16.numpy(), g32.numpy(), rtol=REF_GRAD_RTOL,
                               atol=REF_GRAD_ATOL)
    v = np.random.default_rng(5).standard_normal(D).astype(np.float32)
    hv16 = obj.hessian_vector(torch.as_tensor(w), torch.as_tensor(v), tb16)
    jhv16 = np.asarray(jobj.hessian_vector_product(jnp.asarray(w), jnp.asarray(v), jb16))
    np.testing.assert_allclose(hv16.numpy(), jhv16, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * max(1.0, float(np.abs(jhv16).max())))


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_bf16_second_order_terms_match_jax(kind):
    """The Hessian diagonal and matrix on a bf16 batch: the dense square in
    the storage dtype, the sparse one in float32 after the coefficient, as
    the reference promotes them."""
    rng = np.random.default_rng(2)
    if kind == "dense":
        x = rng.standard_normal((128, 16)).astype(np.float32)
        y = (rng.random(128) < 0.5).astype(np.float32)
        tb16 = batch_astype(dense_batch(x, y, device="cpu"), "bfloat16")
        jb16 = jax_astype(jax_dense_batch(x, y), jnp.bfloat16)
        d = 16
    else:
        arrays = _arrays(n=128, k=4, d=16, seed=3)
        tb16 = batch_astype(SparseBatch(*(torch.as_tensor(a) for a in arrays)), "bfloat16")
        jb16 = jax_astype(JaxBatch(*(jnp.asarray(a) for a in arrays)), jnp.bfloat16)
        d = 16
    w = (rng.standard_normal(d) * 0.2).astype(np.float32)
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 0.5))
    jobj = JaxObjective.create("logistic", JaxReg("l2", 0.5))
    wt = torch.as_tensor(w)
    np.testing.assert_allclose(float(obj.value(wt, tb16)),
                               float(jobj.value(jnp.asarray(w), jb16)), rtol=VALUE_RTOL)
    np.testing.assert_allclose(obj.hessian_diagonal(wt, tb16).numpy(),
                               np.asarray(jobj.hessian_diagonal(jnp.asarray(w), jb16)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(obj.hessian_matrix(wt, tb16).numpy(),
                               np.asarray(jobj.hessian_matrix(jnp.asarray(w), jb16)),
                               rtol=1e-3, atol=1e-3)


def test_bf16_dense_batch():
    """tests/test_bf16_storage.py::test_bf16_dense_batch, and the port's
    bf16 against the JAX package's."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((128, 16)).astype(np.float32)
    y = (rng.random(128) < 0.5).astype(np.float32)
    b = dense_batch(x, y, device="cpu")
    b16 = batch_astype(b, torch.bfloat16)
    assert isinstance(b16, DenseBatch) and b16.x.dtype == torch.bfloat16
    obj = GlmObjective.create("logistic")
    w = torch.as_tensor(rng.standard_normal(16).astype(np.float32)) * 0.2
    v32, _ = obj.value_and_grad(w, b)
    v16, g16 = obj.value_and_grad(w, b16)
    np.testing.assert_allclose(float(v16), float(v32), rtol=REF_VALUE_RTOL)
    jv16, jg16 = JaxObjective.create("logistic").value_and_grad(
        jnp.asarray(w.numpy()), jax_astype(jax_dense_batch(x, y), jnp.bfloat16))
    np.testing.assert_allclose(float(v16), float(jv16), rtol=VALUE_RTOL)
    np.testing.assert_allclose(g16.numpy(), np.asarray(jg16), rtol=GRAD_RTOL, atol=GRAD_ATOL)


# Values around bf16's rounding: ties to even both ways, the largest finite
# bf16 and past it, signed zeros, infinities, subnormals.
SPECIAL = np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8), 3.3895314e38,
                    3.40e38, 0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-39, 7.0e-3],
                   np.float32)


def test_bf16_bits_equal_the_jax_package(monkeypatch):
    """batch_astype's and dataset_astype's bf16 values, as uint16 bit
    patterns, equal the JAX package's (round to nearest even)."""
    ids, vals, label, offset, weight = _arrays(n=64, k=6, seed=9)
    vals = vals * 37.0
    vals.reshape(-1)[: SPECIAL.size] = SPECIAL
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "pallas")
    arrays = (ids, vals, label, offset, weight)
    _, jb16, _, tb16 = _batches(arrays, aligned=True)

    def bits(t: torch.Tensor) -> np.ndarray:
        return t.view(torch.int16).numpy().view(np.uint16).reshape(-1)

    def jbits(a) -> np.ndarray:
        return np.asarray(a).view(np.uint16).reshape(-1)

    np.testing.assert_array_equal(bits(tb16.vals), jbits(jb16.vals))
    np.testing.assert_array_equal(bits(tb16.fm.vals), jbits(jb16.fm.vals))
    np.testing.assert_array_equal(bits(tb16.al.vals), jbits(jb16.al.vals))
    dense = np.concatenate([vals, SPECIAL[None, :6].repeat(64, 0)], axis=1)
    port = dataset_astype(GameDataset.create(label, {
        "d": DenseShard(dense), "s": SparseShard(ids, vals, D)}), "bfloat16")
    ref = jax_dataset_astype(JaxGameDataset.create(label, {
        "d": JaxDenseShard(dense), "s": JaxSparseShard(ids, vals, D)}), jnp.bfloat16)
    assert port.shards["d"].x.dtype == np.uint16
    np.testing.assert_array_equal(port.shards["d"].x, np.asarray(ref.shards["d"].x).view(np.uint16))
    np.testing.assert_array_equal(port.shards["s"].vals,
                                  np.asarray(ref.shards["s"].vals).view(np.uint16))
    np.testing.assert_array_equal(port.shards["s"].ids, ids)
    # Converting again, or back, is exact; labels stay float32.
    again = dataset_astype(port, torch.bfloat16)
    np.testing.assert_array_equal(again.shards["s"].vals, port.shards["s"].vals)
    back = dataset_astype(port, "float32")
    np.testing.assert_array_equal(back.shards["s"].vals,
                                  np.asarray(ref.shards["s"].vals, np.float32))
    assert port.label.dtype == np.float32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dataset_astype(port, "float16")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        batch_astype(tb16, torch.float16)


def test_bf16_shards_move_unchanged_through_the_host_pipeline():
    """Row gathers, merges and padding move the bf16 bits; the upload views
    them as torch.bfloat16 and the budget helpers count 2 bytes a value."""
    rng = np.random.default_rng(4)
    n = 40
    x = rng.standard_normal((n, 5)).astype(np.float32)
    ids = rng.integers(0, 9, size=(n, 3)).astype(np.int32)
    vals = rng.standard_normal((n, 3)).astype(np.float32)
    data = GameDataset.create((rng.random(n) < 0.5).astype(np.float32), {
        "d": DenseShard(x), "s": SparseShard(ids, vals, 9)},
        id_columns={"e": rng.integers(0, 6, n)})
    b16 = dataset_astype(data, "bfloat16")
    sub = take_rows(b16, np.arange(0, n, 3))
    assert sub.shards["d"].x.dtype == np.uint16
    np.testing.assert_array_equal(lowp.host_f32(sub.shards["d"].x),
                                  lowp.host_f32(b16.shards["d"].x)[::3])
    dev = lowp.feature_tensor(b16.shards["s"].vals, "cpu")
    assert dev.dtype == torch.bfloat16
    np.testing.assert_array_equal(dev.float().numpy(), lowp.host_f32(b16.shards["s"].vals))
    assert per_row_bytes(b16) == per_row_bytes(data) - 2 * (5 + 3)
    ds = tcoord.build_random_effect_dataset(b16, "e", "s")
    merged = pad_bucket_rows(merge_buckets(list(ds.buckets)), 4)
    assert merged.features.vals.dtype == np.uint16


def test_aligned_layout_survives_astype_and_pad_strip(monkeypatch):
    """tests/test_fast_sparse.py:455-475: batch_astype converts al.vals in
    place; pad_batch strips the row-structure layouts."""
    from photon_tpu.data.batch import pad_batch as jax_pad

    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "pallas")
    rng = np.random.default_rng(70)
    arrays = (rng.integers(0, 32, size=(64, 4)).astype(np.int32),
              rng.standard_normal((64, 4)).astype(np.float32),
              (rng.random(64) < 0.5).astype(np.float32),
              np.zeros(64, np.float32), np.ones(64, np.float32))
    fast = attach_feature_major(SparseBatch(*(torch.as_tensor(a) for a in arrays)),
                                aligned_dim=32)
    bf16 = batch_astype(fast, torch.bfloat16)
    assert bf16.al is not None and bf16.al.vals.dtype == torch.bfloat16
    obj = GlmObjective.create("logistic")
    w = (rng.standard_normal(32) * 0.1).astype(np.float32)
    jfast = jax_attach(JaxBatch(*(jnp.asarray(a) for a in arrays)), aligned_dim=32)
    jobj = JaxObjective.create("logistic")
    _, g_ref = jobj.value_and_grad(jnp.asarray(w), JaxBatch(*(jnp.asarray(a) for a in arrays)))
    _, g_bf = obj.value_and_grad(torch.as_tensor(w), bf16)
    np.testing.assert_allclose(g_bf.numpy(), np.asarray(g_ref), rtol=0.02, atol=0.02)
    _, jg_bf = jobj.value_and_grad(jnp.asarray(w), jax_astype(jfast, jnp.bfloat16))
    np.testing.assert_allclose(g_bf.numpy(), np.asarray(jg_bf), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    padded = pad_batch(fast, 80)
    assert padded.al is None and padded.fm is None and padded.num_examples == 80
    jpadded = jax_pad(jfast, 80)
    for name in ("ids", "vals", "label", "offset", "weight"):
        np.testing.assert_array_equal(getattr(padded, name).numpy(),
                                      np.asarray(getattr(jpadded, name)))
    # Padded rows weigh nothing: the objective is unchanged.
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "autodiff")
    np.testing.assert_allclose(float(obj.value(torch.as_tensor(w), padded)),
                               float(obj.value(torch.as_tensor(w), fast)), rtol=1e-6)
    assert pad_batch(fast, 64) is fast
    with pytest.raises(ValueError, match="rows"):
        pad_batch(fast, 10)
    dense = pad_batch(dense_batch(np.ones((3, 2)), np.ones(3), device="cpu"), 5)
    assert dense.x.shape == (5, 2) and float(dense.weight[3:].sum()) == 0.0


@pytest.mark.usefixtures("native_router")
def test_xchg_bf16_payload_close_to_f32(monkeypatch):
    """tests/test_vperm.py:199-219: PHOTON_XCHG_DTYPE=bfloat16 rides the
    exchange at half width and the reduce stays float32, so the gradient
    tracks the f32 payload's; and it equals the JAX package's bf16 payload
    at the f32 parity tolerances."""
    monkeypatch.setenv("PHOTON_XCHG_REDUCE", "cumsum")
    rng = np.random.default_rng(10)
    n, k, dim = 2048, 16, 512
    ids = rng.integers(0, dim, size=(n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    aux = tv.build_xchg_sorted_route(ids, dim, device="cpu")
    per_row = rng.standard_normal(n).astype(np.float32)
    args = (torch.as_tensor(per_row), torch.as_tensor(vals), None, aux, dim)
    g32 = tv.xchg_segment_grad(*args).numpy()
    monkeypatch.setenv("PHOTON_XCHG_DTYPE", "bfloat16")
    g16 = tv.xchg_segment_grad(*args).numpy()
    scale = np.abs(g32).max()
    np.testing.assert_allclose(g16, g32, atol=2e-2 * scale)
    assert not np.array_equal(g16, g32)  # the knob engaged
    jaux = jax_sorted_route(ids, dim)
    jg16 = np.asarray(jax_xchg_segment_grad(jnp.asarray(per_row), jnp.asarray(vals), None,
                                            jaux, dim, interpret=True))
    np.testing.assert_allclose(g16, jg16, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale)


@pytest.mark.usefixtures("native_router")
@pytest.mark.parametrize("reduce", ["aligned", "cumsum"])
def test_bf16_storage_keeps_xchg_grad_consistent(monkeypatch, reduce):
    """The single-device half of tests/test_sharded_kernels.py:204-230:
    batch_astype after an xchg attach converts the baked stream in place, so
    the gradient reads the values the margins read; held against autodiff
    on the same converted batch (same values, another order)."""
    monkeypatch.setenv("PHOTON_XCHG_REDUCE", reduce)
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "xchg")
    rng = np.random.default_rng(17)
    n, k = 256, 8
    arrays = (rng.integers(0, 64, size=(n, k)).astype(np.int32),
              rng.standard_normal((n, k)).astype(np.float32),
              (rng.random(n) < 0.5).astype(np.float32),
              np.zeros(n, np.float32), np.ones(n, np.float32))
    obj = GlmObjective.create("logistic", RegularizationContext("l2", 0.3))
    w = torch.as_tensor((rng.standard_normal(64) * 0.1).astype(np.float32))
    batch = SparseBatch(*(torch.as_tensor(a) for a in arrays))
    fast = attach_feature_major(batch, aligned_dim=64)
    assert fast.xchg is not None and fast.xchg.vals_dest is not None
    fast16 = batch_astype(fast, torch.bfloat16)
    assert fast16.xchg.vals_dest.dtype == torch.bfloat16
    v_x, g_x = obj.value_and_grad(w, fast16)
    monkeypatch.setenv("PHOTON_SPARSE_GRAD", "autodiff")
    v_a, g_a = obj.value_and_grad(w, batch_astype(batch, torch.bfloat16))
    np.testing.assert_allclose(float(v_x), float(v_a), rtol=2e-5)
    scale = max(float(g_a.abs().max()), 1.0)
    np.testing.assert_allclose(g_x.numpy(), g_a.numpy(), rtol=2e-4, atol=1e-5 * scale)


def test_kernel_wrappers_take_bf16_values_and_refuse_other_types():
    """On CPU tensors every wrapper takes its plain version, which widens
    bf16 values as the kernel does; a value type no kernel form takes
    raises (nothing falls back to a widened float32 launch)."""
    from photon_tpu_torch.core.losses import get_loss

    ids, vals, label, offset, weight = (torch.as_tensor(a) for a in _arrays(n=64, seed=6))
    v16 = vals.to(torch.bfloat16)
    w = torch.as_tensor(_w())
    loss = get_loss("logistic")
    got = fused_sparse.fused_value_and_grad(loss, w, ids, v16, label, offset, weight)
    ref = fused_sparse.fused_value_and_grad(loss, w, ids, v16.float(), label, offset, weight)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    r = torch.randn(64)
    assert torch.equal(fused_sparse.row_scatter(r, ids, v16, D),
                       fused_sparse.row_scatter(r, ids, v16.float(), D))
    with pytest.raises(TypeError, match="bfloat16"):
        fused_sparse.fused_value_and_grad(loss, w, ids, vals.half(), label, offset, weight)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_sparse.row_scatter(r, ids, vals.half(), D)
    lay = slab_reduce.device_layout(slab_reduce.build_aligned_layout(
        ids.numpy(), vals.numpy(), D), "cpu")
    w2d = w.index_select(0, lay.dup_map).view(-1, slab_reduce.LANES)
    v2 = lay.vals.to(torch.bfloat16)
    assert torch.equal(
        slab_reduce.aligned_gather_products(w2d, lay.slab_of_tile, lay.lo, v2),
        slab_reduce.aligned_gather_products(w2d, lay.slab_of_tile, lay.lo, v2.float()))
    with pytest.raises(TypeError, match="bfloat16"):
        slab_reduce.aligned_gather_products(w2d, lay.slab_of_tile, lay.lo, lay.vals.half())
    nc, ch = 1, 16
    x = torch.randn(nc * ch, tv.LANES)
    rng = np.random.default_rng(0)
    i1 = torch.as_tensor(rng.integers(0, 128, (ch, 128)).astype(np.int8))
    i2 = torch.as_tensor(rng.integers(0, ch, (128, ch)).astype(np.int16))
    i3 = torch.as_tensor(rng.integers(0, 128, (ch, 128)).astype(np.int8))
    xb = x.to(torch.bfloat16)
    assert torch.equal(tv.chunk_pass(xb, i1, i2, i3, nc, ch),
                       tv.chunk_pass(x, i1, i2, i3, nc, ch).to(torch.bfloat16))
    assert tv.chunk_pass(xb, i1, i2, i3, nc, ch).dtype == torch.bfloat16
    assert torch.equal(tv.lane_pass(xb, i1), tv.lane_pass(x, i1).to(torch.bfloat16))
    dz = torch.randn(nc * ch, 4)
    assert torch.equal(tv.chunk_expand_pass(dz.to(torch.bfloat16), i1, i2, i3, nc, ch),
                       tv.chunk_expand_pass(dz, i1, i2, i3, nc, ch).to(torch.bfloat16))
    for bad in (lambda: tv.chunk_pass(x.half(), i1, i2, i3, nc, ch),
                lambda: tv.lane_pass(x.half(), i1)):
        with pytest.raises(TypeError, match="bfloat16"):
            bad()


def _libsvm(path, n=600, d=24, seed=3):
    """tests/test_bf16_storage.py::test_driver_dtype_flag's data."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(d)
    with open(path, "w") as f:
        for _ in range(n):
            fid = np.sort(rng.choice(np.arange(1, d + 1), 5, replace=False))
            xv = rng.standard_normal(5)
            y = 1 if rng.random() < 1 / (1 + np.exp(-float(w_true[fid - 1] @ xv))) else -1
            f.write(f"{y} " + " ".join(f"{j}:{v:.5f}" for j, v in zip(fid, xv)) + "\n")


@pytest.mark.parametrize("route", ["fused", "pallas"])
def test_driver_dtype_flag(tmp_path, monkeypatch, route):
    """train --dtype bfloat16 lands near the f32 model (the reference's
    bound) and on the JAX package's bf16 fit; --stream refuses it."""
    from photon_tpu.drivers import train as jax_train

    monkeypatch.setenv("PHOTON_SPARSE_GRAD", route)
    path = tmp_path / "t.libsvm"
    _libsvm(path)
    common = ["--backend", "cpu", "--input", str(path), "--task", "logistic_regression",
              "--reg-weights", "1.0", "--max-iterations", "40"]
    outs = {}
    for dtype in ("float32", "bfloat16"):
        summary = train.run(train.build_parser().parse_args(
            [*common, "--dtype", dtype, "--output-dir", str(tmp_path / dtype)]))
        assert summary["dtype"] == dtype
        outs[dtype] = summary["sweep"][0]["final_value"]
    np.testing.assert_allclose(outs["bfloat16"], outs["float32"], rtol=REF_VALUE_RTOL)
    ref = jax_train.run(jax_train.build_parser().parse_args(
        [*common, "--dtype", "bfloat16", "--output-dir", str(tmp_path / "jax")]))
    np.testing.assert_allclose(outs["bfloat16"], ref["sweep"][0]["final_value"], rtol=1e-5)
    with pytest.raises(ValueError, match="--stream does not support --dtype"):
        train.run(train.build_parser().parse_args(
            ["--backend", "cpu", "--stream", "--input", str(path), "--dtype", "bfloat16",
             "--output-dir", str(tmp_path / "stream")]))


GAME_ARGS = ["--backend", "cpu", "--input", "synthetic-game:16:6:8:4:1:4",
             "--coordinate", "fixed:type=fixed,shard=global,max_iters=5",
             "--coordinate", "pu:type=random,shard=re0,entity=re0,max_iters=4",
             "--descent-iterations", "1", "--validation-split", "0.25"]


def test_game_driver_dtype_flag(tmp_path):
    """tests/test_bf16_storage.py::test_game_driver_dtype_flag: train_game
    --dtype bfloat16 lands within 0.05 AUC of the f32 run; its metrics equal
    the JAX package's bf16 run's, and the streamed bf16 run's the resident
    one's, at the GAME parity tolerance."""
    from photon_tpu.drivers import train_game as jax_train_game

    def run(mod, name, *extra):
        summary = mod.run(mod.build_parser().parse_args(
            [*GAME_ARGS, *extra, "--output-dir", str(tmp_path / name)]))
        assert os.path.isdir(str(tmp_path / name / "best_model"))
        return summary["best_metrics"]

    f32 = run(train_game, "f32")
    b16 = run(train_game, "bf16", "--dtype", "bfloat16")
    assert abs(b16["AUC"] - f32["AUC"]) < AUC_TOL
    ref = run(jax_train_game, "jax_bf16", "--dtype", "bfloat16")
    streamed = run(train_game, "bf16_stream", "--dtype", "bfloat16", "--stream-chunks", "50")
    for name, value in ref.items():
        assert abs(b16[name] - value) <= METRIC_TOL, (name, b16, ref)
        assert abs(streamed[name] - b16[name]) <= METRIC_TOL, (name, streamed, b16)


def _problem(lam):
    return ProblemConfig(regularization=RegularizationContext("l2", lam),
                         optimizer_config=OptimizerConfig(
                             max_iterations=80, tolerance=1e-11, gradient_tolerance=1e-8))


def _jax_problem(lam):
    return JaxProblem(regularization=JaxReg("l2", lam),
                      optimizer_config=JaxOpt(max_iterations=80, tolerance=1e-11,
                                              gradient_tolerance=1e-8))


def _to_port(data) -> GameDataset:
    def shard(s):
        if hasattr(s, "x"):
            return DenseShard(np.asarray(s.x))
        return SparseShard(np.asarray(s.ids), np.asarray(s.vals), s.dim_)

    return GameDataset(np.asarray(data.label), np.asarray(data.offset),
                       np.asarray(data.weight),
                       {n: shard(s) for n, s in data.shards.items()},
                       {n: np.asarray(c) for n, c in data.id_columns.items()})


def _sparse(data: GameDataset) -> GameDataset:
    def shard(s):
        n, d = s.x.shape
        return SparseShard(np.tile(np.arange(d, dtype=np.int32), (n, 1)), s.x.copy(), d)

    return GameDataset(data.label, data.offset, data.weight,
                       {n: shard(s) for n, s in data.shards.items()}, data.id_columns)


@pytest.fixture(scope="module")
def game_fits():
    """A linear GAME fit on bf16 training data: the JAX package's resident
    fit, and the port's resident and streamed (37-row chunks) fits on dense
    and on sparse shards, plus the port's f32 resident fit."""
    jtrain, jval = jax_split(jax_make_game_dataset(100, 5, 6, 3, seed=0,
                                                   n_random_coords=1)[0], 0.25, seed=1)
    train32, val = _to_port(jtrain), _to_port(jval)
    config = GameOptimizationConfiguration(coordinates={
        "fixed": tcoord.FixedEffectCoordinateConfig("global", _problem(1.0)),
        "re0": tcoord.RandomEffectCoordinateConfig("re0", "re0", _problem(1.0)),
    }, descent_iterations=2, name="bf16")
    jconfig = JaxConfig(coordinates={
        "fixed": jcoord.FixedEffectCoordinateConfig("global", _jax_problem(1.0)),
        "re0": jcoord.RandomEffectCoordinateConfig("re0", "re0", _jax_problem(1.0)),
    }, descent_iterations=2, name="bf16")

    def fit(train, **kw):
        return GameEstimator("linear_regression", train, validation_data=val,
                             device="cpu", **kw).fit([config])[0]

    train16 = dataset_astype(train32, "bfloat16")
    return {
        "val": val,
        "jax": JaxEstimator("linear_regression", jax_dataset_astype(jtrain, jnp.bfloat16),
                            validation_data=jval).fit([jconfig])[0],
        "jval": jval,
        "f32": fit(train32),
        "resident": fit(train16),
        "stream": fit(train16, stream_chunks=37),
        "sparse_resident": fit(_sparse(train16)),
        "sparse_stream": fit(_sparse(train16), stream_chunks=37),
    }


def _close(a, b, what):
    diff = np.asarray(a) - np.asarray(b)
    assert float(np.sqrt(np.mean(diff * diff))) <= RMS_TOL, what
    assert np.abs(diff).max() <= MAX_TOL, what


def test_game_bf16_fit_matches_jax(game_fits):
    val = game_fits["val"]
    ours = game_fits["resident"]
    _close(ours.model.score(val), game_fits["jax"].model.score(game_fits["jval"]), "jax")
    for name, value in game_fits["jax"].metrics.items():
        assert abs(ours.metrics[name] - value) <= METRIC_TOL, name
    # bf16 storage moves the fit by its value rounding only.
    diff = ours.model.score(val) - game_fits["f32"].model.score(val)
    assert np.abs(diff).max() <= 5e-2


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_game_bf16_stream_chunks_match_resident(game_fits, kind):
    prefix = "" if kind == "dense" else "sparse_"
    val = game_fits["val"]
    resident, streamed = game_fits[prefix + "resident"], game_fits[prefix + "stream"]
    _close(streamed.model.score(val), resident.model.score(val), kind)
    for name, value in resident.metrics.items():
        assert abs(streamed.metrics[name] - value) <= METRIC_TOL, name
