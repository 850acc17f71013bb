"""Port parity of the random-effect feature projections
(``photon_tpu_torch/game/projection.py``, a copy of the reference's numpy
module) and of the projected coordinate solve.

Mirrors ``tests/test_projection.py`` (:37-227): index-map projections are
exact (margins unchanged), the random matrix is the reference's bit for
bit, its lift preserves margins and its restriction undoes the lift in
norm.  The projected coordinate against the reference's: index-map within
1e-5 (Newton route, past the float32 floor), random projection within 1e-5;
the index-map solve equals the unprojected one.
"""

import numpy as np
import pytest

from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxOptimizerConfig
from photon_tpu.core.problem import ProblemConfig as JaxProblemConfig
from photon_tpu.game import coordinate as jcoord
from photon_tpu.game import data as jdata
from photon_tpu.game import projection as jproj
from photon_tpu_torch.core.objective import RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.game import coordinate as tcoord
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game import projection as tproj


def _sparse_bucket(pkg):
    """4 entities x 2 rows, global dim 32, few active features (the
    reference test's bucket), in package ``pkg``'s types."""
    rng = np.random.default_rng(0)
    ids = np.zeros((4, 2, 3), np.int32)
    vals = np.zeros((4, 2, 3), np.float32)
    for e in range(4):
        active = rng.choice(np.arange(1, 32), size=4, replace=False)
        for r in range(2):
            ids[e, r] = np.sort(rng.choice(active, size=3, replace=False))
            vals[e, r] = rng.standard_normal(3)
    return pkg.EntityBucket(
        row_capacity=2, entity_index=np.arange(4, dtype=np.int32),
        row_index=np.zeros((4, 2), np.int64), row_weight=np.ones((4, 2), np.float32),
        label=np.zeros((4, 2), np.float32), features=pkg.SparseShard(ids, vals, 32))


def _dense_bucket(pkg, x):
    n = x.shape[0]
    return pkg.EntityBucket(
        row_capacity=x.shape[1], entity_index=np.arange(n, dtype=np.int32),
        row_index=np.zeros(x.shape[:2], np.int64),
        row_weight=np.ones(x.shape[:2], np.float32),
        label=np.zeros(x.shape[:2], np.float32), features=pkg.DenseShard(x))


def test_index_map_projection_matches_reference_and_is_exact():
    jb, tb = _sparse_bucket(jdata), _sparse_bucket(tdata)
    jp, tp = jproj.build_index_map_projection(jb), tproj.build_index_map_projection(tb)
    np.testing.assert_array_equal(tp.proj_ids, jp.proj_ids)
    np.testing.assert_array_equal(tp.mask, jp.mask)
    assert tp.projected_dim == jp.projected_dim < 32
    local = tp.project(tb.features)
    np.testing.assert_array_equal(local.ids, jp.project(jb.features).ids)
    w = np.random.default_rng(1).standard_normal(32).astype(np.float32)
    w_local = tp.restrict_table(np.tile(w, (4, 1)))
    np.testing.assert_array_equal(w_local, jp.restrict_table(np.tile(w, (4, 1))))
    ids, vals = tb.features.ids, tb.features.vals
    for e in range(4):
        for r in range(2):
            np.testing.assert_allclose((w_local[e][local.ids[e, r]] * local.vals[e, r]).sum(),
                                       (w[ids[e, r]] * vals[e, r]).sum(), rtol=1e-5)


def test_index_map_projection_dense_and_no_savings():
    x = np.zeros((3, 2, 16), np.float32)
    x[0, :, 2] = 1.0
    x[1, :, [5, 7]] = 2.0
    x[2, 0, 11] = 3.0
    tp = tproj.build_index_map_projection(_dense_bucket(tdata, x))
    jp = jproj.build_index_map_projection(_dense_bucket(jdata, x))
    assert tp.projected_dim == 2
    np.testing.assert_array_equal(tp.proj_ids, jp.proj_ids)
    local = tp.project(tdata.DenseShard(x))
    w = np.arange(16, dtype=np.float32)
    np.testing.assert_allclose(np.einsum("erd,ed->er", x, np.tile(w, (3, 1))),
                               np.einsum("erp,ep->er", local.x,
                                         tp.restrict_table(np.tile(w, (3, 1)))),
                               rtol=1e-5)
    assert tproj.build_index_map_projection(
        _dense_bucket(tdata, np.ones((2, 2, 4), np.float32))) is None


@pytest.mark.parametrize("dim,p,seed", [(64, 16, 3), (32, 8, 0), (19, 4, 7), (512, 32, 1)])
def test_random_matrix_is_the_reference_bit_for_bit(dim, p, seed):
    np.testing.assert_array_equal(tproj.build_random_projection(dim, p, seed).matrix,
                                  jproj.build_random_projection(dim, p, seed).matrix)


def test_random_projection_lift_restrict_and_sparse():
    rng = np.random.default_rng(2)
    proj = tproj.build_random_projection(64, 16, seed=3)
    x = rng.standard_normal((5, 3, 64)).astype(np.float32)
    local = proj.project(tdata.DenseShard(x))
    w_local = rng.standard_normal((5, 16)).astype(np.float32)
    np.testing.assert_allclose(np.einsum("erp,ep->er", local.x, w_local),
                               np.einsum("erd,ed->er", x, proj.lift(w_local)),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        tproj.build_random_projection(8, 8)
    big = tproj.build_random_projection(512, 32, seed=1)
    w = rng.standard_normal((6, 32)).astype(np.float32)
    ratio = np.linalg.norm(big.restrict_table(big.lift(w))) / np.linalg.norm(w)
    assert 0.7 < ratio < 1.4
    small = tproj.build_random_projection(32, 8, seed=0)
    bucket = _sparse_bucket(tdata)
    dense = np.zeros((4, 2, 32), np.float32)
    for e in range(4):
        for r in range(2):
            np.add.at(dense[e, r], bucket.features.ids[e, r], bucket.features.vals[e, r])
    np.testing.assert_allclose(small.project(bucket.features).x,
                               small.project(tdata.DenseShard(dense)).x,
                               rtol=1e-4, atol=1e-5)


def _game_sparse_data(seed=0):
    """The reference test's GAME dataset with a sparse random-effect shard
    (20 entities, dim 64, 4 features a row), as both packages' datasets."""
    rng = np.random.default_rng(seed)
    n_entities, dim, k = 20, 64, 4
    counts = np.maximum(1, rng.geometric(1.0 / 4, n_entities))
    n = int(counts.sum())
    entity = np.repeat(np.arange(n_entities), counts)
    ids = np.zeros((n, k), np.int32)
    vals = np.zeros((n, k), np.float32)
    w_true = rng.standard_normal((n_entities, dim)).astype(np.float32) * 0.5
    z = np.zeros(n, np.float32)
    for i in range(n):
        ids[i] = np.sort(rng.choice(dim, size=k, replace=False))
        vals[i] = rng.standard_normal(k)
        z[i] = (w_true[entity[i], ids[i]] * vals[i]).sum()
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    return (jdata.GameDataset.create(y, {"re": jdata.SparseShard(ids, vals, dim)},
                                     id_columns={"re": entity}),
            tdata.GameDataset.create(y, {"re": tdata.SparseShard(ids, vals, dim)},
                                     id_columns={"re": entity}))


def _train_both(jd, td, **config_kw):
    cfg = dict(max_iterations=100, tolerance=0.0, gradient_tolerance=1e-8)
    jprob = JaxProblemConfig(regularization=JaxReg("l2", 1.0),
                             optimizer_config=JaxOptimizerConfig(**cfg))
    tprob = ProblemConfig(regularization=RegularizationContext("l2", 1.0),
                          optimizer_config=OptimizerConfig(**cfg))
    jc = jcoord.RandomEffectCoordinate(
        jd, jcoord.RandomEffectCoordinateConfig("re", "re", jprob, **config_kw),
        "logistic_regression")
    tc = tcoord.RandomEffectCoordinate(
        td, tcoord.RandomEffectCoordinateConfig("re", "re", tprob, **config_kw),
        "logistic_regression", device="cpu")
    offsets = np.zeros(jd.num_examples, np.float32)
    jm, _ = jc.train(offsets)
    tm, ts = tc.train(offsets)
    return jc, tc, jm, tm, ts


@pytest.mark.parametrize("projection,kw", [("index_map", {}),
                                           ("random", {"projected_dim": 16})])
def test_projected_coordinate_matches_reference(projection, kw):
    jd, td = _game_sparse_data(seed=0 if projection == "index_map" else 1)
    jc, tc, jm, tm, ts = _train_both(jd, td, projection=projection, **kw)
    assert ts["entities"] == tm.num_entities and ts["quarantined"] == 0
    assert tm.table.shape == (20, 64)
    assert [d["solve_dim"] for d in tc.device_data.device_buckets] == \
        [d["solve_dim"] for d in jc.device_data.device_buckets]
    np.testing.assert_allclose(tm.table.numpy(), np.asarray(jm.table), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tc.score_device(tm).numpy(), jc.score(jm), atol=1e-5)
    # A warm start from its own model restricts on the device, as the next
    # descent iteration does.
    offsets = np.full(jd.num_examples, 0.1, np.float32)
    jm2, _ = jc.train(offsets, initial_model=jm)
    tm2, _ = tc.train(offsets, initial_model=tm)
    np.testing.assert_allclose(tm2.table.numpy(), np.asarray(jm2.table), atol=1e-5, rtol=0)


def test_index_map_projected_solve_matches_unprojected():
    """The index-map projection is exact: the projected and unprojected
    solves land on the same model (the reference test's claim)."""
    jd, td = _game_sparse_data()
    *_, plain, _ = _train_both(jd, td)
    *_, projected, _ = _train_both(jd, td, projection="index_map")
    np.testing.assert_allclose(projected.table.numpy(), plain.table.numpy(),
                               rtol=2e-3, atol=2e-4)


def test_projection_config_checks_match_reference():
    for kw in ({"projection": "random"}, {"projection": "bogus"}):
        with pytest.raises(ValueError):
            jcoord.RandomEffectCoordinateConfig("re", "re", **kw)
        with pytest.raises(ValueError):
            tcoord.RandomEffectCoordinateConfig("re", "re", **kw)
