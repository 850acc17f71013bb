"""Port parity of the GAME data layer, Avro IO, models and scoring.

The same numpy inputs go through the JAX package's functions and the
port's.  The host-side data layer (entity vocabulary, buckets, size bins,
splits, the fixture generators, the Avro reader) is numpy in both, so it is
held bit for bit; device scoring is held to 1e-5, the tolerance of the
reference's model round trips (``tests/test_game_drivers.py``).
"""

import dataclasses
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.data import fixtures as jfix
from photon_tpu.data import synthetic as jsyn
from photon_tpu.data.game_io import read_game_avro as jax_read_avro
from photon_tpu.data.game_io import write_game_avro as jax_write_avro
from photon_tpu.data.validation import validate_game_dataset as jax_validate
from photon_tpu.evaluation import metrics as jmetrics
from photon_tpu.game import data as jdata
from photon_tpu.game import model as jmodel
from photon_tpu.models.glm import Coefficients as JaxCoefficients
from photon_tpu.models.glm import model_for_task as jax_model_for_task
from photon_tpu_torch.data import fixtures as tfix
from photon_tpu_torch.data import synthetic as tsyn
from photon_tpu_torch.data.game_io import read_game_avro, write_game_avro
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.data.validation import validate_game_dataset
from photon_tpu_torch.evaluation import metrics as tmetrics
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.model import game_model_from_numpy

SCORE_TOL = 1e-5


def _to_torch_dataset(data) -> tdata.GameDataset:
    """The reference's GameDataset as the port's (the same arrays)."""
    shards = {
        name: (tdata.DenseShard(s.x) if isinstance(s, jdata.DenseShard)
               else tdata.SparseShard(s.ids, s.vals, s.dim_))
        for name, s in data.shards.items()
    }
    return tdata.GameDataset(label=data.label, offset=data.offset, weight=data.weight,
                             shards=shards, id_columns=dict(data.id_columns))


def _assert_datasets_equal(a, b):
    for field in ("label", "offset", "weight"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), field)
    assert sorted(a.shards) == sorted(b.shards)
    for name in a.shards:
        sa, sb = a.shards[name], b.shards[name]
        assert type(sa).__name__ == type(sb).__name__
        for field in ("x",) if hasattr(sa, "x") else ("ids", "vals", "dim_"):
            np.testing.assert_array_equal(getattr(sa, field), getattr(sb, field))
    assert sorted(a.id_columns) == sorted(b.id_columns)
    for name in a.id_columns:
        assert a.id_columns[name].dtype == b.id_columns[name].dtype
        np.testing.assert_array_equal(a.id_columns[name], b.id_columns[name])


def _assert_buckets_equal(ja, ta):
    assert ja.row_capacity == ta.row_capacity
    for field in ("entity_index", "row_index", "row_weight", "label"):
        got, want = getattr(ta, field), getattr(ja, field)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, field)
    fj, ft = ja.features, ta.features
    for field in ("x",) if hasattr(fj, "x") else ("ids", "vals"):
        np.testing.assert_array_equal(getattr(ft, field), getattr(fj, field))


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"n_users": 60, "n_items": 40, "mean_ratings": 9, "seed": 5},
])
def test_movielens_fixture_bit_identical(kw):
    jd, jmaps = jfix.make_movielens_like(**kw)
    td, tmaps = tfix.make_movielens_like(**kw)
    _assert_datasets_equal(jd, td)
    for name in jmaps:
        assert list(jmaps[name].keys()) == list(tmaps[name].keys())


@pytest.mark.parametrize("args", [(25, 4, 6, 4, 3, 1), (40, 7, 5, 3, 9, 2)])
def test_synthetic_game_dataset_bit_identical(args):
    n_e, rows, fdim, rdim, seed, n_random = args
    jd, jmaps = jsyn.make_game_dataset(n_e, rows, fdim, rdim, seed=seed,
                                       n_random_coords=n_random)
    td, tmaps = tsyn.make_game_dataset(n_e, rows, fdim, rdim, seed=seed,
                                       n_random_coords=n_random)
    _assert_datasets_equal(jd, td)
    assert sorted(jmaps) == sorted(tmaps)


# ---------------------------------------------------------------------------
# Entity grouping, size bins, splits
# ---------------------------------------------------------------------------


def _movielens_pair(seed=7, n_users=80):
    jd, _ = jfix.make_movielens_like(n_users=n_users, n_items=60, mean_ratings=10,
                                     seed=seed)
    return jd, _to_torch_dataset(jd)


@pytest.mark.parametrize("cap", [None, 6])
@pytest.mark.parametrize("keys", ["int", "str"])
def test_random_effect_dataset_matches_reference(cap, keys):
    jd, td = _movielens_pair()
    if keys == "str":  # Avro id columns come back as strings
        col = jd.id_columns["userId"].astype(str)
        jd = dataclasses.replace(jd, id_columns={"userId": col})
        td = dataclasses.replace(td, id_columns={"userId": col})
    ja = jdata.build_random_effect_dataset(jd, "userId", "per_user",
                                           active_row_cap=cap, seed=3)
    ta = tdata.build_random_effect_dataset(td, "userId", "per_user",
                                           active_row_cap=cap, seed=3)
    np.testing.assert_array_equal(ta.keys, ja.keys)
    np.testing.assert_array_equal(ta.entity_idx_per_row, ja.entity_idx_per_row)
    assert len(ta.buckets) == len(ja.buckets)
    for jb, tb in zip(ja.buckets, ta.buckets):
        _assert_buckets_equal(jb, tb)
    for max_bins, waste in ((4, 2.0), (2, 1.5), (1, 2.0), (8, 8.0)):
        groups = tdata.plan_size_bins(ta.buckets, max_bins=max_bins, waste_cap=waste)
        assert groups == jdata.plan_size_bins(ja.buckets, max_bins=max_bins,
                                              waste_cap=waste)
        for group in groups:
            _assert_buckets_equal(
                jdata.merge_buckets([ja.buckets[i] for i in group]),
                tdata.merge_buckets([ta.buckets[i] for i in group]))
    big = ta.buckets[-1]
    _assert_buckets_equal(jdata.pad_bucket_rows(ja.buckets[-1], 3),
                          tdata.pad_bucket_rows(big, 3))
    _assert_buckets_equal(jdata.pad_bucket_entities(ja.buckets[-1], 4, ja.num_entities),
                          tdata.pad_bucket_entities(big, 4, ta.num_entities))


def test_plan_size_bins_on_skewed_cohorts_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        caps = sorted(rng.choice(12, size=rng.integers(1, 9), replace=False))
        buckets = [types.SimpleNamespace(row_capacity=1 << int(c),
                                         num_entities=int(rng.integers(1, 5000)))
                   for c in caps]
        max_bins = int(rng.integers(1, 6))
        waste = float(rng.choice([1.0, 1.5, 2.0, 4.0]))
        assert (tdata.plan_size_bins(buckets, max_bins, waste)
                == jdata.plan_size_bins(buckets, max_bins, waste))


@pytest.mark.parametrize("fraction,seed", [(0.2, 0), (0.5, 3), (0.01, 9)])
def test_split_game_dataset_matches_reference(fraction, seed):
    jd, td = _movielens_pair()
    for ja, ta in zip(jdata.split_game_dataset(jd, fraction, seed),
                      tdata.split_game_dataset(td, fraction, seed)):
        _assert_datasets_equal(ja, ta)


def test_entity_index_for_matches_reference():
    vocab_int = np.array([3, 7, 11, 40], np.int64)
    vocab_str = np.array(["10", "3", "7"])
    cases = [
        (np.array([7, 3, 5, 40, 41]), vocab_int),
        (np.array(["7", "40", "x", "3"]), vocab_int[:0]),
        (np.array(["7", "40", "3", "11"]), vocab_int),
        (np.array([7, 10, 3, 2]), vocab_str),
    ]
    for raw, vocab in cases:
        np.testing.assert_array_equal(tdata.entity_index_for(raw, vocab),
                                      jdata.entity_index_for(raw, vocab))
    with pytest.raises(ValueError, match="int64"):
        tdata.entity_index_for(np.array(["x"]), vocab_int)


# ---------------------------------------------------------------------------
# Avro IO and validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("fixed_maps", [False, True])
def test_game_avro_read_and_write_across_packages(tmp_path, writer, fixed_maps):
    jd, jmaps = jsyn.make_game_dataset(20, 5, 6, 4, seed=2, n_random_coords=2)
    td, tmaps = tsyn.make_game_dataset(20, 5, 6, 4, seed=2, n_random_coords=2)
    path = str(tmp_path / "train.avro")
    if writer == "jax":
        jax_write_avro(path, jd, jmaps)
    else:
        write_game_avro(path, td, tmaps)
    bags = {name: name for name in jd.shards}
    jread, jread_maps = jax_read_avro(path, bags, ["re0", "re1"],
                                      index_maps=jmaps if fixed_maps else None)
    tread, tread_maps = read_game_avro(path, bags, ["re0", "re1"],
                                       index_maps=tmaps if fixed_maps else None)
    _assert_datasets_equal(jread, tread)
    for name in bags:
        assert list(jread_maps[name].keys()) == list(tread_maps[name].keys())
        assert jread_maps[name].intercept_id == tread_maps[name].intercept_id


def test_avro_reader_handles_part_dirs_and_empty_input(tmp_path):
    td, tmaps = tsyn.make_game_dataset(10, 3, 4, 3, seed=1)
    (tmp_path / "parts").mkdir()
    write_game_avro(str(tmp_path / "parts" / "part-0.avro"), td, tmaps)
    write_game_avro(str(tmp_path / "parts" / "part-1.avro"), td, tmaps)
    (tmp_path / "parts" / "_SUCCESS").write_text("")
    bags = {"global": "global", "re0": "re0"}
    both, _ = read_game_avro(str(tmp_path / "parts"), bags, ["re0"])
    jboth, _ = jax_read_avro(str(tmp_path / "parts"), bags, ["re0"])
    _assert_datasets_equal(jboth, both)
    assert both.num_examples == 2 * td.num_examples
    with pytest.raises(FileNotFoundError):
        read_game_avro(str(tmp_path / "nothing*.avro"), bags, ["re0"])


def test_validate_game_dataset_matches_reference():
    jd, td = _movielens_pair(n_users=30)
    for d in (jd, td):
        d.label[:3] = [np.nan, 2.0, 0.5]
        d.weight[5] = 0.0
        d.offset[7] = np.inf
        d.shards["global"].x[9, 0] = np.nan
    for task in ("logistic_regression", "poisson_regression", "linear_regression"):
        want = [str(i) for i in jax_validate(jd, task)]
        assert [str(i) for i in validate_game_dataset(td, task)] == want
        assert want


# ---------------------------------------------------------------------------
# Models and scoring
# ---------------------------------------------------------------------------


def _jax_models(data, rng, shard_kind):
    d_fixed = data.shards["global"].dim
    d_user = data.shards["per_user"].dim
    keys = np.unique(data.id_columns["userId"])[::2]  # half the users unseen
    w = rng.standard_normal(d_fixed).astype(np.float32)
    table = rng.standard_normal((len(keys), d_user)).astype(np.float32)
    var = rng.random((len(keys), d_user)).astype(np.float32)
    jm = jmodel.GameModel({
        "fixed": jmodel.FixedEffectModel(
            jax_model_for_task("logistic_regression",
                               JaxCoefficients(jnp.asarray(w), None)), "global"),
        "per_user": jmodel.RandomEffectModel(
            jnp.asarray(table), keys, "userId", "per_user", "logistic_regression",
            jnp.asarray(var)),
    }, "logistic_regression")
    spec = {
        "fixed": {"type": "fixed", "shard_name": "global", "means": w},
        "per_user": {"type": "random", "shard_name": "per_user",
                     "entity_column": "userId", "keys": keys, "table": table,
                     "variances": var},
    }
    return jm, game_model_from_numpy("logistic_regression", spec, device="cpu")


@pytest.mark.parametrize("shard_kind", ["dense", "sparse"])
def test_game_model_scores_match_reference(tmp_path, shard_kind):
    rng = np.random.default_rng(4)
    jd, jmaps = jfix.make_movielens_like(n_users=50, n_items=40, mean_ratings=8)
    if shard_kind == "sparse":  # the Avro reader's padded-COO shards
        path = str(tmp_path / "ml.avro")
        jax_write_avro(path, jd, jmaps)
        jd, _ = jax_read_avro(path, {"global": "global", "per_user": "per_user"},
                              ["userId"])
    td = _to_torch_dataset(jd)
    jm, tm = _jax_models(jd, rng, shard_kind)
    np.testing.assert_allclose(tm.score(td), jm.score(jd), rtol=SCORE_TOL, atol=SCORE_TOL)
    np.testing.assert_allclose(tm.predict(td), jm.predict(jd), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    for name in ("fixed", "per_user"):
        np.testing.assert_allclose(tm.coordinate(name).score(td),
                                   jm.coordinate(name).score(jd),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)
    unseen = jd.id_columns["userId"][
        tdata.entity_index_for(jd.id_columns["userId"], tm.coordinate("per_user").keys) < 0]
    assert len(unseen)
    re = tm.coordinate("per_user")
    assert re.model_for_entity(unseen[0]) is None
    key = re.keys[3]
    np.testing.assert_array_equal(re.model_for_entity(key).coefficients.means.numpy(),
                                  np.asarray(jm.coordinate("per_user").table)[3])


def test_game_model_from_numpy_rejects_unsorted_keys():
    with pytest.raises(ValueError, match="sorted"):
        game_model_from_numpy("logistic_regression", {"r": {
            "type": "random", "shard_name": "s", "entity_column": "e",
            "keys": np.array([3, 1]), "table": np.zeros((2, 2))}}, device="cpu")


def test_auc_matches_reference_on_tie_heavy_scores():
    """Tied scores split their pairs half and half in both packages."""
    rng = np.random.default_rng(11)
    for _ in range(60):
        n = int(rng.integers(2, 300))
        scores = rng.integers(0, 4, n).astype(np.float32)
        labels = (rng.random(n) < 0.4).astype(np.float32)
        weights = np.where(rng.random(n) < 0.1, 0.0, rng.random(n)).astype(np.float32)
        want = float(jmetrics.area_under_roc_curve(
            jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(weights)))
        got = float(tmetrics.area_under_roc_curve(
            torch.as_tensor(scores), torch.as_tensor(labels), torch.as_tensor(weights)))
        assert abs(got - want) <= 1e-6, (got, want)


def test_index_maps_read_back_across_packages(tmp_path):
    from photon_tpu.data.index_map import IndexMap as JaxIndexMap

    imap = IndexMap.build(["a", "b\x01x"], intercept=True)
    imap.save(str(tmp_path / "m.json"))
    back = JaxIndexMap.load(str(tmp_path / "m.json"))
    assert list(back.keys()) == list(imap.keys())
    assert back.intercept_id == imap.intercept_id


def test_unported_library_paths_raise(tmp_path):
    """Each path the port leaves out raises, naming its ROADMAP item."""
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import ProblemConfig
    from photon_tpu_torch.game import batched_solve, coordinate
    from photon_tpu_torch.game.descent import CoordinateDescent
    from photon_tpu_torch.game.estimator import (
        GameEstimator,
        GameOptimizationConfiguration,
    )

    data, _ = tsyn.make_game_dataset(8, 3, 4, 3, seed=1)
    problem = ProblemConfig(optimizer_config=OptimizerConfig(max_iterations=3))
    fixed = coordinate.FixedEffectCoordinateConfig("global", problem)
    rand = coordinate.RandomEffectCoordinateConfig("re0", "re0", problem)
    cases = [
        (lambda: GameEstimator("logistic_regression", data, mesh=object()), "item 10"),
        (lambda: coordinate.RandomEffectCoordinateConfig("r", "r", row_split=True),
         "item 10"),
    ]
    for make, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            make()
    # The item 9 path is ported: a streamed fit spilled to a tile store.
    spilled = GameEstimator("logistic_regression", data, device="cpu", stream_chunks=4,
                            spill_dir=str(tmp_path / "spill"))
    spilled.fit([GameOptimizationConfiguration(coordinates={"fixed": fixed})])
    assert any(n.startswith("feat-") for n in os.listdir(tmp_path / "spill"))
    # The item 5 paths are ported: the elastic-net lane objective, the
    # Newton-CG and row-split routes, projections.
    lane = batched_solve.LaneObjective.of(GlmObjective.create(
        "logistic", RegularizationContext("elastic_net", 1.0)))
    assert lane.l1_weight == 0.5 and lane.l2_weight == 0.5
    assert batched_solve.solver_route(ProblemConfig(optimizer="newton_cg"), 19) == "newton_cg"
    assert batched_solve.solver_route(problem, 19, row_split=True) == "row_split"
    coordinate.RandomEffectCoordinateConfig("r", "r", projection="index_map")
    # Normalization applies to fixed effects only, as in the reference.
    from photon_tpu_torch.core.normalization import NormalizationContext

    with pytest.raises(ValueError, match="random-effect"):
        coordinate.build_coordinate(data, rand, "logistic_regression", device="cpu",
                                    normalization=NormalizationContext())
    est = GameEstimator("logistic_regression", data, device="cpu")
    config = GameOptimizationConfiguration({"fixed": fixed, "re0": rand})
    # Descent checkpoints and resume are ported (item 6).
    ckpt = str(tmp_path / "ckpt")
    model = est.fit([config], checkpoint_dir=ckpt)[0].model
    restored = est.fit([config], checkpoint_dir=ckpt, resume="latest")[0].model
    assert torch.equal(restored.coordinate("fixed").coefficients.means,
                       model.coordinate("fixed").coefficients.means)
    coords = est._build_coordinates(config)
    loop = CoordinateDescent(coords, "logistic_regression", data)
    loop.run(1, initial_model=model)  # warm starts are ported (item 5)
    from photon_tpu_torch.fault.checkpoint import CheckpointError, DescentCheckpointer

    state = DescentCheckpointer(os.path.join(ckpt, "cfg-000")).load("latest", device="cpu")
    with pytest.raises(CheckpointError):  # a warm-started run is another descent
        loop.run(1, initial_model=model, resume_state=state)
    # A foreign vocabulary joins by key (item 5): no entity overlaps, so
    # the warm start is the cold one.
    foreign = dataclasses.replace(model.coordinate("re0"), keys=model.coordinate("re0").keys + 100)
    offsets = np.zeros(data.num_examples, np.float32)
    assert torch.equal(coords["re0"].train(offsets, initial_model=foreign)[0].table,
                       coords["re0"].train(offsets)[0].table)
