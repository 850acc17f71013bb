"""Port parity of the factored random effect (``w_e = L z_e``).

The port draws the initial ``L`` and takes the rank-r SVD warm start with
the reference's numpy code, so both packages start the alternation from the
same ``L`` (held bit for bit).  The table is held to the reference's within
``FACTORED_ATOL``: its lane L-BFGS ``z`` solves and its pooled L-BFGS ``L``
solve run the reference's iterations, cut before a lane reaches the
float32 value floor (``tests/test_torch_lane_solvers.py`` says why); at
full convergence its last ``z`` pass is held within 1e-5 of the float64
optimum of the ``z`` lanes under that pass's ``L``.  And
the reference's own claims (``tests/test_game.py:389``): on low-rank
effects with few rows an entity, validation AUC above 0.78 and 0.03 above
the free per-entity fit.
"""

import numpy as np
import pytest
import torch

from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxOptimizerConfig
from photon_tpu.core.problem import ProblemConfig as JaxProblemConfig
from photon_tpu.game import coordinate as jcoord
from photon_tpu.game import data as jdata
from photon_tpu_torch.core.objective import RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.evaluation.metrics import area_under_roc_curve as auc
from photon_tpu_torch.game import coordinate as tcoord
from photon_tpu_torch.game import data as tdata
from tests.test_torch_lane_solvers import (
    END_POINT_ATOL,
    END_POINT_ITERATIONS,
    dense_lanes,
    float64_optimum,
)

# Held: the table after the alternation, the z and L solves cut to
# ITERATIONS each (no lane reaches the float32 floor before them).
FACTORED_ATOL = 1e-4
ITERATIONS = 4


def _low_rank_data(seed=17, n_entities=60, rows=(6, 8), d=10, rank=2):
    """The reference test's data: rank-2 per-entity effects, few rows an
    entity; (train, validation) in both packages' types."""
    rng = np.random.default_rng(seed)
    u_true = rng.standard_normal((d, rank)) * 1.6
    w_true = rng.standard_normal((n_entities, rank)) @ u_true.T
    out = []
    for rows_per in rows:
        n = n_entities * rows_per
        ent = np.repeat(np.arange(n_entities), rows_per)
        x = rng.standard_normal((n, d)).astype(np.float32)
        margin = np.einsum("nd,nd->n", x, w_true[ent])
        label = (rng.random(n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
        out.append(tuple(
            pkg.GameDataset(shards={"re0": pkg.DenseShard(x)}, label=label,
                            offset=np.zeros(n, np.float32), weight=np.ones(n, np.float32),
                            id_columns={"re0": ent})
            for pkg in (jdata, tdata)))
    return out


def _coordinates(jd, td, latent_dim=2, latent_iterations=4, max_iterations=ITERATIONS):
    jprob = JaxProblemConfig(regularization=JaxReg("l2", 1.0),
                             optimizer_config=JaxOptimizerConfig(max_iterations=max_iterations))
    tprob = ProblemConfig(regularization=RegularizationContext("l2", 1.0),
                          optimizer_config=OptimizerConfig(max_iterations=max_iterations))
    return (jcoord.FactoredRandomEffectCoordinate(
                jd, jcoord.FactoredRandomEffectCoordinateConfig(
                    "re0", "re0", latent_dim=latent_dim,
                    latent_iterations=latent_iterations, problem=jprob),
                "logistic_regression"),
            tcoord.FactoredRandomEffectCoordinate(
                td, tcoord.FactoredRandomEffectCoordinateConfig(
                    "re0", "re0", latent_dim=latent_dim,
                    latent_iterations=latent_iterations, problem=tprob),
                "logistic_regression", device="cpu"))


def _first_latent(coord, monkeypatch, module):
    """The ``L`` each package's first ``z`` pass projects by."""
    seen = []
    real = type(coord)._project_bucket

    def spy(self, dev, latent):
        seen.append(np.asarray(latent).copy() if module == "jax" else latent.numpy().copy())
        return real(self, dev, latent)

    monkeypatch.setattr(type(coord), "_project_bucket", spy)
    return seen


def test_same_initial_latent_and_table_as_reference(monkeypatch):
    (jd, td), _ = _low_rank_data()
    jc, tc = _coordinates(jd, td)
    jseen = _first_latent(jc, monkeypatch, "jax")
    tseen = _first_latent(tc, monkeypatch, "torch")
    offsets = np.zeros(td.num_examples, np.float32)
    jm, js = jc.train(offsets)
    tm, ts = tc.train(offsets)
    np.testing.assert_array_equal(tseen[0], jseen[0])
    np.testing.assert_allclose(tm.table.numpy(), np.asarray(jm.table),
                               atol=FACTORED_ATOL, rtol=0)
    for key in ("entities", "quarantined", "latent_iterations"):
        assert ts[key] == js[key], key
    np.testing.assert_allclose(tc.score_device(tm).numpy(), jc.score(jm), atol=1e-4)


def test_svd_warm_start_matches_reference(monkeypatch):
    """The rank-r SVD warm start (the reference's numpy code): the same
    ``L``, ``z`` and fallback table from the same model, and the same
    warm-started fit."""
    (jd, td), _ = _low_rank_data()
    jc, tc = _coordinates(jd, td)
    offsets = np.zeros(td.num_examples, np.float32)
    tm, _ = tc.train(offsets)
    jmodel = jcoord.RandomEffectModel(
        table=tm.table.numpy(), keys=tm.keys, entity_column=tm.entity_column,
        shard_name=tm.shard_name, task_type=tm.task_type)
    tl, tz, tprev = tc._warm_start(tm)
    jl, jz, jprev = jc._warm_start(jmodel)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tprev, np.asarray(jprev))
    t2, _ = tc.train(offsets, initial_model=tm)
    j2, _ = jc.train(offsets, initial_model=jmodel)
    np.testing.assert_allclose(t2.table.numpy(), np.asarray(j2.table),
                               atol=FACTORED_ATOL, rtol=0)


def test_factored_z_solves_reach_the_float64_optimum(monkeypatch):
    """The lane L-BFGS ``z`` solves at full convergence: the exported table
    ``z L^T`` within ``END_POINT_ATOL`` of ``z* L^T``, ``z*`` each entity's
    float64 optimum over its rows projected by the last pass's ``L``."""
    (_, td), _ = _low_rank_data()
    prob = ProblemConfig(regularization=RegularizationContext("l2", 1.0),
                         optimizer_config=OptimizerConfig(
                             max_iterations=END_POINT_ITERATIONS, tolerance=0.0,
                             gradient_tolerance=1e-8))
    coord = tcoord.FactoredRandomEffectCoordinate(
        td, tcoord.FactoredRandomEffectCoordinateConfig(
            "re0", "re0", latent_dim=2, latent_iterations=2, problem=prob),
        "logistic_regression", device="cpu")
    seen = _first_latent(coord, monkeypatch, "torch")
    offsets = (0.1 * np.random.default_rng(1).standard_normal(td.num_examples)
               ).astype(np.float32)
    model, stats = coord.train(offsets)
    assert stats["converged"] == stats["entities"] == 60
    latent = seen[-1].astype(np.float64)  # the last z pass's L, every bin's
    data = coord.device_data
    truth = np.zeros((data.dataset.num_entities + 1, coord.dim))
    for i, bucket in enumerate(data.device_buckets):
        x, y, off, wt = dense_lanes(data.batch_for(i, data.bin_offsets(i, offsets)),
                                    coord.dim)
        z = float64_optimum(x @ latent, y, off, wt, "logistic_regression",
                            coord.objective.l2_weight)
        truth[bucket["entity_index"].numpy()] = z @ latent.T
    np.testing.assert_allclose(model.table.double().numpy(), truth[:-1],
                               atol=END_POINT_ATOL, rtol=0)


def test_factored_generalizes_better_than_free_fit():
    """The reference's claim (``tests/test_game.py:389``) on the port: the
    rank-constrained fit beats the free per-entity fit on validation."""
    (_, train), (_, val) = _low_rank_data()
    prob = ProblemConfig(regularization=RegularizationContext("l2", 1.0),
                         optimizer_config=OptimizerConfig(max_iterations=10))
    offsets = np.zeros(train.num_examples, np.float32)
    fc = tcoord.FactoredRandomEffectCoordinate(
        train, tcoord.FactoredRandomEffectCoordinateConfig(
            "re0", "re0", latent_dim=2, latent_iterations=4, problem=prob),
        "logistic_regression", device="cpu")
    m_fact, stats = fc.train(offsets)
    assert stats["entities"] == 60
    rc = tcoord.RandomEffectCoordinate(
        train, tcoord.RandomEffectCoordinateConfig("re0", "re0", problem=prob),
        "logistic_regression", device="cpu")
    m_free, _ = rc.train(offsets)
    label, weight = torch.as_tensor(val.label), torch.as_tensor(val.weight)
    val_fact = float(auc(torch.as_tensor(m_fact.score(val)), label, weight))
    val_free = float(auc(torch.as_tensor(m_free.score(val)), label, weight))
    assert val_fact > 0.78, val_fact
    assert val_fact > val_free + 0.03, (val_fact, val_free)


def test_factored_config_checks_match_reference():
    for kw in ({"latent_dim": 0}, {"latent_iterations": 1},
               {"problem": ProblemConfig(variance_computation="simple")},
               {"problem": ProblemConfig(optimizer="tron")}):
        with pytest.raises(ValueError):
            tcoord.FactoredRandomEffectCoordinateConfig("re0", "re0", **kw)
    config = tcoord.FactoredRandomEffectCoordinateConfig("re0", "re0")
    assert config.data_key == tcoord.RandomEffectCoordinateConfig("re0", "re0").data_key
