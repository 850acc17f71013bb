"""Port parity of the batched entity solves: the lane objective, the damped
Newton batched over lanes, and the random-effect coordinate.

The reference solves a size bin with ``jax.vmap`` over one problem's
``lax.while_loop`` (``cached_newton_solver``); the port carries the lane
axis itself with per-lane masks.  Held, as the reference's own tests hold
its batched path (``tests/test_batched_solve.py:200-244``): the port's
solution to the reference's on the same bins and to the float64 optimum
within 1e-5, variances (simple and full) within 1e-5, and a lane that
converges early frozen while the others iterate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxOptimizerConfig
from photon_tpu.core.problem import ProblemConfig as JaxProblemConfig
from photon_tpu.data.batch import DenseBatch as JaxDense
from photon_tpu.data.batch import SparseBatch as JaxSparse
from photon_tpu.data.synthetic import make_game_data
from photon_tpu.game import batched_solve as jbs
from photon_tpu.game import coordinate as jcoord
from photon_tpu.game import data as jdata
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.optimizers.base import ConvergenceReason
from photon_tpu_torch.core.optimizers.newton import newton
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.data.batch import DenseBatch, SparseBatch
from photon_tpu_torch.game import batched_solve as tbs
from photon_tpu_torch.game import coordinate as tcoord
from photon_tpu_torch.game import data as tdata

ATOL = 1e-5
TASKS = ("logistic_regression", "linear_regression", "poisson_regression")


def _dataset(n_entities=40, rows_mean=6, dim=4, seed=3, sparse=False):
    raw = make_game_data(n_entities=n_entities, rows_per_entity_mean=rows_mean,
                         fixed_dim=5, random_dim=dim, seed=seed)
    x = raw["x_random"]["re0"]
    if sparse:  # padded COO with a ragged row length and pad slots
        rng = np.random.default_rng(seed)
        keep = rng.random(x.shape) < 0.7
        keep[:, -1] = True  # the intercept
        k = dim + 2
        ids = np.zeros((len(x), k), np.int32)
        vals = np.zeros((len(x), k), np.float32)
        for i in range(len(x)):
            cols = np.nonzero(keep[i])[0]
            ids[i, :len(cols)] = cols
            vals[i, :len(cols)] = x[i, cols]
        shards = {"per_entity": (jdata.SparseShard(ids, vals, dim),
                                 tdata.SparseShard(ids, vals, dim))}
    else:
        shards = {"per_entity": (jdata.DenseShard(x), tdata.DenseShard(x))}
    label, ids = raw["label"], {"userId": raw["entity_ids"]["re0"]}
    return (jdata.GameDataset.create(label, {k: v[0] for k, v in shards.items()}, ids),
            tdata.GameDataset.create(label, {k: v[1] for k, v in shards.items()}, ids))


def _problems(variance="none", reg=1.0, max_iterations=100, optimizer="lbfgs"):
    cfg = dict(max_iterations=max_iterations, tolerance=0.0, gradient_tolerance=1e-8)
    return (
        JaxProblemConfig(optimizer=optimizer, regularization=JaxReg("l2", reg),
                         optimizer_config=JaxOptimizerConfig(**cfg),
                         variance_computation=variance),
        ProblemConfig(optimizer=optimizer, regularization=RegularizationContext("l2", reg),
                      optimizer_config=OptimizerConfig(**cfg),
                      variance_computation=variance),
    )


def _bin_batches(bucket):
    """One size bin as the reference's batch and the port's (same arrays)."""
    shape = bucket.row_weight.shape
    zeros = np.zeros(shape, np.float32)
    f = bucket.features
    if isinstance(f, jdata.DenseShard):
        jb = JaxDense(jnp.asarray(f.x), jnp.asarray(bucket.label), jnp.asarray(zeros),
                      jnp.asarray(bucket.row_weight))
        tb = DenseBatch(torch.as_tensor(f.x), torch.as_tensor(bucket.label),
                        torch.as_tensor(zeros), torch.as_tensor(bucket.row_weight))
    else:
        jb = JaxSparse(jnp.asarray(f.ids), jnp.asarray(f.vals), jnp.asarray(bucket.label),
                       jnp.asarray(zeros), jnp.asarray(bucket.row_weight))
        tb = SparseBatch(torch.as_tensor(f.ids), torch.as_tensor(f.vals),
                         torch.as_tensor(bucket.label), torch.as_tensor(zeros),
                         torch.as_tensor(bucket.row_weight))
    return jb, tb


def _bins(jd):
    ds = jdata.build_random_effect_dataset(jd, "userId", "per_entity")
    return [jdata.merge_buckets([ds.buckets[i] for i in g])
            for g in jdata.plan_size_bins(ds.buckets)]


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("task", TASKS)
def test_lane_objective_matches_vmapped_reference(task, sparse):
    import jax

    jd, _ = _dataset(sparse=sparse, seed=5)
    jobj = JaxObjective.create(task, JaxReg("l2", 0.7))
    tobj = tbs.LaneObjective.of(GlmObjective.create(task, RegularizationContext("l2", 0.7)))
    rng = np.random.default_rng(1)
    for bucket in _bins(jd):
        jb, tb = _bin_batches(bucket)
        w = (0.3 * rng.standard_normal((bucket.num_entities, 4))).astype(np.float32)
        jv, jg = jax.vmap(jobj.value_and_grad, in_axes=(0, 0))(jnp.asarray(w), jb)
        tv, tg = tobj.value_and_grad(torch.as_tensor(w), tb)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
        jh = jax.vmap(jobj.hessian_matrix, in_axes=(0, 0))(jnp.asarray(w), jb)
        th = tobj.hessian_matrix(torch.as_tensor(w), tb)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
        jdg = jax.vmap(jobj.hessian_diagonal, in_axes=(0, 0))(jnp.asarray(w), jb)
        tdg = tobj.hessian_diagonal(torch.as_tensor(w), tb)
        np.testing.assert_allclose(tdg.numpy(), np.asarray(jdg), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("task", TASKS)
def test_lane_values_at_several_points_match_vmapped_reference(task, sparse):
    """``LaneObjective.line_values`` (the line search's pass over a block of
    step sizes) is the reference's value at every point of every lane."""
    import jax

    jd, _ = _dataset(sparse=sparse, seed=6)
    jobj = JaxObjective.create(task, JaxReg("l2", 0.7))
    tobj = tbs.LaneObjective.of(GlmObjective.create(task, RegularizationContext("l2", 0.7)))
    rng = np.random.default_rng(2)
    for bucket in _bins(jd):
        jb, tb = _bin_batches(bucket)
        b = bucket.num_entities
        w = (0.3 * rng.standard_normal((b, 4))).astype(np.float32)
        step = (0.3 * rng.standard_normal((b, 4))).astype(np.float32)
        ts = np.concatenate([np.zeros((b, 1)), rng.uniform(0, 2, (b, 4))], 1)
        points = (w[:, None] + ts[..., None] * step[:, None]).astype(np.float32)
        per_point = jax.vmap(jax.vmap(jobj.value, in_axes=(0, None)), in_axes=(0, 0))
        jv = per_point(jnp.asarray(points), jb)
        tv = tobj.line_values(torch.as_tensor(w), torch.as_tensor(step),
                              torch.as_tensor(ts.astype(np.float32)), tb)
        assert tv.shape == (b, 5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("task,variance", [
    *((task, "none") for task in TASKS),
    ("logistic_regression", "simple"), ("logistic_regression", "full"),
])
def test_batched_newton_matches_reference_on_the_same_bins(task, variance):
    jd, _ = _dataset(sparse=task == "poisson_regression")
    jprob, tprob = _problems(variance)
    jobj = JaxObjective.create(task, jprob.regularization)
    tobj = tbs.LaneObjective.of(GlmObjective.create(task, tprob.regularization))
    solver = jbs.cached_newton_solver(jprob)
    for bucket in _bins(jd):
        jb, tb = _bin_batches(bucket)
        w0 = np.zeros((bucket.num_entities, 4), np.float32)
        jc, jr = solver(jobj, jb, jnp.asarray(w0))
        tc, tr = tbs.run_newton_fit(tobj, tb, torch.as_tensor(w0),
                                    cfg=tprob.optimizer_config, variance=variance)
        np.testing.assert_allclose(tc.means.numpy(), np.asarray(jc.means),
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
        if variance == "none":
            assert tc.variances is None
        else:
            np.testing.assert_allclose(tc.variances.numpy(), np.asarray(jc.variances),
                                       atol=ATOL, rtol=0)


def test_batched_newton_matches_f64_ground_truth():
    """Within 1e-5 of the float64 optimum (numpy Newton to 1e-14)."""
    jd, td = _dataset()
    _, tprob = _problems()
    coord = tcoord.RandomEffectCoordinate(
        td, tcoord.RandomEffectCoordinateConfig("per_entity", "userId", tprob),
        "logistic_regression", device="cpu")
    model, stats = coord.train(np.zeros(td.num_examples, np.float32))
    assert stats["entities"] == coord.dataset.num_entities and stats["quarantined"] == 0
    x = td.shards["per_entity"].x.astype(np.float64)
    ids = td.id_columns["userId"]
    table = model.table.numpy()
    for e, key in enumerate(model.keys):
        rows = ids == key
        xe, ye = x[rows], td.label[rows].astype(np.float64)
        w = np.zeros(x.shape[1])
        for _ in range(200):
            p = 1.0 / (1.0 + np.exp(-(xe @ w)))
            step = np.linalg.solve((xe * (p * (1 - p))[:, None]).T @ xe + np.eye(len(w)),
                                   -(xe.T @ (p - ye) + w))
            w += step
            if np.abs(step).max() < 1e-14:
                break
        np.testing.assert_allclose(table[e], w, atol=ATOL, rtol=0)


def test_converged_lane_freezes_while_others_iterate():
    """Lane 0 starts at its optimum (zero gradient) and lane 1 at a point
    one step from it: both must come out exactly as solved alone, with
    their own iteration counts and histories, while lane 2 iterates on."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 4, 4)).astype(np.float32)
    h = torch.as_tensor(np.einsum("bij,bkj->bik", a, a) + 4 * np.eye(4, dtype=np.float32))
    c = torch.as_tensor(rng.standard_normal((3, 4)).astype(np.float32))
    scale = torch.tensor([0.0, 1e-3, 10.0])

    def fun(w):  # lane b: (w - c_b)^T H_b (w - c_b) / 2 + scale_b * |w|^4 / 4
        d = w - c
        hd = torch.einsum("bij,bj->bi", h, d)
        n2 = torch.sum(w * w, -1)
        return (0.5 * torch.sum(d * hd, -1) + 0.25 * scale * n2 * n2,
                hd + scale[:, None] * n2[:, None] * w)

    def hess(w):
        n2 = torch.sum(w * w, -1)
        eye = torch.eye(4)
        return h + scale[:, None, None] * (n2[:, None, None] * eye
                                           + 2 * w[:, :, None] * w[:, None, :])

    cfg = OptimizerConfig(max_iterations=50, tolerance=0.0, gradient_tolerance=1e-7)
    w0 = torch.zeros(3, 4)
    w0[0] = c[0]  # lane 0: gradient exactly zero at w0 (scale 0)
    together = newton(fun, w0, cfg, hess=hess)
    assert together.reason[0] == ConvergenceReason.GRADIENT_TOLERANCE
    assert together.iterations[0] == 0
    assert torch.equal(together.w[0], c[0])
    assert together.history_valid[0].sum() == 1
    assert int(together.iterations[2]) > int(together.iterations[1]) >= 1
    for b in (1, 2):
        alone = newton(lambda w: tuple(t[b:b + 1] for t in fun(w.expand(3, 4))),
                       w0[b:b + 1], cfg,
                       hess=lambda w: hess(w.expand(3, 4))[b:b + 1])
        assert int(alone.iterations[0]) == int(together.iterations[b])
        np.testing.assert_array_equal(alone.w[0].numpy(), together.w[b].numpy())
        np.testing.assert_array_equal(alone.history_valid[0].numpy(),
                                      together.history_valid[b].numpy())
    # Every lane's line search ends in its first block of step sizes, so
    # the loop reads the host once an iteration (and once before it).
    assert together.host_reads == together.loop_iterations + 1


def test_line_search_halves_per_lane():
    """A far start on an exp-shaped lane needs halvings; a quadratic lane
    beside it must take its full Newton step regardless."""
    def fun(w):
        v = torch.stack([torch.exp(w[0, 0]) - 2 * w[0, 0], 0.5 * (w[1, 0] - 3) ** 2])
        g = torch.stack([torch.exp(w[0, 0]) - 2, w[1, 0] - 3])[:, None]
        return v, g

    def hess(w):
        return torch.stack([torch.exp(w[0, 0]), torch.ones(())])[:, None, None]

    res = newton(fun, torch.tensor([[-8.0], [0.0]]),
                 OptimizerConfig(max_iterations=60, tolerance=0.0,
                                 gradient_tolerance=1e-6), hess=hess)
    np.testing.assert_allclose(res.w[:, 0].numpy(), [np.log(2.0), 3.0], atol=1e-5)
    assert int(res.iterations[1]) == 1
    # The far start needs more halvings than one block of step sizes
    # holds: that iteration reads again for the next block.
    assert res.host_reads > res.loop_iterations + 1


@pytest.mark.parametrize("variance", ["none", "full"])
def test_random_effect_coordinate_matches_reference(variance):
    jd, td = _dataset(n_entities=30, seed=8, sparse=True)
    jprob, tprob = _problems(variance, reg=0.5)
    offsets = (0.1 * np.random.default_rng(0).standard_normal(jd.num_examples)
               ).astype(np.float32)
    jc = jcoord.RandomEffectCoordinate(
        jd, jcoord.RandomEffectCoordinateConfig("per_entity", "userId", jprob),
        "logistic_regression")
    tc = tcoord.RandomEffectCoordinate(
        td, tcoord.RandomEffectCoordinateConfig("per_entity", "userId", tprob),
        "logistic_regression", device="cpu")
    jm, js = jc.train(offsets)
    tm, ts = tc.train(offsets)
    np.testing.assert_array_equal(tm.keys, jm.keys)
    np.testing.assert_allclose(tm.table.numpy(), np.asarray(jm.table), atol=ATOL, rtol=0)
    if variance != "none":
        np.testing.assert_allclose(tm.variances.numpy(), np.asarray(jm.variances),
                                   atol=ATOL, rtol=0)
    for key in ("entities", "converged", "quarantined"):
        assert ts[key] == js[key], key
    assert [b["capacity"] for b in ts.bins] == [s["capacity"] for s in
                                                jc.device_data.bin_stats]
    # Warm start from its own model, as the second descent iteration does.
    jm2, _ = jc.train(offsets, initial_model=jm)
    tm2, _ = tc.train(offsets, initial_model=tm)
    np.testing.assert_allclose(tm2.table.numpy(), np.asarray(jm2.table), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc.score_device(tm2).numpy(), jc.score(jm2), atol=ATOL)


def test_nonfinite_entity_keeps_previous_row(monkeypatch):
    """An entity whose solve comes back non-finite keeps its previous row
    and counts as quarantined, not converged (the reference's guard,
    exercised as its fault injection does: by poisoning one solve)."""
    _, td = _dataset(n_entities=12, seed=4)
    _, tprob = _problems()
    tc = tcoord.RandomEffectCoordinate(
        td, tcoord.RandomEffectCoordinateConfig("per_entity", "userId", tprob),
        "logistic_regression", device="cpu")
    offsets = np.zeros(td.num_examples, np.float32)
    model, _ = tc.train(offsets)
    real = tcoord.run_newton_fit

    def poisoned(*args, **kw):
        coefficients, result = real(*args, **kw)
        coefficients.means[0, 1] = float("nan")
        return coefficients, result

    monkeypatch.setattr(tcoord, "run_newton_fit", poisoned)
    again, stats = tc.train(offsets + 0.5, initial_model=model)
    bins = len(tc.device_data.buckets)
    assert stats["quarantined"] == bins
    assert stats["converged"] == stats["entities"] - bins
    first = [int(b.entity_index[0]) for b in tc.device_data.buckets]
    for e in range(model.num_entities):
        same = np.array_equal(again.table[e].numpy(), model.table[e].numpy())
        assert same == (e in first), e


def _route_matches_reference(jprob, tprob, dim):
    """The port takes the reference's ``newton`` route where the reference
    does and raises, naming item 5, where it takes another."""
    if jbs.solver_route(jprob, dim) == "newton":
        assert tbs.solver_route(tprob, dim) == "newton"
    else:
        with pytest.raises(NotImplementedError, match=f"dim {dim}.*item 5"):
            tbs.solver_route(tprob, dim)


def test_solver_route_and_bin_layout_match_reference(monkeypatch):
    jprob, tprob = _problems()
    for dim in (4, 64, 65, 1024, 1025):
        _route_matches_reference(jprob, tprob, dim)
    jd, _ = _dataset()
    buckets = jdata.build_random_effect_dataset(jd, "userId", "per_entity").buckets
    for env in ({}, {"PHOTON_SOLVE_BINNING": "off"}, {"PHOTON_SOLVE_MAX_BINS": "1"},
                {"PHOTON_NEWTON_MAX_DIM": "2"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tbs.bin_layout(buckets) == jbs.bin_layout(buckets)
        _route_matches_reference(jprob, tprob, 4)
        for k in env:
            monkeypatch.delenv(k)


@pytest.mark.parametrize("env,optimizer,match", [
    ({"PHOTON_NEWTON_MAX_DIM": "2"}, "lbfgs", "dim 4"),
    ({}, "newton-cg", "'newton-cg'"),
    ({}, "newton_cg", "'newton_cg'"),
])
def test_unported_entity_routes_raise(monkeypatch, env, optimizer, match):
    """The reference's newton_cg route (past the dim cap, or asked for by
    either spelling) raises at construction, before any work."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, td = _dataset(n_entities=5)
    _, tprob = _problems(optimizer=optimizer)
    with pytest.raises(NotImplementedError, match=f"{match}.*newton_cg or vmapped.*item 5"):
        tcoord.RandomEffectCoordinate(
            td, tcoord.RandomEffectCoordinateConfig("per_entity", "userId", tprob),
            "logistic_regression", device="cpu")
