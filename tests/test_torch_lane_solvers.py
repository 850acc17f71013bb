"""Port parity of the lane solvers: Newton-CG, L-BFGS, OWL-QN and TRON
batched over the entities of a size bin.

The reference solves a bin with ``jax.vmap`` over one problem's
``lax.while_loop`` (``cached_newton_cg_solver`` and ``cached_solver(...,
vmapped=True)``); the port carries the lane axis itself with per-lane masks.
Held on the same bins, sparse and dense: lane Newton-CG within 1e-5 of the
reference's (the bound of ``tests/test_batched_solve.py:200``), lane L-BFGS,
OWL-QN and TRON within 1e-4 (the reference's L1 bound, ``:272``); a lane
that converges early equals that lane solved alone.

L-BFGS, OWL-QN and TRON are held over the iterations before a lane reaches
the float32 value floor (``LANE_PARITY_ITERATIONS``): there a step changes
the objective by an ulp or none, and whether a line search or a trust
region takes it turns on the last bit of the value, so two float32
implementations stop at different points of a basin ~1e-3 wide (recorded
in ROADMAP.md queue 3 with its smallest input).  Newton-CG polishes past
the floor and is held at its end point.

Every lane solver's end point at full convergence is held within
``END_POINT_ATOL`` of an independent float64 optimum (numpy, here:
:func:`float64_optimum`), the L1 lanes' zero pattern exactly: the port's
lane values are float64, so its lanes converge past the reference's
float32 floor, and the end points and polish steps are checked where the
trajectory tests stop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.core import problem as jproblem
from photon_tpu.core.objective import GlmObjective as JaxObjective
from photon_tpu.core.objective import RegularizationContext as JaxReg
from photon_tpu.core.optimizers import OptimizerConfig as JaxOptimizerConfig
from photon_tpu.core.problem import ProblemConfig as JaxProblemConfig
from photon_tpu.data.batch import DenseBatch as JaxDense
from photon_tpu.data.batch import SparseBatch as JaxSparse
from photon_tpu.data.synthetic import make_game_data
from photon_tpu.game import batched_solve as jbs
from photon_tpu.game import data as jdata
from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
from photon_tpu_torch.core.optimizers import OptimizerConfig
from photon_tpu_torch.core.optimizers.base import ConvergenceReason
from photon_tpu_torch.core.optimizers.lbfgs import lbfgs_lanes
from photon_tpu_torch.core.optimizers.newton_cg import newton_cg_lanes
from photon_tpu_torch.core.optimizers.owlqn import owlqn_lanes
from photon_tpu_torch.core.optimizers.tron import tron_lanes
from photon_tpu_torch.core.problem import ProblemConfig
from photon_tpu_torch.data.batch import DenseBatch, SparseBatch
from photon_tpu_torch.game import batched_solve as tbs

NEWTON_CG_ATOL = 1e-5
LANE_ATOL = 1e-4
END_POINT_ATOL = 1e-5
# Full convergence: the bins hold a one-row pure-L1 lane whose two features
# differ little, and OWL-QN needs 161 iterations to settle which one
# carries it (the reference's does not settle it in 100 either).
END_POINT_ITERATIONS = 200
DIM = 6
# Iterations of each solver held to the reference: on these bins no lane
# reaches the float32 value floor before them.
LANE_PARITY_ITERATIONS = {"lbfgs": 4, "owlqn": 4, "tron": 2}


def _bins(sparse: bool, seed: int, n_entities: int = 40):
    """The size bins of a synthetic random effect as the reference's batches
    and the port's (the same arrays)."""
    raw = make_game_data(n_entities=n_entities, rows_per_entity_mean=6, fixed_dim=5,
                         random_dim=DIM, seed=seed)
    x = raw["x_random"]["re0"]
    if sparse:  # padded COO with ragged rows and pad slots
        rng = np.random.default_rng(seed)
        keep = rng.random(x.shape) < 0.7
        keep[:, -1] = True
        k = DIM + 2
        ids = np.zeros((len(x), k), np.int32)
        vals = np.zeros((len(x), k), np.float32)
        for i in range(len(x)):
            cols = np.nonzero(keep[i])[0]
            ids[i, :len(cols)] = cols
            vals[i, :len(cols)] = x[i, cols]
        shard = jdata.SparseShard(ids, vals, DIM)
    else:
        shard = jdata.DenseShard(x)
    jd = jdata.GameDataset.create(raw["label"], {"re": shard},
                                  {"userId": raw["entity_ids"]["re0"]})
    ds = jdata.build_random_effect_dataset(jd, "userId", "re")
    out = []
    for group in jdata.plan_size_bins(ds.buckets):
        bucket = jdata.merge_buckets([ds.buckets[i] for i in group])
        rng = np.random.default_rng(seed + len(out))
        offset = (0.1 * rng.standard_normal(bucket.row_weight.shape)).astype(np.float32)
        f, lab, wt = bucket.features, bucket.label, bucket.row_weight
        if sparse:
            jb = JaxSparse(jnp.asarray(f.ids), jnp.asarray(f.vals), jnp.asarray(lab),
                           jnp.asarray(offset), jnp.asarray(wt))
            tb = SparseBatch(torch.as_tensor(f.ids), torch.as_tensor(f.vals),
                             torch.as_tensor(lab), torch.as_tensor(offset),
                             torch.as_tensor(wt))
        else:
            jb = JaxDense(jnp.asarray(f.x), jnp.asarray(lab), jnp.asarray(offset),
                          jnp.asarray(wt))
            tb = DenseBatch(torch.as_tensor(f.x), torch.as_tensor(lab),
                            torch.as_tensor(offset), torch.as_tensor(wt))
        out.append((bucket.num_entities, jb, tb))
    return out


def _problems(optimizer, reg=("l2", 1.0), variance="none", max_iterations=100):
    cfg = dict(max_iterations=max_iterations, tolerance=0.0, gradient_tolerance=1e-8)
    return (
        JaxProblemConfig(optimizer=optimizer, regularization=JaxReg(*reg),
                         optimizer_config=JaxOptimizerConfig(**cfg),
                         variance_computation=variance),
        ProblemConfig(optimizer=optimizer, regularization=RegularizationContext(*reg),
                      optimizer_config=OptimizerConfig(**cfg),
                      variance_computation=variance),
    )


def _solve_both(task, optimizer, reg, sparse, seed, variance="none",
                max_iterations=100):
    jprob, tprob = _problems(optimizer, reg, variance, max_iterations)
    jobj = JaxObjective.create(task, jprob.regularization)
    tobj = tbs.LaneObjective.of(GlmObjective.create(task, tprob.regularization))
    if optimizer == "newton_cg":
        jsolve = jbs.cached_newton_cg_solver(jprob)
    else:
        jsolve = jproblem.cached_solver(optimizer, jprob.optimizer_config, variance,
                                        vmapped=True)
    pairs = []
    for n, jb, tb in _bins(sparse, seed):
        w0 = np.zeros((n, DIM), np.float32)
        jc, jr = jsolve(jobj, jb, jnp.asarray(w0))
        if optimizer == "newton_cg":
            tc, tr = tbs.run_newton_cg_fit(tobj, tb, torch.as_tensor(w0),
                                           cfg=tprob.optimizer_config, variance=variance)
        else:
            tc, tr = tbs.run_lane_fit(tobj, tb, torch.as_tensor(w0), optimizer=optimizer,
                                      cfg=tprob.optimizer_config, variance=variance)
        pairs.append((jc, jr, tc, tr))
    return pairs


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("task", ["logistic_regression", "poisson_regression"])
def test_lane_newton_cg_matches_vmapped_reference(task, sparse):
    for jc, jr, tc, tr in _solve_both(task, "newton_cg", ("l2", 1.0), sparse, seed=3):
        np.testing.assert_allclose(tc.means.numpy(), np.asarray(jc.means),
                                   atol=NEWTON_CG_ATOL, rtol=0)
        np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
        assert (tr.cg_iterations.numpy() > 0).all()
        # One read a CG block and one a line-search block, far fewer than
        # one a CG step.
        assert tr.host_reads < int(tr.cg_iterations.sum())


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("optimizer,reg", [
    ("lbfgs", ("l2", 1.0)),
    ("owlqn", ("l1", 0.3)),
    ("owlqn", ("elastic_net", 1.0)),
    ("tron", ("l2", 1.0)),
])
def test_lane_solvers_match_vmapped_reference(optimizer, reg, sparse):
    for jc, _, tc, tr in _solve_both("logistic_regression", optimizer, reg, sparse,
                                     seed=5,
                                     max_iterations=LANE_PARITY_ITERATIONS[optimizer]):
        np.testing.assert_allclose(tc.means.numpy(), np.asarray(jc.means),
                                   atol=LANE_ATOL, rtol=0)
        if reg[0] != "l2":
            # The zero pattern survives (OWL-QN lands on exact zeros).
            np.testing.assert_array_equal(tc.means.numpy() == 0.0,
                                          np.asarray(jc.means) == 0.0)
        assert tr.host_reads >= tr.loop_iterations + 1


def test_lane_variances_match_reference():
    for jc, _, tc, _ in _solve_both("logistic_regression", "newton_cg", ("l2", 1.0),
                                    True, seed=7, variance="simple"):
        np.testing.assert_allclose(tc.variances.numpy(), np.asarray(jc.variances),
                                   atol=NEWTON_CG_ATOL, rtol=0)


def _quadratic_lanes(scale):
    """Three lanes: ``(w - c)^T H (w - c) / 2 + scale |w|^4 / 4``."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 4, 4)).astype(np.float32)
    h = torch.as_tensor(np.einsum("bij,bkj->bik", a, a) + 4 * np.eye(4, dtype=np.float32))
    c = torch.as_tensor(rng.standard_normal((3, 4)).astype(np.float32))
    scale = torch.as_tensor(scale)

    def fun(w):
        d = w - c
        hd = torch.einsum("bij,bj->bi", h, d)
        n2 = torch.sum(w * w, -1)
        return (0.5 * torch.sum(d * hd, -1) + 0.25 * scale * n2 * n2,
                hd + scale[:, None] * n2[:, None] * w)

    def hvp_at(w):
        n2 = torch.sum(w * w, -1)

        def hv(v):
            return (torch.einsum("bij,bj->bi", h, v)
                    + scale[:, None] * (n2[:, None] * v
                                        + 2 * w * torch.sum(w * v, -1)[:, None]))
        return hv

    return fun, hvp_at, c


def _lane_of(fn, b):
    """Lane ``b`` of a three-lane function, as a one-lane function."""
    def one(w, *rest):
        out = fn(w.expand(3, -1), *(r.expand(3, -1) for r in rest))
        return tuple(t[b:b + 1] for t in out) if isinstance(out, tuple) else out[b:b + 1]
    return one


@pytest.mark.parametrize("solver", ["newton_cg", "lbfgs", "owlqn", "tron"])
def test_converged_lane_freezes_and_equals_its_solve_alone(solver):
    """Lane 0 starts at its optimum (zero gradient), lanes 1 and 2 iterate
    to different depths: each equals its own lane solved alone, with its own
    iteration count and history, while the others iterate on."""
    fun, hvp_at, c = _quadratic_lanes([0.0, 1e-3, 10.0])
    cfg = OptimizerConfig(max_iterations=60, tolerance=0.0, gradient_tolerance=1e-7)

    def run(f, hv, w0):
        if solver == "newton_cg":
            return newton_cg_lanes(f, w0, cfg, hvp_at=hv)
        if solver == "lbfgs":
            return lbfgs_lanes(f, w0, cfg)
        if solver == "owlqn":
            return owlqn_lanes(f, w0, cfg, l1_weight=0.0)
        return tron_lanes(f, w0, cfg, hvp_at=hv)

    w0 = torch.zeros(3, 4)
    w0[0] = c[0]
    together = run(fun, hvp_at, w0)
    assert together.reason[0] == ConvergenceReason.GRADIENT_TOLERANCE
    assert together.iterations[0] == 0
    assert torch.equal(together.w[0], c[0])
    assert int(together.history_valid[0].sum()) == 1
    assert int(together.iterations[2]) >= 1 and int(together.iterations[1]) >= 1
    for b in (1, 2):
        def hv_b(w, b=b):
            op = hvp_at(w.expand(3, -1))
            return lambda v: op(v.expand(3, -1))[b:b + 1]

        alone = run(_lane_of(fun, b), hv_b, w0[b:b + 1])
        assert int(alone.iterations[0]) == int(together.iterations[b])
        np.testing.assert_array_equal(alone.w[0].numpy(), together.w[b].numpy())
        np.testing.assert_array_equal(alone.history_valid[0].numpy(),
                                      together.history_valid[b].numpy())
        np.testing.assert_array_equal(alone.history_value[0].numpy(),
                                      together.history_value[b].numpy())


def test_lane_objective_hvp_and_point_values_match_reference():
    """``LaneObjective.hvp_operator`` is the reference's ``hvp_operator``
    under ``vmap``, and ``point_values`` its value at explicit points."""
    import jax

    jobj = JaxObjective.create("logistic_regression", JaxReg("l2", 0.7))
    tobj = tbs.LaneObjective.of(GlmObjective.create("logistic_regression",
                                                    RegularizationContext("l2", 0.7)))
    rng = np.random.default_rng(4)
    for sparse in (False, True):
        for n, jb, tb in _bins(sparse, seed=9):
            w = (0.3 * rng.standard_normal((n, DIM))).astype(np.float32)
            v = rng.standard_normal((n, DIM)).astype(np.float32)
            jhv = jax.vmap(lambda w_, v_, b_: jobj.hvp_operator(w_, b_)(v_))(
                jnp.asarray(w), jnp.asarray(v), jb)
            thv = tobj.hvp_operator(torch.as_tensor(w), tb)(torch.as_tensor(v))
            np.testing.assert_allclose(thv.numpy(), np.asarray(jhv), rtol=1e-5, atol=1e-5)
            pts = (w[:, None] + rng.standard_normal((n, 3, DIM))).astype(np.float32)
            jv = jax.vmap(jax.vmap(jobj.value, in_axes=(0, None)))(jnp.asarray(pts), jb)
            tv = tobj.point_values(torch.as_tensor(pts), tb)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


def dense_lanes(batch, dim: int):
    """``(x [B, R, dim], label, offset, weight [B, R])`` in float64 from a
    lane batch of the port (dense ``x``, or padded COO ``ids``/``vals``)."""
    if isinstance(batch, DenseBatch):
        x = batch.x.double().numpy()
    else:
        ids, vals = batch.ids.long().numpy(), batch.vals.double().numpy()
        bsz, rows, _ = ids.shape
        x = np.zeros((bsz, rows, dim))
        b, r = np.meshgrid(np.arange(bsz), np.arange(rows), indexing="ij")
        np.add.at(x, (b[..., None], r[..., None], ids), vals)
    return (x, batch.label.double().numpy(), batch.offset.double().numpy(),
            batch.weight.double().numpy())


def _loss64(task):
    """``(value, d1, d2, curvature bound)`` of a GLM loss in numpy."""
    if task == "logistic_regression":
        def sigmoid(z):
            return 1.0 / (1.0 + np.exp(-z))
        return (lambda z, y: np.logaddexp(0.0, z) - y * z,
                lambda z, y: sigmoid(z) - y,
                lambda z, y: sigmoid(z) * (1.0 - sigmoid(z)), 0.25)
    assert task == "poisson_regression", task
    return (lambda z, y: np.exp(z) - y * z, lambda z, y: np.exp(z) - y,
            lambda z, y: np.exp(z), None)


def float64_optimum(x, y, offset, weight, task, l2, l1=0.0):
    """Each lane's minimizer of ``sum_r weight * loss(x . w + offset, y) +
    l2/2 |w|^2 + l1 |w|_1`` in float64, independent of both packages: a
    smooth lane by damped Newton; an L1 lane by FISTA to find its support,
    then Newton on the support with its signs fixed, until the KKT
    conditions hold (asserted, so a wrong optimum fails loudly)."""
    value, d1, d2, curvature = _loss64(task)
    bsz, _, d = x.shape

    def grad(w):
        z = np.einsum("brd,bd->br", x, w) + offset
        return np.einsum("brd,br->bd", x, weight * d1(z, y)) + l2 * w

    def total(w, sign):
        z = np.einsum("brd,bd->br", x, w) + offset
        return (np.sum(weight * value(z, y), -1) + 0.5 * l2 * np.sum(w * w, -1)
                + l1 * np.sum(sign * w, -1))

    def newton(w, free):
        sign = np.sign(w)
        for _ in range(100):
            z = np.einsum("brd,bd->br", x, w) + offset
            g = (grad(w) + l1 * sign) * free
            if np.abs(g).max() < 1e-13:
                break
            h = np.einsum("brd,br,bre->bde", x, weight * d2(z, y), x) + l2 * np.eye(d)
            h = h * free[:, :, None] * free[:, None, :] + np.eye(d) * ~free[:, None, :]
            step = -np.linalg.solve(h, g[..., None])[..., 0]
            t, f0 = np.ones(bsz), total(w, sign)
            for _ in range(60):
                bad = total(w + t[:, None] * step, sign) > f0 + 1e-4 * t * np.sum(g * step, -1)
                if not bad.any():
                    break
                t = np.where(bad, 0.5 * t, t)
            w = w + t[:, None] * step
        return w

    if not l1:
        return newton(np.zeros((bsz, d)), np.ones((bsz, d), bool))
    lipschitz = np.linalg.eigvalsh(np.einsum("brd,br,bre->bde", x, weight * curvature,
                                             x))[:, -1:] + l2
    w = v = np.zeros((bsz, d))
    t = 1.0
    for _ in range(5000):
        u = v - grad(v) / lipschitz
        w_next = np.sign(u) * np.maximum(np.abs(u) - l1 / lipschitz, 0.0)
        t_next = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        v = w_next + ((t - 1.0) / t_next) * (w_next - w)
        w, t = w_next, t_next
    for _ in range(d + 1):
        free = w != 0.0
        w = np.where(free, newton(w, free), 0.0)
        g = grad(w)
        enter = ~free & (np.abs(g) > l1)
        if not enter.any():
            break
        w = np.where(enter, -1e-9 * np.sign(g), w)
    g, on = grad(w), w != 0.0
    assert np.all(np.abs(g[~on]) <= l1), "KKT: a zero coordinate should enter"
    assert np.all(np.abs((g + l1 * np.sign(w))[on]) < 1e-9), "KKT: not stationary"
    return w


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("optimizer,reg", [
    ("newton_cg", ("l2", 1.0)),
    ("lbfgs", ("l2", 1.0)),
    ("owlqn", ("l1", 0.3)),
    ("owlqn", ("elastic_net", 1.0)),
    ("tron", ("l2", 1.0)),
])
def test_lane_end_points_reach_the_float64_optimum(optimizer, reg, sparse):
    """At full convergence (tolerance 0, ``END_POINT_ITERATIONS``) every lane
    stops before the cap and ends within ``END_POINT_ATOL`` of its float64
    optimum; the L1 lanes land on its zeros exactly."""
    _, tprob = _problems(optimizer, reg, max_iterations=END_POINT_ITERATIONS)
    tobj = tbs.LaneObjective.of(GlmObjective.create("logistic_regression",
                                                    tprob.regularization))
    for n, _, tb in _bins(sparse, seed=5):
        w0 = torch.zeros(n, DIM)
        if optimizer == "newton_cg":
            tc, tr = tbs.run_newton_cg_fit(tobj, tb, w0, cfg=tprob.optimizer_config,
                                           variance="none")
        else:
            tc, tr = tbs.run_lane_fit(tobj, tb, w0, optimizer=optimizer,
                                      cfg=tprob.optimizer_config, variance="none")
        truth = float64_optimum(*dense_lanes(tb, DIM), "logistic_regression",
                                tobj.l2_weight, tobj.l1_weight)
        assert not (tr.reason == ConvergenceReason.MAX_ITERATIONS).any()
        if optimizer != "tron":
            # TRON, as the reference's, stops a lane whose trust region
            # collapses at the float32 gradient's floor as not improving.
            assert tr.converged.all(), tr.reason
        np.testing.assert_allclose(tc.means.double().numpy(), truth,
                                   atol=END_POINT_ATOL, rtol=0)
        if reg[0] != "l2":
            np.testing.assert_array_equal(tc.means.numpy() == 0.0, truth == 0.0)
