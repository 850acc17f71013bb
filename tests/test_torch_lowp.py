"""Low-precision serving tables against the JAX package, on the CPU.

The port's bf16 and int8 serving tables equal the reference's bit for bit
(bf16 bits; int8 ``q`` and ``scale``), as do the host row codecs; per
storage dtype the port's scorer agrees with the reference's within 1e-5
and both with the f32 host oracle within ``PARITY_TOL``; the serving cases
of ``tests/test_lowp.py``: the cold fallback exact per dtype, no capture
after warmup per dtype, the table-bytes bars (bf16 >= 1.9x, int8 >= 3.5x),
swap keeping the dtype, growth in place, and a dtype-mismatched swap
refused; and per dtype, parity at ``bench.py``'s serving fixture, where
the reference's bf16 tables pass their bound after bench.py's window.
"""

import numpy as np
import pytest
import torch

from photon_tpu.data.synthetic import make_game_dataset as ref_dataset
from photon_tpu.game import lowp as ref_lowp
from photon_tpu.game import model as ref_model
from photon_tpu.models.glm import Coefficients as RefCoefficients
from photon_tpu.models.glm import model_for_task as ref_model_for_task
from photon_tpu import serving as ref_serving
from photon_tpu.telemetry import TelemetrySession as RefSession
from photon_tpu_torch.game import lowp
from photon_tpu_torch.game.data import DenseShard, GameDataset
from photon_tpu_torch.game.model import game_model_from_numpy
from photon_tpu_torch.serving import (
    GameScorer,
    ScoringRequest,
    build_requests,
    concat_requests,
    host_score_request,
    request_spec_for_dataset,
)
from photon_tpu_torch.telemetry import TelemetrySession

LOSSY = ("bf16", "int8")
SCORE_TOL = 1e-5
# Wide enough that int8's per-row scale amortizes past the 3.5x bar
# (bytes ratio 4d / (d + 4)).
RANDOM_DIM = 32


def _arrays(seed, n_entities=40, fixed_dim=6, random_dim=RANDOM_DIM):
    data, _ = ref_dataset(n_entities, 4, fixed_dim, random_dim, seed=seed)
    rng = np.random.default_rng(seed)
    keys = np.unique(data.id_columns["re0"])
    means = rng.standard_normal(fixed_dim).astype(np.float32)
    table = rng.standard_normal((len(keys), random_dim)).astype(np.float32)
    return (means, keys, table), data


def _ref_model(means, keys, table):
    task = "logistic_regression"
    return ref_model.GameModel(coordinates={
        "fixed": ref_model.FixedEffectModel(
            ref_model_for_task(task, RefCoefficients(means)), "global"),
        "per_entity": ref_model.RandomEffectModel(
            table=table, keys=keys, entity_column="re0", shard_name="re0",
            task_type=task),
    }, task_type=task)


def _port_model(means, keys, table):
    return game_model_from_numpy("logistic_regression", {
        "fixed": {"type": "fixed", "shard_name": "global", "means": means},
        "per_entity": {"type": "random", "shard_name": "re0",
                       "entity_column": "re0", "keys": keys, "table": table},
    }, device="cpu")


def _as_port(data) -> GameDataset:
    return GameDataset(label=data.label, offset=data.offset, weight=data.weight,
                       shards={n: DenseShard(s.x) for n, s in data.shards.items()},
                       id_columns=dict(data.id_columns))


def _counter_total(session, name):
    return sum(m["value"] for m in session.registry.snapshot()["counters"]
               if m["name"] == name)


@pytest.fixture(scope="module")
def served_tiers():
    arrays, rdata = _arrays(3)
    rm, pm, pdata = _ref_model(*arrays), _port_model(*arrays), _as_port(rdata)
    out = {}
    for dtype in lowp.TABLE_DTYPES:
        rs, ps = RefSession(f"ref-{dtype}"), TelemetrySession(f"port-{dtype}")
        ref = ref_serving.GameScorer(
            rm, request_spec=ref_serving.request_spec_for_dataset(rm, rdata),
            max_batch=64, telemetry=rs, table_dtype=dtype).warmup()
        port = GameScorer(
            pm, device="cpu", request_spec=request_spec_for_dataset(pm, pdata),
            max_batch=64, telemetry=ps, table_dtype=dtype).warmup()
        out[dtype] = (ref, port, rs, ps)
    return rm, pm, rdata, pdata, out


def _table_rows(seed):
    """Rows of mixed magnitudes with exact-zero rows and halfway cases."""
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((37, 24))
             * 10.0 ** rng.integers(-4, 4, (37, 1))).astype(np.float32)
    table[5] = 0.0
    table[9, :4] = [127.0, 0.5, -1.5, 2.5]  # int8: q exactly at .5 steps
    return table


# -- the storage forms, bit for bit ------------------------------------------

@pytest.mark.parametrize("capacity", [None, 128])
def test_serving_tables_equal_reference_bit_for_bit(capacity):
    table = _table_rows(0)
    keys = np.arange(len(table))
    rre = ref_model.RandomEffectModel(table=table, keys=keys, entity_column="e",
                                      shard_name="s", task_type="logistic_regression")
    pre = _port_model(np.zeros(2, np.float32), keys, table).coordinate("per_entity")
    assert pre.serving_capacity == rre.serving_capacity == 64
    f32 = pre.serving_table(capacity=capacity).numpy()
    np.testing.assert_array_equal(f32, np.asarray(rre.serving_table(capacity=capacity)))
    assert not f32[len(table):].any()
    bf16 = pre.serving_table(capacity=capacity, dtype="bf16")
    ref_bf16 = np.asarray(rre.serving_table(capacity=capacity, dtype="bf16"))
    np.testing.assert_array_equal(
        bf16.view(torch.int16).numpy().view(np.uint16),
        ref_bf16.view(np.uint16))
    q, scale = pre.serving_table(capacity=capacity, dtype="int8")
    rq, rscale = rre.serving_table(capacity=capacity, dtype="int8")
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert scale.numpy().tobytes() == np.asarray(rscale).tobytes()
    assert scale[len(table):].eq(0).all() and scale[5] == 0


def test_too_small_capacity_refuses():
    table = _table_rows(1)
    pre = _port_model(np.zeros(2, np.float32), np.arange(len(table)),
                      table).coordinate("per_entity")
    with pytest.raises(ValueError, match="layout-shape change"):
        pre.serving_table(capacity=len(table))


def test_host_codecs_equal_reference():
    arr = _table_rows(2)
    q, scale = lowp.quantize_int8_rows(arr)
    rq, rscale = ref_lowp.quantize_int8_rows(arr)
    assert q.tobytes() == rq.tobytes() and scale.tobytes() == rscale.tobytes()
    np.testing.assert_array_equal(lowp.dequantize_int8_rows(q, scale),
                                  ref_lowp.dequantize_int8_rows(rq, rscale))
    q, scale, ok = lowp.quantize_int8_canonical(arr)
    rq, rscale, rok = ref_lowp.quantize_int8_canonical(arr)
    assert ok == rok and q.tobytes() == rq.tobytes() and scale.tobytes() == rscale.tobytes()
    bits = lowp.encode_bf16(arr)
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, ref_lowp.encode_bf16(arr).view(np.uint16))
    back = lowp.decode_bf16(bits)
    np.testing.assert_array_equal(back, ref_lowp.decode_bf16(ref_lowp.encode_bf16(arr)))
    np.testing.assert_array_equal(lowp.encode_bf16(back), bits)  # idempotent


@pytest.mark.parametrize("dtype", lowp.TABLE_DTYPES)
def test_dtype_registry_matches_reference(dtype):
    assert lowp.TABLE_DTYPES == ref_lowp.TABLE_DTYPES
    assert lowp.parity_tol_for(dtype) == ref_lowp.parity_tol_for(dtype)
    assert lowp.check_dtype(None) == "f32"
    with pytest.raises(ValueError, match="fp8"):
        lowp.check_dtype("fp8")


# -- serving per dtype -------------------------------------------------------

@pytest.mark.parametrize("dtype", lowp.TABLE_DTYPES)
def test_request_and_dataset_parity_per_dtype(served_tiers, dtype):
    rm, pm, rdata, pdata, tiers = served_tiers
    ref, port, _, _ = tiers[dtype]
    tol = lowp.parity_tol_for(dtype)
    sizes = [1, 3, 17, 64]
    for rreq, preq in zip(ref_serving.build_requests(rdata, rm, sizes),
                          build_requests(pdata, pm, sizes)):
        got = port.score_batch(preq)
        np.testing.assert_allclose(got, np.asarray(ref.score_batch(rreq)),
                                   rtol=0, atol=SCORE_TOL)
        assert np.abs(got - host_score_request(pm, preq)).max() <= tol
    got = port.score_dataset(pdata)
    np.testing.assert_allclose(got, np.asarray(ref.score_dataset(rdata)),
                               rtol=0, atol=SCORE_TOL)
    assert np.abs(got - pm.score(pdata)).max() <= tol


@pytest.mark.parametrize("dtype", LOSSY)
def test_cold_entities_fall_back_exactly_per_dtype(served_tiers, dtype):
    _, pm, _, pdata, tiers = served_tiers
    _, port, _, session = tiers[dtype]
    before = _counter_total(session, "serving.cold_entities")
    x_fixed, x_rand = pdata.shards["global"].x[:3], pdata.shards["re0"].x[:3]
    got = port.score_batch(ScoringRequest(
        features={"global": x_fixed, "re0": x_rand},
        entity_ids={"re0": np.array([10 ** 9, 10 ** 9 + 1, 10 ** 9 + 2])}))
    np.testing.assert_allclose(
        got, x_fixed @ pm.coordinate("fixed").coefficients.means.numpy(),
        rtol=0, atol=SCORE_TOL)
    assert _counter_total(session, "serving.cold_entities") == before + 3


@pytest.mark.parametrize("dtype", lowp.TABLE_DTYPES)
def test_no_capture_after_warmup_per_dtype(served_tiers, dtype):
    _, pm, _, pdata, tiers = served_tiers
    _, port, _, session = tiers[dtype]
    warm = port.compilations
    syncs = _counter_total(session, "serving.host_syncs")
    sizes = np.random.default_rng(4).integers(1, 65, size=20).tolist()
    for req in build_requests(pdata, pm, sizes):
        port.score_batch(req)
    assert port.compilations == warm
    assert _counter_total(session, "serving.host_syncs") - syncs == 20


def test_table_bytes_bars_and_reference_bytes(served_tiers):
    *_, tiers = served_tiers
    port_bytes = {d: tiers[d][3].registry.gauge("serving.table_bytes", dtype=d).value
                  for d in tiers}
    ref_bytes = {d: tiers[d][2].registry.gauge("serving.table_bytes", dtype=d).value
                 for d in tiers}
    assert port_bytes == ref_bytes
    assert port_bytes["f32"] / port_bytes["bf16"] >= 1.9
    assert port_bytes["f32"] / port_bytes["int8"] >= 3.5


def _perturbed(arrays, seed, extra_entities=0):
    means, keys, table = arrays
    rng = np.random.default_rng(seed)
    table = table + 0.1 * rng.standard_normal(table.shape).astype(np.float32)
    if extra_entities:
        keys = np.concatenate([keys, np.arange(keys.max() + 1, keys.max() + 1
                                               + extra_entities).astype(keys.dtype)])
        table = np.concatenate([table, rng.standard_normal(
            (extra_entities, table.shape[1])).astype(np.float32)])
    return means, keys, table.astype(np.float32)


@pytest.mark.parametrize("dtype", LOSSY)
def test_swap_model_keeps_dtype_and_matches_reference(dtype):
    arrays, rdata = _arrays(9)
    pdata = _as_port(rdata)
    new = _perturbed(arrays, 10)
    rm, pm = _ref_model(*arrays), _port_model(*arrays)
    ref = ref_serving.GameScorer(
        rm, request_spec=ref_serving.request_spec_for_dataset(rm, rdata),
        max_batch=16, table_dtype=dtype).warmup()
    port = GameScorer(pm, device="cpu", request_spec=request_spec_for_dataset(pm, pdata),
                      max_batch=16, table_dtype=dtype).warmup()
    warm = port.compilations
    ref.swap_model(_ref_model(*new))
    port.swap_model(_port_model(*new))
    assert port.table_dtype == dtype and port.compilations == warm
    got = port.score_dataset(pdata)
    np.testing.assert_allclose(got, np.asarray(ref.score_dataset(rdata)),
                               rtol=0, atol=SCORE_TOL)
    assert np.abs(got - _port_model(*new).score(pdata)).max() <= lowp.parity_tol_for(dtype)


@pytest.mark.parametrize("dtype", LOSSY)
def test_grow_in_place_keeps_dtype(dtype):
    arrays, rdata = _arrays(12)
    pdata = _as_port(rdata)
    pm = _port_model(*arrays)
    scorer = GameScorer(pm, device="cpu", request_spec=request_spec_for_dataset(pm, pdata),
                        max_batch=16, table_dtype=dtype, table_capacity_factor=2).warmup()
    warm = scorer.compilations
    means, keys, table = _perturbed(arrays, 13, extra_entities=8)
    scorer.swap_model(_port_model(means, keys, table))
    assert scorer.table_dtype == dtype and scorer.compilations == warm
    x_fixed, x_rand = pdata.shards["global"].x[:8], pdata.shards["re0"].x[:8]
    got = scorer.score_batch(ScoringRequest(
        features={"global": x_fixed, "re0": x_rand}, entity_ids={"re0": keys[-8:]}))
    want = x_fixed @ means + np.einsum("rd,rd->r", x_rand, table[-8:])
    assert np.abs(got - want).max() <= lowp.parity_tol_for(dtype)


@pytest.mark.parametrize("dtype", lowp.TABLE_DTYPES)
def test_swapped_tables_equal_the_build_path_bit_for_bit(dtype):
    """A swap (its allocations staged at warmup) leaves in the captured
    leaves exactly what the build path makes of the new model: the fixed
    weights and the random table at the served capacity, in f32, bf16 bits
    and int8 ``q``/``scale``, and the reference's tables too."""
    arrays, rdata = _arrays(16)
    pdata = _as_port(rdata)
    pm = _port_model(*arrays)
    scorer = GameScorer(pm, device="cpu", request_spec=request_spec_for_dataset(pm, pdata),
                        max_batch=16, table_dtype=dtype, table_capacity_factor=2).warmup()
    new = _perturbed(arrays, 17, extra_entities=5)
    new_model = _port_model(*new)
    scorer.swap_model(new_model)
    (capacity,) = [c.capacity for c in scorer._plan if c.kind == "random"]
    table = new_model.coordinate("per_entity").serving_table(capacity=capacity, dtype=dtype)
    want = [new_model.coordinate("fixed").serving_weights("cpu"),
            *(table if isinstance(table, tuple) else (table,))]
    got = scorer._table_leaves()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    ref_table = ref_model.RandomEffectModel(
        table=new[2], keys=new[1], entity_column="re0", shard_name="re0",
        task_type="logistic_regression").serving_table(capacity=capacity, dtype=dtype)
    ref_leaves = ref_table if isinstance(ref_table, tuple) else (ref_table,)
    for g, r in zip(got[1:], ref_leaves):
        assert g.view(torch.uint8).numpy().tobytes() == np.asarray(r).tobytes()


def test_swap_model_dtype_mismatch_refuses():
    arrays, rdata = _arrays(14)
    pdata = _as_port(rdata)
    pm = _port_model(*arrays)
    scorer = GameScorer(pm, device="cpu", request_spec=request_spec_for_dataset(pm, pdata),
                        max_batch=16, table_dtype="bf16").warmup()
    with pytest.raises(ValueError, match="bf16"):
        scorer.swap_model(_port_model(*_perturbed(arrays, 15)), table_dtype="f32")
    with pytest.raises(ValueError, match="f16"):
        GameScorer(pm, device="cpu", table_dtype="f16")
    got = scorer.score_dataset(pdata)
    assert np.abs(got - pm.score(pdata)).max() <= lowp.parity_tol_for("bf16")


# -- parity at bench.py's serving fixture --------------------------------------

# bench.py's serving bench at its accelerator size (bench.py:1319-1367):
# 20,000 entities, two random coordinates and a fixed effect of d = 32, and
# 1500 geometric requests of mean 8 rows capped at 128.  bench.py gates
# parity on the first 100 requests.
BENCH_WINDOW = 100


@pytest.fixture(scope="module")
def bench_fixture():
    from photon_tpu.drivers.serve_game import request_sizes as ref_sizes
    from photon_tpu_torch.drivers.serve_game import request_sizes

    rdata, _ = ref_dataset(20_000, 20, 32, 32, seed=0, n_random_coords=2)
    rng = np.random.default_rng(7)
    task = "logistic_regression"
    means = rng.standard_normal(32).astype(np.float32)
    ref_coords = {"fixed": ref_model.FixedEffectModel(
        ref_model_for_task(task, RefCoefficients(means)), "global")}
    port_coords = {"fixed": {"type": "fixed", "shard_name": "global", "means": means}}
    for name in ("re0", "re1"):
        keys = np.unique(rdata.id_columns[name])
        table = rng.standard_normal((len(keys), 32)).astype(np.float32)
        ref_coords[name] = ref_model.RandomEffectModel(
            table=table, keys=keys, entity_column=name, shard_name=name, task_type=task)
        port_coords[name] = {"type": "random", "shard_name": name, "entity_column": name,
                             "keys": keys, "table": table}
    rm = ref_model.GameModel(coordinates=ref_coords, task_type=task)
    pm = game_model_from_numpy(task, port_coords, device="cpu")
    pdata = _as_port(rdata)
    sizes = request_sizes(1500, 8.0, 128, seed=0)
    np.testing.assert_array_equal(sizes, ref_sizes(1500, 8.0, 128, seed=0))
    return rm, pm, rdata, pdata, sizes


@pytest.mark.parametrize("dtype", lowp.TABLE_DTYPES)
def test_bench_fixture_parity_per_dtype(bench_fixture, dtype):
    """Every request within PARITY_TOL for f32 and int8; for bf16 only
    bench.py's first 100, because the reference's own bf16 tables (bit
    for bit the port's) pass 5e-2 later in the same stream."""
    rm, pm, rdata, pdata, sizes = bench_fixture
    cuts = np.cumsum(sizes)[:-1]
    rreqs = ref_serving.build_requests(rdata, rm, sizes)
    preqs = build_requests(pdata, pm, sizes)
    oracle = np.split(host_score_request(pm, concat_requests(preqs)), cuts)
    ref = ref_serving.GameScorer(
        rm, request_spec=ref_serving.request_spec_for_dataset(rm, rdata),
        max_batch=128, table_dtype=dtype).warmup()
    port = GameScorer(pm, device="cpu", request_spec=request_spec_for_dataset(pm, pdata),
                      max_batch=128, table_dtype=dtype).warmup()
    want = np.asarray(ref.score_batch(ref_serving.concat_requests(rreqs)))
    got = port.score_batch(concat_requests(preqs))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    tol = lowp.parity_tol_for(dtype)
    for scores in (want, got):
        worst = [float(np.abs(s - o).max()) for s, o in zip(np.split(scores, cuts), oracle)]
        if dtype == "bf16":
            assert max(worst[:BENCH_WINDOW]) <= tol < max(worst)
        else:
            assert max(worst) <= tol
