"""The serving slice against the JAX package: the port's ``GameScorer``,
``RequestBatcher``, ``score_game`` and ``serve_game`` fed the same numpy
model and requests as the reference's, on the CPU.

Held to: request and dataset scores within 1e-5 of the reference's scorer,
and both within ``PARITY_TOL`` of the host oracle; the same bucket ladder,
padded costs, request cuts and cold counts; the contracts of
``tests/test_serving.py`` (one program per bucket after warmup, the
off-ladder raise, one host sync per batch, padding never cold, the
batcher's slices and failures, swap without recapture, grown vocabulary,
layout refusal); ``score_game`` against the reference's driver on one saved
model directory (scores 1e-5, metrics 1e-6); ``serve_game --traffic
geometric`` against the host oracle (1e-4) with its report's "## Online
serving" section.
"""

import json

import numpy as np
import pytest
import torch

from photon_tpu.data.synthetic import make_game_dataset as ref_dataset
from photon_tpu.game import model as ref_model
from photon_tpu.models.glm import Coefficients as RefCoefficients
from photon_tpu.models.glm import model_for_task as ref_model_for_task
from photon_tpu import serving as ref_serving
from photon_tpu.telemetry import TelemetrySession as RefSession
from photon_tpu_torch.game.data import DenseShard, GameDataset, SparseShard
from photon_tpu_torch.game.lowp import PARITY_TOL
from photon_tpu_torch.game.model import game_model_from_numpy
from photon_tpu_torch.serving import (
    GameScorer,
    RequestBatcher,
    ScoringRequest,
    bucket_ladder,
    build_requests,
    concat_requests,
    host_score_request,
    padded_cost,
    request_from_dataset,
    request_spec_for_dataset,
    request_windows,
    run_closed_loop,
    slice_request,
)
from photon_tpu_torch.telemetry import TelemetrySession

SCORE_TOL = 1e-5
METRIC_TOL = 1e-6
MAX_BATCH = 32


def _arrays(seed, n_entities=40, fixed_dim=6, random_dim=4):
    """numpy model arrays (fixed means, sorted keys, table) and the
    reference's dataset for them."""
    data, maps = ref_dataset(n_entities, 4, fixed_dim, random_dim, seed=seed)
    rng = np.random.default_rng(seed)
    keys = np.unique(data.id_columns["re0"])
    means = rng.standard_normal(fixed_dim).astype(np.float32)
    table = rng.standard_normal((len(keys), random_dim)).astype(np.float32)
    return (means, keys, table), data, maps


def _ref_model(means, keys, table, task="logistic_regression"):
    return ref_model.GameModel(
        coordinates={
            "fixed": ref_model.FixedEffectModel(
                ref_model_for_task(task, RefCoefficients(means)), "global"),
            "per_entity": ref_model.RandomEffectModel(
                table=table, keys=keys, entity_column="re0", shard_name="re0",
                task_type=task),
        },
        task_type=task,
    )


def _port_model(means, keys, table, task="logistic_regression"):
    return game_model_from_numpy(task, {
        "fixed": {"type": "fixed", "shard_name": "global", "means": means},
        "per_entity": {"type": "random", "shard_name": "re0",
                       "entity_column": "re0", "keys": keys, "table": table},
    }, device="cpu")


def _as_port(data) -> GameDataset:
    def shard(s):
        if hasattr(s, "x"):
            return DenseShard(s.x)
        return SparseShard(s.ids, s.vals, s.dim_)

    return GameDataset(label=data.label, offset=data.offset, weight=data.weight,
                       shards={n: shard(s) for n, s in data.shards.items()},
                       id_columns=dict(data.id_columns))


def _counter_total(session, name, **labels):
    total = 0
    for m in session.registry.snapshot()["counters"]:
        if m["name"] != name:
            continue
        if labels and any(str(m["labels"].get(k)) != str(v) for k, v in labels.items()):
            continue
        total += m["value"]
    return total


def _pair(seed):
    arrays, data, maps = _arrays(seed)
    rm, pm = _ref_model(*arrays), _port_model(*arrays)
    return rm, pm, data, _as_port(data), maps


@pytest.fixture(scope="module")
def served():
    rm, pm, rdata, pdata, _ = _pair(3)
    rsession, psession = RefSession("ref"), TelemetrySession("port")
    ref = ref_serving.GameScorer(
        rm, request_spec=ref_serving.request_spec_for_dataset(rm, rdata),
        max_batch=MAX_BATCH, telemetry=rsession).warmup()
    port = GameScorer(
        pm, device="cpu", request_spec=request_spec_for_dataset(pm, pdata),
        max_batch=MAX_BATCH, telemetry=psession).warmup()
    return rm, pm, rdata, pdata, ref, port, rsession, psession


def test_request_and_dataset_scores_match_reference(served):
    rm, pm, rdata, pdata, ref, port, _, _ = served
    sizes = [1, 3, 17, MAX_BATCH, MAX_BATCH, 100]  # 100 rows: chunked
    for rreq, preq in zip(ref_serving.build_requests(rdata, rm, sizes),
                          build_requests(pdata, pm, sizes)):
        got = port.score_batch(preq)
        np.testing.assert_allclose(got, np.asarray(ref.score_batch(rreq)),
                                   rtol=0, atol=SCORE_TOL)
        assert np.abs(got - host_score_request(pm, preq)).max() <= PARITY_TOL["f32"]
        assert np.abs(ref_serving.host_score_request(rm, rreq)
                      - host_score_request(pm, preq)).max() <= SCORE_TOL
    got = port.score_dataset(pdata)
    np.testing.assert_allclose(got, np.asarray(ref.score_dataset(rdata)),
                               rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(got, pm.score(pdata), rtol=0, atol=SCORE_TOL)


def test_sparse_request_spec_matches_reference():
    """Padded-COO shards (the Avro layout) through both scorers."""
    rm, pm, rdata, _, _ = _pair(11)
    import dataclasses

    from photon_tpu.game.data import SparseShard as RefSparse

    def sparse(shard):
        n, d = shard.x.shape
        return np.tile(np.arange(d, dtype=np.int32), (n, 1)), shard.x, d

    rsparse = dataclasses.replace(rdata, shards={
        k: RefSparse(*sparse(s)) for k, s in rdata.shards.items()})
    psparse = _as_port(rsparse)
    ref = ref_serving.GameScorer(
        rm, request_spec=ref_serving.request_spec_for_dataset(rm, rsparse),
        max_batch=16).warmup()
    spec = request_spec_for_dataset(pm, psparse)
    assert spec == {k: type(spec[k])(**dataclasses.asdict(v)) for k, v in
                    ref_serving.request_spec_for_dataset(rm, rsparse).items()}
    port = GameScorer(pm, device="cpu", request_spec=spec, max_batch=16).warmup()
    np.testing.assert_allclose(port.score_dataset(psparse),
                               np.asarray(ref.score_dataset(rsparse)),
                               rtol=0, atol=SCORE_TOL)
    for rreq, preq in zip(ref_serving.build_requests(rsparse, rm, [5, 16]),
                          build_requests(psparse, pm, [5, 16])):
        np.testing.assert_allclose(port.score_batch(preq),
                                   np.asarray(ref.score_batch(rreq)),
                                   rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("case", [(None, 64, 8), (None, 100, 8), (None, 5, 1),
                                  ((32, 8, 8, 64), 999, 8)])
def test_bucket_ladder_and_padded_cost_match_reference(case):
    buckets, max_batch, min_bucket = case
    ladder = bucket_ladder(buckets, max_batch, min_bucket)
    assert ladder == ref_serving.scorer.bucket_ladder(buckets, max_batch, min_bucket)
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 200, 1000):
        assert padded_cost(n, ladder) == ref_serving.scorer.padded_cost(n, ladder)


def test_warmup_captures_the_ladder_and_never_again():
    _, pm, _, pdata, _ = _pair(9)
    session = TelemetrySession("warm")
    scorer = GameScorer(pm, device="cpu",
                        request_spec=request_spec_for_dataset(pm, pdata),
                        max_batch=64, telemetry=session)
    assert scorer.compilations == 0
    scorer.warmup()
    assert scorer.buckets == (8, 16, 32, 64)
    assert scorer.compilations == len(scorer.buckets)
    assert _counter_total(session, "serving.compilations") == 4
    assert (scorer.bucket_for(1), scorer.bucket_for(9), scorer.bucket_for(64)) == (8, 16, 64)
    with pytest.raises(ValueError, match="exceeds max bucket"):
        scorer.bucket_for(65)
    with pytest.raises(RuntimeError, match="never recompile"):
        scorer._program(scorer.max_bucket * 4096)
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 65, size=50).tolist()
    sizes[0], sizes[-1] = 1, 64
    for req in build_requests(pdata, pm, sizes):
        scorer.score_batch(req)
    assert scorer.compilations == 4
    assert _counter_total(session, "serving.batches") == 50
    assert _counter_total(session, "serving.host_syncs") == 50
    hit = {m["labels"]["bucket"] for m in session.registry.snapshot()["counters"]
           if m["name"] == "serving.batches"}
    assert len(hit) >= 2
    # The dataset layout runs after warmup, counted once per size.
    scorer.score_dataset(pdata)
    scorer.score_dataset(pdata)
    assert scorer.compilations == 5


def test_cold_counts_match_reference_and_padding_is_not_cold(served):
    rm, pm, rdata, pdata, ref, port, rsession, psession = served
    x_fixed, x_rand = pdata.shards["global"].x[:3], pdata.shards["re0"].x[:3]
    unknown = np.array([10 ** 9, 10 ** 9 + 1, 10 ** 9 + 2])
    before = (_counter_total(rsession, "serving.cold_entities"),
              _counter_total(psession, "serving.cold_entities"))
    req = dict(features={"global": x_fixed, "re0": x_rand},
               entity_ids={"re0": unknown})
    got = port.score_batch(ScoringRequest(**req))
    want = np.asarray(ref.score_batch(ref_serving.ScoringRequest(**req)))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(
        got, x_fixed @ pm.coordinate("fixed").coefficients.means.numpy(),
        rtol=0, atol=SCORE_TOL)
    after = (_counter_total(rsession, "serving.cold_entities"),
             _counter_total(psession, "serving.cold_entities"))
    assert after[1] - before[1] == after[0] - before[0] == 3
    (known,) = build_requests(pdata, pm, [3])  # pads to the 8-bucket
    port.score_batch(known)
    assert _counter_total(psession, "serving.cold_entities") == after[1]


def test_request_validation_errors(served):
    _, pm, _, pdata, _, port, _, _ = served
    (req,) = build_requests(pdata, pm, [4])
    with pytest.raises(ValueError, match="missing shard"):
        port.score_batch(ScoringRequest(
            features={"global": req.features["global"]}, entity_ids=req.entity_ids))
    with pytest.raises(ValueError, match="missing id column"):
        port.score_batch(ScoringRequest(features=req.features, entity_ids={}))
    with pytest.raises(ValueError, match="want"):
        port.score_batch(ScoringRequest(
            features={"global": req.features["global"][:, :2],
                      "re0": req.features["re0"]},
            entity_ids=req.entity_ids))


def test_request_cuts_match_reference(served):
    rm, pm, rdata, pdata, _, _, _, _ = served
    sizes = [3, 50, 1, 200, 7]
    for a, b in zip(request_windows(pdata.num_examples, sizes, start=5),
                    ref_serving.request_windows(rdata.num_examples, sizes, start=5)):
        np.testing.assert_array_equal(a, b)
    for p, r in zip(build_requests(pdata, pm, sizes), ref_serving.build_requests(rdata, rm, sizes)):
        for k in r.features:
            np.testing.assert_array_equal(p.features[k], r.features[k])
        np.testing.assert_array_equal(p.entity_ids["re0"], r.entity_ids["re0"])
        np.testing.assert_array_equal(p.offset, r.offset)
    req = request_from_dataset(pdata, pm)
    merged = concat_requests([slice_request(req, 0, 10),
                              slice_request(req, 10, req.num_rows)])
    assert merged.num_rows == req.num_rows
    np.testing.assert_array_equal(merged.features["global"], req.features["global"])
    np.testing.assert_array_equal(merged.entity_ids["re0"], req.entity_ids["re0"])
    np.testing.assert_array_equal(merged.offset, req.offset)


# -- batcher -----------------------------------------------------------------

def test_batcher_coalesces_and_preserves_request_slices(served):
    _, pm, _, pdata, _, port, _, psession = served
    want = pm.score(pdata)
    sizes = [2] * 20
    before = _counter_total(psession, "serving.batches")
    with RequestBatcher(port, max_delay_s=0.05) as batcher:
        futures = [batcher.submit(r) for r in build_requests(pdata, pm, sizes)]
        results = [f.result(timeout=30) for f in futures]
    for rows, got in zip(request_windows(pdata.num_examples, sizes), results):
        np.testing.assert_allclose(got, want[rows], rtol=0, atol=SCORE_TOL)
    assert _counter_total(psession, "serving.batches") - before < len(sizes)


def test_batcher_closed_loop_and_latency_telemetry(served):
    _, pm, _, pdata, _, port, _, psession = served
    requests = build_requests(pdata, pm, [1, 5, 9, 30, 2, 7])
    with RequestBatcher(port, max_delay_s=0.001) as batcher:
        scores, latencies, _ = run_closed_loop(batcher, requests, clients=3)
    assert [len(s) for s in scores] == [1, 5, 9, 30, 2, 7]
    assert all(lat is not None and lat >= 0 for lat in latencies)
    hist = next(h for h in psession.registry.snapshot()["histograms"]
                if h["name"] == "serving.request_latency_s")
    assert hist["count"] >= len(requests) and hist["p99"] is not None


def test_batcher_surfaces_scorer_failure_and_respects_max_batch(served):
    _, pm, _, pdata, _, port, _, psession = served
    (good,) = build_requests(pdata, pm, [4])
    bad = ScoringRequest(features={"global": good.features["global"]},
                         entity_ids=good.entity_ids)
    with RequestBatcher(port, max_delay_s=0.001) as batcher:
        with pytest.raises(ValueError, match="missing shard"):
            batcher.submit(bad).result(timeout=30)
        assert batcher.submit(good).result(timeout=30).shape == (4,)
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(good)
    before = _counter_total(psession, "serving.batches")
    with RequestBatcher(port, max_batch=20, max_delay_s=0.2) as batcher:
        for f in [batcher.submit(r) for r in build_requests(pdata, pm, [10, 10, 10])]:
            f.result(timeout=30)
    assert _counter_total(psession, "serving.batches") - before >= 2


# -- model swap --------------------------------------------------------------

def _retrained(arrays, seed):
    means, keys, table = arrays
    rng = np.random.default_rng(seed)
    return ((means + rng.standard_normal(means.shape)).astype(np.float32), keys,
            rng.standard_normal(table.shape).astype(np.float32))


def test_swap_model_matches_reference_without_recapture():
    arrays, rdata, _ = _arrays(23)
    pdata = _as_port(rdata)
    new = _retrained(arrays, 29)
    session = TelemetrySession("swap")
    ref = ref_serving.GameScorer(
        _ref_model(*arrays), max_batch=32,
        request_spec=ref_serving.request_spec_for_dataset(_ref_model(*arrays), rdata)).warmup()
    pm = _port_model(*arrays)
    port = GameScorer(pm, device="cpu", max_batch=32, telemetry=session,
                      request_spec=request_spec_for_dataset(pm, pdata)).warmup()
    captured = port.compilations
    ref.swap_model(_ref_model(*new))
    port.swap_model(_port_model(*new))
    rreq = ref_serving.build_requests(rdata, ref.model, [16])[0]
    preq = build_requests(pdata, port.model, [16])[0]
    np.testing.assert_allclose(port.score_batch(preq), np.asarray(ref.score_batch(rreq)),
                               rtol=0, atol=SCORE_TOL)
    assert port.compilations == captured
    assert _counter_total(session, "serving.swaps") == 1


def test_swap_model_mid_closed_loop_no_dropped_requests():
    arrays, rdata, _ = _arrays(31)
    pdata = _as_port(rdata)
    old, new = _port_model(*arrays), _port_model(*_retrained(arrays, 37))
    scorer = GameScorer(old, device="cpu", max_batch=32,
                        request_spec=request_spec_for_dataset(old, pdata)).warmup()
    want_old, want_new = old.score(pdata), new.score(pdata)
    sizes = [8] * 40
    windows = request_windows(pdata.num_examples, sizes)
    with RequestBatcher(scorer, max_batch=32, max_delay_s=0.001) as batcher:
        futures = []
        for i, req in enumerate(build_requests(pdata, old, sizes)):
            if i == 20:
                scorer.swap_model(new)
            futures.append(batcher.submit(req))
        results = [f.result(timeout=30) for f in futures]
    for rows, got in zip(windows, results):
        assert (np.allclose(got, want_old[rows], rtol=0, atol=SCORE_TOL)
                or np.allclose(got, want_new[rows], rtol=0, atol=SCORE_TOL))
    np.testing.assert_allclose(results[-1], want_new[windows[-1]], rtol=0, atol=SCORE_TOL)


def test_swap_model_grown_vocabulary_within_capacity():
    arrays, rdata, _ = _arrays(41)
    pdata = _as_port(rdata)
    means, keys, table = arrays
    session = TelemetrySession("grow")
    pm = _port_model(*arrays)
    scorer = GameScorer(pm, device="cpu", max_batch=16, telemetry=session,
                        request_spec=request_spec_for_dataset(pm, pdata)).warmup()
    captured = scorer.compilations
    new_row = np.arange(1, table.shape[1] + 1, dtype=np.float32)
    grown_keys = np.concatenate([keys, np.asarray([10_000], keys.dtype)])
    grown = _port_model(means, grown_keys, np.concatenate([table, new_row[None]]))
    assert len(grown_keys) + 1 <= pm.coordinate("per_entity").serving_capacity
    scorer.swap_model(grown)
    x_fixed, x_rand = pdata.shards["global"].x[:2], pdata.shards["re0"].x[:2]
    before = _counter_total(session, "serving.cold_entities")
    got = scorer.score_batch(ScoringRequest(
        features={"global": x_fixed, "re0": x_rand},
        entity_ids={"re0": np.asarray([10_000, 999_999], keys.dtype)}))
    np.testing.assert_allclose(
        got, x_fixed @ means + np.array([x_rand[0] @ new_row, 0.0]),
        rtol=0, atol=1e-4)
    assert _counter_total(session, "serving.cold_entities") == before + 1
    assert scorer.compilations == captured


def test_swap_model_rejects_layout_changes():
    arrays, rdata, _ = _arrays(41)
    pdata = _as_port(rdata)
    means, keys, table = arrays
    pm = _port_model(*arrays)
    scorer = GameScorer(pm, device="cpu", max_batch=16,
                        request_spec=request_spec_for_dataset(pm, pdata)).warmup()
    capacity = pm.coordinate("per_entity").serving_capacity
    extra = np.arange(20_000, 20_000 + capacity, dtype=keys.dtype)
    bigger = _port_model(means, np.concatenate([keys, extra]),
                         np.zeros((len(keys) + capacity, table.shape[1]), np.float32))
    with pytest.raises(ValueError, match="layout-shape change"):
        scorer.swap_model(bigger)
    wider = _port_model(means, keys, np.zeros((len(keys), table.shape[1] + 1), np.float32))
    with pytest.raises(ValueError, match="swap_model"):
        scorer.swap_model(wider)
    from photon_tpu_torch.game.model import GameModel

    with pytest.raises(ValueError, match="swap_model"):
        scorer.swap_model(GameModel(coordinates={"fixed": pm.coordinate("fixed")},
                                    task_type=pm.task_type))
    # The refused swaps left the served model in place.
    np.testing.assert_allclose(scorer.score_dataset(pdata), pm.score(pdata),
                               rtol=0, atol=SCORE_TOL)


def test_scorer_defaults_to_cuda_and_raises_without_a_card(served, monkeypatch):
    _, pm, _, _, _, _, _, _ = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GameScorer(pm)


# -- drivers -----------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from photon_tpu.game.model_io import save_game_model

    arrays, _, maps = _arrays(17)
    root = tmp_path_factory.mktemp("serve_model")
    save_game_model(str(root / "model"), _ref_model(*arrays), maps)
    return root, arrays


def test_score_game_matches_reference_driver(model_dir, monkeypatch):
    from photon_tpu.drivers import score_game as ref_score_game
    from photon_tpu_torch.drivers import score_game

    root, _ = model_dir
    args = ["--input", "synthetic-game:40:4:6:4:1:17", "--model", str(root / "model"),
            "--evaluators", "AUC,LOGISTIC_LOSS", "--backend", "cpu"]
    monkeypatch.delenv("PHOTON_BATCH_SCORER", raising=False)
    ref_out = ref_score_game.run(ref_score_game.build_parser().parse_args(
        args + ["--output-dir", str(root / "ref"), "--no-telemetry"]))
    out = score_game.run(score_game.build_parser().parse_args(
        args + ["--output-dir", str(root / "port")]))
    scores = np.loadtxt(str(root / "port" / "scores.txt"))
    np.testing.assert_allclose(scores, np.loadtxt(str(root / "ref" / "scores.txt")),
                               rtol=0, atol=SCORE_TOL)
    assert set(out["metrics"]) == set(ref_out["metrics"]) == {"AUC", "LOGISTIC_LOSS"}
    for name, value in ref_out["metrics"].items():
        assert abs(out["metrics"][name] - value) <= METRIC_TOL, name
    with open(root / "port" / "telemetry" / "run_report.json") as f:
        report = json.load(f)
    assert report["status"] == "success"
    assert "torch" in report["environment"]
    # The host oracle path.
    monkeypatch.setenv("PHOTON_BATCH_SCORER", "host")
    score_game.run(score_game.build_parser().parse_args(
        args + ["--output-dir", str(root / "host"), "--predict-mean"]))
    host = np.loadtxt(str(root / "host" / "scores.txt"))
    np.testing.assert_allclose(host, 1.0 / (1.0 + np.exp(-scores)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("flag,error,match", [
    # --stream streams Avro part files; a synthetic input is refused.
    (["--stream"], ValueError, "Avro part-file input"),
    (["--evaluators", "SHARDED_AUC:re0"], NotImplementedError, "queue 1, item 4"),
], ids=["flag0", "flag1"])
def test_score_game_not_ported_flags_raise(model_dir, tmp_path, flag, error, match):
    from photon_tpu_torch.drivers import score_game

    root, _ = model_dir
    with pytest.raises(error, match=match):
        score_game.run(score_game.build_parser().parse_args([
            "--input", "synthetic-game:40:4:6:4:1:17", "--model", str(root / "model"),
            "--backend", "cpu", "--output-dir", str(tmp_path), *flag]))


def test_serve_game_geometric_matches_host_oracle(model_dir, tmp_path):
    from photon_tpu_torch.drivers import serve_game
    from photon_tpu_torch.telemetry.report import render_markdown

    root, arrays = model_dir
    out = tmp_path / "served"
    summary = serve_game.run(serve_game.build_parser().parse_args([
        "--backend", "cpu", "--model", str(root / "model"),
        "--input", "synthetic-game:40:4:6:4:1:17", "--requests", "25",
        "--clients", "3", "--traffic", "geometric", "--replicas", "2",
        "--max-batch", "32", "--max-delay-ms", "1", "--output-dir", str(out),
    ]))
    assert summary["requests"] == summary["served"] == 25 and summary["shed"] == 0
    assert summary["latency_p99_ms"] >= summary["latency_p50_ms"] > 0
    scores = np.loadtxt(str(out / "scores.txt"))
    assert len(scores) == summary["rows"]
    pm = _port_model(*arrays)
    _, rdata, _ = _arrays(17)
    pdata = _as_port(rdata)
    sizes = serve_game.request_sizes(25, 8.0, 32, seed=0)
    want = np.concatenate([host_score_request(pm, r)
                           for r in build_requests(pdata, pm, sizes)])
    np.testing.assert_allclose(scores, want, rtol=0, atol=1e-4)
    with open(out / "serving_summary.json") as f:
        assert set(json.load(f)) == set(summary)
    with open(out / "telemetry" / "run_report.json") as f:
        md = render_markdown(json.load(f))
    assert "## Online serving" in md
    assert "serving.host_syncs per batch | 1 |" in md


@pytest.mark.parametrize("flags", [
    ["--transport", "tcp", "--supervise"],
    ["--replica-backend", "subprocess"],
    ["--transport", "tcp", "--replica-backend", "subprocess", "--supervise",
     "--probe-interval-ms", "100"],
])
def test_serve_game_fleet_flags_match_host_oracle(model_dir, tmp_path, flags):
    """serve_game over the socket ingest, on subprocess replicas, under the
    supervisor (the reference's ``test_fleet.py:793-830``): every request
    served once, the scores the host oracle's, the summary's fleet fields
    and each child's record."""
    from photon_tpu_torch.drivers import serve_game
    from photon_tpu_torch.drivers.train_game import _load_game_data
    from photon_tpu_torch.serving import generate_traffic
    from photon_tpu_torch.telemetry.report import render_markdown

    root, arrays = model_dir
    out = tmp_path / "served"
    args = serve_game.build_parser().parse_args([
        "--model", str(root / "model"), "--input", "synthetic-game:40:4:6:4:1:17",
        "--requests", "30", "--clients", "3", "--replicas", "2", "--traffic", "powerlaw",
        "--storm-frac", "0.1", "--max-batch", "32", "--max-delay-ms", "1",
        "--backend", "cpu", "--output-dir", str(out), *flags])
    summary = serve_game.run(args)
    assert summary["requests"] == summary["served"] == 30 and summary["shed"] == 0
    assert summary["transport"] == args.transport
    assert summary["replica_backend"] == args.replica_backend
    assert summary["supervised"] is args.supervise
    assert summary["replica_deaths"] == summary["resurrections"] == 0
    assert summary["cold_entities"] > 0  # the storm rode the zero row
    pm = _port_model(*arrays)
    data, _ = _load_game_data(args.input, args)
    items = generate_traffic(data, pm, serve_game.traffic_spec(args)).items
    want = np.concatenate([host_score_request(pm, item.request) for item in items])
    np.testing.assert_allclose(np.loadtxt(str(out / "scores.txt")), want, rtol=0, atol=1e-4)
    children = summary["children"]
    if args.replica_backend == "thread":
        assert children == []
    else:
        assert [c["replica"] for c in children] == ["r0", "r1"]
        for c in children:
            assert c["device"] == "cpu" and c["host_syncs"] == c["batches"] > 0
            assert c["captures"] == c["captures_at_warmup"]
    with open(out / "telemetry" / "run_report.json") as f:
        report = json.load(f)
    names = {m["name"] for m in report["metrics"]["counters"]}
    assert "serving.admitted" in names
    assert ("serving.transport_connections" in names) == (args.transport == "tcp")
    md = render_markdown(report)
    assert "## Serving fleet" in md and "## Online serving" in md


@pytest.mark.parametrize("flag", [["--models", "2"], ["--splits", "m0=1"],
                                  ["--tenant-queue-rows", "4"]])
def test_serve_game_not_ported_flags_raise(model_dir, tmp_path, flag):
    from photon_tpu_torch.drivers import serve_game

    root, _ = model_dir
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        serve_game.run(serve_game.build_parser().parse_args([
            "--model", str(root / "model"), "--input", "synthetic-game:40:4:6:4:1:17",
            "--backend", "cpu", "--output-dir", str(tmp_path), *flag]))
