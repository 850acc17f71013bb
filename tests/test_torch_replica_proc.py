"""Subprocess replicas against the JAX package, on the CPU.

Mirrors ``tests/test_supervisor.py``'s artifact and subprocess cases
(:174, :598-720): the shared model artifact is the same bytes in both
packages and loads in the other bit for bit; a two-child fleet scores
within 1e-5 of the JAX package's host oracle and hot-swaps over the wire;
the child's ``stats`` frame merges into the parent's report; a SIGKILLed
child's requests reroute exactly once and the supervisor respawns it; a
child configured for ``cuda`` on a machine with no card fails its spawn
with ``ReplicaSpawnError`` and nothing falls back to the CPU; the child's
boot imports no JAX and nothing of the JAX package.  The children run
with ``device="cpu"``; one fleet serves the file (``rig``).
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from photon_tpu import serving as ref_serving
from photon_tpu.data.synthetic import make_game_dataset as ref_dataset
from photon_tpu.game import model as ref_model
from photon_tpu.models.glm import Coefficients as RefCoefficients
from photon_tpu.models.glm import model_for_task as ref_model_for_task
from photon_tpu.serving import replica_proc as ref_replica_proc
from photon_tpu_torch.game.data import DenseShard, GameDataset
from photon_tpu_torch.game.model import game_model_from_numpy
from photon_tpu_torch.serving import (
    ReplicaSpawnError,
    ServingFleet,
    SupervisorPolicy,
    build_requests,
    request_spec_for_dataset,
)
from photon_tpu_torch.serving import replica_proc
from photon_tpu_torch.telemetry import TelemetrySession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-5


def _arrays(seed, n_entities=40, fixed_dim=6, random_dim=4):
    data, _ = ref_dataset(n_entities, 4, fixed_dim, random_dim, seed=seed)
    rng = np.random.default_rng(seed)
    keys = np.unique(data.id_columns["re0"])
    means = rng.standard_normal(fixed_dim).astype(np.float32)
    table = rng.standard_normal((len(keys), random_dim)).astype(np.float32)
    return (means, keys, table), data


def _port_model(means, keys, table):
    return game_model_from_numpy("logistic_regression", {
        "fixed": {"type": "fixed", "shard_name": "global", "means": means},
        "per_entity": {"type": "random", "shard_name": "re0",
                       "entity_column": "re0", "keys": keys, "table": table},
    }, device="cpu")


def _ref_model(means, keys, table):
    task = "logistic_regression"
    return ref_model.GameModel(coordinates={
        "fixed": ref_model.FixedEffectModel(
            ref_model_for_task(task, RefCoefficients(means)), "global"),
        "per_entity": ref_model.RandomEffectModel(
            table=table, keys=keys, entity_column="re0", shard_name="re0",
            task_type=task),
    }, task_type=task)


def _as_port(data) -> GameDataset:
    return GameDataset(label=data.label, offset=data.offset, weight=data.weight,
                       shards={n: DenseShard(s.x) for n, s in data.shards.items()},
                       id_columns=dict(data.id_columns))


def _retrained(arrays, seed):
    means, keys, table = arrays
    rng = np.random.default_rng(seed)
    return ((means + rng.standard_normal(means.shape)).astype(np.float32), keys,
            rng.standard_normal(table.shape).astype(np.float32))


def _counter_total(session, name, **labels):
    return sum(m["value"] for m in session.registry.snapshot()["counters"]
               if m["name"] == name
               and all(str(m["labels"].get(k)) == str(v) for k, v in labels.items()))


@pytest.fixture(scope="module")
def rig():
    """One two-child fleet for the file (a child's start is the costly
    part)."""
    import types

    arrays, rdata = _arrays(41)
    model, data = _port_model(*arrays), _as_port(rdata)
    session = TelemetrySession("replica-proc-rig")
    fleet = ServingFleet(model, replicas=2, backend="subprocess", device="cpu",
                         request_spec=request_spec_for_dataset(model, data),
                         max_batch=16, max_delay_s=0.001, telemetry=session).warmup()
    yield types.SimpleNamespace(arrays=arrays, rdata=rdata, model=model, data=data,
                                session=session, fleet=fleet)
    fleet.close()


# -- the model artifact --------------------------------------------------------

@pytest.mark.parametrize("keys", ["int", "str"])
def test_artifact_same_bytes_and_round_trips_both_ways(tmp_path, keys):
    means, ids, table = _arrays(5)[0]
    if keys == "str":
        ids = np.sort(np.asarray([f"user-{k}" for k in ids]))
    ours, theirs = _port_model(means, ids, table), _ref_model(means, ids, table)
    assert replica_proc.pack_model(ours, 7) == ref_replica_proc.pack_model(theirs, 7)
    for save, load, model, device in (
            (replica_proc.save_model_artifact, ref_replica_proc.load_model_artifact,
             ours, {}),
            (ref_replica_proc.save_model_artifact, replica_proc.load_model_artifact,
             theirs, {"device": "cpu"})):
        path = str(tmp_path / f"model-{save.__module__}.bin")
        save(path, model, version=7)
        got, version = load(path, **device)
        assert version == 7 and got.task_type == "logistic_regression"
        assert list(got.coordinates) == ["fixed", "per_entity"]
        np.testing.assert_array_equal(
            np.asarray(got.coordinates["fixed"].coefficients.means), means)
        np.testing.assert_array_equal(np.asarray(got.coordinates["per_entity"].table),
                                      table)
        np.testing.assert_array_equal(got.coordinates["per_entity"].keys, ids)
        assert got.coordinates["per_entity"].keys.dtype == ids.dtype
        assert got.coordinates["per_entity"].task_type == "logistic_regression"


def test_model_store_caches_by_identity_and_evicts(tmp_path):
    arrays, _ = _arrays(6)
    store = replica_proc.ModelStore(str(tmp_path / "store"))
    models = [_port_model(*arrays) for _ in range(3)]
    first = store.publish(models[0])
    assert store.publish(models[0]) == first == (str(tmp_path / "store" / "model-v000000.bin"), 0)
    paths = [store.publish(m)[0] for m in models[1:]]
    assert not os.path.exists(first[0]) and all(os.path.exists(p) for p in paths)
    assert store.publish(models[0])[1] == 3  # evicted: written again, new version


# -- the subprocess fleet ----------------------------------------------------------

def test_subprocess_fleet_matches_jax_oracle_and_swaps_over_the_wire(rig):
    fleet, session = rig.fleet, rig.session
    rmodel = _ref_model(*rig.arrays)
    sizes = [1, 5, 16, 4, 20]
    requests = build_requests(rig.data, rig.model, sizes)
    for req, rreq in zip(requests, ref_serving.build_requests(rig.rdata, rmodel, sizes)):
        np.testing.assert_allclose(fleet.score(req),
                                   ref_serving.host_score_request(rmodel, rreq),
                                   rtol=0, atol=SCORE_TOL)
    pong = fleet.replicas[0].ping(10.0)
    assert pong["kind"] == "pong" and pong["compilations"] == 2
    for replica in fleet.replicas:
        report = replica.child_report()
        assert report["device"] == "cpu" and report["captures_at_warmup"] == 2
        assert report["spawn_s"] > 0
    # A canary rollout over the wire: each child swaps from the shared
    # artifact into its captured tables; nothing captures.
    new_arrays = _retrained(rig.arrays, 43)
    new = _port_model(*new_arrays)
    compiled = fleet.compilations
    fleet.rollout(new, probe_requests=requests[:2])
    assert fleet.compilations == compiled
    rnew = _ref_model(*new_arrays)
    for req, rreq in zip(requests, ref_serving.build_requests(rig.rdata, rnew, sizes)):
        np.testing.assert_allclose(fleet.score(req),
                                   ref_serving.host_score_request(rnew, rreq),
                                   rtol=0, atol=SCORE_TOL)
    assert {r.scorer.version for r in fleet.replicas} == {1}
    fleet.rollout(rig.model, probe_requests=requests[:2])


def test_child_stats_frame_merges_into_parent_report(rig):
    from photon_tpu_torch.telemetry.report import render_markdown

    fleet, session = rig.fleet, rig.session
    r0 = fleet.replicas[0]
    r0.pull_stats()
    syncs0 = _counter_total(session, "serving.host_syncs", replica="r0")
    requests = build_requests(rig.data, rig.model, [4, 9, 2])
    for req in requests:
        r0.submit(req).result(timeout=30)
    merged = r0.pull_stats()
    assert merged  # counters crossed the wire
    assert r0.pull_stats() == {}  # delta merge: nothing new, nothing added
    syncs = _counter_total(session, "serving.host_syncs", replica="r0")
    batches = _counter_total(session, "serving.batches", replica="r0")
    assert syncs - syncs0 == len(requests)  # one host sync a batch
    assert syncs == batches
    stats = r0.scorer.last_stats
    assert stats["device"] == "cpu" and stats["captures"] == 2
    assert stats["segments"] == stats["memory_reserved"] == 0  # no card here
    # The child counts its own kernel launches: every wrapper, none launched.
    from photon_tpu_torch.ops import launch_counts

    report = r0.child_report()
    assert set(stats["kernel_launches"]) == set(launch_counts()) != set()
    assert report["kernel_launches"] == stats["kernel_launches"]
    assert not any(report["kernel_launches"].values())
    assert not any(report["kernel_launches_at_warmup"].values())
    text = render_markdown(session.build_report())
    assert "child scorers" in text and "r0: host_syncs=" in text


def test_killed_child_reroutes_exactly_once_and_respawns(rig):
    from photon_tpu_torch.serving import host_score_request

    fleet, session = rig.fleet, rig.session
    sup = fleet.supervise(SupervisorPolicy(probe_interval_s=0.05, probe_deadline_s=30.0,
                                           respawn_base_s=0.0, respawn_jitter=0.0),
                          start=False)
    r0 = fleet.replicas[0]
    pid = r0.child_pid
    requests = build_requests(rig.data, rig.model, [4, 5, 16, 4, 4, 4] * 3)
    os.kill(pid, signal.SIGKILL)
    time.sleep(0.2)
    results = [f.result(timeout=60) for f in [fleet.submit(r) for r in requests]]
    for req, got in zip(requests, results):  # every future its own scores
        np.testing.assert_allclose(got, host_score_request(rig.model, req),
                                   rtol=0, atol=SCORE_TOL)
    for _ in range(60):
        sup.check_once()
        if r0.alive:
            break
        time.sleep(0.2)
    assert r0.alive and r0.poll_exit() is None and r0.child_pid != pid
    assert [c["pid"] for c in r0.retired_children] == [pid]  # the dead child's report
    np.testing.assert_allclose(r0.submit(requests[1]).result(timeout=30),
                               host_score_request(rig.model, requests[1]),
                               rtol=0, atol=SCORE_TOL)
    assert _counter_total(session, "serving.replica_deaths", replica="r0", cause="crash") == 1
    assert _counter_total(session, "serving.replica_resurrections", replica="r0") == 1
    # The parent-death watchdog: a child whose stdin closes exits.
    r1 = fleet.replicas[1]
    r1._proc.stdin.close()
    r1._proc.wait(timeout=30)
    assert r1.poll_exit() == 0


# -- no fallback, no JAX -------------------------------------------------------

def test_cuda_child_without_a_card_fails_its_spawn(tmp_path):
    """A child told ``cuda`` on a machine with no card fails its start; the
    fleet raises ReplicaSpawnError naming the child's log, reaps what it
    spawned, and never builds a CPU replica in its place."""
    arrays, rdata = _arrays(7)
    model, data = _port_model(*arrays), _as_port(rdata)
    workdir = str(tmp_path / "fleet")
    with pytest.raises(ReplicaSpawnError, match="during startup") as e:
        ServingFleet(model, replicas=2, backend="subprocess", device="cuda",
                     workdir=workdir, request_spec=request_spec_for_dataset(model, data),
                     max_batch=16)
    assert os.path.join(workdir, "r0.log") in str(e.value)
    for rid in ("r0", "r1"):  # both children started side by side, both failed
        with open(os.path.join(workdir, f"{rid}.log")) as f:
            assert "CUDA" in f.read()
    assert replica_proc.child_device_env(0, 2, "cuda") == {"CUDA_VISIBLE_DEVICES": ""}
    assert replica_proc.child_device_env(1, 2, "cpu") == {"CUDA_VISIBLE_DEVICES": ""}


def test_child_device_deal_follows_the_parent_mask(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    deal = [replica_proc.child_device_env(i, 2, "cuda")["CUDA_VISIBLE_DEVICES"]
            for i in range(2)]
    assert deal == ["2", "3"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5")  # one card: every child shares it
    assert {replica_proc.child_device_env(i, 3, "cuda")["CUDA_VISIBLE_DEVICES"]
            for i in range(3)} == {"5"}


def test_child_boot_imports_no_jax(tmp_path):
    """The child entry point, booted to the point where it serves, has
    imported nothing of JAX or the JAX package."""
    arrays, rdata = _arrays(8)
    model, data = _port_model(*arrays), _as_port(rdata)
    artifact = str(tmp_path / "model.bin")
    replica_proc.save_model_artifact(artifact, model, 0)
    spec = request_spec_for_dataset(model, data)
    config = {"replica_id": "r0", "device": "cpu", "max_batch": 16, "min_bucket": 8,
              "spec": {k: {"kind": s.kind, "dim": s.dim, "nnz": s.nnz}
                       for k, s in spec.items()}}
    code = (
        "import os, runpy, socketserver, sys\n"
        "def served(self, *a, **k):\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                 ('jax', 'jaxlib', 'photon_tpu', 'ml_dtypes'))\n"
        "    print('BAD', bad, flush=True)\n"
        "    os._exit(3 if bad else 0)\n"
        "socketserver.BaseServer.serve_forever = served\n"
        f"sys.argv = ['replica_proc', '--artifact', {artifact!r}, '--ready-file',\n"
        f"            {str(tmp_path / 'ready.json')!r}, '--config', {json.dumps(config)!r}]\n"
        "runpy.run_module('photon_tpu_torch.serving.replica_proc', run_name='__main__')\n"
    )
    # stdin stays open: the child's parent-death watchdog exits on its EOF.
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        code = proc.wait(timeout=120)
        stdout, stderr = proc.stdout.read(), proc.stderr.read()
    finally:
        proc.kill()
        proc.stdin.close()
    assert code == 0, stdout + stderr
    assert "BAD []" in stdout
    with open(tmp_path / "ready.json") as f:
        ready = json.load(f)
    assert ready["device"] == "cpu" and ready["compilations"] == 2
