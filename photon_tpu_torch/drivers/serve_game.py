"""Online GAME scoring driver: a replica fleet serving seeded traffic.

Counterpart of ``photon_tpu/drivers/serve_game.py``: load a saved GAME
model ONCE, build ``--replicas`` scorer replicas (each with its own tables
on the device, its own CUDA stream and one captured graph per bucket)
behind the deadline-aware fleet router, capture every replica's bucket
ladder, then drive a seeded traffic stream through the fleet with
closed-loop clients.  ``--traffic powerlaw`` (default) draws requests from
the traffic generator (power-law entity popularity, an optional cold-start
storm); ``--traffic geometric`` cuts consecutive row windows of geometric
sizes.  ``--deadline-ms`` arms admission control (a request whose
queue-wait projection blows the budget is shed and counted, never queued).
``--transport tcp`` serves over the loopback socket ingest (each client a
``ScoringClient`` connection) instead of submitting in-process;
``--replica-backend subprocess`` runs each replica as a child process
with its own CUDA context; ``--supervise`` attaches the self-healing
supervisor (health probes every ``--probe-interval-ms``, resurrection,
quarantine).

Scores land in ``<output-dir>/scores.txt`` in request order (admitted
requests only), ``serving_summary.json`` beside them, and the run report
carries the ``serving.*`` block:

    python -m photon_tpu_torch.drivers.serve_game \\
        --model out/best_model --input test.avro \\
        --feature-bags global=global,per_user=per_user --id-columns userId \\
        --requests 500 --clients 8 --replicas 2 --deadline-ms 25 \\
        --transport tcp --replica-backend subprocess --supervise \\
        --max-batch 128 --max-delay-ms 2 --output-dir served

``--backend gpu`` (the default) runs on the card and fails without one.
``--models`` > 1, ``--splits`` and ``--tenant-queue-rows`` wait for the
multi-model arena in ROADMAP.md queue 1, item 7.5.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from photon_tpu_torch.drivers import common
from photon_tpu_torch.drivers.score_game import publish_text
from photon_tpu_torch.drivers.train_game import _load_game_data


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "photon_tpu_torch.drivers.serve_game", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_common_args(p)
    common.add_telemetry_arg(p)
    p.add_argument("--model", required=True, help="GAME model directory")
    p.add_argument("--input", required=True,
                   help="request feature source: Avro file/dir or "
                   "synthetic-game spec (see train_game); requests are row "
                   "sets cut from it")
    p.add_argument("--feature-bags", default=None)
    p.add_argument("--id-columns", default=None)
    p.add_argument("--requests", type=int, default=256,
                   help="number of requests to serve")
    p.add_argument("--request-rows-mean", type=float, default=8.0,
                   help="mean rows per request (geometric long tail, "
                   "clipped to [1, --max-batch])")
    p.add_argument("--clients", type=int, default=4,
                   help="closed-loop client threads")
    p.add_argument("--replicas", type=int, default=1,
                   help="scorer replicas behind the fleet router")
    p.add_argument("--traffic", choices=("powerlaw", "geometric"),
                   default="powerlaw",
                   help="request stream: power-law entity popularity "
                   "(default), or seeded geometric row windows")
    p.add_argument("--popularity-alpha", type=float, default=1.1,
                   help="power-law popularity exponent (powerlaw traffic)")
    p.add_argument("--storm-frac", type=float, default=0.0,
                   help="fraction of requests in a cold-start storm "
                   "segment (unknown entities; powerlaw traffic)")
    p.add_argument("--transport", choices=("inproc", "tcp"),
                   default="inproc",
                   help="inproc: submit straight to the router; tcp: "
                   "serve over the loopback socket ingest")
    p.add_argument("--replica-backend", choices=("thread", "subprocess"),
                   default="thread",
                   help="replica runtime: threads in this process, or one "
                   "child process per replica (its own CUDA context, frame "
                   "protocol over loopback)")
    p.add_argument("--supervise", action="store_true",
                   help="attach the self-healing supervisor: health probes "
                   "(exit code, heartbeat, ping, known-answer score vs the "
                   "host oracle), backed-off resurrection with a "
                   "canary-gated rejoin, flap quarantine")
    p.add_argument("--probe-interval-ms", type=float, default=500.0,
                   help="supervisor health-probe interval")
    p.add_argument("--deadline-ms", type=float, default=0.0,
                   help="per-request deadline budget; 0 disables "
                   "admission shedding")
    p.add_argument("--max-batch", type=int, default=128,
                   help="bucket-ladder cap / batcher coalescing cap (rows)")
    p.add_argument("--max-delay-ms", type=float, default=2.0,
                   help="batcher window: max time the first queued request "
                   "waits for coalescing partners")
    p.add_argument("--seed", type=int, default=0,
                   help="traffic stream seed")
    p.add_argument("--table-dtype", choices=("f32", "bf16", "int8"),
                   default="f32",
                   help="storage dtype of the serving tables: bf16 halves "
                   "table bytes, int8 quarters them (per-row absmax "
                   "scale); every accumulation stays f32")
    p.add_argument("--models", type=int, default=1,
                   help="tenant models hosted per replica; more than 1 is "
                   "not ported (ROADMAP.md queue 1, item 7.5)")
    p.add_argument("--splits", default=None,
                   help="not ported: traffic split spec 'm0=0.7,m1=0.3' "
                   "(ROADMAP.md queue 1, item 7.5)")
    p.add_argument("--tenant-queue-rows", type=int, default=0,
                   help="not ported: per-tenant admission budget "
                   "(ROADMAP.md queue 1, item 7.5)")
    return p


def request_sizes(n_requests: int, mean: float, cap: int,
                  seed: int) -> np.ndarray:
    """Seeded long-tailed request-size stream (geometric, clipped to
    [1, cap]) — the draw ``--traffic geometric`` and the traffic generator
    share."""
    from photon_tpu_torch.serving.traffic import geometric_sizes

    return geometric_sizes(n_requests, mean, cap, np.random.default_rng(seed))


def traffic_spec(args):
    """The request stream the arguments ask for (the one definition a
    caller that checks the served scores regenerates the stream from)."""
    from photon_tpu_torch.serving.traffic import TrafficSpec

    return TrafficSpec(
        requests=args.requests,
        mean_rows=args.request_rows_mean,
        max_rows=args.max_batch,
        popularity=args.traffic,
        alpha=args.popularity_alpha,
        storm_frac=args.storm_frac if args.traffic == "powerlaw" else 0.0,
        deadline_ms=args.deadline_ms if args.deadline_ms > 0 else None,
        seed=args.seed,
    )


def _reject_not_ported(args) -> None:
    flags = (
        ("--models > 1", args.models > 1),
        ("--splits", args.splits is not None),
        ("--tenant-queue-rows", args.tenant_queue_rows > 0),
    )
    for flag, given in flags:
        if given:
            raise NotImplementedError(
                f"serve_game {flag} is not ported yet; it waits in "
                "ROADMAP.md queue 1, item 7.5"
            )


def run(args: argparse.Namespace) -> dict:
    _reject_not_ported(args)
    device = common.device_for_backend(args.backend)
    logger = common.RunLogger("photon_tpu_torch.serve_game", args.log_file)
    os.makedirs(args.output_dir, exist_ok=True)
    with common.telemetry_run(args, "serve_game", logger) as session:
        return _run(args, device, logger, session)


def _run(args, device, logger, session) -> dict:
    from photon_tpu_torch.fault.retry import retry_call
    from photon_tpu_torch.game.model_io import load_game_model
    from photon_tpu_torch.serving import (
        AdmissionPolicy,
        ScoringClient,
        ServingFleet,
        SupervisorPolicy,
        generate_traffic,
        request_spec_for_dataset,
        run_closed_loop_outcomes,
    )

    with logger.timed("load-model"):
        model, index_maps = retry_call(
            lambda: load_game_model(args.model, device=device),
            site="model:load", telemetry=session, logger=logger,
        )
        logger.info("model: %s, coordinates %s on %s", model.task_type,
                    list(model.coordinates), device)
    with logger.timed("load-data"):
        data, _ = _load_game_data(args.input, args, index_maps=index_maps)
        logger.info("request source: %d rows", data.num_examples)

    deadline_s = args.deadline_ms / 1000.0 if args.deadline_ms > 0 else None
    with logger.timed("build-fleet"):
        fleet = ServingFleet(
            model,
            replicas=args.replicas,
            device=device,
            backend=args.replica_backend,
            request_spec=request_spec_for_dataset(model, data),
            max_batch=args.max_batch,
            max_delay_s=args.max_delay_ms / 1000.0,
            telemetry=session,
            admission=AdmissionPolicy(default_deadline_s=deadline_s),
            table_dtype=args.table_dtype,
        ).warmup()
        if args.supervise:
            fleet.supervise(
                SupervisorPolicy(
                    probe_interval_s=args.probe_interval_ms / 1000.0
                ),
                logger=logger,
            )
        logger.info("fleet warm: %d %s replicas, %d programs captured%s",
                    args.replicas, args.replica_backend, fleet.compilations,
                    ", supervised" if args.supervise else "")

    traffic = generate_traffic(data, model, traffic_spec(args))

    server = fleet.serve() if args.transport == "tcp" else None
    clients: list = []

    def factory(tid: int):
        if server is None:
            return lambda item: fleet.score(item.request,
                                            deadline_s=item.deadline_s)
        client = ScoringClient(server.address, telemetry=session)
        clients.append(client)
        return lambda item: client.score(item.request,
                                         deadline_s=item.deadline_s)

    try:
        with logger.timed("serve"):
            outcomes, wall = run_closed_loop_outcomes(
                factory, traffic.items, clients=args.clients
            )
    finally:
        for client in clients:
            client.close()
        fleet.close()

    ok = [o for o in outcomes if o.status == "ok"]
    shed = [o for o in outcomes if o.status == "shed"]
    errors = [o for o in outcomes if o.status == "error"]
    if errors:
        raise RuntimeError(
            f"{len(errors)} request(s) failed; first: {errors[0].reason}"
        )

    rows = int(sum(o.item.request.num_rows for o in ok))
    qps = len(ok) / wall if wall > 0 else 0.0
    lat_ms = np.sort(np.asarray(
        [o.latency_s for o in ok], np.float64
    )) * 1e3 if ok else np.zeros(1)
    p50 = float(np.percentile(lat_ms, 50))
    p99 = float(np.percentile(lat_ms, 99))
    session.gauge("serving.qps").set(qps)
    session.gauge("serving.rows_per_second").set(rows / wall if wall else 0.0)

    publish_text(
        args.output_dir, "scores.txt",
        lambda f: np.savetxt(
            f,
            np.concatenate([o.scores for o in ok])
            if ok else np.zeros(0, np.float32),
            fmt="%.8g",
        ),
        session, logger, site="serve:write",
    )

    def _counter(name):
        return sum(
            m["value"]
            for m in session.registry.snapshot().get("counters", [])
            if m["name"] == name
        ) if session.enabled else 0

    summary = {
        "requests": len(outcomes),
        "served": len(ok),
        "shed": len(shed),
        "shed_fraction": round(len(shed) / len(outcomes), 4)
        if outcomes else 0.0,
        "rows": rows,
        "wall_s": round(wall, 4),
        "qps": round(qps, 2),
        "rows_per_sec": round(rows / wall, 1) if wall else 0.0,
        "latency_p50_ms": round(p50, 3),
        "latency_p99_ms": round(p99, 3),
        "cold_entities": int(_counter("serving.cold_entities")),
        "compiled_programs": fleet.compilations,
        "replicas": args.replicas,
        "replica_backend": args.replica_backend,
        "supervised": bool(args.supervise),
        "replica_deaths": int(_counter("serving.replica_deaths")),
        "resurrections": int(_counter("serving.replica_resurrections")),
        "quarantined": int(_counter("serving.replica_quarantined")),
        "transport": args.transport,
        "traffic": args.traffic,
        "deadline_ms": args.deadline_ms,
        "table_dtype": args.table_dtype,
        "models": args.models,
        "splits": None,
        "tenant_shed": 0,
        # Each child replica's device, captures and allocator segments at
        # warmup and at its last stats pull, card memory, host syncs and
        # batches (subprocess backend; empty for threads).
        "children": [r.child_report() for r in fleet.replicas
                     if hasattr(r, "child_report")],
    }
    publish_text(
        args.output_dir, "serving_summary.json",
        lambda f: json.dump(summary, f, indent=1),
        session, logger, site="serve:write",
    )
    logger.info(
        "served %d/%d requests (%d rows, %d shed) at %.1f req/s; latency "
        "p50 %.2f ms p99 %.2f ms; %d cold entities",
        summary["served"], summary["requests"], rows, summary["shed"],
        qps, p50, p99, summary["cold_entities"],
    )
    return summary


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
