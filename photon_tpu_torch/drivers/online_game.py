"""Online GAME learning driver: continual training with zero-downtime refresh.

Counterpart of ``photon_tpu/drivers/online_game.py``: fit an initial GAME
model on ``--input``, stand up a serving fleet on it (thread replicas, one
CUDA graph a bucket), then drain ``--append-dir``'s part files through the
online-learning service — in-place device-data growth, a warm-started
partial refresh with untouched coordinates locked, a canary-gated publish —
and record each round's append-to-serving latency.

    python -m photon_tpu_torch.drivers.online_game \\
        --input train.avro --append-dir appends/ \\
        --feature-bags global=global,per_user=per_user --id-columns userId \\
        --coordinate fixed:type=fixed,shard=global \\
        --coordinate per_user:type=random,shard=per_user,entity=userId \\
        --replicas 2 --checkpoint-dir ckpt --output-dir out

With ``--checkpoint-dir`` every refresh is preemption-safe: a killed round
resumes from its descent checkpoint and a restarted run re-merges the
parts the feed already published.  The final model and
``online_summary.json`` land in ``--output-dir``.  ``--backend gpu`` (the
default) trains and serves on the card; ``--backend cpu`` on the host.
The fleet is the in-process thread fleet, as in the reference: this driver
has no socket ingest and no subprocess replicas (``serve_game`` has both).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from photon_tpu_torch.drivers import common
from photon_tpu_torch.drivers.train_game import (
    _build_sweep,
    _coordinate_specs,
    _load_game_data,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "photon_tpu_torch.drivers.online_game", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_common_args(p)
    p.add_argument("--input", required=True,
                   help="initial training data: Avro file/dir/glob or a "
                   "synthetic-game spec (see train_game)")
    p.add_argument("--append-dir", required=True,
                   help="directory of appended Avro part files, watched by "
                   "the online feed; the consumed cursor lives here")
    p.add_argument("--feature-bags", default=None)
    p.add_argument("--id-columns", default=None)
    p.add_argument("--task", default="logistic_regression")
    p.add_argument("--coordinate", action="append", required=True,
                   dest="coordinates", metavar="NAME:key=value,...",
                   help="coordinate spec (train_game's grammar); exactly "
                   "one configuration: online refresh is not a sweep")
    p.add_argument("--initial-iterations", type=int, default=2,
                   help="outer descent iterations of the initial fit")
    p.add_argument("--refresh-iterations", type=int, default=2,
                   help="outer descent iterations per refresh (warm-started)")
    p.add_argument("--max-rounds", type=int, default=0,
                   help="stop after this many refresh rounds (0 = drain the "
                   "append directory once)")
    p.add_argument("--replicas", type=int, default=1,
                   help="serving replicas behind the fleet router")
    p.add_argument("--table-capacity-factor", type=int, default=2,
                   help="serving-table headroom factor: a grown vocabulary "
                   "swaps in place until it outgrows it")
    p.add_argument("--no-lock-untouched", action="store_true",
                   help="retrain every coordinate each refresh")
    p.add_argument("--rollout-parity-tol", type=float, default=1e-3,
                   help="canary parity gate of each publish")
    p.add_argument("--checkpoint-dir", default=None,
                   help="per-round descent checkpoints and the durable round "
                   "counter")
    p.add_argument("--max-quarantined", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    common.add_telemetry_arg(p)
    return p


def run(args: argparse.Namespace) -> dict:
    logger = common.RunLogger("photon_tpu_torch.online_game")
    os.makedirs(args.output_dir, exist_ok=True)
    with common.telemetry_run(args, "online_game", logger) as session:
        return _run(args, logger, session)


def _run(args: argparse.Namespace, logger, session) -> dict:
    from photon_tpu_torch.game.estimator import (
        GameEstimator,
        GameOptimizationConfiguration,
    )
    from photon_tpu_torch.game.model_io import save_game_model
    from photon_tpu_torch.online import (
        DirectoryFeed,
        OnlineLearningService,
        RefreshPolicy,
        merge_append,
    )
    from photon_tpu_torch.serving.fleet import ServingFleet
    from photon_tpu_torch.serving.scorer import request_spec_for_dataset

    device = common.device_for_backend(args.backend)
    configurations = _build_sweep(_coordinate_specs(args), args.task)
    if len(configurations) != 1:
        raise ValueError(
            "online refresh takes exactly ONE configuration (no reg-weight "
            f"sweeps); got {len(configurations)} combinations")
    _label, coords = configurations[0]
    config = GameOptimizationConfiguration(
        coordinates=coords, descent_iterations=args.initial_iterations,
        name="online")

    with logger.timed("load-data"):
        data, index_maps = _load_game_data(args.input, args)
        logger.info("initial training data: %d rows", data.num_examples)

    def load_part(path):
        return _load_game_data(path, args, index_maps=index_maps)[0]

    feed = DirectoryFeed(args.append_dir, loader=load_part, telemetry=session,
                         logger=logger)
    # Restart: the parts a previous run published are skipped by the feed's
    # cursor, but the merged training data is not durable: re-merge them in
    # their ingest order.
    consumed = feed.consumed_sources()
    if consumed:
        n_before = data.num_examples
        with logger.timed("replay-consumed-parts"):
            for name in consumed:
                data, _ = merge_append(data, load_part(os.path.join(args.append_dir, name)))
        logger.info("restart: re-merged %d published part(s) (%d rows)",
                    len(consumed), data.num_examples - n_before)

    estimator = GameEstimator(args.task, data, device=device, logger=logger,
                              telemetry=session)
    max_quarantined = None if args.max_quarantined < 0 else args.max_quarantined
    with logger.timed("initial-fit"):
        model = estimator.fit([config], max_quarantined=max_quarantined)[0].model

    with logger.timed("build-fleet"):
        fleet = ServingFleet(
            model, replicas=args.replicas, device=device,
            request_spec=request_spec_for_dataset(model, data),
            telemetry=session, table_capacity_factor=args.table_capacity_factor,
        ).warmup()
        logger.info("fleet warm: %d replicas, %d programs", args.replicas,
                    fleet.compilations)

    service = OnlineLearningService(
        estimator, config, feed, model=model, fleet=fleet,
        checkpoint_dir=args.checkpoint_dir,
        policy=RefreshPolicy(
            refresh_iterations=args.refresh_iterations,
            lock_untouched=not args.no_lock_untouched,
            max_quarantined=max_quarantined,
            rollout_parity_tol=args.rollout_parity_tol,
        ),
        telemetry=session, logger=logger,
    )
    rounds = []
    try:
        with logger.timed("online-refresh"):
            while True:
                result = service.refresh_once()
                if result is None:
                    break
                rounds.append(result)
                if args.max_rounds and len(rounds) >= args.max_rounds:
                    break
    finally:
        fleet.close()

    model_dir = os.path.join(args.output_dir, "model")
    with logger.timed("save-model"):
        save_game_model(model_dir, service.model, index_maps or {})
    latencies = [r.latency_s for r in rounds]
    summary = {
        "rounds": len(rounds),
        "rows_ingested": int(sum(r.rows for r in rounds)),
        "coordinates": list(config.coordinates),
        "locked_per_round": [r.locked for r in rounds],
        "published": sum(1 for r in rounds if r.published),
        "replicas": args.replicas,
        "refresh_latency_s": {
            "per_round": latencies,
            "mean": float(np.mean(latencies)) if latencies else 0.0,
            "max": float(np.max(latencies)) if latencies else 0.0,
        },
        "compiled_programs": fleet.compilations,
        "model_dir": model_dir,
        "phase_times": logger.phase_times,
        "backend": args.backend,
    }
    with open(os.path.join(args.output_dir, "online_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    logger.info("online loop done: %d round(s), %d rows, mean refresh %.3fs",
                summary["rounds"], summary["rows_ingested"],
                summary["refresh_latency_s"]["mean"])
    return summary


def main(argv=None) -> None:
    common.run_cli(run, build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
