"""GAME scoring driver: score a dataset with a saved GAME model.

Counterpart of ``photon_tpu/drivers/score_game.py``: load a saved GAME model
directory (retried), read and index the scoring data through the model's
per-shard feature maps (features the model never saw drop), score it
through the serving :class:`~photon_tpu_torch.serving.GameScorer` — the
same tables and body the online service runs, so the batch and serving
paths cannot drift — and write ``scores.txt`` (atomically, retried) and,
with ``--evaluators``, ``metrics.json``:

    python -m photon_tpu_torch.drivers.score_game \\
        --input test.avro --model out/best_model \\
        --feature-bags global=global,per_user=per_user \\
        --id-columns userId --evaluators AUC --output-dir scored

``PHOTON_BATCH_SCORER=host`` scores through ``GameModel.score`` instead
(float64 accumulation on the host: the oracle the serving path is held
to).  ``--backend gpu`` (the default) runs on the card and fails without
one.  ``--stream`` scores Avro part files (a directory or a glob) one at a
time through the same scorer (one per request layout the parts give),
appending each part's scores to ``scores.txt`` and dropping its features
before the next part loads; with ``--evaluators`` only the scores, labels
and weights are kept.  The sharded evaluators wait in ROADMAP.md queue 1,
item 4.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from photon_tpu_torch.drivers import common
from photon_tpu_torch.drivers.train_game import _load_game_data


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "photon_tpu_torch.drivers.score_game", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_common_args(p)
    common.add_telemetry_arg(p)
    p.add_argument("--input", required=True,
                   help="scoring data: Avro file/dir or synthetic-game spec "
                   "(see train_game)")
    p.add_argument("--model", required=True, help="GAME model directory")
    p.add_argument("--feature-bags", default=None)
    p.add_argument("--id-columns", default=None)
    p.add_argument("--evaluators", default=None)
    p.add_argument("--predict-mean", action="store_true",
                   help="write mean predictions (inverse link) instead of "
                   "raw scores")
    p.add_argument("--stream", action="store_true",
                   help="score Avro part files one at a time, dropping each "
                   "part's features after scoring")
    return p


def publish_text(output_dir: str, name: str, write_fn, session, logger,
                 site: str) -> None:
    """Atomic, retried artifact publish: each attempt writes a fresh temp
    file and renames it into place, so a failed or abandoned attempt can
    never leave a torn file — readers see the previous complete file or
    the new one.  ``io:write`` is the fault window, ``site`` the retry
    site."""
    import tempfile

    from photon_tpu_torch.fault.injection import fault_point
    from photon_tpu_torch.fault.retry import retry_call

    def attempt():
        fault_point("io:write", path=name)
        fd, tmp = tempfile.mkstemp(
            prefix=f".{name}-", suffix=".tmp", dir=output_dir
        )
        try:
            with os.fdopen(fd, "w") as f:
                write_fn(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(output_dir, name))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    retry_call(attempt, site=site, telemetry=session, logger=logger)


def score_dataset(model, data, device, logger, session,
                  scorers: dict | None = None) -> np.ndarray:
    """Raw scores through the serving :class:`GameScorer` on ``device``
    (the dataset's own padded layout, one program), or through the host
    oracle under ``PHOTON_BATCH_SCORER=host``.  ``scorers`` keeps one
    scorer per request layout across calls (the streamed parts)."""
    if os.environ.get("PHOTON_BATCH_SCORER", "device") == "host":
        logger.info("PHOTON_BATCH_SCORER=host: host scoring path")
        return model.score(data)
    from photon_tpu_torch.serving import GameScorer, request_spec_for_dataset

    spec = request_spec_for_dataset(model, data)
    key = repr(sorted(spec.items()))
    scorer = None if scorers is None else scorers.get(key)
    if scorer is None:
        scorer = GameScorer(model, device=device, request_spec=spec,
                            telemetry=session)
        if scorers is not None:
            scorers[key] = scorer
    return scorer.score_dataset(data)


def run(args: argparse.Namespace) -> dict:
    device = common.device_for_backend(args.backend)
    logger = common.RunLogger("photon_tpu_torch.score_game", args.log_file)
    os.makedirs(args.output_dir, exist_ok=True)
    with common.telemetry_run(args, "score_game", logger) as session:
        return _run(args, device, logger, session)


def _run(args, device, logger, session) -> dict:
    from photon_tpu_torch.core.losses import get_loss
    from photon_tpu_torch.fault.retry import retry_call
    from photon_tpu_torch.game.model_io import load_game_model

    # Evaluator names fail before any work.
    evaluators = (common.build_flat_evaluators(args.evaluators)
                  if args.evaluators else None)
    with logger.timed("load-model"):
        # A model directory is many small files: a transient storage error
        # retries instead of killing the run.
        model, index_maps = retry_call(
            lambda: load_game_model(args.model, device=device),
            site="model:load", telemetry=session, logger=logger,
        )
        logger.info("model: %s, coordinates %s on %s", model.task_type,
                    list(model.coordinates), device)
    if args.stream:
        return _run_streaming(args, model, index_maps, device, evaluators,
                              logger, session)
    with logger.timed("load-data"):
        data, _ = _load_game_data(args.input, args, index_maps=index_maps)
        logger.info("scoring %d examples", data.num_examples)
        session.gauge("score.num_scored").set(data.num_examples)
    with logger.timed("score"):
        raw = score_dataset(model, data, device, logger, session)
        out = raw
        if args.predict_mean:
            out = get_loss(model.task_type).mean(torch.as_tensor(raw)).numpy()
    publish_text(args.output_dir, "scores.txt",
                 lambda f: np.savetxt(f, out, fmt="%.8g"), session, logger,
                 site="scores:write")
    metrics = {}
    if evaluators is not None:
        with logger.timed("evaluate"):
            metrics = evaluators.evaluate(
                torch.as_tensor(raw, device=device),
                torch.as_tensor(np.asarray(data.label, np.float32), device=device),
                torch.as_tensor(np.asarray(data.weight, np.float32), device=device),
            )
        for name, value in metrics.items():
            session.gauge("score.metric", metric=name).set(value)
        logger.info("metrics %s", metrics)
        with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=1)
    return {"num_scored": int(data.num_examples), "metrics": metrics,
            "phase_times": logger.phase_times}


def _run_streaming(args, model, index_maps, device, evaluators, logger,
                   session) -> dict:
    """File-at-a-time scoring: each Avro part file is read and indexed
    through the model's maps, scored, written, and dropped before the next
    file loads (``common.stream_score_parts``)."""
    from photon_tpu_torch.core.losses import get_loss
    from photon_tpu_torch.data.game_io import read_game_avro
    from photon_tpu_torch.drivers.train_game import parse_feature_bags

    if args.input.startswith("synthetic-game:"):
        raise ValueError("--stream needs Avro part-file input")
    if not args.feature_bags or not args.id_columns:
        raise ValueError("Avro input needs --feature-bags and --id-columns")
    bags = parse_feature_bags(args.feature_bags)
    id_cols = [c.strip() for c in args.id_columns.split(",") if c.strip()]
    scorers: dict = {}
    kept = []  # (raw, label, weight) a part, for the evaluators only

    def load_chunk(path):
        return read_game_avro(path, bags, id_cols, index_maps=index_maps)[0]

    def score_chunk(chunk):
        raw = score_dataset(model, chunk, device, logger, session, scorers)
        out = raw
        if args.predict_mean:
            out = get_loss(model.task_type).mean(torch.as_tensor(raw)).numpy()
        return raw, out, int(chunk.num_examples)

    def on_chunk(chunk, raw):
        if evaluators is not None:
            kept.append((raw, np.asarray(chunk.label, np.float32),
                         np.asarray(chunk.weight, np.float32)))

    with logger.timed("stream-score"):
        n = common.stream_score_parts(
            args.input, load_chunk, score_chunk,
            os.path.join(args.output_dir, "scores.txt"), logger, on_chunk,
            telemetry=session,
        )
    session.gauge("score.num_scored").set(n)
    metrics = {}
    if evaluators is not None:
        raw, labels, weights = (np.concatenate(part) for part in zip(*kept))
        with logger.timed("evaluate"):
            metrics = evaluators.evaluate(
                *(torch.as_tensor(a, device=device) for a in (raw, labels, weights)))
        for name, value in metrics.items():
            session.gauge("score.metric", metric=name).set(value)
        logger.info("metrics %s", metrics)
        with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=1)
    return {"num_scored": n, "metrics": metrics, "streamed": True,
            "scorers": len(scorers), "phase_times": logger.phase_times}


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
