"""GLM scoring driver: load a saved model, score a dataset, write the scores.

Counterpart of ``photon_tpu/drivers/score.py``: read the model (keyed by
name and term) through the port's ``data/model_io.py``, join it onto the
feature index written at training time, score LIBSVM, Avro or
``synthetic:`` input on the card (or ``--backend cpu``), write
``scores.txt`` and, with ``--evaluators``, the metrics to
``metrics.json``.

Usage:
    python -m photon_tpu_torch.drivers.score \\
        --input val.libsvm --model out/best_model.avro \\
        --evaluators RMSE --output-dir scored --backend gpu

``--stream`` scores part files (a directory or a glob of LIBSVM or Avro
files) one at a time, appending each file's scores to ``scores.txt`` and
dropping its features before the next file loads; with ``--evaluators``
only the scores, labels and weights are kept for the metrics.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from photon_tpu_torch.drivers import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "photon_tpu_torch.drivers.score", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_common_args(p)
    common.add_data_args(p)
    p.add_argument("--model", required=True, help="saved model file (avro/json)")
    p.add_argument("--index-map", default=None,
                   help="feature index map JSON written at training time; "
                   "defaults to feature_index.json next to the model")
    p.add_argument("--evaluators", default=None)
    p.add_argument("--predict-mean", action="store_true",
                   help="write mean predictions (sigmoid/exp link) instead of "
                   "raw scores")
    p.add_argument("--stream", action="store_true",
                   help="score part files (LIBSVM or Avro) one at a time, "
                   "dropping each chunk's features after scoring")
    return p


def run(args: argparse.Namespace) -> dict:
    from photon_tpu_torch.data.index_map import IndexMap
    from photon_tpu_torch.data.model_io import load_glm_model

    device = common.device_for_backend(args.backend)
    logger = common.RunLogger("photon_tpu_torch.score", args.log_file)
    os.makedirs(args.output_dir, exist_ok=True)
    imap_path = args.index_map or os.path.join(
        os.path.dirname(args.model), "feature_index.json"
    )
    index_map = IndexMap.load(imap_path)
    model = load_glm_model(args.model, index_map, device=device)
    dim = int(model.coefficients.means.shape[0])
    logger.info("model: %s dim=%d on %s", model.task_type, dim, device)
    # Whether the model has an intercept is recorded in the index map, not
    # the flag: trusting the flag would shift every feature id of a model
    # trained with --no-intercept.
    intercept = index_map.intercept_id is not None
    if intercept != args.intercept:
        logger.warning("index map says intercept=%s; overriding --intercept flag",
                       intercept)
    evaluators = (common.build_flat_evaluators(args.evaluators)
                  if args.evaluators else None)

    def load_chunk(spec: str):
        return common.load_validation(
            spec, dim, intercept, model.task_type, device,
            avro_field=args.avro_feature_field, index_map=index_map,
        )

    def score_chunk(batch):
        raw = model.compute_score(batch)
        out = model.loss.mean(raw) if args.predict_mean else raw
        if args.predict_mean and model.task_type == "poisson_regression":
            from photon_tpu_torch.core.losses import _POISSON_MAX_EXPONENT

            n_capped = int((raw > _POISSON_MAX_EXPONENT).sum())
            if n_capped:
                logger.info("%d scoring margins exceed the Poisson exp cap (%g); "
                            "their predicted means are clamped to e^cap",
                            n_capped, _POISSON_MAX_EXPONENT)
        return raw, out.cpu().numpy()

    scores_path = os.path.join(args.output_dir, "scores.txt")
    if args.stream:
        kept = []  # (raw, label, weight) a part, for the evaluators only

        def on_chunk(batch, raw):
            if evaluators is not None:
                kept.append((raw, batch.label, batch.weight))

        with logger.timed("stream-score"):
            n = common.stream_score_parts(
                args.input, load_chunk,
                lambda b: (*score_chunk(b), b.num_examples),
                scores_path, logger, on_chunk,
            )
        if evaluators is not None:
            raw, labels, weights = (torch.cat(part) for part in zip(*kept))
    else:
        with logger.timed("load-data"):
            batch = load_chunk(args.input)
        with logger.timed("score"):
            raw, scores = score_chunk(batch)
        np.savetxt(scores_path, scores, fmt="%.8g")
        n = int(scores.shape[0])
        labels, weights = batch.label, batch.weight
    metrics = {}
    if evaluators is not None:
        with logger.timed("evaluate"):
            metrics = evaluators.evaluate(raw, labels, weights)
        logger.info("metrics %s", metrics)
        with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=1)
    return {"num_scored": n, "metrics": metrics, "streamed": bool(args.stream),
            "input_reader": None if args.stream else common.input_reader(args.input),
            "phase_times": logger.phase_times}


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
