"""Shared driver plumbing: device choice, data loading, sweep selection.

Counterpart of the parts of ``photon_tpu/drivers/common.py`` that the GLM
training driver's resident path uses.  ``--backend gpu`` (the default) runs
on the card and fails where there is none; ``--backend cpu`` runs on the
host.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time
from typing import Iterator, Optional

from photon_tpu_torch.core.losses import BINARY_TASKS
from photon_tpu_torch.device import resolve_device


class RunLogger:
    """Console logger with timed phases (``phase_times`` goes into the
    training summary)."""

    def __init__(self, name: str):
        self._logger = logging.getLogger(name)
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        if not self._logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(message)s")
            )
            self._logger.addHandler(handler)
        self.phase_times: dict[str, float] = {}

    def info(self, msg: str, *args) -> None:
        self._logger.info(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self._logger.warning(msg, *args)

    @contextlib.contextmanager
    def timed(self, phase: str) -> Iterator[None]:
        t0 = time.monotonic()
        self.info("phase %s: start", phase)
        try:
            yield
        finally:
            self.phase_times[phase] = time.monotonic() - t0
            self.info("phase %s: %.3fs", phase, self.phase_times[phase])


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                        help="gpu (default) runs on the CUDA card and fails "
                        "without one; cpu runs on the host")
    parser.add_argument("--output-dir", required=True)


def add_data_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--input", required=True,
                        help="training data: a LIBSVM file (Avro and "
                        "synthetic inputs wait in ROADMAP.md queue 1)")
    parser.add_argument("--validation-input", default=None,
                        help="validation data (LIBSVM)")
    parser.add_argument("--intercept", action=argparse.BooleanOptionalAction,
                        default=True)


def device_for_backend(backend: str):
    return resolve_device("cuda" if backend == "gpu" else "cpu")


def load_dataset(spec: str, intercept: bool, task: str, device):
    """``(batch, dim, index_map)`` from a LIBSVM file; {-1, +1} labels map
    to {0, 1} for binary tasks only."""
    from photon_tpu_torch.data.index_map import IndexMap, feature_key
    from photon_tpu_torch.data.libsvm import load_sparse_batch

    if not os.path.exists(spec):
        raise FileNotFoundError(f"--input {spec} does not exist")
    batch, dim, raw_dim = load_sparse_batch(
        spec, intercept=intercept, binary_labels=task in BINARY_TASKS,
        device=device,
    )
    keys = [feature_key(f"f{i}") for i in range(raw_dim)]
    return batch, dim, IndexMap.build(keys, intercept=intercept)


def load_validation(spec: Optional[str], train_dim: int, intercept: bool,
                    task: str, device):
    """Validation data padded to the training dimension."""
    if spec is None:
        return None
    from photon_tpu_torch.data.libsvm import load_sparse_batch

    feature_dim = train_dim - (1 if intercept else 0)
    batch, _, _ = load_sparse_batch(
        spec, dim=feature_dim, intercept=intercept,
        binary_labels=task in BINARY_TASKS, max_feature_dim=feature_dim,
        device=device,
    )
    return batch


def parse_weights_list(s: str) -> list[float]:
    return [float(tok) for tok in s.split(",") if tok.strip()]


def build_flat_evaluators(spec: str):
    from photon_tpu_torch.evaluation.evaluators import MultiEvaluator, get_evaluator

    return MultiEvaluator([get_evaluator(n) for n in spec.split(",")])


def select_and_save_sweep(sweep: list, evaluators, has_validation: bool,
                          index_map, args, logger: RunLogger,
                          extra_summary: Optional[dict] = None) -> dict:
    """Pick the best lambda (primary evaluator, else final objective value),
    save the model and the feature index, write training_summary.json."""
    from photon_tpu_torch.data.model_io import save_glm_model

    primary = evaluators.primary
    if has_validation:
        best = sweep[0]
        for entry in sweep[1:]:
            if primary.better_than(
                entry["metrics"][primary.name], best["metrics"][primary.name]
            ):
                best = entry
    else:
        best = min(sweep, key=lambda e: e["final_value"])
    with logger.timed("save-models"):
        index_map.save(os.path.join(args.output_dir, "feature_index.json"))
        ext = "avro" if args.model_format == "avro" else "json"
        save_glm_model(
            os.path.join(args.output_dir, f"best_model.{ext}"),
            best["model"], index_map, fmt=args.model_format,
        )
        summary = {
            "task": args.task,
            "best_lambda": best["lambda"],
            "sweep": [
                {k: v for k, v in entry.items() if k != "model"} for entry in sweep
            ],
            "phase_times": logger.phase_times,
            **(extra_summary or {}),
        }
        with open(os.path.join(args.output_dir, "training_summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    logger.info("best lambda=%g -> %s/best_model.%s",
                best["lambda"], args.output_dir, ext)
    return summary

