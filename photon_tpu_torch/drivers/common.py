"""Shared driver plumbing: device choice, data loading, sweep selection.

Counterpart of the parts of ``photon_tpu/drivers/common.py`` that the GLM
drivers' resident paths use.  ``--backend gpu`` (the default) runs on the
card and fails where there is none; ``--backend cpu`` runs on the host.
Inputs: a LIBSVM file (the native parser when the host library builds),
an Avro file or directory of ``TrainingExampleAvro`` records (the native
columnar decoder, ``data/game_io.py``), or
``synthetic:<task>:<n>:<dim>[:seed[:weight_seed]]`` (a dense batch from
``data/synthetic.make_glm_data``).
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
        # Set by TelemetrySession.attach: each timed phase becomes a span.
        self.tracer = None

    def info(self, msg: str, *args) -> None:
        self._logger.info(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self._logger.warning(msg, *args)

    @contextlib.contextmanager
    def timed(self, phase: str) -> Iterator[None]:
        t0 = time.monotonic()
        self.info("phase %s: start", phase)
        span = (self.tracer.span(phase) if self.tracer is not None
                else contextlib.nullcontext())
        try:
            with span:
                yield
        finally:
            self.phase_times[phase] = time.monotonic() - t0
            self.info("phase %s: %.3fs", phase, self.phase_times[phase])


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--backend", choices=("gpu", "cpu"), default="gpu",
                        help="gpu (default) runs on the CUDA card and fails "
                        "without one; cpu runs on the host")
    parser.add_argument("--output-dir", required=True)


def add_telemetry_arg(parser: argparse.ArgumentParser) -> None:
    """The one definition of ``--telemetry``."""
    parser.add_argument("--telemetry", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="write structured telemetry (metrics registry "
                        "snapshot, tracing spans, run report) under "
                        "<output-dir>/telemetry/; PHOTON_TELEMETRY=off "
                        "disables process-wide")


@contextlib.contextmanager
def telemetry_run(args: argparse.Namespace, driver: str, logger: RunLogger):
    """Run-report bracket around a driver body: yields a telemetry session
    attached to ``logger`` (every timed phase becomes a span), then writes
    ``<output-dir>/telemetry/run_report.json`` — with status "error" and the
    exception when the body raises.  A ``PHOTON_FAULTS`` plan restarts
    fresh for the run."""
    from photon_tpu_torch.fault.injection import reset_env_plan
    from photon_tpu_torch.telemetry import TelemetrySession, telemetry_enabled

    reset_env_plan()
    session = TelemetrySession(
        driver, enabled=telemetry_enabled(getattr(args, "telemetry", None))
    )
    session.attach(logger)
    try:
        yield session
    except BaseException as e:
        session.finalize(getattr(args, "output_dir", None), status="error",
                         error=f"{type(e).__name__}: {e}")
        raise
    else:
        session.finalize(getattr(args, "output_dir", None))


def add_data_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--input", required=True,
                        help="a LIBSVM file, an Avro file or directory, or "
                        "synthetic:<task>:<n>:<dim>[:seed[:weight_seed]]")
    parser.add_argument("--validation-input", default=None,
                        help="validation data, in any --input form")
    parser.add_argument("--intercept", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--avro-feature-field", default="features",
                        help="the Avro record field holding the feature bag")


def device_for_backend(backend: str):
    return resolve_device("cuda" if backend == "gpu" else "cpu")


def _is_avro_input(spec: str) -> bool:
    from photon_tpu_torch.data.game_io import is_avro_dir

    return spec.endswith(".avro") or is_avro_dir(spec)


def input_reader(spec: str) -> str:
    """Which reader loaded ``spec`` last: ``native`` or ``python`` for a
    LIBSVM or Avro file, ``synthetic`` for a generated batch."""
    if spec.startswith("synthetic:"):
        return "synthetic"
    if _is_avro_input(spec):
        from photon_tpu_torch.data import game_io

        return game_io.last_reader
    from photon_tpu_torch.data import libsvm

    return libsvm.last_reader


def load_dataset(spec: str, intercept: bool, task: str, device,
                 avro_field: str = "features", index_map=None):
    """``(batch, dim, index_map)`` from an ``--input`` spec; {-1, +1}
    LIBSVM labels map to {0, 1} for binary tasks only.  Avro records give
    their ``avro_field`` bag as one feature shard; pass ``index_map`` to
    index them as a training run did (features absent from it are
    dropped)."""
    from photon_tpu_torch.data.index_map import IndexMap, feature_key

    if _is_avro_input(spec):
        from photon_tpu_torch.data.game_io import read_game_avro
        from photon_tpu_torch.game.model import shard_to_batch

        maps = None if index_map is None else {"global": index_map}
        data, out_maps = read_game_avro(spec, {"global": avro_field}, [],
                                        index_maps=maps, intercept=intercept)
        shard = data.shards["global"]
        batch = shard_to_batch(shard, data.label, data.offset, data.weight,
                               device=device)
        return batch, shard.dim, out_maps["global"]
    if spec.startswith("synthetic:"):
        from photon_tpu_torch.data.synthetic import make_glm_data

        parts = spec.split(":")
        task, n, dim = parts[1], int(parts[2]), int(parts[3])
        seed = int(parts[4]) if len(parts) > 4 else 0
        weight_seed = int(parts[5]) if len(parts) > 5 else None
        batch, _ = make_glm_data(n, dim, task=task, seed=seed, intercept=intercept,
                                 weight_seed=weight_seed, device=device)
        keys = [feature_key(f"f{i}") for i in range(dim - (1 if intercept else 0))]
        return batch, dim, IndexMap.build(keys, intercept=intercept)
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
                    task: str, device, avro_field: str = "features",
                    index_map=None):
    """Validation or scoring data at the training dimension (a LIBSVM file
    whose largest id is below it is padded)."""
    if spec is None:
        return None
    if _is_avro_input(spec) or spec.startswith("synthetic:"):
        if _is_avro_input(spec) and index_map is None:
            raise ValueError(
                "Avro validation input needs the training index map "
                "(features must share the training run's indexing)"
            )
        batch, dim, _ = load_dataset(spec, intercept, task, device,
                                     avro_field=avro_field, index_map=index_map)
        if dim != train_dim:
            raise ValueError(f"validation dim {dim} != train dim {train_dim}")
        return batch
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
        if getattr(args, "save_all_models", False):
            for entry in sweep:
                save_glm_model(
                    os.path.join(args.output_dir,
                                 f"model_lambda_{entry['lambda']:g}.{ext}"),
                    entry["model"], index_map, fmt=args.model_format,
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

