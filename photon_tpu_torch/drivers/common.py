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


_LOG_FORMAT = "%(asctime)s %(levelname)s %(message)s"


class RunLogger:
    """Console logger with timed phases (``phase_times`` goes into the
    training summary), and a copy of every line in ``log_file`` when one
    is given (``--log-file``)."""

    def __init__(self, name: str, log_file: Optional[str] = None):
        self._logger = logging.getLogger(name)
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        if not any(type(h) is logging.StreamHandler for h in self._logger.handlers):
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(_LOG_FORMAT))
            self._logger.addHandler(handler)
        # The logger is a process-wide singleton and each construction is a
        # new run: file handlers are reset to exactly the requested file, so
        # a later run neither appends to an earlier run's log nor writes
        # each line twice.
        target = os.path.abspath(log_file) if log_file else None
        for h in list(self._logger.handlers):
            if isinstance(h, logging.FileHandler) and h.baseFilename != target:
                self._logger.removeHandler(h)
                h.close()
        if target and not any(isinstance(h, logging.FileHandler)
                              for h in self._logger.handlers):
            os.makedirs(os.path.dirname(target), exist_ok=True)
            handler = logging.FileHandler(target)
            handler.setFormatter(logging.Formatter(_LOG_FORMAT))
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
    parser.add_argument("--log-file", default=None,
                        help="also write the run's log lines to this file")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of the train "
                        "phase here (train, train_game)")


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], name: str) -> Iterator[None]:
    """Wrap a phase in a ``torch.profiler`` trace when a directory is
    given: host operators, and on a card its kernels too, exported as
    ``<trace_dir>/<name>.pt.trace.json`` (Chrome trace format)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    slug = "".join(c if c.isalnum() or c in "-_." else "-" for c in name)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{slug}.pt.trace.json"))


def add_telemetry_arg(parser: argparse.ArgumentParser) -> None:
    """The one definition of ``--telemetry``."""
    parser.add_argument("--telemetry", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="write structured telemetry (metrics registry "
                        "snapshot, tracing spans, run report) under "
                        "<output-dir>/telemetry/; PHOTON_TELEMETRY=off "
                        "disables process-wide")


def add_fault_args(parser: argparse.ArgumentParser) -> None:
    """The fault-tolerance flags of the training drivers: fault injection
    (overrides ``PHOTON_FAULTS``), preemption handling and the watchdog."""
    parser.add_argument("--faults", default=None, metavar="SPEC",
                        help="inject deterministic faults for recovery "
                        "testing, e.g. 'io:read:p=0.3,descent:kill:iter=2,"
                        "preempt:iter=1' (overrides PHOTON_FAULTS)")
    parser.add_argument("--faults-seed", type=int, default=0,
                        help="seed of the fault plan's RNG streams")
    parser.add_argument("--on-preempt", default="checkpoint",
                        choices=("checkpoint", "ignore"),
                        help="SIGTERM/SIGINT: 'checkpoint' (default) stops at "
                        "the next iteration boundary with its checkpoint "
                        "published and exits with code 75; 'ignore' keeps "
                        "the default signal behavior")
    parser.add_argument("--stall-timeout", type=float, default=None,
                        metavar="SECONDS",
                        help="run watchdog: watchdog.stalled telemetry when "
                        "iteration or IO heartbeats go silent this long, and "
                        "a guarded-IO call hung past it becomes a retriable "
                        "timeout.  Default: PHOTON_STALL_TIMEOUT_S, else off")


@contextlib.contextmanager
def telemetry_run(args: argparse.Namespace, driver: str, logger: RunLogger,
                  preemptible: bool = False):
    """Run-report bracket around a driver body: yields a telemetry session
    attached to ``logger`` (every timed phase becomes a span), then writes
    ``<output-dir>/telemetry/run_report.json`` — status "preempted" on a
    preemption stop, "error" with the exception when the body raises.

    It also installs the run-scoped fault machinery: the ``--faults`` plan
    (or a fresh ``PHOTON_FAULTS`` plan), the ``--stall-timeout`` watchdog
    and, for the training drivers (``preemptible``: their loops poll the
    flag at iteration boundaries), the ``--on-preempt`` SIGTERM/SIGINT
    handler.  All of it is undone on exit."""
    from photon_tpu_torch.fault.injection import install_from_args, set_plan
    from photon_tpu_torch.fault.preemption import PreemptedError, PreemptionHandler
    from photon_tpu_torch.fault.watchdog import (
        Watchdog,
        clear_heartbeats,
        set_stall_timeout,
        stall_timeout,
    )
    from photon_tpu_torch.telemetry import TelemetrySession, telemetry_enabled

    install_from_args(args)
    session = TelemetrySession(
        driver, enabled=telemetry_enabled(getattr(args, "telemetry", None))
    )
    session.attach(logger)
    flag_timeout = getattr(args, "stall_timeout", None)
    if flag_timeout is not None:
        set_stall_timeout(flag_timeout)
    watchdog = None
    if stall_timeout() > 0:
        watchdog = Watchdog(stall_timeout(), telemetry=session, logger=logger).start()
    handler = PreemptionHandler(
        (getattr(args, "on_preempt", None) or "checkpoint") if preemptible
        else "ignore", logger=logger)
    output_dir = getattr(args, "output_dir", None)
    try:
        with handler:
            yield session
    except PreemptedError as e:
        session.finalize(output_dir, status="preempted", error=str(e))
        raise
    except BaseException as e:
        session.finalize(output_dir, status="error",
                         error=f"{type(e).__name__}: {e}")
        raise
    else:
        session.finalize(output_dir)
    finally:
        if watchdog is not None:
            watchdog.stop()
        set_stall_timeout(None)
        clear_heartbeats()
        if getattr(args, "faults", None):
            set_plan(None)


def run_cli(run_fn, args: argparse.Namespace) -> None:
    """Driver ``main()`` tail: a preemption stop exits with
    :data:`~photon_tpu_torch.fault.preemption.PREEMPTED_EXIT_CODE` (75,
    EX_TEMPFAIL), so a wrapper can resubmit it; everything else propagates."""
    from photon_tpu_torch.fault.preemption import PREEMPTED_EXIT_CODE, PreemptedError

    try:
        run_fn(args)
    except PreemptedError as e:
        print(f"preempted: {e}", file=sys.stderr)
        raise SystemExit(PREEMPTED_EXIT_CODE)


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


def stream_score_parts(input_spec: str, load_chunk, score_chunk, scores_path: str,
                       logger: RunLogger, on_chunk=None, telemetry=None) -> int:
    """The file-at-a-time skeleton of both scoring drivers' ``--stream``:
    list the part files first (a bad glob writes no empty ``scores.txt``),
    skip empty parts (:class:`~photon_tpu_torch.data.game_io.NoRecordsError`
    or a 0-row chunk), append each part's scores as it is scored, and drop
    each chunk before the next file loads.  ``score_chunk(chunk) -> (raw,
    out, n)``; ``on_chunk(chunk, raw)`` keeps what the caller's evaluators
    need.  Returns the total row count (> 0, else NoRecordsError)."""
    import numpy as np

    from photon_tpu_torch.data.game_io import NoRecordsError, _input_files, narrow_avro_dir
    from photon_tpu_torch.telemetry import NULL_SESSION

    t = telemetry or NULL_SESSION
    files = _input_files(narrow_avro_dir(input_spec))
    n = 0
    t0 = time.monotonic()
    with open(scores_path, "w") as out_f, t.span("stream-score", files=len(files)):
        for path in files:
            chunk_t0 = time.monotonic()
            try:
                chunk = load_chunk(path)
            except NoRecordsError:
                chunk = None
            if chunk is None or getattr(chunk, "num_examples", None) == 0:
                # Part layouts often hold empty parts; only a zero-row total
                # is an error.
                logger.info("skipping empty part %s", path)
                t.counter("stream.chunks_skipped_empty").inc()
                continue
            raw, out, real_n = score_chunk(chunk)
            np.savetxt(out_f, out, fmt="%.8g")
            if on_chunk is not None:
                on_chunk(chunk, raw)
            n += real_n
            t.counter("stream.chunks_scored").inc()
            t.counter("stream.rows_scored").inc(real_n)
            t.histogram("stream.chunk_seconds").observe(time.monotonic() - chunk_t0)
            del chunk, raw, out
    if n == 0:
        raise NoRecordsError(f"no rows in {input_spec!r}")
    wall = time.monotonic() - t0
    if wall > 0:
        t.gauge("stream.rows_per_second").set(n / wall)
    return n
