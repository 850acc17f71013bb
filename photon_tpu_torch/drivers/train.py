"""Single-model GLM training driver.

Counterpart of the resident single-process path of
``photon_tpu/drivers/train.py``: read the data (LIBSVM, Avro or
``synthetic:``), summarize the features and build the normalization when
asked, sweep the regularization weights with L-BFGS, OWL-QN (L1 and the
elastic net) or TRON (optionally warm-starting each weight from the last, in
the optimizer's normalized space), compute the coefficient variances if
asked, evaluate each model on the validation data, keep the best, and write
the model in the original feature space (variances included), the feature
index and ``training_summary.json``.

Usage:
    python -m photon_tpu_torch.drivers.train \\
        --input train.libsvm --validation-input val.libsvm \\
        --task linear_regression --optimizer owlqn --reg-type elastic_net \\
        --reg-weights 1.0 --normalization standardization \\
        --output-dir out --backend gpu

``--checkpoint-dir`` publishes one completed snapshot per finished
regularization weight (the reference's ``StreamState`` shape), and
``--resume`` rebuilds finished weights from their snapshots without a
refit; the preemption boundary (SIGTERM/SIGINT, the ``preempt`` fault site)
sits between weights and exits with code 75.  The snapshots publish on a
background thread (``--checkpoint-async``, default on; the sweep drains it
before it returns or stops), blocking above ``--checkpoint-max-staged-mb``.
``--telemetry`` writes the run report, ``--faults`` injects faults.

``--stream`` trains on data beyond device memory: ``--input`` is a glob or a
directory of LIBSVM part files, re-parsed on every objective evaluation
(``data/streaming.py``), fitted by the host-loop L-BFGS (``l2`` or
``none``), with mid-fit checkpoints every ``--checkpoint-every`` iterations
that ``--resume`` continues exactly::

    python -m photon_tpu_torch.drivers.train --stream \
        --input 'parts/part-*.libsvm' --reg-weights 1.0 \
        --checkpoint-dir ck --checkpoint-every 1 --output-dir out

``--feature-dim`` skips the metadata parse.  ``PHOTON_STREAM_KERNEL`` (or a
forced ``PHOTON_SPARSE_GRAD``) picks the chunks' route; the default is the
row-major ``autodiff``.

``--dtype bfloat16`` stores the training batch's feature values in bf16
(``data/batch.batch_astype``), after the normalization statistics and the
layout attach, so no layout or route is rebuilt; labels, weights,
coefficients and all arithmetic stay float32, and the validation data
stays float32.  With ``--stream`` it raises, as the reference does.

Not carried (ROADMAP.md queue 1): the diagnostic reports and multi-process
runs (item 10).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from photon_tpu_torch.core.losses import BINARY_TASKS
from photon_tpu_torch.core.normalization import NORMALIZATION_TYPES
from photon_tpu_torch.drivers import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "photon_tpu_torch.drivers.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_common_args(p)
    common.add_data_args(p)
    p.add_argument("--task", default="logistic_regression",
                   choices=("logistic_regression", "linear_regression",
                            "poisson_regression", "smoothed_hinge_loss_linear_svm"))
    p.add_argument("--optimizer", default="lbfgs", choices=("lbfgs", "owlqn", "tron"))
    p.add_argument("--reg-type", default="l2",
                   choices=("none", "l1", "l2", "elastic_net"),
                   help="l1 and elastic_net fit with owlqn")
    p.add_argument("--reg-weights", default="1.0",
                   help="comma-separated sweep of regularization weights")
    p.add_argument("--elastic-net-alpha", type=float, default=0.5)
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                   help="storage dtype of the FEATURE VALUES (labels, weights, "
                   "coefficients and all arithmetic stay float32); bfloat16 "
                   "halves the value stream the sparse hot loop reads")
    p.add_argument("--normalization", default="none", choices=NORMALIZATION_TYPES)
    p.add_argument("--evaluators", default=None,
                   help="comma-separated evaluator names; default per task")
    p.add_argument("--variance-computation", default="none",
                   choices=("none", "simple", "full"))
    p.add_argument("--model-format", default="avro", choices=("avro", "json"))
    p.add_argument("--sweep-warm-start", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="start each regularization weight's fit from the "
                   "previous weight's solution")
    p.add_argument("--save-all-models", action="store_true",
                   help="write every sweep model, not just the best")
    p.add_argument("--checkpoint-dir", default=None,
                   help="one completed snapshot per finished regularization "
                   "weight, published atomically here")
    p.add_argument("--resume", default=None, metavar="auto|latest",
                   help="rebuild finished weights from --checkpoint-dir "
                   "without refitting; 'latest' requires a published "
                   "snapshot")
    p.add_argument("--checkpoint-async", default=None, choices=("on", "off"),
                   help="publish checkpoints from a background thread "
                   "(default on, or PHOTON_CHECKPOINT_ASYNC); 'off' writes "
                   "inline")
    p.add_argument("--checkpoint-max-staged-mb", type=float, default=None,
                   help="a snapshot staging more than this many MB publishes "
                   "blocking (PHOTON_CHECKPOINT_MAX_STAGED_MB; default "
                   "unbounded)")
    p.add_argument("--stream", action="store_true",
                   help="host-streamed training for data beyond device "
                   "memory: --input is a glob or directory of LIBSVM files, "
                   "each re-parsed per objective evaluation (lbfgs with l2 "
                   "or none)")
    p.add_argument("--feature-dim", type=int, default=None,
                   help="with --stream: the known feature dimension; skips "
                   "the metadata parse for a row/nnz scan")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="with --stream and --checkpoint-dir: a mid-fit "
                   "snapshot every N L-BFGS iterations (the resident sweep "
                   "snapshots each finished weight and ignores this)")
    p.add_argument("--data-validation", default="error",
                   choices=("error", "warn", "off"),
                   help="label and feature checks before training, over the "
                   "loaded batch or, with --stream, the part files (the "
                   "reference's DataValidators strictness)")
    common.add_fault_args(p)
    common.add_telemetry_arg(p)
    return p


def run(args: argparse.Namespace) -> dict:
    device = common.device_for_backend(args.backend)
    logger = common.RunLogger("photon_tpu_torch.train", args.log_file)
    os.makedirs(args.output_dir, exist_ok=True)
    with common.telemetry_run(args, "train", logger, preemptible=True) as session:
        if args.resume and not args.checkpoint_dir:
            raise ValueError("--resume needs --checkpoint-dir")
        if args.resume == "latest":
            from photon_tpu_torch.fault.checkpoint import has_published_checkpoint

            if not has_published_checkpoint(args.checkpoint_dir):
                raise ValueError(
                    f"--resume latest: no published checkpoint under "
                    f"{args.checkpoint_dir!r}")
        if args.stream:
            return _train_streaming(args, device, logger, session)
        return _train(args, device, logger, session)


def _train_streaming(args, device, logger, session) -> dict:
    """The host-streamed weight sweep (lbfgs; data beyond device memory)."""
    import glob as globmod

    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import (
        OptimizationStatesTracker,
        OptimizerConfig,
    )
    from photon_tpu_torch.data.index_map import IndexMap, feature_key
    from photon_tpu_torch.data.stream_layouts import stream_kernel, stream_kernel_why
    from photon_tpu_torch.data.streaming import (
        LibsvmFileSource,
        StreamingObjective,
        streaming_lbfgs,
    )
    from photon_tpu_torch.evaluation.evaluators import (
        MultiEvaluator,
        default_evaluators_for_task,
    )
    from photon_tpu_torch.fault.checkpoint import StreamCheckpointer, require_fingerprint
    from photon_tpu_torch.models.glm import Coefficients, model_for_task

    if args.normalization != "none":
        raise ValueError("--stream does not support --normalization")
    if args.dtype != "float32":
        raise ValueError("--stream does not support --dtype yet")
    if args.optimizer != "lbfgs" or args.reg_type in ("l1", "elastic_net"):
        raise ValueError("--stream supports the lbfgs optimizer with l2/none "
                         "regularization")
    if os.path.isdir(args.input):
        files = sorted(os.path.join(args.input, f) for f in os.listdir(args.input)
                       if not f.startswith((".", "_")))
    else:
        files = sorted(globmod.glob(args.input)) or [args.input]
    with logger.timed("scan-metadata"):
        source = LibsvmFileSource(
            files, intercept=args.intercept,
            binary_labels=args.task in BINARY_TASKS,
            feature_dim=args.feature_dim, telemetry=session, device=device,
        )
    kernel = stream_kernel()
    logger.info("streaming %d files, %d rows, dim %d, nnz capacity %d, route %s",
                len(files), source.num_examples, source.dim, source.capacity, kernel)
    session.gauge("train.num_examples").set(source.num_examples)
    session.gauge("train.num_features").set(source.dim)
    session.gauge("train.stream_files").set(len(source.files))
    if args.data_validation != "off":
        with logger.timed("validate-data"):
            _validate_stream_files(source.files, args, logger, session)
    val_batch = common.load_validation(
        args.validation_input, source.dim, args.intercept, args.task, device)
    if args.evaluators:
        evaluators = common.build_flat_evaluators(args.evaluators)
    else:
        evaluators = MultiEvaluator(default_evaluators_for_task(args.task))
    opt_config = OptimizerConfig(
        max_iterations=args.max_iterations, tolerance=args.tolerance
    )
    sweep = []
    w_start = torch.zeros(source.dim, dtype=torch.float32, device=device)
    for i, lam in enumerate(common.parse_weights_list(args.reg_weights)):
        reg = RegularizationContext(args.reg_type, lam, args.elastic_net_alpha)
        objective = StreamingObjective(
            GlmObjective.create(args.task, reg), source.chunk_iter_factory)
        # What makes a snapshot this fit's state (the reference's keys, so
        # either package resumes the other's chain); the iteration budget is
        # left out: a resume with more iterations continues the fit.
        fingerprint = {
            "kind": StreamCheckpointer.KIND, "task": args.task,
            "reg_type": args.reg_type, "lambda": lam,
            "alpha": args.elastic_net_alpha, "dim": int(source.dim),
            "num_examples": int(source.num_examples),
            "intercept": bool(args.intercept),
            "warm_start": bool(args.sweep_warm_start),
            "history_length": int(opt_config.history_length),
            "tolerance": float(opt_config.tolerance),
        }
        checkpointer = resume_state = None
        if args.checkpoint_dir:
            checkpointer = StreamCheckpointer(
                os.path.join(args.checkpoint_dir, f"lam-{i:03d}"),
                telemetry=session, logger=logger,
                async_publish=args.checkpoint_async,
                max_staged_mb=args.checkpoint_max_staged_mb,
            )
            if args.resume:
                resume_state = require_fingerprint(
                    checkpointer.load("auto"), fingerprint, f"lambda={lam:g}")
        with logger.timed(f"train-lambda-{lam}"), \
                common.maybe_profile(args.profile_dir, f"train-lambda-{lam:g}"):
            t0 = time.monotonic()
            result = streaming_lbfgs(
                objective, w_start, opt_config, checkpointer=checkpointer,
                checkpoint_every=max(1, args.checkpoint_every),
                resume_state=resume_state, fingerprint=fingerprint,
            )
            wall = time.monotonic() - t0
        if args.sweep_warm_start:
            w_start = result.w
        tracker = OptimizationStatesTracker(result, wall)
        logger.info("lambda=%g %s", lam, tracker.summary().splitlines()[0])
        model = model_for_task(args.task, Coefficients(result.w))
        metrics = {}
        if val_batch is not None:
            metrics = evaluators.evaluate(
                model.compute_score(val_batch), val_batch.label, val_batch.weight)
            logger.info("lambda=%g validation %s", lam, metrics)
        sweep.append({
            "lambda": lam, "model": model, "metrics": metrics,
            "iterations": tracker.iterations,
            "convergence_reason": tracker.convergence_reason,
            "wall_time_s": wall, "final_value": float(result.value),
            "last_kernel": objective.last_kernel,
            "states": tracker.states(),
        })
    index_map = IndexMap.build(
        [feature_key(f"f{j}") for j in range(source.feature_dim)],
        intercept=args.intercept,
    )
    return common.select_and_save_sweep(
        sweep, evaluators, val_batch is not None, index_map, args, logger,
        extra_summary={
            "optimizer": "lbfgs", "streaming": True,
            "stream_kernel": kernel, "stream_kernel_why": stream_kernel_why(kernel),
            "stream_files": len(source.files), "num_examples": source.num_examples,
            "backend": args.backend,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
        },
    )


def _validate_stream_files(files, args, logger, session) -> None:
    """The streamed data's validation: labels and feature values of every
    part file, on the host from the raw parses (files on the host-IO pool,
    issues in file order, at most 4 parses in flight)."""
    import numpy as np

    from photon_tpu_torch.data.libsvm import (
        normalize_binary_labels,
        parse_csr_or_none,
        parse_libsvm,
    )
    from photon_tpu_torch.data.validation import (
        _feature_issues,
        apply_validation,
        validate_columns,
    )
    from photon_tpu_torch.utils.io_pool import io_threads, map_ordered

    def file_issues(path):
        csr = parse_csr_or_none(path)
        if csr is not None:
            labels, _, _, values, _ = csr
        else:
            data = parse_libsvm(path)
            labels = data.labels
            values = (np.concatenate([v for _, v in data.rows]) if data.rows
                      else np.zeros(0, np.float32))
        if args.task in BINARY_TASKS:
            labels = normalize_binary_labels(labels)
        out = list(validate_columns(labels, None, None, args.task))
        if values.size:
            out.extend(_feature_issues(values.reshape(-1, 1), os.path.basename(path)))
        return out

    issues = []
    for found in map_ordered(file_issues, files, workers=min(io_threads(), 4),
                             telemetry=session):
        issues.extend(found)
    apply_validation(issues, args.data_validation, logger)


def _train(args, device, logger, session) -> dict:
    from photon_tpu_torch.core.normalization import NormalizationContext
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import (
        OptimizationStatesTracker,
        OptimizerConfig,
    )
    from photon_tpu_torch.core.optimizers.base import OptimizerResult
    from photon_tpu_torch.core.problem import GlmOptimizationProblem, ProblemConfig
    from photon_tpu_torch.core.stats import BasicStatisticalSummary
    from photon_tpu_torch.data.batch import SparseBatch, attach_feature_major, batch_astype
    from photon_tpu_torch.evaluation.evaluators import (
        MultiEvaluator,
        default_evaluators_for_task,
    )
    from photon_tpu_torch.fault.checkpoint import (
        StreamCheckpointer,
        StreamState,
        require_fingerprint,
    )
    from photon_tpu_torch.fault.preemption import (
        PreemptedError,
        consume_preempt_injection,
        preemption_reason,
        preemption_requested,
    )
    from photon_tpu_torch.models.glm import Coefficients, model_for_task
    from photon_tpu_torch.ops.sparse_grad_select import aligned_layout_wanted

    with logger.timed("load-data"):
        batch, dim, index_map = common.load_dataset(
            args.input, args.intercept, args.task, device,
            avro_field=args.avro_feature_field,
        )
        reader = common.input_reader(args.input)
        val_batch = common.load_validation(
            args.validation_input, dim, args.intercept, args.task, device,
            avro_field=args.avro_feature_field, index_map=index_map,
        )
        logger.info("train: %d examples, %d features on %s (%s reader)",
                    batch.num_examples, dim, device, reader)
    if args.data_validation != "off":
        from photon_tpu_torch.data.validation import apply_validation, validate_batch

        with logger.timed("validate-data"):
            apply_validation(validate_batch(batch, args.task),
                             args.data_validation, logger)
    norm = None
    if args.normalization != "none":
        with logger.timed("summarize"):
            norm = NormalizationContext.build(
                args.normalization, BasicStatisticalSummary.from_batch(batch, dim),
                intercept_id=index_map.intercept_id,
            )
    if isinstance(batch, SparseBatch):
        with logger.timed("attach-layouts"):
            batch = attach_feature_major(
                batch,
                aligned_dim=(dim if aligned_layout_wanted(batch.ids.numel(), device)
                             else None),
            )
    if args.dtype != "float32":
        # After the normalization statistics (they read full-precision
        # values) and after the layout attach (the conversion carries every
        # layout's values along, so nothing is rebuilt).
        batch = batch_astype(batch, args.dtype)
        logger.info("feature values stored as %s (float32 arithmetic)", args.dtype)
    if args.evaluators:
        evaluators = common.build_flat_evaluators(args.evaluators)
    else:
        evaluators = MultiEvaluator(default_evaluators_for_task(args.task))
    opt_config = OptimizerConfig(
        max_iterations=args.max_iterations, tolerance=args.tolerance
    )
    optimizer = args.optimizer
    if args.reg_type in ("l1", "elastic_net") and optimizer != "owlqn":
        logger.warning("reg-type %s requires owlqn; switching optimizer", args.reg_type)
        optimizer = "owlqn"
    sweep = []
    w_start = torch.zeros(dim, dtype=torch.float32, device=device)
    publishers = []  # every weight's checkpointer, drained before returning
    try:
        for i, lam in enumerate(common.parse_weights_list(args.reg_weights)):
            # The preemption boundary: between weights.  Every finished weight
            # is already checkpointed, so stopping here loses nothing once the
            # publisher drains.  The ``preempt`` fault site counts weights as
            # its iterations.
            consume_preempt_injection(i)
            if preemption_requested():
                for checkpointer in publishers:
                    checkpointer.drain()
                hint = ("resume with --resume auto" if args.checkpoint_dir
                        else "no --checkpoint-dir — a restart begins from scratch")
                raise PreemptedError(
                    f"preempted ({preemption_reason()}) before lambda={lam:g}; {hint}")
            reg = RegularizationContext(args.reg_type, lam, args.elastic_net_alpha)
            # What makes a snapshot this weight's completed fit (the
            # reference's keys; max_iterations is pinned: only final states
            # are saved, so a raised budget refits).
            fingerprint = {
                "kind": StreamCheckpointer.KIND, "path": "resident",
                "task": args.task, "optimizer": optimizer, "reg_type": args.reg_type,
                "lambda": lam, "alpha": args.elastic_net_alpha, "dim": int(dim),
                "num_examples": int(batch.num_examples),
                "intercept": bool(args.intercept),
                "normalization": args.normalization, "dtype": args.dtype,
                "variance": args.variance_computation,
                "warm_start": bool(args.sweep_warm_start),
                "max_iterations": int(opt_config.max_iterations),
                "tolerance": float(opt_config.tolerance),
            }
            checkpointer = resume_state = None
            if args.checkpoint_dir:
                checkpointer = StreamCheckpointer(
                    os.path.join(args.checkpoint_dir, f"lam-{i:03d}"),
                    telemetry=session, logger=logger,
                    async_publish=args.checkpoint_async,
                    max_staged_mb=args.checkpoint_max_staged_mb,
                )
                publishers.append(checkpointer)
                if args.resume:
                    resume_state = require_fingerprint(
                        checkpointer.load("auto"), fingerprint, f"lambda={lam:g}")
            if resume_state is not None and resume_state.completed:
                # A finished weight: the model and its convergence record from
                # the snapshot, no solve; the solver-space iterate keeps the
                # warm-start chain of the uninterrupted sweep.
                saved = resume_state.arrays
                result = OptimizerResult(
                    w=torch.as_tensor(saved["w_opt"], device=device),
                    value=float(resume_state.scalars["f"]),
                    grad_norm=float(resume_state.scalars["gnorm"]),
                    iterations=int(resume_state.iteration),
                    converged=bool(resume_state.scalars.get("converged", False)),
                    reason=int(resume_state.reason),
                    history_value=saved["hv"], history_grad_norm=saved["hg"],
                    history_valid=saved["hvalid"].astype(bool),
                    host_reads=0, evaluations=0,
                )
                wall = 0.0
                coefficients = Coefficients(
                    torch.as_tensor(saved["means"], device=device),
                    (torch.as_tensor(saved["variances"], device=device)
                     if "variances" in saved else None))
                session.counter("train.lambdas_resumed").inc()
                logger.info("lambda=%g restored from completed checkpoint (no refit)", lam)
            else:
                problem = GlmOptimizationProblem(
                    GlmObjective.create(args.task, reg, normalization=norm),
                    ProblemConfig(optimizer=optimizer, regularization=reg,
                                  optimizer_config=opt_config,
                                  variance_computation=args.variance_computation),
                )
                with logger.timed(f"train-lambda-{lam}"), \
                        common.maybe_profile(args.profile_dir,
                                             f"train-lambda-{lam:g}"):
                    t0 = time.monotonic()
                    coefficients, result = problem.run(batch, w_start)
                    wall = time.monotonic() - t0
                if checkpointer is not None:
                    saved = {
                        # The solver-space iterate (the warm-start chain) and
                        # the original-space model, with the history buffers.
                        "w_opt": result.w, "means": coefficients.means,
                        "hv": result.history_value, "hg": result.history_grad_norm,
                        "hvalid": result.history_valid,
                    }
                    if coefficients.variances is not None:
                        saved["variances"] = coefficients.variances
                    checkpointer.save(StreamState(
                        iteration=int(result.iterations), arrays=saved,
                        scalars={"f": float(result.value),
                                 "gnorm": float(result.grad_norm),
                                 "converged": bool(result.converged)},
                        completed=True, reason=int(result.reason),
                        fingerprint=fingerprint,
                    ))
            if args.sweep_warm_start:
                w_start = result.w  # the optimizer's (normalized) space
            tracker = OptimizationStatesTracker(result, wall)
            logger.info("lambda=%g %s", lam, tracker.summary().splitlines()[0])
            model = model_for_task(args.task, coefficients)
            metrics = {}
            if val_batch is not None:
                metrics = evaluators.evaluate(
                    model.compute_score(val_batch), val_batch.label, val_batch.weight
                )
                logger.info("lambda=%g validation %s", lam, metrics)
            sweep.append({
                "lambda": lam, "model": model, "metrics": metrics,
                "iterations": tracker.iterations,
                "convergence_reason": tracker.convergence_reason,
                "wall_time_s": wall, "final_value": float(result.value),
                "evaluations": result.evaluations, "host_reads": result.host_reads,
                "zero_coefficients": int((coefficients.means == 0).sum()),
                "states": tracker.states(),
            })
    except BaseException:
        for checkpointer in publishers:
            checkpointer.drain(reraise=False)
        raise
    for checkpointer in publishers:
        checkpointer.drain()
    return common.select_and_save_sweep(
        sweep, evaluators, val_batch is not None, index_map, args, logger,
        extra_summary={
            "optimizer": optimizer,
            "normalization": args.normalization,
            "dtype": args.dtype,
            "input_reader": reader,
            "backend": args.backend,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
        },
    )


def main(argv=None) -> None:
    common.run_cli(run, build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
