"""Single-model GLM training driver.

Counterpart of the resident single-process path of
``photon_tpu/drivers/train.py``: read LIBSVM data, sweep the regularization
weights with L-BFGS (optionally warm-starting each weight from the last),
evaluate each model on the validation data, keep the best, and write the
model, the feature index and ``training_summary.json``.

Usage:
    python -m photon_tpu_torch.drivers.train \\
        --input a1a.libsvm --validation-input a1a.t.libsvm \\
        --task logistic_regression --optimizer lbfgs --reg-type l2 \\
        --reg-weights 0.1,1,10 --evaluators AUC,LOGISTIC_LOSS \\
        --output-dir out --backend gpu

Not carried in this slice (ROADMAP.md queue 1): other optimizers and L1
(item 3), normalization and variances (items 2-3), streaming, checkpoints,
multi-process runs, fault injection and telemetry (items 6 and 9-10).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

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
    p.add_argument("--optimizer", default="lbfgs", choices=("lbfgs",),
                   help="lbfgs (OWL-QN and TRON wait in ROADMAP.md queue 1, item 3)")
    p.add_argument("--reg-type", default="l2", choices=("none", "l2"),
                   help="none or l2 (L1 and elastic net need OWL-QN, ROADMAP.md "
                   "queue 1, item 3)")
    p.add_argument("--reg-weights", default="1.0",
                   help="comma-separated sweep of regularization weights")
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument("--evaluators", default=None,
                   help="comma-separated evaluator names; default per task")
    p.add_argument("--model-format", default="avro", choices=("avro", "json"))
    p.add_argument("--sweep-warm-start", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="start each regularization weight's fit from the "
                   "previous weight's solution")
    return p


def run(args: argparse.Namespace) -> dict:
    from photon_tpu_torch.core.objective import GlmObjective, RegularizationContext
    from photon_tpu_torch.core.optimizers import (
        OptimizationStatesTracker,
        OptimizerConfig,
    )
    from photon_tpu_torch.core.problem import GlmOptimizationProblem, ProblemConfig
    from photon_tpu_torch.data.batch import attach_feature_major
    from photon_tpu_torch.evaluation.evaluators import (
        MultiEvaluator,
        default_evaluators_for_task,
    )
    from photon_tpu_torch.models.glm import Coefficients, model_for_task
    from photon_tpu_torch.ops.sparse_grad_select import aligned_layout_wanted

    device = common.device_for_backend(args.backend)
    logger = common.RunLogger("photon_tpu_torch.train")
    os.makedirs(args.output_dir, exist_ok=True)
    with logger.timed("load-data"):
        batch, dim, index_map = common.load_dataset(
            args.input, args.intercept, args.task, device
        )
        val_batch = common.load_validation(
            args.validation_input, dim, args.intercept, args.task, device
        )
        logger.info("train: %d examples, %d features on %s",
                    batch.num_examples, dim, device)
    with logger.timed("attach-layouts"):
        batch = attach_feature_major(
            batch, aligned_dim=dim if aligned_layout_wanted() else None
        )
    if args.evaluators:
        evaluators = common.build_flat_evaluators(args.evaluators)
    else:
        evaluators = MultiEvaluator(default_evaluators_for_task(args.task))
    opt_config = OptimizerConfig(
        max_iterations=args.max_iterations, tolerance=args.tolerance
    )
    sweep = []
    w_start = torch.zeros(dim, dtype=torch.float32, device=device)
    for lam in common.parse_weights_list(args.reg_weights):
        reg = RegularizationContext(args.reg_type, lam)
        problem = GlmOptimizationProblem(
            GlmObjective.create(args.task, reg),
            ProblemConfig(optimizer=args.optimizer, regularization=reg,
                          optimizer_config=opt_config),
        )
        with logger.timed(f"train-lambda-{lam}"):
            t0 = time.monotonic()
            coefficients, result = problem.run(batch, w_start)
            wall = time.monotonic() - t0
        if args.sweep_warm_start:
            w_start = coefficients.means
        tracker = OptimizationStatesTracker(result, wall)
        logger.info("lambda=%g %s", lam, tracker.summary().splitlines()[0])
        model = model_for_task(args.task, Coefficients(coefficients.means))
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
            "states": tracker.states(),
        })
    return common.select_and_save_sweep(
        sweep, evaluators, val_batch is not None, index_map, args, logger,
        extra_summary={
            "optimizer": args.optimizer,
            "backend": args.backend,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
        },
    )


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
