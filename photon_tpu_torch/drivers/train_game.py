"""GAME training driver.

Counterpart of the resident single-device path of
``photon_tpu/drivers/train_game.py``: read Avro training data (feature bags
and entity-id columns) or a ``synthetic-game:`` spec, build the coordinates,
run the regularization sweep through ``GameEstimator`` (coordinate descent
over a fixed effect and per-entity random effects), evaluate on the
validation data, and write the best GAME model and
``training_summary.json``:

    python -m photon_tpu_torch.drivers.train_game \\
        --input train.avro --task logistic_regression \\
        --feature-bags global=global,per_user=per_user --id-columns userId \\
        --coordinate fixed:type=fixed,shard=global,max_iters=30 \\
        --coordinate per_user:type=random,shard=per_user,entity=userId \\
        --descent-iterations 2 --validation-split 0.2 --output-dir out

Coordinate specs are ``name:key=value,...`` (or one ``@file.json``); keys:
``type`` (fixed|random), ``shard``, ``entity`` (random), ``optimizer``
(lbfgs|tron; random-effect bins solve by batched Newton), ``reg_type``
(none|l2), ``reg_weights`` (a ``+``-joined sweep), ``max_iters``,
``tolerance``, ``variance`` (none|simple|full), ``active_row_cap``
(random), ``seed``.  The sweep is the cross product of every coordinate's
``reg_weights``.  ``--backend gpu`` (the default) runs on the card and
fails without one; ``--backend cpu`` runs on the host.

Flags of the reference that the port does not carry yet raise, naming
their ROADMAP.md queue 1 item: streaming (9), checkpoints and fault flags
(6), tuning and multi-process runs (10), ``--dtype`` other than float32
(9), warm start and locked coordinates (5), and the coordinate keys
``type=factored_random``, ``projection`` (5), ``row_split`` (10),
``downsample`` (4) and L1 regularization (3).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import torch

from photon_tpu_torch.drivers import common

# (flag, its ROADMAP.md queue 1 item, what waits there): given at all,
# each raises.
_NOT_PORTED = (
    ("stream_chunks", 9, "streamed GAME training"),
    ("max_resident_mb", 9, "streamed GAME training"),
    ("max_host_mb", 9, "the disk-backed tile store"),
    ("spill_dir", 9, "the disk-backed tile store"),
    ("tile_dtype", 9, "the disk-backed tile store"),
    ("checkpoint", 6, "per-iteration model checkpoints"),
    ("checkpoint_dir", 6, "descent checkpointing"),
    ("resume", 6, "descent checkpointing"),
    ("faults", 6, "fault injection"),
    ("stall_timeout", 6, "the run watchdog"),
    ("tuning", 10, "hyperparameter tuning"),
    ("coordinator", 10, "multi-process runs"),
    ("initial_model", 5, "GAME warm starts"),
    ("locked_coordinates", 5, "locked coordinates"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "photon_tpu_torch.drivers.train_game", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_common_args(p)
    p.add_argument("--input", required=True,
                   help="training data: Avro file/dir/glob, or "
                   "synthetic-game:<entities>:<rows_mean>:<fixed_dim>:"
                   "<random_dim>[:n_random[:seed]]")
    p.add_argument("--validation-input", default=None,
                   help="validation data (same format as --input)")
    p.add_argument("--validation-split", type=float, default=None,
                   help="fraction of --input rows held out for validation")
    p.add_argument("--feature-bags", default=None,
                   help="shard=recordField pairs, comma separated (Avro input)")
    p.add_argument("--id-columns", default=None,
                   help="entity id columns to read, comma separated (Avro input)")
    p.add_argument("--index-maps", default=None,
                   help="directory of feature_index_<shard>.json maps; features "
                   "absent from a map are dropped")
    p.add_argument("--data-validation", default="error",
                   choices=("error", "warn", "off"),
                   help="row sanity checks before training")
    p.add_argument("--task", default="logistic_regression",
                   choices=("logistic_regression", "linear_regression",
                            "poisson_regression", "smoothed_hinge_loss_linear_svm"))
    p.add_argument("--coordinate", action="append", required=True,
                   dest="coordinates", metavar="NAME:K=V,...",
                   help="one per coordinate, in update order; or one @configs.json")
    p.add_argument("--descent-iterations", type=int, default=1)
    p.add_argument("--residuals", default=None, choices=("auto", "device", "host"),
                   help="residual passing: 'device' (auto) keeps the score "
                   "table on the device, 'host' accumulates in float64 on "
                   "the host; overrides PHOTON_RESIDUALS")
    p.add_argument("--validation-pipeline", default=None,
                   choices=("auto", "device", "host"),
                   help="validation scoring: 'device' re-scores only the "
                   "retrained coordinate and reads the metrics once per "
                   "iteration, 'host' scores the whole model on the host; "
                   "'auto' follows --residuals")
    p.add_argument("--evaluators", default=None,
                   help="comma-separated evaluator names; default per task")
    p.add_argument("--model-format", default="avro", choices=("avro", "json"))
    p.add_argument("--save-all-models", action="store_true")
    p.add_argument("--max-quarantined", type=int, default=8,
                   help="non-finite solves/score rows a run may quarantine "
                   "before it fails; -1 = unlimited")
    p.add_argument("--dtype", default="float32",
                   help="feature value storage (only float32 is ported)")
    for flag, item, what in _NOT_PORTED:
        p.add_argument("--" + flag.replace("_", "-"), default=None,
                       help=f"not ported: {what} (ROADMAP.md queue 1, item {item})")
    return p


_KNOWN_COORDINATE_KEYS = {
    "type", "shard", "entity", "optimizer", "reg_type", "reg_weights",
    "alpha", "max_iters", "tolerance", "variance", "active_row_cap",
    "downsample", "downsampler", "projection", "projected_dim", "seed",
    "row_split", "latent_dim", "latent_iterations",
}


def _validate_coordinate(name: str, kv: dict, origin: str) -> tuple[str, dict]:
    unknown = set(kv) - _KNOWN_COORDINATE_KEYS
    if unknown:
        raise ValueError(f"unknown coordinate key(s) {sorted(unknown)} in {origin}")
    kind = kv.get("type", "fixed")
    if kind == "factored_random":
        raise NotImplementedError(
            "factored random effects wait in ROADMAP.md queue 1, item 5")
    if kind not in ("fixed", "random"):
        raise ValueError(f"coordinate type must be fixed|random in {origin}")
    if "shard" not in kv:
        raise ValueError(f"coordinate {name!r} needs shard=<feature shard>")
    if kind == "random" and "entity" not in kv:
        raise ValueError(f"random coordinate {name!r} needs entity=<id column>")
    return name, kv


def parse_coordinate_spec(spec: str) -> tuple[str, dict]:
    """``name:key=value,...`` -> (name, dict); raises on unknown keys."""
    name, _, body = spec.partition(":")
    if not name or not body:
        raise ValueError(f"bad coordinate spec {spec!r} (want name:key=value,...)")
    kv = {}
    for tok in body.split(","):
        k, _, v = tok.partition("=")
        kv[k.strip()] = v.strip()
    return _validate_coordinate(name, kv, repr(spec))


def _coordinate_specs(args) -> list[tuple[str, dict]]:
    if len(args.coordinates) == 1 and args.coordinates[0].startswith("@"):
        path = args.coordinates[0][1:]
        with open(path) as f:
            payload = json.load(f)
        return [_validate_coordinate(c.pop("name"), c, f"{path} entry {i}")
                for i, c in enumerate(payload)]
    return [parse_coordinate_spec(s) for s in args.coordinates]


def _coord_bool(value) -> bool:
    if isinstance(value, bool):
        return value
    s = str(value).strip().lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no"):
        return False
    raise ValueError(f"coordinate-spec boolean must be true/false/1/0/yes/no, got {value!r}")


def _coord_config(kv: dict, lam: float):
    """One coordinate's config with regularization weight ``lam``."""
    from photon_tpu_torch.core.objective import RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import ProblemConfig
    from photon_tpu_torch.game.coordinate import (
        FixedEffectCoordinateConfig,
        RandomEffectCoordinateConfig,
    )

    reg_type = kv.get("reg_type", "l2")
    optimizer = kv.get("optimizer", "lbfgs")
    if reg_type in ("l1", "elastic_net"):
        optimizer = "owlqn"  # raises in ProblemConfig, naming item 3
    problem = ProblemConfig(
        optimizer=optimizer,
        regularization=RegularizationContext(reg_type, lam, float(kv.get("alpha", 0.5))),
        optimizer_config=OptimizerConfig(
            max_iterations=int(kv.get("max_iters", 50)),
            tolerance=float(kv.get("tolerance", 1e-7)),
        ),
        variance_computation=kv.get("variance", "none"),
    )
    if kv.get("type", "fixed") == "fixed":
        if _coord_bool(kv.get("row_split", False)):
            raise ValueError("row_split applies to random coordinates only")
        return FixedEffectCoordinateConfig(
            shard_name=kv["shard"], problem=problem,
            downsampling_rate=float(kv.get("downsample", 1.0)),
            seed=int(kv.get("seed", 0)),
        )
    cap = kv.get("active_row_cap")
    pdim = kv.get("projected_dim")
    return RandomEffectCoordinateConfig(
        shard_name=kv["shard"], entity_column=kv["entity"], problem=problem,
        active_row_cap=None if cap in (None, "") else int(cap),
        projection=kv.get("projection", "none"),
        projected_dim=None if pdim in (None, "") else int(pdim),
        seed=int(kv.get("seed", 0)),
        row_split=_coord_bool(kv.get("row_split", False)),
    )


def _combo_label(specs, combo) -> str:
    return ",".join(f"{name}={lam:g}" for (name, _), lam in zip(specs, combo))


def _build_sweep(specs) -> list:
    """Cross product of per-coordinate reg weights -> (label, coords)."""
    weight_lists = [[float(w) for w in str(kv.get("reg_weights", "1.0")).split("+")]
                    for _, kv in specs]
    return [
        (_combo_label(specs, combo),
         {name: _coord_config(kv, lam) for (name, kv), lam in zip(specs, combo)})
        for combo in itertools.product(*weight_lists)
    ]


def parse_feature_bags(feature_bags: str) -> dict:
    """--feature-bags 'shard=field,...' -> dict."""
    return dict(tok.split("=", 1) for tok in feature_bags.split(","))


def _load_game_data(spec: str, args, index_maps=None):
    """(dataset, index_maps) from an input spec (Avro or synthetic-game)."""
    if spec.startswith("synthetic-game:"):
        from photon_tpu_torch.data.synthetic import make_game_dataset

        parts = spec.split(":")
        n_e, rows, fdim, rdim = (int(x) for x in parts[1:5])
        n_random = int(parts[5]) if len(parts) > 5 else 1
        seed = int(parts[6]) if len(parts) > 6 else 0
        data, maps = make_game_dataset(n_e, rows, fdim, rdim, seed=seed,
                                       n_random_coords=n_random)
        if index_maps is not None:
            for name, imap in maps.items():
                other = index_maps.get(name)
                if other is not None and list(other.keys()) != list(imap.keys()):
                    raise ValueError(
                        f"index map for shard {name!r} does not match the "
                        "synthetic-game feature layout")
        return data, (index_maps or maps)
    from photon_tpu_torch.data.game_io import read_game_avro

    if not args.feature_bags or not args.id_columns:
        raise ValueError("Avro input needs --feature-bags and --id-columns")
    bags = parse_feature_bags(args.feature_bags)
    id_cols = [c.strip() for c in args.id_columns.split(",") if c.strip()]
    return read_game_avro(spec, bags, id_cols, index_maps=index_maps)


def _reject_not_ported(args) -> None:
    for flag, item, what in _NOT_PORTED:
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: {what} waits in ROADMAP.md "
                f"queue 1, item {item}")
    if args.dtype != "float32":
        raise NotImplementedError(
            f"--dtype {args.dtype}: feature storage other than float32 waits "
            "in ROADMAP.md queue 1, item 9")


def run(args: argparse.Namespace) -> dict:
    from photon_tpu_torch.data.validation import apply_validation, validate_game_dataset
    from photon_tpu_torch.evaluation.evaluators import (
        MultiEvaluator,
        default_evaluators_for_task,
    )
    from photon_tpu_torch.game.data import split_game_dataset
    from photon_tpu_torch.game.estimator import (
        GameEstimator,
        GameOptimizationConfiguration,
    )
    from photon_tpu_torch.game.model_io import save_game_model

    _reject_not_ported(args)
    device = common.device_for_backend(args.backend)
    logger = common.RunLogger("photon_tpu_torch.train_game")
    os.makedirs(args.output_dir, exist_ok=True)
    specs = _coordinate_specs(args)
    sweep = _build_sweep(specs)

    prebuilt_maps = None
    if args.index_maps:
        if not args.feature_bags:
            raise ValueError("--index-maps needs --feature-bags")
        from photon_tpu_torch.data.index_map import IndexMap

        prebuilt_maps = {
            shard: IndexMap.load(os.path.join(args.index_maps,
                                              f"feature_index_{shard}.json"))
            for shard in parse_feature_bags(args.feature_bags)
        }
    with logger.timed("load-data"):
        data, index_maps = _load_game_data(args.input, args, index_maps=prebuilt_maps)
        val_data = None
        if args.validation_input:
            val_data, _ = _load_game_data(args.validation_input, args,
                                          index_maps=index_maps)
        elif args.validation_split:
            data, val_data = split_game_dataset(data, args.validation_split)
        logger.info("train: %d examples, shards %s on %s", data.num_examples,
                    {n: s.dim for n, s in data.shards.items()}, device)
    if args.data_validation != "off":
        apply_validation(validate_game_dataset(data, args.task),
                         args.data_validation, logger)
    if args.evaluators:
        evaluators = common.build_flat_evaluators(args.evaluators)
    else:
        evaluators = MultiEvaluator(default_evaluators_for_task(args.task))
    estimator = GameEstimator(
        args.task, data, validation_data=val_data,
        evaluators=evaluators if val_data is not None else None,
        device=device, logger=logger, residual_mode=args.residuals,
        validation_mode=args.validation_pipeline,
    )
    max_quarantined = None if args.max_quarantined < 0 else args.max_quarantined
    results = []
    for label, coords in sweep:
        config = GameOptimizationConfiguration(
            coordinates=coords, descent_iterations=args.descent_iterations,
            name=label)
        with logger.timed(f"fit-{label}"):
            result = estimator.fit([config], max_quarantined=max_quarantined)[0]
        results.append(result)
        if args.save_all_models:
            save_game_model(os.path.join(args.output_dir, f"model_{label}"),
                            result.model, index_maps, fmt=args.model_format)
    best = estimator.select_best(results)
    with logger.timed("save-model"):
        save_game_model(os.path.join(args.output_dir, "best_model"), best.model,
                        index_maps, fmt=args.model_format)
    summary = {
        "task": args.task,
        "best_configuration": best.configuration.name,
        "best_metrics": best.metrics,
        "sweep": [
            {
                "configuration": r.configuration.name,
                "metrics": r.metrics,
                "history": [
                    {key: h[key] for key in ("iteration", "metrics", "seconds", "solver",
                                             "residual_updates", "host_syncs")}
                    for h in r.descent.history
                ],
            }
            for r in results
        ],
        "phase_times": logger.phase_times,
        "backend": args.backend,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    with open(os.path.join(args.output_dir, "training_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    logger.info("best configuration %s -> %s/best_model",
                best.configuration.name, args.output_dir)
    return summary


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
