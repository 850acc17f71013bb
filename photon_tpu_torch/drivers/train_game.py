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
``type`` (fixed|random|factored_random), ``shard``, ``entity`` (random),
``optimizer`` (lbfgs|tron|newton_cg; random-effect bins take the route
``game/batched_solve.solver_route`` gives them), ``reg_type`` (none|l2;
l1 and elastic_net, with ``alpha``, fit with OWL-QN), ``reg_weights`` (a
``+``-joined sweep), ``max_iters``, ``tolerance``, ``variance``
(none|simple|full), ``active_row_cap`` (random), ``projection``
(none|index_map|random) and ``projected_dim`` (random), ``latent_dim`` and
``latent_iterations`` (factored_random), ``downsample`` and
``downsampler`` (fixed: default|binary, by default the task's), ``seed``.
The sweep is the cross product of every coordinate's ``reg_weights``.
``--initial-model`` warm-starts every fit from a saved GAME model and
``--locked-coordinates`` keeps those coordinates at it.

Fault tolerance: ``--checkpoint-dir`` publishes every descent's restart
state after each outer iteration (one chain a sweep entry, the reference's
format) and ``--resume auto|latest|PATH`` goes on from it; ``--checkpoint``
writes each iteration's model under ``<output-dir>/checkpoint/latest``.
``--faults`` injects faults at named sites, SIGTERM/SIGINT (or the
``preempt`` site) stops at the next iteration boundary with the checkpoint
published and exits with code 75, and ``--stall-timeout`` runs the
watchdog.  ``--backend gpu``
(the default) runs on the card and fails without one; ``--backend cpu``
runs on the host.  The run report (``<output-dir>/telemetry/``) carries
the entity solves' routes and bins.

Out-of-core GAME: ``--stream-chunks ROWS`` trains with the streamed
descent (``game/stream_descent.py``): the rows in ROWS-row chunks, the
score tables as host tiles, each chunk copied to the device one ahead of
its compute, so device residency is bounded by the chunk window.
``--max-resident-mb`` turns it on by itself when the resident fit's
estimate exceeds the budget, with the chunk size whose window fits it.
Checkpoints then carry the mid-epoch chunk cursor.  ``--spill-dir D``
adds the disk tier (``game/tile_store.py``): the feature chunks and the
residual tiles in part files under D, read through an LRU host cache of
``--max-host-mb`` MB, stored under the ``--tile-dtype`` codec (f32, bf16
or int8).  ``--max-host-mb`` alone turns streaming and spilling on (under
``<output-dir>/tile_store``) when the streamed fit's host estimate
exceeds it.

``--dtype bfloat16`` stores the training data's feature values in bf16
(``game/data.dataset_astype``), resident or streamed: every coordinate's
blocks and chunks move 2 bytes a value, and labels, weights, coefficients
and all arithmetic stay float32.  The validation data stays float32.

Flags of the reference that the port does not carry yet raise, naming
their ROADMAP.md queue 1 item: tuning and multi-process runs (10), and the
coordinate key ``row_split`` (10).
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
    ("tuning", 10, "hyperparameter tuning"),
    ("coordinator", 10, "multi-process runs"),
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
    p.add_argument("--stream-chunks", type=int, default=None, metavar="ROWS",
                   help="out-of-core GAME: the streamed descent, rows in "
                   "ROWS-row chunks, score tables tiled in host memory, each "
                   "chunk copied to the device one ahead of its compute "
                   "(device residency bounded by the chunk window).  Replaces "
                   "--residuals/--validation-pipeline")
    p.add_argument("--max-resident-mb", type=float, default=None,
                   help="device budget in MB: when the resident fit's estimate "
                   "exceeds it, streaming turns on with a chunk size whose "
                   "in-flight window fits the budget (--stream-chunks wins)")
    p.add_argument("--max-host-mb", type=float, default=None,
                   help="host budget in MB for the streamed fit: when its host "
                   "estimate (feature chunks and score tiles) exceeds it, the "
                   "disk-backed tile store turns on (under --spill-dir, else "
                   "<output-dir>/tile_store) with an LRU host cache of this "
                   "size, and streaming too if no other flag turned it on.  The "
                   "input is still read whole once to build the store")
    p.add_argument("--spill-dir", default=None,
                   help="directory of the disk-backed tile store (feature chunks "
                   "and score tiles, a part file each a chunk); forces spilling. "
                   "Requires streamed mode")
    p.add_argument("--tile-dtype", choices=("f32", "bf16", "int8"), default="f32",
                   help="storage codec of the tile store: bf16 halves and int8 "
                   "(a per-row absmax scale) quarters the spilled feature values "
                   "and score tiles; all arithmetic stays f32.  Requires "
                   "--spill-dir (or a --max-host-mb that derives one)")
    p.add_argument("--evaluators", default=None,
                   help="comma-separated evaluator names; default per task")
    p.add_argument("--model-format", default="avro", choices=("avro", "json"))
    p.add_argument("--save-all-models", action="store_true")
    p.add_argument("--max-quarantined", type=int, default=8,
                   help="non-finite solves/score rows a run may quarantine "
                   "before it fails; -1 = unlimited")
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                   help="storage dtype of the FEATURE VALUES in every training "
                   "shard (labels, weights, coefficients and all arithmetic "
                   "stay float32); bfloat16 halves the value stream each "
                   "coordinate's gathers read")
    p.add_argument("--initial-model", default=None,
                   help="GAME model directory to warm-start from")
    p.add_argument("--locked-coordinates", default=None,
                   help="comma-separated coordinates to keep at the initial "
                   "model (partial retraining)")
    p.add_argument("--checkpoint", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="write each iteration's model under <output-dir>/"
                   "checkpoint/latest and each sweep entry's as it finishes "
                   "(resume via --initial-model)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="descent checkpointing: after every outer iteration "
                   "the full restart state is published atomically here "
                   "(one subdirectory a sweep entry)")
    p.add_argument("--checkpoint-async", default=None, choices=("on", "off"),
                   help="publish checkpoints from a background thread "
                   "(default on, or PHOTON_CHECKPOINT_ASYNC): the loop "
                   "stages the copies, the write runs behind the next "
                   "iteration; 'off' writes inline")
    p.add_argument("--checkpoint-max-staged-mb", type=float, default=None,
                   help="a staged snapshot over this many MB publishes "
                   "blocking.  Default: PHOTON_CHECKPOINT_MAX_STAGED_MB, "
                   "else unbounded")
    p.add_argument("--resume", default=None, metavar="auto|latest|PATH",
                   help="go on from --checkpoint-dir: 'auto' resumes what is "
                   "there (a fresh start otherwise), 'latest' requires a "
                   "published checkpoint, a path names one version; "
                   "finished sweep entries are rebuilt without a fit")
    common.add_fault_args(p)
    common.add_telemetry_arg(p)
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
    if kind not in ("fixed", "random", "factored_random"):
        raise ValueError(
            f"coordinate type must be fixed|random|factored_random in {origin}")
    if "shard" not in kv:
        raise ValueError(f"coordinate {name!r} needs shard=<feature shard>")
    if kind in ("random", "factored_random") and "entity" not in kv:
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


def _coord_config(kv: dict, lam: float, task: str):
    """One coordinate's config with regularization weight ``lam``; the
    fixed effect's ``downsampler`` defaults to the task's (binary for the
    logistic and hinge tasks, uniform otherwise)."""
    from photon_tpu_torch.core.objective import RegularizationContext
    from photon_tpu_torch.core.optimizers import OptimizerConfig
    from photon_tpu_torch.core.problem import ProblemConfig
    from photon_tpu_torch.game.coordinate import (
        FactoredRandomEffectCoordinateConfig,
        FixedEffectCoordinateConfig,
        RandomEffectCoordinateConfig,
    )

    reg_type = kv.get("reg_type", "l2")
    optimizer = kv.get("optimizer", "lbfgs")
    if reg_type in ("l1", "elastic_net"):
        optimizer = "owlqn"
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
        downsampler = kv.get("downsampler") or "auto"
        if downsampler == "auto":
            from photon_tpu_torch.core.losses import BINARY_TASKS

            downsampler = "binary" if task.lower() in BINARY_TASKS else "default"
        return FixedEffectCoordinateConfig(
            shard_name=kv["shard"], problem=problem,
            downsampling_rate=float(kv.get("downsample", 1.0)),
            downsampler=downsampler, seed=int(kv.get("seed", 0)),
        )
    cap = kv.get("active_row_cap")
    if kv.get("type") == "factored_random":
        if _coord_bool(kv.get("row_split", False)):
            raise ValueError("row_split is not supported for factored_random "
                             "coordinates (the pooled latent solve spans every row)")
        if kv.get("projection") or kv.get("projected_dim") or kv.get("variance"):
            raise ValueError(
                "projection/projected_dim/variance are not supported for "
                "factored_random coordinates (the latent projection is the "
                "dimensionality reduction; z-space variances do not transport "
                "to w = L z)")
        return FactoredRandomEffectCoordinateConfig(
            shard_name=kv["shard"], entity_column=kv["entity"],
            latent_dim=int(kv.get("latent_dim", 4)),
            latent_iterations=int(kv.get("latent_iterations", 2)),
            problem=problem, active_row_cap=None if cap in (None, "") else int(cap),
            seed=int(kv.get("seed", 0)),
        )
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


def _build_sweep(specs, task: str) -> list:
    """Cross product of per-coordinate reg weights -> (label, coords)."""
    weight_lists = [[float(w) for w in str(kv.get("reg_weights", "1.0")).split("+")]
                    for _, kv in specs]
    return [
        (_combo_label(specs, combo),
         {name: _coord_config(kv, lam, task) for (name, kv), lam in zip(specs, combo)})
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


def _validate_resume(args, specs) -> None:
    """The reference's checks (``train_game.py:442-465``), before any data
    is read."""
    from photon_tpu_torch.fault.checkpoint import has_published_checkpoint

    if args.resume and not args.checkpoint_dir:
        raise ValueError("--resume needs --checkpoint-dir")
    if args.resume == "latest" and not has_published_checkpoint(args.checkpoint_dir):
        raise ValueError(
            f"--resume latest: no published checkpoint under {args.checkpoint_dir!r}")
    if (args.resume and args.resume not in ("auto", "latest")
            and len(_build_sweep(specs, args.task)) > 1):
        raise ValueError(
            "an explicit --resume path applies to a single sweep entry; use "
            "--resume auto for sweeps")


def _stream_rows(args, data, n_coordinates: int, session, logger):
    """``(chunk rows, spill directory)``: the chunk size of a streamed fit
    (None for a resident one) and its tile store (None: host-resident
    tiles).  The reference's rule (``photon_tpu/drivers/train_game.py:
    543-610``)."""
    from photon_tpu_torch.game.tiles import (
        chunk_rows_for_budget,
        resident_bytes_estimate,
        stream_host_bytes_estimate,
    )

    rows = None
    if args.stream_chunks is not None:
        if args.stream_chunks < 1:
            raise ValueError(f"--stream-chunks must be >= 1, got {args.stream_chunks}")
        rows = args.stream_chunks
    elif args.max_resident_mb is not None:
        estimate = resident_bytes_estimate(data, n_coordinates=n_coordinates)
        session.gauge("stream.resident_estimate_bytes").set(estimate)
        if estimate > int(args.max_resident_mb * (1 << 20)):
            rows = chunk_rows_for_budget(data, args.max_resident_mb)
            logger.info("resident estimate %.1f MB exceeds --max-resident-mb %.1f: "
                        "streaming enabled with %d-row chunks",
                        estimate / (1 << 20), args.max_resident_mb, rows)
    if args.max_host_mb is not None and args.max_host_mb <= 0:
        raise ValueError(f"--max-host-mb must be > 0, got {args.max_host_mb}")
    spill_dir = args.spill_dir
    if args.max_host_mb is not None:
        # The host's side of the budget: a dataset past it streams and
        # spills instead of holding its chunks and tiles in memory.
        host_estimate = stream_host_bytes_estimate(data, n_coordinates=n_coordinates)
        session.gauge("stream.host_estimate_bytes").set(host_estimate)
        if host_estimate > int(args.max_host_mb * (1 << 20)):
            if rows is None:
                rows = chunk_rows_for_budget(data, args.max_host_mb)
                logger.info("host estimate %.1f MB exceeds --max-host-mb %.1f: "
                            "streaming enabled with %d-row chunks",
                            host_estimate / (1 << 20), args.max_host_mb, rows)
            if spill_dir is None:
                spill_dir = os.path.join(args.output_dir, "tile_store")
            logger.info("host estimate %.1f MB exceeds --max-host-mb %.1f: "
                        "disk-backed tile store enabled at %s",
                        host_estimate / (1 << 20), args.max_host_mb, spill_dir)
    if spill_dir is not None and not rows:
        raise ValueError(
            "--spill-dir requires streamed mode (--stream-chunks or a "
            "--max-resident-mb/--max-host-mb budget the dataset exceeds)")
    if spill_dir is not None:
        session.gauge("stream.spilled").set(1)
    if rows:
        if (args.residuals not in (None, "auto")
                or args.validation_pipeline not in (None, "auto")):
            logger.info("streamed descent replaces --residuals/"
                        "--validation-pipeline; ignoring the explicit flags")
        session.gauge("stream.chunk_rows").set(rows)
    return rows, spill_dir


def _model_checkpoint_fn(args, index_maps, logger):
    """``--checkpoint``: each iteration's model goes into the slot that
    ``<output-dir>/checkpoint/latest`` does not point to, then the link is
    replaced atomically, so ``latest`` always names a whole model."""
    import shutil

    from photon_tpu_torch.game.model_io import save_game_model

    base = os.path.join(args.output_dir, "checkpoint")
    latest = os.path.join(base, "latest")

    def checkpoint_fn(iteration, model):
        live = (os.path.basename(os.path.realpath(latest))
                if os.path.islink(latest) else None)
        slot = os.path.join(base, "slot-1" if live == "slot-0" else "slot-0")
        shutil.rmtree(slot, ignore_errors=True)
        save_game_model(slot, model, index_maps, fmt=args.model_format)
        tmp_link = os.path.join(base, ".latest.tmp")
        if os.path.lexists(tmp_link):
            os.remove(tmp_link)
        os.symlink(os.path.basename(slot), tmp_link)
        os.replace(tmp_link, latest)
        logger.info("checkpoint: iteration %d -> %s", iteration, latest)

    return checkpoint_fn


def run(args: argparse.Namespace) -> dict:
    _reject_not_ported(args)
    logger = common.RunLogger("photon_tpu_torch.train_game", args.log_file)
    os.makedirs(args.output_dir, exist_ok=True)
    with common.telemetry_run(args, "train_game", logger, preemptible=True) as session:
        return _train(args, logger, session)


def _train(args: argparse.Namespace, logger, session) -> dict:
    from photon_tpu_torch.data.validation import apply_validation, validate_game_dataset
    from photon_tpu_torch.evaluation.evaluators import (
        MultiEvaluator,
        default_evaluators_for_task,
    )
    from photon_tpu_torch.game.data import dataset_astype, split_game_dataset
    from photon_tpu_torch.game.estimator import (
        GameEstimator,
        GameOptimizationConfiguration,
    )
    from photon_tpu_torch.game.model_io import load_game_model, save_game_model

    device = common.device_for_backend(args.backend)
    specs = _coordinate_specs(args)
    _validate_resume(args, specs)
    sweep = _build_sweep(specs, args.task)

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
        if args.dtype != "float32":
            # The training data only: the validation data stays float32, so
            # the metrics do not depend on the storage option.
            data = dataset_astype(data, args.dtype)
            logger.info("feature values stored as %s (float32 arithmetic)", args.dtype)
        logger.info("train: %d examples, shards %s on %s", data.num_examples,
                    {n: s.dim for n, s in data.shards.items()}, device)
    if args.data_validation != "off":
        apply_validation(validate_game_dataset(data, args.task),
                         args.data_validation, logger)
    if args.evaluators:
        evaluators = common.build_flat_evaluators(args.evaluators)
    else:
        evaluators = MultiEvaluator(default_evaluators_for_task(args.task))
    initial_model = None
    if args.initial_model:
        # Joined onto this run's feature maps by (name, term).
        initial_model, _ = load_game_model(args.initial_model, index_maps, device=device)
    locked = ([c.strip() for c in args.locked_coordinates.split(",") if c.strip()]
              if args.locked_coordinates else [])
    stream_rows, spill_dir = _stream_rows(args, data, len(specs), session, logger)
    estimator = GameEstimator(
        args.task, data, validation_data=val_data,
        evaluators=evaluators if val_data is not None else None,
        device=device, logger=logger,
        # The streamed estimator refuses explicit engine modes; the flags
        # were reported above.
        residual_mode=None if stream_rows else args.residuals,
        validation_mode=None if stream_rows else args.validation_pipeline,
        stream_chunks=stream_rows, telemetry=session, spill_dir=spill_dir,
        max_host_mb=args.max_host_mb if spill_dir is not None else None,
        tile_dtype=args.tile_dtype,
    )
    max_quarantined = None if args.max_quarantined < 0 else args.max_quarantined
    checkpoint_fn = (_model_checkpoint_fn(args, index_maps, logger)
                     if args.checkpoint else None)
    results = []
    for seq, (label, coords) in enumerate(sweep):
        config = GameOptimizationConfiguration(
            coordinates=coords, descent_iterations=args.descent_iterations,
            name=label)
        ckpt_dir = resume = None
        if args.checkpoint_dir:
            # One chain a sweep entry (sequence number and label, the
            # reference's naming); entries the interrupted run never
            # reached start fresh.
            slug = "".join(c if c.isalnum() else "-" for c in label)[:80]
            ckpt_dir = os.path.join(args.checkpoint_dir, f"{seq:03d}-{slug}")
            resume = args.resume if args.resume != "latest" else "auto"
        with logger.timed(f"fit-{label}"), \
                common.maybe_profile(args.profile_dir, f"fit-{seq:03d}"):
            result = estimator.fit(
                [config], initial_model=initial_model, locked_coordinates=locked,
                checkpoint_fn=checkpoint_fn, checkpoint_dir=ckpt_dir,
                resume=resume, max_quarantined=max_quarantined,
                checkpoint_async=args.checkpoint_async,
                checkpoint_max_staged_mb=args.checkpoint_max_staged_mb,
            )[0]
        results.append(result)
        if args.save_all_models or args.checkpoint:
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
                # A history resumed from the JAX package's checkpoint lacks
                # the port's per-iteration keys.
                "history": [
                    {key: h.get(key) for key in ("iteration", "metrics", "seconds",
                                                 "solver", "residual_updates",
                                                 "host_syncs")}
                    for h in r.descent.history
                ],
            }
            for r in results
        ],
        "phase_times": logger.phase_times,
        "stream_chunks": stream_rows,
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
    common.run_cli(run, build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
