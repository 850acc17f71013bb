"""CoordinateDescent: the GAME outer loop.

Counterpart of the resident path of ``photon_tpu/game/descent.py``: cycle
the coordinates in update order for a fixed number of outer iterations;
each trains against the residuals of the others — its offsets are the
dataset offset plus every other coordinate's current scores — and then
re-scores the data.  After each pass the composite model is evaluated on
the validation data and the best model (by the primary evaluator) is kept.

Residuals pass through the score tables of ``game/residuals.py`` (device
mode) or the float64 host path (``--residuals host``).  Each outer
iteration makes two host reads of its own: one for every random-effect
coordinate's statistics and every score-table guard flag together, one for
the validation metrics (the solvers' own reads are counted by the
coordinates).  A rejected (non-finite) score row rolls its coordinate back
to the previous iterate; ``max_quarantined`` bounds how many such events a
run may absorb.

A run may start from an initial model (its coordinates seed the score
tables and warm-start the first pass) and keep some coordinates locked at
it: a locked coordinate is never trained again.

A ``checkpointer`` (``fault/checkpoint.DescentCheckpointer``) snapshots the
full restart state after every outer iteration, and ``resume_state``
restores one: the score table is rebuilt from the saved rows, the
validation rows are re-scored from the saved models, and the loop goes on
at the next iteration, so a resumed run repeats an uninterrupted one.  The
top of each outer iteration is the preemption boundary: a SIGTERM (or the
``preempt`` fault site) drains the last checkpoint and raises
``PreemptedError``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.fault import QuarantineBudgetError
from photon_tpu_torch.fault.checkpoint import (
    DescentState,
    descent_fingerprint,
    require_fingerprint,
)
from photon_tpu_torch.fault.injection import fault_point
from photon_tpu_torch.game.coordinate import DeferredSolveStats
from photon_tpu_torch.game.data import GameDataset
from photon_tpu_torch.game.model import DeviceScoringCache, GameModel
from photon_tpu_torch.game.residuals import (
    HostResiduals,
    ResidualEngine,
    ValidationEngine,
    resolve_residual_mode,
    resolve_validation_mode,
)
from photon_tpu_torch.telemetry import NULL_SESSION


@dataclasses.dataclass
class DescentResult:
    """Outcome of one CoordinateDescent run."""

    best_model: GameModel
    last_model: GameModel
    best_metrics: Dict[str, float]
    history: list  # per outer iteration: iteration, metrics, coordinates, solver


def _coordinate_record(info) -> dict:
    """The JSON-ready record of one coordinate's train() in one iteration."""
    if isinstance(info, DeferredSolveStats):
        return {**info.resolve(), "bins": info.bins}
    return {
        "iterations": info.iterations,
        "convergence_reason": info.convergence_reason,
        "evaluations": getattr(info, "evaluations", None),
        "host_reads": getattr(info, "host_reads", None),
        "seconds": info.wall_time_s,
        "quarantined": getattr(info, "quarantined", 0),
    }


class CoordinateDescent:
    """Cycles coordinate training with residual (offset) passing;
    ``coordinates`` maps name -> coordinate in update order."""

    def __init__(
        self,
        coordinates: Dict[str, object],
        task_type: str,
        training_data: GameDataset,
        validation_data: Optional[GameDataset] = None,
        evaluators=None,
        logger=None,
        residual_mode: Optional[str] = None,
        validation_mode: Optional[str] = None,
        validation_cache: Optional[DeviceScoringCache] = None,
        telemetry=None,
    ):
        if not coordinates:
            raise ValueError("CoordinateDescent needs at least one coordinate")
        self.coordinates = dict(coordinates)
        self.task_type = task_type
        self.training_data = training_data
        self.validation_data = validation_data
        self.evaluators = evaluators
        self.logger = logger or logging.getLogger("photon_tpu_torch.game")
        self.residual_mode = resolve_residual_mode(residual_mode)
        self.validation_mode = resolve_validation_mode(
            validation_mode, self.residual_mode)
        self.device = next(iter(self.coordinates.values())).device
        self._validation_cache = validation_cache
        self.telemetry = telemetry or NULL_SESSION

    def _build_residuals(self):
        cls = ResidualEngine if self.residual_mode == "device" else HostResiduals
        return cls(self.training_data.offset, list(self.coordinates), self.device)

    def _build_validation(self):
        cache = self._validation_cache
        if cache is None or cache.data is not self.validation_data:
            cache = DeviceScoringCache(self.validation_data, self.device)
            self._validation_cache = cache
        engine = ValidationEngine(self.validation_data.offset,
                                  list(self.coordinates), self.device)
        return engine, cache

    def _score(self, coord, model):
        """Training-data scores: a device tensor in device mode, the host
        vector in host mode."""
        if self.residual_mode == "device":
            return coord.score_device(model)
        return coord.score(model)

    def _evaluate_host(self, model: GameModel) -> Dict[str, float]:
        data = self.validation_data
        scores = torch.as_tensor(model.score(data))
        label, weight = torch.as_tensor(data.label), torch.as_tensor(data.weight)
        return {ev.name: float(ev.fn(scores, label, weight))
                for ev in self.evaluators.evaluators}

    def _evaluate_device(self, engine: ValidationEngine,
                         cache: DeviceScoringCache) -> Dict[str, float]:
        """Every metric of the composite margin in one host read."""
        composite = engine.composite()
        evs = self.evaluators.evaluators
        # host-sync: the validation metrics, one read an outer iteration
        values = torch.stack([
            torch.as_tensor(ev.fn(composite, cache.label, cache.weight)).float()
            for ev in evs]).tolist()
        return {ev.name: v for ev, v in zip(evs, values)}

    def _fingerprint(self, config_key: Optional[str] = None, locked=(),
                     warm_start: bool = False) -> dict:
        has_validation = (self.validation_data is not None
                          and self.evaluators is not None)
        return descent_fingerprint(
            self.task_type, self.coordinates, self.training_data.num_examples,
            self.residual_mode, config_key=config_key,
            validation_key=self.evaluators.primary.name if has_validation else None,
            locked=locked, warm_start=warm_start,
            coordinate_kinds={name: getattr(c, "kind", type(c).__name__)
                              for name, c in self.coordinates.items()},
        )

    def run(
        self,
        num_iterations: int,
        initial_model: Optional[GameModel] = None,
        locked_coordinates: Sequence[str] = (),
        checkpoint_fn=None,
        checkpointer=None,
        resume_state: Optional[DescentState] = None,
        max_quarantined: Optional[int] = None,
        config_key: Optional[str] = None,
    ) -> DescentResult:
        """``checkpoint_fn(iteration, model)``, when given, is called after
        every pass with the composite model.  ``initial_model``'s
        coordinates seed the score tables and warm-start the first pass;
        ``locked_coordinates`` stay at the initial model's.
        ``checkpointer`` saves the restart state after every iteration and
        ``resume_state`` restores one (its fingerprint, with ``config_key``
        the configuration's digest, must match this run's).  A completed
        run returns after its last checkpoint is published."""
        from photon_tpu_torch.fault.watchdog import complete

        try:
            result = self._run(num_iterations, initial_model, locked_coordinates,
                               checkpoint_fn, checkpointer, resume_state,
                               max_quarantined, config_key)
        except BaseException:
            # Quiesce the publisher without masking the real error.
            if checkpointer is not None:
                checkpointer.drain(reraise=False)
            raise
        finally:
            complete("descent.iteration")
        if checkpointer is not None:
            with self.telemetry.span("descent.checkpoint.drain"):
                checkpointer.drain()
        return result

    def _run(self, num_iterations, initial_model, locked_coordinates,
             checkpoint_fn, checkpointer, resume_state, max_quarantined,
             config_key) -> DescentResult:
        from photon_tpu_torch.fault.preemption import (
            PreemptedError,
            consume_preempt_injection,
            preemption_reason,
            preemption_requested,
        )
        from photon_tpu_torch.fault.watchdog import heartbeat

        locked = set(locked_coordinates)
        unknown = locked - set(self.coordinates)
        if unknown:
            raise KeyError(f"locked coordinates not in update sequence: {sorted(unknown)}")
        if locked and initial_model is None:
            raise ValueError("locked coordinates require an initial model")
        for name in locked:
            if name not in initial_model.coordinates:
                raise KeyError(f"locked coordinate {name!r} missing from initial model")
        fingerprint = self._fingerprint(config_key, locked=locked,
                                        warm_start=initial_model is not None)
        models: Dict[str, object] = {}
        residuals = self._build_residuals()
        val_engine = val_cache = None
        has_validation = (self.validation_data is not None
                          and self.evaluators is not None)
        if has_validation and self.validation_mode == "device":
            val_engine, val_cache = self._build_validation()
        best_model: Optional[GameModel] = None
        best_metrics: Dict[str, float] = {}
        best_iteration = -1
        history = []
        quarantined_total = 0
        start_iteration = 0
        game_model = None
        if resume_state is not None:
            require_fingerprint(resume_state, fingerprint, "this descent")
            with self.telemetry.span("descent.resume", iteration=resume_state.iteration):
                models = dict(resume_state.models)
                residuals.load_rows(resume_state.residual_rows)
                if val_engine is not None:
                    # The validation table is not saved: the saved models
                    # re-score it exactly as the uninterrupted run did.
                    for name, model in models.items():
                        val_engine.update(name, val_cache.score(model))
                best_model = GameModel(dict(resume_state.best_models), self.task_type)
                best_metrics = dict(resume_state.best_metrics)
                best_iteration = resume_state.best_iteration
                history = list(resume_state.history)
                quarantined_total = resume_state.quarantined
                start_iteration = resume_state.iteration + 1
            self.telemetry.counter("descent.resumes").inc()
            self.logger.info("resumed descent after iteration %d",
                             resume_state.iteration)
        elif initial_model is not None:
            for name, coord_model in initial_model.coordinates.items():
                if name not in self.coordinates:
                    continue
                models[name] = coord_model
                residuals.update(name, self._score(self.coordinates[name], coord_model))
                if val_engine is not None:
                    # Locked coordinates are never re-scored: their rows
                    # stay as seeded here.
                    val_engine.update(name, val_cache.score(coord_model))
            # The foreign-vocabulary key joins run on a host thread while
            # the first coordinates train.
            from photon_tpu_torch.game.coordinate import prefetch_warm_joins

            prefetch_warm_joins(self.coordinates, initial_model, self.telemetry)
        # A rejected seed row belongs to the initial model, not to whatever
        # trains first: the coordinate cold-starts instead (one host read).
        seed_rejected = set(residuals.poll_quarantined())
        if val_engine is not None:
            seed_rejected |= set(val_engine.poll_quarantined())
        bad_locked = sorted(seed_rejected & locked)
        if bad_locked:
            raise ValueError(
                f"locked coordinate(s) {bad_locked} produced non-finite scores from "
                "the initial model; a locked coordinate cannot be quarantined")
        for name in sorted(seed_rejected):
            quarantined_total += 1
            models.pop(name, None)
            self.logger.info("coordinate %s: non-finite scores from the initial "
                             "model quarantined (cold start instead)", name)
        if max_quarantined is not None and quarantined_total > max_quarantined:
            raise QuarantineBudgetError(
                f"{quarantined_total} quarantined solves/score rows exceed "
                f"--max-quarantined {max_quarantined}"
            )
        if start_iteration >= num_iterations:
            # A completed descent: nothing left to run.
            last = GameModel(dict(models), self.task_type)
            return DescentResult(
                best_model=best_model if best_model is not None else last,
                last_model=last, best_metrics=best_metrics, history=history)
        for it in range(start_iteration, num_iterations):
            # The kill site and the preemption boundary: between outer
            # iterations, where the last checkpoint is consistent.
            fault_point("descent:kill", iteration=it)
            consume_preempt_injection(it)
            if preemption_requested():
                self.telemetry.counter("descent.preempted").inc()
                if checkpointer is not None:
                    with self.telemetry.span("descent.checkpoint.drain"):
                        checkpointer.drain()
                    hint = "resume with --resume auto"
                else:
                    hint = ("no checkpointer configured — a restart begins "
                            "from scratch (set --checkpoint-dir)")
                raise PreemptedError(
                    f"preempted ({preemption_reason()}) before iteration {it}; {hint}")
            heartbeat("descent.iteration")
            t0 = time.perf_counter()
            coord_logs: Dict[str, object] = {}
            prev_iterates: Dict[str, object] = {}
            deferred: Dict[str, DeferredSolveStats] = {}
            updates0 = residuals.updates
            for name, coord in self.coordinates.items():
                if name in locked:
                    continue
                prev_iterates[name] = models.get(name)
                offsets = residuals.offsets_for(name)
                model, info = coord.train(offsets, initial_model=models.get(name))
                models[name] = model
                residuals.update(name, self._score(coord, model))
                if val_engine is not None:
                    val_engine.update(name, val_cache.score(model))
                if isinstance(info, DeferredSolveStats):
                    deferred[name] = info
                else:
                    quarantined_total += int(getattr(info, "quarantined", 0))
                    coord_logs[name] = info
            # The iteration's one read of the statistics and guard flags.
            res_flags = residuals.drain_guard_flags()
            val_flags = val_engine.drain_guard_flags() if val_engine is not None else []
            flags = [(which, name, ok) for which, pending in
                     (("res", res_flags), ("val", val_flags)) for name, ok in pending]
            on_device = [ds.device.long() for ds in deferred.values()] + [
                ok.reshape(1).long() for _, _, ok in flags if isinstance(ok, torch.Tensor)]
            host = []
            if on_device:
                # host-sync: the iteration's one read of the deferred solve
                # statistics and the score tables' guard flags.
                host = torch.cat(on_device).tolist()
                self.telemetry.counter("descent.host_syncs", kind="stats").inc()
            for i, (name, ds) in enumerate(deferred.items()):
                info = ds.resolve(host[6 * i: 6 * i + 6])
                quarantined_total += info["quarantined"]
                coord_logs[name] = ds
            device_oks = iter(host[6 * len(deferred):])
            rejected = {"res": set(), "val": set()}
            for which, name, ok in flags:
                if not (next(device_oks) if isinstance(ok, torch.Tensor) else ok):
                    rejected[which].add(name)
            residuals.record_rejected(sorted(rejected["res"]))
            if val_engine is not None:
                val_engine.record_rejected(sorted(rejected["val"]))
            for name in sorted(rejected["res"] | rejected["val"]):
                quarantined_total += 1
                prev = prev_iterates.get(name)
                if prev is not None:
                    models[name] = prev
                    residuals.update(name, self._score(self.coordinates[name], prev))
                    if val_engine is not None:
                        val_engine.update(name, val_cache.score(prev))
                else:
                    # No previous iterate: the coordinate leaves the composite.
                    models.pop(name, None)
                    residuals.update(name, np.zeros(self.training_data.num_examples,
                                                    np.float32))
                    if val_engine is not None:
                        val_engine.update(name, np.zeros(val_cache.n, np.float32))
                self.logger.info("iter %d coordinate %s: non-finite scores "
                                 "quarantined (previous iterate kept)", it, name)
            if max_quarantined is not None and quarantined_total > max_quarantined:
                raise QuarantineBudgetError(
                    f"{quarantined_total} quarantined solves/score rows exceed "
                    f"--max-quarantined {max_quarantined}"
                )
            game_model = GameModel(dict(models), self.task_type)
            if checkpoint_fn is not None:
                checkpoint_fn(it, game_model)
            metrics: Dict[str, float] = {}
            if has_validation:
                metrics = (self._evaluate_device(val_engine, val_cache)
                           if val_engine is not None else self._evaluate_host(game_model))
            solver = {name: _coordinate_record(info) for name, info in coord_logs.items()}
            for name, rec in solver.items():
                self.logger.info("iter %d coordinate %s: %s", it, name, rec)
            if metrics:
                self.logger.info("iter %d validation %s", it, metrics)
            history.append({
                "iteration": it, "metrics": metrics,
                "coordinates": {name: str(rec) for name, rec in solver.items()},
                "solver": solver,
                "residual_updates": residuals.updates - updates0,
                # Host clock from the iteration's start to its metrics read.
                "seconds": time.perf_counter() - t0,
                "host_syncs": {"stats": int(bool(on_device)),
                               "validation": int(val_engine is not None)},
            })
            if not metrics:
                best_model, best_metrics, best_iteration = game_model, metrics, it
            else:
                primary = self.evaluators.primary
                if best_model is None or primary.better_than(
                        metrics[primary.name], best_metrics[primary.name]):
                    best_model, best_metrics, best_iteration = game_model, metrics, it
            if checkpointer is not None:
                state = DescentState(
                    iteration=it, num_iterations=num_iterations,
                    task_type=self.task_type, models=dict(models),
                    best_models=dict(best_model.coordinates),
                    best_metrics=dict(best_metrics), best_iteration=best_iteration,
                    history=list(history), residual_rows=residuals.snapshot_rows(),
                    quarantined=quarantined_total, fingerprint=fingerprint,
                )
                with self.telemetry.span("descent.checkpoint.save", iteration=it):
                    checkpointer.save(state)
        assert best_model is not None
        return DescentResult(best_model=best_model, last_model=game_model,
                             best_metrics=best_metrics, history=history)
