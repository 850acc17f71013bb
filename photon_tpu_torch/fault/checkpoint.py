"""Preemption-safe checkpoint/resume for GAME coordinate descent.

Counterpart of ``photon_tpu/fault/checkpoint.py`` on one device.  After
every outer iteration the full descent state — per-coordinate models, the
residual engine's score rows, the best model so far, the validation
history and the quarantine count — is published as one versioned
directory with the atomic protocol of :mod:`photon_tpu_torch.fault.atomic`:

    <dir>/ckpt-000002/
        state.json      # iteration, history, best metrics, fingerprint
        arrays.npz      # model tables + residual score rows (exact dtypes)
        manifest.json   # content hashes, written last
    <dir>/LATEST        # pointer file, replaced atomically

The on-disk format is the reference's, key for key, so a checkpoint either
package publishes resumes in the other.  Resume rebuilds the score tables
from the saved rows and warm-starts every coordinate from its saved model,
so a resumed fit repeats an uninterrupted one.

Staging (:func:`stage_to_host`) is the one place this module touches the
device: on the loop thread every device tensor is copied ``non_blocking``
into a pinned host buffer, all in stream order, and one event wait then
makes the host copies whole before ``save_arrays`` returns — the loop
overwrites the score table in place the moment it resumes.  The copied
bytes count as ``descent.host_transfer_bytes{path=checkpoint}``.  The
serialize + fsync + rename publish runs on a depth-1 publisher thread
(:class:`AsyncPublisher`, ``--checkpoint-async``, default on) whose
failures surface at the next save or at ``drain``, or inline with
``--checkpoint-async off``; ``--checkpoint-max-staged-mb`` caps the host
bytes one staged snapshot may hold while the loop runs ahead (over it, the
publish blocks).  On an H100 the thread hides little of the publish: a
checkpointed descent iteration took a few percent less with it, pooled
over runs that disagreed (PERF.md, fault tolerance).

:class:`StreamState`/:class:`StreamCheckpointer` carry the state shape the
resident GLM sweep snapshots once per finished regularization weight
(``drivers/train.py``) and the streamed L-BFGS loop publishes every
``checkpoint_every`` iterations and at its end (``data/streaming.py``).  The
streamed GAME descent (``game/stream_descent.py``) saves a
:class:`DescentState` after every coordinate with its mid-epoch cursor in
``stream``.  The mesh argument of the loads waits in ROADMAP.md queue 1,
item 10.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_tpu_torch.fault.atomic import (
    atomic_dir,
    atomic_write_bytes,
    verify_manifest,
    write_manifest,
)
from photon_tpu_torch.fault.injection import fault_point
from photon_tpu_torch.fault.retry import retry_call
from photon_tpu_torch.telemetry import NULL_SESSION

STATE_VERSION = 1
LATEST_NAME = "LATEST"


class CheckpointError(RuntimeError):
    """A checkpoint could not be loaded (missing, corrupt, or mismatched)."""


def resolve_checkpoint_async(mode=None) -> bool:
    """True = the async publisher: the explicit ``mode`` (flag or bool)
    over ``PHOTON_CHECKPOINT_ASYNC`` over the default (``on``)."""
    if isinstance(mode, bool):
        return mode
    resolved = (
        (mode or "").strip().lower()
        or os.environ.get("PHOTON_CHECKPOINT_ASYNC", "").strip().lower()
        or "on"
    )
    if resolved not in ("on", "off"):
        raise ValueError(
            f"checkpoint-async must be 'on' or 'off', got {resolved!r}"
        )
    return resolved == "on"


def has_published_checkpoint(checkpoint_dir: Optional[str]) -> bool:
    """True when any checkpoint chain under ``checkpoint_dir`` has a
    published version (a ``LATEST`` pointer); ``.tmp-*`` debris of a run
    killed before its first publish does not count."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return False
    for _dirpath, _dirnames, filenames in os.walk(checkpoint_dir):
        if LATEST_NAME in filenames:
            return True
    return False


def stage_to_host(arrays: Dict[str, object], telemetry=None) -> Dict[str, np.ndarray]:
    """Host copies of a checkpoint's array dict, whole when this returns.

    Every CUDA tensor is copied ``non_blocking`` into a pinned host buffer
    on the current stream, all before any wait, so the copies queue behind
    the kernels that wrote the tensors and ahead of any that overwrite
    them; one event wait then lands them all.  CPU tensors are cloned (a numpy
    view of one would follow the loop's in-place writes) and host arrays
    pass through.  A stage that read any tensor counts one
    ``descent.host_syncs{kind=checkpoint}``: the event wait on the card,
    the clones on the CPU."""
    staged: Dict[str, object] = {}
    pinned: Dict[str, torch.Tensor] = {}
    read_tensor = False
    for key, value in arrays.items():
        if isinstance(value, torch.Tensor) and value.is_cuda:
            buf = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            buf.copy_(value.detach(), non_blocking=True)
            pinned[key] = buf
        elif isinstance(value, torch.Tensor):
            # host-sync: a CPU tensor (no device): the clone is the copy.
            staged[key] = value.detach().clone().numpy()
            read_tensor = True
        else:
            # host-sync: host leaves (key vocabularies, host-engine rows)
            # normalize through numpy without touching a device.
            staged[key] = np.asarray(value)
    d2h_bytes = 0
    if pinned:
        done = torch.cuda.Event()
        done.record()
        # host-sync: checkpoint staging — the one wait that lands every
        # pinned copy queued above, the sanctioned once-per-iteration
        # off-hot-path fetch.
        done.synchronize()
        read_tensor = True
        for key, buf in pinned.items():
            # host-sync: numpy views of the landed pinned buffers.
            staged[key] = buf.numpy()
            d2h_bytes += buf.numel() * buf.element_size()
    if telemetry is not None and read_tensor:
        telemetry.counter("descent.host_syncs", kind="checkpoint").inc()
    if telemetry is not None and d2h_bytes:
        telemetry.counter(
            "descent.host_transfer_bytes", direction="d2h", path="checkpoint"
        ).inc(d2h_bytes)
    return {key: staged[key] for key in arrays}


class AsyncPublisher:
    """Dedicated checkpoint-publisher thread with bounded depth 1.

    ``submit(fn)`` first waits out any in-flight publish (the only place
    the training loop can block on checkpoint IO, observed as
    ``checkpoint.blocked_s``) and re-raises a previous publish's failure
    there.  ``drain()`` waits, stops the thread and raises any pending
    failure.  ``checkpoint.publish_lag_s`` observes enqueue-to-landed
    latency."""

    def __init__(self, telemetry=None, name: str = "checkpoint-publisher"):
        self.telemetry = telemetry or NULL_SESSION
        self._name = name
        self._job = None
        self._job_ready = threading.Condition()
        self._idle = threading.Event()
        self._idle.set()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = False

    def _run(self) -> None:
        while True:
            with self._job_ready:
                while self._job is None and not self._stop:
                    self._job_ready.wait()
                if self._stop and self._job is None:
                    return
                fn, enqueued = self._job
                self._job = None
            try:
                with self.telemetry.span("checkpoint.publish"):
                    fn()
            except BaseException as e:  # surfaced at the next save/drain
                self._error = e
            finally:
                self.telemetry.histogram("checkpoint.publish_lag_s").observe(
                    time.monotonic() - enqueued
                )
                self._idle.set()

    def _wait_idle(self) -> None:
        t0 = time.monotonic()
        self._idle.wait()
        self.telemetry.histogram("checkpoint.blocked_s").observe(
            time.monotonic() - t0
        )

    def _raise_pending(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise err

    def submit(self, fn) -> None:
        """Enqueue one publish; blocks while the previous one is in flight
        and re-raises its failure here."""
        self._wait_idle()
        self._raise_pending()
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, name=self._name, daemon=True
            )
            self._thread.start()
        self._idle.clear()
        with self._job_ready:
            self._job = (fn, time.monotonic())
            self._job_ready.notify()

    def wait(self, reraise: bool = True) -> None:
        """Block until the in-flight publish lands, keeping the thread (the
        staged-bytes cap's blocking publish)."""
        self._idle.wait()
        if reraise:
            self._raise_pending()

    def drain(self, reraise: bool = True) -> None:
        """Wait out the in-flight publish and stop the thread; with
        ``reraise=False`` (error paths) a pending failure is dropped so the
        caller's own exception surfaces."""
        self._idle.wait()
        thread = self._thread
        if thread is not None and thread.is_alive():
            with self._job_ready:
                self._stop = True
                self._job_ready.notify()
            thread.join()
        self._thread = None
        if reraise:
            self._raise_pending()
        else:
            self._error = None


def logical_layout(num_examples: int, coordinate_kinds=None) -> dict:
    """The device-independent layout of a descent run: the unpadded
    training row count and each coordinate's kind in update order."""
    return {
        "rows": int(num_examples),
        "coordinates": {
            str(name): str(kind)
            for name, kind in (coordinate_kinds or {}).items()
        },
    }


def layout_digest(layout: dict) -> str:
    """Stable digest of a logical layout, stamped into the manifest and
    cross-checked against the payload on load."""
    return hashlib.sha256(
        json.dumps(layout, sort_keys=True).encode()
    ).hexdigest()[:16]


def descent_fingerprint(
    task_type: str, coordinate_names, num_examples: int, residual_mode: str,
    config_key: Optional[str] = None,
    validation_key: Optional[str] = None,
    locked=(),
    warm_start: bool = False,
    coordinate_kinds=None,
) -> dict:
    """The one definition of a descent's checkpoint-compatibility
    fingerprint: task, coordinate sequence, logical layout, residual mode,
    optimization configuration, validation setup, lock list and
    warm-start-ness.  Nothing of the device is in it."""
    fp = {
        "task_type": task_type,
        "coordinates": list(coordinate_names),
        "layout": logical_layout(num_examples, coordinate_kinds),
        "residual_mode": residual_mode,
        "validation": validation_key,
        "locked": sorted(locked),
        "warm_start": bool(warm_start),
    }
    if config_key is not None:
        fp["config"] = config_key
    return fp


def require_fingerprint(state, expected: dict, what: str):
    """Pass ``state`` (None = nothing checkpointed) through unless its
    fingerprint differs from ``expected``; then raise
    :class:`CheckpointError` naming ``what`` it failed to match."""
    if state is not None and state.fingerprint != expected:
        raise CheckpointError(
            f"checkpoint fingerprint {state.fingerprint} does not match "
            f"{what} ({expected}); refusing to resume"
        )
    return state


def configuration_key(coordinate_configs: dict) -> str:
    """Digest of a sweep point's per-coordinate configs (their dataclass
    reprs, the reference's to the character); ``descent_iterations`` is not
    in it, so a resume may run more iterations."""
    return hashlib.sha256(repr(coordinate_configs).encode()).hexdigest()[:16]


@dataclasses.dataclass
class DescentState:
    """One outer iteration's complete restart state.  ``residual_rows``
    holds host rows or device row views (the async staging path);
    :func:`stage_to_host` takes either."""

    iteration: int              # last COMPLETED outer iteration
    num_iterations: int         # the run's target iteration count
    task_type: str
    models: Dict[str, object]
    best_models: Dict[str, object]
    best_metrics: Dict[str, float]
    best_iteration: int
    history: List[dict]
    residual_rows: Dict[str, object]
    quarantined: int
    fingerprint: dict
    # The streamed GAME loop's mid-epoch cursor: ``chunk_rows``, ``cursor``
    # (coordinates of iteration + 1 done), ``seq``, the per-chunk
    # ``tile_digests`` and ``spilled``; None for resident descents.
    stream: Optional[dict] = None

    @property
    def completed(self) -> bool:
        return self.iteration + 1 >= self.num_iterations and not (
            self.stream or {}
        ).get("cursor")


def _models_to_arrays(prefix: str, models: Dict[str, object]):
    """``(arrays, meta)`` of one model dict; array keys
    ``<prefix><i>__<field>`` as the reference's.  Tensors stay tensors:
    :func:`stage_to_host` copies them all in one pass."""
    from photon_tpu_torch.game.model import FixedEffectModel, RandomEffectModel

    arrays, meta = {}, []
    for i, (name, model) in enumerate(models.items()):
        key = f"{prefix}{i}__"
        if isinstance(model, FixedEffectModel):
            coeff = model.coefficients
            arrays[key + "means"] = coeff.means
            if coeff.variances is not None:
                arrays[key + "variances"] = coeff.variances
            meta.append({
                "name": name, "kind": "fixed", "shard_name": model.shard_name,
                "has_variances": coeff.variances is not None,
            })
        elif isinstance(model, RandomEffectModel):
            arrays[key + "table"] = model.table
            arrays[key + "keys"] = model.keys
            if model.variances is not None:
                arrays[key + "variances"] = model.variances
            meta.append({
                "name": name, "kind": "random", "shard_name": model.shard_name,
                "entity_column": model.entity_column,
                "has_variances": model.variances is not None,
            })
        else:
            raise TypeError(f"cannot checkpoint coordinate model {type(model)!r}")
    return arrays, meta


def _models_from_arrays(prefix: str, meta: List[dict], arrays, task_type: str,
                        device):
    """Coordinate models from checkpointed host arrays, on ``device``."""
    from photon_tpu_torch.game.model import FixedEffectModel, RandomEffectModel
    from photon_tpu_torch.models.glm import Coefficients, model_for_task

    def place(host):
        return torch.as_tensor(np.array(host, np.float32), device=device)

    models = {}
    for i, m in enumerate(meta):
        key = f"{prefix}{i}__"
        variances = place(arrays[key + "variances"]) if m["has_variances"] else None
        if m["kind"] == "fixed":
            glm = model_for_task(
                task_type, Coefficients(place(arrays[key + "means"]), variances))
            models[m["name"]] = FixedEffectModel(model=glm, shard_name=m["shard_name"])
        else:
            models[m["name"]] = RandomEffectModel(
                table=place(arrays[key + "table"]),
                keys=arrays[key + "keys"],
                entity_column=m["entity_column"],
                shard_name=m["shard_name"],
                task_type=task_type,
                variances=variances,
            )
    return models


class CheckpointPublisherBase:
    """Versioned directories under one root, published atomically with the
    manifest last, a ``LATEST`` pointer, the newest ``keep`` versions kept,
    and the sync or async publish path.  One process writes (``write``
    defaults to True; the multi-process rank rule waits with item 10)."""

    def __init__(self, directory: str, telemetry=None, logger=None,
                 keep: int = 2, write: Optional[bool] = None,
                 async_publish=None, max_staged_mb: Optional[float] = None):
        self.directory = directory
        self.telemetry = telemetry or NULL_SESSION
        self.logger = logger
        self.keep = max(1, keep)
        self._write = True if write is None else bool(write)
        self.async_publish = resolve_checkpoint_async(async_publish)
        self._publisher = (
            AsyncPublisher(self.telemetry) if self.async_publish else None
        )
        if max_staged_mb is None:
            raw = os.environ.get("PHOTON_CHECKPOINT_MAX_STAGED_MB", "").strip()
            try:
                max_staged_mb = float(raw) if raw else None
            except ValueError:
                max_staged_mb = None
        self.max_staged_bytes = (
            None if max_staged_mb is None or max_staged_mb < 0
            else int(max_staged_mb * (1 << 20))
        )

    def _ckpt_name(self, iteration: int) -> str:
        return f"ckpt-{iteration:06d}"

    def latest_path(self) -> Optional[str]:
        """The checkpoint directory ``LATEST`` points to, or None."""
        pointer = os.path.join(self.directory, LATEST_NAME)
        if not os.path.isfile(pointer):
            return None
        with open(pointer) as f:
            name = f.read().strip()
        path = os.path.join(self.directory, name)
        return path if os.path.isdir(path) else None

    def save_arrays(self, iteration: int, arrays: Dict[str, object],
                    payload: dict) -> Optional[str]:
        """Stage and publish one version; returns its path (None when this
        process does not write).  Staging runs here, on the calling
        thread, and the host copies exist when this returns; the publish
        runs inline or on the publisher thread, blocking only on the
        previous publish.  Checkpoint IO retries like any guarded write; an
        exhausted retry raises."""
        if not self._write:
            return None
        t0 = time.monotonic()
        fault_point("checkpoint:stage", iteration=iteration)
        staged = stage_to_host(arrays, telemetry=self.telemetry)
        staged_bytes = sum(a.nbytes for a in staged.values())
        self.telemetry.gauge("checkpoint.staged_bytes").set(staged_bytes)
        self.telemetry.histogram("checkpoint.stage_seconds").observe(
            time.monotonic() - t0
        )
        final = os.path.join(self.directory, self._ckpt_name(iteration))

        def publish() -> str:
            return retry_call(
                lambda: self._publish_once(final, staged, payload),
                site="checkpoint:io",
                telemetry=self.telemetry, logger=self.logger,
            )

        if self._publisher is None:
            publish()
        elif (self.max_staged_bytes is not None
                and staged_bytes > self.max_staged_bytes):
            # Over the staged-bytes cap: publish on this thread, after
            # surfacing any failure of the publish in flight.
            self._publisher.wait()
            self.telemetry.counter("checkpoint.staged_fallback_sync").inc()
            if self.logger is not None:
                self.logger.info(
                    "checkpoint: staged snapshot %.1f MB over the "
                    "--checkpoint-max-staged-mb cap (%.1f MB); publishing "
                    "blocking", staged_bytes / (1 << 20),
                    self.max_staged_bytes / (1 << 20),
                )
            publish()
        else:
            self._publisher.submit(publish)
        # Async: the loop-side cost (staging and any wait on the previous
        # publish); the publish itself is checkpoint.publish_lag_s.
        self.telemetry.histogram("checkpoint.write_seconds").observe(
            time.monotonic() - t0
        )
        self.telemetry.counter("checkpoint.saves").inc()
        if self.logger is not None:
            self.logger.info(
                "checkpoint: iteration %d -> %s%s", iteration, final,
                " (async publish)" if self._publisher is not None else "",
            )
        return final

    def drain(self, reraise: bool = True) -> None:
        """Wait for the in-flight async publish (no-op when synchronous) and
        surface its failure unless ``reraise`` is False."""
        if self._publisher is not None:
            self._publisher.drain(reraise=reraise)

    def _publish_once(self, final: str, arrays: Dict[str, np.ndarray],
                      payload: dict) -> str:
        iteration = int(payload.get("iteration", 0))
        manifest_extra = {"iteration": iteration}
        if "layout" in payload:
            manifest_extra["layout_digest"] = layout_digest(payload["layout"])
        t0 = time.monotonic()
        with atomic_dir(final) as tmp:
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                np.savez(f, **arrays)
            with open(os.path.join(tmp, "state.json"), "w") as f:
                json.dump(payload, f, indent=1)
            # The torn-write window: payload written, manifest not; a kill
            # here leaves only an invisible .tmp dir.
            fault_point("checkpoint:write", iteration=iteration)
            write_manifest(tmp, extra=manifest_extra)
        atomic_write_bytes(
            os.path.join(self.directory, LATEST_NAME),
            os.path.basename(final).encode(),
        )
        self._prune(keep_name=os.path.basename(final))
        self.telemetry.histogram("checkpoint.publish_seconds").observe(
            time.monotonic() - t0
        )
        return final

    def _prune(self, keep_name: str) -> None:
        """Drop all but the newest ``keep`` versions (never the one just
        written) and any ``.tmp-*``/``.old-*`` debris of a hard kill."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        names = sorted(
            n for n in entries
            if n.startswith("ckpt-")
            and os.path.isdir(os.path.join(self.directory, n))
        )
        stale = [n for n in entries if n.startswith((".tmp-", ".old-"))]
        for name in stale + names[:-self.keep]:
            if name != keep_name:
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    @staticmethod
    def read_payload(path: str) -> tuple:
        """``(payload, arrays)`` of one version directory, its manifest
        verified first and the read retried like any guarded IO."""
        if not os.path.isdir(path):
            raise CheckpointError(f"no checkpoint directory at {path!r}")
        verify_manifest(path)

        def _read():
            fault_point("checkpoint:read", path=path)
            with open(os.path.join(path, "state.json")) as f:
                payload = json.load(f)
            with np.load(os.path.join(path, "arrays.npz")) as arrays:
                return payload, {k: arrays[k] for k in arrays.files}

        payload, arrays = retry_call(_read, site="checkpoint:io")
        if payload.get("version") != STATE_VERSION:
            raise CheckpointError(
                f"{path}: checkpoint version {payload.get('version')!r} "
                f"!= supported {STATE_VERSION}"
            )
        return payload, arrays

    def resolve_resume(self, resume: str) -> Optional[str]:
        """``auto`` -> the latest version or None, ``latest`` -> the latest
        version (required), anything else -> an explicit version path."""
        if resume in ("auto", "latest"):
            path = self.latest_path()
            if path is None and resume == "latest":
                raise CheckpointError(
                    f"--resume latest: no checkpoint under {self.directory}"
                )
            return path
        return resume


def _state_layout(state: DescentState) -> dict:
    """The snapshot's logical layout: unpadded score-row lengths and each
    model's vocabulary size and dimension."""
    from photon_tpu_torch.game.model import RandomEffectModel

    coords = {}
    for name, model in state.models.items():
        if isinstance(model, RandomEffectModel):
            coords[name] = {
                "kind": "random",
                "entities": int(model.num_entities),
                "dim": int(model.dim),
            }
        else:
            coords[name] = {
                "kind": "fixed",
                "dim": int(model.coefficients.means.shape[0]),
            }
    return {
        "rows": {
            name: int(row.shape[0]) for name, row in state.residual_rows.items()
        },
        "coordinates": coords,
    }


class DescentCheckpointer(CheckpointPublisherBase):
    """Versioned GAME-descent checkpoints (see the module docstring)."""

    def save(self, state: DescentState) -> Optional[str]:
        """Stage and publish ``state``; returns the checkpoint path."""
        if not self._write:
            return None
        arrays, models_meta = _models_to_arrays("m", state.models)
        # A best model that IS the current iterate is stored by name.
        best_shared = sorted(
            name for name, model in state.best_models.items()
            if state.models.get(name) is model
        )
        best_arrays, best_meta = _models_to_arrays(
            "b",
            {name: model for name, model in state.best_models.items()
             if name not in set(best_shared)},
        )
        arrays.update(best_arrays)
        for j, (name, row) in enumerate(state.residual_rows.items()):
            arrays[f"r{j}__row"] = row
        payload = {
            "version": STATE_VERSION,
            "iteration": state.iteration,
            "num_iterations": state.num_iterations,
            "task_type": state.task_type,
            "models": models_meta,
            "best_models": best_meta,
            "best_shared": best_shared,
            "best_metrics": state.best_metrics,
            "best_iteration": state.best_iteration,
            "history": state.history,
            "residual_rows": list(state.residual_rows),
            "quarantined": state.quarantined,
            "fingerprint": state.fingerprint,
            "layout": _state_layout(state),
            "stream": state.stream,
        }
        seq = state.iteration
        if state.stream:
            seq = int(state.stream.get("seq", state.iteration))
        return self.save_arrays(seq, arrays, payload)

    def load(self, resume: str, device=None) -> Optional[DescentState]:
        """Resolve ``resume`` (see :meth:`resolve_resume`) and load; None
        when ``auto`` finds nothing."""
        path = self.resolve_resume(resume)
        if path is None:
            return None
        return self.load_path(path, device=device)

    @staticmethod
    def load_path(path: str, device=None) -> DescentState:
        """Load one version directory, its manifest verified, its models on
        ``device`` (``cuda`` by default)."""
        from photon_tpu_torch.device import resolve_device

        device = resolve_device(device)
        payload, arrays = CheckpointPublisherBase.read_payload(path)
        layout = payload.get("layout")
        if layout is not None:
            def _read_manifest():
                with open(os.path.join(path, "manifest.json")) as f:
                    return json.load(f)

            advertised = retry_call(
                _read_manifest, site="checkpoint:io"
            ).get("extra", {}).get("layout_digest")
            if advertised is not None and advertised != layout_digest(layout):
                raise CheckpointError(
                    f"{path}: manifest layout digest {advertised!r} does "
                    "not match the payload layout — inconsistent checkpoint "
                    "artifact; refusing to resume"
                )
        task = payload["task_type"]
        models = _models_from_arrays("m", payload["models"], arrays, task, device)
        best_models = _models_from_arrays("b", payload["best_models"], arrays,
                                          task, device)
        for name in payload.get("best_shared", []):
            best_models[name] = models[name]
        best_models = {
            name: best_models[name] for name in models if name in best_models
        } | {
            name: model for name, model in best_models.items() if name not in models
        }
        return DescentState(
            iteration=payload["iteration"],
            num_iterations=payload["num_iterations"],
            task_type=task,
            models=models,
            best_models=best_models,
            best_metrics=dict(payload["best_metrics"]),
            best_iteration=payload["best_iteration"],
            history=list(payload["history"]),
            residual_rows={
                name: arrays[f"r{j}__row"]
                for j, name in enumerate(payload["residual_rows"])
            },
            quarantined=int(payload.get("quarantined", 0)),
            fingerprint=payload.get("fingerprint", {}),
            stream=payload.get("stream"),
        )


@dataclasses.dataclass
class StreamState:
    """A GLM fit's state in the reference's streamed-L-BFGS shape: the
    resident sweep saves one per finished regularization weight
    (``completed`` True); the streamed loop (``data/streaming.
    streaming_lbfgs``) saves its mid-fit states (iterate, gradient, pair
    ring buffer, history and host scalars; ``completed`` False) and a final
    one, so either package resumes the other's."""

    iteration: int
    arrays: Dict[str, object]
    scalars: dict
    completed: bool
    reason: int
    fingerprint: dict


class StreamCheckpointer(CheckpointPublisherBase):
    """GLM fit checkpoints through the same atomic protocol and publisher;
    one instance owns one regularization weight's chain."""

    KIND = "stream-lbfgs"

    def save(self, state: StreamState) -> Optional[str]:
        if not self._write:
            return None
        payload = {
            "version": STATE_VERSION,
            "kind": self.KIND,
            "iteration": state.iteration,
            "scalars": state.scalars,
            "completed": state.completed,
            "reason": state.reason,
            "arrays": sorted(state.arrays),
            "fingerprint": state.fingerprint,
        }
        return self.save_arrays(state.iteration, dict(state.arrays), payload)

    def load(self, resume: str) -> Optional[StreamState]:
        path = self.resolve_resume(resume)
        if path is None:
            return None
        payload, arrays = self.read_payload(path)
        if payload.get("kind") != self.KIND:
            raise CheckpointError(
                f"{path}: not a streamed-GLM checkpoint "
                f"(kind={payload.get('kind')!r})"
            )
        return StreamState(
            iteration=int(payload["iteration"]),
            arrays={k: arrays[k] for k in payload["arrays"]},
            scalars=dict(payload["scalars"]),
            completed=bool(payload.get("completed", False)),
            reason=int(payload.get("reason", 0)),
            fingerprint=payload.get("fingerprint", {}),
        )
