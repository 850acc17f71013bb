"""Atomic, torn-write-proof filesystem publication.

A copy of ``photon_tpu/fault/atomic.py``.

Every durable artifact the fault-tolerance layer owns (checkpoints, model
directories, pointer files) is published with the same protocol: build the
content somewhere invisible, fsync it, then make it visible with ONE atomic
``rename`` — so a kill at any instant leaves either the previous complete
artifact or the new complete artifact, never a torn hybrid.  Directory
artifacts additionally carry a ``manifest.json`` of content hashes written
LAST, so a reader can verify completeness (and bit-rot) before trusting a
checkpoint.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import tempfile
from typing import Dict, Iterator, Optional

MANIFEST_NAME = "manifest.json"


class CorruptArtifactError(RuntimeError):
    """A directory artifact failed manifest verification."""


def fsync_dir(path: str) -> None:
    """fsync a directory so a completed rename survives power loss (no-op
    on filesystems that reject directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``path`` via temp file + fsync + rename in the same directory."""
    parent = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        dir=parent, prefix=f".{os.path.basename(path)}.tmp-"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
    fsync_dir(parent)


def atomic_write_json(path: str, obj) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=1).encode())


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _walk_files(dir_path: str) -> Iterator[str]:
    for root, _, files in os.walk(dir_path):
        for name in sorted(files):
            yield os.path.relpath(os.path.join(root, name), dir_path)


def write_manifest(dir_path: str, extra: Optional[dict] = None) -> dict:
    """Hash every file under ``dir_path`` into ``manifest.json`` (written
    last, atomically) — the completeness marker of a directory artifact."""
    files: Dict[str, str] = {
        rel: file_sha256(os.path.join(dir_path, rel))
        for rel in _walk_files(dir_path)
        if rel != MANIFEST_NAME
    }
    manifest = {"version": 1, "files": files}
    if extra:
        manifest["extra"] = extra
    atomic_write_json(os.path.join(dir_path, MANIFEST_NAME), manifest)
    return manifest


def verify_manifest(dir_path: str) -> dict:
    """Check ``dir_path`` against its manifest; returns the manifest.
    Raises :class:`CorruptArtifactError` on a missing manifest, missing
    file, or content-hash mismatch."""
    mpath = os.path.join(dir_path, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        raise CorruptArtifactError(f"{dir_path}: no {MANIFEST_NAME}")
    with open(mpath) as f:
        manifest = json.load(f)
    for rel, digest in manifest.get("files", {}).items():
        fpath = os.path.join(dir_path, rel)
        if not os.path.isfile(fpath):
            raise CorruptArtifactError(f"{dir_path}: missing {rel}")
        if file_sha256(fpath) != digest:
            raise CorruptArtifactError(f"{dir_path}: content mismatch in {rel}")
    return manifest


def _fsync_tree(dir_path: str) -> None:
    for rel in _walk_files(dir_path):
        try:
            fd = os.open(os.path.join(dir_path, rel), os.O_RDONLY)
        except OSError:
            continue
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    fsync_dir(dir_path)


@contextlib.contextmanager
def atomic_dir(final_path: str) -> Iterator[str]:
    """Build a directory artifact atomically: yields a temp build dir next
    to ``final_path``; on clean exit the tree is fsynced and renamed into
    place (an existing destination is parked aside first and removed only
    after the new directory is live).  On error the temp dir is removed and
    the previous artifact is untouched.

    A kill during the body leaves only an invisible ``.tmp-*`` dir; a kill
    between the aside-rename and the publish-rename leaves the destination
    briefly missing but both complete trees on disk — never a torn mix.
    An in-process publish failure in that window renames the previous
    artifact back into place before re-raising.
    """
    final_path = os.path.abspath(final_path)
    parent = os.path.dirname(final_path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(
        dir=parent, prefix=f".tmp-{os.path.basename(final_path)}-"
    )
    try:
        yield tmp
        _fsync_tree(tmp)
        aside = None
        if os.path.lexists(final_path):
            aside = tempfile.mktemp(
                dir=parent, prefix=f".old-{os.path.basename(final_path)}-"
            )
            os.rename(final_path, aside)
        try:
            os.rename(tmp, final_path)
        except BaseException:
            if aside is not None:
                # Publish failed after the previous artifact was parked
                # aside: put it back so the published path never loses its
                # last complete copy to an in-process error.
                with contextlib.suppress(OSError):
                    os.rename(aside, final_path)
            raise
        fsync_dir(parent)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
