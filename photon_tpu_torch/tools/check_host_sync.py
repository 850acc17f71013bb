#!/usr/bin/env python3
"""Guard against host-sync regressions in the port's hot loops.

Counterpart of ``tools/check_host_sync.py``.  The descent loop, the entity
and GLM solvers, the serving scorer and batcher, the online loop and the
checkpoint staging each read the device at a few points they choose on
purpose (one read a descent iteration for the statistics and guard flags,
one a solver decision, one event wait a served batch, one a checkpoint
stage); the serving fleet's transport, replica processes and supervisor
move frames and host numpy and read the device only to publish a model
artifact; the observability plane never reads it.  Any other read stalls the host behind the device.

This check scans the guarded modules for the torch calls that wait for the
device or copy from it — ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``torch.cuda.synchronize`` and an event's or stream's
``.synchronize()`` — and fails unless a ``host-sync:`` marker comment sits
on the same line or within the three lines above it (the reference's
window).  A new read in a hot loop thus needs a visible, reviewed note.

Usage: ``python -m photon_tpu_torch.tools.check_host_sync [files...]``
(default: the guarded modules).  Exit code 0 = clean, 1 = unmarked syncs.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent

# Module paths under the package; a directory guards every module in it.
DEFAULT_FILES = (
    "game/descent.py",
    "game/batched_solve.py",
    # The streamed descent moves score data per chunk by design, in bulk
    # copies that carry a marker; its scalar reads are the resident ones.
    "game/tiles.py",
    "game/stream_descent.py",
    "core/optimizers",
    "serving/scorer.py",
    "serving/batcher.py",
    # The fleet's process and wire layers are host IO: frames and numpy.
    # Their one sanctioned fetch is the artifact publish, once a version.
    "serving/transport.py",
    "serving/netfault.py",
    "serving/replica_proc.py",
    "serving/supervisor.py",
    # The observability plane is host bookkeeping over plain dicts: an
    # observer that read the device would be the latency it measures.
    "telemetry/distributed.py",
    "telemetry/live.py",
    "serving/observe.py",
    "online/feed.py",
    "online/delta.py",
    "online/service.py",
    "fault/checkpoint.py",
)

SYNC_PATTERN = re.compile(
    r"\.item\s*\(\s*\)|\.tolist\s*\(\s*\)|\.cpu\s*\(|\.numpy\s*\(|"
    r"torch\.cuda\.synchronize\s*\(|\.synchronize\s*\("
)
MARKER = "host-sync:"
MARKER_WINDOW = 3


def guarded_files() -> list:
    out = []
    for rel in DEFAULT_FILES:
        path = PACKAGE / rel
        out.extend(sorted(path.glob("*.py")) if path.is_dir() else [path])
    return out


def check_file(path: Path) -> list:
    """Unmarked sync call sites in ``path`` as ``(line_number, line)``."""
    lines = Path(path).read_text().splitlines()
    violations = []
    for i, line in enumerate(lines):
        stripped = line.strip()
        if stripped.startswith("#") or not SYNC_PATTERN.search(line.split("#")[0]):
            continue
        window = lines[max(0, i - MARKER_WINDOW): i + 1]
        if not any(MARKER in w for w in window):
            violations.append((i + 1, stripped))
    return violations


def main(argv: list) -> int:
    files = [Path(a) for a in argv] if argv else guarded_files()
    failed = False
    for path in files:
        for lineno, line in check_file(path):
            failed = True
            print(f"{path}:{lineno}: unmarked host sync: {line}")
    if failed:
        print(
            "\nThe port's hot loops read the device only at their chosen "
            "points.  If this read is one, say why in a `# host-sync: <why>` "
            "comment on its line or within the three lines above it."
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
