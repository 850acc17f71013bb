"""Shared disk-cache root resolution.

A copy of ``photon_tpu/utils/caches.py`` (the port imports nothing of the
JAX package).

Three host-side caches share one precedence contract — the exchange
routes (``PHOTON_ROUTE_CACHE``), the streamed-chunk layouts
(``PHOTON_STREAM_LAYOUT_CACHE``), and the aligned layouts
(``PHOTON_LAYOUT_CACHE``): a specific env var overrides (value ``"0"``
disables), otherwise they live in subdirectories of the route-cache
root so one knob relocates or disables everything together.  One helper
so the contract cannot drift between hand-rolled copies.
"""

from __future__ import annotations

import functools
import os
from typing import Optional


@functools.lru_cache(maxsize=1)
def default_route_cache_root() -> str:
    """Resolve the default cache root ONCE per process: back-compat
    honors an existing CWD cache (pre-round-5 default, and how this
    host's pre-built production routes are stored); otherwise cache
    files stay out of the working directory (ADVICE r4) under the
    conventional user cache root.  Memoized so a mid-process chdir
    cannot flip the location and split a cache across two roots
    (the env overrides are still read per call by callers)."""
    legacy = os.path.abspath(".photon_route_cache")
    if os.path.isdir(legacy):
        return legacy
    return os.path.join(
        os.path.expanduser("~"), ".cache", "photon_tpu", "routes"
    )


def resolve_cache_dir(env_name: str, subdir: str) -> Optional[str]:
    """The directory a named cache should use, or None when disabled.

    ``env_name`` (when set in the environment) overrides; its value
    ``"0"`` disables.  Otherwise the cache follows ``PHOTON_ROUTE_CACHE``
    (same ``"0"`` semantics) into ``<route root>/<subdir>`` — with
    ``subdir == ""`` meaning the route root itself (how the route cache
    resolves its own root: an explicit override and the followed root
    coincide there).
    """
    root = os.environ.get(env_name)
    if root == "0":
        return None
    if root is not None:
        return root  # explicit override: use as-is
    base = os.environ.get("PHOTON_ROUTE_CACHE")
    if base == "0":
        return None
    if base is None:
        base = default_route_cache_root()
    return os.path.join(base, subdir) if subdir else base
