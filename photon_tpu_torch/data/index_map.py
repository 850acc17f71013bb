"""Feature index maps: (name, term) <-> integer id.

A copy of ``photon_tpu/data/index_map.py``'s :class:`IndexMap` (the
off-heap store waits in ROADMAP.md queue 1): the same keys and the same JSON
file, so the two packages read each other's ``feature_index.json``.

Feature keys follow the reference's Avro convention: a feature is a
``name`` + ``term`` pair rendered as ``"name\x01term"`` (the reference uses a
similar delimiter-joined key), with the intercept under a reserved key.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, Optional

import numpy as np

DELIMITER = "\x01"
INTERCEPT_KEY = "(INTERCEPT)"


def feature_key(name: str, term: str = "") -> str:
    return f"{name}{DELIMITER}{term}" if term else name


class IndexMap:
    """Bidirectional feature-key <-> id map with O(1) lookups.

    ``intercept_id`` is set when the map was built with an intercept feature
    (always the last id, matching ``to_sparse_batch``'s convention).
    """

    def __init__(self, keys: list[str], intercept: bool = False):
        if intercept and INTERCEPT_KEY not in keys:
            keys = list(keys) + [INTERCEPT_KEY]
        self._keys = list(keys)
        self._index = {k: i for i, k in enumerate(self._keys)}
        if len(self._index) != len(self._keys):
            raise ValueError("duplicate feature keys in index map")
        self.intercept_id: Optional[int] = self._index.get(INTERCEPT_KEY)

    # -- lookups --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def get_id(self, key: str, default: int = -1) -> int:
        return self._index.get(key, default)

    def get_key(self, idx: int) -> str:
        return self._keys[idx]

    def keys(self) -> Iterator[str]:
        return iter(self._keys)

    def ids_for(self, keys: Iterable[str]) -> np.ndarray:
        return np.asarray([self.get_id(k) for k in keys], np.int32)

    # -- construction ---------------------------------------------------------
    @classmethod
    def build(cls, keys: Iterable[str], intercept: bool = True) -> "IndexMap":
        """Build from an iterable of (possibly repeated) feature keys,
        assigning ids in first-seen order (deterministic, like the
        reference's indexing job output for a fixed input order)."""
        seen: dict[str, None] = {}
        for k in keys:
            if k not in seen:
                seen[k] = None
        return cls(list(seen), intercept=intercept)

    # -- persistence ----------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": 1, "keys": self._keys}, f)

    @classmethod
    def load(cls, path: str) -> "IndexMap":
        with open(path) as f:
            payload = json.load(f)
        return cls(payload["keys"])
