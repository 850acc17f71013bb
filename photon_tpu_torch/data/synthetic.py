"""Seeded synthetic GAME data for tests, drivers and the on-card smoke run.

A numpy copy of ``make_game_data`` and ``make_game_dataset`` from
``photon_tpu/data/synthetic.py``: with the same arguments they return the
reference's arrays bit for bit (``tests/test_torch_game.py``).  They feed
the GAME driver's ``synthetic-game:`` input.
"""

from __future__ import annotations

import numpy as np


def make_game_data(
    n_entities: int,
    rows_per_entity_mean: int,
    fixed_dim: int,
    random_dim: int,
    seed: int = 0,
    n_random_coords: int = 1,
):
    """Synthetic GAME data: global fixed effect + per-entity random effects.

    Returns a dict with dense feature blocks, labels, and per-coordinate
    entity ids — the host-side precursor the GAME data pipeline buckets.
    Row counts per entity are skewed (geometric-ish) to exercise the
    ragged-bucketing path.
    """
    rng = np.random.default_rng(seed)
    counts = np.maximum(1, rng.geometric(1.0 / rows_per_entity_mean, n_entities))
    n = int(counts.sum())
    x_fixed = rng.normal(size=(n, fixed_dim)).astype(np.float32)
    x_fixed[:, -1] = 1.0  # intercept
    w_fixed = (rng.normal(size=fixed_dim) * 0.5).astype(np.float32)
    z = x_fixed @ w_fixed

    entity_ids = {}
    x_random = {}
    for c in range(n_random_coords):
        ids = np.repeat(np.arange(n_entities), counts)
        perm = rng.permutation(n) if c > 0 else np.arange(n)
        ids = ids[perm]
        entity_ids[f"re{c}"] = ids.astype(np.int64)
        xr = rng.normal(size=(n, random_dim)).astype(np.float32)
        xr[:, -1] = 1.0
        x_random[f"re{c}"] = xr
        w_re = (rng.normal(size=(n_entities, random_dim)) * 0.5).astype(np.float32)
        z = z + np.sum(xr * w_re[ids], axis=1)

    p = 1.0 / (1.0 + np.exp(-z))
    y = (rng.random(n) < p).astype(np.float32)
    return {
        "x_fixed": x_fixed,
        "x_random": x_random,
        "entity_ids": entity_ids,
        "label": y,
        "weight": np.ones(n, np.float32),
        "n_entities": n_entities,
    }


def make_game_dataset(
    n_entities: int,
    rows_per_entity_mean: int,
    fixed_dim: int,
    random_dim: int,
    seed: int = 0,
    n_random_coords: int = 1,
):
    """GAME data as a ready-to-train ``GameDataset`` + per-shard index maps.

    Shards: ``"global"`` (fixed effect) and ``"re0"``/``"re1"``… (one per
    random coordinate, with a same-named entity-id column).  The last column
    of every shard is the intercept, matching each shard's index map.
    """
    from photon_tpu_torch.data.index_map import IndexMap, feature_key
    from photon_tpu_torch.game.data import DenseShard, GameDataset

    raw = make_game_data(
        n_entities, rows_per_entity_mean, fixed_dim, random_dim,
        seed=seed, n_random_coords=n_random_coords,
    )

    def imap_for(dim: int) -> IndexMap:
        return IndexMap.build(
            [feature_key(f"f{i}") for i in range(dim - 1)], intercept=True
        )

    shards = {"global": DenseShard(raw["x_fixed"])}
    index_maps = {"global": imap_for(fixed_dim)}
    id_columns = {}
    for name, ids in raw["entity_ids"].items():
        shards[name] = DenseShard(raw["x_random"][name])
        index_maps[name] = imap_for(random_dim)
        id_columns[name] = ids
    data = GameDataset.create(raw["label"], shards, id_columns=id_columns)
    return data, index_maps
