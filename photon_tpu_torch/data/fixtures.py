"""The MovieLens-shaped GAME fixture (BASELINE.json config 4).

A numpy copy of ``make_movielens_like`` and ``movielens_dataset`` from
``photon_tpu/data/fixtures.py``: with the same seed they give the
reference's arrays bit for bit.  MovieLens-1M itself cannot be fetched
here, so the generator reproduces its shape — 18 genre indicators plus an
intercept per rating, zipf item popularity, geometric per-user activity,
ratings >= 4 as positives (~57.5%) — and ``movielens_dataset`` reads the
real ``ml-1m`` files instead when ``PHOTON_REAL_DATA_DIR`` holds them.
"""

from __future__ import annotations

import os

import numpy as np


def make_movielens_like(
    n_users: int = 600,
    n_items: int = 400,
    mean_ratings: int = 18,
    seed: int = 13,
):
    """MovieLens-shaped GAME dataset + index maps (users x zipf items).

    Global fixed-effect features: item-genre indicators (18 genres, as in
    MovieLens-1M) + user demographic buckets; per-user random effect over
    the genre features — the canonical GLMix personalization setup.
    Returns ``(GameDataset, index_maps)`` ready for the GAME pipeline or
    :func:`photon_tpu_torch.data.game_io.write_game_avro`.
    """
    from photon_tpu_torch.data.index_map import IndexMap, feature_key
    from photon_tpu_torch.game.data import DenseShard, GameDataset

    rng = np.random.default_rng(seed)
    n_genres = 18
    item_genres = np.zeros((n_items, n_genres), np.float32)
    for i in range(n_items):
        k = 1 + rng.geometric(0.55)
        item_genres[i, rng.choice(n_genres, size=min(k, 4), replace=False)] = 1.0
    item_pop = 1.0 / (np.arange(n_items) + 2.0) ** 1.1
    item_pop /= item_pop.sum()

    user_taste = rng.standard_normal((n_users, n_genres)).astype(np.float32) * 0.9
    genre_quality = rng.standard_normal(n_genres).astype(np.float32) * 0.5
    item_bias = rng.standard_normal(n_items).astype(np.float32) * 0.6

    users, items, labels = [], [], []
    for u in range(n_users):
        n_r = max(3, int(rng.geometric(1.0 / mean_ratings)))
        seen = rng.choice(n_items, size=min(n_r, n_items), replace=False, p=item_pop)
        for it in seen:
            margin = (
                float(item_genres[it] @ (genre_quality + user_taste[u]))
                + float(item_bias[it])
                + 0.65  # ~57.5% of MovieLens-1M ratings are >= 4
            )
            y = 1.0 if rng.random() < 1.0 / (1.0 + np.exp(-margin)) else 0.0
            users.append(u)
            items.append(int(it))
            labels.append(y)
    users = np.asarray(users, np.int64)
    items = np.asarray(items, np.int64)
    labels = np.asarray(labels, np.float32)
    n = len(labels)

    # Global shard: genre indicators of the rated item + intercept.
    x_global = np.concatenate(
        [item_genres[items], np.ones((n, 1), np.float32)], axis=1
    )
    # Per-user shard: same genre indicators (the user's personal genre
    # model) + per-user intercept.
    x_user = x_global.copy()

    shards = {
        "global": DenseShard(x_global),
        "per_user": DenseShard(x_user),
    }
    index_maps = {}
    for name in shards:
        keys = [feature_key(f"genre{g}") for g in range(n_genres)]
        index_maps[name] = IndexMap.build(keys, intercept=True)
    data = GameDataset(
        shards=shards,
        label=labels,
        offset=np.zeros(n, np.float32),
        weight=np.ones(n, np.float32),
        id_columns={"userId": users, "itemId": items},
    )
    return data, index_maps


# MovieLens-1M genre vocabulary (README order; 18 genres).
_ML_GENRES = (
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
)


def movielens_dataset(**fixture_kw):
    """GAME MovieLens dataset: the REAL MovieLens-1M when operators provide
    it (``PHOTON_REAL_DATA_DIR/ml-1m/{ratings,movies}.dat``), else the
    statistics-matched generator :func:`make_movielens_like` with
    ``fixture_kw``.  Both return
    ``(GameDataset, index_maps)`` with identical shard structure, so bench
    config 4 and drivers are agnostic to which backs them."""
    real_dir = os.environ.get("PHOTON_REAL_DATA_DIR")
    if real_dir:
        mdir = os.path.join(real_dir, "ml-1m")
        if os.path.exists(os.path.join(mdir, "ratings.dat")) and os.path.exists(
            os.path.join(mdir, "movies.dat")
        ):
            return _movielens_real(mdir)
    return make_movielens_like(**fixture_kw)


def _movielens_real(mdir: str):
    """Parse the verbatim MovieLens-1M distribution into the GAME layout
    used by the fixture: label = rating >= 4, global + per-user shards of
    the rated item's genre indicators + intercept."""
    from photon_tpu_torch.data.index_map import IndexMap, feature_key
    from photon_tpu_torch.game.data import DenseShard, GameDataset

    n_genres = len(_ML_GENRES)
    gidx = {g: i for i, g in enumerate(_ML_GENRES)}
    genres_by_movie: dict = {}
    with open(os.path.join(mdir, "movies.dat"), encoding="latin-1") as f:
        for line in f:
            parts = line.rstrip("\n").split("::")
            if len(parts) != 3:
                continue
            vec = np.zeros(n_genres, np.float32)
            for g in parts[2].split("|"):
                gi = gidx.get(g.strip())
                if gi is not None:
                    vec[gi] = 1.0
            genres_by_movie[int(parts[0])] = vec
    users, items, labels = [], [], []
    with open(os.path.join(mdir, "ratings.dat"), encoding="latin-1") as f:
        for line in f:
            parts = line.split("::")
            if len(parts) < 3:
                continue
            movie = int(parts[1])
            if movie not in genres_by_movie:
                continue
            users.append(int(parts[0]))
            items.append(movie)
            labels.append(1.0 if float(parts[2]) >= 4.0 else 0.0)
    if not users:
        raise ValueError(
            f"no joinable ratings found in {mdir!r}: ratings.dat rows must "
            "reference movie ids present in movies.dat (truncated or "
            "mismatched MovieLens drop-in?)"
        )
    users = np.asarray(users, np.int64)
    items = np.asarray(items, np.int64)
    labels = np.asarray(labels, np.float32)
    n = len(labels)
    item_genres = np.stack([genres_by_movie[m] for m in items])
    x_global = np.concatenate([item_genres, np.ones((n, 1), np.float32)], axis=1)
    shards = {
        "global": DenseShard(x_global),
        "per_user": DenseShard(x_global.copy()),
    }
    index_maps = {
        name: IndexMap.build(
            [feature_key(f"genre{g}") for g in range(n_genres)], intercept=True
        )
        for name in shards
    }
    data = GameDataset(
        shards=shards,
        label=labels,
        offset=np.zeros(n, np.float32),
        weight=np.ones(n, np.float32),
        id_columns={"userId": users, "itemId": items},
    )
    return data, index_maps
