"""GAME model directories: per-coordinate name/term-keyed Avro or JSON.

Counterpart of ``photon_tpu/game/model_io.py`` with the same layout and
records, so each package loads the other's models:

    <dir>/metadata.json                             task type, coordinate order
    <dir>/fixed-effect/<coord>/coefficients.avro    one GLM record
    <dir>/fixed-effect/<coord>/feature_index.json
    <dir>/random-effect/<coord>/coefficients.avro   one record per entity
    <dir>/random-effect/<coord>/feature_index.json

Coefficients are keyed by (name, term), so a model survives a rebuilt
feature index.  The directory is written beside its destination and renamed
into place, so a reader never sees a half-written model.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from photon_tpu_torch.data import avro_codec
from photon_tpu_torch.data.index_map import IndexMap, feature_key
from photon_tpu_torch.data.model_io import (
    NAME_TERM_VALUE_SCHEMA,
    _ntv_list,
    load_glm_model,
    save_glm_model,
)
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game.model import FixedEffectModel, GameModel, RandomEffectModel
from photon_tpu_torch.models.glm import model_for_task

RANDOM_EFFECT_SCHEMA = {
    "type": "record",
    "name": "RandomEffectModelAvro",
    "namespace": "photon_tpu.generated",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "means", "type": {"type": "array", "items": NAME_TERM_VALUE_SCHEMA}},
        {
            "name": "variances",
            "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
            "default": None,
        },
    ],
}


def save_game_model(dir_path: str, model: GameModel,
                    index_maps: Dict[str, IndexMap], fmt: str = "avro") -> None:
    """Write ``model`` under ``dir_path``; ``index_maps`` is keyed by
    feature-shard name.  The whole directory is built in a hidden sibling
    and renamed into place."""
    dir_path = os.path.abspath(dir_path)
    parent, base = os.path.split(dir_path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{base}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        _write_game_model(tmp, model, index_maps, fmt)
        old = None
        if os.path.exists(dir_path):
            old = os.path.join(parent, f".{base}.old-{os.getpid()}")
            os.rename(dir_path, old)
        os.rename(tmp, dir_path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def _write_game_model(dir_path: str, model: GameModel,
                      index_maps: Dict[str, IndexMap], fmt: str) -> None:
    if fmt not in ("avro", "json"):
        raise ValueError(f"unknown model format {fmt!r}")
    os.makedirs(dir_path, exist_ok=True)
    meta = {"version": 1, "task_type": model.task_type, "coordinates": []}
    for name, coord in model.coordinates.items():
        if isinstance(coord, FixedEffectModel):
            coord_dir = os.path.join(dir_path, "fixed-effect", name)
            imap = index_maps[coord.shard_name]
            save_glm_model(os.path.join(coord_dir, f"coefficients.{fmt}"),
                           coord.model, imap, fmt=fmt)
            meta["coordinates"].append(
                {"name": name, "type": "fixed", "shard_name": coord.shard_name})
        elif isinstance(coord, RandomEffectModel):
            coord_dir = os.path.join(dir_path, "random-effect", name)
            os.makedirs(coord_dir, exist_ok=True)
            imap = index_maps[coord.shard_name]
            table, variances = _host(coord.table), _host(coord.variances)
            records = [
                {
                    "modelId": str(key),
                    "means": _ntv_list(table[i], imap),
                    "variances": (None if variances is None
                                  else _ntv_list(variances[i], imap)),
                }
                for i, key in enumerate(coord.keys)
            ]
            path = os.path.join(coord_dir, f"coefficients.{fmt}")
            if fmt == "avro":
                avro_codec.write_container(path, RANDOM_EFFECT_SCHEMA, records)
            else:
                with open(path, "w") as f:
                    json.dump(records, f, indent=1)
            meta["coordinates"].append({
                "name": name, "type": "random", "shard_name": coord.shard_name,
                "entity_column": coord.entity_column,
            })
        else:
            raise TypeError(f"unknown coordinate model type {type(coord)!r}")
        imap.save(os.path.join(coord_dir, "feature_index.json"))
    with open(os.path.join(dir_path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1)


def _coeff_file(coord_dir: str) -> tuple[str, str]:
    for ext in ("avro", "json"):
        p = os.path.join(coord_dir, f"coefficients.{ext}")
        if os.path.exists(p):
            return p, ext
    raise FileNotFoundError(f"no coefficients file under {coord_dir}")


def _load_random_effect(coord_dir: str, meta: dict, imap: IndexMap,
                        task_type: str, device) -> RandomEffectModel:
    path, ext = _coeff_file(coord_dir)
    if ext == "avro":
        _, records = avro_codec.read_container(path)
    else:
        with open(path) as f:
            records = json.load(f)

    def to_vec(ntvs) -> np.ndarray:
        vec = np.zeros(len(imap), np.float32)
        for ntv in ntvs:
            idx = imap.get_id(feature_key(ntv["name"], ntv["term"]))
            if idx >= 0:
                vec[idx] = ntv["value"]
        return vec

    raw_keys = [r["modelId"] for r in records]
    # Keys were written as strings; they come back as int64 when every key
    # parses and the parse keeps them distinct ('01' and '1' stay strings).
    try:
        ints = [int(k) for k in raw_keys]
        parsed = (np.asarray(ints, dtype=np.int64) if len(set(ints)) == len(ints)
                  else np.asarray(raw_keys))
    except (ValueError, OverflowError):
        parsed = np.asarray(raw_keys)
    order = np.argsort(parsed, kind="stable")
    keys = parsed[order]
    has_var = any(r.get("variances") is not None for r in records)
    table = np.zeros((len(records), len(imap)), np.float32)
    variances = np.zeros_like(table) if has_var else None
    for out_i, rec_i in enumerate(order):
        rec = records[rec_i]
        table[out_i] = to_vec(rec["means"])
        if has_var and rec.get("variances") is not None:
            variances[out_i] = to_vec(rec["variances"])
    return RandomEffectModel(
        table=torch.as_tensor(table, device=device), keys=keys,
        entity_column=meta["entity_column"], shard_name=meta["shard_name"],
        task_type=task_type,
        variances=None if variances is None else torch.as_tensor(variances, device=device),
    )


def load_game_model(dir_path: str, index_maps: Optional[Dict[str, IndexMap]] = None,
                    device=None) -> tuple[GameModel, Dict[str, IndexMap]]:
    """Load a GAME model directory onto ``device``.  Each coordinate's
    saved feature index is used unless ``index_maps`` gives its shard's,
    onto which the stored keys are then joined."""
    dev = resolve_device(device)
    with open(os.path.join(dir_path, "metadata.json")) as f:
        meta = json.load(f)
    task_type = meta["task_type"]
    coordinates = {}
    maps_out: Dict[str, IndexMap] = {}
    for cmeta in meta["coordinates"]:
        name, ctype = cmeta["name"], cmeta["type"]
        sub = "fixed-effect" if ctype == "fixed" else "random-effect"
        coord_dir = os.path.join(dir_path, sub, name)
        shard = cmeta["shard_name"]
        if index_maps is not None and shard in index_maps:
            imap = index_maps[shard]
        else:
            imap = IndexMap.load(os.path.join(coord_dir, "feature_index.json"))
        maps_out[shard] = imap
        if ctype == "fixed":
            path, fmt = _coeff_file(coord_dir)
            glm = load_glm_model(path, imap, fmt=fmt, device=dev)
            coordinates[name] = FixedEffectModel(
                model=model_for_task(task_type, glm.coefficients), shard_name=shard)
        else:
            coordinates[name] = _load_random_effect(coord_dir, cmeta, imap,
                                                    task_type, dev)
    return GameModel(coordinates=coordinates, task_type=task_type), maps_out

