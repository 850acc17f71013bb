"""GAME models: fixed effect, random effect and the composite GameModel.

Counterpart of ``photon_tpu/game/model.py``.  A random-effect model is one
coefficient table ``[num_entities, dim]`` on the device beside its sorted
entity keys; scoring joins rows to entities by a gather of the table.
Coordinate scores are raw margins (no offset, no link); the dataset offset
is added once when they are combined.  Entities never seen in training
score 0.

:func:`game_model_from_numpy` carries a GAME model trained by the JAX
package (its arrays as numpy) across, as ``models.glm.from_numpy`` does for
a GLM.  The serving table and its low-precision storage forms wait with
serving (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from photon_tpu_torch.core.losses import get_loss
from photon_tpu_torch.data.batch import DenseBatch, SparseBatch
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game.data import (
    DenseShard,
    GameDataset,
    Shard,
    entity_index_for,
    keys_match,
)
from photon_tpu_torch.models.glm import (
    Coefficients,
    GeneralizedLinearModel,
    model_for_task,
)

Tensor = torch.Tensor


def _f32(values, device) -> Tensor:
    # A read-only array (a view of a JAX buffer) is copied; torch cannot
    # share it.
    return torch.as_tensor(np.require(values, np.float32, ["W"]), device=device)


def shard_to_batch(shard: Shard, label, offset=None, weight=None, device=None):
    """Device batch for one feature shard of a GameDataset."""
    dev = resolve_device(device)
    n = len(label)
    label = _f32(label, dev)
    offset = (torch.zeros(n, dtype=torch.float32, device=dev)
              if offset is None else _f32(offset, dev))
    weight = (torch.ones(n, dtype=torch.float32, device=dev)
              if weight is None else _f32(weight, dev))
    if isinstance(shard, DenseShard):
        return DenseBatch(_f32(shard.x, dev), label, offset, weight)
    return SparseBatch(
        torch.as_tensor(np.asarray(shard.ids, np.int32), device=dev),
        _f32(shard.vals, dev), label, offset, weight,
    )


def shard_feats(shard: Shard, device) -> tuple:
    """A shard's features on ``device``: ``(leaves, dense)`` with leaves
    ``(x,)`` or ``(ids, vals)``."""
    if isinstance(shard, DenseShard):
        return (_f32(shard.x, device),), True
    return (torch.as_tensor(np.asarray(shard.ids, np.int32), device=device),
            _f32(shard.vals, device)), False


def fixed_margins(w: Tensor, feats: tuple, dense: bool) -> Tensor:
    """``w . x_i`` per row."""
    if dense:
        return feats[0] @ w
    ids, vals = feats
    return (w[ids.long()] * vals).sum(-1)


def random_margins(table: Tensor, entity_idx: Tensor, feats: tuple,
                   dense: bool) -> Tensor:
    """Per-row margins against the row's entity's coefficients; rows of an
    unseen entity (index -1) score 0."""
    safe = torch.clamp_min(entity_idx, 0).long()
    if dense:
        m = (feats[0] * table[safe]).sum(-1)
    else:
        ids, vals = feats
        m = (table[safe[:, None], ids.long()] * vals).sum(-1)
    return torch.where(entity_idx >= 0, m, torch.zeros_like(m))


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Global GLM on one feature shard."""

    model: GeneralizedLinearModel
    shard_name: str

    @property
    def coefficients(self) -> Coefficients:
        return self.model.coefficients

    def score(self, data: GameDataset) -> np.ndarray:
        """Raw margins ``w . x_i`` over the dataset's shard (no offset)."""
        w = self.coefficients.means
        feats, dense = shard_feats(data.shard(self.shard_name), w.device)
        return fixed_margins(w, feats, dense).cpu().numpy()

    def margins_device(self, feats: tuple, dense: bool) -> Tensor:
        """Margins against features already on the device."""
        return fixed_margins(self.coefficients.means, feats, dense)


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity coefficient table of one random-effect coordinate:
    ``table[i]`` belongs to entity ``keys[i]``."""

    table: Tensor  # [num_entities, dim]
    keys: np.ndarray  # sorted entity vocabulary
    entity_column: str
    shard_name: str
    task_type: str
    variances: Optional[Tensor] = None  # [num_entities, dim]

    @property
    def num_entities(self) -> int:
        return len(self.keys)

    @property
    def dim(self) -> int:
        return int(self.table.shape[1])

    def model_for_entity(self, key) -> Optional[GeneralizedLinearModel]:
        """One entity's GLM, or None for an unseen key."""
        idx = entity_index_for(np.asarray([key]), self.keys)[0]
        if idx < 0:
            return None
        variances = None if self.variances is None else self.variances[idx]
        return model_for_task(self.task_type, Coefficients(self.table[idx], variances))

    def score(self, data: GameDataset) -> np.ndarray:
        dev = self.table.device
        entity_idx = entity_index_for(data.id_columns[self.entity_column], self.keys)
        feats, dense = shard_feats(data.shard(self.shard_name), dev)
        return random_margins(
            self.table, torch.as_tensor(entity_idx, device=dev), feats, dense
        ).cpu().numpy()

    def margins_device(self, entity_idx: Tensor, feats: tuple, dense: bool) -> Tensor:
        """Margins against device features and a per-row entity index."""
        return random_margins(self.table, entity_idx, feats, dense)


class DeviceScoringCache:
    """One (validation) GameDataset's scoring data on the device: feature
    shards, labels and weights, and per-(column, vocabulary) row->entity
    indices, uploaded once and shared across sweep configurations and
    descent runs."""

    def __init__(self, data: GameDataset, device):
        self.data = data
        self.device = resolve_device(device)
        self.n = data.num_examples
        self._feats: Dict[str, tuple] = {}
        self._entity_idx: Dict[str, tuple] = {}
        self.label = _f32(data.label, self.device)
        self.weight = _f32(data.weight, self.device)

    def feats(self, shard_name: str) -> tuple:
        if shard_name not in self._feats:
            self._feats[shard_name] = shard_feats(
                self.data.shard(shard_name), self.device)
        return self._feats[shard_name]

    def entity_index(self, column: str, keys: np.ndarray) -> Tensor:
        """Per-row entity index of ``column`` against ``keys`` (-1 =
        unseen), cached per column for the latest vocabulary."""
        cached = self._entity_idx.get(column)
        if cached is not None and keys_match(keys, cached[0], cached[1]):
            return cached[2]
        arr = np.asarray(keys)
        idx = entity_index_for(self.data.id_columns[column], arr)
        dev = torch.as_tensor(idx, device=self.device)
        self._entity_idx[column] = (keys, arr, dev)
        return dev

    def score(self, model) -> Tensor:
        """One coordinate model's margins over the cached rows (``[n]``)."""
        if isinstance(model, FixedEffectModel):
            feats, dense = self.feats(model.shard_name)
            return model.margins_device(feats, dense)
        if isinstance(model, RandomEffectModel):
            entity_idx = self.entity_index(model.entity_column, model.keys)
            feats, dense = self.feats(model.shard_name)
            return model.margins_device(entity_idx, feats, dense)
        raise TypeError(
            f"cannot device-score a {type(model).__name__}; expected "
            "FixedEffectModel or RandomEffectModel"
        )


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Ordered per-coordinate model container; ``task_type`` fixes the link
    for prediction."""

    coordinates: Dict[str, object]
    task_type: str

    def coordinate(self, name: str):
        return self.coordinates[name]

    def score(self, data: GameDataset) -> np.ndarray:
        """Total raw score: dataset offset + sum of coordinate margins,
        accumulated in float64 on the host."""
        total = data.offset.astype(np.float64).copy()
        for model in self.coordinates.values():
            total += np.asarray(model.score(data), np.float64)
        return total.astype(np.float32)

    def predict(self, data: GameDataset) -> np.ndarray:
        """The task's mean function of the total score."""
        loss = get_loss(self.task_type)
        return loss.mean(torch.as_tensor(self.score(data))).numpy()


def game_model_from_numpy(task_type: str, coordinates: Dict[str, dict],
                          device=None) -> GameModel:
    """A GameModel on ``device`` from per-coordinate arrays, e.g. those of a
    GAME model trained by the JAX package (``np.asarray`` of its tables).

    ``coordinates`` maps name -> ``{"type": "fixed", "shard_name", "means",
    "variances"}`` or ``{"type": "random", "shard_name", "entity_column",
    "keys", "table", "variances"}`` (``variances`` optional), in the
    model's coordinate order."""
    dev = resolve_device(device)

    def put(a):
        return None if a is None else _f32(a, dev)

    out: Dict[str, object] = {}
    for name, spec in coordinates.items():
        kind = spec.get("type")
        if kind == "fixed":
            out[name] = FixedEffectModel(
                model=model_for_task(task_type, Coefficients(
                    put(spec["means"]), put(spec.get("variances")))),
                shard_name=spec["shard_name"],
            )
        elif kind == "random":
            keys = np.asarray(spec["keys"])
            if len(keys) > 1 and not (keys[1:] > keys[:-1]).all():
                raise ValueError(f"coordinate {name!r}: keys must be sorted and unique")
            out[name] = RandomEffectModel(
                table=put(spec["table"]), keys=keys,
                entity_column=spec["entity_column"], shard_name=spec["shard_name"],
                task_type=task_type, variances=put(spec.get("variances")),
            )
        else:
            raise ValueError(f"coordinate {name!r}: unknown type {kind!r}")
    return GameModel(coordinates=out, task_type=task_type)
