"""GAME models: fixed effect, random effect and the composite GameModel.

Counterpart of ``photon_tpu/game/model.py``.  A random-effect model is one
coefficient table ``[num_entities, dim]`` on the device beside its sorted
entity keys; scoring joins rows to entities by a gather of the table.
Coordinate scores are raw margins (no offset, no link); the dataset offset
is added once when they are combined.  Entities never seen in training
score 0.

:func:`game_model_from_numpy` carries a GAME model trained by the JAX
package (its arrays as numpy) across, as ``models.glm.from_numpy`` does for
a GLM.

The serving forms feed :mod:`photon_tpu_torch.serving`: a fixed effect's
weight vector (:meth:`FixedEffectModel.serving_weights`) and one gather
table per random effect (:meth:`RandomEffectModel.serving_table`), whose
rows past the vocabulary are zero, in f32, bf16 or int8 storage.  Every
multiply-accumulate of :func:`serving_fixed_margins` and
:func:`serving_gather_margins` is float32; only the storage narrows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from photon_tpu_torch.core.losses import get_loss
from photon_tpu_torch.data.batch import DenseBatch, SparseBatch
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.game import lowp
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

#: The words of a serving table's refusal of a vocabulary past its capacity
#: (a scorer's ``swap_model`` raises it): the online loop rebuilds the
#: fleet's scorers when a publish meets it.
CAPACITY_REFUSAL = "rebuild the scorer instead of hot-swapping"


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


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
        return DenseBatch(lowp.feature_tensor(shard.x, dev), label, offset, weight)
    return SparseBatch(
        torch.as_tensor(np.asarray(shard.ids, np.int32), device=dev),
        lowp.feature_tensor(shard.vals, dev), label, offset, weight,
    )


def shard_feats(shard: Shard, device) -> tuple:
    """A shard's features on ``device``: ``(leaves, dense)`` with leaves
    ``(x,)`` or ``(ids, vals)``; bf16 values stay bf16
    (``lowp.feature_tensor``)."""
    if isinstance(shard, DenseShard):
        return (lowp.feature_tensor(shard.x, device),), True
    return (torch.as_tensor(np.asarray(shard.ids, np.int32), device=device),
            lowp.feature_tensor(shard.vals, device)), False


def fixed_margins(w: Tensor, feats: tuple, dense: bool) -> Tensor:
    """``w . x_i`` per row (bf16 features widen before the product)."""
    if dense:
        return feats[0].to(w.dtype) @ w
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


def serving_fixed_margins(w: Tensor, feats: tuple, dense: bool) -> Tensor:
    """``w . x_i`` per row as the serving programs compute it.  The dense
    form is an elementwise product and a sum, never a matmul: a matmul may
    run in TF32 on the card, and the serving parity rule is float32."""
    if dense:
        return (feats[0] * w).sum(-1)
    return fixed_margins(w, feats, dense)


def serving_gather_margins(table, safe_idx: Tensor, feats: tuple,
                           dense: bool) -> Tensor:
    """Margins through the serving gather convention: ``safe_idx`` is in the
    table already (unknown entities mapped by the caller to the zero row of
    :meth:`RandomEffectModel.serving_table`), so the gather itself gives the
    fixed-effect-only fallback with no output mask.

    ``table`` is the storage form: an f32 or bf16 ``[capacity, dim]``
    tensor, or an int8 ``(q, scale)`` pair.  The gather moves the stored
    bytes and the decode runs on the gathered block; the accumulation is
    float32."""
    idx = safe_idx.long()
    if isinstance(table, tuple):
        q, scale = table
        row_scale = scale[idx]
        if dense:
            rows = q[idx].to(torch.float32) * row_scale[:, None]
            return (feats[0] * rows).sum(-1)
        ids, vals = feats
        gathered = q[idx[:, None], ids.long()].to(torch.float32)
        return (gathered * row_scale[:, None] * vals).sum(-1)
    if dense:
        return (feats[0] * table[idx].to(torch.float32)).sum(-1)
    ids, vals = feats
    return (table[idx[:, None], ids.long()].to(torch.float32) * vals).sum(-1)


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

    def serving_weights(self, device=None) -> Tensor:
        """The coefficient vector as the serving tables hold it: float32,
        contiguous, a copy of its own on ``device`` (the means' device by
        default)."""
        means = self.coefficients.means
        dev = means.device if device is None else resolve_device(device)
        return means.detach().to(device=dev, dtype=torch.float32,
                                 copy=True).contiguous()


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

    def with_entities(self, keys: np.ndarray) -> "RandomEffectModel":
        """This model grown to the superset vocabulary ``keys`` on the
        device (the onboarding warm start): existing entities keep their
        rows at their new sorted positions, new entities start at zero."""
        merged = np.asarray(keys)
        idx = entity_index_for(self.keys, merged)
        if (idx < 0).any():
            raise ValueError(
                "with_entities() grows the vocabulary: every existing "
                "entity key must appear in the merged keys")
        idx_dev = torch.as_tensor(idx, device=self.table.device).long()

        def scatter(table):
            grown = torch.zeros(len(merged), self.dim, dtype=torch.float32,
                                device=table.device)
            grown[idx_dev] = table.float()
            return grown

        return dataclasses.replace(
            self, table=scatter(self.table), keys=merged,
            variances=None if self.variances is None else scatter(self.variances))

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

    @property
    def serving_capacity(self) -> int:
        """Default row capacity of the serving gather table: the next power
        of two past ``num_entities + 1`` (the entities and the zero row).
        The headroom lets a grown vocabulary swap into a live scorer in
        place while ``num_entities + 1`` still fits."""
        return pow2_at_least(self.num_entities + 1)

    def serving_table(self, capacity: Optional[int] = None,
                      dtype: Optional[str] = None, device=None):
        """This coordinate's rows as one serving gather table on ``device``
        (the table's own by default): ``[capacity, dim]`` (default
        :attr:`serving_capacity`), rows ``num_entities`` .. ``capacity - 1``
        zero.  The scorer maps unknown entities to the zero row at
        ``num_entities``, so their margin is exactly zero.

        ``dtype`` is the storage tier: ``"f32"`` (default); ``"bf16"``, the
        same table cast; ``"int8"``, the pair ``(q int8 [capacity, dim],
        scale f32 [capacity])`` of :func:`lowp.quantize_int8_table`, whose
        zero rows store scale 0 and decode to exactly 0.  A vocabulary that
        no longer fits ``capacity`` is a layout-shape change and raises."""
        dtype = lowp.check_dtype(dtype)
        capacity = self.serving_capacity if capacity is None else int(capacity)
        if self.num_entities + 1 > capacity:
            raise ValueError(
                f"serving_table: vocabulary ({self.num_entities} entities "
                f"+ zero row) exceeds the table capacity {capacity}; "
                f"capacity growth is a layout-shape change — {CAPACITY_REFUSAL}"
            )
        dev = self.table.device if device is None else resolve_device(device)
        table = torch.zeros(capacity, self.dim, dtype=torch.float32, device=dev)
        table[: self.num_entities] = self.table.detach().to(dev, torch.float32)
        if dtype == "bf16":
            return table.to(torch.bfloat16)
        if dtype == "int8":
            return lowp.quantize_int8_table(table)
        return table


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
