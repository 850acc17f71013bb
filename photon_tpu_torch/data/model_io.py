"""Model persistence: name/term-keyed coefficients in Avro or JSON.

Counterpart of ``photon_tpu/data/model_io.py`` with the same schema and the
same record, so each package reads the other's model files.  Coefficients
are keyed by their (name, term) feature strings; loading joins the stored
keys onto the current index map and drops keys it does not hold.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from photon_tpu_torch.data import avro_codec
from photon_tpu_torch.data.index_map import DELIMITER, INTERCEPT_KEY, IndexMap
from photon_tpu_torch.models.glm import GeneralizedLinearModel, from_numpy

NAME_TERM_VALUE_SCHEMA = {
    "type": "record",
    "name": "NameTermValueAvro",
    "namespace": "photon_tpu.generated",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

GLM_MODEL_SCHEMA = {
    "type": "record",
    "name": "BayesianLinearModelAvro",
    "namespace": "photon_tpu.generated",
    "fields": [
        {"name": "modelClass", "type": "string"},
        {"name": "means", "type": {"type": "array", "items": NAME_TERM_VALUE_SCHEMA}},
        {
            "name": "variances",
            "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
            "default": None,
        },
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}


def _split_key(key: str) -> tuple[str, str]:
    if DELIMITER in key:
        name, term = key.split(DELIMITER, 1)
        return name, term
    return key, ""


def _ntv_list(values: np.ndarray, index_map: IndexMap):
    """Name/term/value records of the non-zero coefficients (the intercept
    is always kept)."""
    out = []
    for i, v in enumerate(values):
        if float(v) == 0.0 and index_map.get_key(i) != INTERCEPT_KEY:
            continue
        name, term = _split_key(index_map.get_key(i))
        out.append({"name": name, "term": term, "value": float(v)})
    return out


def save_glm_model(
    path: str, model: GeneralizedLinearModel, index_map: IndexMap, fmt: str = "avro"
) -> None:
    """Write a single GLM as one name/term-keyed record."""
    variances = model.coefficients.variances
    record = {
        "modelClass": model.task_type,
        "means": _ntv_list(model.coefficients.means.cpu().numpy(), index_map),
        "variances": (
            None if variances is None
            else _ntv_list(variances.cpu().numpy(), index_map)
        ),
        "lossFunction": model.loss.name,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if fmt == "avro":
        avro_codec.write_container(path, GLM_MODEL_SCHEMA, [record])
    elif fmt == "json":
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    else:
        raise ValueError(f"unknown model format {fmt!r}")


def load_glm_model(
    path: str, index_map: IndexMap, fmt: Optional[str] = None, device=None
) -> GeneralizedLinearModel:
    """Load a GLM onto ``device``, joining stored keys onto ``index_map``."""
    if fmt is None:
        with open(path, "rb") as f:
            fmt = "avro" if f.read(4) == avro_codec.MAGIC else "json"
    if fmt == "avro":
        _, records = avro_codec.read_container(path)
        record = records[0]
    else:
        with open(path) as f:
            record = json.load(f)

    def to_vector(ntvs) -> np.ndarray:
        vec = np.zeros(len(index_map), np.float32)
        for ntv in ntvs:
            key = (
                f"{ntv['name']}{DELIMITER}{ntv['term']}" if ntv["term"] else ntv["name"]
            )
            idx = index_map.get_id(key)
            if idx >= 0:
                vec[idx] = ntv["value"]
        return vec

    variances = record.get("variances")
    return from_numpy(
        to_vector(record["means"]),
        None if variances is None else to_vector(variances),
        record["modelClass"], device,
    )
