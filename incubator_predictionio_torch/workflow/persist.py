"""Persisted models: one ``.npz`` file (or model row) per trained engine.

Each algorithm's persisted dict (``prepare_model_for_persistence``) is
written entry by entry: numpy arrays as arrays, every other value (the
persisted BiMaps) as JSON text. The engine.json the models were trained
with rides along, so a deploy rebuilds the same engine. Loading never
unpickles (``allow_pickle=False``).
"""

from __future__ import annotations

import io
import json
import os
from pathlib import Path

import numpy as np

_ENGINE_KEY = "engine.json"


def models_to_bytes(engine_json: dict, stored: list[dict]) -> bytes:
    """The persisted models as ``.npz`` bytes: the payload of a model file
    and of a model row in the Models repository."""
    entries = {_ENGINE_KEY: np.array(json.dumps(engine_json))}
    for i, d in enumerate(stored):
        for key, value in d.items():
            if isinstance(value, np.ndarray):
                entries[f"{i}/{key}"] = value
            else:
                entries[f"{i}/{key}.json"] = np.array(json.dumps(value))
    buf = io.BytesIO()
    np.savez(buf, **entries)
    return buf.getvalue()


def models_from_bytes(payload: bytes) -> tuple[dict, list[dict]]:
    """Inverse of :func:`models_to_bytes`: (engine_json, [persisted dict
    per algorithm]). Never unpickles; bytes that are not such an ``.npz``
    raise."""
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        engine_json = json.loads(str(z[_ENGINE_KEY]))
        stored: dict[int, dict] = {}
        for name in z.files:
            if name == _ENGINE_KEY:
                continue
            idx, key = name.split("/", 1)
            d = stored.setdefault(int(idx), {})
            if key.endswith(".json"):
                d[key[:-len(".json")]] = json.loads(str(z[name]))
            else:
                d[key] = z[name]
    return engine_json, [stored[i] for i in sorted(stored)]


def engine_json_from_bytes(payload: bytes) -> dict:
    """The engine.json of persisted ``.npz`` bytes, without loading the
    model arrays."""
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return json.loads(str(z[_ENGINE_KEY]))


def save_models(path: "str | Path", engine_json: dict, stored: list[dict]) -> None:
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(models_to_bytes(engine_json, stored))
    os.replace(tmp, path)  # a reader never sees a half-written model


def load_models(path: "str | Path") -> tuple[dict, list[dict]]:
    """(engine_json, [persisted dict per algorithm])."""
    with open(path, "rb") as fh:
        return models_from_bytes(fh.read())
