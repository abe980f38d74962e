"""Local-filesystem model store — the `LOCALFS` source type.

The port's own copy of ``incubator_predictionio_tpu/data/storage/localfs.py``.
Reference: storage/localfs/.../LocalFSModels.scala — model blobs as files
under a base directory.
"""

from __future__ import annotations

import os
from typing import Optional

from . import base


class LocalFSModels(base.Models):
    def __init__(self, basedir: str):
        self._dir = basedir
        os.makedirs(basedir, exist_ok=True)

    def _path(self, model_id: str) -> str:
        safe = model_id.replace("/", "_")
        return os.path.join(self._dir, f"pio_model_{safe}.bin")

    def insert(self, model: base.Model) -> None:
        tmp = self._path(model.id) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(model.models)
        os.replace(tmp, self._path(model.id))

    def get(self, model_id: str) -> Optional[base.Model]:
        p = self._path(model_id)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return base.Model(model_id, f.read())

    def exists(self, model_id: str) -> bool:
        return os.path.exists(self._path(model_id))

    def delete(self, model_id: str) -> None:
        p = self._path(model_id)
        if os.path.exists(p):
            os.remove(p)


class LocalFSClient(base.BaseStorageClient):
    """`TYPE=LOCALFS`; property PATH = base directory for model files."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        if "PATH" in config.properties:
            self._path = config.properties["PATH"]
        else:
            from .registry import base_dir

            self._path = os.path.join(base_dir(), "models")

    def models(self, namespace: str = "pio_modeldata") -> base.Models:
        return LocalFSModels(os.path.join(self._path, namespace))
