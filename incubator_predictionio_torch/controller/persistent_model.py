"""PersistentModel — models that persist themselves.

Port of ``incubator_predictionio_tpu/controller/persistent_model.py``
(reference: core/.../controller/PersistentModel.scala). ``run_train`` calls
``model.save(instance_id, params)`` for such a model and stores only a
marker naming its class in the model blob (``workflow/core_workflow.py``);
a deploy resolves that class (never one of the JAX package) and calls its
``load(instance_id, ctx)``.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from ..data.storage.registry import base_dir


class PersistentModel:
    """Mixin: a model that handles its own persistence. ``save`` returns
    True when the model persisted itself."""

    def save(self, instance_id: str, params: Any) -> bool:
        raise NotImplementedError


class PersistentModelLoader:
    """Companion loader (reference: PersistentModelLoader.apply)."""

    @classmethod
    def load(cls, instance_id: str, params: Any, ctx) -> Any:
        raise NotImplementedError


def model_dir(instance_id: str) -> str:
    """``$PIO_FS_BASEDIR/persistent_models/<instance id>`` (created)."""
    d = os.path.join(base_dir(), "persistent_models", instance_id)
    os.makedirs(d, exist_ok=True)
    return d


class LocalFileSystemPersistentModel(PersistentModel):
    """An ``np.savez`` file ``<class name>.npz`` under :func:`model_dir`.
    Subclasses implement ``to_arrays`` / ``from_arrays``; loading never
    unpickles."""

    def to_arrays(self) -> dict:
        raise NotImplementedError

    @classmethod
    def from_arrays(cls, arrays: dict) -> "LocalFileSystemPersistentModel":
        raise NotImplementedError

    def save(self, instance_id: str, params: Any) -> bool:
        path = os.path.join(model_dir(instance_id),
                            f"{type(self).__name__}.npz")
        np.savez(path, **{k: np.asarray(v)
                          for k, v in self.to_arrays().items()})
        return True

    @classmethod
    def load(cls, instance_id: str, ctx=None):
        path = os.path.join(model_dir(instance_id), f"{cls.__name__}.npz")
        with np.load(path, allow_pickle=False) as z:
            return cls.from_arrays({k: z[k] for k in z.files})
