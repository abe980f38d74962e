"""Weights carried across between the JAX package and the port.

The reference's ``ALSAlgorithm.prepare_model_for_persistence`` gives a dict
of numpy factors plus persisted BiMaps (``user_factors``, ``item_factors``,
``users``, ``items``). The port persists exactly the same dict, so the
conversion is a re-binding onto a device, with no numeric change.
"""

from __future__ import annotations

from .models.recommendation import (
    ALSModel, model_from_persisted, model_to_persisted,
)


def from_jax_persisted(stored: dict, device="cuda") -> ALSModel:
    """A reference-persisted ALS model dict → the port's model on ``device``."""
    missing = {"user_factors", "item_factors", "users", "items"} - set(stored)
    if missing:
        raise ValueError(f"not a persisted ALS model: missing {sorted(missing)}")
    return model_from_persisted(stored, device)


def to_jax_persisted(model: ALSModel) -> dict:
    """The port's model → a dict the reference's ``restore_model`` loads."""
    return model_to_persisted(model)
