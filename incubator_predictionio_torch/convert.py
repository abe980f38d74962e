"""Weights carried across between the JAX package and the port.

The reference's templates persist dicts of numpy factors plus persisted
BiMaps: the Recommendation template's ALSAlgorithm ``user_factors``,
``item_factors``, ``users``, ``items``; the Similar-Product template
``user_factors``, ``item_factors``, ``items``, ``item_categories``. The
port persists exactly the same dicts, so the conversion is a re-binding
onto a device, with no numeric change.
"""

from __future__ import annotations

from .models import recommendation, similar_product

_ALS_KEYS = {"user_factors", "item_factors", "users", "items"}
_SIMILAR_KEYS = {"user_factors", "item_factors", "items", "item_categories"}


def from_jax_persisted(stored: dict, device="cuda"):
    """A reference-persisted Recommendation or Similar-Product model dict
    → the port's model on ``device`` (told apart by their keys)."""
    if "item_categories" in stored:
        missing = _SIMILAR_KEYS - set(stored)
        if not missing:
            return similar_product.model_from_persisted(stored, device)
    else:
        missing = _ALS_KEYS - set(stored)
        if not missing:
            return recommendation.model_from_persisted(stored, device)
    raise ValueError(f"not a persisted ALS model: missing {sorted(missing)}")


def to_jax_persisted(model) -> dict:
    """The port's model → a dict the reference's ``restore_model`` loads."""
    if isinstance(model, similar_product.SimilarProductModel):
        return similar_product.model_to_persisted(model)
    return recommendation.model_to_persisted(model)
