"""Weights carried across between the JAX package and the port.

The reference's templates persist dicts of numpy factors plus persisted
BiMaps: the Recommendation template's ALSAlgorithm ``user_factors``,
``item_factors``, ``users``, ``items``; the Similar-Product template
``user_factors``, ``item_factors``, ``items``, ``item_categories``; the
E-Commerce template ``user_factors``, ``item_factors``, ``users``,
``items``, ``item_categories``, ``app_name``, ``seen_event_names``. The
port persists exactly the same dicts, so the conversion is a re-binding
onto a device, with no numeric change.
"""

from __future__ import annotations

from .models import ecommerce, recommendation, similar_product

_ALS_KEYS = {"user_factors", "item_factors", "users", "items"}
_SIMILAR_KEYS = {"user_factors", "item_factors", "items", "item_categories"}
_ECOMMERCE_KEYS = _ALS_KEYS | {"item_categories", "app_name",
                               "seen_event_names"}


def from_jax_persisted(stored: dict, device="cuda", storage=None):
    """A reference-persisted Recommendation, Similar-Product or E-Commerce
    model dict → the port's model on ``device`` (told apart by their keys;
    an E-Commerce model reads its serve-time exclusions from ``storage``,
    the process's store when None)."""
    if "seen_event_names" in stored:
        missing = _ECOMMERCE_KEYS - set(stored)
        if not missing:
            return ecommerce.model_from_persisted(stored, device, storage)
    elif "item_categories" in stored:
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
    if isinstance(model, ecommerce.ECommerceModel):
        return ecommerce.model_to_persisted(model)
    if isinstance(model, similar_product.SimilarProductModel):
        return similar_product.model_to_persisted(model)
    return recommendation.model_to_persisted(model)
