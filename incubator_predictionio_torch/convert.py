"""Weights carried across between the JAX package and the port.

The reference's templates persist dicts of numpy arrays plus persisted
BiMaps: the Recommendation template's ALSAlgorithm ``user_factors``,
``item_factors``, ``users``, ``items``; the Similar-Product template
``user_factors``, ``item_factors``, ``items``, ``item_categories``; the
E-Commerce template ``user_factors``, ``item_factors``, ``users``,
``items``, ``item_categories``, ``app_name``, ``seen_event_names``; the
Universal Recommender ``indicators`` (event name → ``idx`` / ``score``),
``users``, ``items``, ``item_categories``, ``app_name``, ``event_names``,
``popularity``, ``item_dates``; the Complementary Purchase template
``idx``, ``score``, ``items``. The port's models hold the same values, so
the conversion is a re-binding onto a device, with no numeric change.
"""

from __future__ import annotations

import numpy as np

from .models import (
    classification, complementary_purchase, ecommerce, recommendation,
    similar_product, text_classification, universal_recommender,
)
from .ops.linear import LogisticRegressionModel, NaiveBayesModel
from .ops.tfidf import TfIdfVectorizer

_ALS_KEYS = {"user_factors", "item_factors", "users", "items"}
_SIMILAR_KEYS = {"user_factors", "item_factors", "items", "item_categories"}
_ECOMMERCE_KEYS = _ALS_KEYS | {"item_categories", "app_name",
                               "seen_event_names"}
_UR_KEYS = {"indicators", "users", "items", "item_categories", "app_name",
            "event_names"}
_CP_KEYS = {"idx", "score", "items"}


def from_jax_persisted(stored: dict, device="cuda", storage=None):
    """A reference-persisted Recommendation, Similar-Product, E-Commerce,
    Universal Recommender or Complementary Purchase model dict → the port's
    model on ``device`` (told apart by their keys; an E-Commerce or
    Universal Recommender model reads its serve-time history from
    ``storage``, the process's store when None)."""
    if "indicators" in stored:
        missing = _UR_KEYS - set(stored)
        if not missing:
            return universal_recommender.model_from_persisted(
                stored, device, storage)
    elif _CP_KEYS <= set(stored):
        return complementary_purchase.model_from_persisted(stored, device)
    elif "seen_event_names" in stored:
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
    raise ValueError(f"not a persisted model: missing {sorted(missing)}")


def to_jax_persisted(model) -> dict:
    """The port's model → a dict the reference's ``restore_model`` loads."""
    if isinstance(model, universal_recommender.URModel):
        return universal_recommender.model_to_persisted(model)
    if isinstance(model, complementary_purchase.ComplementaryModel):
        return complementary_purchase.model_to_persisted(model)
    if isinstance(model, ecommerce.ECommerceModel):
        return ecommerce.model_to_persisted(model)
    if isinstance(model, similar_product.SimilarProductModel):
        return similar_product.model_to_persisted(model)
    return recommendation.model_to_persisted(model)


def _linear_from_jax(inner):
    """A reference NaiveBayesModel or LogisticRegressionModel (told apart
    by their attributes) → the port's."""
    if hasattr(inner, "log_likelihood"):
        def opt(name):
            v = getattr(inner, name, None)
            return None if v is None else np.array(v, np.float32)

        return NaiveBayesModel(
            log_prior=np.array(inner.log_prior, np.float32),
            log_likelihood=np.array(inner.log_likelihood, np.float32),
            n_classes=int(inner.n_classes),
            feat_counts=opt("feat_counts"),
            class_counts=opt("class_counts"),
            smoothing=float(getattr(inner, "smoothing", 1.0)))
    return LogisticRegressionModel(
        weights=np.array(inner.weights, np.float32),
        intercept=np.array(inner.intercept, np.float32),
        n_classes=int(inner.n_classes))


def from_jax_classifier(obj) -> classification.ClassifierModel:
    """A reference ``ClassifierModel`` → the port's."""
    seen = getattr(obj, "foldin_seen", None)
    return classification.ClassifierModel(
        inner=_linear_from_jax(obj.inner),
        attribute_names=tuple(obj.attribute_names),
        label_values=np.array(obj.label_values),
        foldin_seen=None if seen is None else dict(seen))


def from_jax_text_model(obj) -> text_classification.TextModel:
    """A reference ``TextModel`` → the port's (the vectorizer through its
    ``to_arrays``)."""
    return text_classification.TextModel(
        inner=_linear_from_jax(obj.inner),
        vectorizer=TfIdfVectorizer.from_arrays(obj.vectorizer.to_arrays()),
        label_values=np.array(obj.label_values))
