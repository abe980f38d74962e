"""Serving-time business-rule filters: category, whiteList, blackList.

The port's own copy of ``incubator_predictionio_tpu/models/_filters.py``
(``CategoryIndex``, ``build_exclude_mask``). Category membership becomes
per-category boolean masks, built on first use, so a query costs a few
numpy vector operations.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from ..data.bimap import BiMap


class CategoryIndex:
    """category name → bool mask [n_items] (built lazily, cached)."""

    def __init__(self, items: BiMap, item_categories: Mapping[str, set]):
        self._items = items
        self._cats = item_categories
        self._masks: dict[str, np.ndarray] = {}

    def mask(self, category: str) -> np.ndarray:
        m = self._masks.get(category)
        if m is None:
            m = np.zeros(len(self._items), dtype=bool)
            for item_id, cats in self._cats.items():
                if category in cats:
                    j = self._items.get(item_id)
                    if j is not None:
                        m[j] = True
            self._masks[category] = m
        return m

    def any_of(self, categories: Sequence[str]) -> np.ndarray:
        out = np.zeros(len(self._items), dtype=bool)
        for c in categories:
            out |= self.mask(c)
        return out


def build_exclude_mask(
    items: BiMap,
    category_index: Optional[CategoryIndex] = None,
    categories: Optional[Sequence[str]] = None,
    white_list: Optional[Sequence[str]] = None,
    black_list: Optional[Sequence[str]] = None,
    extra_excluded_items: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """True = suppressed: not in one of ``categories``, not on a non-empty
    ``white_list``, on the ``black_list``, or one of
    ``extra_excluded_items``. Unknown ids are ignored."""
    n = len(items)
    exclude = np.zeros(n, dtype=bool)
    if categories and category_index is not None:
        exclude |= ~category_index.any_of(categories)
    if white_list:
        allowed = {items.get(w) for w in white_list} - {None}
        mask = np.ones(n, dtype=bool)
        if allowed:
            mask[list(allowed)] = False
        exclude |= mask
    for x in list(black_list or []) + list(extra_excluded_items or []):
        j = items.get(x)
        if j is not None:
            exclude[j] = True
    return exclude
