"""BiMap — bidirectional entity-id ↔ dense-index mapping.

The port's own copy of ``incubator_predictionio_tpu/data/storage/bimap.py``
(``BiMap``, ``IdentityBiMap``, the persisted forms and ``extend_bimap``), so
that persisted models cross-load between the two packages.
"""

from __future__ import annotations

from typing import Hashable, Iterable, Mapping, Optional, Sequence

import numpy as np


class BiMap:
    """Immutable bidirectional map key → value (both unique)."""

    def __init__(self, forward: Mapping[Hashable, int]):
        self._fwd = dict(forward)
        self._inv = {v: k for k, v in self._fwd.items()}
        if len(self._inv) != len(self._fwd):
            raise ValueError("BiMap values must be unique")

    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap":
        """Consecutive int indices for (deduped) keys in first-seen order."""
        fwd: dict[str, int] = {}
        for k in keys:
            if k not in fwd:
                fwd[k] = len(fwd)
        return BiMap(fwd)

    def __call__(self, key: Hashable) -> int:
        return self._fwd[key]

    def get(self, key: Hashable, default: Optional[int] = None) -> Optional[int]:
        return self._fwd.get(key, default)

    def inverse(self, value: int) -> Hashable:
        return self._inv[value]

    def inverse_get(self, value: int, default=None):
        return self._inv.get(value, default)

    def contains(self, key: Hashable) -> bool:
        return key in self._fwd

    __contains__ = contains

    def __len__(self) -> int:
        return len(self._fwd)

    def keys(self):
        return self._fwd.keys()

    def to_dict(self) -> dict:
        return dict(self._fwd)

    def to_persisted(self):
        """Model-blob form (IdentityBiMap persists a compact marker)."""
        return self.to_dict()

    @staticmethod
    def from_persisted(obj) -> "BiMap":
        """Inverse of to_persisted: detects the identity marker."""
        if isinstance(obj, Mapping) and "__identity_n__" in obj and len(obj) == 1:
            return IdentityBiMap(obj["__identity_n__"])
        if isinstance(obj, BiMap):
            return obj
        return BiMap(obj)

    def map_array(self, keys: Sequence[Hashable]) -> np.ndarray:
        """Vectorized lookup → int32 numpy array."""
        return np.fromiter((self._fwd[k] for k in keys), dtype=np.int32,
                           count=len(keys))

    def inverse_array(self, values: Sequence[int]) -> list:
        return [self._inv[int(v)] for v in values]


class IdentityBiMap(BiMap):
    """``str(i) ↔ i`` over [0, n) without materializing n entries."""

    def __init__(self, n: int):
        self._n = int(n)

    def __call__(self, key: Hashable) -> int:
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def get(self, key: Hashable, default: Optional[int] = None) -> Optional[int]:
        # strict str keys, canonical spellings only: a dict BiMap keyed by
        # str(i) answers the same way
        if not isinstance(key, str):
            return default
        try:
            v = int(key, 10)
        except ValueError:
            return default
        if 0 <= v < self._n and key == str(v):
            return v
        return default

    def inverse(self, value: int) -> str:
        v = int(value)
        if not 0 <= v < self._n:
            raise KeyError(value)
        return str(v)

    def inverse_get(self, value: int, default=None):
        try:
            return self.inverse(value)
        except (KeyError, TypeError, ValueError):
            return default

    def contains(self, key: Hashable) -> bool:
        return self.get(key) is not None

    __contains__ = contains

    def __len__(self) -> int:
        return self._n

    def keys(self):
        return _IdentityKeys(self._n)

    def to_dict(self) -> dict:
        return {str(j): j for j in range(self._n)}

    def to_persisted(self):
        return {"__identity_n__": self._n}

    def map_array(self, keys: Sequence[Hashable]) -> np.ndarray:
        return np.fromiter((self(k) for k in keys), dtype=np.int32,
                           count=len(keys))

    def inverse_array(self, values: Sequence[int]) -> list:
        return [self.inverse(v) for v in values]


def extend_bimap(bm: BiMap, keys: Iterable[str]):
    """A NEW BiMap with ``keys`` appended after the existing indices
    (first-seen order); ``bm`` is never mutated. Returns
    ``(bimap, appended)``. An IdentityBiMap extends only by the next
    consecutive ``str(n)..`` ids; other keys are refused (``[]``)."""
    new = []
    seen = set()
    for k in keys:
        if k not in seen and k not in bm:
            seen.add(k)
            new.append(k)
    if not new:
        return bm, []
    if isinstance(bm, IdentityBiMap):
        n = len(bm)
        if set(new) == {str(n + j) for j in range(len(new))}:
            return IdentityBiMap(n + len(new)), new
        return bm, []
    fwd = bm.to_dict()
    for k in new:
        fwd[k] = len(fwd)
    return BiMap(fwd), new


class _IdentityKeys:
    """Re-iterable view over str(0..n), like dict_keys."""

    def __init__(self, n: int):
        self._n = n

    def __iter__(self):
        return (str(j) for j in range(self._n))

    def __len__(self) -> int:
        return self._n

    def __contains__(self, key) -> bool:
        return IdentityBiMap(self._n).get(key) is not None
