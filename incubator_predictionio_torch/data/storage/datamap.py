"""DataMap / PropertyMap — schemaless JSON properties attached to events.

The port's own copy of ``incubator_predictionio_tpu/data/storage/datamap.py``.

Re-design of the reference's ``DataMap`` / ``PropertyMap``
(reference: data/.../data/storage/DataMap.scala — json4s JValue wrapper with
typed extractors). Here a thin dict wrapper: Python is dynamically typed, so
the typed-extractor surface collapses to ``get``/``get_opt`` with an optional
expected type check.
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Iterator, Mapping, Optional, Type


class DataMapError(Exception):
    """Raised when a required field is missing or has the wrong type."""


class DataMap(Mapping[str, Any]):
    """Immutable mapping of property name -> JSON value.

    Mirrors the reference behaviour: ``get`` on a missing key raises
    (DataMapException upstream), ``get_opt`` returns None.
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        self._fields: dict[str, Any] = dict(fields or {})

    # -- Mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    # -- reference API ----------------------------------------------------
    def require(self, name: str, expected: Optional[Type] = None) -> Any:
        """``DataMap.get[T](name)`` upstream: missing key is an error."""
        if name not in self._fields:
            raise DataMapError(f"The field {name} is required.")
        value = self._fields[name]
        if expected is not None and not isinstance(value, expected):
            # int is acceptable where float is expected (JSON numbers)
            if expected is float and isinstance(value, int):
                return float(value)
            raise DataMapError(
                f"The field {name} has type {type(value).__name__}; "
                f"expected {expected.__name__}."
            )
        return value

    def get_opt(self, name: str, expected: Optional[Type] = None) -> Any:
        """``DataMap.getOpt[T]`` upstream: None when absent."""
        if name not in self._fields:
            return None
        return self.require(name, expected)

    def get_or_else(self, name: str, default: Any) -> Any:
        value = self.get_opt(name)
        return default if value is None else value

    def union(self, other: "DataMap") -> "DataMap":
        """``++`` upstream — right side wins on conflicts."""
        merged = dict(self._fields)
        merged.update(other._fields)
        return DataMap(merged)

    def minus(self, keys) -> "DataMap":
        """``--`` upstream — remove keys."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    def is_empty(self) -> bool:
        return not self._fields

    def keyset(self) -> set[str]:
        return set(self._fields)

    def to_dict(self) -> dict[str, Any]:
        return dict(self._fields)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        # Content hash so frozen Event dataclasses are hashable/dedupable.
        import json as _json

        return hash(_json.dumps(self._fields, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"


class PropertyMap(DataMap):
    """DataMap plus first/last update times — the result of replaying
    $set/$unset/$delete events (reference: data/.../storage/PropertyMap.scala).
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Optional[Mapping[str, Any]],
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self._fields!r}, first_updated={self.first_updated},"
            f" last_updated={self.last_updated})"
        )
