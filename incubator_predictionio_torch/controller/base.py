"""Params, Doer instantiation, and the cross-cutting controller contracts.

Port of ``incubator_predictionio_tpu/controller/base.py``: a DASE component
is built with keyword arguments extracted from engine.json (the Python
analog of the reference's JsonExtractor + Doer).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Mapping, Optional, Type, TypeVar


class Params:
    """Marker base for component parameters (usually dataclasses)."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    """Parameters of components that need no configuration."""


def params_from_dict(params_cls: Optional[Type], d: Mapping[str, Any]) -> Any:
    """Build a Params instance from a JSON dict. Unknown keys raise, as in
    the reference (a typo in engine.json fails the train)."""
    if params_cls is None:
        return EmptyParams() if not d else dict(d)
    if dataclasses.is_dataclass(params_cls):
        names = {f.name for f in dataclasses.fields(params_cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(
                f"unknown parameter(s) {sorted(unknown)} for {params_cls.__name__};"
                f" expected a subset of {sorted(names)}")
        return params_cls(**d)
    sig = inspect.signature(params_cls)
    return params_cls(**{k: v for k, v in d.items() if k in sig.parameters})


def params_to_dict(p: Any) -> dict[str, Any]:
    """A Params instance (dataclass, mapping or plain object) → a dict."""
    if p is None:
        return {}
    if dataclasses.is_dataclass(p):
        return dataclasses.asdict(p)
    if isinstance(p, Mapping):
        return dict(p)
    return {k: v for k, v in vars(p).items() if not k.startswith("_")}


class AbstractDoer:
    """Base of all DASE components: holds the Params it was built with."""

    params_cls: Optional[Type] = None

    def __init__(self, params: Any = None):
        self.params = params if params is not None else EmptyParams()


T = TypeVar("T", bound=AbstractDoer)


def doer(cls: Type[T], params_json: Optional[Mapping[str, Any]] = None) -> T:
    """Instantiate a DASE component from its JSON params.
    ``cls.params_aliases`` maps engine.json spellings onto Params field
    names, so reference engine.json files work verbatim."""
    params_cls = getattr(cls, "params_cls", None)
    params_json = params_json or {}
    aliases = getattr(cls, "params_aliases", None)
    if aliases:
        params_json = {aliases.get(k, k): v for k, v in params_json.items()}
    if params_cls is not None:
        return cls(params_from_dict(params_cls, params_json))
    return cls(dict(params_json)) if params_json else cls()


class SanityCheck:
    """Post-stage data asserts, run after each DASE stage."""

    def sanity_check(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class CustomQuerySerializer:
    """Hook to override the query/result JSON codecs: components may
    provide ``query_from_json`` / ``result_to_json``."""

    def query_from_json(self, obj: Mapping[str, Any]) -> Any:
        return obj

    def result_to_json(self, result: Any) -> Any:
        return result
