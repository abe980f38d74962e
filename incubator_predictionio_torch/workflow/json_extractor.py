"""engine.json parsing + engine-factory resolution.

The port's own copy of ``incubator_predictionio_tpu/workflow/
json_extractor.py`` (reference: core/.../workflow/JsonExtractor.scala and
the reflective EngineFactory loading in CreateWorkflow). ``engineFactory``
is a dotted path ``package.module.ClassOrFunction`` resolved via importlib;
it may name an EngineFactory subclass, a function returning an Engine, or
an Engine instance. It must name a factory of this package (the
Recommendation engine when absent): an engine.json written for the JAX
package is refused, never loaded through it.

engine.json shape (wire-compatible with the reference):
{
  "id": "default", "description": ...,
  "engineFactory": "incubator_predictionio_torch.models.recommendation.RecommendationEngine",
  "datasource": {"params": {...}},
  "preparator": {"params": {...}},
  "algorithms": [{"name": "als", "params": {...}}],
  "serving": {"params": {...}}
}
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Optional, Tuple

from ..controller.engine import Engine, EngineFactory, EngineParams

PACKAGE = "incubator_predictionio_torch."
DEFAULT_FACTORY = PACKAGE + "models.recommendation.RecommendationEngine"


def load_engine_json(path: str, variant: Optional[str] = None) -> dict:
    """Read engine.json; ``variant`` selects engine.json.<variant> the way
    --engine-variant does upstream."""
    if variant:
        base, name = os.path.split(path)
        path = os.path.join(base, f"{name}.{variant}") if not name.endswith(variant) else path
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def factory_name(engine_json: dict) -> str:
    """engine.json's ``engineFactory``, the Recommendation engine when
    absent; a factory outside this package raises."""
    path = engine_json.get("engineFactory") or DEFAULT_FACTORY
    if not path.startswith(PACKAGE):
        raise ValueError(
            f"engineFactory {path!r} is not a factory of this package "
            f"(expected {PACKAGE}...)")
    return path


def resolve_engine_factory(dotted: str):
    """Dotted path of this package → the factory object it names."""
    module_name, _, attr = dotted.rpartition(".")
    if not module_name:
        raise ValueError(f"engineFactory {dotted!r} must be module.ClassName")
    return getattr(importlib.import_module(module_name), attr)


def engine_from_factory(factory_obj) -> Engine:
    if isinstance(factory_obj, Engine):
        return factory_obj
    if isinstance(factory_obj, type) and issubclass(factory_obj, EngineFactory):
        return factory_obj()()
    if isinstance(factory_obj, EngineFactory):
        return factory_obj()
    if callable(factory_obj):
        engine = factory_obj()
        if isinstance(engine, Engine):
            return engine
    raise TypeError(
        f"engineFactory resolved to {factory_obj!r}, which did not produce an Engine"
    )


def engine_and_params_from_json(
        engine_json: dict) -> Tuple[Engine, EngineParams, str]:
    """(Engine, EngineParams, factory name) of an engine.json dict."""
    factory_path = factory_name(engine_json)
    engine = engine_from_factory(resolve_engine_factory(factory_path))
    return engine, EngineParams.from_json(engine_json), factory_path
