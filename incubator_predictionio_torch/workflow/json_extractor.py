"""engine.json parsing + engine-factory resolution.

The port's own copy of ``incubator_predictionio_tpu/workflow/
json_extractor.py`` (reference: core/.../workflow/JsonExtractor.scala and
the reflective EngineFactory loading in CreateWorkflow). ``engineFactory``
is a dotted path ``package.module.ClassOrFunction`` resolved via importlib;
it may name an EngineFactory subclass, a function returning an Engine, or
an Engine instance (the Recommendation engine when absent). It names a
factory of this package or a user engine's module, found in the engine
directory (``--engine-dir``), which goes on ``sys.path`` first as the
reference's engine-jar classpath does. Whatever it names must build an
Engine of this package; a factory of the JAX package is refused, never
loaded.

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
import sys
from typing import Optional, Tuple

from ..controller.engine import Engine, EngineFactory, EngineParams

PACKAGE = "incubator_predictionio_torch."
DEFAULT_FACTORY = PACKAGE + "models.recommendation.RecommendationEngine"
#: dotted paths under this prefix name the JAX package, which the port never
#: imports
REFERENCE_PACKAGE = "incubator_predictionio_tpu."


def load_engine_json(path: str, variant: Optional[str] = None) -> dict:
    """Read engine.json; ``variant`` selects engine.json.<variant> the way
    --engine-variant does upstream."""
    if variant:
        base, name = os.path.split(path)
        path = os.path.join(base, f"{name}.{variant}") if not name.endswith(variant) else path
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def resolve_engine_factory(dotted: str, engine_dir: Optional[str] = None):
    """Dotted path → the object it names (a factory, an Evaluation or a
    generator class). ``engine_dir`` goes first on ``sys.path``, so a user
    engine's modules resolve from it. A path into the JAX package
    raises."""
    if dotted.startswith(REFERENCE_PACKAGE):
        raise ValueError(
            f"{dotted!r} is not a factory of this package: it names the JAX "
            f"package, which this package never loads (expected {PACKAGE}... "
            "or a module of the engine directory)")
    if engine_dir:
        engine_dir = os.path.abspath(engine_dir)
        if engine_dir not in sys.path:
            sys.path.insert(0, engine_dir)
    module_name, _, attr = dotted.rpartition(".")
    if not module_name:
        raise ValueError(f"engineFactory {dotted!r} must be module.ClassName")
    return getattr(importlib.import_module(module_name), attr)


def engine_from_factory(factory_obj) -> Engine:
    """The Engine a factory builds; it must be an Engine of this
    package."""
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
        f"engineFactory resolved to {factory_obj!r}, which did not produce "
        f"an Engine of {PACKAGE.rstrip('.')}")


def engine_and_params_from_json(
        engine_json: dict, engine_dir: Optional[str] = None
) -> Tuple[Engine, EngineParams, str]:
    """(Engine, EngineParams, factory name) of an engine.json dict; a user
    engine's modules resolve from ``engine_dir``."""
    factory_path = engine_json.get("engineFactory") or DEFAULT_FACTORY
    engine = engine_from_factory(
        resolve_engine_factory(factory_path, engine_dir))
    return engine, EngineParams.from_json(engine_json), factory_path
