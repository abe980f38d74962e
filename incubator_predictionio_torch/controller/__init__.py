"""A trimmed DASE core: what the Recommendation template needs."""

from .base import (
    AbstractDoer, EmptyParams, Params, SanityCheck, doer, params_from_dict,
)
from .components import (
    Algorithm, DataSource, FirstServing, IdentityPreparator, Preparator,
    Serving,
)
from .engine import Deployment, Engine, EngineFactory, EngineParams

__all__ = [
    "AbstractDoer", "Algorithm", "DataSource", "Deployment", "EmptyParams",
    "Engine", "EngineFactory", "EngineParams", "FirstServing",
    "IdentityPreparator", "Params", "Preparator", "SanityCheck", "Serving",
    "doer", "params_from_dict",
]
