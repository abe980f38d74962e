"""The DASE controller API: what an engine's author imports.

The port's counterpart of ``incubator_predictionio_tpu/controller/``:
DataSource → Preparator → Algorithm(s) → Serving, the Engine that binds
them, and the Evaluation side (metrics, the MetricEvaluator and the
candidate generator of ``pio eval``). The reference's P/L class names are
aliases of the one base class of each kind. ``PersistentModel`` models
persist themselves (``controller/persistent_model.py``).
"""

from .base import (
    AbstractDoer, CustomQuerySerializer, EmptyParams, Params, SanityCheck,
    doer, params_from_dict, params_to_dict,
)
from .components import (
    Algorithm, AverageServing, DataSource, FirstServing, IdentityPreparator,
    LAlgorithm, LDataSource, LPreparator, LServing, P2LAlgorithm, PAlgorithm,
    PDataSource, PIdentityPreparator, PPreparator, Preparator, Serving,
)
from .engine import (
    Deployment, Engine, EngineFactory, EngineParams, SimpleEngine,
)
from .evaluation import EngineParamsGenerator, Evaluation
from .metric import (
    AverageMetric, Metric, OptionAverageMetric, SumMetric, ZeroMetric,
)
from .metric_evaluator import MetricEvaluator, MetricEvaluatorResult
from .persistent_model import (
    LocalFileSystemPersistentModel, PersistentModel, PersistentModelLoader,
)

__all__ = [
    "AbstractDoer", "Algorithm", "AverageMetric", "AverageServing",
    "CustomQuerySerializer", "DataSource", "Deployment", "EmptyParams",
    "Engine", "EngineFactory", "EngineParams", "EngineParamsGenerator",
    "Evaluation", "FirstServing", "IdentityPreparator", "LAlgorithm",
    "LDataSource", "LPreparator", "LServing", "LocalFileSystemPersistentModel",
    "Metric", "MetricEvaluator", "MetricEvaluatorResult",
    "OptionAverageMetric", "P2LAlgorithm", "PAlgorithm", "PDataSource",
    "PIdentityPreparator", "PPreparator", "Params", "PersistentModel",
    "PersistentModelLoader", "Preparator", "SanityCheck", "Serving",
    "SimpleEngine",
    "SumMetric", "ZeroMetric", "doer", "params_from_dict", "params_to_dict",
]
