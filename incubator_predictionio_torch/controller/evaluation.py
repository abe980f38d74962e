"""Evaluation and EngineParamsGenerator.

The port's own copy of ``incubator_predictionio_tpu/controller/
evaluation.py`` (reference: core/.../controller/{Evaluation,
EngineParamsGenerator}.scala).
"""

from __future__ import annotations

from typing import Sequence

from .engine import Engine, EngineParams
from .metric import Metric


class Evaluation:
    """Binds an engine with its metrics: subclasses set ``engine`` and
    ``metric`` (and ``metrics``, reported beside it), usually in
    ``__init__``."""

    engine: Engine
    metric: Metric
    metrics: Sequence[Metric] = ()

    def engine_metrics(self) -> tuple[Engine, Metric, Sequence[Metric]]:
        if not hasattr(self, "engine") or not hasattr(self, "metric"):
            raise AttributeError(
                f"{type(self).__name__} must define .engine and .metric")
        return self.engine, self.metric, tuple(self.metrics)


class EngineParamsGenerator:
    """Supplies the candidate EngineParams of a tuning run."""

    engine_params_list: Sequence[EngineParams] = ()

    def params_list(self) -> Sequence[EngineParams]:
        if not self.engine_params_list:
            raise AttributeError(
                f"{type(self).__name__} must define .engine_params_list")
        return self.engine_params_list
