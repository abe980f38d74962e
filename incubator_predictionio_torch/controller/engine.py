"""Engine — binds DASE component classes with their parameters.

Port of ``incubator_predictionio_tpu/controller/engine.py`` (``EngineParams``,
``Engine`` :110, ``Engine.train`` :169, ``Deployment``, ``EngineFactory``
:377), without telemetry, fault points, placement or checkpoints.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Mapping, Sequence, Type

from .base import SanityCheck, doer
from .components import FirstServing, IdentityPreparator

log = logging.getLogger("pio.torch.engine")


def _as_class_map(spec) -> dict[str, Type]:
    """A single class (registered under "") or a {name: class} map."""
    if spec is None:
        return {}
    if isinstance(spec, Mapping):
        return dict(spec)
    return {"": spec}


@dataclasses.dataclass
class EngineParams:
    """Per-component parameter selection; ``algorithm_params_list`` is a
    list of (name, params_dict) pairs."""

    data_source_params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    preparator_params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    algorithm_params_list: Sequence[tuple[str, Mapping[str, Any]]] = \
        dataclasses.field(default_factory=list)
    serving_params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    data_source_name: str = ""
    preparator_name: str = ""
    serving_name: str = ""

    @staticmethod
    def from_json(obj: Mapping[str, Any]) -> "EngineParams":
        """Parse the engine.json dict: {"datasource": {"params": {...}},
        "algorithms": [{"name": ..., "params": {...}}], ...}."""

        def unwrap(block):
            if block is None:
                return "", {}
            if "params" in block or "name" in block:
                return block.get("name", ""), block.get("params", {}) or {}
            return "", block

        ds_name, ds_params = unwrap(obj.get("datasource"))
        p_name, p_params = unwrap(obj.get("preparator"))
        s_name, s_params = unwrap(obj.get("serving"))
        algos = [(a.get("name", ""), a.get("params", {}) or {})
                 for a in obj.get("algorithms", []) or []]
        return EngineParams(
            data_source_params=ds_params, preparator_params=p_params,
            algorithm_params_list=algos, serving_params=s_params,
            data_source_name=ds_name, preparator_name=p_name,
            serving_name=s_name)


class Engine:
    """Composes DASE for train and deploy."""

    def __init__(self, data_source_class, preparator_class=None,
                 algorithm_class_map=None, serving_class=None):
        self.data_source_class_map = _as_class_map(data_source_class)
        self.preparator_class_map = _as_class_map(
            preparator_class or IdentityPreparator)
        self.algorithm_class_map = _as_class_map(algorithm_class_map)
        self.serving_class_map = _as_class_map(serving_class or FirstServing)

    @staticmethod
    def _pick(class_map: dict[str, Type], name: str, what: str) -> Type:
        if name in class_map:
            return class_map[name]
        if not name and len(class_map) == 1:
            return next(iter(class_map.values()))
        raise KeyError(
            f"{what} {name!r} not registered; available: {sorted(class_map)}")

    def make_components(self, engine_params: EngineParams):
        ds = doer(self._pick(self.data_source_class_map,
                             engine_params.data_source_name, "datasource"),
                  engine_params.data_source_params)
        prep = doer(self._pick(self.preparator_class_map,
                               engine_params.preparator_name, "preparator"),
                    engine_params.preparator_params)
        algo_list = [
            (name, doer(self._pick(self.algorithm_class_map, name, "algorithm"),
                        params))
            for name, params in (engine_params.algorithm_params_list
                                 or [("", {})])
        ]
        serving = doer(self._pick(self.serving_class_map,
                                  engine_params.serving_name, "serving"),
                       engine_params.serving_params)
        return ds, prep, algo_list, serving

    @staticmethod
    def _sanity_check(obj, label: str) -> None:
        if isinstance(obj, SanityCheck):
            log.info("sanity check: %s", label)
            obj.sanity_check()

    def train(self, ctx, engine_params: EngineParams) -> list[Any]:
        """read → prepare → train every algorithm; returns the models."""
        ds, prep, algo_list, _ = self.make_components(engine_params)
        td = ds.read_training(ctx)
        self._sanity_check(td, "datasource")
        pd = prep.prepare(ctx, td)
        self._sanity_check(pd, "preparator")
        models = []
        for name, algo in algo_list:
            log.info("training algorithm %s (%s)", name or "<default>",
                     type(algo).__name__)
            model = algo.train(ctx, pd)
            self._sanity_check(model, f"algorithm[{name or 'default'}]")
            models.append(model)
        return models

    def prepare_deployment(self, ctx, engine_params: EngineParams,
                           models: list[Any]) -> "Deployment":
        """Re-bind stored models to live algorithm instances for serving."""
        _, _, algo_list, serving = self.make_components(engine_params)
        if len(models) != len(algo_list):
            raise ValueError(
                f"{len(models)} stored models but {len(algo_list)} algorithms")
        restored = [algo.restore_model(m, ctx)
                    for (_, algo), m in zip(algo_list, models)]
        return Deployment(algo_list, restored, serving)


class Deployment:
    """Live serving bundle: algorithms + restored models + serving."""

    def __init__(self, algo_list, models, serving):
        self.algo_list = algo_list
        self.models = models
        self.serving = serving

    def query(self, q) -> Any:
        q = self.serving.supplement(q)
        predictions = [algo.predict(model, q)
                       for (_, algo), model in zip(self.algo_list, self.models)]
        return self.serving.serve(q, predictions)

    def batch_query(self, queries) -> list[Any]:
        """One batched predict per algorithm for the whole list."""
        qs = [self.serving.supplement(q) for q in queries]
        per_algo = [algo.batch_predict(model, qs)
                    for (_, algo), model in zip(self.algo_list, self.models)]
        return [self.serving.serve(q, [pred[j] for pred in per_algo])
                for j, q in enumerate(qs)]


class EngineFactory:
    """``apply()`` returns an Engine; calling the factory does the same."""

    def apply(self) -> Engine:
        raise NotImplementedError

    def __call__(self) -> Engine:
        return self.apply()
