"""Engine — binds DASE component classes with their parameters.

Port of ``incubator_predictionio_tpu/controller/engine.py`` (``EngineParams``,
``Engine`` :110, ``Engine.train`` :169, ``Engine.eval`` :248,
``Deployment``, ``SimpleEngine`` :364, ``EngineFactory`` :377), with the
workflow flags, the NaN guard and per-algorithm checkpoints, the serving
stages' fault points, deadline spend-points, stage histograms
(``pio_query_stage_seconds``) and ``query.*`` trace spans, without
placement (one device: ``ctx.device``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Mapping, Optional, Sequence, Type

from ..common import deadline, faultinject, telemetry
from ..common.nan_guard import check_finite
from ..workflow.checkpoint import CheckpointHook
from ..workflow.workflow_params import WorkflowParams
from .base import SanityCheck, doer
from .components import FirstServing, IdentityPreparator

log = logging.getLogger("pio.torch.engine")

# Per-query serving-stage latency (featurize = Serving.supplement, predict
# = every algorithm's predict, serve = the blend). The batched path
# records the same stages once per coalesced batch under batched="1".
_STAGE_SECONDS = telemetry.registry().histogram(
    "pio_query_stage_seconds",
    "Per-query serving stage latency by stage "
    "(featurize/predict/serve); batched=1 rows are one observation "
    "per micro-batch dispatch",
    ("stage", "batched"))
_ST_FEATURIZE = _STAGE_SECONDS.labels("featurize", "0")
_ST_PREDICT = _STAGE_SECONDS.labels("predict", "0")
_ST_SERVE = _STAGE_SECONDS.labels("serve", "0")
_ST_FEATURIZE_B = _STAGE_SECONDS.labels("featurize", "1")
_ST_PREDICT_B = _STAGE_SECONDS.labels("predict", "1")
_ST_SERVE_B = _STAGE_SECONDS.labels("serve", "1")


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

    def to_json(self) -> dict[str, Any]:
        return {
            "datasource": {"name": self.data_source_name,
                           "params": dict(self.data_source_params)},
            "preparator": {"name": self.preparator_name,
                           "params": dict(self.preparator_params)},
            "algorithms": [{"name": n, "params": dict(p)}
                           for n, p in self.algorithm_params_list],
            "serving": {"name": self.serving_name,
                        "params": dict(self.serving_params)},
        }


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
    def _maybe_sanity_check(obj, label: str, enabled: bool,
                            nan_guard: bool = False) -> None:
        if enabled and isinstance(obj, SanityCheck):
            log.info("sanity check: %s", label)
            obj.sanity_check()
        if nan_guard:
            check_finite(obj, label)

    def train(self, ctx, engine_params: EngineParams,
              workflow_params: Optional[WorkflowParams] = None) -> list[Any]:
        """read → prepare → train every algorithm; returns the models
        (none when ``stop_after_read`` / ``stop_after_prepare`` halt it).

        Sets ``ctx.workflow_params``, which the algorithms read. With a
        ``ctx.checkpoint_hook``, each algorithm snapshots into its own
        subdirectory ``algo_<idx>_<name>``; the root hook is back on the
        context on every exit path."""
        wp = workflow_params or WorkflowParams()
        ctx.workflow_params = wp
        ds, prep, algo_list, _ = self.make_components(engine_params)
        td = ds.read_training(ctx)
        self._maybe_sanity_check(td, "datasource", not wp.skip_sanity_check,
                                 wp.nan_guard)
        if wp.stop_after_read:
            log.info("--stop-after-read: halting before prepare")
            return []
        pd = prep.prepare(ctx, td)
        self._maybe_sanity_check(pd, "preparator", not wp.skip_sanity_check,
                                 wp.nan_guard)
        if wp.stop_after_prepare:
            log.info("--stop-after-prepare: halting before train")
            return []
        models = []
        root_hook = ctx.checkpoint_hook
        for idx, (name, algo) in enumerate(algo_list):
            log.info("training algorithm %s (%s)", name or "<default>",
                     type(algo).__name__)
            label = f"algorithm[{name or 'default'}]"
            ctx.stage_label = label
            if root_hook is not None:
                ctx.checkpoint_hook = CheckpointHook(
                    os.path.join(root_hook.directory,
                                 f"algo_{idx}_{name or 'default'}"),
                    every_n=root_hook.every_n,
                    max_to_keep=root_hook.max_to_keep)
            try:
                model = algo.train(ctx, pd)
            finally:
                if root_hook is not None:
                    ctx.checkpoint_hook.close()
                    ctx.checkpoint_hook = root_hook
            self._maybe_sanity_check(model, label, not wp.skip_sanity_check,
                                     wp.nan_guard)
            models.append(model)
        return models

    def eval(self, ctx, engine_params: EngineParams,
             workflow_params: Optional[WorkflowParams] = None) -> list:
        """Per fold of ``read_eval``: prepare, train every algorithm, then
        ``supplement`` → ``batch_predict`` → ``serve`` over the fold's
        queries. Returns [(eval_info, [(query, predicted, actual), ...])],
        one entry per fold."""
        if workflow_params is not None:
            ctx.workflow_params = workflow_params
        ds, prep, algo_list, serving = self.make_components(engine_params)
        results = []
        for fold_i, (td, eval_info, qa) in enumerate(ds.read_eval(ctx)):
            pd = prep.prepare(ctx, td)
            models = []
            for name, algo in algo_list:
                ctx.stage_label = f"algorithm[{name or 'default'}]"
                models.append(algo.train(ctx, pd))
            qa = list(qa)
            queries = [serving.supplement(q) for q, _ in qa]
            per_algo = [algo.batch_predict(model, queries)
                        for (_, algo), model in zip(algo_list, models)]
            qpa = [(q, serving.serve(q, [pred[j] for pred in per_algo]), a)
                   for j, (q, a) in enumerate(qa)]
            results.append((eval_info, qpa))
            log.info("eval fold %d: %d query/actual pairs", fold_i, len(qpa))
        return results

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
        """supplement → predict per algorithm → serve. Each stage opens
        with a fault point and, past the first, a deadline spend-point: a
        worker past its request's budget (``common/deadline.py``) frees
        itself at the next stage boundary. Every stage feeds its
        histogram; a sampled request (the trace the handler thread bound,
        carried into the query worker with its context) gets one span per
        stage."""
        dl = deadline.current()
        tr = telemetry.current_trace()
        t0 = (time.perf_counter_ns()
              if tr is not None else telemetry.timer_start())
        faultinject.fault_point("query.featurize")
        q = self.serving.supplement(q)
        t1 = time.perf_counter_ns() if t0 else 0
        _ST_FEATURIZE.observe_since(t0)
        if dl is not None:
            dl.check("query.predict")
        faultinject.fault_point("query.predict")
        predictions = [algo.predict(model, q)
                       for (_, algo), model in zip(self.algo_list, self.models)]
        t2 = time.perf_counter_ns() if t0 else 0
        _ST_PREDICT.observe_since(t1)
        if dl is not None:
            dl.check("query.serve")
        faultinject.fault_point("query.serve")
        result = self.serving.serve(q, predictions)
        _ST_SERVE.observe_since(t2)
        if tr is not None:
            t3 = time.perf_counter_ns()
            tr.add_span("query.featurize", t1 - t0)
            tr.add_span("query.predict", t2 - t1,
                        algorithms=len(self.algo_list))
            tr.add_span("query.serve", t3 - t2)
        return result

    def batch_query(self, queries) -> list[Any]:
        """One batched predict per algorithm for the whole list (the
        engine server's micro-batches and ``pio batchpredict``). No
        deadline spend-point: a batch mixes requests with different
        budgets, which the server enforces per request."""
        t0 = telemetry.timer_start()
        faultinject.fault_point("query.batch_predict")
        qs = [self.serving.supplement(q) for q in queries]
        t1 = time.perf_counter_ns() if t0 else 0
        _ST_FEATURIZE_B.observe_since(t0)
        per_algo = [algo.batch_predict(model, qs)
                    for (_, algo), model in zip(self.algo_list, self.models)]
        t2 = time.perf_counter_ns() if t0 else 0
        _ST_PREDICT_B.observe_since(t1)
        out = [self.serving.serve(q, [pred[j] for pred in per_algo])
               for j, q in enumerate(qs)]
        _ST_SERVE_B.observe_since(t2)
        return out


class SimpleEngine(Engine):
    """One DataSource and one Algorithm, identity preparator, first
    serving."""

    def __init__(self, data_source_class, algorithm_class):
        super().__init__(data_source_class, IdentityPreparator,
                         {"": algorithm_class}, FirstServing)


class EngineFactory:
    """``apply()`` returns an Engine; calling the factory does the same."""

    def apply(self) -> Engine:
        raise NotImplementedError

    def __call__(self) -> Engine:
        return self.apply()
