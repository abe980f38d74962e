"""The evaluation workflow: run the candidate EngineParams, rank them by
the metric, persist an EvaluationInstance.

Port of ``incubator_predictionio_tpu/workflow/evaluation_workflow.py``
(``run_evaluation`` :83; reference: core/.../workflow/
EvaluationWorkflow.scala). The instance row is EVALRUNNING while the
candidates run, then EVALCOMPLETED with the leaderboard (text and JSON),
or EVALABORTED when a candidate raises (the error propagates).

``parallelism`` > 1 runs up to min(parallelism, cards, candidates)
candidates at once, each on a card of its own for its whole run (a
thread per card). A one-card host, and a run on the CPU, evaluate the
candidates one after another; a process of a gang refuses it.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import datetime as _dt
import logging
import threading
from typing import Optional

import torch

from ..controller.evaluation import EngineParamsGenerator, Evaluation
from ..controller.metric_evaluator import MetricEvaluator, MetricEvaluatorResult
from ..data.storage.base import EvaluationInstance
from ..data.storage.event import new_event_id
from .context import WorkflowContext

log = logging.getLogger("pio.torch.evalworkflow")


def _utcnow():
    return _dt.datetime.now(_dt.timezone.utc)


def candidate_devices(ctx: WorkflowContext, parallelism: int,
                      n_candidates: int) -> list[torch.device]:
    """The devices the candidates run on: one per worker. Parallel
    candidates are refused in a process of a gang, as in the reference
    (evaluation_workflow.py:49-54)."""
    if parallelism > 1:
        from ..parallel.distributed import process_count

        if process_count() > 1:
            raise ValueError(
                "--parallel-candidates requires a single-controller run: "
                "per-candidate single-device meshes would hand workers "
                "devices owned by other processes (their collectives would "
                "hang). Run the sweep sequentially on multi-host.")
    if ctx.device.type != "cuda" or parallelism <= 1:
        return [ctx.device]
    n = max(1, min(parallelism, torch.cuda.device_count(), n_candidates))
    return [torch.device("cuda", i) for i in range(n)]


def _eval_candidates(engine, params_list, ctx, devices) -> list:
    """[(engine_params, eval_data)] in candidate order; with several
    devices each worker thread keeps one device for all its candidates."""
    if len(devices) == 1:
        out = []
        for i, ep in enumerate(params_list):
            log.info("evaluating candidate %d/%d", i + 1, len(params_list))
            out.append((ep, engine.eval(ctx, ep, ctx.workflow_params)))
        return out
    free = list(devices)
    lock = threading.Lock()
    local = threading.local()

    def run(idx_ep):
        idx, ep = idx_ep
        dev = getattr(local, "device", None)
        if dev is None:
            with lock:
                dev = local.device = free.pop()
        log.info("evaluating candidate %d/%d on %s", idx + 1,
                 len(params_list), dev)
        sub_ctx = dataclasses.replace(ctx, device=dev)
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            return ep, engine.eval(sub_ctx, ep, ctx.workflow_params)

    with cf.ThreadPoolExecutor(max_workers=len(devices)) as ex:
        return list(ex.map(run, enumerate(params_list)))


def run_evaluation(
    evaluation: Evaluation,
    generator: Optional[EngineParamsGenerator],
    ctx: Optional[WorkflowContext] = None,
    batch: str = "",
    evaluation_name: str = "",
    generator_name: str = "",
    parallelism: int = 1,
) -> tuple[MetricEvaluatorResult, str]:
    """Evaluate every candidate of ``generator`` (or the evaluation's own
    ``engine_params_list``) with ``Engine.eval`` on ``ctx.device`` and
    rank them; returns (result, evaluation instance id)."""
    ctx = ctx or WorkflowContext()
    dao = ctx.get_storage().get_meta_data_evaluation_instances()
    engine, metric, other_metrics = evaluation.engine_metrics()
    params_list = (
        generator.params_list()
        if generator is not None
        else getattr(evaluation, "engine_params_list", None) or ()
    )
    if not params_list:
        raise ValueError(
            "no candidate EngineParams: pass an EngineParamsGenerator or set "
            "engine_params_list on the Evaluation")
    instance = EvaluationInstance(
        id=new_event_id(),
        status="EVALRUNNING",
        start_time=_utcnow(),
        end_time=None,
        evaluation_class=evaluation_name or type(evaluation).__name__,
        engine_params_generator_class=generator_name or (
            type(generator).__name__ if generator else ""),
        batch=batch,
    )
    instance_id = dao.insert(instance)
    log.info("EvaluationInstance %s EVALRUNNING (%d candidates)",
             instance_id, len(params_list))
    try:
        devices = candidate_devices(ctx, parallelism, len(params_list))
        candidates = _eval_candidates(engine, params_list, ctx, devices)
        result = MetricEvaluator(metric, other_metrics).evaluate_candidates(
            candidates)
    except Exception:
        dao.update(dataclasses.replace(
            instance, id=instance_id, status="EVALABORTED",
            end_time=_utcnow()))
        raise
    dao.update(dataclasses.replace(
        instance, id=instance_id, status="EVALCOMPLETED", end_time=_utcnow(),
        evaluator_results=result.pretty(), evaluator_results_html="",
        evaluator_results_json=result.to_json()))
    log.info("EvaluationInstance %s EVALCOMPLETED", instance_id)
    return result, instance_id
