"""`pio eval` and `pio dashboard`.

The port's own copy of ``incubator_predictionio_tpu/tools/commands/
evaluation.py`` (:18) and of the ``dashboard`` verb
(``tools/commands/management.py:1222``). ``eval`` takes the dotted names
of an Evaluation and, optionally, an EngineParamsGenerator (resolved from
``--engine-dir`` like a user engine's factory), runs every candidate
through ``Engine.eval`` on the card unless ``--device cpu`` is given,
ranks them with the MetricEvaluator and persists an EvaluationInstance.
It prints the leaderboard, the instance id and one JSON line: the
instance id, seconds, device, the candidates' scores and best index, the
solve-kernel launches and the ``ranking_metrics`` calls with their
seconds. An Evaluation whose constructor takes ``device`` gets
``--device`` (its metrics run there too).
"""

from __future__ import annotations

import argparse
import inspect
import json
import signal
import time

from ...data.storage.registry import Storage
from . import verb


def _instance(cls, **kw):
    """``cls`` built with the keywords its constructor accepts (an
    instance, or None, passes through)."""
    if not isinstance(cls, type):
        return cls
    accepted = inspect.signature(cls).parameters
    return cls(**{k: v for k, v in kw.items() if k in accepted})


@verb("eval", "run an evaluation: pio eval <Evaluation> [<EngineParamsGenerator>]")
def eval_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio eval")
    p.add_argument("evaluation", help="dotted path of the Evaluation class")
    p.add_argument("generator", nargs="?", default=None,
                   help="dotted path of the EngineParamsGenerator (optional "
                        "when the Evaluation defines its params)")
    p.add_argument("--engine-dir", default=".",
                   help="engine directory: a user engine's modules (it goes "
                        "first on sys.path)")
    p.add_argument("--batch", default="")
    p.add_argument("--app-name", default="",
                   help="app whose events the evaluation reads (when the "
                        "classes name none)")
    p.add_argument("--parallel-candidates", type=int, default=1,
                   help="evaluate up to N candidates at once, each on a "
                        "card of its own (at most the cards present)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to train, predict and score: the card "
                        "(default) or, only when asked, the CPU")
    ns = p.parse_args(args)
    from ...ops import eval as evalops
    from ...workflow.context import WorkflowContext
    from ...workflow.evaluation_workflow import run_evaluation
    from ...workflow.json_extractor import resolve_engine_factory
    from .engine import _launches

    # the device is checked before the store is opened
    ctx = WorkflowContext(app_name=ns.app_name, device=ns.device)
    ctx.storage = Storage.instance()
    evaluation = _instance(
        resolve_engine_factory(ns.evaluation, ns.engine_dir),
        device=ns.device)
    generator = (_instance(resolve_engine_factory(ns.generator, ns.engine_dir))
                 if ns.generator else None)
    t0 = time.perf_counter()
    result, instance_id = run_evaluation(
        evaluation, generator, ctx, batch=ns.batch,
        evaluation_name=ns.evaluation, generator_name=ns.generator or "",
        parallelism=ns.parallel_candidates)
    seconds = time.perf_counter() - t0
    print(result.pretty())
    print(f"[info] Evaluation completed. Instance ID: {instance_id}")
    stats = evalops.ranking_metrics_calls
    print(json.dumps({
        "evaluationInstanceId": instance_id, "seconds": seconds,
        "device": ns.device, "metricHeader": result.metric_header,
        "otherMetricHeaders": list(result.other_metric_headers),
        "candidates": len(result.all_results),
        "scores": [s for _, s, _ in result.all_results],
        "others": [list(o) for _, _, o in result.all_results],
        "bestIndex": result.best_index, "bestScore": result.best_score,
        "kernel_launches": _launches(),
        "ranking_metrics": {"calls": stats.calls, "seconds": stats.seconds},
    }), flush=True)
    return 0


def _raise_exit(signum, frame):
    raise SystemExit(0)


@verb("dashboard", "serve the evaluation leaderboard (:9000)")
def dashboard_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio dashboard")
    p.add_argument("--ip", "--host", dest="ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9000)
    ns = p.parse_args(args)
    from ..dashboard import Dashboard

    server = Dashboard(Storage.instance(), ns.ip, ns.port)
    signal.signal(signal.SIGTERM, _raise_exit)
    host, port = server.address
    print(f"[info] Dashboard is running at http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0
