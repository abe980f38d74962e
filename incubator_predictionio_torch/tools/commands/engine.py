"""`pio build/train/deploy/undeploy/batchpredict` (reference:
tools/.../commands/Engine.scala + RunWorkflow/RunServer and
BatchPredict.scala; the workflow runs in-process).

The port's own copy of the single-process paths of
``incubator_predictionio_tpu/tools/commands/engine.py`` (:19-182,
:261-377, :534-600). ``train``, ``deploy`` and ``batchpredict`` run on the
card unless ``--device cpu`` is given. With ``--events``/``--model-out``
(train) or ``--model`` (deploy) they take the file-based forms of
``tools/console.py`` instead of the stores. ``train --window DUR`` trains
on the events of the last DUR only: the bound is resolved once, here, to
an absolute ``PIO_TRAIN_WINDOW_START_US`` (reference :91-121). ``deploy``
runs the engine server of ``workflow/create_server.py`` (admission
control, micro-batching, the result cache, the model lifecycle, drain on
SIGTERM), with ``--online-foldin`` (reference :298-306),
``--quality-eval`` (:307-315) and ``--multitenant`` (:322-330) arming
its fold-in loop, quality watch and tenant mux. The reference's gang
training (``--num-workers``, ``--feed``) and the serving fleet
(``--replicas``) are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ...data.storage.registry import Storage
from ...workflow.json_extractor import engine_and_params_from_json, load_engine_json
from ...workflow.workflow_params import WorkflowParams
from . import verb


def _engine_json(ns) -> dict:
    path = ns.engine_json or os.path.join(ns.engine_dir, "engine.json")
    return load_engine_json(path, ns.variant)


def _load_engine(ns):
    engine_json = _engine_json(ns)
    engine, params, factory = engine_and_params_from_json(engine_json,
                                                          ns.engine_dir)
    variant = engine_json.get("id", "default")
    return engine, params, factory, variant, engine_json


def _app_name(params) -> str:
    dsp = dict(params.data_source_params)
    return dsp.get("app_name") or dsp.get("appName", "")


def _common_args(p: argparse.ArgumentParser):
    p.add_argument("--engine-dir", default=".",
                   help="engine directory: holds engine.json and a user "
                        "engine's modules (it goes first on sys.path)")
    p.add_argument("--engine-json", default=None,
                   help="the engine.json file (default <engine-dir>/engine.json)")
    p.add_argument("--variant", default=None, help="engine.json variant suffix")


def _device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to train or serve: the card (default) or, "
                        "only when asked, the CPU")


def _launches() -> dict:
    """The solve-kernel launches of this process, per kernel (0 on the
    CPU, where the plain version runs)."""
    from ...ops import spd_solve

    return {"warp": spd_solve.gauss_jordan_warp_launches.count,
            "wide": spd_solve.gauss_jordan_wide_launches.count}


@verb("build", "validate the engine template (no compilation needed)")
def build_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio build")
    _common_args(p)
    ns = p.parse_args(args)
    try:
        engine, params, factory, variant, _ = _load_engine(ns)
    except Exception as e:  # noqa: BLE001
        print(f"[error] engine build failed: {e}", file=sys.stderr)
        return 1
    n_algos = len(params.algorithm_params_list) or 1
    print(f"[info] Engine {factory} (variant {variant}) is ready: "
          f"{n_algos} algorithm(s) configured. No compilation needed "
          "(the CUDA kernels build at their first launch).")
    return 0


@verb("train", "run the training workflow")
def train_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio train")
    _common_args(p)
    _device_arg(p)
    p.add_argument("--batch", default="")
    p.add_argument("--skip-sanity-check", action="store_true")
    p.add_argument("--stop-after-read", action="store_true")
    p.add_argument("--stop-after-prepare", action="store_true")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="snapshot algorithm state every N iterations")
    p.add_argument("--resume", action="store_true",
                   help="continue the most recent interrupted run from its "
                        "last snapshot")
    p.add_argument("--nan-guard", action="store_true",
                   help="fail with stage/iteration attribution when a stage "
                        "produces NaN/Inf (iterative trainers run one "
                        "iteration at a time)")
    p.add_argument("--events", default=None,
                   help="file form: a JSON-lines events file instead of the "
                        "event store (needs --model-out)")
    p.add_argument("--model-out", default=None,
                   help="file form: write the model file here instead of "
                        "the model store; snapshots go to "
                        "<model-out>.checkpoints/")
    p.add_argument("--window", default=None, metavar="DUR",
                   help="train on events from the last DUR only "
                        "(90d/12h/30m/45s): windowed reads skip whole "
                        "sealed log generations by their manifest "
                        "event-time bounds without decoding them "
                        "(default $PIO_TRAIN_WINDOW)")
    ns = p.parse_args(args)
    if (ns.events is None) != (ns.model_out is None):
        p.error("--events and --model-out go together (the file form)")
    if ns.window and ns.events is not None:
        p.error("--window cuts the event store's read, not an --events file")
    from ...common import train_window

    if ns.window:
        dur = train_window.parse_duration_us(ns.window)
        if dur is None:
            print(f"[error] --window {ns.window!r}: expected a duration "
                  "like 90d, 12h, 30m, or 45s", file=sys.stderr)
            return 1
        os.environ["PIO_TRAIN_WINDOW"] = ns.window
        # resolved to an absolute bound once, so every read of this train
        # cuts the log at the same microsecond
        os.environ.setdefault("PIO_TRAIN_WINDOW_START_US",
                              str(train_window.now_us() - dur))
    wp = WorkflowParams(
        batch=ns.batch,
        skip_sanity_check=ns.skip_sanity_check,
        stop_after_read=ns.stop_after_read,
        stop_after_prepare=ns.stop_after_prepare,
        checkpoint_every=ns.checkpoint_every,
        resume=ns.resume,
        nan_guard=ns.nan_guard,
    )
    if ns.events is not None:
        return _train_file(ns, wp)

    from ...workflow.context import WorkflowContext
    from ...workflow.core_workflow import run_train

    engine, params, factory, variant, _ = _load_engine(ns)
    ctx = WorkflowContext(app_name=_app_name(params), storage=Storage.instance(),
                          device=ns.device)
    # the read's and the trainer's phase times, printed below
    ctx.read_timings, ctx.bench_timings = {}, {}
    t0 = time.perf_counter()
    instance_id = run_train(engine, params, ctx, wp,
                            engine_factory_name=factory, engine_variant=variant)
    seconds = time.perf_counter() - t0
    print(f"[info] Training completed in {seconds:.2f}s. "
          f"Engine instance ID: {instance_id}")
    start_us, until_us = train_window.resolve_us()
    print(json.dumps({"engineInstanceId": instance_id, "seconds": seconds,
                      "device": ns.device, "kernel_launches": _launches(),
                      "window": {"startUs": start_us, "untilUs": until_us},
                      "timings": {**ctx.read_timings, **ctx.bench_timings}}),
          flush=True)
    return 0


def _train_file(ns, wp: WorkflowParams) -> int:
    """The file form: events file in, model file out."""
    from ...data.events import read_events
    from .. import console

    engine_json = _engine_json(ns)
    events = read_events(ns.events)
    seconds = console.train(engine_json, events, ns.model_out, ns.device, wp,
                            engine_dir=ns.engine_dir)
    print(json.dumps({"trained": None if seconds is None else ns.model_out,
                      "events": len(events), "seconds": seconds,
                      "device": ns.device, "kernel_launches": _launches()}),
          flush=True)
    return 0


@verb("deploy", "serve the trained engine over HTTP")
def deploy_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio deploy")
    _common_args(p)
    _device_arg(p)
    p.add_argument("--ip", "--host", dest="ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--engine-instance-id", default=None,
                   help="serve this instance (no walk-back) instead of the "
                        "newest deployable COMPLETED one")
    p.add_argument("--model", default=None,
                   help="file form: serve this model file instead of an "
                        "engine instance of the model store (no reload, "
                        "rollback or refresh)")
    p.add_argument("--feedback", action="store_true",
                   help="self-log every answered query as a predict event "
                        "of the engine's app")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="coalesce queries arriving within this window into "
                        "one vectorized dispatch (0 = off)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="most queries per micro-batch (capped at 256)")
    p.add_argument("--probe-latency", action="store_true",
                   help="at startup, measure the full-path query p50/p99 "
                        "split (HTTP / predict / device round trip / "
                        "parse) and persist it to the instance row")
    p.add_argument("--query-conc", type=int, default=None,
                   help="bounded query executor width (default "
                        "$PIO_QUERY_CONC, else cpu+4 capped at 32)")
    p.add_argument("--query-max-pending", type=int, default=None,
                   help="admission queue depth beyond --query-conc; excess "
                        "load sheds 503 + jittered Retry-After (default "
                        "$PIO_QUERY_MAX_PENDING, else 128)")
    p.add_argument("--query-deadline-ms", type=float, default=None,
                   help="per-query deadline budget; exceeded → 504 "
                        "(X-Pio-Deadline-Ms overrides per request; 0 "
                        "disables; default $PIO_QUERY_DEADLINE_MS, else "
                        "30000)")
    p.add_argument("--drain-deadline-ms", type=float, default=None,
                   help="graceful-drain budget on SIGTERM or /stop "
                        "(default $PIO_DRAIN_DEADLINE_MS, else 10000)")
    p.add_argument("--model-refresh-ms", type=float, default=None,
                   help="poll for newer COMPLETED instances and hot-swap "
                        "them through the validated gate every N ms "
                        "(default $PIO_MODEL_REFRESH_MS, else 0 = off)")
    p.add_argument("--query-cache-size", type=int, default=None,
                   help="served-result cache entries (default "
                        "$PIO_QUERY_CACHE_SIZE, else 0 = off)")
    p.add_argument("--online-foldin", action="store_true",
                   help="streaming online learning: tail the app's event "
                        "log and fold new events into the served model, "
                        "publishing each increment through the same "
                        "validation gate and watch window as a retrain "
                        "(interval $PIO_FOLDIN_MS, default 1000)")
    p.add_argument("--quality-eval", action="store_true",
                   help="continuous quality evaluation: shadow-score a "
                        "sampled slice of live queries against the users' "
                        "next events in the app's log and roll a ranking "
                        "regression back like an error-rate breach "
                        "(sample rate $PIO_QUALITY_SAMPLE, default 0.01 "
                        "with this flag; thresholds via PIO_QUALITY_*)")
    p.add_argument("--multitenant", action="store_true",
                   help="serve every registered app from this process: "
                        "queries route by app name (X-Pio-App header, app "
                        "parameter) or access key (accessKey parameter, "
                        "X-Pio-Access-Key header) to an LRU of "
                        "$PIO_TENANT_MAX_RESIDENT (default 8) resident "
                        "deployments, each with its own gate, watch, "
                        "rollback, fold-in cursor and admission budget "
                        "($PIO_TENANT_MAX_PENDING)")
    p.add_argument("--rollback", action="store_true",
                   help="don't deploy: tell the engine server already "
                        "running at --ip/--port to roll back to its "
                        "previous deployment, then exit")
    ns = p.parse_args(args)
    if ns.model is not None and (ns.online_foldin or ns.quality_eval
                                 or ns.multitenant):
        p.error("--online-foldin, --quality-eval and --multitenant need the "
                "model store and the event log: not with --model")
    if ns.rollback:
        from .models import rollback_via_url

        host = "127.0.0.1" if ns.ip in ("0.0.0.0", "::") else ns.ip
        return rollback_via_url(f"http://{host}:{ns.port}")
    from ...workflow.create_server import run_engine_server

    server = _build_engine_server(ns)
    print(f"[info] Engine is deployed and running. Listening on "
          f"{ns.ip}:{ns.port}", flush=True)
    run_engine_server(server, ns.ip, ns.port, probe_latency=ns.probe_latency)
    return 0


def _build_engine_server(ns):
    """The EngineServer of a deploy: the newest deployable instance of
    the model store (or ``--engine-instance-id``), or the ``--model``
    file."""
    from ...common import envknobs
    from ...workflow.create_server import EngineServer

    # each flag arms its loop at its knob's value (or the flag's default);
    # without the flag the knob alone can still arm it
    online = dict(
        foldin_ms=(float(envknobs.env_int("PIO_FOLDIN_MS", 1000, lo=1))
                   if ns.online_foldin else None),
        quality_sample=(envknobs.env_float("PIO_QUALITY_SAMPLE", 0.01,
                                           lo=0.0, hi=1.0)
                        if ns.quality_eval else None),
        tenant_max_resident=(
            envknobs.env_int("PIO_TENANT_MAX_RESIDENT", 8, lo=1)
            if ns.multitenant else None))
    knobs = dict(
        batch_window_ms=ns.batch_window_ms, max_batch=ns.max_batch,
        query_conc=ns.query_conc, query_max_pending=ns.query_max_pending,
        query_deadline_ms=ns.query_deadline_ms,
        drain_deadline_ms=ns.drain_deadline_ms,
        model_refresh_ms=ns.model_refresh_ms,
        query_cache_size=ns.query_cache_size, device=ns.device)
    if ns.model is not None:
        from .. import console

        deployment, _ = console.load_deployment(ns.model, ns.device,
                                                ns.engine_dir)
        return EngineServer(deployment=deployment, **knobs)
    engine, params, factory, variant, _ = _load_engine(ns)
    return EngineServer(
        engine,
        engine_factory_name=factory,
        engine_variant=variant,
        instance_id=ns.engine_instance_id,
        feedback=ns.feedback,
        feedback_app_name=_app_name(params),
        **online,
        **knobs)


@verb("undeploy", "stop a running engine server")
def undeploy_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio undeploy")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    ns = p.parse_args(args)
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://{ns.ip}:{ns.port}/stop",
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            msg = json.load(resp).get("message", resp.status)
    except urllib.error.HTTPError as e:
        try:
            msg = json.load(e).get("message", e.code)
        except ValueError:
            msg = e.code
        print(f"[error] {msg}", file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"[error] {e}", file=sys.stderr)
        return 1
    print(f"[info] {msg}")
    return 0


@verb("batchpredict", "bulk scoring: queries JSONL in, predictions JSONL out")
def batchpredict_cmd(args: list[str]) -> int:
    """Reference: tools/.../commands/BatchPredict.scala (0.13+)."""
    p = argparse.ArgumentParser(prog="pio batchpredict")
    _common_args(p)
    _device_arg(p)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--engine-instance-id", default=None)
    p.add_argument("--query-partitions", type=int, default=None,
                   help="ignored (single process)")
    ns = p.parse_args(args)
    from ...workflow.context import WorkflowContext
    from ...workflow.core_workflow import load_deployment

    engine, params, factory, variant, _ = _load_engine(ns)
    ctx = WorkflowContext(storage=Storage.instance(), device=ns.device)
    deployment, _, _ = load_deployment(
        engine, ns.engine_instance_id, ctx,
        engine_factory_name=factory, engine_variant=variant)
    queries = []
    with open(ns.input) as f:
        for line in f:
            line = line.strip()
            if line:
                queries.append(json.loads(line))
    t0 = time.perf_counter()
    # one vectorized batch_predict when there is exactly one algorithm;
    # otherwise per query through serving
    if len(deployment.algo_list) == 1:
        _, algo = deployment.algo_list[0]
        supplemented = [deployment.serving.supplement(q) for q in queries]
        preds = algo.batch_predict(deployment.models[0], supplemented)
        results = [deployment.serving.serve(q, [pr])
                   for q, pr in zip(supplemented, preds)]
    else:
        results = [deployment.query(q) for q in queries]
    seconds = time.perf_counter() - t0
    with open(ns.output, "w") as f:
        for q, r in zip(queries, results):
            f.write(json.dumps({"query": q, "prediction": r}) + "\n")
    print(f"[info] Batch predict completed: {len(results)} predictions → "
          f"{ns.output} in {seconds:.3f}s", flush=True)
    return 0
