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
its fold-in loop, quality watch and tenant mux. ``deploy --replicas
N|auto`` (reference :331-371, :432-530) serves as a fleet: the front of
``workflow/fleet.py`` supervising N ``deploy --replica-worker`` copies of
the same command line (``--device`` included), each serving on the card in
its own process. ``train --num-workers N`` (or ``$PIO_NUM_WORKERS``;
reference :78-126, :184-253) trains as a supervised gang: the supervisor of
``parallel/supervisor.py`` runs N copies of this command line
(``--device`` included) as the ranks of a gloo process group, each on the
card (``cuda:{rank % cards}``: ranks share a card when there are more
ranks than cards), each reading only its own partitions of the JSONL event
log (``--feed partition``, the gang default) or the whole merged view
(``--feed merged``, and any store that is not the JSONL log: the
multi-process slab loop, on the 2-D ALX layout with ``PIO_MESH_SHAPE=DxM``
and ``--num-workers D·M``), restarting the whole gang from the latest
checkpoint when a worker dies or stalls, and draining it on SIGTERM. A
template that does not train ALS, or a mesh shape that is not the gang,
is refused before anything spawns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ...data.storage.registry import Storage
from ...workflow.workflow_params import WorkflowParams
from . import verb

# json_extractor (the controller API, torch) is imported where an engine is
# loaded, never at module import: `undeploy` and every verb of the other
# command modules start without torch


def _engine_json(ns) -> dict:
    from ...workflow.json_extractor import load_engine_json

    path = ns.engine_json or os.path.join(ns.engine_dir, "engine.json")
    return load_engine_json(path, ns.variant)


def _load_engine(ns):
    from ...workflow.json_extractor import engine_and_params_from_json

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
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace (Chrome JSON, CPU and "
                        "CUDA activity) of the train stage here")
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
    p.add_argument("--num-workers", type=int, default=None, metavar="N",
                   help="train as a supervised gang of N worker processes "
                        "over a gloo process group (heartbeat monitoring, "
                        "gang restart from the latest checkpoint, drain on "
                        "SIGTERM; default $PIO_NUM_WORKERS, else 1 = in "
                        "this process)")
    p.add_argument("--feed", choices=("partition", "merged"), default=None,
                   help="the gang's data plane: 'partition' = each worker "
                        "reads only its event-log partitions, id maps "
                        "all-gathered once (the gang default); 'merged' = "
                        "every worker reads the merged view and the gang "
                        "trains on the multi-process slab loop (2-D with "
                        "PIO_MESH_SHAPE=DxM), the linear templates on each "
                        "rank's row block (default $PIO_TRAIN_FEED)")
    ns = p.parse_args(args)
    if (ns.events is None) != (ns.model_out is None):
        p.error("--events and --model-out go together (the file form)")
    if ns.window and ns.events is not None:
        p.error("--window cuts the event store's read, not an --events file")
    from ...common import envknobs, train_window

    num_workers = (ns.num_workers if ns.num_workers is not None
                   else envknobs.env_int("PIO_NUM_WORKERS", 1, lo=1))
    supervised_worker = envknobs.env_flag("PIO_GANG_WORKER", False)
    if num_workers > 1 and ns.events is not None:
        p.error("--num-workers trains from the event store, not an "
                "--events file")
    if ns.feed:
        # the flag wins over the env, here AND (inherited) in every worker
        os.environ["PIO_TRAIN_FEED"] = ns.feed
    if ns.window:
        dur = train_window.parse_duration_us(ns.window)
        if dur is None:
            print(f"[error] --window {ns.window!r}: expected a duration "
                  "like 90d, 12h, 30m, or 45s", file=sys.stderr)
            return 1
        os.environ["PIO_TRAIN_WINDOW"] = ns.window
        # resolved to an absolute bound once, so every read of this train —
        # every gang worker's included — cuts the log at the same
        # microsecond
        os.environ.setdefault("PIO_TRAIN_WINDOW_START_US",
                              str(train_window.now_us() - dur))
    if num_workers > 1 and not supervised_worker:
        # the gang default: the partitioned event log is the data plane
        os.environ.setdefault("PIO_TRAIN_FEED", "partition")
        return _train_supervised(args, ns, num_workers)
    if supervised_worker:
        _join_gang(ns.device)
    wp = WorkflowParams(
        batch=ns.batch,
        skip_sanity_check=ns.skip_sanity_check,
        stop_after_read=ns.stop_after_read,
        stop_after_prepare=ns.stop_after_prepare,
        checkpoint_every=ns.checkpoint_every,
        resume=ns.resume,
        nan_guard=ns.nan_guard,
        profile_dir=ns.profile_dir,
    )
    if ns.events is not None:
        return _train_file(ns, wp)

    from ...parallel.supervisor import DRAIN_EXIT_CODE, GangDrainRequested
    from ...workflow.context import WorkflowContext
    from ...workflow.core_workflow import run_train

    engine, params, factory, variant, _ = _load_engine(ns)
    ctx = WorkflowContext(app_name=_app_name(params), storage=Storage.instance(),
                          device=ns.device)
    # the read's and the trainer's phase times, printed below
    ctx.read_timings, ctx.bench_timings = {}, {}
    t0 = time.perf_counter()
    try:
        instance_id = run_train(engine, params, ctx, wp,
                                engine_factory_name=factory,
                                engine_variant=variant)
    except GangDrainRequested as e:
        # not a failure: the supervisor stops without restarting
        print(f"[info] Drained at step {e.step}; checkpoint kept — resume "
              "with `pio train --resume`.", flush=True)
        return DRAIN_EXIT_CODE
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


def _join_gang(device: str) -> None:
    """A supervised gang worker: join the gloo process group (a garbled
    rank or world size raises here, at start-up), route SIGTERM to the
    drain flag (checkpoint at the next sweep boundary, then exit), and
    make this rank's card the current device (on the CPU: give each rank
    its share of the cores). The first heartbeat comes from the training
    loop, after the first sweep."""
    from ...parallel.distributed import initialize_distributed, rank_device
    from ...parallel.supervisor import install_worker_signal_handlers

    import torch

    initialize_distributed()
    install_worker_signal_handlers()
    dev = rank_device(device)
    if dev.startswith("cuda"):
        torch.cuda.set_device(dev)
    else:
        # the ranks share the host's cores: N ranks each spinning one
        # thread per core starve each other at every collective
        from ...parallel.distributed import process_count

        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // process_count()))


def _strip_num_workers(args: list[str]) -> list[str]:
    """A worker's argv: the train argv minus the gang flag (a worker that
    spawned a gang of its own would fork without end)."""
    out, skip = [], False
    for tok in args:
        if skip:
            skip = False
            continue
        if tok == "--num-workers":
            skip = True
            continue
        if tok.startswith("--num-workers="):
            continue
        out.append(tok)
    return out


def _last_json(path: str) -> "dict | None":
    """The last JSON object line of a worker's log (its train report), or
    None when that attempt printed none."""
    try:
        with open(path, encoding="utf-8", errors="replace") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                return None
    return None


def _train_supervised(args: list[str], ns, num_workers: int) -> int:
    """`pio train --num-workers N`: N copies of this command line as a
    supervised gang (``parallel/supervisor.py``). The gang id is a fresh
    instance id, or on ``--resume`` the interrupted run's (found here, so
    the leader continues it instead of training from scratch). Prints the
    outcome and, last, one JSON line with every worker's train report."""
    from ...data.storage.event import new_event_id
    from ...parallel.supervisor import (
        COMPLETED, DRAINED, GangConfig, Supervisor,
    )
    from ...parallel.mesh import mesh_dims
    from ...workflow import train_feed
    from ...workflow.json_extractor import DEFAULT_FACTORY

    try:
        engine_json = _engine_json(ns)
        d, m = mesh_dims(num_workers)
        err = None
        if m > 1 and train_feed.partition_feed_active(Storage.instance()):
            err = (f"PIO_MESH_SHAPE={d}x{m}: the 2-D layout is the slab "
                   "gang's (--feed merged); the partition feed's "
                   "data-parallel trainer needs a 1-D data mesh")
    except (OSError, ValueError) as e:
        err = str(e)
    if err is not None:
        print(f"[error] {err}", file=sys.stderr)
        return 1
    if ns.checkpoint_every <= 0:
        print("[warn] gang training without --checkpoint-every: a restart "
              "retrains from scratch instead of resuming mid-run",
              file=sys.stderr)
    gang_id = None
    if ns.resume:
        from ...workflow.checkpoint import find_resumable_instance

        def params_of(key):
            block = engine_json.get(key) or {}
            if "params" in block or "name" in block:
                return block.get("params", {}) or {}
            return block

        prior = find_resumable_instance(
            Storage.instance(),
            engine_json.get("engineFactory") or DEFAULT_FACTORY, "1",
            engine_json.get("id", "default"),
            data_source_params=json.dumps(dict(params_of("datasource"))),
            preparator_params=json.dumps(dict(params_of("preparator"))))
        if prior is not None:
            gang_id = prior.id
            print(f"[info] --resume: continuing interrupted instance "
                  f"{gang_id}", flush=True)
        else:
            print("[info] --resume requested but no resumable instance "
                  "found; training from scratch", flush=True)
    gang_id = gang_id or new_event_id()
    worker_argv = [sys.executable, "-m",
                   "incubator_predictionio_torch.tools.console", "train",
                   *_strip_num_workers(args)]
    sup = Supervisor(worker_argv, num_workers,
                     config=GangConfig.from_env(num_workers),
                     gang_instance_id=gang_id)
    sup.install_signal_handlers()
    print(f"[info] Gang training: {num_workers} workers, instance "
          f"{gang_id}, run dir {sup.run_dir}", flush=True)
    t0 = time.perf_counter()
    outcome = sup.run()
    seconds = time.perf_counter() - t0
    reports = [_last_json(os.path.join(sup.run_dir, f"worker_{i}.log"))
               for i in range(num_workers)]
    if outcome == COMPLETED:
        print(f"[info] Gang training completed ({sup.restarts} restart(s)) "
              f"in {seconds:.2f}s. Engine instance ID: {gang_id}")
    elif outcome == DRAINED:
        print("[info] Gang drained cleanly; resume with `pio train "
              f"--num-workers {num_workers} --resume` (instance {gang_id}).")
    else:
        print(f"[error] Gang training failed after {sup.restarts} "
              f"restart(s); see the worker logs under {sup.run_dir}",
              file=sys.stderr)
    print(json.dumps({"engineInstanceId": gang_id, "state": outcome,
                      "seconds": seconds, "restarts": sup.restarts,
                      "runDir": sup.run_dir, "device": ns.device,
                      "workers": reports}), flush=True)
    return 1 if outcome not in (COMPLETED, DRAINED) else 0


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
                        "previous deployment, then exit (against a fleet "
                        "front this is a FLEET rollback)")
    p.add_argument("--replicas", default=None, metavar="N|auto",
                   help="serve as a fleet of N supervised engine-server "
                        "processes behind an L4 splice front with a staged "
                        "canary rollout (default $PIO_QUERY_REPLICAS, else "
                        "0 = single process); 'auto' arms elastic mode "
                        "within [$PIO_FLEET_MIN_REPLICAS, "
                        "$PIO_FLEET_MAX_REPLICAS]")
    p.add_argument("--replica-worker", action="store_true",
                   help=argparse.SUPPRESS)  # internal: one fleet replica
    ns = p.parse_args(args)
    if ns.model is not None and (ns.online_foldin or ns.quality_eval
                                 or ns.multitenant):
        p.error("--online-foldin, --quality-eval and --multitenant need the "
                "model store and the event log: not with --model")
    if ns.rollback:
        from .models import rollback_via_url

        # the scheme the server itself deploys with; loopback https skips
        # verification (its certificate need not name 127.0.0.1)
        scheme = "https" if _tls_requested() else "http"
        host = "127.0.0.1" if ns.ip in ("0.0.0.0", "::") else ns.ip
        return rollback_via_url(f"{scheme}://{host}:{ns.port}",
                                insecure=True)
    if ns.replica_worker:
        return _deploy_replica_worker(ns)
    from ...common import envknobs

    raw = (str(ns.replicas) if ns.replicas is not None
           else envknobs.env_str("PIO_QUERY_REPLICAS", "0"))
    elastic = raw.strip().lower() == "auto"
    if elastic:
        replicas = 0  # run_fleet starts at the operator floor
    else:
        try:
            replicas = max(0, int(raw))
        except ValueError:
            print(f"[error] --replicas expects an integer or 'auto', "
                  f"got {raw!r}", file=sys.stderr)
            return 1
    if replicas >= 1 or elastic:
        if ns.model is not None:
            p.error("--replicas needs the model store: not with --model")
        return _deploy_fleet(args, ns, replicas, elastic)
    from ...workflow.create_server import run_engine_server

    server = _build_engine_server(ns)
    print(f"[info] Engine is deployed and running. Listening on "
          f"{ns.ip}:{ns.port}", flush=True)
    run_engine_server(server, ns.ip, ns.port, probe_latency=ns.probe_latency)
    _print_served_launches()
    return 0


def _print_served_launches() -> None:
    """After serving stopped: this process's solve-kernel launches (the
    online fold-in's, in a fleet replica 0's alone) as one JSON line, the
    counterpart of train's ``kernel_launches``."""
    from ...common import envknobs

    replica = envknobs.env_int("PIO_FLEET_REPLICA", -1)
    print(json.dumps({"kernel_launches": _launches(),
                      "fleetReplica": replica if replica >= 0 else None,
                      "pid": os.getpid()}), flush=True)


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


def _strip_replicas(args: list[str]) -> list[str]:
    """A replica's argv: the deploy argv minus the fleet flag (a replica
    that spawned a fleet of its own would fork without end)."""
    out, skip = [], False
    for tok in args:
        if skip:
            skip = False
            continue
        if tok == "--replicas":
            skip = True
            continue
        if tok.startswith("--replicas="):
            continue
        out.append(tok)
    return out


def _tls_requested() -> bool:
    """The reference's TLS knobs (both set) are in the environment."""
    from ...common import envknobs

    return bool(envknobs.env_str("PIO_SSL_CERTFILE", "", lower=False)
                and envknobs.env_str("PIO_SSL_KEYFILE", "", lower=False))


def _deploy_fleet(args: list[str], ns, replicas: int,
                  elastic: bool = False) -> int:
    """`pio deploy --replicas N` front: the fleet coordinator and splice
    front (``workflow/fleet.py``) supervising N ``--replica-worker``
    copies of this command line. The front reads engine.json for the
    factory and variant names and never loads the engine or touches the
    card: the replicas carry the models."""
    from ...workflow import multitenant
    from ...workflow.fleet import run_fleet

    if _tls_requested():
        # the splice front and its readiness probes are plaintext L4: TLS
        # replicas would never probe ready, and the /healthz peek cannot
        # see inside a ClientHello
        print("[error] --replicas does not support PIO_SSL_CERTFILE/"
              "PIO_SSL_KEYFILE: the splice front and its readiness probes "
              "are plaintext L4. Terminate TLS at a proxy in front of the "
              "fleet and unset the PIO_SSL_* knobs here.", file=sys.stderr)
        return 1
    engine_json = _engine_json(ns)
    factory = engine_json.get("engineFactory", "engine")
    variant = engine_json.get("id", "default")
    worker_argv = [sys.executable, "-m",
                   "incubator_predictionio_torch.tools.console", "deploy",
                   "--replica-worker", *_strip_replicas(args)]
    if ns.probe_latency:
        print("[warn] --probe-latency is ignored with --replicas: the probe "
              "measures ONE process's hot path and would race N replicas "
              "writing the same instance row; probe a single-process "
              "deploy instead", file=sys.stderr)
    if ns.engine_instance_id:
        print("[warn] --engine-instance-id only seeds the replicas' FIRST "
              "load with --replicas: the fleet coordinator owns rollout and "
              "will stage (and, if healthy, promote) the newest COMPLETED "
              "instance on its next tick. To hold the fleet on an older "
              "version, roll back to it (`pio models rollback --engine-url "
              "<front>`) so the newer instance is pinned", file=sys.stderr)
    if elastic:
        print(f"[info] Engine fleet: elastic replicas behind "
              f"{ns.ip}:{ns.port} (autoscaler armed; bounds from "
              "PIO_FLEET_MIN/MAX_REPLICAS, staged canary rollout, front "
              "/healthz aggregates liveness + scaler state)", flush=True)
    else:
        print(f"[info] Engine fleet: {replicas} replica(s) behind "
              f"{ns.ip}:{ns.port} (staged canary rollout; front /healthz "
              "aggregates liveness)", flush=True)
    from ...common import envknobs

    armed = (ns.multitenant
             or envknobs.env_int("PIO_TENANT_MAX_RESIDENT", 0, lo=0) > 0)
    return run_fleet(worker_argv, replicas, ns.ip, ns.port,
                     engine_factory_name=factory, engine_variant=variant,
                     app_name=multitenant.fleet_app(engine_json, armed),
                     elastic=elastic)


def _deploy_replica_worker(ns) -> int:
    """One supervised fleet replica: its identity and port arrive in the
    supervisor's environment (the front owns --ip/--port). The
    ``fleet.spawn`` fault point fires BEFORE the engine loads."""
    from ...workflow.create_server import run_engine_server
    from ...workflow.fleet import replica_worker_entry

    port = replica_worker_entry()
    if port <= 0:
        return 1
    server = _build_engine_server(ns)
    run_engine_server(server, "127.0.0.1", port)
    _print_served_launches()
    return 0


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
