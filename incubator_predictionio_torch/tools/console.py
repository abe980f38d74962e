"""``train`` and ``deploy`` for the port.

    python -m incubator_predictionio_torch.tools.console train \\
        --engine-json engine.json --events events.jsonl --model-out model.npz \\
        [--device cpu] [--checkpoint-every N] [--resume] [--nan-guard] \\
        [--skip-sanity-check] [--stop-after-read] [--stop-after-prepare]
    python -m incubator_predictionio_torch.tools.console deploy \\
        --model model.npz --port 8000 [--host 127.0.0.1] [--device cpu]

``train`` reads a JSON-lines events file (the ``pio import`` format), trains
the engine that engine.json names and writes the persisted models with the
engine.json beside them, and prints one JSON line (seconds, device and the
solve-kernel launches). Its flags are ``pio train``'s; snapshots live in
``<model-out>.checkpoints/`` (deleted when the train completes, kept when
it fails, for ``--resume``). ``deploy`` restores the models and serves
``POST /queries.json`` until SIGTERM or Ctrl-C. Both run on the card unless
``--device cpu`` is given. The metadata and event stores and the rest of
the ``pio`` commands wait for a later slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import logging
import signal
import sys
import time
from typing import Optional

from ..controller import EngineParams
from ..data.events import read_events
from ..ops import spd_solve
from ..workflow.checkpoint import CheckpointHook, CheckpointIncompatibleError
from ..workflow.context import WorkflowContext
from ..workflow.create_server import EngineServer
from ..workflow.persist import load_models, save_models
from ..workflow.workflow_params import WorkflowParams

log = logging.getLogger("pio.torch.console")

_PACKAGE = "incubator_predictionio_torch."
_DEFAULT_FACTORY = _PACKAGE + "models.recommendation.RecommendationEngine"


def engine_from_json(engine_json: dict):
    """The Engine that engine.json's ``engineFactory`` names (a factory of
    this package; the Recommendation engine when absent)."""
    path = engine_json.get("engineFactory") or _DEFAULT_FACTORY
    if not path.startswith(_PACKAGE):
        raise ValueError(
            f"engineFactory {path!r} is not a factory of this package "
            f"(expected {_PACKAGE}...)")
    module, _, name = path.rpartition(".")
    factory = getattr(importlib.import_module(module), name)
    return factory()()


def checkpoint_dir(model_out: str) -> str:
    """Where a train's snapshots live: ``<model-out>.checkpoints/``, the
    run being keyed by its output path."""
    return model_out + ".checkpoints"


def _train_with_stale_checkpoint_fallback(engine, params, ctx,
                                          wp: WorkflowParams):
    """engine.train; on ``--resume``, a snapshot that cannot continue this
    run (other data, rank or iterations) is discarded and the train starts
    from scratch (the reference's core_workflow.py:67-102)."""
    try:
        return engine.train(ctx, params, wp)
    except CheckpointIncompatibleError as e:
        if ctx.checkpoint_hook is None or not wp.resume:
            raise
        log.warning("--resume: %s; discarding stale checkpoints and "
                    "training from scratch", e)
        ctx.checkpoint_hook.delete_all()
        return engine.train(ctx, params, dataclasses.replace(wp, resume=False))


def train(engine_json: dict, events: list[dict], model_out: str,
          device: str = "cuda",
          workflow_params: Optional[WorkflowParams] = None) -> Optional[float]:
    """Train and persist; returns the training seconds, or None when
    ``stop_after_read`` / ``stop_after_prepare`` halted the run (nothing
    is persisted then).

    With ``checkpoint_every`` or ``resume``, snapshots go to
    :func:`checkpoint_dir`: a fresh (not resumed) train starts by clearing
    them, a completed train deletes them, and a failed one keeps them for
    ``resume``."""
    wp = workflow_params or WorkflowParams()
    engine = engine_from_json(engine_json)
    params = EngineParams.from_json(engine_json)
    ctx = WorkflowContext(events=events, device=device)
    if wp.checkpoint_every > 0 or wp.resume:
        ctx.checkpoint_hook = CheckpointHook(checkpoint_dir(model_out),
                                             every_n=wp.checkpoint_every)
        if not wp.resume:
            ctx.checkpoint_hook.delete_all()
    hook = ctx.checkpoint_hook
    try:
        t0 = time.perf_counter()
        models = _train_with_stale_checkpoint_fallback(engine, params, ctx, wp)
        seconds = time.perf_counter() - t0
        if wp.stop_after_read or wp.stop_after_prepare:
            return None
        _, _, algo_list, _ = engine.make_components(params)
        stored = [algo.prepare_model_for_persistence(m)
                  for (_, algo), m in zip(algo_list, models)]
        save_models(model_out, engine_json, stored)
    finally:
        if hook is not None:
            hook.close()  # on failure the snapshots stay for --resume
    if hook is not None:
        hook.delete_all()  # superseded by the persisted model
    return seconds


def load_deployment(model_path: str, device: str = "cuda"):
    """Restore persisted models into a live Deployment on ``device``."""
    engine_json, stored = load_models(model_path)
    engine = engine_from_json(engine_json)
    ctx = WorkflowContext(device=device)
    deployment = engine.prepare_deployment(
        ctx, EngineParams.from_json(engine_json), stored)
    for model in deployment.models:
        warm = getattr(model, "warm_up", None)
        if warm is not None:
            warm()
    return deployment, ctx


def _raise_exit(signum, frame):
    raise SystemExit(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m incubator_predictionio_torch.tools.console")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train an engine from an events file")
    t.add_argument("--engine-json", required=True)
    t.add_argument("--events", required=True, help="JSON-lines events file")
    t.add_argument("--model-out", required=True)
    t.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    t.add_argument("--skip-sanity-check", action="store_true")
    t.add_argument("--stop-after-read", action="store_true")
    t.add_argument("--stop-after-prepare", action="store_true")
    t.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="snapshot algorithm state every N iterations into "
                        "<model-out>.checkpoints/")
    t.add_argument("--resume", action="store_true",
                   help="continue an interrupted train of the same "
                        "--model-out from its last snapshot")
    t.add_argument("--nan-guard", action="store_true",
                   help="fail with stage/iteration attribution when a stage "
                        "produces NaN/Inf (iterative trainers run one "
                        "iteration at a time)")
    d = sub.add_parser("deploy", help="serve a trained model over HTTP")
    d.add_argument("--model", required=True)
    d.add_argument("--host", default="127.0.0.1")
    d.add_argument("--port", type=int, default=8000)
    d.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.cmd == "train":
        with open(args.engine_json, encoding="utf-8") as fh:
            engine_json = json.load(fh)
        events = read_events(args.events)
        wp = WorkflowParams(
            skip_sanity_check=args.skip_sanity_check,
            stop_after_read=args.stop_after_read,
            stop_after_prepare=args.stop_after_prepare,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            nan_guard=args.nan_guard)
        seconds = train(engine_json, events, args.model_out, args.device, wp)
        # the solve-kernel launches of this run, per kernel (0 on the CPU)
        launches = {"warp": spd_solve.gauss_jordan_warp_launches.count,
                    "wide": spd_solve.gauss_jordan_wide_launches.count}
        print(json.dumps({"trained": None if seconds is None
                          else args.model_out, "events": len(events),
                          "seconds": seconds, "device": args.device,
                          "kernel_launches": launches}),
              flush=True)
        return 0

    deployment, ctx = load_deployment(args.model, args.device)
    server = EngineServer(deployment, args.host, args.port,
                          info={"model": args.model, "device": str(ctx.device)})
    signal.signal(signal.SIGTERM, _raise_exit)
    host, port = server.address
    print(f"listening on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
