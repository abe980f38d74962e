"""The port's ``pio`` console: one verb per command.

    python -m incubator_predictionio_torch.tools.console <verb> [args]
    pio-torch <verb> [args]                     # the installed script

Verbs (``tools/commands/``), on the event store and metadata of
``$PIO_FS_BASEDIR/pio.sqlite`` (or the ``PIO_STORAGE_*`` configuration,
e.g. the events on a JSONL log):

    app new|list|show|delete|channel-new|channel-delete|data-delete
    accesskey new|list|delete
    import --app-name A --input F [--format auto|jsonl|parquet]
    export --app-name A --output F [--format auto|jsonl|parquet]
    eventserver [--ip H] [--port 7070]
    eventlog compact [--min-new-bytes N] | scrub | status | retire [--ttl D]
             | tail [--app A | --appid N] [--channel C] [--from CURSOR]
                    [--limit N]
    build [--engine-dir D]
    train [--engine-dir D | --engine-json J] [--device cpu] [--batch B]
          [--window DUR] [--checkpoint-every N] [--resume] [--nan-guard]
          [--profile-dir D]
          [--skip-sanity-check] [--stop-after-read] [--stop-after-prepare]
    deploy [--engine-dir D | --engine-json J] [--engine-instance-id ID]
           [--ip H] [--port 8000] [--device cpu] [--feedback]
           [--batch-window-ms MS] [--max-batch N] [--probe-latency]
           [--query-conc N] [--query-max-pending N] [--query-deadline-ms MS]
           [--drain-deadline-ms MS] [--model-refresh-ms MS]
           [--query-cache-size N] [--rollback]
    undeploy [--ip H] [--port 8000]
    batchpredict --input Q.jsonl --output P.jsonl [--engine-dir D]
                 [--engine-instance-id ID] [--device cpu]
    models list | verify | rollback --engine-url URL
           | gc [--keep N] [--engine-url URL] [--dry-run]
    status [--engine-url URL]
    eval EVALUATION [GENERATOR] [--engine-dir D] [--app-name A] [--batch B]
         [--parallel-candidates N] [--device cpu]
    dashboard [--ip H] [--port 9000]
    adminserver [--ip H] [--port 7071]
    template list | get NAME DEST      run module.function [args]
    shell [-c STMT]                    upgrade
    soak [--engine-dir D] [--device cpu] [--seed S] [--duration-s T]
         [--event-workers N] [--replicas N] [--faults LIST] [--out F]
         [--dry-run] ...

``train`` reads the app's events from the event store, trains the engine
that engine.json names, writes an engine-instance row and a checksummed
model blob, and prints one JSON line (instance id, seconds, device, the
solve-kernel launches, the training window and the read/train phase
times). ``deploy`` serves
``POST /queries.json`` from the newest deployable COMPLETED instance
(walking back past a corrupt blob or one the validation gate refuses)
through the engine server of ``workflow/create_server.py`` until
SIGTERM, Ctrl-C or ``undeploy``, which drain it. ``batchpredict`` answers
a JSON-lines file of queries in one batch; ``models`` lists, verifies,
rolls back or garbage-collects the stored models. ``eval`` evaluates the candidate
parameters of an Evaluation and stores the leaderboard, which
``dashboard`` serves. ``train``, ``deploy`` and ``eval`` run on the card
unless ``--device cpu`` is given; ``--engine-dir`` names a user engine's
directory, which goes first on ``sys.path``.

The file-based forms stay beside them: ``train --events F.jsonl --model-out
M.npz`` reads a JSON-lines events file and writes the model file (snapshots
in ``<model-out>.checkpoints/``), and ``deploy --model M.npz`` serves it.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from ..workflow.persist import load_models, save_models
from ..workflow.workflow_params import WorkflowParams

# the controller API and the workflow (torch) are imported by the helpers
# that train or load, never at module import: a verb that needs neither
# (app, import, eventlog, status, models, undeploy, ...) starts without
# torch, seconds sooner on a card host


def engine_from_json(engine_json: dict, engine_dir: Optional[str] = None):
    """The Engine that engine.json's ``engineFactory`` names (a factory of
    this package or of a user engine in ``engine_dir``; the Recommendation
    engine when absent)."""
    from ..workflow import json_extractor

    return json_extractor.engine_and_params_from_json(engine_json,
                                                      engine_dir)[0]


def checkpoint_dir(model_out: str) -> str:
    """Where a train's snapshots live: ``<model-out>.checkpoints/``, the
    run being keyed by its output path."""
    return model_out + ".checkpoints"


def train(engine_json: dict, events: list[dict], model_out: str,
          device: str = "cuda",
          workflow_params: Optional[WorkflowParams] = None,
          engine_dir: Optional[str] = None) -> Optional[float]:
    """Train and persist; returns the training seconds, or None when
    ``stop_after_read`` / ``stop_after_prepare`` halted the run (nothing
    is persisted then).

    With ``checkpoint_every`` or ``resume``, snapshots go to
    :func:`checkpoint_dir`: a fresh (not resumed) train starts by clearing
    them, a completed train deletes them, and a failed one keeps them for
    ``resume``."""
    from ..controller import EngineParams
    from ..workflow import core_workflow
    from ..workflow.checkpoint import CheckpointHook
    from ..workflow.context import WorkflowContext

    wp = workflow_params or WorkflowParams()
    engine = engine_from_json(engine_json, engine_dir)
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
        models = core_workflow.train_with_stale_checkpoint_fallback(
            engine, params, ctx, wp)
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


def load_deployment(model_path: str, device: str = "cuda",
                    engine_dir: Optional[str] = None):
    """Restore persisted models into a live Deployment on ``device``."""
    from ..controller import EngineParams
    from ..workflow.context import WorkflowContext

    engine_json, stored = load_models(model_path)
    engine = engine_from_json(engine_json, engine_dir)
    ctx = WorkflowContext(device=device)
    deployment = engine.prepare_deployment(
        ctx, EngineParams.from_json(engine_json), stored)
    for model in deployment.models:
        warm = getattr(model, "warm_up", None)
        if warm is not None:
            warm()
    return deployment, ctx


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["soak"]:
        # the soak driver only builds argv for subprocesses (which set up
        # their own device): it is dispatched before anything can import
        # torch, so the scenario clock never pays for it
        from .commands.soak import soak_cmd

        return soak_cmd(argv[1:])
    from . import commands

    if not argv or argv[0] in ("-h", "--help", "help"):
        print(commands.usage())
        return 0
    if argv[0] == "version":
        from .. import __version__

        print(__version__)
        return 0
    return commands.dispatch(argv[0], argv[1:])


if __name__ == "__main__":
    sys.exit(main())
