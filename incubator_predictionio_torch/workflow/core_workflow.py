"""CoreWorkflow — run a training job against the stores and load one back.

Port of ``incubator_predictionio_tpu/workflow/core_workflow.py`` (:34-104,
:195-549; reference: core/.../workflow/{CoreWorkflow,CreateWorkflow}.scala):

- :func:`run_train` stamps an EngineInstance row RUNNING, runs
  ``Engine.train`` (read from the event store → prepare → train on the
  card), writes the models as one checksummed artifact
  (``workflow/model_artifact.py``) and stamps the row COMPLETED; a failure
  stamps it ABORTED (never masking the original error) and keeps the
  snapshots for ``--resume``, which finds the interrupted instance and
  continues it under its own id and checkpoint directory.
- On a JSONL event store, :func:`run_train` also seeds the online fold-in
  cursor row (``model_artifact.foldin_row_id``) with the log position it
  read from, when no such row exists yet — the same row and cursor as the
  reference's train, so a fold-in producer resumes from the right byte.
- In a training gang (``pio train --num-workers N``, reference :105-135,
  :215-265) the supervisor pins ONE instance id for every attempt
  (``PIO_GANG_INSTANCE_ID``): rank 0 (the leader) owns the row — a direct
  ``get`` on ``--resume``, never a discovery that could pick another
  interrupted run — and persists the model; the other ranks
  (:func:`_run_train_follower`) take part in every collective and every
  checkpoint barrier and persist nothing (the factors are replicated).
- ``pio train --profile-dir D`` (reference :359-372, a
  ``jax.profiler.trace``) records the train stage with ``torch.profiler``
  (CPU activity, and CUDA activity on the card: a card whose torch cannot
  trace CUDA, or a trace that holds no kernel, raises rather than leave a
  CPU-only trace) and writes it as Chrome JSON to :func:`trace_path`, one
  file per gang rank.
- :func:`load_deployment` picks the newest COMPLETED instance of the
  engine and walks back past any whose artifact fails verification or does
  not load; an explicit instance id never walks back.

The payload is the ``.npz`` bytes of ``workflow/persist.py`` (never a
pickle). A model that is a :class:`..controller.PersistentModel` saves
itself (``model.save(instance_id, params)``) and leaves only a marker in
the payload, its class's dotted path (``__persistent__``); the deploy
resolves that class (a path into the JAX package is refused before any
import) and calls its ``load(instance_id, ctx)``. Instances are keyed by
the engine factory's dotted name, so the JAX package's instances in a
shared store are never picked here.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime as _dt
import json
import logging
import os
import socket
from typing import Any, Optional

from ..controller.engine import Engine, EngineParams
from ..controller.persistent_model import PersistentModel
from ..data.storage.base import EngineInstance
from ..data.storage.event import new_event_id
from ..common import envknobs
from ..parallel import supervisor as gang
from . import model_artifact
from .checkpoint import (
    CheckpointHook, CheckpointIncompatibleError, find_resumable_instance,
    instance_checkpoint_dir,
)
from .context import WorkflowContext
from .persist import models_from_bytes, models_to_bytes
from .workflow_params import WorkflowParams

log = logging.getLogger("pio.torch.workflow")


def _utcnow():
    return _dt.datetime.now(_dt.timezone.utc)


def engine_json_of(engine_params: EngineParams, factory: str,
                   variant: str = "default") -> dict:
    """The engine.json dict that selects ``engine_params``."""
    def block(name, params):
        out = {"params": dict(params)}
        if name:
            out["name"] = name
        return out

    return {
        "id": variant, "engineFactory": factory,
        "datasource": block(engine_params.data_source_name,
                            engine_params.data_source_params),
        "preparator": block(engine_params.preparator_name,
                            engine_params.preparator_params),
        "algorithms": [{"name": n, "params": dict(p)}
                       for n, p in engine_params.algorithm_params_list],
        "serving": block(engine_params.serving_name,
                         engine_params.serving_params),
    }


#: the persisted dict's key that marks a self-persisted model
PERSISTENT_MARKER = "__persistent__"


def serialize_models(algo_list, models: list[Any], engine_json: dict) -> bytes:
    """Trained models → the persisted dicts → ``.npz`` bytes. A
    PersistentModel is stored as the marker naming its class (it saved
    itself)."""
    stored = [
        {PERSISTENT_MARKER: type(model).__module__ + "."
         + type(model).__qualname__}
        if isinstance(model, PersistentModel)
        else algo.prepare_model_for_persistence(model)
        for (_, algo), model in zip(algo_list, models)]
    return models_to_bytes(engine_json, stored)


def deserialize_models(blob: bytes) -> list[dict]:
    """``.npz`` bytes → the persisted dict of each algorithm (raises on
    bytes that are not such an ``.npz``, a pickle included)."""
    return models_from_bytes(blob)[1]


def load_persistent_models(stored: list, instance_id: str, ctx) -> list:
    """Each marker of a self-persisted model replaced by its class's
    ``load(instance_id, ctx)``; a class path into the JAX package raises
    before anything is imported."""
    from .json_extractor import resolve_engine_factory

    return [resolve_engine_factory(item[PERSISTENT_MARKER]).load(
                instance_id, ctx)
            if isinstance(item, dict) and PERSISTENT_MARKER in item
            else item for item in stored]


def trace_path(profile_dir: str, instance_id: Optional[str],
               rank: str = "0") -> str:
    """Where ``--profile-dir`` puts one rank's trace of one train: ranks of
    a gang, and trains into the same directory, never share a file."""
    return os.path.join(profile_dir,
                        f"train-{instance_id or 'file'}-rank{rank}"
                        ".pt.trace.json")


def trace_kernels(path: str) -> dict:
    """Kernel name → launches in a Chrome trace that ``--profile-dir``
    wrote (its ``"cat": "kernel"`` events)."""
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh).get("traceEvents", [])
    return dict(collections.Counter(ev.get("name", "") for ev in events
                                    if ev.get("cat") == "kernel"))


@contextlib.contextmanager
def profiled(ctx, wp: WorkflowParams):
    """A torch.profiler trace of the ``with`` body into ``wp.profile_dir``
    (a null context when it is empty). On the card the trace must hold
    CUDA activity: there is no quiet fall back to a CPU-only trace."""
    if not wp.profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities

    on_card = torch.device(ctx.device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "--profile-dir on the card needs torch.profiler's CUDA "
                "activity, which this torch build does not offer")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(wp.profile_dir, exist_ok=True)
    path = trace_path(wp.profile_dir, ctx.engine_instance_id,
                      envknobs.env_str("PIO_PROCESS_ID", "0"))
    with profile(activities=activities) as prof:
        yield path
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    if on_card and not trace_kernels(path):
        raise RuntimeError(
            f"--profile-dir: the trace {path} holds no CUDA kernel; the "
            "profiler recorded no device activity on this host")
    log.info("profiler trace written to %s", path)


def train_with_stale_checkpoint_fallback(engine, engine_params, ctx, wp):
    """engine.train with the --resume stale-snapshot fallback: a
    CheckpointIncompatibleError (data/rank changed) discards the
    checkpoints and retrains from scratch — otherwise every future
    --resume re-selects the same instance and fails the same way. With
    ``wp.profile_dir`` the train runs under :func:`profiled`."""
    with profiled(ctx, wp):
        return _train_with_fallback(engine, engine_params, ctx, wp)


def _train_with_fallback(engine, engine_params, ctx, wp):
    try:
        return engine.train(ctx, engine_params, wp)
    except CheckpointIncompatibleError as e:
        if ctx.checkpoint_hook is None or not wp.resume:
            raise
        log.warning(
            "--resume: %s; discarding stale checkpoints and training "
            "from scratch", e,
        )
        root = ctx.checkpoint_hook
        root.delete_all()
        ctx.checkpoint_hook = CheckpointHook(
            root.directory, every_n=root.every_n,
            max_to_keep=root.max_to_keep,
        )
        ctx.workflow_params = dataclasses.replace(wp, resume=False)
        try:
            return engine.train(ctx, engine_params, ctx.workflow_params)
        finally:
            ctx.workflow_params = wp


def _capture_foldin_anchor(storage, ctx):
    """(app_id, LogCursor) at the current event-log end, or None when
    fold-in cannot apply (an event store that is not a JSONL log, no app).
    Best-effort: training never fails over its online-learning
    bookkeeping."""
    try:
        from ..data.api.log_tail import LogTailer

        le = storage.get_l_events()
        events_dir = getattr(le, "events_dir", None)
        if not events_dir or not ctx.app_name:
            return None
        app = storage.get_meta_data_apps().get_by_name(ctx.app_name)
        if app is None:
            return None
        return app.id, LogTailer(events_dir, app.id).end_cursor()
    except Exception:  # noqa: BLE001 — bookkeeping only
        return None


def _persist_foldin_anchor(storage, anchor, ctx, engine_factory_name,
                           engine_variant) -> None:
    """Seed the fold-in cursor row from a completed train — only when none
    exists yet: a live fold-in producer owns an existing row (single
    writer), and rewinding it under a running tailer would re-fold
    everything since its last tick."""
    if anchor is None:
        return
    try:
        import time as _time

        app_id, cursor = anchor
        group = model_artifact.fleet_group(engine_factory_name,
                                           engine_variant)
        row_id = model_artifact.foldin_row_id(group, app_id)
        if model_artifact.read_fleet_doc(storage, row_id) is not None:
            return
        model_artifact.write_fleet_doc(storage, row_id, {
            "cursor": cursor.to_json(),
            "group": group,
            "appId": app_id,
            "app": ctx.app_name,
            "intervalMs": 0.0,
            "updatedAt": _time.time(),
            "caughtUpAt": None,
            "events": 0,
            "publishes": 0,
            "anchor": "train",
        })
        log.info("fold-in cursor anchored at this train's read position "
                 "(LSN %d) for app %r", cursor.total(), ctx.app_name)
    except Exception:  # noqa: BLE001 — bookkeeping only
        log.debug("could not persist the fold-in train anchor",
                  exc_info=True)


def _require_gang_capable(engine: Engine, engine_params: EngineParams,
                          world: int) -> None:
    """A gang of ``world`` > 1 trains only engines whose algorithms train
    in a gang (``Algorithm.gang_capable``): every template of the port
    does (the ALS templates through ``ops.als``, the linear ones through
    ``ops.linear``'s process-local trainers, the CCO ones through
    ``ops.llr``'s split counts); a user engine's algorithm must say so.
    Every rank refuses alike, before any collective."""
    if world <= 1:
        return
    ds, _, algos, _ = engine.make_components(engine_params)
    if not all(getattr(a, "gang_capable", False) for _, a in algos):
        raise NotImplementedError(
            f"{type(ds).__name__} / "
            f"{', '.join(type(a).__name__ for _, a in algos)}: an algorithm "
            "without gang_capable = True cannot train in a gang (--num-"
            "workers > 1); train it in one process")


def _run_train_follower(engine, engine_params, ctx, wp, gang_id: str) -> str:
    """Gang ranks 1..N-1: take part in every training collective (and the
    checkpoint barriers) under the supervisor-pinned instance id, and leave
    ALL metadata and model persistence to the leader — the factors are
    replicated, so the leader's copy is the gang's."""
    ctx.engine_instance_id = gang_id
    if wp.resume:
        prior = ctx.get_storage().get_meta_data_engine_instances().get(
            gang_id)
        if prior is not None and prior.status == "COMPLETED":
            # the leader's already-COMPLETED exit, mirrored: on a relaunch
            # that raced the finish line every rank must skip training, or
            # the ones that do not would wait forever in the first
            # collective
            log.info("gang follower: EngineInstance %s already COMPLETED; "
                     "nothing to do", gang_id)
            return gang_id
    if wp.checkpoint_every > 0 or wp.resume:
        ctx.checkpoint_hook = CheckpointHook(
            instance_checkpoint_dir(gang_id), every_n=wp.checkpoint_every)
    try:
        train_with_stale_checkpoint_fallback(engine, engine_params, ctx, wp)
    finally:
        if ctx.checkpoint_hook is not None:
            ctx.checkpoint_hook.close()
            ctx.checkpoint_hook = None
    log.info("gang follower %s: train stage complete",
             envknobs.env_str("PIO_PROCESS_ID", "?"))
    return gang_id


def run_train(
    engine: Engine,
    engine_params: EngineParams,
    ctx: Optional[WorkflowContext] = None,
    workflow_params: Optional[WorkflowParams] = None,
    engine_factory_name: str = "",
    engine_variant: str = "default",
) -> str:
    """Run the training workflow; returns the engine-instance id."""
    from ..parallel.distributed import process_count

    ctx = ctx or WorkflowContext()
    wp = workflow_params or WorkflowParams()
    ctx.workflow_params = wp
    # resolved once for every stage of this run, and logged: whether a
    # train streamed must be readable from its log
    pl = ctx.get_input_pipeline()
    log.info("input pipeline: mode=%s chunk_rows=%d chunk_docs=%d depth=%d "
             "workers=%d", pl.mode, pl.chunk_rows, pl.chunk_docs, pl.depth,
             pl.workers)
    _require_gang_capable(engine, engine_params, process_count())
    gang_id = os.environ.get(gang.ENV_GANG_INSTANCE_ID) or None
    if gang_id and envknobs.env_str("PIO_PROCESS_ID", "0") != "0":
        return _run_train_follower(engine, engine_params, ctx, wp, gang_id)
    storage = ctx.get_storage()
    instances = storage.get_meta_data_engine_instances()

    instance = EngineInstance(
        id=new_event_id(),
        status="RUNNING",
        start_time=_utcnow(),
        end_time=None,
        engine_id=engine_factory_name or "engine",
        engine_version="1",
        engine_variant=engine_variant,
        engine_factory=engine_factory_name,
        batch=wp.batch,
        # pid/host let `--resume` distinguish a SIGKILL'd RUNNING row from a
        # train that is genuinely still alive on this machine.
        env={"appName": ctx.app_name, "pid": str(os.getpid()),
             "host": socket.gethostname()},
        data_source_params=json.dumps(dict(engine_params.data_source_params)),
        preparator_params=json.dumps(dict(engine_params.preparator_params)),
        algorithms_params=json.dumps(
            [{"name": n, "params": dict(p)} for n, p in engine_params.algorithm_params_list]
        ),
        serving_params=json.dumps(dict(engine_params.serving_params)),
    )
    if gang_id:
        # the supervisor-pinned id: the row and the checkpoint directory
        # are shared by every attempt of the gang
        instance = EngineInstance(**{**instance.__dict__, "id": gang_id})
        prior = instances.get(gang_id) if wp.resume else None
        if prior is not None and prior.status == "COMPLETED":
            # a relaunch raced the finish line: the job is done, and every
            # rank takes this same exit (the followers read the same row)
            log.info("gang resume: EngineInstance %s is already COMPLETED; "
                     "nothing to do", gang_id)
            return gang_id
        if (prior is not None
                and prior.algorithms_params != instance.algorithms_params):
            log.warning(
                "gang --resume: instance %s has different algorithm params; "
                "discarding its checkpoints and training from scratch",
                gang_id)
            CheckpointHook(instance_checkpoint_dir(gang_id)).delete_all()
            prior = None
        if (prior is not None
                and os.path.isdir(instance_checkpoint_dir(gang_id))):
            instance = EngineInstance(
                **{**instance.__dict__, "start_time": prior.start_time})
            instances.update(instance)
            log.info("gang resume: continuing EngineInstance %s", gang_id)
        elif instances.get(gang_id) is not None:
            # the row exists but no snapshot landed before the relaunch:
            # retake it fresh (an insert would be a duplicate key)
            instances.update(instance)
        else:
            instances.insert(instance)
        instance_id = gang_id
    elif wp.resume:
        prior = find_resumable_instance(
            storage, engine_factory_name or "engine", "1", engine_variant,
            data_source_params=instance.data_source_params,
            preparator_params=instance.preparator_params,
        )
        if prior is not None and prior.algorithms_params != instance.algorithms_params:
            # Same data, changed hyperparameters — resuming would blend
            # them. The superseded snapshots are useless under the new
            # params: drop them and retire the row.
            log.warning(
                "--resume: interrupted instance %s has different algorithm "
                "params than the current engine.json; discarding its "
                "checkpoints and training from scratch",
                prior.id,
            )
            CheckpointHook(instance_checkpoint_dir(prior.id)).delete_all()
            if prior.status == "RUNNING":
                instances.update(prior.with_status("ABORTED", _utcnow()))
            prior = None
        if prior is not None:
            # Continue the interrupted run under its own instance id so the
            # checkpoint directory and metadata row line up.
            instance = EngineInstance(**{**instance.__dict__, "id": prior.id,
                                         "start_time": prior.start_time})
            instances.update(instance)
            instance_id = prior.id
            log.info("resuming interrupted EngineInstance %s", instance_id)
        else:
            log.info("--resume requested but no resumable instance found; "
                     "training from scratch")
            instance_id = instances.insert(instance)
    else:
        instance_id = instances.insert(instance)
    ctx.engine_instance_id = instance_id
    log.info("EngineInstance %s RUNNING", instance_id)
    # The fold-in anchor is the log position BEFORE the training read, so
    # an event racing the read may be both trained and folded (at least
    # once), never dropped.
    foldin_anchor = _capture_foldin_anchor(storage, ctx)

    if wp.checkpoint_every > 0 or wp.resume:
        ctx.checkpoint_hook = CheckpointHook(
            instance_checkpoint_dir(instance_id), every_n=wp.checkpoint_every
        )

    try:
        models = train_with_stale_checkpoint_fallback(
            engine, engine_params, ctx, wp)
        gang.beat()
        if wp.stop_after_read or wp.stop_after_prepare:
            instances.update(instance.with_status("ABORTED", _utcnow()))
            if ctx.checkpoint_hook is not None:
                ctx.checkpoint_hook.close()
                ctx.checkpoint_hook = None
            return instance_id

        # persistence has no natural beat points: a background beat keeps
        # the supervisor from gang-killing a job whose training succeeded
        with gang.beat_while():
            _, _, algo_list, _ = engine.make_components(engine_params)
            persistent = sum(
                1 for (_, algo), model in zip(algo_list, models)
                if isinstance(model, PersistentModel)
                and model.save(instance_id, algo.params))
            blob = serialize_models(
                algo_list, models,
                engine_json_of(engine_params, engine_factory_name,
                               engine_variant))
            # The Model row must land before the COMPLETED stamp below: a
            # crash in between leaves a RUNNING row (never deployed)
            # instead of a COMPLETED row without a model.
            sha = model_artifact.write_model(storage, instance_id, blob)
            log.info("models persisted: %d bytes (sha256 %s), %d "
                     "self-persisted", len(blob), sha[:12], persistent)
            done = EngineInstance(
                **{**instance.__dict__, "id": instance_id}
            ).with_status("COMPLETED", _utcnow())
            instances.update(done)
            if ctx.checkpoint_hook is not None:
                ctx.checkpoint_hook.delete_all()  # superseded by the model
                ctx.checkpoint_hook = None
        _persist_foldin_anchor(storage, foldin_anchor, ctx,
                               engine_factory_name, engine_variant)
        log.info("EngineInstance %s COMPLETED", instance_id)
        return instance_id
    except Exception:
        # Best-effort ABORTED stamp: when the failure IS the storage
        # backend, this second write fails too — it must never mask the
        # original training error.
        try:
            instances.update(
                EngineInstance(
                    **{**instance.__dict__, "id": instance_id}
                ).with_status("ABORTED", _utcnow())
            )
        except Exception:  # noqa: BLE001 - the original error wins
            log.exception(
                "could not stamp EngineInstance %s ABORTED (storage "
                "unavailable?); surfacing the original failure", instance_id)
        if ctx.checkpoint_hook is not None:
            ctx.checkpoint_hook.close()  # keep snapshots for --resume
            ctx.checkpoint_hook = None
        raise


def load_deployment(
    engine: Engine,
    instance_id: Optional[str],
    ctx: Optional[WorkflowContext] = None,
    engine_factory_name: str = "",
    engine_variant: str = "default",
    exclude_ids=(),
    on_reject=None,
    app_name: Optional[str] = None,
):
    """Load a trained instance for serving → (deployment, instance,
    engine_params).

    ``instance_id`` None → the newest *deployable* COMPLETED instance:
    every candidate's stored model is verified, and a corrupt, missing or
    unloadable artifact makes the loader walk back to the next-older
    COMPLETED instance — the bad blob is counted and kept, never deleted.
    ``exclude_ids`` skips instances the caller has pinned;
    ``on_reject(instance_id, kind)`` is called per skipped instance. An
    explicit ``instance_id`` never walks back: a failure surfaces as an
    error. ``app_name`` confines the walk to one app's instances."""
    ctx = ctx or WorkflowContext()
    storage = ctx.get_storage()
    instances = storage.get_meta_data_engine_instances()
    excluded = set(exclude_ids or ())
    if instance_id is None:
        candidates = instances.get_completed(
            engine_factory_name or "engine", "1", engine_variant
        )
        if app_name is not None:
            candidates = [
                c for c in candidates
                if model_artifact.instance_app_name(c) == app_name]
        if not candidates:
            raise RuntimeError(
                "No COMPLETED engine instance found"
                + (f" for app {app_name!r}" if app_name else "")
                + "; run `pio train` first"
            )
        candidates = [c for c in candidates if c.id not in excluded]
        if not candidates:
            raise RuntimeError(
                "Every COMPLETED engine instance "
                + (f"for app {app_name!r} " if app_name else "")
                + "is excluded; train a fresh instance or deploy one "
                "explicitly")
    else:
        instance = instances.get(instance_id)
        if instance is None:
            raise RuntimeError(f"Engine instance {instance_id} not found")
        candidates = [instance]

    rejected: list[str] = []
    caller_app_name = ctx.app_name
    for instance in candidates:
        try:
            payload = model_artifact.read_model(storage, instance.id)
        except model_artifact.ModelIntegrityError as e:
            if instance_id is not None:
                raise
            rejected.append(f"{instance.id} ({e.kind})")
            if on_reject is not None:
                on_reject(instance.id, e.kind)
            log.warning("%s; walking back to an older COMPLETED instance",
                        e)
            continue
        engine_params = EngineParams(
            data_source_params=json.loads(instance.data_source_params),
            preparator_params=json.loads(instance.preparator_params),
            algorithm_params_list=[
                (a["name"], a["params"])
                for a in json.loads(instance.algorithms_params)
            ],
            serving_params=json.loads(instance.serving_params),
        )
        ctx.engine_instance_id = instance.id
        # derive from THIS candidate, not whatever a previously rejected
        # candidate left behind
        if not caller_app_name:
            ctx.app_name = instance.env.get("appName", "")
        try:
            models = load_persistent_models(
                deserialize_models(payload), instance.id, ctx)
        except Exception as e:  # noqa: BLE001 - checksummed yet unloadable
            if instance_id is not None:
                raise
            ctx.app_name = caller_app_name
            model_artifact.count_integrity_failure("deserialize")
            rejected.append(f"{instance.id} (deserialize)")
            if on_reject is not None:
                on_reject(instance.id, "deserialize")
            log.warning(
                "model for engine instance %s verified but failed to "
                "deserialize (%s); walking back to an older COMPLETED "
                "instance", instance.id, e)
            continue
        deployment = engine.prepare_deployment(ctx, engine_params, models)
        if rejected:
            log.warning(
                "deployed %s after skipping %d undeployable instance(s): "
                "%s", instance.id, len(rejected), ", ".join(rejected))
        return deployment, instance, engine_params
    raise RuntimeError(
        "No deployable COMPLETED engine instance: all candidates "
        f"rejected ({', '.join(rejected)}); blobs kept for forensics — "
        "`pio train` to replace")
