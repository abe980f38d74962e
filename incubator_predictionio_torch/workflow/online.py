"""Streaming online learning: log-tailing fold-in with a gated publish.

The port's own copy of the single-server mode of
``incubator_predictionio_tpu/workflow/online.py``, with the reference's
marker document, cursor document and ``/status`` keys, so ``pio status`` of
either package reads the other's rows:

1. **Tail** the deployed app's event log through a durable byte cursor
   (``data/api/log_tail.py``: O(new bytes), restart-resumable through a
   reserved Models-DAO row, ``model_artifact.foldin_row_id``).
2. **Fold** the new events into a COPY of the served models through each
   algorithm's ``fold_in`` hook (closed-form per-item then per-user ridge
   against the fixed opposite side for ALS, the warp Gauss-Jordan kernel
   on the card; exact count increments for NB; SGD steps for LR).
3. **Commit** the increment as a new COMPLETED engine instance: the
   checksummed artifact of ``model_artifact.write_model`` with the served
   instance's engine.json, and the provenance marker
   ``runtime_conf["foldin"]`` (``of``, ``events``, ``lsn``, ``bases``,
   ``users``), whose ``bases`` and ``users`` let the serving cache evict
   only the touched users.
4. **Publish through the same gate as a retrain**: the engine server's
   ``_publish_once`` (validate → swap → watch → rollback and pin). In a
   serving fleet only replica 0 runs a runner; it commits the increment
   row and never publishes it: the fleet coordinator finds it as a newer
   COMPLETED instance and stages it through its canary
   (``workflow/fleet.py``), while the other replicas stand by.

Delivery is at-least-once: the cursor commits after the increment's
instance row, so a crash in between re-folds the same events on restart.
While an increment's publication is deferred (fleet canary staging, a
busy gate), the next one chains onto it instead of the served model; a chain through a pinned link
is dropped whole.

Fault points: ``foldin.read`` (before the tail read), ``foldin.apply``
(before the fold), ``foldin.publish`` (after the model blob lands, before
the COMPLETED stamp). Telemetry: ``pio_foldin_events_total``,
``pio_foldin_publishes_total``, ``pio_foldin_rollbacks_total{reason}`` and
the ``pio_foldin_freshness_lag_seconds`` gauge (the engine server's
``/metrics``); the same counts ride ``view()`` and :func:`rollback_counts`,
which ``/status`` reports.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import os
import socket
import threading
import time
from typing import Optional

from ..common import faultinject, telemetry
from ..data.api.log_tail import LogCursor, LogTailer
from ..data.storage.event import new_event_id
from . import model_artifact
from .context import WorkflowContext
from .persist import engine_json_from_bytes

log = logging.getLogger("pio.torch.foldin")

__all__ = ["FoldInRunner", "cursor_docs", "is_foldin_instance",
           "note_rollback", "rollback_counts"]

# Targeted cache invalidation gives up past this many distinct users per
# increment chain: the flush costs one cold query per cached user, and the
# marker row stays bounded.
_USER_FOOTPRINT_CAP = 512
# Chain-ancestry list cap in the marker (a chain this deep means the gate
# has been stuck for hundreds of ticks; a full flush is fine).
_BASES_CAP = 64

_rollback_lock = threading.Lock()
_rollbacks: dict[str, int] = {}


def _touched_users(events) -> Optional[set]:
    """The user entity ids whose model rows this batch folds into, or None
    when the batch's effect cannot be attributed to specific users (any
    non-user-entity event, or more distinct users than the cap): None
    tells the serving cache to flush instead of invalidating narrowly."""
    users: set = set()
    for e in events:  # wire-format dicts (log_tail.TailBatch.events)
        if not isinstance(e, dict):
            return None
        if e.get("entityType") != "user" or not e.get("entityId"):
            return None
        users.add(str(e["entityId"]))
        if len(users) > _USER_FOOTPRINT_CAP:
            return None
    return users


_M_EVENTS = telemetry.registry().counter(
    "pio_foldin_events_total",
    "Events read from the log tail by the online fold-in loop").labels()
_M_PUBLISHES = telemetry.registry().counter(
    "pio_foldin_publishes_total",
    "Fold-in increments committed as new COMPLETED engine "
    "instances").labels()
_M_ROLLBACKS = telemetry.registry().counter(
    "pio_foldin_rollbacks_total",
    "Fold-in increments refused or rolled back through the model "
    "lifecycle (validate = gate refusal, error-rate = post-swap watch "
    "breach, plus any manual/fleet pin reason)", ("reason",))
_M_LAG = telemetry.registry().gauge(
    "pio_foldin_freshness_lag_seconds",
    "Seconds since the fold-in view last caught up with the event log "
    "(grows while the loop is failing or falling behind)").labels()


def is_foldin_instance(instance) -> bool:
    """Whether this engine-instance row was produced by a fold-in
    increment (the provenance marker ``_commit_increment`` writes)."""
    try:
        return bool((instance.runtime_conf or {}).get("foldin"))
    except Exception:  # noqa: BLE001 — classification only
        return False


def note_rollback(reason: str) -> None:
    """Count one fold-in increment refused or rolled back (called by the
    engine server's gate and watch paths when the pinned instance carries
    the fold-in marker)."""
    with _rollback_lock:
        _rollbacks[reason] = _rollbacks.get(reason, 0) + 1
    _M_ROLLBACKS.labels(reason).inc()


def rollback_counts() -> dict[str, int]:
    """Fold-in increments refused or rolled back in this process, by
    reason (the reference's ``pio_foldin_rollbacks_total{reason}``)."""
    with _rollback_lock:
        return dict(_rollbacks)


class FoldInRunner:
    """One app's fold-in producer, driven by the engine server's fold-in
    thread (single-flight: only that thread ticks it, so its state needs
    no lock; the server keeps a snapshot of :meth:`view` for /status)."""

    def __init__(self, storage, engine_factory_name: str,
                 engine_variant: str, interval_ms: float = 0.0,
                 app_name: str = "", device="cuda"):
        self.storage = storage
        self.engine_factory_name = engine_factory_name
        self.engine_variant = engine_variant
        self.interval_ms = float(interval_ms)
        self.device = device
        # ``app_name`` pins a multi-tenant runner to ITS tenant: a served
        # instance of another app is a structural disable, never a silent
        # cross-tenant fold-in
        self.app_name = str(app_name or "")
        self.group = model_artifact.fleet_group(engine_factory_name,
                                                engine_variant)
        self._tailer: Optional[LogTailer] = None
        self._cursor: Optional[LogCursor] = None
        self._app_id: Optional[int] = None
        self._app_name: Optional[str] = None
        self._disabled: Optional[str] = None
        self._caught_up_at: Optional[float] = None
        self._events = 0
        self._publishes = 0
        self._last_instance: Optional[str] = None
        self._last_error: Optional[str] = None
        # the last committed increment while its publication is deferred:
        # (tip_id, ancestor_ids, models, users). ancestor_ids = the served
        # base plus every superseded link
        self._pending: Optional[tuple] = None
        # instance id → its engine.json (an increment carries its base's)
        self._engine_json: dict[str, dict] = {}

    # -- status surface ---------------------------------------------------
    def view(self) -> dict:
        now = time.time()
        lag = (now - self._caught_up_at
               if self._caught_up_at is not None else None)
        return {
            # the raw anchor, so /status recomputes the lag at read time
            "caughtUpAt": self._caught_up_at,
            "pendingInstance": (self._pending[0]
                                if self._pending is not None else None),
            "enabled": self._disabled is None,
            "disabledReason": self._disabled,
            "ms": self.interval_ms,
            "group": self.group,
            "app": self._app_name,
            "appId": self._app_id,
            "cursorBytes": (self._cursor.total()
                            if self._cursor is not None else None),
            "cursorShards": (len(self._cursor.shards)
                             if self._cursor is not None else 0),
            "cursorResets": (self._cursor.resets
                             if self._cursor is not None else 0),
            "events": self._events,
            "publishes": self._publishes,
            "lagSeconds": round(lag, 3) if lag is not None else None,
            "lastInstance": self._last_instance,
            "lastError": self._last_error,
        }

    # -- bootstrap --------------------------------------------------------
    def arm(self, instance) -> bool:
        """Eager arming at server start, before the port opens: with no
        persisted cursor the tailer anchors at the log end, and anchoring
        on the first tick instead would skip the events that land in the
        start → first-tick window. The armed cursor is persisted at once."""
        if not self._arm(instance):
            return False
        try:
            self._persist_cursor(time.time())
        except Exception:  # noqa: BLE001 — the first tick re-persists
            log.warning("fold-in: could not persist the armed cursor; "
                        "the first tick retries", exc_info=True)
        return True

    def _arm(self, instance) -> bool:
        """Resolve the app, the events directory and the persisted cursor
        once (and again whenever the served instance's app changes). False
        = fold-in structurally unavailable here; the reason lands on
        /status instead of a crash-looping tick."""
        le = self.storage.get_l_events()
        events_dir = getattr(le, "events_dir", None)
        if not events_dir:
            self._disabled = ("event store is not a JSONL event log "
                              "(fold-in tails log files; TYPE=JSONL)")
            return False
        app_name = model_artifact.instance_app_name(instance)
        if not app_name:
            self._disabled = ("deployed instance names no app "
                              "(env.appName / data-source appName)")
            return False
        if self.app_name and app_name != self.app_name:
            self._disabled = (
                f"served instance binds to app {app_name!r}, not this "
                f"runner's tenant {self.app_name!r}")
            return False
        app = self.storage.get_meta_data_apps().get_by_name(app_name)
        if app is None:
            self._disabled = f"app {app_name!r} is not registered"
            return False
        if self._app_id == app.id and self._tailer is not None:
            return True
        self._app_id, self._app_name = app.id, app_name
        self._tailer = LogTailer(events_dir, app.id)
        self._cursor = None
        doc = model_artifact.read_fleet_doc(
            self.storage, model_artifact.foldin_row_id(self.group, app.id))
        if doc is not None:
            try:
                self._cursor = LogCursor.from_json(doc.get("cursor"))
                log.info("fold-in resuming app %r at LSN %d (%d shard(s))",
                         app_name, self._cursor.total(),
                         len(self._cursor.shards))
            except (TypeError, ValueError):
                log.warning("fold-in cursor record for app %r is damaged; "
                            "re-arming at the log end", app_name,
                            exc_info=True)
        if self._cursor is None:
            # first arm: the deployed model was trained on everything
            # already in the log; only future events are news
            self._cursor = self._tailer.end_cursor()
            log.info("fold-in armed for app %r at the current log end "
                     "(LSN %d)", app_name, self._cursor.total())
        self._disabled = None
        return True

    @staticmethod
    def _ds_params(instance) -> dict:
        try:
            doc = json.loads(instance.data_source_params or "{}")
            return doc if isinstance(doc, dict) else {}
        except ValueError:
            return {}

    def _persist_cursor(self, now: float) -> None:
        model_artifact.write_fleet_doc(
            self.storage,
            model_artifact.foldin_row_id(self.group, self._app_id),
            {
                "cursor": self._cursor.to_json(),
                "group": self.group,
                "appId": self._app_id,
                "app": self._app_name,
                "intervalMs": self.interval_ms,
                "updatedAt": now,
                "caughtUpAt": self._caught_up_at,
                "events": self._events,
                "publishes": self._publishes,
                "pid": os.getpid(),
            })

    def _chain_base(self, instance, pinned) -> Optional[list]:
        """The models the NEXT increment folds into while the last one
        still awaits publication, else None (fold into the served
        deployment):

        - served == the last increment → published; the chain is done
        - a chain link pinned (gate refusal, watch rollback) → the chain
          carried poison; drop it and fold into the served last-good
        - served is still an ancestor → publication deferred (busy gate);
          keep chaining so the earlier batches are not lost
        - served moved elsewhere (operator reload, a racing retrain) →
          the chain's base is stale; drop it with a warning
        """
        pend = self._pending
        if pend is None:
            return None
        pend_id, ancestors, models, _users = pend
        if instance.id == pend_id:
            self._pending = None
            return None
        if pend_id in pinned or any(a in pinned for a in ancestors):
            log.warning("fold-in: increment chain through %s carried a "
                        "pinned link; dropping it and folding into the "
                        "served last-good", pend_id)
            self._pending = None
            return None
        if instance.id in ancestors:
            return models
        log.warning("fold-in: served instance moved to %s while increment "
                    "%s awaited publication; resetting the chain onto the "
                    "new deployment", instance.id, pend_id)
        self._pending = None
        return None

    # -- one tick ---------------------------------------------------------
    def run_once(self, deployment, instance, pinned=()) -> dict:
        """One tick on the fold-in thread: read → fold → commit → persist
        the cursor. Returns the /status view, with ``"instance"`` set when
        an increment was committed (the caller publishes it). ``pinned`` is
        the server's pin set: how the chain learns its last increment was
        refused or rolled back. Raises on injected and storage faults: the
        loop logs and retries next tick, and the lag keeps growing."""
        try:
            if not self._arm(instance):
                return self.view()
            faultinject.fault_point("foldin.read")
            batch = self._tailer.read_since(self._cursor)
            produced = None
            if batch.events:
                faultinject.fault_point("foldin.apply")
                produced = self._fold_and_commit(deployment, instance,
                                                 batch, set(pinned))
            else:
                # no new events: still resolve the chain so a published or
                # pinned increment is observed promptly
                self._chain_base(instance, set(pinned))
            now = time.time()
            # count events once the cursor commits past them: a tick that
            # faults re-reads the same batch next tick
            self._events += len(batch.events)
            _M_EVENTS.inc(len(batch.events))
            self._cursor = batch.cursor
            self._caught_up_at = now
            _M_LAG.set(0.0)
            self._persist_cursor(now)
            self._last_error = None
            out = self.view()
            if produced:
                out["instance"] = produced
            return out
        except Exception as e:
            self._last_error = str(e)
            if self._caught_up_at is not None:
                _M_LAG.set(time.time() - self._caught_up_at)
            raise

    def _fold_and_commit(self, deployment, instance, batch,
                         pinned) -> Optional[str]:
        ds_params = self._ds_params(instance)
        ctx = WorkflowContext(app_name=self._app_name or "",
                              storage=self.storage, device=self.device)
        ctx.engine_instance_id = instance.id
        chain = self._chain_base(instance, pinned)
        if chain is not None:
            base_models = chain
            base_id = self._pending[0]
            ancestors = self._pending[1] | {self._pending[0]}
            prev_users = self._pending[3]
        else:
            base_models = deployment.models
            base_id = instance.id
            ancestors = {instance.id}
            prev_users: Optional[set] = set()
        new_models, changed = [], False
        for (_name, algo), model in zip(deployment.algo_list, base_models):
            out = algo.fold_in(model, batch.events, ctx,
                               data_source_params=ds_params)
            new_models.append(model if out is None else out)
            changed = changed or out is not None
        if not changed:
            return None
        # the freshness footprint is cumulative over a deferral chain: the
        # increment that publishes carries every user any link re-solved,
        # or None once any link was unattributable
        batch_users = _touched_users(batch.events)
        users = (None if batch_users is None or prev_users is None
                 else prev_users | batch_users)
        if users is not None and len(users) > _USER_FOOTPRINT_CAP:
            users = None
        iid = self._commit_increment(instance, deployment.algo_list,
                                     new_models, len(batch.events),
                                     batch.cursor, ancestors, users)
        doc = self._engine_json_for(instance)
        self._engine_json = {instance.id: doc, iid: doc}
        self._pending = (iid, ancestors, new_models, users)
        self._publishes += 1
        self._last_instance = iid
        _M_PUBLISHES.inc()
        log.info("fold-in: %d event(s) folded into %s -> new instance %s "
                 "(LSN %d)", len(batch.events), base_id, iid,
                 batch.cursor.total())
        return iid

    def _engine_json_for(self, instance) -> dict:
        """The served instance's engine.json (read once from its artifact),
        so an increment loads exactly like a retrain of the same engine."""
        doc = self._engine_json.get(instance.id)
        if doc is None:
            doc = engine_json_from_bytes(
                model_artifact.read_model(self.storage, instance.id))
            self._engine_json = {instance.id: doc}
        return doc

    def _commit_increment(self, instance, algo_list, models,
                          n_events: int, cursor: LogCursor,
                          ancestors: set, users: Optional[set]) -> str:
        """Persist one increment exactly like a retrain: instance row
        RUNNING → model artifact → ``foldin.publish`` fault point →
        COMPLETED stamp. A crash before the stamp leaves a RUNNING row no
        loader serves, and the cursor (committed only after this returns)
        re-folds the same events on restart."""
        from .core_workflow import serialize_models

        engine_json = self._engine_json_for(instance)
        instances = self.storage.get_meta_data_engine_instances()
        now = _dt.datetime.now(_dt.timezone.utc)
        marker = {"of": instance.id, "events": n_events,
                  "lsn": cursor.total()}
        if len(ancestors) <= _BASES_CAP:
            # no bases ⇒ the serving cache cannot prove the swap is a pure
            # fold-in of what it serves ⇒ full flush (safe)
            marker["bases"] = sorted(ancestors)
        if users is not None:
            marker["users"] = sorted(users)
        row = dataclasses.replace(
            instance,
            id=new_event_id(),
            status="RUNNING",
            start_time=now,
            end_time=None,
            runtime_conf={**(instance.runtime_conf or {}),
                          "foldin": json.dumps(marker)},
            env={**(instance.env or {}), "pid": str(os.getpid()),
                 "host": socket.gethostname()},
        )
        instances.insert(row)
        blob = serialize_models(algo_list, models, engine_json)
        model_artifact.write_model(self.storage, row.id, blob)
        faultinject.fault_point("foldin.publish")
        instances.update(row.with_status(
            "COMPLETED", _dt.datetime.now(_dt.timezone.utc)))
        return row.id


def cursor_docs(storage) -> list[dict]:
    """Every persisted fold-in cursor record, for ``pio status``: probe the
    (fleet group × registered app) combinations the metadata knows (the
    DAO has no row scan, and these ids are deterministic). [] when a
    repository is unreachable: a health surface must not crash."""
    out: list[dict] = []
    try:
        instances = storage.get_meta_data_engine_instances().get_all()
        groups = {model_artifact.fleet_group(
            i.engine_factory or i.engine_id, i.engine_variant)
            for i in instances}
        apps = storage.get_meta_data_apps().get_all()
    except Exception:  # noqa: BLE001 — diagnostics only
        return out
    for group in sorted(groups):
        for app in apps:
            doc = model_artifact.read_fleet_doc(
                storage, model_artifact.foldin_row_id(group, app.id))
            if doc is not None:
                out.append({**doc, "app": doc.get("app") or app.name})
    return out
