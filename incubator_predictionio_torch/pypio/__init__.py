"""pypio — the script- and notebook-friendly facade of the port.

Port of ``incubator_predictionio_tpu/pypio/__init__.py`` (reference:
python/pypio, 0.13's PySpark bridge: ``pypio.init()``, ``new_app``,
``find_events`` → DataFrame, the lifecycle verbs driven from Jupyter).
The whole framework is Python here, so the bridge is a thin layer: one
import that wires storage from the environment and exposes the common
verbs as functions returning numpy and columnar data.

:func:`train` runs the training workflow (``workflow.core_workflow.
run_train``) on the card unless ``device="cpu"`` is asked for; importing
this module imports no torch, which loads only when something trains.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
from typing import Optional, Sequence

from ..data.storage.base import AccessKey as _AccessKey
from ..data.storage.base import App as _App
from ..data.storage.registry import Storage
from ..data.store.p_event_store import EventBatch, PEventStore

_storage: Optional[Storage] = None


def init(storage: Optional[Storage] = None) -> Storage:
    """Initialise the bridge (reference: pypio.init_pypio). Idempotent;
    returns the bound Storage."""
    global _storage
    _storage = storage or Storage.instance()
    return _storage


def _require_storage() -> Storage:
    if _storage is None:
        raise RuntimeError("call pypio.init() first")
    return _storage


def new_app(name: str, access_key: str = "",
            description: Optional[str] = None):
    """Create an app and its access key; returns (app_id, access_key)."""
    s = _require_storage()
    apps = s.get_meta_data_apps()
    app_id = apps.insert(_App(0, name, description))
    if app_id is None:
        raise ValueError(f"App {name!r} already exists")
    s.get_l_events().init(app_id)
    key = s.get_meta_data_access_keys().insert(
        _AccessKey(access_key, app_id, ()))
    if key is None:
        apps.delete(app_id)
        raise ValueError(f"Access key {access_key!r} already exists")
    return app_id, key


def delete_app(name: str) -> None:
    s = _require_storage()
    apps = s.get_meta_data_apps()
    app = apps.get_by_name(name)
    if app is None:
        raise ValueError(f"App {name!r} does not exist")
    for k in s.get_meta_data_access_keys().get_by_appid(app.id):
        s.get_meta_data_access_keys().delete(k.key)
    s.get_l_events().remove(app.id)
    apps.delete(app.id)


def import_events(app_name: str, jsonl_path: str) -> int:
    """Bulk-load a JSON-lines export into an app; returns the events
    inserted."""
    s = _require_storage()
    from ..data.storage.event import Event

    app = s.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise ValueError(f"App {app_name!r} does not exist")
    le = s.get_l_events()
    n = 0
    with open(jsonl_path, encoding="utf-8") as f:
        batch = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            batch.append(Event.from_json(json.loads(line)))
            if len(batch) >= 1000:
                le.insert_batch(batch, app.id)
                n += len(batch)
                batch = []
        if batch:
            le.insert_batch(batch, app.id)
            n += len(batch)
    return n


def find_events(
    app_name: str,
    event_names: Optional[Sequence[str]] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
) -> EventBatch:
    """Columnar scan of an app's events (reference: pypio.data.find_events
    returning a DataFrame; here an EventBatch of host columns)."""
    return PEventStore.find_batch(
        app_name, event_names=event_names, storage=_require_storage(),
        start_time=start_time, until_time=until_time,
    )


def find_ratings(app_name: str, event_names: Optional[Sequence[str]] = None,
                 **kwargs):
    """(user_idx, item_idx, rating, user_map, item_map): the COO triple of
    the training workflow's read. ``kwargs`` pass through to
    PEventStore.find_ratings (channel_name, event_default_ratings, ...)."""
    return PEventStore.find_ratings(
        app_name, event_names=event_names, storage=_require_storage(),
        **kwargs)


def train(engine_dir: str, variant: Optional[str] = None,
          device: str = "cuda") -> str:
    """Run the training workflow for a template directory on ``device``
    (the card unless ``"cpu"`` is asked for); returns the engine-instance
    id (reference: `pio train`)."""
    from ..workflow.context import WorkflowContext
    from ..workflow.core_workflow import run_train
    from ..workflow.json_extractor import (
        engine_and_params_from_json, load_engine_json,
    )
    from ..workflow.workflow_params import WorkflowParams

    s = _require_storage()
    engine_json = load_engine_json(os.path.join(engine_dir, "engine.json"),
                                   variant)
    engine, params, factory = engine_and_params_from_json(engine_json,
                                                          engine_dir)
    dsp = dict(params.data_source_params)
    ctx = WorkflowContext(app_name=dsp.get("app_name")
                          or dsp.get("appName", ""),
                          storage=s, device=device)
    return run_train(engine, params, ctx, WorkflowParams(),
                     engine_factory_name=factory,
                     engine_variant=engine_json.get("id", "default"))
