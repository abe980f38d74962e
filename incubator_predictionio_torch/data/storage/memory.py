"""In-memory storage backend — the `MEMORY` source type.

The port's own copy of ``incubator_predictionio_tpu/data/storage/memory.py``.
Serves all three repositories (metadata/eventdata/modeldata). Used by unit
tests and as the reference implementation of the DAO contracts.
"""

from __future__ import annotations

import datetime as _dt
import itertools
import threading
from typing import Iterable, Iterator, Optional, Sequence

from . import base
from .event import Event, new_event_id


def event_matches(
    e: Event,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    entity_type: Optional[str] = None,
    entity_id: Optional[str] = None,
    event_names: Optional[Sequence[str]] = None,
    target_entity_type: Optional[str] = None,
    target_entity_id: Optional[str] = None,
) -> bool:
    """Shared filter predicate — mirrors the reference's scan filters
    (reference: HBEventsUtil.createScan / JDBCLEvents where-clauses)."""
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in event_names:
        return False
    if target_entity_type is not None and e.target_entity_type != target_entity_type:
        return False
    if target_entity_id is not None and e.target_entity_id != target_entity_id:
        return False
    return True


class _Table:
    def __init__(self) -> None:
        self.events: dict[str, Event] = {}


class MemoryLEvents(base.LEvents):
    def __init__(self) -> None:
        self._tables: dict[tuple[int, Optional[int]], _Table] = {}
        self._lock = threading.RLock()

    def _table(self, app_id: int, channel_id: Optional[int]) -> _Table:
        key = (app_id, channel_id)
        with self._lock:
            if key not in self._tables:
                self._tables[key] = _Table()
            return self._tables[key]

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._table(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            self._tables.pop((app_id, channel_id), None)
        return True

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        t = self._table(app_id, channel_id)
        eid = event.event_id or new_event_id()
        stored = event.with_event_id(eid)
        with self._lock:
            # Upsert moves the event to the END of its equal-timestamp tie
            # group (cross-backend contract: the JSONL log re-appends,
            # SQLite's REPLACE assigns a new rowid; pop before assign so
            # the dict's insertion order matches).
            t.events.pop(eid, None)
            t.events[eid] = stored
        return eid

    def insert_batch(
        self, events: Sequence[Event], app_id: int,
        channel_id: Optional[int] = None,
    ) -> list[str]:
        """One lock acquisition for the whole batch (the base-class
        default re-locks per event)."""
        t = self._table(app_id, channel_id)
        ids = []
        with self._lock:
            for event in events:
                eid = event.event_id or new_event_id()
                ids.append(eid)
                t.events.pop(eid, None)
                t.events[eid] = event.with_event_id(eid)
        return ids

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        t = self._table(app_id, channel_id)
        with self._lock:
            return t.events.get(event_id)

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        t = self._table(app_id, channel_id)
        with self._lock:
            return t.events.pop(event_id, None) is not None

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed_order: bool = False,
    ) -> Iterator[Event]:
        t = self._table(app_id, channel_id)
        with self._lock:
            events = list(t.events.values())
        events.sort(key=lambda e: e.event_time, reverse=reversed_order)
        it = (
            e
            for e in events
            if event_matches(
                e,
                start_time,
                until_time,
                entity_type,
                entity_id,
                event_names,
                target_entity_type,
                target_entity_id,
            )
        )
        if limit is not None and limit >= 0:
            it = itertools.islice(it, limit)
        yield from it


class MemoryPEvents(base.PEvents):
    def __init__(self, l_events: MemoryLEvents) -> None:
        self._l = l_events

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None) -> Iterator[Event]:
        return self._l.find(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
        )

    def write(self, events: Iterable[Event], app_id: int, channel_id: Optional[int] = None) -> None:
        for e in events:
            self._l.insert(e, app_id, channel_id)

    def delete(self, event_ids: Iterable[str], app_id: int, channel_id: Optional[int] = None) -> None:
        for eid in event_ids:
            self._l.delete(eid, app_id, channel_id)


class MemoryApps(base.Apps):
    def __init__(self) -> None:
        self._by_id: dict[int, base.App] = {}
        self._seq = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, app: base.App) -> Optional[int]:
        with self._lock:
            app_id = app.id if app.id > 0 else next(self._seq)
            while app.id <= 0 and app_id in self._by_id:
                app_id = next(self._seq)
            if app_id in self._by_id or self.get_by_name(app.name):
                return None
            self._by_id[app_id] = base.App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> Optional[base.App]:
        with self._lock:
            return self._by_id.get(app_id)

    def get_by_name(self, name: str) -> Optional[base.App]:
        with self._lock:
            return next((a for a in self._by_id.values() if a.name == name), None)

    def get_all(self) -> list[base.App]:
        with self._lock:
            return sorted(self._by_id.values(), key=lambda a: a.id)

    def update(self, app: base.App) -> None:
        with self._lock:
            self._by_id[app.id] = app

    def delete(self, app_id: int) -> None:
        with self._lock:
            self._by_id.pop(app_id, None)


class MemoryAccessKeys(base.AccessKeys):
    def __init__(self) -> None:
        self._by_key: dict[str, base.AccessKey] = {}
        self._lock = threading.RLock()

    def insert(self, k: base.AccessKey) -> Optional[str]:
        import secrets

        key = k.key or secrets.token_urlsafe(48)
        with self._lock:
            if key in self._by_key:
                return None
            self._by_key[key] = base.AccessKey(key, k.appid, tuple(k.events))
            return key

    def get(self, key: str) -> Optional[base.AccessKey]:
        with self._lock:
            return self._by_key.get(key)

    def get_all(self) -> list[base.AccessKey]:
        with self._lock:
            return list(self._by_key.values())

    def get_by_appid(self, appid: int) -> list[base.AccessKey]:
        with self._lock:
            return [k for k in self._by_key.values() if k.appid == appid]

    def update(self, k: base.AccessKey) -> None:
        with self._lock:
            self._by_key[k.key] = k

    def delete(self, key: str) -> None:
        with self._lock:
            self._by_key.pop(key, None)


class MemoryChannels(base.Channels):
    def __init__(self) -> None:
        self._by_id: dict[int, base.Channel] = {}
        self._seq = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, channel: base.Channel) -> Optional[int]:
        if not base.Channel.is_valid_name(channel.name):
            return None
        with self._lock:
            cid = channel.id if channel.id > 0 else next(self._seq)
            while channel.id <= 0 and cid in self._by_id:
                cid = next(self._seq)
            if cid in self._by_id:
                return None
            self._by_id[cid] = base.Channel(cid, channel.name, channel.appid)
            return cid

    def get(self, channel_id: int) -> Optional[base.Channel]:
        with self._lock:
            return self._by_id.get(channel_id)

    def get_by_appid(self, appid: int) -> list[base.Channel]:
        with self._lock:
            return [c for c in self._by_id.values() if c.appid == appid]

    def delete(self, channel_id: int) -> None:
        with self._lock:
            self._by_id.pop(channel_id, None)


class MemoryEngineInstances(base.EngineInstances):
    def __init__(self) -> None:
        self._by_id: dict[str, base.EngineInstance] = {}
        self._seq = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, i: base.EngineInstance) -> str:
        with self._lock:
            iid = i.id or f"EI-{next(self._seq):08d}"
            stored = base.EngineInstance(
                id=iid, status=i.status, start_time=i.start_time,
                end_time=i.end_time, engine_id=i.engine_id,
                engine_version=i.engine_version, engine_variant=i.engine_variant,
                engine_factory=i.engine_factory, batch=i.batch, env=dict(i.env),
                runtime_conf=dict(i.runtime_conf),
                data_source_params=i.data_source_params,
                preparator_params=i.preparator_params,
                algorithms_params=i.algorithms_params,
                serving_params=i.serving_params,
            )
            self._by_id[iid] = stored
            return iid

    def get(self, instance_id: str) -> Optional[base.EngineInstance]:
        with self._lock:
            return self._by_id.get(instance_id)

    def get_all(self) -> list[base.EngineInstance]:
        with self._lock:
            return list(self._by_id.values())

    def get_completed(self, engine_id, engine_version, engine_variant):
        with self._lock:
            values = list(self._by_id.values())
        out = [
            i
            for i in values
            if i.status == "COMPLETED"
            and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        done = self.get_completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    def update(self, i: base.EngineInstance) -> None:
        with self._lock:
            self._by_id[i.id] = i

    def delete(self, instance_id: str) -> None:
        with self._lock:
            self._by_id.pop(instance_id, None)


class MemoryEvaluationInstances(base.EvaluationInstances):
    def __init__(self) -> None:
        self._by_id: dict[str, base.EvaluationInstance] = {}
        self._seq = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, i: base.EvaluationInstance) -> str:
        with self._lock:
            iid = i.id or f"EVI-{next(self._seq):08d}"
            self._by_id[iid] = base.EvaluationInstance(
                id=iid, status=i.status, start_time=i.start_time,
                end_time=i.end_time, evaluation_class=i.evaluation_class,
                engine_params_generator_class=i.engine_params_generator_class,
                batch=i.batch, env=dict(i.env),
                evaluator_results=i.evaluator_results,
                evaluator_results_html=i.evaluator_results_html,
                evaluator_results_json=i.evaluator_results_json,
            )
            return iid

    def get(self, instance_id: str) -> Optional[base.EvaluationInstance]:
        with self._lock:
            return self._by_id.get(instance_id)

    def get_all(self) -> list[base.EvaluationInstance]:
        with self._lock:
            return list(self._by_id.values())

    def get_completed(self) -> list[base.EvaluationInstance]:
        with self._lock:
            values = list(self._by_id.values())
        out = [i for i in values if i.status == "EVALCOMPLETED"]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out

    def update(self, i: base.EvaluationInstance) -> None:
        with self._lock:
            self._by_id[i.id] = i

    def delete(self, instance_id: str) -> None:
        with self._lock:
            self._by_id.pop(instance_id, None)


class MemoryModels(base.Models):
    def __init__(self) -> None:
        self._by_id: dict[str, base.Model] = {}
        self._lock = threading.RLock()

    def insert(self, model: base.Model) -> None:
        with self._lock:
            self._by_id[model.id] = model

    def get(self, model_id: str) -> Optional[base.Model]:
        with self._lock:
            return self._by_id.get(model_id)

    def exists(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._by_id

    def delete(self, model_id: str) -> None:
        with self._lock:
            self._by_id.pop(model_id, None)


class StorageClient(base.BaseStorageClient):
    """`TYPE=MEMORY` source. DAOs are singletons per (client, namespace) so
    repositories with different _NAMEs are isolated, matching the
    namespace-prefix behaviour of persistent backends."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        self._spaces: dict[tuple[str, str], object] = {}
        self._lock = threading.RLock()

    def _space(self, kind: str, namespace: str, factory):
        key = (kind, namespace)
        with self._lock:
            if key not in self._spaces:
                self._spaces[key] = factory()
            return self._spaces[key]

    def apps(self, namespace: str = "pio_metadata"):
        return self._space("apps", namespace, MemoryApps)

    def access_keys(self, namespace: str = "pio_metadata"):
        return self._space("keys", namespace, MemoryAccessKeys)

    def channels(self, namespace: str = "pio_metadata"):
        return self._space("channels", namespace, MemoryChannels)

    def engine_instances(self, namespace: str = "pio_metadata"):
        return self._space("engine_instances", namespace, MemoryEngineInstances)

    def evaluation_instances(self, namespace: str = "pio_metadata"):
        return self._space("evaluation_instances", namespace, MemoryEvaluationInstances)

    def models(self, namespace: str = "pio_modeldata"):
        return self._space("models", namespace, MemoryModels)

    def l_events(self, namespace: str = "pio_eventdata"):
        return self._space("l_events", namespace, MemoryLEvents)

    def p_events(self, namespace: str = "pio_eventdata"):
        return MemoryPEvents(self.l_events(namespace))
