"""Storage abstraction: DAO interfaces + metadata record types.

The port's own copy of ``incubator_predictionio_tpu/data/storage/base.py``.
Re-design of the reference storage traits (reference:
data/.../data/storage/{LEvents,PEvents,Apps,AccessKeys,Channels,
EngineInstances,EvaluationInstances,Models}.scala). The reference returns
Scala Futures from LEvents; here the host side is synchronous Python (the
event server wraps calls in a thread executor), which keeps backends trivial
to implement while preserving semantics.
"""

from __future__ import annotations

import abc
import datetime as _dt
from dataclasses import dataclass, field, replace
from typing import Any, Iterable, Iterator, Optional, Sequence

from .datamap import PropertyMap
from .event import Event


# ---------------------------------------------------------------------------
# Metadata record types (reference: case classes of the same names)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class App:
    id: int
    name: str
    description: Optional[str] = None


@dataclass(frozen=True)
class AccessKey:
    key: str
    appid: int
    events: Sequence[str] = ()  # empty = all events allowed


def new_access_key() -> str:
    """A fresh random access key that never starts with ``-``: such a key
    reads as an option on the ``pio accesskey`` command line (one
    ``secrets.token_urlsafe`` key in 64 does)."""
    import secrets

    while True:
        key = secrets.token_urlsafe(48)
        if not key.startswith("-"):
            return key


@dataclass(frozen=True)
class Channel:
    id: int
    name: str
    appid: int

    @staticmethod
    def is_valid_name(s: str) -> bool:
        # Reference: Channel.nameConstraint — alphanumeric + - _
        return bool(s) and all(c.isalnum() or c in "-_" for c in s)


@dataclass(frozen=True)
class EngineInstance:
    """One train run (reference: data/.../storage/EngineInstances.scala)."""

    id: str
    status: str  # INIT | RUNNING | COMPLETED | ABORTED
    start_time: _dt.datetime
    end_time: Optional[_dt.datetime]
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    runtime_conf: dict[str, str] = field(default_factory=dict)
    data_source_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"

    def with_status(self, status: str, end_time: Optional[_dt.datetime] = None):
        return replace(self, status=status, end_time=end_time or self.end_time)


@dataclass(frozen=True)
class EvaluationInstance:
    """One eval run (reference: data/.../storage/EvaluationInstances.scala)."""

    id: str
    status: str
    start_time: _dt.datetime
    end_time: Optional[_dt.datetime]
    evaluation_class: str
    engine_params_generator_class: str
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclass(frozen=True)
class Model:
    """Serialized model blob keyed by engine-instance id
    (reference: data/.../storage/Models.scala)."""

    id: str
    models: bytes


# ---------------------------------------------------------------------------
# DAO interfaces
# ---------------------------------------------------------------------------


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]: ...

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> None: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> None: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, k: AccessKey) -> Optional[str]: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, k: AccessKey) -> None: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]: ...

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> None: ...


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, i: EngineInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, i: EvaluationInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    def exists(self, model_id: str) -> bool:
        """Row-existence probe. The default round-trips the whole blob;
        backends with a cheap metadata check override it (GC over a
        store of multi-GB artifacts must not read every one to decide
        which few to delete)."""
        return self.get(model_id) is not None

    @abc.abstractmethod
    def delete(self, model_id: str) -> None: ...


# ---------------------------------------------------------------------------
# Event DAOs
# ---------------------------------------------------------------------------


class LEvents(abc.ABC):
    """Single-event CRUD + queries (reference: data/.../storage/LEvents.scala).

    Synchronous; server layers add concurrency. channel_id None = default
    channel, matching the reference.
    """

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Create the backing table/namespace for an app/channel."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Drop all events of an app/channel."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        """Insert, returning the event id (client id honoured for dedupe)."""

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> list[str]:
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool: ...

    def delete_batch(
        self, event_ids: Sequence[str], app_id: int,
        channel_id: Optional[int] = None,
    ) -> list[bool]:
        """Bulk delete; backends with a cheaper-than-per-event path (the
        JSONL log's one-refresh-one-append) override this default loop."""
        return [self.delete(eid, app_id, channel_id) for eid in event_ids]

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[Optional[str]] = None,
        target_entity_id: Optional[Optional[str]] = None,
        limit: Optional[int] = None,
        reversed_order: bool = False,
    ) -> Iterator[Event]:
        """Time-ordered scan with the reference's filter set. A limit of
        None or -1 means unlimited; ``reversed_order`` requires entity
        filters upstream — here it is always honoured."""

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> dict[str, PropertyMap]:
        """Replay $set/$unset/$delete per entity into PropertyMaps
        (reference: LEventAggregator.aggregateProperties)."""
        events = self.find(
            app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=["$set", "$unset", "$delete"],
        )
        return aggregate_property_events(events, required=required)


def aggregate_property_events(
    events: Iterable[Event], required: Optional[Sequence[str]] = None
) -> dict[str, PropertyMap]:
    """Shared $set/$unset/$delete replay (reference: LEventAggregator)."""
    state: dict[str, tuple[dict, _dt.datetime, _dt.datetime]] = {}
    for e in sorted(events, key=lambda ev: ev.event_time):
        eid = e.entity_id
        if e.event == "$set":
            if eid in state:
                props, first, _ = state[eid]
                props.update(e.properties.to_dict())
                state[eid] = (props, first, e.event_time)
            else:
                state[eid] = (e.properties.to_dict(), e.event_time, e.event_time)
        elif e.event == "$unset":
            if eid in state:
                props, first, _ = state[eid]
                for k in e.properties.keyset():
                    props.pop(k, None)
                state[eid] = (props, first, e.event_time)
        elif e.event == "$delete":
            state.pop(eid, None)
    out = {
        eid: PropertyMap(props, first, last)
        for eid, (props, first, last) in state.items()
    }
    if required:
        req = set(required)
        out = {k: v for k, v in out.items() if req.issubset(v.keyset())}
    return out


class PEvents(abc.ABC):
    """Bulk event reads for training (reference: data/.../storage/PEvents.scala).

    The reference returns Spark RDD[Event]; here the scan yields Events
    and data/store/p_event_store.py turns them into the arrays a trainer
    uploads. Backends only need the raw scan.
    """

    @abc.abstractmethod
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
    ) -> Iterator[Event]: ...

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> dict[str, PropertyMap]:
        events = self.find(
            app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=["$set", "$unset", "$delete"],
        )
        return aggregate_property_events(events, required=required)

    @abc.abstractmethod
    def write(self, events: Iterable[Event], app_id: int, channel_id: Optional[int] = None) -> None: ...

    @abc.abstractmethod
    def delete(self, event_ids: Iterable[str], app_id: int, channel_id: Optional[int] = None) -> None: ...


# ---------------------------------------------------------------------------
# Backend client contract
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StorageClientConfig:
    """Reference: StorageClientConfig — parsed PIO_STORAGE_SOURCES_* env."""

    parallel: bool = False
    test: bool = False
    properties: dict[str, str] = field(default_factory=dict)


class BaseStorageClient(abc.ABC):
    """One configured storage source; hands out typed DAOs.

    Reference: BaseStorageClient + per-backend StorageClient classes. A
    backend may support any subset of {metadata, eventdata, modeldata};
    unsupported accessors raise NotImplementedError. ``namespace`` is the
    repository _NAME (reference: the table/keyspace prefix passed to every
    DataObject constructor by Storage.getDataObject) — two configs with
    different names must not collide in the same physical store.
    """

    def __init__(self, config: StorageClientConfig):
        self.config = config

    def apps(self, namespace: str = "pio_metadata") -> Apps:
        raise NotImplementedError(f"{type(self).__name__} does not serve metadata")

    def access_keys(self, namespace: str = "pio_metadata") -> AccessKeys:
        raise NotImplementedError(f"{type(self).__name__} does not serve metadata")

    def channels(self, namespace: str = "pio_metadata") -> Channels:
        raise NotImplementedError(f"{type(self).__name__} does not serve metadata")

    def engine_instances(self, namespace: str = "pio_metadata") -> EngineInstances:
        raise NotImplementedError(f"{type(self).__name__} does not serve metadata")

    def evaluation_instances(self, namespace: str = "pio_metadata") -> EvaluationInstances:
        raise NotImplementedError(f"{type(self).__name__} does not serve metadata")

    def models(self, namespace: str = "pio_modeldata") -> Models:
        raise NotImplementedError(f"{type(self).__name__} does not serve modeldata")

    def l_events(self, namespace: str = "pio_eventdata") -> LEvents:
        raise NotImplementedError(f"{type(self).__name__} does not serve eventdata")

    def p_events(self, namespace: str = "pio_eventdata") -> PEvents:
        raise NotImplementedError(f"{type(self).__name__} does not serve eventdata")

    def close(self) -> None:
        pass
