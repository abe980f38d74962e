"""PEventStore — bulk event reads for training DataSources.

The port's own copy of the row path of ``incubator_predictionio_tpu/data/
store/p_event_store.py`` (reference: data/.../data/store/PEventStore.scala,
find/aggregateProperties returning RDDs). A scan is read time-sorted from
the event backend, laid out as columns (:class:`EventBatch`) and turned
into the (user, item, rating) COO triple plus id maps that the trainers
upload (:func:`ratings_matrix`).

The reference's columnar fast path over the JSONL log and its training
window are not ported yet (ROADMAP.md Queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Iterator, Optional, Sequence

import numpy as np

from ..bimap import BiMap
from ..storage.datamap import PropertyMap
from ..storage.event import Event
from ..storage.registry import Storage


@dataclasses.dataclass
class EventBatch:
    """Columnar view of an event scan (host side)."""

    event: list[str]
    entity_type: list[str]
    entity_id: list[str]
    target_entity_id: list[Optional[str]]
    properties: list[dict]
    event_time_us: np.ndarray  # int64 epoch micros

    def __len__(self) -> int:
        return len(self.event)


_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _resolve_app(app_name: str, storage: Optional[Storage] = None,
                 channel_name: Optional[str] = None):
    """app name (+channel name) → ids (reference: Common.appNameToId)."""
    s = storage or Storage.instance()
    app = s.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise ValueError(f"App {app_name!r} does not exist; create it with `pio app new`")
    channel_id = None
    if channel_name:
        chans = [c for c in s.get_meta_data_channels().get_by_appid(app.id)
                 if c.name == channel_name]
        if not chans:
            raise ValueError(f"Channel {channel_name!r} not found for app {app_name!r}")
        channel_id = chans[0].id
    return s, app.id, channel_id


class PEventStore:
    """Static facade mirroring the reference object's API."""

    @staticmethod
    def find(
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        storage: Optional[Storage] = None,
    ) -> Iterator[Event]:
        s, app_id, channel_id = _resolve_app(app_name, storage, channel_name)
        return s.get_p_events().find(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
        )

    @staticmethod
    def find_batches(
        app_name: str,
        event_names: Optional[Sequence[str]] = None,
        storage: Optional[Storage] = None,
        chunk_size: int = 65536,
        **kwargs,
    ) -> Iterator[EventBatch]:
        """Chunked columnar scan: EventBatch slices of at most
        ``chunk_size`` events in scan (event-time) order; concatenating the
        chunks gives :meth:`find_batch`."""
        events = PEventStore.find(
            app_name, event_names=event_names, storage=storage, **kwargs
        )
        step = max(1, int(chunk_size))
        ev, et, eid, tid, props, times = [], [], [], [], [], []

        def flush() -> EventBatch:
            return EventBatch(
                event=ev, entity_type=et, entity_id=eid,
                target_entity_id=tid, properties=props,
                event_time_us=np.asarray(times, dtype=np.int64),
            )

        for e in events:
            ev.append(e.event)
            et.append(e.entity_type)
            eid.append(e.entity_id)
            tid.append(e.target_entity_id)
            props.append(e.properties.to_dict())
            times.append(
                int((e.event_time - _EPOCH).total_seconds() * 1_000_000)
            )
            if len(ev) >= step:
                yield flush()
                ev, et, eid, tid, props, times = [], [], [], [], [], []
        if ev:
            yield flush()

    @staticmethod
    def find_batch(
        app_name: str,
        event_names: Optional[Sequence[str]] = None,
        storage: Optional[Storage] = None,
        **kwargs,
    ) -> EventBatch:
        """Columnar scan (the hot path for DataSources) — the
        concatenation of find_batches."""
        ev, et, eid, tid, props = [], [], [], [], []
        times: list[np.ndarray] = []
        for b in PEventStore.find_batches(
                app_name, event_names=event_names, storage=storage, **kwargs):
            ev += b.event
            et += b.entity_type
            eid += b.entity_id
            tid += b.target_entity_id
            props += b.properties
            times.append(b.event_time_us)
        return EventBatch(
            event=ev, entity_type=et, entity_id=eid, target_entity_id=tid,
            properties=props,
            event_time_us=(np.concatenate(times) if times
                           else np.asarray([], dtype=np.int64)),
        )

    @staticmethod
    def find_ratings(
        app_name: str,
        event_names: Optional[Sequence[str]] = None,
        rating_from_props: bool = True,
        default_rating: float = 1.0,
        event_default_ratings: Optional[dict] = None,
        storage: Optional[Storage] = None,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, BiMap, BiMap]:
        """(user, item, rating) COO triple + id maps — the shared prep for
        every recommendation-family template.

        ``event_default_ratings`` assigns a rating to events of a given
        name when properties carry none (e.g. the quickstart template's
        implicit "buy" → 4.0). Equal event times keep insertion order (the
        backends' tie rule), so the id maps' first-seen order is the
        reference's.
        """
        batch = PEventStore.find_batch(
            app_name, event_names=event_names, storage=storage,
            channel_name=channel_name, start_time=start_time,
            until_time=until_time,
        )
        if rating_from_props and event_default_ratings:
            for j, ev in enumerate(batch.event):
                dflt = event_default_ratings.get(ev)
                if dflt is not None and "rating" not in batch.properties[j]:
                    batch.properties[j] = {**batch.properties[j], "rating": dflt}
        return ratings_matrix(
            batch, rating_from_props=rating_from_props,
            default_rating=default_rating,
        )

    @staticmethod
    def aggregate_properties(
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
        storage: Optional[Storage] = None,
    ) -> dict[str, PropertyMap]:
        s, app_id, channel_id = _resolve_app(app_name, storage, channel_name)
        return s.get_p_events().aggregate_properties(
            app_id, entity_type, channel_id, start_time, until_time, required
        )


def _coerce_rating(v, default_rating: float) -> float:
    """bool/None, strings outside the common float()/strtod charset (hex,
    inf, nan, "1_0"), and values non-finite after the float32 cast all
    count as "present but unusable" (the reference's rule)."""
    if isinstance(v, bool) or v is None:
        return default_rating
    if isinstance(v, str) and set(v) - set("0123456789.+-eE \t\r\n"):
        return default_rating
    try:
        f = np.float32(float(v))
    except (TypeError, ValueError, OverflowError):
        return default_rating
    return float(f) if np.isfinite(f) else default_rating


def ratings_matrix(
    batch: EventBatch,
    rating_from_props: bool = True,
    default_rating: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, BiMap, BiMap]:
    """(user, item, rating) COO triple + id maps from a columnar batch:
    users over ALL events of the batch and items over the events with a
    target, both indexed in first-seen order; target-less events drop out
    of the triple."""
    users = BiMap.string_int(batch.entity_id)
    items = BiMap.string_int(t for t in batch.target_entity_id if t is not None)
    u = users.map_array(batch.entity_id)
    i = np.fromiter(
        (items(t) if t is not None else -1 for t in batch.target_entity_id),
        dtype=np.int32,
        count=len(batch),
    )
    if rating_from_props:
        r = np.fromiter(
            (_coerce_rating(p.get("rating", default_rating), default_rating)
             for p in batch.properties),
            dtype=np.float32,
            count=len(batch),
        )
    else:
        r = np.full(len(batch), default_rating, dtype=np.float32)
    keep = i >= 0
    return u[keep], i[keep], r[keep], users, items
