"""PEventStore — bulk event reads for training DataSources.

The port's own copy of ``incubator_predictionio_tpu/data/store/
p_event_store.py`` (reference: data/.../data/store/PEventStore.scala,
find/aggregateProperties returning RDDs). Two paths give the (user, item,
rating) COO triple plus id maps that the trainers upload, bit for bit
alike:

- the columnar path, on an event backend with ``scan_columnar`` (the JSONL
  log, ``data/storage/jsonl.py``): the triple is assembled with numpy from
  the codec's interned codes, with no Python object per event;
- the row path (SQLite, memory): a scan is read time-sorted, laid out as
  columns (:class:`EventBatch`) and turned into the triple
  (:func:`ratings_matrix`).

A training read that passes no time range takes the ambient training
window (``pio train --window``, ``PIO_TRAIN_WINDOW``,
``common/train_window.py``); explicit bounds win.
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
        chunks gives :meth:`find_batch`.

        A read that passes no time range fills it from the ambient
        training window; explicit bounds are never overridden."""
        from ...common import train_window

        start, until = train_window.apply_window(
            kwargs.get("start_time"), kwargs.get("until_time"))
        if start is not None or until is not None:
            kwargs = dict(kwargs, start_time=start, until_time=until)
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

        Columnar path: when the event backend exposes ``scan_columnar``
        (the JSONL log decoded by the codec), the triple is assembled with
        numpy on interned codes. Otherwise the row scan +
        :func:`ratings_matrix`.

        ``event_default_ratings`` assigns a rating to events of a given
        name when properties carry none (e.g. the quickstart template's
        implicit "buy" → 4.0). Equal event times keep insertion order (the
        backends' tie rule), so the id maps' first-seen order is the
        reference's.

        When neither ``start_time`` nor ``until_time`` is given the
        ambient training window applies; explicit bounds win.
        """
        from ...common import train_window

        start_time, until_time = train_window.apply_window(
            start_time, until_time)
        s, app_id, channel_id = _resolve_app(app_name, storage, channel_name)
        pe = s.get_p_events()
        if hasattr(pe, "scan_columnar"):
            cols, rows = pe.scan_columnar(
                app_id, channel_id, event_names, start_time, until_time)
            return _columnar_ratings(cols, rows, rating_from_props,
                                     default_rating, event_default_ratings)
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


def _columnar_ratings(cols, rows: np.ndarray, rating_from_props: bool,
                      default_rating: float,
                      event_default_ratings: Optional[dict]):
    """The triple and id maps from the selected rows of a columnar scan,
    equal to :func:`ratings_matrix` over the row path's scan."""
    rows = rows[cols.eid[rows] >= 0]  # malformed records: no entityId
    # The row path iterates events time-sorted (LEvents.find semantics);
    # order the selection the same way (stable: ties keep file order) so
    # BiMap first-seen index assignment matches bit for bit.
    rows = rows[np.argsort(cols.time_us[rows], kind="stable")]
    # users cover ALL scanned events (even target-less ones), items only
    # events with a target; both indexed in first-seen order.
    keep_mask = cols.teid[rows] >= 0
    keep = rows[keep_mask]
    if rating_from_props:
        r = cols.rating[keep].astype(np.float32, copy=True)
        # Codec sentinels: NaN = "rating" key absent (the event default
        # applies, like the row path injecting it into the properties),
        # -inf = key present but not coercible (the row path's
        # _coerce_rating → plain default_rating).
        missing = np.isnan(r)
        unusable = np.isneginf(r)
        if unusable.any():
            r[unusable] = np.float32(default_rating)
        if missing.any():
            fill = np.full(keep.shape, np.float32(default_rating))
            if event_default_ratings:
                ev_table = cols.table(cols.TABLE_EVENT)
                ev = cols.event[keep]
                for name, val in event_default_ratings.items():
                    if name in ev_table:
                        fill = np.where(ev == ev_table.index(name),
                                        np.float32(val), fill)
            r[missing] = fill[missing]
    else:
        r = np.full(keep.shape, default_rating, np.float32)

    def densify(codes: np.ndarray, table: list[str]):
        uniq, first_pos, inv = np.unique(
            codes, return_index=True, return_inverse=True)
        order = np.argsort(first_pos, kind="stable")
        rank = np.empty(order.shape, np.int64)
        rank[order] = np.arange(order.shape[0])
        bimap = BiMap({table[c]: int(k) for k, c in enumerate(uniq[order])})
        return rank[inv], bimap

    u_all, users = densify(cols.eid[rows], cols.table(cols.TABLE_EID))
    u = u_all[keep_mask]
    i, items = densify(cols.teid[keep], cols.table(cols.TABLE_TEID))
    return u.astype(np.int32), i.astype(np.int32), r, users, items


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
