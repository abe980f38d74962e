"""Events in the wire format → the (user, item, rating) COO triple.

Port of the row path of ``PEventStore.find_ratings``
(``incubator_predictionio_tpu/data/store/p_event_store.py:161`` and
``ratings_matrix``). Events are dicts in the event server's wire format, one
JSON object per line in a ``pio import`` file::

    {"event": "rate", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": "i9",
     "properties": {"rating": 4.5}, "eventTime": "2024-01-01T00:00:00.000Z"}

The rules are the reference's: events are read time-sorted (stable, so
equal times keep file order); users are indexed over ALL selected events
and items only over events with a target, both in first-seen order; the
rating is the ``rating`` property, or the per-event default
(``event_default_ratings``, e.g. ``buy`` → 4.0) when the property is
absent, or ``default_rating`` when it is present but not a finite number.
This is the file form's read (``train --events``); the event store's is
``data/store/p_event_store.py``, which gives the same triple.
"""

from __future__ import annotations

import datetime as _dt
import json
from pathlib import Path
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from .bimap import BiMap
from .store.p_event_store import EventBatch, ratings_matrix

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def read_events(path: "str | Path") -> list[dict]:
    """Read a JSON-lines events file (blank lines skipped)."""
    events = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: invalid JSON: {e}") from e
            if not isinstance(obj, dict):
                raise ValueError(f"{path}:{lineno}: an event must be a JSON object")
            events.append(obj)
    return events


def event_time_us(value: Optional[str]) -> float:
    """ISO-8601 eventTime → epoch microseconds (naive times are UTC). An
    event without a time sorts after every timed event."""
    if value is None:
        return float("inf")
    t = _dt.datetime.fromisoformat(value.replace("Z", "+00:00"))
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return (t - _EPOCH) // _dt.timedelta(microseconds=1)


def _id(v) -> Optional[str]:
    return None if v is None else str(v)


def find_ratings(
    events: Iterable[Mapping],
    event_names: Optional[Sequence[str]] = None,
    rating_from_props: bool = True,
    default_rating: float = 1.0,
    event_default_ratings: Optional[Mapping[str, float]] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, BiMap, BiMap]:
    """(user, item, rating) COO triple + id maps from wire-format events:
    the selected events, time-sorted, laid out as the event store's
    columns and turned into the triple by the store read's own
    ``ratings_matrix``."""
    names = None if event_names is None else set(event_names)
    sel = [e for e in events if names is None or e.get("event") in names]
    times = [event_time_us(e.get("eventTime")) for e in sel]
    order = sorted(range(len(sel)), key=times.__getitem__)  # stable
    sel = [sel[j] for j in order]
    defaults = (event_default_ratings or {}) if rating_from_props else {}
    props = []
    for e in sel:
        p = e.get("properties") or {}
        dflt = defaults.get(e.get("event"))
        if dflt is not None and "rating" not in p:
            p = {**p, "rating": dflt}
        props.append(p)
    batch = EventBatch(
        event=[e.get("event") for e in sel],
        entity_type=[e.get("entityType") for e in sel],
        entity_id=[_id(e["entityId"]) for e in sel],
        target_entity_id=[_id(e.get("targetEntityId")) for e in sel],
        properties=props,
        event_time_us=np.asarray([times[j] for j in order], np.float64))
    return ratings_matrix(batch, rating_from_props=rating_from_props,
                          default_rating=default_rating)


def aggregate_properties(events: Iterable[Mapping], entity_type: str,
                         required: Optional[Sequence[str]] = None
                         ) -> dict[str, dict]:
    """Entity id → properties, replayed from the ``$set`` / ``$unset`` /
    ``$delete`` events of ``entity_type`` in event-time order (the
    reference's ``aggregate_property_events``, data/storage/base.py:311):
    ``$set`` merges its properties in, ``$unset`` drops the keys it
    names from an entity that exists, ``$delete`` forgets the entity.
    ``required``: keep only entities that hold every one of these keys."""
    sel = [e for e in events
           if e.get("entityType") == entity_type
           and e.get("event") in ("$set", "$unset", "$delete")]
    sel.sort(key=lambda e: event_time_us(e.get("eventTime")))  # stable
    state: dict[str, dict] = {}
    for e in sel:
        eid = _id(e["entityId"])
        props = e.get("properties") or {}
        if e["event"] == "$set":
            state.setdefault(eid, {}).update(props)
        elif e["event"] == "$unset":
            if eid in state:
                for key in props:
                    state[eid].pop(key, None)
        else:
            state.pop(eid, None)
    if required:
        req = set(required)
        state = {k: v for k, v in state.items() if req.issubset(v)}
    return state
