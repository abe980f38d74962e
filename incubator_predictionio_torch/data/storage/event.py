"""Event model: the immutable event record + validation + JSON codec.

The port's own copy of ``incubator_predictionio_tpu/data/storage/event.py``.

Re-design of the reference's event model
(reference: data/.../data/storage/{Event,EventValidation,EventJson4sSupport}.scala).
Wire format is kept byte-compatible with the PredictionIO REST API so existing
SDKs keep working: keys eventId/event/entityType/entityId/targetEntityType/
targetEntityId/properties/eventTime/tags/prId/creationTime, ISO-8601 times.
"""

from __future__ import annotations

import datetime as _dt
import os as _os
from dataclasses import dataclass, field, replace
# Mapping from collections.abc, not typing: isinstance() against the
# typing alias routes through __instancecheck__ proxies (~5 µs/event on
# the ingestion hot path); the abc check is a plain C lookup.
from collections.abc import Mapping
from typing import Any, Optional, Sequence

from .datamap import DataMap


class EventValidationError(ValueError):
    """Invalid event (bad name, reserved prefix, missing fields...)."""


# Reserved "special" events (reference: EventValidation.specialEvents).
SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


import re as _re

#: fractional-seconds normalizer for Python 3.10's fromisoformat, which
#: accepts only exactly 3 or 6 fractional digits. ISO-8601 (and joda,
#: the reference's time parser) allow any count — "12:00:00.5" is a
#: legal wire time, and the reference's native codec parses it — so the fraction
#: is padded/truncated to 6 digits (µs, the storage resolution) before
#: the stdlib parse. Python 3.11+ never reaches the fallback.
_FRACTION_RE = _re.compile(r"(?<=\d)\.(\d+)")


def _normalize_fraction(value: str) -> str:
    return _FRACTION_RE.sub(
        lambda m: "." + m.group(1)[:6].ljust(6, "0"), value, count=1)


def parse_event_time(value: str) -> _dt.datetime:
    """ISO-8601 → aware datetime (reference uses joda DateTime)."""
    iso = value.replace("Z", "+00:00")
    try:
        # Python 3.11+ fromisoformat handles 'Z' and offsets.
        t = _dt.datetime.fromisoformat(iso)
    except ValueError as e:
        try:
            t = _dt.datetime.fromisoformat(_normalize_fraction(iso))
        except ValueError:
            raise EventValidationError(
                f"Invalid eventTime {value!r}: {e}") from e
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return t


def event_time_us(t: _dt.datetime) -> int:
    """Epoch microseconds; naive datetimes read as UTC (the storage
    backends' shared time encoding — sqlite/ES/PG/HBase all sort and
    range-filter on this)."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return int(t.timestamp() * 1_000_000)


class MonotoneNs:
    """Client-side monotone insertion counter (wall-clock ns, bumped past
    the previous value): orders equal-timestamp event ties by insertion,
    survives restarts, and stays best-effort across multiple concurrent
    writer processes (tie order between two SIMULTANEOUS inserts is
    unspecified by the storage contract). Used by backends whose stores
    have no server-side sequence (HBase rowkeys, Postgres seq column)."""

    def __init__(self) -> None:
        import threading
        import time

        self._time_ns = time.time_ns
        self._last = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._last = max(self._last + 1, self._time_ns())
            return self._last

    def prime(self, floor: int) -> None:
        """Raise the counter past an externally-observed maximum (e.g.
        the store's current MAX(seq)) so a wall clock stepped backwards
        between restarts cannot emit sequence numbers below already-
        committed rows."""
        with self._lock:
            self._last = max(self._last, int(floor))


def format_event_time(t: _dt.datetime) -> str:
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    elif t.tzinfo is not _dt.timezone.utc and t.utcoffset():
        t = t.astimezone(_dt.timezone.utc)
    # Millisecond precision, matching joda's ISODateTimeFormat output.
    # Hand-rolled f-string: strftime costs a few µs per call and this sits
    # on the ingestion path twice per event (event_time + creation_time).
    return (f"{t.year:04d}-{t.month:02d}-{t.day:02d}"
            f"T{t.hour:02d}:{t.minute:02d}:{t.second:02d}"
            f".{t.microsecond // 1000:03d}Z")


@dataclass(frozen=True)
class Event:
    """One immutable event (reference: data/.../storage/Event.scala)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=_utcnow)
    tags: Sequence[str] = ()
    pr_id: Optional[str] = None
    event_id: Optional[str] = None
    creation_time: _dt.datetime = field(default_factory=_utcnow)

    def __post_init__(self):
        # Naive datetimes are taken as UTC so every stored event carries a
        # timezone and cross-backend comparisons never mix naive/aware.
        for attr in ("event_time", "creation_time"):
            t = getattr(self, attr)
            if t.tzinfo is None:
                object.__setattr__(self, attr, t.replace(tzinfo=_dt.timezone.utc))

    def with_event_id(self, event_id: str) -> "Event":
        return replace(self, event_id=event_id)

    # -- JSON codec (wire compatible) ------------------------------------
    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "eventId": self.event_id,
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
        }
        if self.target_entity_type is not None:
            out["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            out["targetEntityId"] = self.target_entity_id
        out["properties"] = self.properties.to_dict()
        out["eventTime"] = format_event_time(self.event_time)
        if self.tags:
            out["tags"] = list(self.tags)
        if self.pr_id is not None:
            out["prId"] = self.pr_id
        out["creationTime"] = format_event_time(self.creation_time)
        return out

    @staticmethod
    def from_json(obj: Mapping[str, Any], *, default_time: Optional[_dt.datetime] = None) -> "Event":
        if not isinstance(obj, Mapping):
            raise EventValidationError("event JSON must be an object")
        try:
            name = obj["event"]
            entity_type = obj["entityType"]
            entity_id = obj["entityId"]
        except KeyError as e:
            raise EventValidationError(f"field {e.args[0]} is required") from e
        def _id_ok(v):
            # str or int ids accepted (JSON clients send both); bool is an
            # int subclass but "true" is never a meaningful id.
            return isinstance(v, str) or (isinstance(v, int) and not isinstance(v, bool))

        if not isinstance(name, str):
            raise EventValidationError("event must be a string")
        if not isinstance(entity_type, str):
            raise EventValidationError("entityType must be a string")
        if not _id_ok(entity_id):
            raise EventValidationError("entityId must be a string")
        tet = obj.get("targetEntityType")
        if tet is not None and not isinstance(tet, str):
            raise EventValidationError("targetEntityType must be a string")
        if obj.get("targetEntityId") is not None and not _id_ok(obj["targetEntityId"]):
            raise EventValidationError("targetEntityId must be a string")
        props = obj.get("properties")
        if props is None:
            props = {}
        if not isinstance(props, Mapping):
            raise EventValidationError("properties must be a JSON object")
        tags = obj.get("tags")
        if tags is None:
            tags = ()
        elif not isinstance(tags, (list, tuple)) or not all(
            isinstance(t, str) for t in tags
        ):
            raise EventValidationError("tags must be a list of strings")
        if obj.get("prId") is not None and not isinstance(obj["prId"], str):
            raise EventValidationError("prId must be a string")
        if "eventTime" in obj and obj["eventTime"] is not None:
            if not isinstance(obj["eventTime"], str):
                raise EventValidationError("eventTime must be an ISO-8601 string")
            event_time = parse_event_time(obj["eventTime"])
        else:
            event_time = default_time or _utcnow()
        if obj.get("creationTime") is not None:
            # Honoured on import so export→import round-trips preserve it;
            # the event server strips it from client payloads.
            if not isinstance(obj["creationTime"], str):
                raise EventValidationError("creationTime must be an ISO-8601 string")
            creation_time = parse_event_time(obj["creationTime"])
        else:
            creation_time = _utcnow()
        ev = Event(
            event=name,
            entity_type=entity_type,
            entity_id=str(entity_id),
            target_entity_type=tet,
            target_entity_id=(
                None
                if obj.get("targetEntityId") is None
                else str(obj.get("targetEntityId"))
            ),
            properties=DataMap(props),
            event_time=event_time,
            tags=tuple(tags),
            pr_id=obj.get("prId"),
            event_id=obj.get("eventId"),
            creation_time=creation_time,
        )
        validate_event(ev)
        return ev


def validate_event(e: Event) -> None:
    """Reference: EventValidation.validate — name/entity checks, reserved
    "$" special events, reserved "pio_" prefix."""
    if not e.event:
        raise EventValidationError("event name must not be empty")
    if not e.entity_type:
        raise EventValidationError("entityType must not be empty")
    if not e.entity_id:
        raise EventValidationError("entityId must not be empty")
    if e.target_entity_type is not None and not e.target_entity_type:
        raise EventValidationError("targetEntityType must not be empty string")
    if e.target_entity_id is not None and not e.target_entity_id:
        raise EventValidationError("targetEntityId must not be empty string")
    if (e.target_entity_type is None) != (e.target_entity_id is None):
        raise EventValidationError(
            "targetEntityType and targetEntityId must be specified together"
        )
    if e.event.startswith("$"):
        if e.event not in SPECIAL_EVENTS:
            raise EventValidationError(f"{e.event} is not a supported reserved event")
        # Reference: special events operate on one entity only.
        if e.target_entity_type is not None or e.target_entity_id is not None:
            raise EventValidationError(
                f"{e.event} must not have targetEntity fields"
            )
        if e.event == "$unset" and e.properties.is_empty():
            raise EventValidationError("$unset event requires non-empty properties")
        if e.event == "$delete" and not e.properties.is_empty():
            raise EventValidationError("$delete event must not have properties")
    # Reserved prefix (reference: EventValidation — "pio_" is reserved).
    for bad in (e.entity_type, e.target_entity_type or ""):
        if bad.startswith("pio_"):
            raise EventValidationError("entityType prefix pio_ is reserved")
    for k in e.properties.keyset():
        if k.startswith("pio_"):
            raise EventValidationError("property name prefix pio_ is reserved")


def new_event_id() -> str:
    """Server-assigned event id (reference: backend-generated UUID/rowkey).
    Raw urandom hex, not uuid4(): same 32-hex shape and entropy minus the
    version-bit bookkeeping, and cheaper per event."""
    return _os.urandom(16).hex()
