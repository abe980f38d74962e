"""Segment.io webhook connector.

Reference: data/.../data/webhooks/segmentio/SegmentIOConnector.scala —
maps Segment spec v2 messages (identify/track/page/screen/group/alias)
onto events named "$identify"-style, entityType "user".
"""

from __future__ import annotations

from typing import Any, Mapping

from ..storage.event import EventValidationError
from .base import JsonConnector

_SUPPORTED = {"identify", "track", "page", "screen", "group", "alias"}


class SegmentIOConnector(JsonConnector):
    def to_event_json(self, payload: Mapping[str, Any]) -> dict:
        msg_type = payload.get("type")
        if msg_type not in _SUPPORTED:
            raise EventValidationError(
                f"segmentio message type {msg_type!r} is not supported"
            )
        user_id = payload.get("userId") or payload.get("anonymousId")
        if not user_id:
            raise EventValidationError("segmentio message has no userId/anonymousId")
        properties: dict[str, Any] = {}
        for k in ("properties", "traits", "context"):
            v = payload.get(k)
            if isinstance(v, Mapping) and v:
                properties[k] = dict(v)
        if msg_type == "track" and payload.get("event"):
            properties["event"] = payload["event"]
        event_json = {
            "event": msg_type,
            "entityType": "user",
            "entityId": str(user_id),
            "properties": properties,
        }
        if payload.get("timestamp"):
            event_json["eventTime"] = payload["timestamp"]
        return event_json
