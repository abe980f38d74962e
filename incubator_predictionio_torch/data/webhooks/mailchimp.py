"""MailChimp webhook connector.

Reference: data/.../data/webhooks/mailchimp/MailChimpConnector.scala —
form-encoded webhooks (subscribe/unsubscribe/profile/upemail/cleaned/
campaign) flattened from "data[...]" form keys.
"""

from __future__ import annotations

from typing import Mapping

from ..storage.event import EventValidationError
from .base import FormConnector

_SUPPORTED = {"subscribe", "unsubscribe", "profile", "upemail", "cleaned", "campaign"}


class MailChimpConnector(FormConnector):
    def to_event_json(self, payload: Mapping[str, str]) -> dict:
        event_type = payload.get("type")
        if event_type not in _SUPPORTED:
            raise EventValidationError(
                f"mailchimp event type {event_type!r} is not supported"
            )
        # Flatten "data[a]" → {"a": v} and nest "data[a][b]" → {"a": {"b": v}}.
        data: dict = {}
        for k, v in payload.items():
            if not (k.startswith("data[") and k.endswith("]")):
                continue
            path = k[5:-1].split("][")
            node = data
            for part in path[:-1]:
                nxt = node.get(part)
                if nxt is None:
                    nxt = node[part] = {}
                elif not isinstance(nxt, dict):
                    raise EventValidationError(
                        f"conflicting mailchimp form keys around data[{part}]"
                    )
                node = nxt
            if isinstance(node.get(path[-1]), dict):
                raise EventValidationError(
                    f"conflicting mailchimp form keys around {k}"
                )
            node[path[-1]] = v
        entity_id = data.get("id") or data.get("email")
        if not entity_id:
            raise EventValidationError("mailchimp payload has no data[id]/data[email]")
        event_json = {
            "event": event_type,
            "entityType": "user",
            "entityId": entity_id,
            "properties": data,
        }
        if payload.get("fired_at"):
            # "2009-03-26 21:35:57" → ISO
            event_json["eventTime"] = payload["fired_at"].replace(" ", "T") + "Z"
        return event_json
