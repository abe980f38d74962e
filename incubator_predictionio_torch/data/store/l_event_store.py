"""LEventStore — serve-time blocking reads of recent entity events.

The port's own copy of ``incubator_predictionio_tpu/data/store/
l_event_store.py``. Reference: data/.../data/store/LEventStore.scala —
used inside predict() for serve-time context (e.g. the e-commerce template
filters recently-seen items). Latency budget is the query hot path's, so
calls take explicit limits and time windows.
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional, Sequence

from ..storage.event import Event
from ..storage.registry import Storage
from .p_event_store import _resolve_app


class LEventStore:
    @staticmethod
    def find_by_entity(
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        limit: Optional[int] = None,
        latest: bool = True,
        time_window: Optional[_dt.timedelta] = None,
        storage: Optional[Storage] = None,
    ) -> list[Event]:
        s, app_id, channel_id = _resolve_app(app_name, storage, channel_name)
        start_time = None
        if time_window is not None:
            start_time = _dt.datetime.now(_dt.timezone.utc) - time_window
        return list(
            s.get_l_events().find(
                app_id,
                channel_id=channel_id,
                start_time=start_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                limit=limit,
                reversed_order=latest,
            )
        )
