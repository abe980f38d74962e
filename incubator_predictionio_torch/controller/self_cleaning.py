"""SelfCleaningDataSource — the event-TTL and compaction mixin.

Port of ``incubator_predictionio_tpu/controller/self_cleaning.py``
(reference: core/.../core/SelfCleaningDataSource.scala): optionally ages
out events older than a TTL, drops re-imported duplicates, and compacts
each entity type's ``$set``/``$unset``/``$delete`` stream into one ``$set``
snapshot per entity, writing the cleaned stream back to the event store.
The same passes over the same store leave the same events as the
reference's.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json as _json
import logging
from typing import Optional

from ..data.storage.base import aggregate_property_events
from ..data.storage.datamap import DataMap
from ..data.storage.event import Event

log = logging.getLogger("pio.torch.selfclean")

_PROPERTY_EVENTS = ("$set", "$unset", "$delete")


class SelfCleaningDataSource:
    """Mixin for DataSources, configured by attributes:
    ``event_window_duration`` (a timedelta, or None to keep every event),
    ``event_window_remove`` (delete the aged-out events) and
    ``event_dedupe`` (keep the first copy of events that are identical in
    every user-visible field). Call ``clean_persisted_data(ctx, app_name)``
    at the top of ``read_training``."""

    event_window_duration: Optional[_dt.timedelta] = None
    event_window_remove: bool = False
    event_dedupe: bool = True

    def clean_persisted_data(self, ctx, app_name: str) -> int:
        """Age out, dedupe and compact the app's default channel; returns
        the net number of events removed."""
        storage = ctx.get_storage()
        app = storage.get_meta_data_apps().get_by_name(app_name)
        if app is None:
            raise ValueError(f"App {app_name!r} does not exist")
        le = storage.get_l_events()
        removed = 0

        # 1) age out old non-property events
        if self.event_window_duration is not None and self.event_window_remove:
            cutoff = (_dt.datetime.now(_dt.timezone.utc)
                      - self.event_window_duration)
            doomed = [e.event_id for e in le.find(app.id, until_time=cutoff)
                      if e.event not in _PROPERTY_EVENTS]
            # what was deleted, not what was asked for: a concurrent
            # writer may have removed some already
            removed += sum(le.delete_batch(doomed, app.id))

        # 2) content dedupe: events identical in every user-visible field
        # (tags and prId included) keep their first copy in store order
        if self.event_dedupe:
            seen: set[bytes] = set()
            dupes = []
            for e in le.find(app.id):
                key = _json.dumps(
                    [e.event, e.entity_type, e.entity_id,
                     e.target_entity_type, e.target_entity_id,
                     e.properties.to_dict(), sorted(e.tags or ()),
                     e.pr_id, e.event_time],
                    sort_keys=True, default=str).encode()
                digest = hashlib.blake2b(key, digest_size=16).digest()
                if digest in seen:
                    dupes.append(e.event_id)
                else:
                    seen.add(digest)
            removed += sum(le.delete_batch(dupes, app.id))

        # 3) compact each entity type's property stream into one $set
        by_type: dict[str, list[Event]] = {}
        for e in le.find(app.id, event_names=list(_PROPERTY_EVENTS)):
            by_type.setdefault(e.entity_type, []).append(e)
        for entity_type, events in by_type.items():
            if len(events) <= len({e.entity_id for e in events}):
                continue  # nothing to compact
            snapshot = aggregate_property_events(events)
            removed += sum(
                le.delete_batch([e.event_id for e in events], app.id))
            for entity_id, pm in snapshot.items():
                le.insert(Event("$set", entity_type, entity_id,
                                properties=DataMap(pm.to_dict()),
                                event_time=pm.last_updated), app.id)
                removed -= 1
        # a concurrent deleter can make deletions < insertions
        removed = max(removed, 0)
        if removed:
            log.info("self-cleaning removed %d events", removed)
        return removed
