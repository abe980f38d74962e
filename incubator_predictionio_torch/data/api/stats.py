"""Rolling ingestion stats behind ``/stats.json`` and ``eventserver
--stats`` (reference: data/.../data/api/Stats.scala — StatsActor counting
by (appId, event, entityType, status)).

The port's own copy of ``incubator_predictionio_tpu/data/api/stats.py``.
The store IS a telemetry
:class:`~incubator_predictionio_torch.common.telemetry.CounterFamily`
(``pio_ingest_events_total{app_id,event,entity_type,status}``), so the
same counts serve the legacy ``/stats.json`` view (:meth:`to_json`) and
the event server's ``GET /metrics`` exposition (the server's collector
yields :attr:`family`). The family is per-Stats-instance — multiple
servers in one test process keep independent JSON views — with each
live server's family exported by its collector registration.

Note the lock-sharded counters make :meth:`record` callable from any
thread without a Stats-wide lock; :meth:`record_many` simply loops —
each label set touches only its own shard cell, so a group of N events
costs N shard increments, not N contended acquisitions of one lock.
"""

from __future__ import annotations

import time

from ...common import telemetry


class Stats:
    def __init__(self) -> None:
        self.family = telemetry.CounterFamily(
            "pio_ingest_events_total",
            "Ingested (and rejected) events by app, event name, entity "
            "type, and HTTP status",
            ("app_id", "event", "entity_type", "status"))
        self.start_time = time.time()

    def record(self, app_id: int, event_name: str, entity_type: str,
               status: int) -> None:
        self.family.labels(app_id, event_name, entity_type, status).inc()

    def record_many(self, counts) -> None:
        """Batched accounting for a whole commit group. ``counts`` maps
        (app_id, event, entityType, status) -> increment."""
        for (app_id, event_name, entity_type, status), n in counts.items():
            self.family.labels(app_id, event_name, entity_type,
                               status).inc(n)

    def to_json(self, app_id: int | None = None) -> dict:
        items = [
            {
                "appId": int(labels[0]),
                "event": labels[1],
                "entityType": labels[2],
                "status": int(labels[3]),
                "count": counter.value(),
            }
            for labels, counter in self.family.samples()
            if app_id is None or labels[0] == str(app_id)
        ]
        # samples() sorts stringified labels; restore the legacy numeric
        # ordering ((appId, event, entityType, status) with ints as ints)
        items.sort(key=lambda d: (d["appId"], d["event"],
                                  d["entityType"], d["status"]))
        return {"uptime": time.time() - self.start_time, "counts": items}
