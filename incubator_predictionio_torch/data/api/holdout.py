"""Held-out *next events* for continuous quality evaluation.

The port's own copy of ``incubator_predictionio_tpu/data/api/holdout.py``.
The shadow scorer (``workflow/quality.py``) grades a sampled live query by
what the user did afterwards: the events that land in the app's log
partitions after the query was answered are its relevance labels. This
module is the label source, a thin layer over :class:`.log_tail.LogTailer`
that

- arms at the CURRENT log end (everything already in the log predates the
  queries being graded, so only future bytes are labels),
- reads exactly the new bytes per poll, and
- groups each new target-bearing action under its acting entity, so
  ``labels_for(user)`` answers "which items did this user touch since we
  started watching" in O(1).

Holdout state is process-local: the samples it grades live in the serving
process's memory, so a persisted cursor would outlive every query it could
label. A restart re-arms at the new log end.

Memory is bounded on both axes: at most ``max_users`` entities (LRU) and
at most ``max_labels_per_user`` recent items per entity.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Optional

from .log_tail import LogTailer

__all__ = ["HoldoutTailer"]

# property writes carry no relevance signal: $set/$unset/$delete mutate
# entity state, they are not the user acting on an item
_NON_LABEL_PREFIX = "$"


class HoldoutTailer:
    """Tail an app's event-log partitions from "now" and serve the new
    target-bearing events as per-user label sets."""

    def __init__(self, events_dir: str, app_id: int,
                 channel_id: Optional[int] = None, *,
                 max_users: int = 4096, max_labels_per_user: int = 64):
        self._tailer = LogTailer(events_dir, app_id, channel_id)
        self._cursor = self._tailer.end_cursor()
        self._max_users = max(1, int(max_users))
        self._max_labels = max(1, int(max_labels_per_user))
        self._labels: "OrderedDict[str, deque]" = OrderedDict()
        self._events = 0
        self._label_events = 0

    def poll(self) -> int:
        """Read exactly the new bytes; returns how many label events they
        carried. Raises on tailer faults: the caller's loop retries."""
        batch = self._tailer.read_since(self._cursor)
        self._cursor = batch.cursor
        self._events += len(batch.events)
        fresh = 0
        for e in batch.events:
            name = str(e.get("event") or "")
            if not name or name.startswith(_NON_LABEL_PREFIX):
                continue
            user = e.get("entityId")
            item = e.get("targetEntityId")
            if not user or not item:
                continue
            key = str(user)
            labs = self._labels.get(key)
            if labs is None:
                if len(self._labels) >= self._max_users:
                    self._labels.popitem(last=False)
                labs = deque(maxlen=self._max_labels)
                self._labels[key] = labs
            else:
                self._labels.move_to_end(key)
            labs.append(str(item))
            fresh += 1
        self._label_events += fresh
        return fresh

    def labels_for(self, user) -> frozenset:
        labs = self._labels.get(str(user))
        return frozenset(labs) if labs else frozenset()

    def view(self) -> dict:
        return {
            "cursorBytes": self._cursor.total(),
            "cursorShards": len(self._cursor.shards),
            "cursorResets": self._cursor.resets,
            "events": self._events,
            "labelEvents": self._label_events,
            "labelUsers": len(self._labels),
        }
