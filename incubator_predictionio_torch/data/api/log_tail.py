"""Durable byte-cursor tailing of the partitioned event log.

The port's own copy of ``incubator_predictionio_tpu/data/api/log_tail.py``:
the same cursor document, so a cursor written by either package resumes in
the other.

Streaming online learning (the reference's ``workflow/online.py``; not
ported yet) needs exactly one data-layer primitive: *give me every
event appended since the last time I asked, in O(new bytes), across
every shard of an app's log, surviving process restarts*. This module
is that primitive, and nothing else — fold-in math, instance
publication and gate/rollback semantics live above it.

Design:

- **The cursor is a per-shard byte-offset map** (``LogCursor``), keyed
  by shard *basename* (``events_<app>[_<chan>][.p<i>].jsonl`` — the
  naming contract shared with ``data/storage/jsonl.shard_paths``).
  JSONL logs are append-only (deletes are tombstone *appends*, and the
  columnar compactor never rewrites the log — its snapshot is a
  sidecar), so a byte offset into a shard is a durable LSN: it stays
  valid across compaction passes, lease fencing and worker restarts.
  The scalar ``total()`` (sum of offsets) is the display LSN
  `pio status` prints.
- **Reads are O(new bytes).** Each poll stats every shard, seeks to
  the committed offset, reads only the appended bytes up to the last
  complete line, and decodes them with the columnar event codec
  (``parse_events`` — the same parser behind ``_LogScan._extend``).
  A cold read from offset 0 seeds from the log's committed colseg
  snapshot (``event_log.load_snapshot`` — CRC-verified) instead of
  re-parsing JSON, so the compactor's work is not wasted on tailers.
- **Fenced-partition and mid-compaction safe.** Tailing only ever
  READS: lease epochs fence *writers*, and whichever worker owns a
  shard, its acked bytes land append-only in the same file, so the
  cursor needs no lease awareness. New shards (a worker count change,
  a force-fenced partition re-claimed under a new index) are
  discovered per poll and read from offset 0. The ONE event that can
  invalidate an offset is a log *rewrite* — tombstone compaction
  (``JSONLEvents.compact``) or operator surgery shrinks the file — and
  that is detected (size < offset) and handled by resetting that
  shard's offset to the new end, counted in ``LogCursor.resets`` and
  logged: a rewrite only drops dead records, and resuming mid-file
  after one could mis-frame a record boundary, which must never happen
  silently.
- **Events come out as wire-format dicts** (``ColumnarEvents
  .record_dict`` — the exact JSON the client POSTed), ordered by shard
  then file position. Tombstone lines are not events and are not
  yielded. Cross-shard ordering is not globally time-sorted (shards
  are appended by independent workers); consumers that need time order
  sort the batch themselves.

Durability is the CALLER's half: ``LogCursor.to_json``/``from_json``
round-trip through whatever store the consumer persists into (the
fold-in cursor is a reserved Models-DAO row,
``workflow/model_artifact.foldin_row_id``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

log = logging.getLogger("pio.torch.logtail")

__all__ = ["LogCursor", "LogTailer", "TailBatch"]

CURSOR_VERSION = 1


@dataclasses.dataclass
class LogCursor:
    """Durable position in one (app, channel) log: committed byte
    offset per shard basename, plus the count of shard resets survived
    (rewrites detected and skipped past — see module docstring)."""

    shards: dict  # shard basename -> committed byte offset
    resets: int = 0

    def total(self) -> int:
        """Scalar display LSN: bytes committed across every shard."""
        return int(sum(self.shards.values()))

    def to_json(self) -> dict:
        return {"v": CURSOR_VERSION, "shards": dict(self.shards),
                "resets": int(self.resets)}

    @staticmethod
    def from_json(doc: dict) -> "LogCursor":
        """Inverse of :meth:`to_json`. Damaged docs raise ValueError —
        a torn cursor must surface loudly, not silently re-read the
        whole log (the caller decides between end_cursor() and a full
        re-read)."""
        if not isinstance(doc, dict) or not isinstance(
                doc.get("shards"), dict):
            raise ValueError(f"not a log cursor: {doc!r}")
        if int(doc.get("v", 1)) > CURSOR_VERSION:
            raise ValueError(
                f"cursor written by a newer format (v{doc.get('v')})")
        shards = {str(k): int(v) for k, v in doc["shards"].items()}
        if any(v < 0 for v in shards.values()):
            raise ValueError("negative shard offset")
        return LogCursor(shards=shards, resets=int(doc.get("resets", 0)))


@dataclasses.dataclass
class TailBatch:
    """One ``read_since`` result: the new events, the advanced cursor
    (commit it AFTER acting on the events — at-least-once), and read
    accounting for telemetry/status."""

    events: list          # wire-format event dicts, shard-then-file order
    cursor: LogCursor     # advanced past every complete line read
    bytes_read: int = 0
    snapshot_seeded: bool = False   # a cold shard loaded its colseg
    resets: int = 0                 # shard rewrites detected THIS read


class LogTailer:
    """Stateless-on-disk tailer over one (app, channel) log directory.
    All state lives in the :class:`LogCursor` the caller holds and
    persists; two tailers with the same cursor read the same events."""

    def __init__(self, events_dir: str, app_id: int,
                 channel_id: Optional[int] = None):
        self.events_dir = events_dir
        self.app_id = int(app_id)
        self.channel_id = channel_id

    def _shards(self) -> list:
        from ..storage.jsonl import shard_paths

        return shard_paths(self.events_dir, self.app_id, self.channel_id)

    @staticmethod
    def _complete_end(path: str) -> int:
        """Byte offset of the last complete line (0 when unreadable)."""
        try:
            size = os.path.getsize(path)
            if size == 0:
                return 0
            with open(path, "rb") as f:
                # probe backwards for the final newline without reading
                # the whole file: tails are what this module is for
                back = min(size, 1 << 16)
                while back <= size:
                    f.seek(size - back)
                    buf = f.read(back)
                    cut = buf.rfind(b"\n")
                    if cut >= 0:
                        return size - back + cut + 1
                    if back == size:
                        return 0
                    back = min(size, back * 4)
            return 0
        except OSError:
            return 0

    def end_cursor(self) -> LogCursor:
        """Cursor at the current complete-line end of every shard —
        "start tailing from NOW" (what the fold-in runner arms with:
        the deployed model was just trained on everything before
        now)."""
        return LogCursor(shards={
            os.path.basename(p): self._complete_end(p)
            for p in self._shards()})

    def lag_bytes(self, cursor: Optional[LogCursor]) -> int:
        """Unread complete-line bytes behind ``cursor`` (0 for a cursor
        at the end; the whole log for None)."""
        total = 0
        shards = (cursor.shards if cursor is not None else {})
        for p in self._shards():
            done = int(shards.get(os.path.basename(p), 0))
            end = self._complete_end(p)
            if end > done:
                total += end - done
        return total

    def read_since(self, cursor: Optional[LogCursor],
                   max_bytes: Optional[int] = None) -> TailBatch:
        """Every event appended past ``cursor`` (None = from the
        beginning of the log). O(new bytes): only appended bytes are
        read and decoded; a cold shard (offset 0) seeds from its
        committed columnar snapshot when one exists.

        ``max_bytes`` bounds ONE call's read (memory + latency) for
        pagination — the returned cursor covers exactly what was read,
        so the caller loops until ``bytes_read == 0``. Bounded calls
        skip snapshot seeding (a snapshot is one unbounded blob) and
        read raw lines instead."""
        from ...native import parse_events
        from . import event_log

        shards = dict(cursor.shards) if cursor is not None else {}
        resets_prior = cursor.resets if cursor is not None else 0
        events: list = []
        bytes_read = 0
        budget = max_bytes
        snapshot_seeded = False
        resets = 0
        for path in self._shards():
            if budget is not None and budget <= 0:
                break   # untouched shards keep their cursor offsets
            name = os.path.basename(path)
            off = int(shards.get(name, 0))
            try:
                size = os.path.getsize(path)
            except OSError:
                continue    # shard vanished between listdir and stat
            if size < off:
                # the log was REWRITTEN under us (tombstone compaction
                # / operator surgery): mid-file offsets no longer frame
                # records. Skip to the new end — a rewrite only drops
                # dead records, and the reset is counted + logged so a
                # lost-update suspicion has an audit trail.
                log.warning(
                    "log shard %s shrank under the cursor (%d -> %d "
                    "bytes): rewritten; resetting this shard's cursor "
                    "to its new end", path, off, size)
                shards[name] = self._complete_end(path)
                resets += 1
                continue
            if off == 0 and budget is None:
                snap = None
                try:
                    snap = event_log.load_snapshot(path)
                except Exception:  # noqa: BLE001 — accel layer only
                    snap = None
                if snap is not None:
                    cols, covered = snap
                    events.extend(cols.record_dict(i)
                                  for i in range(len(cols)))
                    off = covered
                    bytes_read += covered
                    snapshot_seeded = True
            if size > off:
                want = size - off
                if budget is not None:
                    want = min(want, budget)
                try:
                    with open(path, "rb") as f:
                        f.seek(off)
                        tail = f.read(want)
                        if (tail.rfind(b"\n") < 0
                                and want < size - off):
                            # a single line longer than the budget:
                            # finish the line rather than stall forever
                            tail += f.readline()
                except OSError:
                    shards[name] = off
                    continue
                cut = tail.rfind(b"\n") + 1   # complete lines only
                if cut:
                    cols = parse_events(tail[:cut])
                    events.extend(cols.record_dict(i)
                                  for i in range(len(cols)))
                    off += cut
                    bytes_read += cut
                    if budget is not None:
                        budget -= cut
            shards[name] = off
        return TailBatch(
            events=events,
            cursor=LogCursor(shards=shards,
                             resets=resets_prior + resets),
            bytes_read=bytes_read,
            snapshot_seeded=snapshot_seeded,
            resets=resets,
        )
