"""Partition-local training feeds: the partitioned event log as the
training data plane.

The port's own copy of ``incubator_predictionio_tpu/data/api/partition_feed.py``
(:88-326). It reads the ``.p<i>`` shards either package writes
(``data/api/event_log.py``, the partitioned event server):

- **Deterministic shard assignment.** The canonical shard list of one
  (app, channel) log (``jsonl.shard_paths`` order, the naming contract the
  merged view and the log tailer share) is dealt round-robin: shard *j*
  belongs to gang worker ``j % num_workers``. The union over workers covers
  every shard exactly once, with no coordination and no shared state.
- **Sequential snapshot scans.** Each assigned shard is read by
  ``jsonl.scan_log_file``: the committed columnar snapshot covers its
  prefix with no JSON parsing, and only the tail appended past it is
  decoded by the native codec (there is no Python decoder:
  ``NativeUnavailable`` raises).
- **Workers never exchange raw events.** What must be agreed gang-wide —
  the id vocabularies, the tombstoned event ids, the aggregated entity
  properties — is derived per partition here and exchanged once by
  ``workflow/train_feed.py`` over the gang's process group.

Feed semantics against the merged view (the reference's documented
contract): tombstones are id-global across partitions (every worker kills
every reported id in its own shards); duplicate EXPLICIT eventIds that land
in different partitions are not deduplicated (server-generated ids are
unique).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from ..storage.jsonl import (
    _TIME_ABSENT, _to_us, aggregate_replay, scan_log_file, shard_paths,
)

__all__ = [
    "FeedShard", "PartitionFeed", "ShardRatings", "assigned_shards",
    "scan_shard", "to_epoch_us",
]

#: jsonl's datetime → epoch-microseconds conversion: the feed's window
#: bounds must be the merged view's
to_epoch_us = _to_us


def assigned_shards(events_dir: str, app_id: int,
                    channel_id: Optional[int] = None,
                    worker: int = 0, num_workers: int = 1) -> list[str]:
    """Shard paths gang worker ``worker`` of ``num_workers`` feeds from:
    position *j* of the canonical ``shard_paths`` order goes to worker
    ``j % num_workers``. A pure function of the directory listing."""
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    if not 0 <= worker < num_workers:
        raise ValueError(f"worker {worker} outside [0, {num_workers})")
    paths = shard_paths(events_dir, app_id, channel_id)
    return [p for j, p in enumerate(paths) if j % num_workers == worker]


@dataclasses.dataclass
class FeedShard:
    """One scanned shard: its columnar view, the locally-live row mask
    (per-shard dedup and positional tombstones), and the shard's own
    tombstoned ids (exchanged so every worker applies the id-global delete
    rule)."""

    path: str
    cols: object                 # native ColumnarEvents
    live: np.ndarray             # bool mask over cols rows
    tombstone_ids: frozenset
    snapshot_bytes: int = 0
    tail_bytes: int = 0


def scan_shard(path: str, start_us: Optional[int] = None,
               until_us: Optional[int] = None) -> FeedShard:
    """Scan ONE shard: snapshot generations plus a tail-only parse. With an
    event-time window, generations the manifest proves disjoint are
    skipped whole. ``tombstone_ids`` stays the shard's real deletes
    (including ones replayed from skipped generations)."""
    scan, snap_b, tail_b = scan_log_file(path, start_us, until_us)
    return FeedShard(
        path=path, cols=scan.cols, live=scan.live_mask(),
        tombstone_ids=frozenset(scan.tombstones),
        snapshot_bytes=snap_b, tail_bytes=tail_b)


@dataclasses.dataclass
class ShardRatings:
    """One shard's contribution to a rating COO: entity-id strings
    interned per shard (``user_ids``/``item_ids`` in first-seen order over
    the time-sorted selection), the triple indexing into them."""

    user_ids: list            # shard-local user vocabulary
    item_ids: list            # shard-local item vocabulary
    u: np.ndarray             # [nnz] int32 into user_ids
    i: np.ndarray             # [nnz] int32 into item_ids
    rating: np.ndarray        # [nnz] float32


class PartitionFeed:
    """The partition-feed reader of one (app, channel) log for gang worker
    ``worker`` of ``num_workers``. The extraction helpers
    (:meth:`shard_ratings`, :meth:`shard_properties`) are static per-shard
    transforms, so they compose with any prefetch schedule."""

    def __init__(self, events_dir: str, app_id: int,
                 channel_id: Optional[int] = None,
                 worker: int = 0, num_workers: int = 1):
        self.events_dir = events_dir
        self.app_id = int(app_id)
        self.channel_id = channel_id
        self.worker = int(worker)
        self.num_workers = int(num_workers)

    def shard_list(self) -> list[str]:
        return assigned_shards(self.events_dir, self.app_id,
                               self.channel_id, self.worker,
                               self.num_workers)

    def canonical_positions(self) -> dict:
        """{shard path: position in the canonical shard order}: the
        worker-independent key exchanged with per-shard aggregates, so every
        rank merges them identically."""
        return {p: j for j, p in enumerate(
            shard_paths(self.events_dir, self.app_id, self.channel_id))}

    @staticmethod
    def _select(shard: FeedShard,
                event_names: Optional[Sequence[str]],
                global_tombstones: Optional[Iterable[str]],
                start_us: Optional[int], until_us: Optional[int],
                ) -> np.ndarray:
        """Selected row indices of one shard, time-sorted (stable):
        locally-live rows minus id-global tombstones, filtered by event name
        and time window — the merged view's ``scan_columnar`` selection."""
        cols = shard.cols
        if cols is None or len(cols) == 0:
            return np.empty(0, np.int64)
        mask = shard.live.copy()
        if global_tombstones:
            # id-global deletes: ANY record of a tombstoned id dies,
            # whichever partition appended the tombstone
            eid_table = cols.table(cols.TABLE_EVENT_ID)
            dead_codes = [j for j, s in enumerate(eid_table)
                          if s in global_tombstones]
            if dead_codes:
                mask &= ~np.isin(cols.event_id,
                                 np.asarray(dead_codes, np.int32))
        if event_names is not None:
            table = cols.table(cols.TABLE_EVENT)
            codes = [table.index(n) for n in event_names if n in table]
            mask &= np.isin(cols.event, np.asarray(codes, np.int32))
        if start_us is not None or until_us is not None:
            tmask = cols.time_us != _TIME_ABSENT
            if start_us is not None:
                tmask &= cols.time_us >= start_us
            if until_us is not None:
                tmask &= cols.time_us < until_us
            mask &= tmask
        rows = np.nonzero(mask)[0]
        return rows[np.argsort(cols.time_us[rows], kind="stable")]

    @staticmethod
    def shard_ratings(shard: FeedShard,
                      event_names: Optional[Sequence[str]] = None,
                      global_tombstones: Optional[Iterable[str]] = None,
                      rating_from_props: bool = True,
                      default_rating: float = 1.0,
                      event_default_ratings: Optional[dict] = None,
                      start_us: Optional[int] = None,
                      until_us: Optional[int] = None) -> ShardRatings:
        """(user, item, rating) of ONE shard — the columnar path of
        ``PEventStore.find_ratings`` per partition (the codec's NaN / -inf
        rating sentinels, users over all selected rows, items only where a
        target exists)."""
        cols = shard.cols
        rows = PartitionFeed._select(shard, event_names, global_tombstones,
                                     start_us, until_us)
        if rows.size == 0:
            return ShardRatings([], [], np.empty(0, np.int32),
                                np.empty(0, np.int32),
                                np.empty(0, np.float32))
        rows = rows[cols.eid[rows] >= 0]  # malformed records: no entityId
        keep_mask = cols.teid[rows] >= 0
        keep = rows[keep_mask]
        if rating_from_props:
            r = cols.rating[keep].astype(np.float32, copy=True)
            # codec sentinels: NaN = "rating" absent (the event default
            # applies), -inf = present but not a number (plain default)
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

        def densify(codes: np.ndarray, table: list):
            uniq, first_pos, inv = np.unique(
                codes, return_index=True, return_inverse=True)
            order = np.argsort(first_pos, kind="stable")
            rank = np.empty(order.shape, np.int64)
            rank[order] = np.arange(order.shape[0])
            ids = [table[c] for c in uniq[order]]
            return rank[inv].astype(np.int32), ids

        u_all, user_ids = densify(cols.eid[rows], cols.table(cols.TABLE_EID))
        i_codes, item_ids = densify(cols.teid[keep],
                                    cols.table(cols.TABLE_TEID))
        return ShardRatings(user_ids=user_ids, item_ids=item_ids,
                            u=u_all[keep_mask], i=i_codes, rating=r)

    @staticmethod
    def shard_properties(shard: FeedShard,
                         entity_type: Optional[str] = None,
                         global_tombstones: Optional[Iterable[str]] = None
                         ) -> dict:
        """Per-shard $set/$unset/$delete replay →
        ``{entity_id: (props, first_us, last_us)}`` (raw microsecond times,
        ``jsonl.aggregate_replay``). The cross-shard merge is
        ``train_feed``'s; a $delete only erases the $sets of its own shard
        (the documented feed caveat)."""
        rows = PartitionFeed._select(
            shard, ["$set", "$unset", "$delete"], global_tombstones,
            None, None)
        return aggregate_replay(shard.cols, rows, entity_type)

    def local_tombstones(self, shards: Iterable[FeedShard]) -> list:
        """Sorted union of the tombstoned ids of this worker's shards (the
        first, tiny exchange payload)."""
        out: set = set()
        for s in shards:
            out |= s.tombstone_ids
        return sorted(out)
