"""JSONL event-log backend — the `JSONL` source type (eventdata only).

The port's own copy of ``incubator_predictionio_tpu/data/storage/jsonl.py``:
the same files, the same lines and the same read semantics, so one events
directory serves both packages. One append-only JSONL log per (app,
channel), ``events_<app>[_<chan>].jsonl``; inserts and deletes are appends
(deletes as ``{"__tombstone__": id}`` records), and the bulk read feeding
training is a single file scan decoded by the event codec
(``native/src/event_codec.cc``, bound in ``native/__init__.py``) straight
into interned numpy columns — no Python object per event on the training
path. A committed columnar snapshot (``data/api/event_log.py``) replaces
the JSON parse of the prefix it covers, and a windowed read skips whole
generations by their event-time bounds.

Scans are cached per file and extended incrementally: the parser re-reads
only the bytes appended since the previous scan. Under
``PIO_EVENT_PARTITION=i`` (a worker of the multi-worker event server,
``data/api/event_log.py``) every write lands in the worker's own shard
``events_<app>[_<chan>].p<i>.jsonl``; a directory holding ``.p<i>`` shards
(written by either package) is read as one merged view — base log first,
then the partitions in index order — with id-global deletes.

`aggregate_properties` ($set/$unset/$delete folding) and point lookups
reconstruct full events lazily from the cached record spans.
"""

from __future__ import annotations

import datetime as _dt
import itertools
import os
import threading
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from ...common import envknobs
from ...common.faultinject import fault_point
from ...native import ColumnarEvents, parse_events
from . import base
from .datamap import PropertyMap
from .event import Event, new_event_id
from .memory import event_matches

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
_TIME_ABSENT = np.iinfo(np.int64).min


def _to_us(t: Optional[_dt.datetime]) -> Optional[int]:
    if t is None:
        return None
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return int(round((t - _EPOCH).total_seconds() * 1e6))


def shard_paths(dirpath: str, app_id: int,
                channel_id: Optional[int] = None) -> list[str]:
    """Every on-disk shard of one (app, channel) event log, base log
    first then partitions in index order — THE naming contract of the
    partitioned layout (``events_<app>[_<chan>][.p<i>].jsonl``), shared
    by the merged read view below and the log tailer
    (data/api/log_tail.py) so the two can never disagree about what
    files make up a log."""
    suffix = f"_{channel_id}" if channel_id is not None else ""
    base = os.path.join(dirpath, f"events_{app_id}{suffix}.jsonl")
    paths = [base] if os.path.exists(base) else []
    prefix = os.path.basename(base)[:-6] + ".p"
    parts = []
    try:
        names = os.listdir(dirpath)
    except OSError:
        names = []
    for name in names:
        if name.startswith(prefix) and name.endswith(".jsonl"):
            mid = name[len(prefix):-6]
            if mid.isdigit():
                parts.append((int(mid), name))
    paths.extend(os.path.join(dirpath, name) for _i, name in sorted(parts))
    return paths


class _LogScan:
    """Cached columnar scan of one log file, extended incrementally."""

    def __init__(self) -> None:
        self.size = 0
        self.cols: Optional[ColumnarEvents] = None
        # eventId string → last tombstone position (record count at the
        # time the tombstone was appended). Deletes are positional: only
        # records BEFORE the tombstone die; a later re-insert is live.
        self.tombstones: dict[str, int] = {}
        # eventId string → kill position replayed from a generation a
        # windowed read SKIPPED: the skipped generation holds a later
        # duplicate of the id, so every earlier record must die exactly
        # as keep-last dedup would have killed it in the full scan.
        # Kept apart from `tombstones` because these are NOT deletes:
        # they must never be replayed as id-global tombstones against
        # other shards.
        self.skip_kills: dict[str, int] = {}
        # Incrementally-built string → interned-code index per table (the
        # tables are append-only, so only new suffixes need indexing; the
        # same dicts serve point lookups AND _extend's code remapping).
        self._tbl_index: list[dict[str, int]] = [{} for _ in range(6)]
        self._tbl_indexed = [0] * 6

    def _reset_indexes(self) -> None:
        self._tbl_index = [{} for _ in range(6)]
        self._tbl_indexed = [0] * 6

    def table_index(self, which: int) -> dict[str, int]:
        assert self.cols is not None
        table = self.cols.table(which)
        if self._tbl_indexed[which] < len(table):
            idx = self._tbl_index[which]
            for i in range(self._tbl_indexed[which], len(table)):
                idx[table[i]] = i
            self._tbl_indexed[which] = len(table)
        return self._tbl_index[which]

    def eid_index(self) -> dict[str, int]:
        return self.table_index(ColumnarEvents.TABLE_EVENT_ID)

    @staticmethod
    def _merge_tombstones(dest: dict[str, int], cols: ColumnarEvents,
                          offset: int = 0) -> None:
        for tid, pos in zip(cols.tombstones, cols.tombstone_pos):
            dest[tid] = max(dest.get(tid, -1), int(pos) + offset)

    def refresh(self, path: str) -> None:
        try:
            size = os.path.getsize(path)
        except OSError:
            self.size, self.cols, self.tombstones = 0, None, {}
            self.skip_kills = {}
            self._reset_indexes()
            return
        if self.cols is not None and size == self.size:
            return
        if self.cols is not None and size > self.size:
            with open(path, "rb") as f:
                f.seek(self.size)
                tail = f.read()
            new = parse_events(tail)
            self._extend(new)
            self.size = size
            return
        # cold (or replaced) load: a committed columnar snapshot — the
        # event-log compactor's crash-safe rewrite of the log prefix
        # (data/api/event_log.py) — replaces the JSON re-parse of
        # everything it covers; only the tail appended since compaction
        # is parsed. Verified (CRC + manifest) inside load_snapshot;
        # any corruption quarantines the snapshot and falls back to the
        # full parse below — slower, never wrong.
        snap = self._try_snapshot(path)
        if snap is not None:
            cols, covered = snap
            self.cols = cols
            self.tombstones = {}
            self.skip_kills = {}
            self._merge_tombstones(self.tombstones, cols)
            self._reset_indexes()
            self.size = covered
            if size > covered:
                with open(path, "rb") as f:
                    f.seek(covered)
                    tail = f.read()
                self._extend(parse_events(tail))
                self.size = size
            return
        # retention-aware fallback: the JSON parse must start at the
        # byte after the retired-generation prefix, or expired data
        # would resurrect through the slow path
        floor = _parse_floor(path)
        with open(path, "rb") as f:
            if floor:
                f.seek(floor)
            buf = f.read()
        self.cols = parse_events(buf)
        self.tombstones = {}
        self.skip_kills = {}
        self._merge_tombstones(self.tombstones, self.cols)
        self._reset_indexes()
        self.size = size

    @staticmethod
    def _try_snapshot(path: str):
        """(cols, covered_bytes) from the compacted snapshot, or None.
        The snapshot layer must never be able to break a scan."""
        try:
            from ..api import event_log

            return event_log.load_snapshot(path)
        except Exception:  # noqa: BLE001 — cache layer, fall back
            return None

    def _absorb(self, cols: ColumnarEvents) -> None:
        """Fold one parsed/decoded piece onto the end of this scan."""
        if self.cols is None:
            self.cols = cols
            self._merge_tombstones(self.tombstones, cols)
        else:
            self._extend(cols)

    def _absorb_skip(self, entry: dict) -> None:
        """Fold a generation a windowed read skipped WITHOUT decoding:
        its manifest entry carries everything the effective view needs
        from it — the tombstone ids it appended (real deletes, applied
        at the current end so every earlier record of the id dies, just
        as the full scan's positional replay would) and the explicit
        ids it duplicates from earlier generations (keep-last dedup
        kills, tracked separately so they never masquerade as
        deletes)."""
        n = len(self.cols) if self.cols is not None else 0
        for tid in entry.get("tombstones") or ():
            self.tombstones[tid] = max(self.tombstones.get(tid, -1), n)
        for tid in entry.get("dupIds") or ():
            self.skip_kills[tid] = max(self.skip_kills.get(tid, -1), n)

    def _extend(self, new: ColumnarEvents) -> None:
        old = self.cols
        assert old is not None
        # Remap new codes into the old tables (append-only interning). The
        # persistent per-table index dicts avoid an O(total-events) rebuild
        # on every small append.
        remapped = {}
        for which, attr in ((0, "event"), (1, "etype"), (2, "eid"),
                            (3, "tetype"), (4, "teid"), (5, "event_id")):
            old_table = old.table(which)
            old_index = self.table_index(which)
            new_table = new.table(which)
            lut = np.empty(len(new_table) + 1, np.int32)
            lut[-1] = -1  # code -1 stays -1
            for i, s in enumerate(new_table):
                code = old_index.get(s)
                if code is None:
                    code = len(old_table)
                    old_table.append(s)
                    old_index[s] = code
                lut[i] = code
            self._tbl_indexed[which] = len(old_table)
            remapped[attr] = lut[getattr(new, attr)]
        base_off = len(old.raw)
        n_old = len(old)
        shift = lambda a: np.where(a >= 0, a + base_off, a)  # noqa: E731
        self.cols = ColumnarEvents(
            raw=old.raw + new.raw,
            event=np.concatenate([old.event, remapped["event"]]),
            etype=np.concatenate([old.etype, remapped["etype"]]),
            eid=np.concatenate([old.eid, remapped["eid"]]),
            tetype=np.concatenate([old.tetype, remapped["tetype"]]),
            teid=np.concatenate([old.teid, remapped["teid"]]),
            event_id=np.concatenate([old.event_id, remapped["event_id"]]),
            time_us=np.concatenate([old.time_us, new.time_us]),
            rating=np.concatenate([old.rating, new.rating]),
            props=np.concatenate([old.props, shift(new.props)]),
            span=np.concatenate([old.span, shift(new.span)]),
            _tables=[old.table(w) for w in range(6)],
            tombstones=old.tombstones + new.tombstones,
            tombstone_pos=np.concatenate(
                [old.tombstone_pos, new.tombstone_pos + n_old]
            ),
        )
        self._merge_tombstones(self.tombstones, new, offset=n_old)

    def live_mask(self) -> np.ndarray:
        """Boolean mask of the effective view: per eventId only the LAST
        record survives (re-insert with a client-supplied id overwrites,
        matching the other backends' upsert semantics), and records older
        than their id's latest tombstone are dropped (positional delete —
        a record re-inserted AFTER the delete is live again)."""
        cols = self.cols
        assert cols is not None
        n = len(cols)
        mask = np.ones(n, bool)
        ids = cols.event_id
        n_with_id = int((ids >= 0).sum())
        if n and len(cols.table(ColumnarEvents.TABLE_EVENT_ID)) < n_with_id:
            # duplicates exist: keep last occurrence of each code
            rev_ids = ids[::-1]
            _, first_in_rev = np.unique(rev_ids, return_index=True)
            keep = np.zeros(n, bool)
            keep[n - 1 - first_in_rev] = True
            keep |= ids < 0  # records without ids are never deduped
            mask &= keep
        if self.tombstones or self.skip_kills:
            index = self.eid_index()
            n_codes = len(cols.table(ColumnarEvents.TABLE_EVENT_ID))
            last_ts = np.full(n_codes + 1, -1, np.int64)
            # Snapshot: a concurrent delete_batch may grow the dict.
            # skip_kills replay keep-last dedup against records that
            # live only in window-skipped generations; positionally
            # they kill exactly like tombstones, so one pass serves.
            kills = list(self.tombstones.items())
            if self.skip_kills:
                kills += list(self.skip_kills.items())
            for tid, pos in kills:
                code = index.get(tid)
                if code is not None:
                    last_ts[code] = max(last_ts[code], pos)
            # A record dies iff some tombstone for its id was appended
            # after it (record index < tombstone position).
            safe_ids = np.where(ids >= 0, ids, n_codes)
            dead = np.arange(n) < last_ts[safe_ids]
            mask &= ~dead
        return mask


def _parse_floor(path: str) -> int:
    """Byte offset JSON fallback parses must start at (after the
    retired-generation prefix); 0 when the chain layer is unavailable.
    Owned by event_log.py — this is only the safe accessor."""
    try:
        from ..api import event_log

        return event_log.parse_floor(path)
    except Exception:  # noqa: BLE001 — cache layer, fall back
        return 0


def _try_chain(path: str, start_us: Optional[int],
               until_us: Optional[int]):
    """Windowed chain load for the TRAIN read paths, or None (caller
    falls back to the floor-aware JSON parse). An archived generation
    the window actually needs is the one failure that must NOT degrade
    silently: the named-generation error (or its restore-on-demand
    flip) propagates to the trainer."""
    try:
        from ..api import event_log
    except Exception:  # noqa: BLE001 — cache layer, fall back
        return None
    try:
        return event_log.load_chain(
            path, start_us, until_us,
            on_archived=("raise" if (start_us is not None
                                     or until_us is not None)
                         else "parse"))
    except event_log.ArchivedGenerationError:
        raise
    except Exception:  # noqa: BLE001 — cache layer, fall back
        return None


def _fold_chain(scan: _LogScan, path: str, chain: dict) -> int:
    """Fold a ``load_chain`` result into ``scan``; returns the covered
    byte count (where the tail parse resumes)."""
    for piece in chain["pieces"]:
        kind = piece[0]
        if kind == "cols":
            scan._absorb(piece[1])
        elif kind == "skip":
            scan._absorb_skip(piece[1])
        else:  # "gap": archived generation — re-parse its log bytes
            entry = piece[1]
            start = int(entry.get("start", 0))
            try:
                with open(path, "rb") as f:
                    f.seek(start)
                    raw = f.read(int(entry.get("end", 0)) - start)
            except OSError:
                raw = b""
            scan._absorb(parse_events(raw))
    return int(chain["covered"])


def scan_log_file(path: str, start_us: Optional[int] = None,
                  until_us: Optional[int] = None
                  ) -> tuple[_LogScan, int, int]:
    """One-shot scan of a single log shard: the committed colseg
    generations cover their prefix with ZERO JSON parsing and only the
    uncovered tail (bytes appended past the newest generation) is
    decoded. With an event-time window ``[start_us, until_us)``,
    generations the manifest proves disjoint are skipped whole — zero
    bytes read, zero decoded — and their tombstone/duplicate metadata
    replayed, so the scan (after the caller's row-wise time filter)
    stays bit-identical to a filtered full scan. Returns
    ``(scan, snapshot_bytes, tail_bytes)``: how many bytes came from
    snapshots and how many were parsed. Unlike the cached ``_scan``
    registry this builds fresh state per call, and the caller owns its
    lifetime."""
    scan = _LogScan()
    snapshot_bytes = tail_bytes = 0
    chain = _try_chain(path, start_us, until_us)
    if chain is not None:
        scan.size = _fold_chain(scan, path, chain)
        snapshot_bytes = scan.size
    else:
        scan.size = _parse_floor(path)
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    if size > scan.size:
        with open(path, "rb") as f:
            f.seek(scan.size)
            tail = f.read()
        cut = tail.rfind(b"\n") + 1  # complete lines only
        if cut:
            scan._absorb(parse_events(tail[:cut]))
            scan.size += cut
            tail_bytes = cut
    if scan.cols is None:
        scan.cols = parse_events(b"")
    return scan, snapshot_bytes, tail_bytes


def aggregate_replay(
    cols: ColumnarEvents, rows: np.ndarray,
    entity_type: Optional[str] = None,
) -> dict[str, tuple[dict, int, int]]:
    """$set/$unset/$delete replay over selected columnar rows →
    ``{entity_id: (props, first_us, last_us)}`` with raw microsecond
    times (``_TIME_ABSENT`` = the event carried none — callers decide
    the "now" substitution). The replay behind
    :meth:`JSONLEvents.aggregate_columnar`. ``rows`` must already be
    filtered to the
    $set/$unset/$delete selection."""
    if rows.size == 0:
        return {}
    keep = cols.eid[rows] >= 0
    if entity_type is not None:
        et_table = cols.table(ColumnarEvents.TABLE_ETYPE)
        try:
            keep &= cols.etype[rows] == et_table.index(entity_type)
        except ValueError:
            return {}
    rows = rows[keep]
    ev_table = cols.table(ColumnarEvents.TABLE_EVENT)
    codes = {n: ev_table.index(n)
             for n in ("$set", "$unset", "$delete") if n in ev_table}
    # ascending stable time order == sorted(find(), key=event_time),
    # with absent times treated as "now" (sorts last, file order)
    sort_t = cols.time_us[rows]
    sort_t = np.where(sort_t == _TIME_ABSENT,
                      np.iinfo(np.int64).max, sort_t)
    rows = rows[np.argsort(sort_t, kind="stable")]

    import json as _json

    loads, raw = _json.loads, cols.raw
    set_c = codes.get("$set", -1)
    unset_c = codes.get("$unset", -2)
    # hot loop over python scalars: tolist() beats per-element
    # np.int64 indexing, and the props spans are sliced inline
    ev_l = cols.event[rows].tolist()
    eid_l = cols.eid[rows].tolist()
    t_l = cols.time_us[rows].tolist()
    span_l = cols.props[rows].tolist()
    # replay keyed on interned entity codes; strings resolved once
    state: dict[int, tuple[dict, int, int]] = {}
    for e, c, t, (s0, e0) in zip(ev_l, eid_l, t_l, span_l):
        if e == set_c:
            d = loads(raw[s0:e0]) if s0 >= 0 else {}
            got = state.get(c)
            if got is not None:
                props, first, _ = got
                props.update(d)
                state[c] = (props, first, t)
            else:
                state[c] = (d, t, t)
        elif e == unset_c:
            got = state.get(c)
            if got is not None:
                props, first, _ = got
                if s0 >= 0:
                    for k in loads(raw[s0:e0]):
                        props.pop(k, None)
                state[c] = (props, first, t)
        else:  # $delete
            state.pop(c, None)

    eid_table = cols.table(ColumnarEvents.TABLE_EID)
    return {eid_table[c]: v for c, v in state.items()}


def _fsync_enabled() -> bool:
    from ...common import envknobs

    return envknobs.env_flag("PIO_INGEST_FSYNC", False)


class AppendHandle:
    """Lazily-(re)opened long-lived append handle over one file (the
    JSONL tables and the write-ahead log's segments): one ``write`` +
    ``flush`` per append, so the bytes reach the OS page cache — they
    survive a SIGKILL of THIS process — and an explicit per-call
    ``fsync`` for crash-of-the-HOST durability. Not thread-safe; the
    JSONL per-table lock and the WAL's per-key lock serialize callers."""

    __slots__ = ("path", "fh")

    def __init__(self, path: str) -> None:
        self.path = path
        self.fh = None

    def append(self, data: bytes, fsync: bool = False) -> None:
        fh = self.fh
        if fh is None or fh.closed:
            fh = self.fh = open(self.path, "ab")
        fh.write(data)
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())

    def fsync(self) -> None:
        """fsync without writing (the write-ahead log's
        ``PIO_WAL_FSYNC=group`` syncs once per commit group)."""
        if self.fh is not None and not self.fh.closed:
            os.fsync(self.fh.fileno())

    def tell(self) -> int:
        """Current append offset (0 when the handle was never opened)."""
        if self.fh is None or self.fh.closed:
            return 0
        return self.fh.tell()

    def close(self) -> None:
        if self.fh is not None:
            try:
                self.fh.close()
            finally:
                self.fh = None


class _TableState:
    """Per-(app, channel) log state: its own lock plus a persistent
    append handle: appends to different tables run concurrently, and
    each append is one write (plus an optional fsync) on a long-lived
    handle."""

    __slots__ = ("lock", "_handle")

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self._handle: Optional[AppendHandle] = None

    def append(self, path: str, data: bytes) -> None:
        """Caller holds ``lock``."""
        fault_point("jsonl.append")
        if self._handle is None or self._handle.path != path:
            self._handle = AppendHandle(path)
        self._handle.append(data, fsync=_fsync_enabled())

    def close(self) -> None:
        """Caller holds ``lock``."""
        if self._handle is not None:
            self._handle.close()


class JSONLEvents(base.LEvents):
    """LEvents + bulk scan over append-only logs."""

    def __init__(self, basedir: str) -> None:
        self._dir = basedir
        os.makedirs(basedir, exist_ok=True)
        # _meta guards only the table/scan REGISTRIES; all file and scan
        # work happens under the per-table lock. Lock order: a table
        # lock may be held while taking _meta, never the reverse.
        self._meta = threading.Lock()
        self._tables: dict[str, _TableState] = {}
        self._scans: dict[str, _LogScan] = {}
        # partitioned event log (data/api/event_log.py): a multi-worker
        # event server gives each worker PIO_EVENT_PARTITION=i — its
        # appends land in its OWN shard (events_<app>[_<chan>].p<i>) while
        # reads merge every shard, so any worker answers any query.
        # Without the env var, every file is the single-log layout's.
        part = envknobs.env_str("PIO_EVENT_PARTITION", "")
        self._partition = int(part) if part.isdigit() else None
        # merged-view cache: (app, chan) -> ((paths, sizes), _LogScan)
        self._merged: dict = {}
        # one-shot windowed views: (app, chan) -> (cache key, _LogScan).
        # Kept OUT of the incremental caches above — those must stay
        # the full view; a windowed build skips whole generations and
        # can never be extended into an unwindowed answer.
        self._windowed: dict = {}

    # -- paths ------------------------------------------------------------
    def _base_path(self, app_id: int, channel_id: Optional[int]) -> str:
        suffix = f"_{channel_id}" if channel_id is not None else ""
        return os.path.join(self._dir, f"events_{app_id}{suffix}.jsonl")

    def _path(self, app_id: int, channel_id: Optional[int]) -> str:
        """The WRITE path: this process's own shard."""
        base = self._base_path(app_id, channel_id)
        if self._partition is None:
            return base
        return f"{base[:-6]}.p{self._partition}.jsonl"

    @property
    def events_dir(self) -> str:
        """Directory holding this namespace's JSONL logs (the public
        spelling of what `pio status` and the log tailer need — callers
        should stop reaching for the private ``_dir``)."""
        return self._dir

    def _read_paths(self, app_id: int, channel_id: Optional[int]) -> list:
        """Every shard of this (app, channel) log on disk, base first
        then partitions in index order — the merge order of the
        partitioned read view (shared naming contract:
        :func:`shard_paths`)."""
        return shard_paths(self._dir, app_id, channel_id)

    def _state(self, path: str) -> _TableState:
        with self._meta:
            state = self._tables.get(path)
            if state is None:
                state = self._tables[path] = _TableState()
            return state

    def _scan(self, app_id: int, channel_id: Optional[int],
              window: Optional[tuple] = None) -> _LogScan:
        path = self._path(app_id, channel_id)
        read_paths = self._read_paths(app_id, channel_id)
        if read_paths and read_paths != [path]:
            # other shards exist (multi-worker layout, or an operator
            # reading a partitioned dir): serve the merged view
            return self._merged_scan(app_id, channel_id, read_paths,
                                     window)
        if window is not None:
            with self._meta:
                cached = self._scans.get(path)
            if cached is None or cached.cols is None:
                # cold windowed read: a one-shot chain load that skips
                # out-of-window generations outright. A WARM cache is
                # already decoded — the row filter is free there, so it
                # is served below as usual.
                return self._windowed_scan((app_id, channel_id), [path],
                                           window)
        state = self._state(path)
        with self._meta:
            scan = self._scans.setdefault(path, _LogScan())
        with state.lock:
            scan.refresh(path)
            return scan

    def _windowed_scan(self, key: tuple, paths: list,
                       window: tuple) -> _LogScan:
        """One-shot windowed view over a log's shards: per shard, the
        generation chain loads WITH the event-time window so disjoint
        generations are skipped whole (zero decode) — only boundary
        generations and the uncovered tails are materialized, and the
        caller's row-wise time filter does the rest. Cached per
        (app, channel) keyed on (paths, window, sizes): training reads
        are episodic, one slot suffices, and any append invalidates.
        Multi-shard delete semantics match the merged view
        (id-global)."""
        sizes = []
        for p in paths:
            try:
                sizes.append(os.path.getsize(p))
            except OSError:
                sizes.append(0)
        ck = (tuple(paths), tuple(window), tuple(sizes))
        with self._meta:
            got = self._windowed.get(key)
            if got is not None and got[0] == ck:
                return got[1]
        start_us, until_us = window
        scan = _LogScan()
        consumed = 0
        for p in paths:
            chain = _try_chain(p, start_us, until_us)
            if chain is not None:
                start = _fold_chain(scan, p, chain)
            else:
                start = _parse_floor(p)
            try:
                with open(p, "rb") as f:
                    f.seek(start)
                    buf = f.read()
            except OSError:
                buf = b""
            cut = buf.rfind(b"\n") + 1
            if cut:
                scan._absorb(parse_events(buf[:cut]))
            consumed += start + cut
        if scan.cols is None:
            scan.cols = parse_events(b"")
        scan.size = consumed
        if len(paths) > 1:
            # id-global deletes across shards, exactly like the merged
            # view: every tombstone (including those replayed from
            # skipped generations) pins to the end of this view
            n = len(scan.cols)
            for tid in scan.cols.tombstones:
                scan.tombstones[tid] = n
            for tid in list(scan.tombstones):
                scan.tombstones[tid] = n
        with self._meta:
            self._windowed[key] = (ck, scan)
        return scan

    def _merged_scan(self, app_id: int, channel_id: Optional[int],
                     paths: list, window: Optional[tuple] = None
                     ) -> _LogScan:
        """Merged view over every shard of one log, extended
        incrementally.

        Foreign shards are appended by OTHER live processes, so each is
        consumed up to its last complete line. The cache probe is
        stat-only; when shards grew, only their NEW bytes are parsed
        and merged in via ``_extend`` (same remap machinery as the
        single-log incremental refresh) — a read costs O(new bytes),
        not O(total log). A shard that shrank (rewrite/removal) or a
        changed shard set rebuilds from scratch.

        Delete semantics in the merged view are **id-global**: a
        tombstone kills every record of that event id, across all
        shards and regardless of order. Positional ordering between
        independently-appended shards is not meaningful (and deletes
        route to an arbitrary worker), so re-inserting a previously
        deleted explicit eventId is NOT supported here — the delete
        wins. Single-log deployments keep exact positional semantics."""
        key = (app_id, channel_id)
        if window is not None:
            with self._meta:
                probe = self._merged.get(key)
                warm = (probe is not None
                        and probe.get("parsed") is not None
                        and probe["paths"] == tuple(paths))
            if not warm:
                # cold windowed read: build the one-shot skipping view
                # instead of decoding every generation into the cache
                return self._windowed_scan(key, paths, window)
        with self._meta:
            entry = self._merged.get(key)
            if entry is not None and entry["paths"] != tuple(paths):
                entry = None  # shard set changed: rebuild
            if entry is None:
                entry = self._merged[key] = {
                    "paths": tuple(paths), "parsed": None,
                    "scan": None, "lock": threading.Lock(),
                }
        with entry["lock"]:
            sizes = []
            for p in paths:  # cache probe is stat-only
                try:
                    sizes.append(os.path.getsize(p))
                except OSError:
                    sizes.append(0)
            parsed = entry["parsed"]
            if parsed is not None and any(
                    s < done for s, done in zip(sizes, parsed)):
                parsed = None  # a shard shrank: rebuild below
            if parsed is not None:
                scan = entry["scan"]
                for i, p in enumerate(paths):
                    if sizes[i] <= parsed[i]:
                        continue
                    try:
                        with open(p, "rb") as f:
                            f.seek(parsed[i])
                            tail = f.read()
                    except OSError:
                        continue
                    cut = tail.rfind(b"\n") + 1
                    if cut:
                        scan._extend(parse_events(tail[:cut]))
                        parsed[i] += cut
            else:
                # cold (re)build: each shard seeds from its committed
                # columnar snapshot where one exists (same verified
                # load the single-log refresh uses — the compactor's
                # work is not wasted in partitioned mode), then only
                # the uncovered tail is JSON-parsed.
                parsed = []
                scan = _LogScan()

                def merge_piece(cols) -> None:
                    if scan.cols is None:
                        scan.cols = cols
                    else:
                        scan._extend(cols)

                for p in paths:
                    snap = _LogScan._try_snapshot(p)
                    if snap is not None:
                        snap_cols, start = snap[0], snap[1]
                        merge_piece(snap_cols)
                    else:
                        # no usable snapshot: JSON-parse, but never
                        # below the retired-generation floor
                        start = _parse_floor(p)
                    try:
                        with open(p, "rb") as f:
                            f.seek(start)
                            buf = f.read()
                    except OSError:
                        buf = b""
                    cut = buf.rfind(b"\n") + 1
                    if cut:
                        merge_piece(parse_events(buf[:cut]))
                    parsed.append(start + cut)
                if scan.cols is None:
                    scan.cols = parse_events(b"")
                entry["scan"] = scan
                entry["parsed"] = parsed
            scan.size = sum(parsed)
            # id-global deletes: every tombstone pins to the current
            # end, killing all of its id's records in this view
            n = len(scan.cols)
            for tid in scan.cols.tombstones:
                scan.tombstones[tid] = n
            return scan

    def _append(self, path: str, lines: list[str]) -> None:
        state = self._state(path)
        with state.lock:
            state.append(path, "".join(lines).encode("utf-8"))

    def close(self) -> None:
        """Release cached append handles (drain/shutdown path)."""
        with self._meta:
            states = list(self._tables.values())
        for state in states:
            with state.lock:
                state.close()

    # -- LEvents contract -------------------------------------------------
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        path = self._path(app_id, channel_id)
        state = self._state(path)
        with state.lock:
            if not os.path.exists(path):
                open(path, "a").close()
        return True

    @staticmethod
    def _remove_log_artifacts(path: str) -> None:
        """Compaction artifacts follow their log to the grave: the
        snapshot is a full columnar COPY of the data — leaving it
        behind after an app-data delete would silently retain deleted
        events on disk."""
        try:
            from ..api import event_log

            event_log.remove_artifacts(path)
        except Exception:  # noqa: BLE001 — deletion stays best-effort
            pass

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        path = self._path(app_id, channel_id)
        state = self._state(path)
        with state.lock:
            state.close()
            with self._meta:
                self._scans.pop(path, None)
                self._merged.pop((app_id, channel_id), None)
            # foreign shards of this log go too (app deletion must not
            # leave orphan partitions for a later app to merge in) —
            # but NEVER a shard whose partition lease is held: its live
            # owner has an open append handle, and unlinking under it
            # would silently ack events into a ghost inode
            for extra in self._read_paths(app_id, channel_id):
                if extra == path:
                    continue
                stem = os.path.basename(extra)[:-6]
                _b, _, suffix = stem.rpartition(".p")
                if suffix.isdigit():
                    try:
                        from ..api import event_log

                        info = event_log.lease_info(self._dir,
                                                    int(suffix))
                        # err to keeping: held=None means the lease
                        # state could not be read — assume live
                        if info is not None and info["held"] is not False:
                            import logging

                            logging.getLogger("pio.jsonl").warning(
                                "remove(%s): shard %s is owned by a "
                                "live worker (lease held); not "
                                "unlinking under it", app_id, extra)
                            continue
                    except Exception:  # noqa: BLE001 — err to keeping
                        continue
                try:
                    os.remove(extra)
                except OSError:
                    pass
                self._remove_log_artifacts(extra)
            try:
                os.remove(path)
            except OSError:
                return False
            finally:
                self._remove_log_artifacts(path)
        return True

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        import json

        eid = event.event_id or new_event_id()
        stored = event.with_event_id(eid)
        self._append(self._path(app_id, channel_id),
                     [json.dumps(stored.to_json()) + "\n"])
        return eid

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> list[str]:
        import json

        ids, lines = [], []
        for event in events:
            eid = event.event_id or new_event_id()
            ids.append(eid)
            # inject the id into the serialized dict instead of
            # dataclasses.replace-ing the event: replace re-runs
            # __init__/__post_init__ for every event
            d = event.to_json()
            d["eventId"] = eid
            lines.append(json.dumps(d) + "\n")
        self._append(self._path(app_id, channel_id), lines)
        return ids

    def insert_canonical_lines(
        self, lines: bytes, app_id: int, channel_id: Optional[int] = None
    ) -> None:
        """Append pre-serialized canonical JSONL (the native ingest fast
        path — native.ingest_batch already validated and formatted every
        line; re-parsing into Event objects here would throw that work
        away). The buffer must be newline-terminated canonical records.
        One write (+ optional fsync, PIO_INGEST_FSYNC) per call."""
        path = self._path(app_id, channel_id)
        state = self._state(path)
        with state.lock:
            state.append(path, lines)

    def _row_event(self, cols: ColumnarEvents, i: int) -> Event:
        return Event.from_json(cols.record_dict(i))

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        scan = self._scan(app_id, channel_id)
        if scan.cols is None:
            return None
        code = scan.eid_index().get(event_id)
        if code is None:
            return None
        rows = np.nonzero(scan.cols.event_id == code)[0]
        if rows.size == 0:
            return None
        last = int(rows[-1])
        # Positional tombstone check: dead only if deleted after insertion.
        if last < scan.tombstones.get(event_id, -1):
            return None
        return self._row_event(scan.cols, last)

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        return self.delete_batch([event_id], app_id, channel_id)[0]

    def delete_batch(
        self, event_ids: Sequence[str], app_id: int,
        channel_id: Optional[int] = None,
    ) -> list[bool]:
        """One scan refresh + one O(n) pass + one append for any number of
        deletes (the self-cleaning compaction path deletes in bulk)."""
        import json

        event_ids = list(event_ids)
        state = self._state(self._path(app_id, channel_id))
        with state.lock:
            scan = self._scan(app_id, channel_id)
            if scan.cols is None:
                return [False] * len(event_ids)
            index = scan.eid_index()
            ids_col = scan.cols.event_id
            n = len(scan.cols)
            # Last record position per event-id code, one vectorized pass.
            n_codes = len(scan.cols.table(ColumnarEvents.TABLE_EVENT_ID))
            last_occ = np.full(n_codes, -1, np.int64)
            with_id = ids_col >= 0
            np.maximum.at(last_occ, ids_col[with_id],
                          np.nonzero(with_id)[0])
            deleted, lines, new_dead = [], [], set()
            for event_id in event_ids:
                code = index.get(event_id)
                ok = (code is not None
                      and event_id not in new_dead
                      and int(last_occ[code]) >= scan.tombstones.get(event_id, -1))
                deleted.append(ok)
                if ok:
                    lines.append(json.dumps({"__tombstone__": event_id}) + "\n")
                    new_dead.add(event_id)
            if lines:
                # Append BEFORE mutating scan state: if the write fails the
                # cached view must keep matching the file.
                self._append(self._path(app_id, channel_id), lines)
                for event_id in new_dead:
                    scan.tombstones[event_id] = n
        return deleted

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed_order: bool = False,
    ) -> Iterator[Event]:
        scan = self._scan(app_id, channel_id)
        cols = scan.cols
        if cols is None or len(cols) == 0:
            return iter(())
        mask = scan.live_mask()

        # columnar pre-filter on interned codes (cheap numpy ops); the
        # event_matches re-check below keeps exact reference semantics for
        # whatever the columns can't express (absent times etc.)
        def code_filter(which: int, col: np.ndarray, value: Optional[str]):
            nonlocal mask
            if value is None:
                return
            # the scan's string → code dict, not a list search: the entity
            # table holds every user and item id
            code = scan.table_index(which).get(value)
            if code is None:
                mask &= False
                return
            mask = mask & (col == code)

        code_filter(ColumnarEvents.TABLE_ETYPE, cols.etype, entity_type)
        code_filter(ColumnarEvents.TABLE_EID, cols.eid, entity_id)
        code_filter(ColumnarEvents.TABLE_TETYPE, cols.tetype, target_entity_type)
        code_filter(ColumnarEvents.TABLE_TEID, cols.teid, target_entity_id)
        if event_names is not None:
            table = cols.table(ColumnarEvents.TABLE_EVENT)
            codes = [table.index(n) for n in event_names if n in table]
            mask = mask & np.isin(cols.event, np.asarray(codes, np.int32))
        s_us, u_us = _to_us(start_time), _to_us(until_time)
        if s_us is not None:
            mask = mask & (cols.time_us != _TIME_ABSENT) & (cols.time_us >= s_us)
        if u_us is not None:
            mask = mask & (cols.time_us != _TIME_ABSENT) & (cols.time_us < u_us)

        rows = np.nonzero(mask)[0]
        if reversed_order:
            # Stable DESCENDING: ties keep insertion order (matching the
            # memory backend's `sort(reverse=True)`), which a plain
            # reversal of the ascending permutation would flip.
            t = cols.time_us[rows]
            sa = np.argsort(t[::-1], kind="stable")
            order = (len(rows) - 1 - sa)[::-1]
        else:
            order = np.argsort(cols.time_us[rows], kind="stable")
        rows = rows[order]

        def gen():
            for i in rows:
                e = self._row_event(cols, int(i))
                if event_matches(e, start_time, until_time, entity_type,
                                 entity_id, event_names, target_entity_type,
                                 target_entity_id):
                    yield e

        it = gen()
        if limit is not None and limit >= 0:
            it = itertools.islice(it, limit)
        return it

    # -- bulk/columnar API (used by JSONLPEvents + PEventStore fast path) --
    def scan_columnar(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        event_names: Optional[Sequence[str]] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ) -> tuple[ColumnarEvents, np.ndarray]:
        """(columns, selected-row indices) for the training read path.

        A time-bounded request threads its window down to the scan
        layer, where a cold read skips whole out-of-window generations
        by manifest bounds (zero decode); the row filter below then
        makes the result bit-identical to filtering the full view."""
        s_us, u_us = _to_us(start_time), _to_us(until_time)
        window = ((s_us, u_us)
                  if s_us is not None or u_us is not None else None)
        scan = self._scan(app_id, channel_id, window)
        cols = scan.cols
        if cols is None:
            empty = parse_events(b"")
            return empty, np.empty(0, np.int64)
        mask = scan.live_mask()
        if event_names is not None:
            table = cols.table(ColumnarEvents.TABLE_EVENT)
            codes = [table.index(n) for n in event_names if n in table]
            mask = mask & np.isin(cols.event, np.asarray(codes, np.int32))
        if s_us is not None:
            mask = mask & (cols.time_us != _TIME_ABSENT) & (cols.time_us >= s_us)
        if u_us is not None:
            mask = mask & (cols.time_us != _TIME_ABSENT) & (cols.time_us < u_us)
        return cols, np.nonzero(mask)[0]

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        return self.aggregate_columnar(
            app_id, channel_id, entity_type=entity_type,
            start_time=start_time, until_time=until_time,
            required=required)

    def aggregate_columnar(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> dict[str, PropertyMap]:
        """$set/$unset/$delete replay directly on the columnar scan.

        Result-identical to ``base.aggregate_property_events`` over
        ``find()`` but cheaper: that path materializes a full Event per
        row (whole-record reparse + validation + DataMap), while the
        replay only ever needs each event's ``properties`` span and the
        interned entity/event/time columns. Rows without an entityId are
        skipped (the Event path would refuse them at validation).
        Externally written rows WITHOUT an eventTime mirror from_json's
        default-to-now: they sort after every timestamped event (file
        order among themselves) and report the scan time as their
        update time.
        """
        cols, rows = self.scan_columnar(
            app_id, channel_id, ["$set", "$unset", "$delete"],
            start_time, until_time)
        state = aggregate_replay(cols, rows, entity_type)

        now = _dt.datetime.now(_dt.timezone.utc)

        def us_dt(us: int) -> _dt.datetime:
            if us == _TIME_ABSENT:
                return now
            return _EPOCH + _dt.timedelta(microseconds=us)

        out = {
            eid: PropertyMap(props, us_dt(first), us_dt(last))
            for eid, (props, first, last) in state.items()
        }
        if required:
            req = set(required)
            out = {k: v for k, v in out.items() if req.issubset(v.keyset())}
        return out

    def compact(self, app_id: int, channel_id: Optional[int] = None) -> int:
        """Rewrite the log without tombstoned records; returns live count
        (the reference's SelfCleaningDataSource writes a compacted stream
        back — core/.../core/SelfCleaningDataSource.scala)."""
        path = self._path(app_id, channel_id)
        state = self._state(path)
        with state.lock:
            scan = self._scan(app_id, channel_id)
            cols = scan.cols
            if cols is None:
                return 0
            mask = scan.live_mask()
            rows = np.nonzero(mask)[0]
            tmp = path + ".compact"
            with open(tmp, "wb") as f:
                for i in rows:
                    s, e = cols.span[i]
                    f.write(cols.raw[s:e] + b"\n")
            state.close()  # the cached append handle points at the old file
            os.replace(tmp, path)
            with self._meta:
                self._scans.pop(path, None)
            return int(rows.size)


class JSONLPEvents(base.PEvents):
    def __init__(self, l_events: JSONLEvents) -> None:
        self._l = l_events

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None) -> Iterator[Event]:
        return self._l.find(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
        )

    def write(self, events: Iterable[Event], app_id: int, channel_id: Optional[int] = None) -> None:
        self._l.insert_batch(list(events), app_id, channel_id)

    def delete(self, event_ids: Iterable[str], app_id: int, channel_id: Optional[int] = None) -> None:
        self._l.delete_batch(list(event_ids), app_id, channel_id)

    def scan_columnar(self, app_id, channel_id=None, event_names=None,
                      start_time=None, until_time=None):
        return self._l.scan_columnar(
            app_id, channel_id, event_names, start_time, until_time
        )

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        return self._l.aggregate_columnar(
            app_id, channel_id, entity_type=entity_type,
            start_time=start_time, until_time=until_time,
            required=required)


class JSONLClient(base.BaseStorageClient):
    """`TYPE=JSONL`; property PATH = base directory for event logs."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        if "PATH" in config.properties:
            self._path = config.properties["PATH"]
        else:
            from .registry import base_dir

            self._path = os.path.join(base_dir(), "events")
        self._l: dict[str, JSONLEvents] = {}
        self._lock = threading.Lock()

    def l_events(self, namespace: str = "pio_eventdata") -> JSONLEvents:
        with self._lock:
            if namespace not in self._l:
                self._l[namespace] = JSONLEvents(os.path.join(self._path, namespace))
            return self._l[namespace]

    def p_events(self, namespace: str = "pio_eventdata") -> JSONLPEvents:
        return JSONLPEvents(self.l_events(namespace))

    def close(self) -> None:
        with self._lock:
            stores = list(self._l.values())
        for store in stores:
            store.close()
