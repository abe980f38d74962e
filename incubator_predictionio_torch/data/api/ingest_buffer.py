"""Write-behind group commit for event ingestion, on threads.

The port of ``incubator_predictionio_tpu/data/api/ingest_buffer.py``,
rebuilt for the threads of ``http.server``: every write handler enqueues
into a per-(app_id, channel_id) queue, and one committer thread per queue
coalesces the queued events into ONE ``insert_canonical_lines`` /
``insert_batch`` call per group, so concurrent single-event POSTs ride
the batch path.

Group formation
    A group commits when ``PIO_INGEST_GROUP_MAX`` events are queued or
    ``PIO_INGEST_GROUP_MS`` milliseconds have passed since the committer
    woke for its first event, whichever comes first. The default window
    is 0 ms: pure write-behind, where a commit starts as soon as the
    previous one finishes and everything that arrived meanwhile rides
    along. ``PIO_INGEST_GROUP=off`` commits each request on its own
    handler thread (no queue).

Ack semantics (``PIO_INGEST_ACK``, per request ``X-Pio-Ack``)
    ``commit`` (default) — the handler thread blocks on its entry's
    waiter until the group's store write returns; each POST gets its real
    event id and its real per-event error. ``enqueue`` — the answer
    leaves as soon as the validated event is queued (with the WAL: once
    its WAL append returned); commit failures are counted
    (``droppedEvents`` on ``GET /``), or deferred to the next WAL
    recovery when the WAL holds the event.

Backpressure
    Queued-but-uncommitted events are capped at
    ``PIO_INGEST_MAX_PENDING``; beyond it, or while the buffer drains,
    :class:`IngestOverloadError` is raised and the event server answers
    503 with a jittered ``Retry-After``. An append that fails with a
    disk-class ``OSError`` (ENOSPC, EDQUOT, EROFS, EIO, EMFILE, ENFILE)
    sheds the key for a doubling window (``PIO_INGEST_SHED_MS``,
    :class:`AppendShedError`).

Threads
    Handler threads and committers share one lock, held only to admit,
    enqueue and cut a group: the committer never waits on a handler
    thread, and the store write runs outside the lock. :meth:`drain`
    stops intake, lets every committer flush its queue and exit, and so
    resolves or fails every waiter; a committer that dies fails its
    queue instead of leaving waiters hanging.

Group encoding rides the event codec with no Python fallback: the codec
is loaded when the buffer is built (a failed build raises there, before
serving), a run of raw single-event bodies is validated and canonicalized
in one ``native.ingest_batch`` pass, and a run the codec hands back (a
validation failure or a client-supplied id somewhere in it) is parsed in
Python, which owns every error message. A codec error fails the group.
The fault point ``ingest.commit`` fires once per group commit.

Durability (``PIO_WAL=1``, :mod:`.ingest_wal`)
    An enqueue-mode event is appended to its key's WAL segment before its
    ack, and a commit-mode group's lines are appended (one frame) before
    the store write. After the store confirms, a commit marker covers the
    group's records; a store failure reported to waiting clients writes
    an abort marker instead, while enqueue-acked events whose commit
    failed stay uncommitted in the WAL: deferred to the next recovery.
"""

from __future__ import annotations

import collections
import errno
import json
import logging
import threading
import time
from collections import Counter
from typing import Optional, Sequence

from ... import native
from ...common import envknobs, telemetry
from ...common.faultinject import fault_point
from ..storage.event import (Event, EventValidationError, _utcnow,
                             format_event_time, new_event_id)
from .event_log import IngestOverloadError

log = logging.getLogger("pio.torch.ingest")

__all__ = ["AppendShedError", "ForbiddenEventError", "IngestBuffer",
           "IngestConfig", "IngestOverloadError", "classify_append_error",
           "parse_single_event"]

_M_QUEUE_WAIT = telemetry.registry().histogram(
    "pio_ingest_queue_wait_seconds",
    "Time an event waits in the write-behind buffer before its group "
    "commit is formed").labels()
_M_COMMIT = telemetry.registry().histogram(
    "pio_ingest_commit_seconds",
    "Storage commit duration per ingest group").labels()
_M_GROUP_SIZE = telemetry.registry().histogram(
    "pio_ingest_group_size",
    "Events coalesced per group commit",
    lo_exp=0, n_buckets=14, scale=1).labels()
_M_DROPPED = telemetry.registry().counter(
    "pio_ingest_dropped_events_total",
    "Enqueue-acked events dropped because their group commit "
    "failed").labels()
_M_DEFERRED = telemetry.registry().counter(
    "pio_wal_deferred_events_total",
    "Enqueue-acked events whose group commit failed but which remain "
    "in the WAL for the next recovery pass (not lost)").labels()
_M_APPEND_ERRORS = telemetry.registry().counter(
    "pio_ingest_append_errors_total",
    "OSErrors raised by a WAL/event-log append, by errno class; "
    "resource-exhaustion kinds flip the partition to shed mode",
    ("kind",))

Key = tuple[int, Optional[int]]


class AppendShedError(IngestOverloadError):
    """A WAL/event-log append failed with a resource-exhaustion OSError
    (disk full, quota, read-only remount, I/O error): the key sheds
    writes (503 + jittered Retry-After) for a doubling backoff window, so
    a full disk is not hammered into a corrupt log tail."""

    def __init__(self, message: str, kind: str, retry_after: float):
        super().__init__(message, retry_after=retry_after)
        self.kind = kind


#: errno → counter label; membership also defines which append failures
#: shed (``AppendShedError``)
_SHED_ERRNOS = {
    errno.ENOSPC: "enospc",
    errno.EDQUOT: "edquot",
    errno.EROFS: "erofs",
    errno.EIO: "eio",
    errno.EMFILE: "emfile",
    errno.ENFILE: "enfile",
}


def classify_append_error(e: BaseException) -> Optional[str]:
    """Kind label for an append-path OSError, or None for other failures
    (a ConnectionError — an injected or remote fault — is not a disk
    fault)."""
    if not isinstance(e, OSError) or isinstance(e, ConnectionError):
        return None
    if e.errno is None:
        return None
    return _SHED_ERRNOS.get(e.errno, "oserr")


class ForbiddenEventError(PermissionError):
    """Event name not in the access key's allow-list (maps to 403)."""


def parse_single_event(raw: bytes, whitelist=()) -> tuple[Event, dict]:
    """The one raw body → Event path (the group commit's and the
    ack=enqueue handler's): strict JSON, dict-shaped, server-assigned
    creationTime, Event validation, the key's allow-list. Raises
    EventValidationError (400) or ForbiddenEventError (403); either
    carries the parsed ``body`` for the stats."""
    try:
        body = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError):
        raise EventValidationError("invalid JSON body") from None
    if not isinstance(body, dict):
        raise EventValidationError("event body must be a JSON object")
    body.pop("creationTime", None)  # server-assigned on ingest
    try:
        event = Event.from_json(body)
    except EventValidationError as e:
        e.body = body
        raise
    if whitelist and event.event not in whitelist:
        err = ForbiddenEventError(
            f"event {event.event!r} is not allowed for this access key")
        err.body = body
        raise err
    return event, body


class IngestConfig:
    """Resolved group-commit knobs (all overridable via environment)."""

    __slots__ = ("enabled", "group_max", "group_ms", "ack", "max_pending")

    def __init__(self, enabled: bool = True, group_max: int = 256,
                 group_ms: float = 0.0, ack: str = "commit",
                 max_pending: int = 10_000):
        self.enabled = enabled
        self.group_max = max(1, group_max)
        self.group_ms = max(0.0, group_ms)
        self.ack = ack if ack in ("commit", "enqueue") else "commit"
        self.max_pending = max(1, max_pending)

    @classmethod
    def from_env(cls) -> "IngestConfig":
        mode = envknobs.env_str("PIO_INGEST_GROUP", "auto")
        return cls(
            enabled=mode not in ("off", "0", "false", "no"),
            group_max=envknobs.env_int("PIO_INGEST_GROUP_MAX", 256),
            group_ms=envknobs.env_float("PIO_INGEST_GROUP_MS", 0.0),
            ack=envknobs.env_str("PIO_INGEST_ACK", "commit"),
            max_pending=envknobs.env_int("PIO_INGEST_MAX_PENDING", 10_000),
        )

    def to_json(self) -> dict:
        return {"enabled": self.enabled, "groupMax": self.group_max,
                "groupMs": self.group_ms, "ack": self.ack,
                "maxPending": self.max_pending}


_RAW, _EVENT, _EVENTS, _LINES = 0, 1, 2, 3


class _Waiter:
    """A commit-mode request's slot: its handler thread blocks in
    :meth:`wait` until the committer settles it."""

    __slots__ = ("_done", "_result", "_error")

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def settle(self, res) -> None:
        if isinstance(res, BaseException):
            self._error = res
        else:
            self._result = res
        self._done.set()

    def wait(self):
        self._done.wait()
        if self._error is not None:
            raise self._error
        return self._result


class _Pending:
    """One queued submission: a raw single-event body (the hot path), a
    validated Event, a whole validated multi-event request (``/batch``:
    one entry, so it never straddles a group and never partially
    commits), or pre-encoded canonical lines (the batch codec path).
    ``waiter`` is None for fire-and-forget (ack=enqueue)."""

    __slots__ = ("kind", "payload", "body", "ids", "whitelist", "waiter",
                 "n", "t_enq", "lsns", "wal_line", "trace")

    def __init__(self, kind: int, payload, body=None, ids=None,
                 whitelist=(), waiter=None, n=1):
        self.kind = kind
        self.payload = payload
        self.body = body          # parsed dict(s) for stats/plugins
        self.ids = ids            # preset event id(s)
        self.whitelist = whitelist
        self.waiter = waiter
        self.n = n                # events carried (EVENTS/LINES may be > 1)
        self.t_enq = 0            # queue-wait timer (0 = not stamped)
        self.lsns = None          # WAL record LSNs (pre-ack append)
        self.wal_line = None      # the exact bytes the WAL holds
        self.trace = None         # the sampled request's Trace, if any


class _KeyState:
    __slots__ = ("deque", "cv", "thread", "pending_events", "pending_multi")

    def __init__(self, lock):
        self.deque: collections.deque[_Pending] = collections.deque()
        self.cv = threading.Condition(lock)
        self.thread: Optional[threading.Thread] = None
        self.pending_events = 0
        self.pending_multi = 0  # queued entries already carrying >1 event


class IngestBuffer:
    """Per-key write-behind queues and committer threads over one
    storage."""

    def __init__(self, storage, stats, plugins,
                 config: Optional[IngestConfig] = None, wal=None,
                 lease=None):
        self.storage = storage
        self.stats = stats
        self.plugins = plugins
        self.config = config or IngestConfig.from_env()
        self.wal = wal            # IngestWal or None (PIO_WAL off)
        # partition lease (event_log.Lease) of a multi-worker worker: its
        # epoch is verified before EVERY write group and every pre-ack
        # WAL append, so a fenced worker lands no byte
        self.lease = lease
        self._lock = threading.Lock()
        self._keys: dict[Key, _KeyState] = {}
        self._pending = 0
        self._draining = False
        # disk-fault shed mode: key -> (monotonic shed-until, streak)
        self._shed: dict[Key, tuple[float, int]] = {}
        self._shed_window = envknobs.env_float(
            "PIO_INGEST_SHED_MS", 5000.0, lo=100.0) / 1000.0
        # observability (GET / and tests)
        self.groups_committed = 0
        self.events_committed = 0
        self.max_group = 0
        self.dropped = 0
        self.deferred = 0         # enqueue-acked, commit failed, in WAL
        self.shed_appends = 0     # requests refused while in shed mode
        # the codec encodes every raw run of a group: build or load it
        # now, before serving (a failed build raises here)
        if storage is not None and hasattr(storage.get_l_events(),
                                           "insert_canonical_lines"):
            native.load()

    @property
    def ack_on_enqueue(self) -> bool:
        return self.config.enabled and self.config.ack == "enqueue"

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "enabled": self.config.enabled,
                "pending": self._pending,
                "groupsCommitted": self.groups_committed,
                "eventsCommitted": self.events_committed,
                "maxGroup": self.max_group,
                "droppedEvents": self.dropped,
            }
            shed_values = list(self._shed.values())
            if self.shed_appends or shed_values:
                now = time.monotonic()
                out["shedAppends"] = self.shed_appends
                out["shedding"] = sum(
                    1 for until, _ in shed_values if until > now)
            if self.wal is not None:
                out["deferredEvents"] = self.deferred
        if self.lease is not None:
            out["lease"] = self.lease.to_json()
        if self.wal is not None:
            out["wal"] = self.wal.snapshot()
        return out

    # -- submission (handler threads) ----------------------------------------
    def _admit(self, n: int, shed: Optional[tuple] = None) -> None:
        """Caller holds ``_lock``; ``shed`` is the key's entry of the shed
        map, which the caller reads under that lock."""
        if self._draining:
            raise IngestOverloadError("event server is shutting down")
        if shed is not None:
            remaining = shed[0] - time.monotonic()
            if remaining > 0:
                self.shed_appends += 1
                raise AppendShedError(
                    "event log partition is shedding writes after a "
                    "disk error; retry later", kind="shed",
                    retry_after=max(1.0, remaining))
        if self._pending + n > self.config.max_pending:
            raise IngestOverloadError(
                f"ingest buffer full ({self._pending} events pending); "
                "retry later",
                retry_after=max(1.0, self.config.group_ms / 1000.0))

    def _note_append_error(self, key: Key, kind: str) -> float:
        """Flip (or extend) shed mode for this key after a disk-class
        append failure; returns the window length (doubling, capped at
        60 s; the first request after it probes the disk again)."""
        with self._lock:
            prev = self._shed.get(key)
            streak = (prev[1] + 1) if prev is not None else 0
            window = min(60.0, self._shed_window * (2.0 ** streak))
            self._shed[key] = (time.monotonic() + window, streak)
        _M_APPEND_ERRORS.labels(kind).inc()
        log.error("append failed (%s) for %s: shedding writes for "
                  "%.1fs", kind, key, window)
        return window

    def _note_append_ok(self, key: Key) -> None:
        with self._lock:
            if self._shed:
                self._shed.pop(key, None)

    def _enqueue_locked(self, key: Key, entry: _Pending) -> None:
        """Caller holds ``_lock`` (and has admitted the entry)."""
        st = self._keys.get(key)
        if st is None:
            st = self._keys[key] = _KeyState(self._lock)
            st.thread = threading.Thread(
                target=self._run_key, args=(key, st), daemon=True,
                name=f"pio-ingest-{key[0]}-{key[1]}")
            st.thread.start()
        entry.t_enq = telemetry.timer_start()
        entry.trace = telemetry.current_trace()
        st.deque.append(entry)
        st.pending_events += entry.n
        if entry.n > 1:
            st.pending_multi += 1
        self._pending += entry.n
        st.cv.notify()

    def _submit(self, key: Key, entry: _Pending):
        """Commit ``entry`` with its group and return its result (raises
        its error); without group commit, commit it on this thread."""
        if not self.config.enabled:
            return self._passthrough(key, entry)
        entry.waiter = _Waiter()
        with self._lock:
            self._admit(entry.n, self._shed.get(key))
            self._enqueue_locked(key, entry)
        return entry.waiter.wait()

    def _passthrough(self, key: Key, entry: _Pending):
        with self._lock:
            self._admit(entry.n, self._shed.get(key))
            self._pending += entry.n
        t_commit = telemetry.timer_start()
        try:
            res = self._commit_group(key, [entry])[0]
        finally:
            with self._lock:
                self._pending -= entry.n
                self._note_group_locked(entry.n)
        _M_COMMIT.observe_since(t_commit)
        if isinstance(res, BaseException):
            raise res
        return res

    def ingest_raw(self, raw: bytes, access_key, channel_id) -> str:
        """Single-event POST hot path: the raw body is queued as-is and
        validated inside the group commit (one codec pass when the whole
        run qualifies). Returns the stored event id; raises
        EventValidationError / ForbiddenEventError / storage errors."""
        return self._submit((access_key.appid, channel_id), _Pending(
            _RAW, raw, whitelist=access_key.events or ()))

    def ingest_event(self, event: Event, body: Optional[dict],
                     access_key, channel_id) -> str:
        """A pre-validated single event (webhooks)."""
        return self._submit((access_key.appid, channel_id),
                            _Pending(_EVENT, event, body=body))

    def ingest_events(self, events_bodies: Sequence[tuple],
                      access_key, channel_id) -> list[str]:
        """A validated multi-event request (``/batch/events.json``'s
        Python path): ONE queue entry, committed atomically — a storage
        failure means nothing of this request persisted, so the client
        may retry without duplicating. Returns the ids in order."""
        return self._submit((access_key.appid, channel_id), _Pending(
            _EVENTS, [ev for ev, _ in events_bodies],
            body=[b for _, b in events_bodies], n=len(events_bodies)))

    def ingest_lines(self, lines: bytes, ids: list[str],
                     access_key, channel_id) -> list[str]:
        """Pre-encoded canonical JSONL (the batch codec path, ids already
        assigned); commits with the group."""
        return self._submit((access_key.appid, channel_id),
                            _Pending(_LINES, lines, ids=ids, n=len(ids)))

    def enqueue_event(self, event: Event, body: Optional[dict],
                      access_key, channel_id) -> str:
        """Fire-and-forget (ack=enqueue): assign the id now and return as
        soon as the event is queued. With the WAL on, the record is
        appended (and per policy fsynced) BEFORE this returns. Admission
        runs first (a shed 503 must leave nothing in the WAL: the client
        retries, and a leftover record would replay into a duplicate), and
        nothing sheds after the append."""
        key = (access_key.appid, channel_id)
        eid = event.event_id or new_event_id()
        entry = _Pending(_EVENT, event, body=body, ids=[eid])
        with self._lock:
            self._admit(1, self._shed.get(key))
            if self.wal is None:
                self._enqueue_locked(key, entry)
                return eid
            # reserved across the append, so concurrent requests cannot
            # all pass admission against the same count
            self._pending += 1
        try:
            self._wal_append_entry(key, entry)
        finally:
            with self._lock:
                self._pending -= 1
        with self._lock:
            if not self._draining:
                self._enqueue_locked(key, entry)
                return eid
            # the drain began during the append: the record is durable in
            # the WAL, so the next recovery lands it; the ack stays honest
            self.deferred += 1
        _M_DEFERRED.inc(1)
        log.warning("deferred 1 enqueue-acked event to WAL replay: "
                    "accepted during drain")
        return eid

    def _wal_append_entry(self, key: Key, entry: _Pending) -> None:
        """WAL-append one pre-validated entry ahead of its ack, stashing
        the canonical line so the later store write appends the bytes the
        WAL holds. A fenced lease and a disk fault surface as the 503 shed
        (the ack was never sent: the client owns the retry)."""
        if self.lease is not None:
            self.lease.verify()
        d = entry.payload.to_json()
        d["eventId"] = entry.ids[0]
        entry.wal_line = json.dumps(d).encode("utf-8") + b"\n"
        try:
            entry.lsns = [self.wal.append_events(key, entry.wal_line, 1)]
        except OSError as e:
            kind = classify_append_error(e)
            if kind is None:
                raise
            window = self._note_append_error(key, kind)
            raise AppendShedError(
                f"WAL append failed ({kind}): {e}", kind=kind,
                retry_after=window) from e

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop intake, let every committer flush its queue and exit
        (settling every waiter). False when ``timeout`` passed first."""
        with self._lock:
            self._draining = True
            states = list(self._keys.values())
            for st in states:
                st.cv.notify_all()
        deadline = None if timeout is None else time.monotonic() + timeout
        for st in states:
            left = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            st.thread.join(left)
        return not any(st.thread.is_alive() for st in states)

    # -- committers (one thread per key) -------------------------------------
    def _run_key(self, key: Key, st: _KeyState) -> None:
        """The committer must never die silently: if its loop raises,
        every queued request is failed (not hung) and the key slot is
        cleared, so the next submit starts a fresh committer."""
        try:
            self._flush_loop(key, st)
        except BaseException as e:  # noqa: BLE001 - fail the queue, re-raise
            log.exception("ingest committer for %s died; failing its queue",
                          key)
            with self._lock:
                doomed = list(st.deque)
                st.deque.clear()
                for entry in doomed:
                    self._pending -= entry.n
                st.pending_events = st.pending_multi = 0
                if self._keys.get(key) is st:
                    del self._keys[key]
            for entry in doomed:
                if entry.waiter is not None:
                    entry.waiter.settle(e)
            raise

    def _cut_group(self, st: _KeyState) -> Optional[list]:
        """Wait for work and cut the next group; None once drained. Caller
        holds ``_lock`` (through ``st.cv``)."""
        cfg = self.config
        while not st.deque:
            if self._draining:
                return None
            st.cv.wait()
        if (cfg.group_ms > 0 and not self._draining
                and st.pending_events < cfg.group_max
                and not st.pending_multi):
            # collection window, cut short the moment the group fills;
            # skipped for a queued wire batch (already coalesced)
            deadline = time.monotonic() + cfg.group_ms / 1000.0
            while not (st.pending_events >= cfg.group_max
                       or st.pending_multi or self._draining):
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                st.cv.wait(left)
        group: list[_Pending] = []
        n_events = 0
        while st.deque and n_events < cfg.group_max:
            nxt = st.deque[0]
            if group and n_events + nxt.n > cfg.group_max:
                break
            st.deque.popleft()
            _M_QUEUE_WAIT.observe_since(nxt.t_enq)
            group.append(nxt)
            n_events += nxt.n
            if nxt.n > 1:
                st.pending_multi -= 1
        return group

    def _flush_loop(self, key: Key, st: _KeyState) -> None:
        while True:
            with self._lock:
                group = self._cut_group(st)
            if group is None:
                return
            n_events = sum(e.n for e in group)
            t_commit = telemetry.timer_start()
            t0 = time.perf_counter_ns()
            try:
                results = self._commit_group(key, group)
            except Exception as e:  # noqa: BLE001 - settled per request
                log.exception("ingest group commit failed")
                results = [e] * len(group)
            _M_COMMIT.observe_since(t_commit)
            # the sampled requests of the group see the commit they rode
            traces = {id(e.trace): e.trace for e in group
                      if e.trace is not None}
            for tr in traces.values():
                tr.add_span("ingest.group_commit",
                            time.perf_counter_ns() - t0, key=str(key),
                            events=n_events)
            with self._lock:
                st.pending_events -= n_events
                self._pending -= n_events
                self._note_group_locked(n_events)
                for entry, res in zip(group, results):
                    if entry.waiter is None and isinstance(res, Exception):
                        if self.wal is not None and entry.lsns:
                            self.deferred += entry.n
                        else:
                            self.dropped += entry.n
            for entry, res in zip(group, results):
                if entry.waiter is not None:
                    entry.waiter.settle(res)
                elif isinstance(res, Exception):
                    if self.wal is not None and entry.lsns:
                        # the pre-ack WAL record is still uncommitted: the
                        # next recovery pass lands it
                        _M_DEFERRED.inc(entry.n)
                        log.error("deferred %d enqueue-acked event(s) to "
                                  "WAL replay: %s", entry.n, res)
                    else:
                        _M_DROPPED.inc(entry.n)
                        log.error("dropped %d enqueue-acked event(s): %s",
                                  entry.n, res)

    def _note_group_locked(self, n_events: int) -> None:
        self.groups_committed += 1
        self.events_committed += n_events
        if n_events > self.max_group:
            self.max_group = n_events
        _M_GROUP_SIZE.observe_raw(n_events)

    # -- commit (committer or handler thread) --------------------------------
    def _commit_group(self, key: Key, group: list[_Pending]) -> list:
        """Validate/encode every entry and persist all surviving events in
        ONE storage call, recording stats once. Returns one result per
        entry in order: the event id (RAW/EVENT), the id list
        (EVENTS/LINES), or the exception that failed it. Validation
        failures stay per entry; a storage fault fails exactly the entries
        that rode the write."""
        app_id, channel_id = key
        if self.lease is not None:
            # fenced ownership: a stale epoch raises PartitionFencedError
            # for the whole group before any WAL or store byte lands
            self.lease.verify()
        le = self.storage.get_l_events()
        supports_lines = hasattr(le, "insert_canonical_lines")
        wal_on = self.wal is not None
        results: list = [None] * len(group)
        stat_counts: Counter = Counter()
        lines_parts: list[bytes] = []
        events_plan: list[tuple[Event, str]] = []
        committed: list[int] = []     # entry positions riding the write
        wal_parts: list[bytes] = []   # lines not yet in the WAL
        wal_events = 0
        prewal_lsns: list[int] = []   # enqueue-mode records already there

        def plan_event(event: Event, preset: Optional[str]) -> str:
            nonlocal wal_events
            eid = preset or event.event_id or new_event_id()
            line = None
            if supports_lines or wal_on:
                d = event.to_json()
                d["eventId"] = eid
                line = json.dumps(d).encode("utf-8") + b"\n"
            if wal_on:
                wal_parts.append(line)
                wal_events += 1
            if supports_lines:
                lines_parts.append(line)
            else:
                events_plan.append((event, eid))
            return eid

        def parse_raw(pos: int, entry: _Pending) -> None:
            try:
                event, body = parse_single_event(entry.payload,
                                                 entry.whitelist)
            except (EventValidationError, ForbiddenEventError) as e:
                results[pos] = e
                b = getattr(e, "body", None) or {}
                status = 403 if isinstance(e, ForbiddenEventError) else 400
                stat_counts[(app_id, b.get("event", "?"),
                             b.get("entityType", "?"), status)] += 1
                return
            entry.body = body
            results[pos] = plan_event(
                event, entry.ids[0] if entry.ids else None)
            committed.append(pos)

        # the codec's one pass needs no per-event Python: no stats, no
        # plugins (both read each event's body)
        codec_ok = (supports_lines and self.stats is None
                    and not self.plugins.plugins)
        i = 0
        while i < len(group):
            entry = group[i]
            if entry.kind == _LINES:
                lines_parts.append(entry.payload)
                if wal_on:
                    wal_parts.append(entry.payload)
                    wal_events += entry.n
                results[i] = entry.ids
                committed.append(i)
                i += 1
                continue
            if entry.kind == _EVENT:
                if entry.lsns is not None:
                    # WAL'd before its ack: the store gets the bytes the
                    # WAL holds, and its LSN rides this group's marker
                    prewal_lsns.extend(entry.lsns)
                    eid = entry.ids[0]
                    if supports_lines:
                        lines_parts.append(entry.wal_line)
                    else:
                        events_plan.append((entry.payload, eid))
                    results[i] = eid
                else:
                    results[i] = plan_event(
                        entry.payload, entry.ids[0] if entry.ids else None)
                committed.append(i)
                i += 1
                continue
            if entry.kind == _EVENTS:
                results[i] = [plan_event(ev, None) for ev in entry.payload]
                committed.append(i)
                i += 1
                continue
            # RAW: the longest contiguous run goes through ONE codec pass
            j = i
            while (j < len(group) and group[j].kind == _RAW
                   and not group[j].whitelist and group[j].ids is None):
                j += 1
            run = group[i:j] if (codec_ok and j > i) else []
            nat = None
            if run:
                # None is the codec handing the run back (an invalid
                # event or a client id somewhere in it); an error raises
                # and fails the group — there is no Python fallback
                nat = native.ingest_batch(
                    b"[" + b",".join(e.payload for e in run) + b"]",
                    len(run), format_event_time(_utcnow()))
            if nat is not None:
                ids, lines = nat
                lines_parts.append(lines)
                if wal_on:
                    wal_parts.append(lines)
                    wal_events += len(ids)
                for off, eid in enumerate(ids):
                    results[i + off] = eid
                    committed.append(i + off)
                i = j
                continue
            if run:
                # the handed-back run is parsed in Python once, with
                # per-event errors
                for off, e in enumerate(run):
                    parse_raw(i + off, e)
                i = j
                continue
            parse_raw(i, entry)
            i += 1

        if committed:
            storage_error = None
            group_lsn = None
            try:
                if wal_on:
                    # WAL before store: the group's not-yet-logged lines
                    # become ONE frame, synced per policy, before the
                    # store can confirm (or ingest.commit can fire). A
                    # sync failure after the frame landed takes the abort
                    # path below.
                    if wal_parts:
                        group_lsn = self.wal.append_events(
                            key, b"".join(wal_parts), wal_events)
                    self.wal.sync(key)
                fault_point("ingest.commit")
                if supports_lines:
                    le.insert_canonical_lines(b"".join(lines_parts),
                                              app_id, channel_id)
                else:
                    ids = le.insert_batch(
                        [e.with_event_id(eid) for e, eid in events_plan],
                        app_id, channel_id)
                    for (_e, eid), got in zip(events_plan, ids,
                                              strict=True):
                        if got != eid:  # pragma: no cover - contract
                            raise RuntimeError(
                                f"backend rewrote event id {eid} -> {got}")
            except Exception as e:  # noqa: BLE001 - reported per request
                storage_error = e
                kind = classify_append_error(e)
                if kind is not None:
                    window = self._note_append_error(key, kind)
                    storage_error = AppendShedError(
                        f"event log append failed ({kind}): {e}",
                        kind=kind, retry_after=window)
                    storage_error.__cause__ = e
            if storage_error is not None:
                if wal_on and group_lsn is not None:
                    # the group frame's events belong to requests being
                    # TOLD the commit failed: an abort marker keeps replay
                    # from resurrecting them. Pre-acked records stay
                    # uncommitted (deferred to replay, not dropped).
                    try:
                        self.wal.abort(key, [group_lsn])
                    except OSError:
                        log.exception("WAL abort marker failed")
                for pos in committed:
                    results[pos] = storage_error
            else:
                self._note_append_ok(key)
                if wal_on:
                    try:
                        fault_point("wal.mark")
                        self.wal.commit(key, prewal_lsns + (
                            [group_lsn] if group_lsn is not None else []))
                    except OSError:
                        # the data IS in the store; a missing marker costs
                        # a replay that dedups
                        log.exception(
                            "WAL commit marker failed; replay will dedup")
                for pos in committed:
                    entry = group[pos]
                    if self.stats is not None:
                        if entry.kind == _LINES:
                            stat_counts[(app_id, "?", "?", 201)] += entry.n
                        elif entry.kind == _EVENTS:
                            for b in (entry.body or []):
                                b = b or {}
                                stat_counts[(app_id, b.get("event", "?"),
                                             b.get("entityType", "?"),
                                             201)] += 1
                        else:
                            b = entry.body or {}
                            stat_counts[(app_id, b.get("event", "?"),
                                         b.get("entityType", "?"),
                                         201)] += 1
                    if self.plugins.plugins and entry.body is not None:
                        if entry.kind == _EVENTS:
                            for b in entry.body:
                                if b is not None:
                                    self.plugins.on_event(b)
                        else:
                            self.plugins.on_event(entry.body)
        if self.stats is not None and stat_counts:
            self.stats.record_many(stat_counts)
        return results
