"""Crash-durable ingestion: a per-(app, channel) write-ahead log.

The port's own copy of ``incubator_predictionio_tpu/data/api/
ingest_wal.py``: the same frames, segment names, key directories, markers
and directory lock, so a WAL that either package wrote replays in the
other.

The write-behind buffer (ingest_buffer.py) acks events that are not yet
in the backing store: ``PIO_INGEST_ACK=enqueue`` acks before ANY storage
write, and even ``commit``-mode groups in flight at a SIGKILL vanish
silently. This module closes that window the way HBase closes it: every event is appended to a WAL segment — canonical
native-codec JSONL line(s) framed with a per-record CRC — *before* its
ack in enqueue mode and before the group's backing-store commit in
commit mode. Once the backing store confirms a group, a commit marker
covers its records and fully-committed segments are deleted
(truncation). On event-server startup a recovery pass scans the WAL
directory, tolerates a torn tail (CRC-checked suffix discard), and
replays uncommitted records through the ingest buffer's own commit
path, idempotently deduped by event_id against what DID land before
the crash — so every acked event is present exactly once after a
restart.

Frame format (one segment file = a sequence of frames, no header; the
file name carries the sequence number):

    <kind:u8> <payload_len:u32> <lsn:u64> <crc32:u32> <payload>

(the CRC covers the header prefix AND the payload, so a flipped kind
or LSN byte reads as corruption rather than a valid frame with the
wrong identity)

- kind ``E`` — payload is one or more newline-terminated canonical
  event lines (the exact bytes the JSONL store appends); ``lsn`` is the
  per-key log sequence number of this record.
- kind ``C`` — commit marker: payload is a packed u64 array of the LSNs
  whose events the backing store has confirmed.
- kind ``X`` — abort marker: same payload; the records were reported as
  FAILED to a waiting client (the client knows to retry), so replay
  must not resurrect them.

A torn tail — short header, short payload, or CRC mismatch — discards
the rest of the file (appends are sequential, so corruption can only be
a suffix of the last write that raced the crash).

fsync policy (``PIO_WAL_FSYNC``): ``always`` syncs every append (each
enqueue-mode ack is durable against host power loss), ``group`` (the
default) syncs once right before each backing-store commit (a process
crash loses nothing; a host crash can lose only the acks since the last
group), ``off`` never syncs (buffered writes still reach the OS page
cache on every append, so kill -9 of the server process loses nothing —
only an OS crash can). Markers are never synced: losing one costs a
replay that dedups to a no-op.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import zlib
from typing import Optional

from ...common import envknobs, telemetry
from ...common.faultinject import fault_point
from ..storage.jsonl import AppendHandle

log = logging.getLogger("pio.torch.wal")

Key = tuple[int, Optional[int]]

_FRAME = struct.Struct("<BIQI")  # kind, payload_len, lsn, crc32
_HEAD = struct.Struct("<BIQ")    # the CRC-covered header prefix
K_EVENTS, K_COMMIT, K_ABORT = 0x45, 0x43, 0x58  # 'E', 'C', 'X'
_KINDS = (K_EVENTS, K_COMMIT, K_ABORT)

_M_BYTES = telemetry.registry().counter(
    "pio_wal_appended_bytes_total",
    "Bytes appended to ingest WAL segments (frames + markers)").labels()
_M_RECORDS = telemetry.registry().counter(
    "pio_wal_records_total",
    "Event records appended to the ingest WAL").labels()
_M_REPLAYED = telemetry.registry().counter(
    "pio_wal_replayed_events_total",
    "Events re-committed from the WAL by a recovery pass").labels()
_M_DEDUPED = telemetry.registry().counter(
    "pio_wal_replay_deduped_events_total",
    "WAL events skipped at replay because their event_id already "
    "landed in the backing store before the crash").labels()
_M_DISCARDED = telemetry.registry().counter(
    "pio_wal_discarded_bytes_total",
    "Torn-tail bytes discarded from WAL segments at recovery "
    "(CRC-checked suffix)").labels()
_M_QUARANTINED = telemetry.registry().counter(
    "pio_eventlog_quarantined_segments_total",
    "Corrupt event-log segments quarantined (moved aside, never "
    "deleted) by recovery or the scrubber", ("kind",))

#: subdirectory (of a WAL key dir or a JSONL log dir) where corrupt
#: segments are MOVED — never deleted — for operator forensics
QUARANTINE_DIR = "quarantine"


def quarantine_path(path: str, kind: str) -> Optional[str]:
    """Move a corrupt segment/snapshot into its directory's quarantine
    subdir (never delete — the bytes are the only forensic record of
    what the corruption ate). Returns the new path, or None when the
    move itself failed (the file is left in place and the caller must
    keep treating it as corrupt)."""
    qdir = os.path.join(os.path.dirname(path), QUARANTINE_DIR)
    try:
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, os.path.basename(path))
        if os.path.exists(dest):  # re-quarantine after a crashed pass
            dest = f"{dest}.{os.getpid()}"
        os.replace(path, dest)
    except OSError:
        log.exception("could not quarantine corrupt segment %s", path)
        return None
    _M_QUARANTINED.labels(kind).inc()
    log.warning("quarantined corrupt %s segment: %s -> %s",
                kind, path, dest)
    return dest


def _env_flag(name: str) -> bool:
    return envknobs.env_flag(name, False)


class WalConfig:
    """Resolved WAL knobs (all overridable via environment)."""

    __slots__ = ("enabled", "fsync", "dir", "segment_bytes")

    def __init__(self, enabled: bool = False, fsync: str = "group",
                 dir: Optional[str] = None,
                 segment_bytes: int = 16 * 1024 * 1024):
        self.enabled = enabled
        self.fsync = fsync if fsync in ("always", "group", "off") else "group"
        if dir is None:
            from ..storage.registry import base_dir
            dir = os.path.join(base_dir(), "ingest_wal")
        self.dir = dir
        self.segment_bytes = max(4096, segment_bytes)

    @classmethod
    def from_env(cls) -> "WalConfig":
        return cls(
            enabled=_env_flag("PIO_WAL"),
            fsync=envknobs.env_str("PIO_WAL_FSYNC", "group"),
            dir=envknobs.env_str("PIO_WAL_DIR", "", lower=False) or None,
            segment_bytes=envknobs.env_int(
                "PIO_WAL_SEGMENT_BYTES", 16 * 1024 * 1024),
        )

    def to_json(self) -> dict:
        return {"enabled": self.enabled, "fsync": self.fsync,
                "dir": self.dir, "segmentBytes": self.segment_bytes}


class WalLockedError(RuntimeError):
    """The WAL directory is flocked by a live process (an event server
    holds the lock for its whole lifetime): replaying or appending from
    a second process would duplicate in-flight records and delete
    segments out from under the owner."""


def _acquire_dir_lock(dirpath: str):
    """Advisory exclusive flock on ``<dir>/.lock``; returns the held fd
    (kernel releases it on ANY process death, including SIGKILL), or
    ``None`` on platforms without fcntl. Raises :class:`WalLockedError`
    when another live process holds it."""
    try:
        import fcntl
    except ImportError:  # pragma: no cover — non-POSIX
        return None
    os.makedirs(dirpath, exist_ok=True)
    fd = os.open(os.path.join(dirpath, ".lock"),
                 os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        os.close(fd)
        raise WalLockedError(
            f"WAL dir {dirpath!r} is locked by a live process; stop the "
            "event server before replaying (its startup replays "
            "automatically)") from None
    return fd


def _release_dir_lock(fd) -> None:
    if fd is not None:
        try:
            os.close(fd)  # closing drops the flock
        except OSError:  # pragma: no cover — already closed
            pass


def key_dirname(key: Key) -> str:
    app_id, channel_id = key
    return str(app_id) if channel_id is None else f"{app_id}_{channel_id}"


def parse_key_dirname(name: str) -> Optional[Key]:
    parts = name.split("_")
    try:
        if len(parts) == 1:
            return (int(parts[0]), None)
        if len(parts) == 2:
            return (int(parts[0]), int(parts[1]))
    except ValueError:
        pass
    return None


class SegmentDecode:
    """Result of decoding one segment: events ``[(lsn, payload)]`` in
    append order, committed/aborted LSN sets, bytes discarded as
    corrupt/torn, and whether any VALID frame was found after a corrupt
    region (``resynced`` — evidence of mid-file corruption rather than
    the ordinary torn tail a crash leaves)."""

    __slots__ = ("events", "committed", "aborted", "discarded", "resynced")

    def __init__(self):
        self.events: list[tuple[int, bytes]] = []
        self.committed: set[int] = set()
        self.aborted: set[int] = set()
        self.discarded = 0
        self.resynced = False


def _frame_at(buf: bytes, off: int, legacy: bool = False):
    """Try to decode one frame at ``off``; returns
    ``(kind, lsn, payload, next_off)`` or None. Validates kind, length
    bounds, marker-length alignment (a flipped kind byte must not turn
    an E payload into a short-read struct error), and the CRC — never
    raises. ``legacy=True`` checks the older payload-only CRC (segments
    written by an older build; see :func:`decode_buffer`)."""
    n = len(buf)
    if off + _FRAME.size > n:
        return None
    kind, plen, lsn, crc = _FRAME.unpack_from(buf, off)
    start = off + _FRAME.size
    if kind not in _KINDS or start + plen > n:
        return None
    if kind != K_EVENTS and plen % 8 != 0:
        return None  # marker payloads are packed u64 arrays
    payload = buf[start:start + plen]
    want = zlib.crc32(payload) if legacy \
        else _frame_crc(kind, plen, lsn, payload)
    if want != crc:
        return None
    return kind, lsn, payload, start + plen


def decode_buffer(buf: bytes, resync: bool = False) -> SegmentDecode:
    """Decode a segment buffer. Contract (fuzz-tested): NEVER raises,
    and never yields a record that fails its CRC — any truncation, bit
    flip, or garbage between frames is counted in ``discarded``.

    ``resync=False`` (the active-writer view): decoding stops at the
    first bad frame — appends are sequential, so on a healthy disk
    corruption can only be a torn suffix. ``resync=True`` (the recovery
    / scrubber view): after a bad frame the decoder scans forward for
    the next offset that holds a complete CRC-valid frame and resumes,
    salvaging records past a bit-flipped region; ``resynced`` is set so
    the caller can quarantine the segment instead of deleting it.

    Format compatibility: the frame CRC covers the header (a flipped
    kind/LSN byte must read as corruption, not as a valid frame with the
    wrong identity). Segments left behind by an OLDER build carry
    payload-only CRCs — a crashed server upgraded
    in place must still replay them, or every pre-upgrade acked event
    silently vanishes. A segment is written by exactly one build, so
    the format is locked in by the FIRST frame that validates under
    either CRC (not just the frame at offset 0 — a corrupt first frame
    in a legacy segment must not condemn the intact rest)."""
    out = SegmentDecode()
    off, n = 0, len(buf)
    legacy: Optional[bool] = None  # unknown until a frame validates

    def frame_at(o: int):
        nonlocal legacy
        if legacy is not None:
            return _frame_at(buf, o, legacy)
        got = _frame_at(buf, o)
        if got is not None:
            legacy = False
            return got
        got = _frame_at(buf, o, legacy=True)
        if got is not None:
            legacy = True
        return got

    while off < n:
        got = frame_at(off)
        if got is None:
            if not resync:
                break
            nxt = off + 1
            while nxt < n:
                if buf[nxt] in _KINDS and frame_at(nxt) is not None:
                    break
                nxt += 1
            if nxt >= n:
                break
            out.discarded += nxt - off
            out.resynced = True
            off = nxt
            continue
        kind, lsn, payload, off = got
        if kind == K_EVENTS:
            out.events.append((lsn, payload))
        else:
            dest = out.committed if kind == K_COMMIT else out.aborted
            dest.update(struct.unpack(f"<{len(payload) // 8}Q", payload))
    out.discarded += n - off
    return out


def decode_segment(path: str, resync: bool = False) -> SegmentDecode:
    with open(path, "rb") as f:
        return decode_buffer(f.read(), resync=resync)


def read_segment(path: str):
    """Decode one segment file (compat 4-tuple view of
    :func:`decode_segment`, no resync).

    Returns ``(events, committed, aborted, discarded_bytes)`` where
    ``events`` is ``[(lsn, payload_bytes)]`` in append order and
    ``committed``/``aborted`` are LSN sets from the markers. Any torn
    tail (short header, short/garbled payload) is counted in
    ``discarded_bytes`` and ignored — never raised."""
    d = decode_segment(path)
    return d.events, d.committed, d.aborted, d.discarded


def _frame_crc(kind: int, plen: int, lsn: int, payload: bytes) -> int:
    """CRC over header AND payload: a bit flip in the kind or LSN
    fields must read as corruption, not as a differently-numbered valid
    record (replay accounting is keyed on LSNs — fuzz-tested)."""
    return zlib.crc32(payload, zlib.crc32(_HEAD.pack(kind, plen, lsn)))


def _frame(kind: int, lsn: int, payload: bytes) -> bytes:
    return _FRAME.pack(kind, len(payload), lsn,
                       _frame_crc(kind, len(payload), lsn, payload)) + payload


class _Segment:
    __slots__ = ("path", "handle", "outstanding", "frozen")

    def __init__(self, path: str, frozen: bool = False):
        self.path = path
        self.handle: Optional[AppendHandle] = None
        self.outstanding = 0   # E-frames not yet covered by a C/X marker
        self.frozen = frozen   # pre-existing (recovery owns its cleanup)


class _KeyWal:
    __slots__ = ("lock", "dir", "next_lsn", "next_seq", "active",
                 "segments", "lsn_seg", "dirty")

    def __init__(self, dirpath: str):
        self.lock = threading.Lock()
        self.dir = dirpath
        self.next_lsn = 1
        self.next_seq = 1
        self.active: Optional[_Segment] = None
        self.segments: dict[int, _Segment] = {}   # seq -> segment
        self.lsn_seg: dict[int, int] = {}         # uncommitted lsn -> seq
        self.dirty = False                        # bytes since last fsync


class IngestWal:
    """Per-key segment writer + marker/truncation bookkeeping.

    Appends come from the handler threads (the pre-ack append in
    enqueue mode) and from the committer threads; every per-key
    operation runs under that key's lock. Segments left behind by a
    crashed process are *frozen*: the runtime never deletes them (the
    recovery pass is their only cleaner) and starts its own sequence
    numbers after them."""

    def __init__(self, config: Optional[WalConfig] = None):
        self.config = config or WalConfig.from_env()
        os.makedirs(self.config.dir, exist_ok=True)
        # hold the dir lock for this writer's lifetime so an out-of-band
        # `pio wal replay` can't replay in-flight records / delete live
        # segments. Two writers on one dir is a deployment error — warn
        # loudly but serve (the status quo without the lock).
        try:
            self._lock_fd = _acquire_dir_lock(self.config.dir)
        except WalLockedError:
            log.warning(
                "WAL dir %s is locked by another live process — two "
                "writers on one WAL dir can interleave segments; give "
                "each server its own PIO_WAL_DIR", self.config.dir)
            self._lock_fd = None
        self._meta = threading.Lock()
        self._keys: dict[Key, _KeyWal] = {}
        # process-lifetime counters (snapshot() / GET /)
        self.appended_records = 0
        self.appended_bytes = 0

    @property
    def fsyncs_on_commit(self) -> bool:
        return self.config.fsync in ("always", "group")

    def _key(self, key: Key) -> _KeyWal:
        with self._meta:
            kw = self._keys.get(key)
            if kw is None:
                kw = self._keys[key] = _KeyWal(
                    os.path.join(self.config.dir, key_dirname(key)))
                self._bootstrap(kw)
            return kw

    def _bootstrap(self, kw: _KeyWal) -> None:
        """Start sequence/LSN counters after any leftover segments (a
        prior recovery pass may have failed with the store down)."""
        if not os.path.isdir(kw.dir):
            return
        for name in os.listdir(kw.dir):
            if not name.endswith(".wal"):
                continue
            try:
                seq = int(name[:-4])
            except ValueError:
                continue
            path = os.path.join(kw.dir, name)
            kw.segments[seq] = _Segment(path, frozen=True)
            kw.next_seq = max(kw.next_seq, seq + 1)
            try:
                # resync=True: even records past a corrupt region count
                # toward the LSN floor — reusing one of their LSNs would
                # make replay silently skip the new record
                d = decode_segment(path, resync=True)
                # bootstrap past marker LSN sets too, not just surviving
                # E-frames: a committed segment may be deleted while its
                # marker lives on in a later one — reusing an LSN a stale
                # marker covers would make replay silently skip the new
                # record (acked-event loss)
                top = max(lsn for lsn, _ in d.events) if d.events else 0
                for marked in (d.committed, d.aborted):
                    if marked:
                        top = max(top, max(marked))
                kw.next_lsn = max(kw.next_lsn, top + 1)
            except OSError:
                pass

    def _active(self, kw: _KeyWal) -> _Segment:
        seg = kw.active
        if (seg is not None and seg.handle is not None
                and seg.handle.tell() >= self.config.segment_bytes):
            # rotate: close the full segment; it stays registered until
            # its last record is committed, then _settle deletes it.
            # Under fsync=group the outgoing segment may hold appends
            # from since the last group commit — sync it NOW, or the
            # policy's "a host crash loses only the acks since the last
            # group" promise would silently exclude rotated records
            # (sync() only ever touches the active segment).
            if self.config.fsync == "group" and kw.dirty:
                seg.handle.fsync()
                kw.dirty = False
            seg.handle.close()
            if seg.outstanding == 0 and not seg.frozen:
                self._delete(kw, seg)
            seg = kw.active = None
        if seg is None:
            os.makedirs(kw.dir, exist_ok=True)
            seq = kw.next_seq
            kw.next_seq += 1
            seg = _Segment(os.path.join(kw.dir, f"{seq:010d}.wal"))
            seg.handle = AppendHandle(seg.path)
            kw.segments[seq] = seg
            kw.active = seg
        return seg

    def append_events(self, key: Key, payload: bytes, n_events: int) -> int:
        """Append one E frame (one or more canonical lines) and return
        its LSN. Durable per the fsync policy BEFORE returning."""
        fault_point("wal.append")
        kw = self._key(key)
        with kw.lock:
            seg = self._active(kw)
            lsn = kw.next_lsn
            kw.next_lsn += 1
            data = _frame(K_EVENTS, lsn, payload)
            try:
                seg.handle.append(data, fsync=self.config.fsync == "always")
            except BaseException:
                # the caller will report failure (client retries / group
                # aborts), but the frame may still be COMPLETE on disk
                # (e.g. the write landed and only the fsync raised) — a
                # best-effort abort marker neutralizes it so replay can't
                # resurrect a duplicate. A partial frame needs no marker
                # (torn-tail discard also swallows anything after it).
                try:
                    seg.handle.append(
                        _frame(K_ABORT, 0, struct.pack("<Q", lsn)))
                except OSError:  # keep the real error
                    pass
                raise
            seg.outstanding += 1
            kw.lsn_seg[lsn] = self._seq_of(kw, seg)
            kw.dirty = self.config.fsync != "always"
            self.appended_records += n_events
            self.appended_bytes += len(data)
        _M_RECORDS.inc(n_events)
        _M_BYTES.inc(len(data))
        return lsn

    @staticmethod
    def _seq_of(kw: _KeyWal, seg: _Segment) -> int:
        for seq, s in kw.segments.items():
            if s is seg:
                return seq
        raise KeyError("segment not registered")  # pragma: no cover

    def sync(self, key: Key) -> None:
        """fsync the active segment if the policy is ``group`` and bytes
        were appended since the last sync (called right before each
        backing-store commit)."""
        if self.config.fsync != "group":
            return
        kw = self._key(key)
        with kw.lock:
            if kw.dirty and kw.active is not None \
                    and kw.active.handle is not None:
                kw.active.handle.fsync()
                kw.dirty = False

    def commit(self, key: Key, lsns: list[int]) -> None:
        self._mark(key, K_COMMIT, lsns)

    def abort(self, key: Key, lsns: list[int]) -> None:
        self._mark(key, K_ABORT, lsns)

    def _mark(self, key: Key, kind: int, lsns: list[int]) -> None:
        if not lsns:
            return
        kw = self._key(key)
        payload = struct.pack(f"<{len(lsns)}Q", *lsns)
        with kw.lock:
            seg = self._active(kw)
            data = _frame(kind, 0, payload)
            seg.handle.append(data)   # markers are never fsynced
            self.appended_bytes += len(data)
            self._settle(kw, lsns)
        _M_BYTES.inc(len(data))

    def _settle(self, kw: _KeyWal, lsns: list[int]) -> None:
        """Caller holds ``kw.lock``: account marked LSNs and delete any
        non-active segment whose records are all covered."""
        for lsn in lsns:
            seq = kw.lsn_seg.pop(lsn, None)
            if seq is None:
                continue
            seg = kw.segments.get(seq)
            if seg is None:
                continue
            seg.outstanding -= 1
            if (seg.outstanding == 0 and seg is not kw.active
                    and not seg.frozen):
                self._delete(kw, seg, seq)

    def _delete(self, kw: _KeyWal, seg: _Segment,
                seq: Optional[int] = None) -> None:
        if seg.handle is not None:
            seg.handle.close()
        try:
            os.remove(seg.path)
        except OSError:
            pass
        if seq is None:
            seq = self._seq_of(kw, seg)
        kw.segments.pop(seq, None)

    def pending(self) -> int:
        """E-frames appended by THIS process not yet marked."""
        with self._meta:
            keys = list(self._keys.values())
        return sum(len(kw.lsn_seg) for kw in keys)

    def snapshot(self) -> dict:
        with self._meta:
            keys = list(self._keys.values())
        segs = sum(len(kw.segments) for kw in keys)
        return {
            "enabled": True,
            "fsync": self.config.fsync,
            "appendedRecords": self.appended_records,
            "appendedBytes": self.appended_bytes,
            "pendingRecords": sum(len(kw.lsn_seg) for kw in keys),
            "segments": segs,
        }

    def close(self) -> None:
        with self._meta:
            keys = list(self._keys.values())
        for kw in keys:
            with kw.lock:
                for seg in kw.segments.values():
                    if seg.handle is not None:
                        seg.handle.close()
        _release_dir_lock(self._lock_fd)
        self._lock_fd = None


# ---------------------------------------------------------------------------
# recovery / inspection
# ---------------------------------------------------------------------------

def _scan_key_dir(dirpath: str, resync: bool = True):
    """Aggregate every segment of one key directory (seq order).

    Returns ``(uncommitted, n_committed, n_aborted, discarded, paths,
    corrupt)`` — ``uncommitted`` is ``[(lsn, payload)]`` in LSN order:
    E-records covered by neither a commit nor an abort marker anywhere
    in the key's WAL (markers may land in a later segment than their
    records). ``corrupt`` lists segment paths with MID-FILE corruption
    (valid frames found past a bad region — bit rot, not the ordinary
    crash-torn tail): recovery quarantines those instead of deleting."""
    seqs = []
    for name in os.listdir(dirpath):
        if name.endswith(".wal"):
            try:
                seqs.append((int(name[:-4]), name))
            except ValueError:
                continue
    seqs.sort()
    events: list[tuple[int, bytes]] = []
    committed: set[int] = set()
    aborted: set[int] = set()
    discarded = 0
    paths = []
    corrupt = []
    for _seq, name in seqs:
        path = os.path.join(dirpath, name)
        paths.append(path)
        d = decode_segment(path, resync=resync)
        events.extend(d.events)
        committed |= d.committed
        aborted |= d.aborted
        discarded += d.discarded
        if d.resynced or (not d.events and not d.committed
                          and not d.aborted and d.discarded > 0):
            # mid-file corruption, OR a segment that decoded to NOTHING
            # despite holding bytes (could be a benign partial-frame
            # tail, could be wholesale corruption of an old-format
            # segment — indistinguishable, so keep the forensic bytes)
            corrupt.append(path)
    events.sort(key=lambda t: t[0])
    uncommitted = [(lsn, p) for lsn, p in events
                   if lsn not in committed and lsn not in aborted]
    return uncommitted, len(committed), len(aborted), discarded, paths, \
        corrupt


def _partition_subdirs(dirpath: str) -> list[tuple[int, str]]:
    """(index, path) of multi-worker partition WAL subdirs (``p<i>``)
    under a root WAL dir — each is flocked by its OWN worker."""
    out = []
    try:
        names = os.listdir(dirpath)
    except OSError:
        return out
    for name in names:
        if (name.startswith("p") and name[1:].isdigit()
                and os.path.isdir(os.path.join(dirpath, name))):
            out.append((int(name[1:]), os.path.join(dirpath, name)))
    out.sort()
    return out


def _sub_config(config: WalConfig, subdir: str) -> WalConfig:
    return WalConfig(enabled=True, fsync=config.fsync, dir=subdir,
                     segment_bytes=config.segment_bytes)


def dir_is_live(config: Optional[WalConfig] = None) -> bool:
    """True when a live process (an event server) holds the WAL dir
    flock — the root dir's, or any multi-worker partition subdir's
    (``p<i>``, each locked by its own worker). A live dir's active
    segment is mid-write: `inspect` counts taken now include in-flight
    records and can even show a transient "torn tail" (a frame between
    header and payload flush) — expected on a healthy server, not
    corruption, and `replay` would refuse anyway."""
    config = config or WalConfig.from_env()
    if not os.path.isdir(config.dir):
        return False
    for dirpath in ([config.dir]
                    + [p for _i, p in _partition_subdirs(config.dir)]):
        try:
            fd = _acquire_dir_lock(dirpath)
        except WalLockedError:
            return True
        _release_dir_lock(fd)
    return False


def inspect(config: Optional[WalConfig] = None,
            partition: Optional[int] = None) -> list[dict]:
    """Per-key WAL state for `pio wal inspect` / `pio status`: segment
    count and bytes, record/uncommitted counts, torn-tail bytes,
    corrupt/quarantined segment counts. Recurses into multi-worker
    partition subdirs (``p<i>``), tagging their rows."""
    config = config or WalConfig.from_env()
    out = []
    if not os.path.isdir(config.dir):
        return out
    if partition is None:
        for idx, sub in _partition_subdirs(config.dir):
            out.extend(inspect(_sub_config(config, sub), partition=idx))
    for name in sorted(os.listdir(config.dir)):
        key = parse_key_dirname(name)
        dirpath = os.path.join(config.dir, name)
        if key is None or not os.path.isdir(dirpath):
            continue
        uncommitted, n_com, n_ab, discarded, paths, corrupt = \
            _scan_key_dir(dirpath)
        n_events = sum(p.count(b"\n") for _lsn, p in uncommitted)
        qdir = os.path.join(dirpath, QUARANTINE_DIR)
        quarantined = (len(os.listdir(qdir)) if os.path.isdir(qdir) else 0)
        out.append({
            "appId": key[0], "channelId": key[1],
            "partition": partition,
            "segments": len(paths),
            "bytes": sum(os.path.getsize(p) for p in paths),
            "uncommittedRecords": len(uncommitted),
            "uncommittedEvents": n_events,
            "committedRecords": n_com, "abortedRecords": n_ab,
            "tornTailBytes": discarded,
            "corruptSegments": len(corrupt),
            "quarantinedSegments": quarantined,
        })
    return out


def recover(storage, config: Optional[WalConfig] = None, stats=None,
            plugins=None) -> dict:
    """Replay every uncommitted WAL record through the ingest buffer's
    commit path, deduped by event_id against the backing store (the
    JSONL log's merged read: every ``.p<i>`` shard too), then truncate
    (delete) the replayed segments. Idempotent: a crash during recovery
    just re-runs it. A dead backing store propagates so the caller can
    decide (the event server logs and serves; `pio wal replay` exits
    non-zero)."""
    config = config or WalConfig.from_env()
    summary = {"keys": 0, "replayed": 0, "deduped": 0, "aborted": 0,
               "discardedBytes": 0, "segmentsRemoved": 0, "quarantined": 0}
    if not os.path.isdir(config.dir):
        return summary
    # a live writer (an event server holding the dir flock) makes
    # replay unsafe: in-flight records would duplicate and its active
    # segments would be deleted under it — refuse instead
    lock_fd = _acquire_dir_lock(config.dir)
    try:
        return _recover_locked(storage, config, summary, stats, plugins)
    finally:
        _release_dir_lock(lock_fd)


def _recover_locked(storage, config, summary, stats, plugins) -> dict:
    from ...workflow.plugins import EventServerPluginContext
    from ..storage.event import Event
    from .ingest_buffer import _EVENT, IngestBuffer, IngestConfig, _Pending

    # replay commits through the buffer's own group commit, synchronously
    # and without a WAL (it must not re-log its own commits)
    buf = IngestBuffer(storage, stats, plugins or EventServerPluginContext(),
                       IngestConfig(), wal=None)
    for name in sorted(os.listdir(config.dir)):
        key = parse_key_dirname(name)
        dirpath = os.path.join(config.dir, name)
        if key is None or not os.path.isdir(dirpath):
            continue
        uncommitted, _n_com, n_ab, discarded, paths, corrupt = \
            _scan_key_dir(dirpath)
        summary["keys"] += 1
        summary["aborted"] += n_ab
        summary["discardedBytes"] += discarded
        if discarded:
            _M_DISCARDED.inc(discarded)
            log.warning("WAL %s: discarded %d torn-tail byte(s)",
                        name, discarded)
        le = storage.get_l_events()
        entries, replayed, deduped = [], 0, 0
        for _lsn, payload in uncommitted:
            for line in payload.splitlines():
                if not line.strip():
                    continue
                doc = json.loads(line)
                eid = doc.get("eventId")
                if eid and le.get(eid, key[0], key[1]) is not None:
                    deduped += 1
                    continue
                entries.append(_Pending(_EVENT, Event.from_json(doc),
                                        ids=[eid] if eid else None))
                replayed += 1
        if entries:
            results = buf._commit_group(key, entries)
            errs = [r for r in results if isinstance(r, Exception)]
            if errs:
                raise errs[0]
        summary["replayed"] += replayed
        summary["deduped"] += deduped
        _M_REPLAYED.inc(replayed)
        _M_DEDUPED.inc(deduped)
        for path in paths:
            if path in corrupt:
                # mid-file corruption: the salvageable records were just
                # replayed, but the bad region may hide records we could
                # not read — keep the raw bytes for forensics instead of
                # deleting the evidence
                if quarantine_path(path, "wal") is not None:
                    summary["quarantined"] += 1
                continue
            try:
                os.remove(path)
                summary["segmentsRemoved"] += 1
            except OSError:
                pass
        try:
            os.rmdir(dirpath)
        except OSError:
            pass
    # multi-worker layout: each partition subdir is its own WAL (its
    # worker's flock, its worker's replay at startup). `pio wal replay`
    # on the ROOT replays dead partitions and skips live ones — a live
    # worker's in-flight records are not stranded, merely not ours.
    for idx, sub in _partition_subdirs(config.dir):
        try:
            sub_summary = recover(storage, _sub_config(config, sub),
                                  stats=stats, plugins=plugins)
        except WalLockedError:
            log.info("WAL partition p%d is owned by a live worker; "
                     "skipping (its startup replay owns it)", idx)
            continue
        for k, v in sub_summary.items():
            summary[k] = summary.get(k, 0) + v
    if summary["replayed"] or summary["deduped"] or summary["discardedBytes"]:
        log.info("WAL recovery: %s", summary)
    return summary
