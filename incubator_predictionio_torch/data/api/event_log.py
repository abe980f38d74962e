"""The partitioned event log: fenced ownership, columnar compaction,
generations, retention, health and the multi-worker event server.

The port's own copy of ``incubator_predictionio_tpu/data/api/event_log.py``:
the same lease files (``.p<i>.lease``, the same JSON body), the same
snapshot files (``<log>.g<N>.colseg``, the same npz keys and
``SNAPSHOT_VERSION``), the same manifest (schema v2, ``<log>.manifest``)
and the same commit protocol, so a directory written by either package is
read, compacted and claimed by the other.

- **Fenced ownership** (:func:`claim_partition`). Every partition (a
  worker's shard ``events_<app>[_<chan>].p<i>.jsonl``) is claimed through
  a lease file: an exclusive ``flock`` held for the owner's lifetime plus
  a monotonically bumped epoch in the file body. A rival claimant on a
  held partition fails at claim time (:class:`PartitionHeldError`); the
  owner re-reads the epoch before every write (:meth:`Lease.verify`), and
  a stale epoch raises :class:`PartitionFencedError`, which the event
  server answers as the reference's 503 shed — a write that verifies
  after the epoch bump lands no byte. The fence takes effect from the next
  verify: a request whose verify passed just before the bump still lands,
  as in the reference, whose verify-then-append has the same window.
  ``force=True`` (``pio eventlog fence``) bumps the epoch past a held
  flock.
- **Multi-worker serving** (:func:`run_partitioned_event_server`, ``pio
  eventserver --workers N``): N supervised worker processes
  (``parallel/supervisor.py``, per-worker restart), each owning one
  partition, behind the splice front (``common/splice.py``), with the
  runtime rescale through the scale file and SIGHUP.

- **Crash-safe compaction** (:func:`compact_log`). Each pass rewrites the
  newly committed bytes of a log into a columnar snapshot generation —
  the codec's interned columns plus the raw bytes, serialized — stamped
  with its event-time bounds ``[minEventUs, maxEventUs]``, its tombstone
  ids and the explicit event ids it duplicates from earlier generations.
  Shadow file + fsync + atomic rename + manifest commit record: a kill at
  any step leaves either the previous chain or the new one. The JSONL log
  itself is never rewritten.
- **Windowed loads** (:func:`load_chain`). A read with an event-time
  window skips every generation the manifest proves disjoint from it —
  zero bytes read, zero decoded — and replays its tombstones and
  duplicate-id kills, so the result equals the row-filtered full scan.
- **Retention** (:func:`retire_expired`, ``PIO_EVENT_RETENTION``). A
  fully expired prefix of the chain moves to the ``retired/`` tier; JSON
  fallback parses start past it (:func:`parse_floor`).
- **Scrubbing and health** (:func:`scrub_log_dir`,
  :func:`partition_health`). Corrupt snapshots are quarantined (moved to
  ``quarantine/``, never deleted) and the log keeps serving from its JSONL
  bytes.

- **Archive and restore** (:func:`archive_generation`,
  :func:`restore_generation`, ``pio eventlog archive|restore``). A sealed
  hot generation streams to the cold source named by
  ``PIO_EVENT_ARCHIVE_SOURCE`` (a Models DAO of any configured storage
  source: localfs or SQLite here), CRC-verified on the round trip before
  the local copy goes; a windowed train that needs it restores it on
  demand (``PIO_EVENT_RESTORE_ON_DEMAND=1``) or raises
  :class:`ArchivedGenerationError` naming it; serving reads re-parse its
  log bytes.
- **The write-ahead log under the workers.** Each worker gets its own
  ``PIO_WAL_DIR=<wal_dir>/p<i>`` (:func:`worker_env`), replayed by the
  worker after it claimed its lease; the front replays the WAL root
  before the workers start and a retired partition's subdirectory on a
  scale-down (:func:`run_partitioned_event_server`).
- **Telemetry.** Snapshot loads, compactions, retired, archived and
  restored generations and the generations a window skipped count into
  the process registry (``GET /metrics``).
"""

from __future__ import annotations

import asyncio
import datetime as _dt
import io
import json
import logging
import os
import socket
import sys
import threading
import zlib
from typing import Optional

import numpy as np

from ...common import envknobs, telemetry
from ...common.faultinject import fault_point

log = logging.getLogger("pio.torch.eventlog")

__all__ = [
    "ArchivedGenerationError", "IngestOverloadError", "Lease",
    "PartitionFencedError", "PartitionHeldError", "archive_generation",
    "claim_partition", "compact_log", "front_info_path", "lease_info",
    "load_chain", "load_snapshot", "parse_floor", "partition_health",
    "restore_generation", "retire_expired", "run_partitioned_event_server",
    "scrub_log_dir", "worker_env",
]

_M_SNAP_LOADS = telemetry.registry().counter(
    "pio_eventlog_snapshot_loads_total",
    "Compacted columnar snapshots loaded in place of a JSON "
    "re-parse").labels()
_M_COMPACTIONS = telemetry.registry().counter(
    "pio_eventlog_compactions_total",
    "Event-log compaction passes that committed a new snapshot").labels()
_M_RETIRED = telemetry.registry().counter(
    "pio_eventlog_retired_generations_total",
    "Fully-expired generations moved to the retired tier by "
    "PIO_EVENT_RETENTION / pio eventlog retire").labels()
_M_ARCHIVED = telemetry.registry().counter(
    "pio_eventlog_archived_generations_total",
    "Sealed generations streamed to the cold archive source with a "
    "verified round-trip").labels()
_M_RESTORED = telemetry.registry().counter(
    "pio_eventlog_restored_generations_total",
    "Archived generations restored to the hot tier (operator command "
    "or restore-on-demand)").labels()
_M_WINDOW_SKIPS = telemetry.registry().counter(
    "pio_train_window_generations_skipped_total",
    "Whole generations skipped by manifest event-time bounds during a "
    "windowed read — zero snapshot bytes decoded").labels()

SNAPSHOT_VERSION = 1
MANIFEST_VERSION = 2
MANIFEST_SUFFIX = ".manifest"
TAIL_PROBE_LEN = 4096
#: quarantine-style subdirectory retired generations move INTO (never
#: unlinked in place)
RETIRED_DIR = "retired"
#: subdirectory corrupt snapshots move into (the reference's
#: ``data/api/ingest_wal.py`` name, shared by both packages' directories)
QUARANTINE_DIR = "quarantine"
#: the Models namespace archived generations live under on the cold
#: source (the reference's, so either package restores the other's)
ARCHIVE_NAMESPACE = "pio_eventlog_archive"
#: sentinel the codec stores for rows without an eventTime
_TIME_ABSENT_US = int(np.iinfo(np.int64).min)


def quarantine_path(path: str, kind: str) -> Optional[str]:
    """Move a corrupt snapshot into its directory's quarantine subdir
    (never delete — the bytes are the only forensic record of what the
    corruption ate). Returns the new path, or None when the move itself
    failed (the file is left in place and the caller must keep treating it
    as corrupt)."""
    qdir = os.path.join(os.path.dirname(path), QUARANTINE_DIR)
    try:
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, os.path.basename(path))
        if os.path.exists(dest):  # re-quarantine after a crashed pass
            dest = f"{dest}.{os.getpid()}"
        os.replace(path, dest)
    except OSError:
        log.exception("could not quarantine corrupt %s file %s", kind, path)
        return None
    log.warning("quarantined corrupt %s file: %s -> %s", kind, path, dest)
    return dest


# ---------------------------------------------------------------------------
# partition leases (fenced ownership)
# ---------------------------------------------------------------------------

class IngestOverloadError(RuntimeError):
    """A write the event server sheds with 503 + a jittered
    ``Retry-After`` (the reference's ``ingest_buffer.IngestOverloadError``,
    the base of its shed contract)."""

    def __init__(self, message: str, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = retry_after


class PartitionHeldError(RuntimeError):
    """A live process holds this partition's lease (flock): a second
    claimant must not come up — two writers on one shard would
    interleave appends."""


class PartitionFencedError(IngestOverloadError):
    """This worker's lease epoch is no longer the partition's current
    epoch: another claimant took ownership. Every later write is refused
    (verified BEFORE any store append) and the event server answers it
    with a 503 so clients retry against the new owner. Restarting the
    fenced worker re-claims with a fresh epoch."""

    def __init__(self, message: str):
        super().__init__(message, retry_after=5.0)


def _lease_path(dirpath: str, partition: int) -> str:
    return os.path.join(dirpath, f".p{partition}.lease")


class Lease:
    """A held partition lease: an exclusive flock (released by the kernel
    on ANY process death, SIGKILL included) plus the epoch this holder
    wrote. ``verify()`` re-reads the on-disk epoch; callers run it before
    every write."""

    __slots__ = ("path", "partition", "epoch", "_fd", "_fd_lock", "forced")

    def __init__(self, path: str, partition: int, epoch: int, fd: int,
                 forced: bool = False):
        self.path = path
        self.partition = partition
        self.epoch = epoch
        self._fd = fd
        # verify() runs on request threads while shutdown's release()
        # closes the fd: without the lock a straggler verify could pread a
        # closed (or reused) descriptor
        self._fd_lock = threading.Lock()
        self.forced = forced

    def verify(self) -> None:
        """Raise :class:`PartitionFencedError` unless the on-disk epoch is
        still ours. An unreadable or garbled body — or a lease this process
        already released — also fences: the safe direction is refusing
        the write."""
        try:
            with self._fd_lock:
                if self._fd is None:
                    raise OSError("lease released")
                body = os.pread(self._fd, 4096, 0)
            current = json.loads(body.decode("utf-8"))["epoch"]
        except (OSError, ValueError, KeyError, UnicodeDecodeError):
            raise PartitionFencedError(
                f"partition {self.partition} lease unreadable; refusing "
                "writes (possible ownership change in progress)") from None
        if current != self.epoch:
            raise PartitionFencedError(
                f"partition {self.partition} fenced: lease epoch "
                f"{current} has overtaken ours ({self.epoch}); another "
                "worker owns this partition now")

    def release(self) -> None:
        with self._fd_lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)  # closing drops the flock
                except OSError:  # pragma: no cover — already closed
                    pass
                self._fd = None

    def to_json(self) -> dict:
        return {"partition": self.partition, "epoch": self.epoch,
                "forced": self.forced}


def _write_lease_body(fd: int, epoch: int) -> None:
    body = json.dumps({
        "epoch": epoch, "pid": os.getpid(),
        "host": socket.gethostname(),
        "claimedAt": _dt.datetime.now(_dt.timezone.utc).isoformat(),
    }).encode("utf-8")
    os.ftruncate(fd, 0)
    os.pwrite(fd, body, 0)
    os.fsync(fd)


def _read_lease_body(fd: int) -> dict:
    try:
        return json.loads(os.pread(fd, 4096, 0).decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError):
        return {}


def claim_partition(dirpath: str, partition: int,
                    force: bool = False) -> Lease:
    """Claim a partition: exclusive flock on its lease file, then bump and
    persist the epoch. A held lease raises :class:`PartitionHeldError`
    unless ``force`` — the operator's split-brain resolver (``pio eventlog
    fence``): it bumps the epoch WITHOUT the flock, so a wedged-but-alive
    previous owner is fenced out on its next write. With ``force`` the
    caller asserts there is at most one live claimant."""
    os.makedirs(dirpath, exist_ok=True)
    path = _lease_path(dirpath, partition)
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    forced = False
    try:
        try:
            import fcntl
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ImportError:  # pragma: no cover — non-POSIX
            pass
        except OSError:
            if not force:
                holder = _read_lease_body(fd)
                raise PartitionHeldError(
                    f"partition {partition} of {dirpath!r} is held by a "
                    f"live process (pid {holder.get('pid')}, epoch "
                    f"{holder.get('epoch')}); a second writer would "
                    "corrupt the shard") from None
            forced = True
        epoch = int(_read_lease_body(fd).get("epoch", 0)) + 1
        _write_lease_body(fd, epoch)
    except Exception:
        os.close(fd)
        raise
    lease = Lease(path, partition, epoch, fd, forced=forced)
    log.info("claimed partition %d of %s (epoch %d%s)", partition,
             dirpath, epoch, ", FORCED past a held flock" if forced else "")
    return lease


def lease_info(dirpath: str, partition: int) -> Optional[dict]:
    """Operator view of one lease file: holder body plus whether the
    flock is actually held (``held=False`` with a body present = a
    stale lease left by a crashed worker — the next claimant recovers
    it). Returns None when the lease file does not exist."""
    path = _lease_path(dirpath, partition)
    if not os.path.exists(path):
        return None
    try:
        fd = os.open(path, os.O_RDWR)
    except OSError:
        # unreadable (permissions, or deleted since the exists check):
        # a health surface must degrade, not traceback
        return {"partition": partition, "held": None, "epoch": None,
                "pid": None, "claimedAt": None, "stale": False}
    try:
        body = _read_lease_body(fd)
        held = True
        try:
            import fcntl
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            held = False  # we got it: no live holder
            fcntl.flock(fd, fcntl.LOCK_UN)
        except ImportError:  # pragma: no cover — non-POSIX
            held = False
        except OSError:
            held = True
        return {"partition": partition, "held": held,
                "epoch": body.get("epoch"), "pid": body.get("pid"),
                "claimedAt": body.get("claimedAt"),
                "stale": bool(body) and not held}
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# crash-safe columnar compaction
# ---------------------------------------------------------------------------

def _manifest_path(log_path: str) -> str:
    return log_path + MANIFEST_SUFFIX


def _read_manifest(log_path: str) -> Optional[dict]:
    try:
        with open(_manifest_path(log_path)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _fsync_dir(dirpath: str) -> None:
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:  # pragma: no cover — platform without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _serialize_cols(cols) -> bytes:
    """ColumnarEvents → one npz blob (arrays + interned tables). The
    snapshot stores the raw bytes too, so lazy per-record reparse
    (``record_dict`` — what ``find()`` materializes Events from) works
    off the snapshot exactly as off a fresh parse: bit-identical."""
    buf = io.BytesIO()
    tables = {f"table_{w}": np.frombuffer(
        json.dumps(cols.table(w)).encode("utf-8"), np.uint8)
        for w in range(6)}
    np.savez(
        buf,
        version=np.asarray([SNAPSHOT_VERSION], np.int64),
        raw=np.frombuffer(cols.raw, np.uint8),
        event=cols.event, etype=cols.etype, eid=cols.eid,
        tetype=cols.tetype, teid=cols.teid, event_id=cols.event_id,
        time_us=cols.time_us, rating=cols.rating,
        props=cols.props, span=cols.span,
        tombstones=np.frombuffer(
            json.dumps(cols.tombstones).encode("utf-8"), np.uint8),
        tombstone_pos=cols.tombstone_pos,
        **tables,
    )
    return buf.getvalue()


def _deserialize_cols(blob: bytes):
    from ...native import ColumnarEvents

    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        if int(z["version"][0]) != SNAPSHOT_VERSION:
            raise ValueError(f"snapshot version {z['version'][0]}")
        tables = [json.loads(bytes(z[f"table_{w}"]).decode("utf-8"))
                  for w in range(6)]
        return ColumnarEvents(
            raw=bytes(z["raw"]),
            event=z["event"], etype=z["etype"], eid=z["eid"],
            tetype=z["tetype"], teid=z["teid"], event_id=z["event_id"],
            time_us=z["time_us"], rating=z["rating"],
            props=z["props"], span=z["span"],
            _tables=tables,
            tombstones=json.loads(bytes(z["tombstones"]).decode("utf-8")),
            tombstone_pos=z["tombstone_pos"],
        )


def _tail_probe(buf: bytes, covered: int) -> dict:
    off = max(0, covered - TAIL_PROBE_LEN)
    return {"off": off, "len": covered - off,
            "crc32": zlib.crc32(buf[off:covered])}


def _generations(manifest: dict) -> list:
    """The manifest's generation chain, oldest first. A legacy (v1)
    manifest — one snapshot covering everything, no event-time bounds —
    normalizes to a single UNBOUNDED entry: it is always loaded (never
    window-skipped), never retired, and ``pio eventlog status`` warns
    about it until the next compaction seals a bounded generation."""
    gens = manifest.get("generations")
    if isinstance(gens, list) and gens:
        return gens
    return [{
        "generation": int(manifest.get("generation", 1)),
        "file": manifest.get("file"),
        "start": 0,
        "end": int(manifest.get("covered", 0)),
        "events": manifest.get("events"),
        "crc32": manifest.get("crc32"),
        "minEventUs": None,
        "maxEventUs": None,
        "untimedRows": None,
        "tombstones": None,
        "dupIds": None,
        "dupComplete": False,
        "tier": "hot",
        "legacy": True,
    }]


def _gen_skippable(entry: dict, start_us, until_us) -> bool:
    """May a windowed read drop this generation without decoding it?

    Only when the manifest PROVES equivalence to the row filter: the
    entry carries real bounds metadata (not legacy, and its
    cross-generation duplicate-id set was complete at seal time) and
    its timed rows are disjoint from ``[start_us, until_us)``. An entry
    with no timed rows at all is always skippable — the row filter
    drops untimed rows from every bounded window."""
    if entry.get("legacy") or not entry.get("dupComplete", False):
        return False
    if entry.get("tombstones") is None or entry.get("dupIds") is None:
        return False
    lo, hi = entry.get("minEventUs"), entry.get("maxEventUs")
    if lo is None or hi is None:
        return True
    if start_us is not None and hi < start_us:
        return True
    if until_us is not None and lo >= until_us:
        return True
    return False


def _dup_ids(dirpath: str, chain: list, cols) -> tuple:
    """``(sorted duplicate ids, complete?)`` for a generation being
    sealed: the explicit event-ids it shares with any EARLIER
    non-retired generation. A windowed read that skips this generation
    replays these as keep-last kills, so dedup against skipped rows
    stays bit-identical to the full scan. When an earlier generation's
    id table is unreadable locally (archived, or a racing gc), the set
    is marked incomplete and the new generation is simply never
    skipped — conservative, never wrong."""
    from ...native import ColumnarEvents

    new_ids = set(cols.table(ColumnarEvents.TABLE_EVENT_ID))
    if not new_ids:
        return [], True
    dups, complete = set(), True
    for entry in chain:
        if entry.get("tier") == "retired":
            continue  # retired rows never appear in any scan
        path = os.path.join(dirpath, entry.get("file") or "")
        try:
            with np.load(path, allow_pickle=False) as z:
                ids = json.loads(bytes(z["table_5"]).decode("utf-8"))
        except Exception:  # noqa: BLE001 — archived/missing/corrupt
            complete = False
            continue
        dups.update(new_ids.intersection(ids))
    return sorted(dups), complete


def _commit_manifest(log_path: str, manifest: dict) -> None:
    """Shadow-write + fsync + atomic-rename the manifest — the commit
    record every tier transition shares."""
    mtmp = _manifest_path(log_path) + ".tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(mtmp, _manifest_path(log_path))
    _fsync_dir(os.path.dirname(log_path) or ".")


def compact_log(log_path: str, min_new_bytes: int = 0) -> Optional[dict]:
    """Compact one JSONL event log into a columnar snapshot generation.

    Additive and lock-free: each pass seals ONLY the newly covered
    byte range ``[prev_covered, covered)`` as its own generation and
    appends it to the manifest's generation chain (schema v2) — prior
    generations' files are untouched, so a pass parses and serializes
    just the new bytes. Each entry records the range's event-time
    bounds, its tombstone ids, and the explicit event-ids it duplicates
    from earlier generations: everything a windowed read needs to skip
    a disjoint generation without decoding it. Commit protocol (each
    step leaves a recoverable state — SIGKILL anywhere yields either
    the old chain or the new one, complete):

    1. write ``<log>.g<N>.colseg.tmp`` (shadow file), fsync
    2. atomic-rename to ``<log>.g<N>.colseg``, fsync dir
    3. write + fsync + atomic-rename the manifest (the COMMIT record:
       it names the exact generation chain)
    4. garbage-collect unreferenced snapshot files and stray ``.tmp``

    Returns the committed manifest, or None when the log has grown less
    than ``min_new_bytes`` past the current chain."""
    from ...native import parse_events

    try:
        with open(log_path, "rb") as f:
            buf = f.read()
    except OSError:
        return None
    covered = buf.rfind(b"\n") + 1  # complete lines only
    prev = _read_manifest(log_path)
    chain: list = []
    prev_covered, gen = 0, 1
    if prev is not None:
        chain = [dict(e) for e in _generations(prev)]
        prev_covered = int(prev.get("covered", 0))
        if covered < prev_covered + max(1, min_new_bytes):
            return None
        gen = int(prev.get("generation", 0)) + 1
    elif covered == 0:
        return None
    cols = parse_events(buf[prev_covered:covered])
    blob = _serialize_cols(cols)
    dirpath = os.path.dirname(log_path) or "."
    base = os.path.basename(log_path)
    snap_name = f"{base}.g{gen}.colseg"
    tmp = os.path.join(dirpath, snap_name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    fault_point("compact.write")
    os.replace(tmp, os.path.join(dirpath, snap_name))
    _fsync_dir(dirpath)
    fault_point("compact.rename")
    timed = cols.time_us[cols.time_us != _TIME_ABSENT_US]
    dup_ids, dup_complete = _dup_ids(dirpath, chain, cols)
    entry = {
        "generation": gen,
        "file": snap_name,
        "start": prev_covered,
        "end": covered,
        "events": len(cols),
        "crc32": zlib.crc32(blob),
        "minEventUs": int(timed.min()) if timed.size else None,
        "maxEventUs": int(timed.max()) if timed.size else None,
        "untimedRows": int(len(cols) - timed.size),
        "tombstones": list(cols.tombstones),
        "dupIds": dup_ids,
        "dupComplete": dup_complete,
        "tier": "hot",
    }
    chain.append(entry)
    manifest = {
        "version": MANIFEST_VERSION,
        # top-level keys describe the NEWEST generation plus chain
        # totals — the shape v1 consumers (tests, bench, status) read
        "generation": gen,
        "file": snap_name,
        "covered": covered,
        "events": sum(int(e.get("events") or 0) for e in chain),
        "crc32": entry["crc32"],
        "tailProbe": _tail_probe(buf, covered),
        "compactedAt": _dt.datetime.now(_dt.timezone.utc).isoformat(),
        "generations": chain,
    }
    mtmp = _manifest_path(log_path) + ".tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    fault_point("compact.manifest")
    os.replace(mtmp, _manifest_path(log_path))
    _fsync_dir(dirpath)
    _M_COMPACTIONS.inc()
    _gc_generations(dirpath, base,
                    keep={e["file"] for e in chain
                          if e.get("file") and e.get("tier") != "archived"})
    log.info("compacted %s: generation %d, %d new event(s), %d byte(s) "
             "covered", log_path, gen, len(cols), covered)
    return manifest


def _gc_generations(dirpath: str, base: str, keep) -> None:
    """Remove snapshot files the committed manifest no longer
    references, plus stray shadow files (post-commit: nothing
    references them).

    ``keep`` is the full SET of file names still referenced by the
    chain — every hot generation, and retired entries whose move into
    ``retired/`` may still be pending after a crash. Keying the sweep
    on a single name would collect live chain members (and an exact-name
    set also shuts the near-miss door: ``.g1`` vs ``.g11`` share a
    prefix but never an entry)."""
    if isinstance(keep, str):
        keep = {keep}
    prefix = base + ".g"
    for name in os.listdir(dirpath):
        if not name.startswith(prefix):
            continue
        if name in keep:
            continue
        if name.endswith(".colseg") or name.endswith(".tmp"):
            try:
                os.remove(os.path.join(dirpath, name))
            except OSError:  # pragma: no cover — racing gc is fine
                pass


def _discard_stale(log_path: str, manifest: Optional[dict]) -> None:
    """Remove a snapshot that no longer matches its log (the log was
    replaced or rewritten — e.g. tombstone compaction). NOT corruption:
    nothing is quarantined, the next compaction pass rebuilds it.

    Generation-guarded: a reader can race a concurrent compaction — it
    read generation N, the compactor committed N+1 and gc'd N's file,
    and the reader's failed load must NOT delete the freshly committed
    N+1 manifest. Only the generation the caller actually failed on is
    ever removed."""
    current = _read_manifest(log_path)
    if (current is not None and manifest is not None
            and current.get("generation") != manifest.get("generation")):
        return  # a newer commit raced in: it owns the manifest now
    dirpath = os.path.dirname(log_path) or "."
    doomed = [_manifest_path(log_path)]
    if manifest is not None:
        # every hot chain file describes the replaced log; retired
        # files and archived blobs are left alone (quarantine-style)
        doomed += [os.path.join(dirpath, e["file"])
                   for e in _generations(manifest)
                   if e.get("file") and e.get("tier", "hot") == "hot"]
    for p in doomed:
        try:
            os.remove(p)
        except OSError:
            pass
    log.info("discarded stale snapshot of %s (log replaced/rewritten)",
             log_path)


class ArchivedGenerationError(RuntimeError):
    """A read needs a generation whose snapshot lives only on the cold
    archive source (and restore-on-demand is off). Names the generations
    so the operator knows exactly what to ``pio eventlog restore``."""

    def __init__(self, log_path: str, generations: list):
        self.log_path = log_path
        self.generations = list(generations)
        gens = ", ".join(str(g) for g in self.generations)
        super().__init__(
            f"generation(s) {gens} of {log_path!r} are archived; run "
            f"`pio eventlog restore` or set "
            f"PIO_EVENT_RESTORE_ON_DEMAND=1")


def parse_floor(log_path: str) -> int:
    """First byte offset of the log still in the hot view: the byte
    after the contiguous RETIRED prefix of the generation chain. JSON
    fallback parses (snapshot missing/corrupt) must start here, not at
    byte 0 — re-parsing retired bytes would resurrect expired data."""
    manifest = _read_manifest(log_path)
    if manifest is None:
        return 0
    floor = 0
    for entry in _generations(manifest):
        if entry.get("tier") != "retired":
            break
        floor = int(entry.get("end", floor))
    return floor


def _truncate_chain(log_path: str, manifest: dict, bad_gen: int) -> None:
    """Self-heal a chain whose generation ``bad_gen`` failed to load:
    keep the verified prefix (entries sealed before it), drop it and
    everything after — the next compaction pass re-seals the dropped
    byte range. Generation-guarded like :func:`_discard_stale`. With no
    loadable prefix the manifest is removed outright (the v1
    behavior)."""
    current = _read_manifest(log_path)
    if (current is not None
            and current.get("generation") != manifest.get("generation")):
        return
    kept = [e for e in _generations(manifest)
            if int(e.get("generation", 0)) < bad_gen]
    if not kept:
        try:
            os.remove(_manifest_path(log_path))
        except OSError:
            pass
        return
    last = kept[-1]
    covered = int(last.get("end", 0))
    try:
        with open(log_path, "rb") as f:
            buf = f.read(covered)
        probe = _tail_probe(buf, covered)
    except OSError:
        probe = manifest.get("tailProbe")
    try:
        _commit_manifest(log_path, {
            "version": MANIFEST_VERSION,
            "generation": int(last.get("generation", 0)),
            "file": last.get("file"),
            "covered": covered,
            "events": sum(int(e.get("events") or 0) for e in kept),
            "crc32": last.get("crc32"),
            "tailProbe": probe,
            "compactedAt": manifest.get("compactedAt"),
            "generations": kept,
        })
    except OSError:  # pragma: no cover — degraded disk; next pass heals
        pass


def load_chain(log_path: str, start_us=None, until_us=None,
               on_archived: str = "raise", storage=None) -> Optional[dict]:
    """Load the committed generation chain of one log, fully verified,
    optionally windowed by event time.

    Returns ``{"pieces", "covered", "floor", "skipped", "decodedBytes",
    "generations"}`` or None (no chain / stale — caller falls back to
    the JSON parse from :func:`parse_floor`). ``pieces`` is an ordered
    list the consumer folds into one scan:

    - ``("cols", ColumnarEvents, entry)`` — a decoded generation;
    - ``("skip", entry)`` — a generation PROVEN disjoint from the
      window by its manifest bounds: zero bytes read, zero decoded.
      The entry carries the tombstone ids and duplicate-id kills the
      consumer must still apply for bit-identity with a full scan;
    - ``("gap", entry)`` — an archived generation under
      ``on_archived="parse"``: the consumer re-parses the log bytes
      ``[start, end)`` (correct, just slower — serving paths use this
      so archival never breaks availability).

    ``on_archived`` picks the policy for an archived generation the
    window actually needs: ``"raise"`` (windowed trains —
    :class:`ArchivedGenerationError` names the generation; flipped to a
    restore from ``storage``'s archive source by
    ``PIO_EVENT_RESTORE_ON_DEMAND``) or ``"parse"``.

    Corruption handling is per-generation: a CRC-mismatched or
    undecodable snapshot is quarantined and the chain self-truncates to
    the verified prefix (:func:`_truncate_chain`); a STALE chain (log
    shrank / tail probe mismatch) is discarded whole. Either way the
    caller falls back to the JSON parse — speed degrades, availability
    and replay never do."""
    manifest = _read_manifest(log_path)
    if manifest is None:
        return None
    chain = _generations(manifest)
    covered = int(manifest.get("covered", 0))
    # the chain must describe THIS log: size still covers it and the
    # last bytes of the covered prefix match the recorded probe
    try:
        if os.path.getsize(log_path) < covered:
            raise ValueError("log shrank")
        probe = manifest["tailProbe"]
        with open(log_path, "rb") as f:
            f.seek(int(probe["off"]))
            got = f.read(int(probe["len"]))
        if zlib.crc32(got) != probe["crc32"]:
            raise ValueError("tail probe mismatch")
    except (OSError, KeyError, TypeError, ValueError):
        _discard_stale(log_path, manifest)
        return None
    dirpath = os.path.dirname(log_path) or "."
    windowed = start_us is not None or until_us is not None
    pieces: list = []
    floor = 0
    skipped = decoded = 0
    for entry in chain:
        if entry.get("tier") == "retired":
            if not pieces and not skipped:
                floor = int(entry.get("end", floor))
            continue
        if windowed and _gen_skippable(entry, start_us, until_us):
            pieces.append(("skip", entry))
            skipped += 1
            continue
        if entry.get("tier") == "archived":
            if envknobs.env_flag("PIO_EVENT_RESTORE_ON_DEMAND", False):
                restore_generation(log_path,
                                   int(entry.get("generation", 0)),
                                   storage=storage)
                # the restored file now sits in the hot dir under the
                # same name and crc: load it below
            elif on_archived == "parse":
                pieces.append(("gap", entry))
                continue
            else:
                raise ArchivedGenerationError(
                    log_path, [entry.get("generation")])
        snap_path = os.path.join(dirpath, entry.get("file") or "")
        try:
            with open(snap_path, "rb") as f:
                blob = f.read()
        except OSError:
            # a hot chain member is missing: treat as corruption of
            # that generation — keep the verified prefix, re-seal later
            _truncate_chain(log_path, manifest,
                            int(entry.get("generation", 0)))
            log.warning("generation %s of %s is missing; chain "
                        "truncated to the verified prefix",
                        entry.get("generation"), log_path)
            return None
        if zlib.crc32(blob) != entry.get("crc32"):
            quarantine_path(snap_path, "colseg")
            _truncate_chain(log_path, manifest,
                            int(entry.get("generation", 0)))
            log.warning("generation %s of %s failed CRC; quarantined — "
                        "scans fall back to the JSON parse",
                        entry.get("generation"), log_path)
            return None
        try:
            cols = _deserialize_cols(blob)
        except Exception:  # noqa: BLE001 — any decode failure = corrupt
            quarantine_path(snap_path, "colseg")
            _truncate_chain(log_path, manifest,
                            int(entry.get("generation", 0)))
            log.exception("generation %s of %s failed to decode; "
                          "quarantined", entry.get("generation"),
                          log_path)
            return None
        pieces.append(("cols", cols, entry))
        decoded += len(blob)
    if skipped:
        _M_WINDOW_SKIPS.inc(skipped)
    _M_SNAP_LOADS.inc()
    return {"pieces": pieces, "covered": covered, "floor": floor,
            "skipped": skipped, "decodedBytes": decoded,
            "generations": chain}


def load_snapshot(log_path: str):
    """Load the full committed snapshot view of one log, verified.

    Returns ``(ColumnarEvents, covered_bytes)`` or None (caller falls
    back to the JSON parse). Multi-generation chains merge in order
    through the scan merger, archived generations read through via the
    log bytes (``on_archived="parse"`` — serving never breaks on
    archival), and retired generations are excluded — ``covered`` still
    reports the full committed prefix, so incremental tail parses
    resume at the right byte."""
    from ...native import parse_events
    from ..storage.jsonl import _LogScan

    got = load_chain(log_path, on_archived="parse")
    if got is None:
        return None
    pieces = got["pieces"]
    only = [p for p in pieces if p[0] == "cols"]
    if len(pieces) == 1 and len(only) == 1:
        return only[0][1], got["covered"]
    scan = _LogScan()
    for piece in pieces:
        if piece[0] == "cols":
            cols = piece[1]
        else:  # "gap": archived — re-parse its log byte range
            entry = piece[1]
            try:
                with open(log_path, "rb") as f:
                    f.seek(int(entry.get("start", 0)))
                    raw = f.read(int(entry.get("end", 0))
                                 - int(entry.get("start", 0)))
            except OSError:
                return None
            cols = parse_events(raw)
        if scan.cols is None:
            scan.cols = cols
            scan._merge_tombstones(scan.tombstones, cols)
        else:
            scan._extend(cols)
    if scan.cols is None:
        scan.cols = parse_events(b"")
    return scan.cols, got["covered"]


# ---------------------------------------------------------------------------
# tiered retention: the retired/ tier
# ---------------------------------------------------------------------------

def retention_ttl_us() -> Optional[int]:
    """The ``PIO_EVENT_RETENTION`` TTL in microseconds, or None when
    retention is off (unset/malformed — a typo must never expire
    data)."""
    from ...common import train_window

    return train_window.parse_duration_us(
        envknobs.env_str("PIO_EVENT_RETENTION", ""))


def _retirable(entry: dict, cutoff_us: int) -> bool:
    """A generation may retire only when EVERY row in it is provably
    expired: bounded (non-legacy) metadata, no untimed rows (an absent
    eventTime means "now" — never expired), and its newest timed row
    older than the cutoff."""
    if entry.get("legacy"):
        return False
    if int(entry.get("untimedRows") or 0) != 0:
        return False
    hi = entry.get("maxEventUs")
    if hi is None:
        # no timed rows AND no untimed rows: an empty generation —
        # safe to retire (nothing to lose)
        return int(entry.get("events") or 0) == 0
    return int(hi) < cutoff_us


def _sweep_retired(dirpath: str, chain: list) -> int:
    """Move every tier=retired entry's snapshot file that still sits in
    the hot directory into ``retired/`` (quarantine-style: renamed,
    never unlinked). Idempotent — the convergence half of
    :func:`retire_expired`, re-run after any crash."""
    moved = 0
    rdir = os.path.join(dirpath, RETIRED_DIR)
    for entry in chain:
        if entry.get("tier") != "retired" or not entry.get("file"):
            continue
        src = os.path.join(dirpath, entry["file"])
        if not os.path.exists(src):
            continue
        os.makedirs(rdir, exist_ok=True)
        try:
            os.replace(src, os.path.join(rdir, entry["file"]))
            moved += 1
        except OSError:  # pragma: no cover — racing sweep is fine
            continue
    if moved:
        _fsync_dir(rdir)
        _fsync_dir(dirpath)
    return moved


def retire_expired(log_path: str, ttl_us: Optional[int] = None,
                   now_us: Optional[int] = None) -> Optional[dict]:
    """Move fully-expired generations of one log to the retired tier.

    TTL comes from ``ttl_us`` or the ``PIO_EVENT_RETENTION`` knob; with
    neither set this only runs the convergence sweep (finishing any
    crashed earlier pass). Only a contiguous PREFIX of the chain ever
    retires: a retired generation's tombstones and duplicate ids stop
    being replayed, which is exactly correct when no earlier live rows
    remain for them to act on — an expired generation sitting behind a
    live one keeps serving until the prefix catches up.

    Commit protocol (the compaction discipline): the manifest marking
    the entries ``tier="retired"`` is shadow-written, fsynced and
    atomically renamed — the COMMIT record (``retire.rename`` is the
    crash point just before it lands). Only after the commit do the
    snapshot files move into ``retired/`` (never unlinked in place);
    a crash between commit and move leaves strays the next pass
    sweeps. Readers exclude retired entries by tier, and JSON fallback
    parses start at :func:`parse_floor` — the log's own bytes are NOT
    rewritten (append handles stay valid), so retirement reclaims the
    decoded view, not the raw JSONL.

    Returns ``{"retired", "generations", "floor", "swept"}`` or None
    (no manifest)."""
    manifest = _read_manifest(log_path)
    if manifest is None:
        return None
    dirpath = os.path.dirname(log_path) or "."
    chain = [dict(e) for e in _generations(manifest)]
    if ttl_us is None:
        ttl_us = retention_ttl_us()
    newly: list = []
    if ttl_us is not None:
        now = now_us if now_us is not None else int(
            _dt.datetime.now(_dt.timezone.utc).timestamp() * 1e6)
        cutoff = now - ttl_us
        for entry in chain:
            if entry.get("tier") == "retired":
                continue  # already-retired prefix
            if entry.get("tier") != "archived" \
                    and _retirable(entry, cutoff):
                newly.append(entry)
                continue
            break  # first live generation ends the retirable prefix
    if newly:
        stamp = _dt.datetime.now(_dt.timezone.utc).isoformat()
        for entry in newly:
            entry["tier"] = "retired"
            entry["retiredAt"] = stamp
        committed = dict(manifest)
        committed["generations"] = chain
        mtmp = _manifest_path(log_path) + ".tmp"
        with open(mtmp, "w") as f:
            json.dump(committed, f)
            f.flush()
            os.fsync(f.fileno())
        fault_point("retire.rename")
        os.replace(mtmp, _manifest_path(log_path))
        _fsync_dir(dirpath)
        _M_RETIRED.inc(len(newly))
        log.info("retired %d generation(s) of %s (event-time TTL)",
                 len(newly), log_path)
    swept = _sweep_retired(dirpath, chain)
    return {"retired": len(newly),
            "generations": [int(e.get("generation", 0)) for e in newly],
            "floor": parse_floor(log_path), "swept": swept}


def remove_artifacts(log_path: str) -> None:
    """Delete one log's compaction artifacts (manifest + snapshot
    generations + stray shadow files). Called when the LOG ITSELF is
    being deleted — the snapshot is a full columnar copy of the data,
    and app-data deletion must not silently retain it on disk."""
    dirpath = os.path.dirname(log_path) or "."
    base = os.path.basename(log_path)

    def sweep(d: str) -> None:
        try:
            names = os.listdir(d)
        except OSError:
            return
        for name in names:
            if (name == base + MANIFEST_SUFFIX
                    or (name.startswith(base + ".g")
                        and (name.endswith(".colseg")
                             or name.endswith(".tmp")))):
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass

    sweep(dirpath)
    # retired-tier copies are full columnar data too: app deletion must
    # not silently retain them (archived blobs live on the cold source
    # and are the operator's to purge — `pio eventlog` names them)
    sweep(os.path.join(dirpath, RETIRED_DIR))


def _archive_models(storage=None):
    """(Models DAO on the cold source, source name). The source comes
    from ``PIO_EVENT_ARCHIVE_SOURCE`` and resolves through the storage
    registry: any configured source the port has (localfs, SQLite) can
    be the cold tier."""
    source = envknobs.env_str("PIO_EVENT_ARCHIVE_SOURCE", "",
                              lower=False)
    if not source:
        raise RuntimeError(
            "PIO_EVENT_ARCHIVE_SOURCE is not set: name the storage "
            "source (PIO_STORAGE_SOURCES_<NAME>_*) archived event-log "
            "generations should stream to")
    if storage is None:
        from ..storage.registry import Storage

        storage = Storage.instance()
    return storage._client_for_source(source).models(
        ARCHIVE_NAMESPACE), source


def archive_generation(log_path: str, generation: int,
                       storage=None) -> dict:
    """Stream one sealed hot generation to the cold archive source.

    Protocol — every step before the manifest commit leaves the hot
    state untouched and serving:

    1. read + CRC-verify the local snapshot (corruption is never
       archived);
    2. put the blob on the cold source (``archive.put``) under
       ``<log basename>.g<N>``;
    3. read it BACK and CRC-verify — the round-trip proof;
    4. commit the manifest marking the entry ``tier="archived"``
       (``archive.manifest`` precedes the rename);
    5. only after the commit, unlink the local file (the archived copy
       is now the record; a crash before this leaves a stray the next
       call or compaction gc converges).

    Returns the updated entry. Raises on an unknown/retired
    generation, a missing archive source, or any verification
    failure."""
    from ..storage import base as storage_base

    manifest = _read_manifest(log_path)
    if manifest is None:
        raise ValueError(f"no committed manifest for {log_path!r}")
    dirpath = os.path.dirname(log_path) or "."
    chain = [dict(e) for e in _generations(manifest)]
    entry = next((e for e in chain
                  if int(e.get("generation", -1)) == int(generation)),
                 None)
    if entry is None:
        raise ValueError(
            f"{log_path!r} has no generation {generation}")
    snap_path = os.path.join(dirpath, entry.get("file") or "")
    if entry.get("tier") == "retired":
        raise ValueError(
            f"generation {generation} of {log_path!r} is retired; "
            "only hot generations archive")
    models, source = _archive_models(storage)
    blob_id = f"{os.path.basename(log_path)}.g{int(generation)}"
    if entry.get("tier") == "archived":
        # converge a crashed earlier run: the commit landed, the local
        # unlink may not have
        try:
            os.remove(snap_path)
        except OSError:
            pass
        return entry
    with open(snap_path, "rb") as f:
        blob = f.read()
    if zlib.crc32(blob) != entry.get("crc32"):
        raise RuntimeError(
            f"generation {generation} of {log_path!r} fails CRC "
            "locally; refusing to archive a corrupt snapshot (run "
            "`pio eventlog scrub`)")
    fault_point("archive.put")
    models.insert(storage_base.Model(id=blob_id, models=blob))
    got = models.get(blob_id)
    if got is None or zlib.crc32(got.models) != entry.get("crc32"):
        raise RuntimeError(
            f"round-trip verification failed archiving generation "
            f"{generation} of {log_path!r} to source {source!r}; "
            "the hot copy remains authoritative")
    entry["tier"] = "archived"
    entry["archive"] = {
        "source": source, "id": blob_id,
        "archivedAt": _dt.datetime.now(_dt.timezone.utc).isoformat(),
    }
    committed = dict(manifest)
    committed["generations"] = chain
    mtmp = _manifest_path(log_path) + ".tmp"
    with open(mtmp, "w") as f:
        json.dump(committed, f)
        f.flush()
        os.fsync(f.fileno())
    fault_point("archive.manifest")
    os.replace(mtmp, _manifest_path(log_path))
    _fsync_dir(dirpath)
    try:
        os.remove(snap_path)
    except OSError:  # pragma: no cover — gc converges later
        pass
    _M_ARCHIVED.inc()
    log.info("archived generation %d of %s to source %s", generation,
             log_path, source)
    return entry


def restore_generation(log_path: str, generation: int,
                       storage=None) -> dict:
    """Fetch one archived generation back to the hot tier, verified.

    The blob is CRC-checked against the manifest entry (the archived
    copy must be checksum-identical to what left), shadow-written +
    fsynced + atomically renamed into the hot directory FIRST, and only
    then does the manifest commit flip the entry back to
    ``tier="hot"`` — a crash in between leaves a stray file the next
    restore (or compaction gc) handles, never a manifest pointing at
    nothing."""
    manifest = _read_manifest(log_path)
    if manifest is None:
        raise ValueError(f"no committed manifest for {log_path!r}")
    dirpath = os.path.dirname(log_path) or "."
    chain = [dict(e) for e in _generations(manifest)]
    entry = next((e for e in chain
                  if int(e.get("generation", -1)) == int(generation)),
                 None)
    if entry is None:
        raise ValueError(
            f"{log_path!r} has no generation {generation}")
    if entry.get("tier") != "archived":
        return entry  # already hot (converged) or retired (no-op)
    models, _source = _archive_models(storage)
    blob_id = (entry.get("archive") or {}).get("id") or (
        f"{os.path.basename(log_path)}.g{int(generation)}")
    got = models.get(blob_id)
    if got is None:
        raise RuntimeError(
            f"archived blob {blob_id!r} for generation {generation} of "
            f"{log_path!r} is missing from the archive source")
    if zlib.crc32(got.models) != entry.get("crc32"):
        raise RuntimeError(
            f"archived blob {blob_id!r} fails CRC against the manifest "
            f"for generation {generation} of {log_path!r}; refusing to "
            "restore a corrupt copy")
    snap_path = os.path.join(dirpath, entry.get("file") or "")
    tmp = snap_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(got.models)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, snap_path)
    _fsync_dir(dirpath)
    entry["tier"] = "hot"
    entry.pop("archive", None)
    entry["restoredAt"] = _dt.datetime.now(
        _dt.timezone.utc).isoformat()
    committed = dict(manifest)
    committed["generations"] = chain
    _commit_manifest(log_path, committed)
    _M_RESTORED.inc()
    log.info("restored generation %d of %s from the archive source",
             generation, log_path)
    return entry


def scrub_log_dir(dirpath: str) -> dict:
    """Verify every committed snapshot in one JSONL log directory;
    quarantine corrupt ones (:func:`load_snapshot` does the moving and
    counting). Returns ``{checked, ok, quarantined, stale}``."""
    report = {"checked": 0, "ok": 0, "quarantined": 0, "stale": 0}
    if not os.path.isdir(dirpath):
        return report
    qdir = os.path.join(dirpath, QUARANTINE_DIR)

    def qcount() -> int:
        return len(os.listdir(qdir)) if os.path.isdir(qdir) else 0

    for name in sorted(os.listdir(dirpath)):
        if not name.endswith(".jsonl" + MANIFEST_SUFFIX):
            continue
        log_path = os.path.join(dirpath, name[:-len(MANIFEST_SUFFIX)])
        report["checked"] += 1
        before = qcount()
        if load_snapshot(log_path) is not None:
            report["ok"] += 1
        elif qcount() > before:
            report["quarantined"] += 1
        else:
            report["stale"] += 1
    return report


# ---------------------------------------------------------------------------
# partition health (pio status / pio eventlog status)
# ---------------------------------------------------------------------------

def partition_health(events_dir: str) -> dict:
    """Health of one JSONL namespace dir for ``pio status`` /
    ``pio eventlog status``: per-log rows (file size, lease holder/epoch
    with staleness, last compaction, generations) plus the dir-level
    quarantine count."""
    out = {"logs": [], "quarantinedFiles": 0}
    if not os.path.isdir(events_dir):
        return out
    qdir = os.path.join(events_dir, QUARANTINE_DIR)
    out["quarantinedFiles"] = (
        len(os.listdir(qdir)) if os.path.isdir(qdir) else 0)
    for name in sorted(os.listdir(events_dir)):
        if not name.endswith(".jsonl"):
            continue
        path = os.path.join(events_dir, name)
        stem = name[:-6]
        partition = None
        if ".p" in stem:
            _stem_base, _, suffix = stem.rpartition(".p")
            if suffix.isdigit():
                partition = int(suffix)
        manifest = _read_manifest(path)
        lease = (lease_info(events_dir, partition)
                 if partition is not None else None)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        gens = []
        if manifest is not None:
            for e in _generations(manifest):
                gens.append({
                    "generation": e.get("generation"),
                    "tier": e.get("tier", "hot"),
                    "bytes": (int(e.get("end", 0))
                              - int(e.get("start", 0))),
                    "events": e.get("events"),
                    "minEventUs": e.get("minEventUs"),
                    "maxEventUs": e.get("maxEventUs"),
                    "legacy": bool(e.get("legacy")),
                })
        out["logs"].append({
            "log": name,
            "partition": partition,
            "bytes": size,
            "lease": lease,
            "lastCompaction": (manifest or {}).get("compactedAt"),
            "compactedEvents": (manifest or {}).get("events"),
            "compactedBytes": (manifest or {}).get("covered"),
            "generations": gens,
            "retiredBytes": sum(g["bytes"] for g in gens
                                if g["tier"] == "retired"),
        })
    out["retiredGenerations"] = sum(
        1 for row in out["logs"] for g in row["generations"]
        if g["tier"] == "retired")
    out["archivedGenerations"] = sum(
        1 for row in out["logs"] for g in row["generations"]
        if g["tier"] == "archived")
    return out



# ---------------------------------------------------------------------------
# multi-worker event serving (front listener + supervised workers)
# ---------------------------------------------------------------------------

def worker_env(idx: int, port: int, wal_dir: Optional[str] = None) -> dict:
    """Env overrides one event worker runs under: its partition identity,
    its private listen port and (when the WAL is armed) its OWN WAL
    subdirectory — per-partition WAL dirs keep the dir flock, the replay
    and the segment lifecycle single-owner."""
    env = {"PIO_EVENT_PARTITION": str(idx),
           "PIO_EVENT_WORKER_PORT": str(port)}
    if wal_dir:
        env["PIO_WAL_DIR"] = os.path.join(wal_dir, f"p{idx}")
    return env


def _replay_wal(config, what: str) -> None:
    """One recovery pass of a WAL directory the front owns (the root
    before the workers start, a retired partition's subdirectory). A dead
    store is logged, not fatal: ``pio wal replay`` lands it later."""
    from ..storage.registry import Storage
    from . import ingest_wal

    try:
        rec = ingest_wal.recover(Storage.instance(), config)
    except Exception:  # noqa: BLE001 - serve; the operator replays
        log.exception("%s WAL replay failed; run `pio wal replay` once "
                      "storage is healthy", what)
        return
    if rec["replayed"] or rec["deduped"]:
        log.info("%s: replayed %d WAL event(s), %d deduped", what,
                 rec["replayed"], rec["deduped"])


def front_info_path() -> str:
    """Where a running partitioned front advertises itself (pid, ports,
    live workers, scale-target file) for ``pio eventserver scale`` and
    ``pio status``."""
    from ..storage.registry import base_dir

    return os.path.join(base_dir(), "eventserver_front.json")


def run_partitioned_event_server(host: str, port: int, workers: int,
                                 enable_stats: bool = False) -> int:
    """Blocking entry for ``pio eventserver --workers N``: spawn N
    supervised worker processes (disjoint partitions, per-worker restart)
    and splice client connections to them.

    The front answers ``GET /healthz`` itself: the live workers, each
    one's pid, port and readiness (its ``GET /`` answering 200, probed
    every 200 ms) and ``readyWorkers``; every other request is spliced to
    a worker, ready ones first.

    Chaos hook: ``PIO_EVENT_WORKER_FAULT_SPEC`` (or
    ``PIO_EVENT_WORKER_FAULT_SPEC_<i>`` for worker i) becomes a worker's
    ``PIO_FAULT_SPEC`` on its FIRST launch only — a relaunched worker
    comes up clean, so an injected crash cannot relaunch-loop.

    **Runtime rescale**: ``pio eventserver scale N`` writes the target
    into the front's scale file and SIGHUPs it (a bare SIGHUP re-reads the
    file too). Scale-up adds workers at the lowest free partition indices.
    Scale-down retires the HIGHEST indices so partitions stay dense: the
    front stops routing new connections to the departing worker, the
    worker's SIGTERM path finishes its requests and releases its lease,
    and the front then claims the orphaned lease with an epoch bump
    (fencing any wedged straggler writer) and PARKS it until a scale-up
    hands it — released, for a fresh claim — to the newcomer. The
    orphaned shard stays readable through the merged view.

    **The write-ahead log** (``PIO_WAL=1``): worker i logs into
    ``<wal_dir>/p<i>`` and replays it at start-up, after its lease claim.
    The front replays the WAL root once before the workers start (what a
    single-process deployment left), and a retired partition's
    subdirectory once it has parked the lease (acknowledged events a
    crashed drain left uncommitted)."""
    from ...common.splice import FrontProxy, probe_ready
    from ...parallel.supervisor import Supervisor
    from . import ingest_wal

    wal_cfg = ingest_wal.WalConfig.from_env()
    if wal_cfg.enabled and os.path.isdir(wal_cfg.dir):
        _replay_wal(wal_cfg, "the front (WAL root)")
    workers = max(1, int(workers))
    ports: list = [Supervisor._free_port() for _ in range(workers)]
    base_env = dict(os.environ)
    chaos = base_env.pop("PIO_EVENT_WORKER_FAULT_SPEC", None)
    per_worker_chaos = {
        i: base_env.pop(f"PIO_EVENT_WORKER_FAULT_SPEC_{i}")
        for i in range(workers)
        if f"PIO_EVENT_WORKER_FAULT_SPEC_{i}" in base_env}
    base_env.pop("PIO_EVENT_WORKERS", None)
    base_env.pop("PIO_EVENT_PARTITION", None)

    def env_for(attempt: int, idx: int) -> dict:
        if attempt > 0:
            # the original port pick is a TOCTOU (the probe socket closed
            # before the worker binds): each respawn re-picks, and the
            # front routes off the live list
            ports[idx] = Supervisor._free_port()
        env = worker_env(idx, ports[idx],
                         wal_cfg.dir if wal_cfg.enabled else None)
        spec = per_worker_chaos.get(idx, chaos)
        if spec and attempt == 0:
            env["PIO_FAULT_SPEC"] = spec
        return env

    argv = [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
            "eventserver", "--worker"] + (["--stats"] if enable_stats else [])
    proxy_ref: dict = {"proxy": None}
    sup = Supervisor(argv, workers, env=base_env, per_worker_env=env_for,
                     restart_scope="worker")
    sup_done = threading.Event()
    outcome: dict = {}

    def run_sup():
        try:
            outcome["state"] = sup.run()
        except BaseException:  # noqa: BLE001 — a crashed supervisor is a
            # failed service, not a clean drain
            log.exception("event-server supervisor crashed")
            outcome["state"] = "error"
        finally:
            sup_done.set()

    t = threading.Thread(target=run_sup, daemon=True)
    t.start()
    log.info("partitioned event server: front on %s:%d, %d worker(s) on "
             "ports %s (run dir %s)", host, port, workers, ports,
             sup.run_dir)

    # runtime-rescale state (mutated on the front's event loop only): live
    # partition indices, indices mid-retirement, and the orphaned leases
    # the front holds parked after a scale-down
    live: set = set(range(workers))
    retiring: set = set()
    parked: dict = {}
    scale_path = os.path.join(sup.run_dir, "scale_target")
    info_path = front_info_path()
    le_dir = None
    try:
        from ..storage.registry import Storage

        le_dir = getattr(Storage.instance().get_l_events(), "events_dir",
                         None)
    except Exception:  # noqa: BLE001 — a store without a log dir: no leases
        log.debug("event store has no JSONL dir; lease handoff off",
                  exc_info=True)

    def publish_info() -> None:
        doc = {"pid": os.getpid(), "host": host, "port": port,
               "workers": sorted(live), "retiring": sorted(retiring),
               "parkedPartitions": sorted(parked),
               "scaleFile": scale_path, "runDir": sup.run_dir}
        tmp = info_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, info_path)
        except OSError:  # pragma: no cover — basedir ripped out
            log.debug("could not publish front info", exc_info=True)

    def read_scale_target() -> Optional[int]:
        try:
            with open(scale_path) as f:
                return max(1, int(f.read().strip()))
        except (OSError, ValueError):
            return None

    def adopt_partition(idx: int) -> None:
        """After a retirement: claim the orphan's lease (the epoch bump
        fences any straggler), keep it parked on the front, and replay the
        partition's WAL subdirectory — every acknowledged event lands once
        even when the drain died mid-commit."""
        if le_dir is not None and idx not in parked:
            try:
                parked[idx] = claim_partition(le_dir, idx)
            except PartitionHeldError:
                # the drained worker's flock went with it; a HELD flock
                # here is a wedged straggler — fence past it
                parked[idx] = claim_partition(le_dir, idx, force=True)
        if wal_cfg.enabled:
            pdir = os.path.join(wal_cfg.dir, f"p{idx}")
            if os.path.isdir(pdir):
                _replay_wal(ingest_wal.WalConfig(
                    enabled=True, fsync=wal_cfg.fsync, dir=pdir,
                    segment_bytes=wal_cfg.segment_bytes),
                    f"retired partition {idx}")

    #: the worker pid each positive readiness probe answered for: a
    #: relaunched worker is not ready on the strength of its predecessor's
    #: last probe
    ready_pid: dict = {}

    def healthz() -> dict:
        proxy = proxy_ref["proxy"]
        backends = []
        for idx in sorted(live):
            pid = sup.worker_pid(idx)
            backends.append({
                "worker": idx, "pid": pid,
                "port": ports[idx] if idx < len(ports) else None,
                "ready": bool(proxy is not None and proxy.is_ready(idx)
                              and pid is not None
                              and ready_pid.get(idx) == pid),
                "retiring": idx in retiring,
                "restarts": (sup.worker_restarts[idx]
                             if idx < len(sup.worker_restarts) else 0)})
        return {"status": "alive", "workers": sorted(live),
                "readyWorkers": sum(1 for b in backends
                                    if b["ready"] and not b["retiring"]),
                "retiring": sorted(retiring),
                "parkedPartitions": sorted(parked), "backends": backends,
                "supervisor": sup.state}

    async def front_main() -> None:
        import signal as _signal

        proxy = FrontProxy(ports, healthz_provider=healthz,
                           connect_retry_s=envknobs.env_ms(
                               "PIO_EVENT_CONNECT_RETRY_MS", 0.0))
        for idx in range(workers):
            proxy.set_ready(idx, False)  # probed before it is preferred
        proxy_ref["proxy"] = proxy
        await proxy.start(host, port)
        stop = asyncio.Event()
        rescale = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (_signal.SIGTERM, _signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):  # pragma: no cover
                pass
        try:
            loop.add_signal_handler(_signal.SIGHUP, rescale.set)
        except (NotImplementedError, RuntimeError,
                AttributeError):  # pragma: no cover — non-POSIX
            pass
        await asyncio.to_thread(publish_info)

        async def ready_loop() -> None:
            while True:
                for idx in sorted(live):
                    p = ports[idx] if idx < len(ports) else None
                    pid = sup.worker_pid(idx)
                    ok = (p is not None and pid is not None
                          and await probe_ready("127.0.0.1", p, 1.0,
                                                path="/")
                          and sup.worker_pid(idx) == pid)
                    ready_pid[idx] = pid if ok else None
                    proxy.set_ready(idx, ok)
                await asyncio.sleep(0.2)

        def apply_target(target: int) -> None:
            # dense partitions: grow at the lowest free index, shrink from
            # the top — writes land in each worker's OWN shard, so
            # membership is purely "which indices are live"
            current = sorted(live)
            while len(live) - len(retiring) < target:
                idx = 0
                while idx in live:
                    idx += 1
                lease = parked.pop(idx, None)
                if lease is not None:
                    # hand the parked lease to the newcomer: release, and
                    # its start-up claim bumps the epoch again
                    lease.release()
                while len(ports) <= idx:
                    ports.append(None)
                ports[idx] = Supervisor._free_port()
                proxy.set_backend(idx, ports[idx])
                proxy.set_ready(idx, False)
                live.add(idx)
                sup.add_worker(idx)
                log.info("rescale: worker %d spawning (target %d)", idx,
                         target)
            victims = [i for i in current if i not in retiring]
            while len(live) - len(retiring) > target and victims:
                idx = victims.pop()  # the highest live index
                proxy.set_draining(idx, True)
                retiring.add(idx)
                sup.retire_worker(idx)
                log.info("rescale: worker %d draining (target %d)", idx,
                         target)

        async def rescale_loop() -> None:
            while True:
                if retiring:
                    await asyncio.sleep(0.1)
                else:
                    await rescale.wait()
                rescale.clear()
                for idx in sorted(retiring, reverse=True):
                    if sup.worker_pid(idx) is None \
                            and not sup.is_retiring(idx):
                        # booked out: finished, lease released — adopt it
                        await asyncio.to_thread(adopt_partition, idx)
                        proxy.set_backend(idx, None)
                        ports[idx] = None
                        retiring.discard(idx)
                        live.discard(idx)
                        log.info("rescale: worker %d retired; partition "
                                 "lease parked on the front", idx)
                        await asyncio.to_thread(publish_info)
                target = await asyncio.to_thread(read_scale_target)
                if target is not None \
                        and target != len(live) - len(retiring):
                    apply_target(target)
                    await asyncio.to_thread(publish_info)

        tasks = [loop.create_task(rescale_loop()),
                 loop.create_task(ready_loop())]
        # the front lives exactly as long as its workers: a supervisor
        # that gave up takes the front down
        while not stop.is_set() and not sup_done.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=0.25)
            except asyncio.TimeoutError:
                pass
        for task in tasks:
            task.cancel()
        for task in tasks:
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        await proxy.stop()
        sup.request_stop()

    try:
        asyncio.run(front_main())
    finally:
        # the crash path too (e.g. the front's port taken): the supervisor
        # started first, so its workers must be drained either way
        sup.request_stop()
        sup_done.wait(timeout=60)
        t.join(timeout=5)
        for lease in parked.values():
            lease.release()
        try:
            os.unlink(info_path)
        except OSError:
            pass
    state = outcome.get("state", "wedged")
    log.info("partitioned event server stopped (%s)", state)
    return 0 if state in ("drained", "completed") else 1
