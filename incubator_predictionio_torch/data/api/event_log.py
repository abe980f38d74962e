"""The event log's columnar compaction, generations, retention and health.

The port's own copy of the single-process part of
``incubator_predictionio_tpu/data/api/event_log.py``: the same snapshot
files (``<log>.g<N>.colseg``, the same npz keys and ``SNAPSHOT_VERSION``),
the same manifest (schema v2, ``<log>.manifest``) and the same commit
protocol, so a directory compacted by either package is read by the other.

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

Not ported yet (ROADMAP.md Queue 1): claiming and fencing partition
leases and the partitioned multi-worker event server (only the read-only
:func:`lease_info` view is here), archiving generations to a cold source
and restoring them (an archived generation is read back from the log's
bytes, or named in :class:`ArchivedGenerationError`), and the telemetry
counters.
"""

from __future__ import annotations

import datetime as _dt
import io
import json
import logging
import os
import zlib
from typing import Optional

import numpy as np

from ...common import envknobs
from ...common.faultinject import fault_point

log = logging.getLogger("pio.torch.eventlog")

__all__ = [
    "ArchivedGenerationError", "compact_log", "lease_info", "load_chain",
    "load_snapshot", "parse_floor", "partition_health", "retire_expired",
    "scrub_log_dir",
]

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
# partition leases: the read-only view
# ---------------------------------------------------------------------------

def _lease_path(dirpath: str, partition: int) -> str:
    return os.path.join(dirpath, f".p{partition}.lease")


def _read_lease_body(fd: int) -> dict:
    try:
        return json.loads(os.pread(fd, 4096, 0).decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError):
        return {}


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
    """A windowed read needs a generation whose snapshot lives only on the
    cold archive source (written by the reference's ``pio eventlog
    archive``). Names the generations; restoring them is not ported yet
    (restore them with the reference's ``pio eventlog restore``)."""

    def __init__(self, log_path: str, generations: list):
        self.log_path = log_path
        self.generations = list(generations)
        gens = ", ".join(str(g) for g in self.generations)
        super().__init__(
            f"generation(s) {gens} of {log_path!r} are archived; restore "
            "them with `pio eventlog restore` (the reference's; this "
            "package does not restore archived generations yet)")


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
               on_archived: str = "raise") -> Optional[dict]:
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
    :class:`ArchivedGenerationError` names the generation) or
    ``"parse"``.

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
            if on_archived == "parse":
                pieces.append(("gap", entry))
                continue
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

