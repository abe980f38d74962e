"""`pio status/eventserver/eventlog/export/import` (reference: tools/.../
commands/{Management,Export,Import}.scala, tools/export/EventsToFile.scala,
tools/imprt/FileToEvents.scala).

The port's own copy of those verbs of ``incubator_predictionio_tpu/tools/
commands/management.py`` (``status`` :18 with its fold-in cursor rows
``_print_foldin_cursors`` :921, ``--engine-url``'s
``_print_engine_overload`` :160 with its fold-in, quality (``_print_quality``
:330) and tenant (``_print_tenants`` :291) lines, ``wal`` :405-487,
``eventserver [--stats]`` :538, ``eventserver --workers N`` / ``--worker``
:540-578 and ``eventserver scale N`` :489-537, ``eventlog`` :687-1002,
``export`` :1113, ``import`` :1155, ``storageserver`` :1005, and the
operator tools :1235-1352: ``adminserver``, ``template``, ``run``,
``upgrade``, ``shell``) for JSON-lines and Parquet files; ``import``
writes to whichever event store is configured. Parquet needs pyarrow,
imported only when the format is Parquet: without it the verb fails
naming pyarrow and writes nothing (there is no JSON-lines fallback).
``eventlog`` has ``compact``, ``scrub``, ``status``, ``fence``,
``retire``, ``archive``, ``restore`` and ``tail``; ``wal`` has
``inspect`` and ``replay``. ``status`` also names a running partitioned
event-server front, prints each network store's circuit breakers and the
last soak's one-liner (``SOAK.json`` in the working directory). ``fleet
plan`` (:582) and the fleet and autoscaler lines of ``status
--engine-url`` (``_print_fleet`` :355, ``_print_autoscaler`` :262) read a
serving fleet's front. ``template`` lists and copies the port's own
bundle (``incubator_predictionio_torch/templates/``), whose engine.json
files name the port's factories.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import Optional

from ...common import envknobs
from ...data.storage.event import Event
from ...data.storage.registry import REPOSITORIES, Storage, base_dir
from . import verb

#: events per ``insert_batch`` of an import (the reference's batch size)
IMPORT_BATCH = 20_000


def _kernel_status() -> str:
    """What the solve kernels would run on: the card and the nvcc that
    builds them, whether the current source is already built, or why the
    card path is off."""
    import torch

    from ...ops import _build

    if not torch.cuda.is_available():
        return ("no CUDA card visible (torch.cuda.is_available() is False); "
                "train and deploy need --device cpu here")
    try:
        nvcc = _build.find_nvcc()
    except RuntimeError as e:
        return f"CUDA card {torch.cuda.get_device_name(0)}, but {e}"
    built = _build.library_path("gauss_jordan").is_file()
    return (f"CUDA card {torch.cuda.get_device_name(0)}, nvcc {nvcc}; "
            f"gauss_jordan {'built' if built else 'builds at first launch'} "
            f"in {_build.build_dir()}")


@verb("status", "verify storage configuration and the kernel build")
def status_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio status")
    p.add_argument("--engine-url",
                   default=envknobs.env_str(
                       "PIO_ENGINE_URL", "", lower=False) or None,
                   help="also query a running engine server's GET /status "
                        "and report its overload counters (shed / "
                        "deadline / drain) and model lifecycle (default "
                        "$PIO_ENGINE_URL)")
    ns = p.parse_args(args)
    s = Storage.instance()
    print("[info] Inspecting storage backend connections...")
    for repo in REPOSITORIES:
        print(f"[info]   {repo}: {s.repo_source_type(repo)}")
    errors = s.verify_all_data_objects()
    # per-backend circuit-breaker state (common/resilience.py): which wire
    # endpoints are healthy, tripped open, or probing half-open
    for repo, health in s.backend_health().items():
        for b in health.get("breakers", []):
            marker = "[info]" if b["state"] == "closed" else "[warn]"
            print(f"{marker}   {repo}: breaker {b['name']} is "
                  f"{b['state']} (failures={b['failure']}, "
                  f"opened={b['opened']})")
    if errors:
        for e in errors:
            print(f"[error] {e}", file=sys.stderr)
        return 1
    print(f"[info] Storage OK. Base dir: {base_dir()}")
    apps = s.get_meta_data_apps().get_all()
    print(f"[info] {len(apps)} app(s) registered.")
    print(f"[info] Solve kernels: {_kernel_status()}")
    from ... import native

    log_dir = getattr(s.get_l_events(), "events_dir", None)
    try:
        print(f"[info] Event codec: {native.status()}")
    except native.NativeUnavailable as e:
        # a JSONL event store cannot be read without it
        print(f"[{'error' if log_dir else 'warn'}] Event codec: {e}",
              file=sys.stderr)
        if log_dir:
            return 1
    if log_dir is not None and os.path.isdir(log_dir):
        from ...data.api import event_log

        health = event_log.partition_health(log_dir)
        if health["logs"]:
            print(f"[info] Event log: {len(health['logs'])} log file(s) "
                  f"in {log_dir}")
            _print_partition_health(health, log_dir)
    _print_event_front()
    # where each app's online fold-in tailer stands, with the freshness-lag
    # warn-marker
    _print_foldin_cursors(s)
    # the last production-day soak's verdict (`pio soak` writes ./SOAK.json)
    _print_soak_verdict()
    if ns.engine_url:
        _print_engine_overload(ns.engine_url)
    return 0


def _print_soak_verdict(path: str = "SOAK.json") -> None:
    """One line summarizing the last soak scorecard in the working
    directory: whether production day last went green, with the seed that
    replays it if it did not."""
    from ...workflow.soak import read_scorecard

    doc = read_scorecard(path)
    if not doc or "verdict" not in doc:
        return
    ok = doc.get("verdict") == "PASS"
    slos = doc.get("slos") or []
    green = sum(1 for s in slos if s.get("ok"))
    fired = sum(1 for f in (doc.get("faults") or []) if f.get("fired"))
    age_h = (time.time() - float(doc.get("startedAt") or 0)) / 3600.0
    marker = "[info]" if ok else "[warn]"
    extra = "" if ok else (
        " — VIOLATED: "
        + ", ".join(s["name"] for s in slos if not s.get("ok"))
        + f"; replay with `pio soak --seed {doc.get('seed')}`")
    print(f"{marker} Last soak ({path}): {doc.get('verdict')}, "
          f"{green}/{len(slos)} SLO(s) green, {fired} fault(s) "
          f"injected, seed {doc.get('seed')}, {age_h:.1f}h ago{extra}")


def _print_event_front() -> None:
    """The partitioned event-server front's entry, from the info file it
    publishes while it runs (``pio eventserver --workers N``)."""
    from ...data.api.event_log import front_info_path

    try:
        with open(front_info_path(), encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return
    alive = True
    try:
        os.kill(int(doc["pid"]), 0)
    except (OSError, KeyError, TypeError, ValueError):
        alive = False
    marker = "[info]" if alive else "[warn]"
    print(f"{marker} Event-server front: pid {doc.get('pid')}"
          f"{'' if alive else ' (not running: stale info file)'} on "
          f"{doc.get('host')}:{doc.get('port')}, workers "
          f"{doc.get('workers')}, retiring {doc.get('retiring')}, parked "
          f"partitions {doc.get('parkedPartitions')}")


def _print_engine_overload(url: str) -> None:
    """The operator's view of a live engine server: its /status overload
    and lifecycle sections."""
    from .models import engine_status

    base = url if "://" in url else f"http://{url}"
    try:
        doc = engine_status(url)
    except Exception as e:  # noqa: BLE001 - diagnostics, not a failure
        print(f"[warn] engine server at {base} unreachable: {e}")
        return
    ov = doc.get("overload")
    if not ov:
        print(f"[warn] engine server at {base} predates the overload "
              "surface (no `overload` on /status)")
        return
    marker = "[warn]" if (ov.get("draining") or ov.get("shed")
                          or ov.get("deadlineExceeded")
                          or ov.get("drainStragglers")) else "[info]"
    print(f"[info] Engine server {base}: instance "
          f"{doc.get('engineInstanceId')}, {doc.get('queryCount')} "
          "queries served"
          + (", DEGRADED" if doc.get("degraded") else ""))
    print(f"{marker}   serving: pending {ov.get('pending')}"
          f"/{ov.get('pendingLimit')} (peak {ov.get('peakPending')}, "
          f"conc {ov.get('conc')}), shed={ov.get('shed')}, "
          f"deadlineExceeded={ov.get('deadlineExceeded')}, "
          f"orphaned={ov.get('orphaned')}, "
          f"draining={ov.get('draining')}, "
          f"drainStragglers={ov.get('drainStragglers')}")
    lc = doc.get("lifecycle")
    if lc:
        rollbacks = sum((lc.get("rollbacks") or {}).values())
        pinned = lc.get("pinned") or {}
        integ = {k: v for k, v in
                 (lc.get("integrityFailures") or {}).items() if v}
        marker = "[warn]" if (rollbacks or pinned or integ
                              or lc.get("validateFailures")) else "[info]"
        pins = (", ".join(f"{i} ({r})" for i, r in sorted(pinned.items()))
                or "none")
        rms = lc.get("refreshMs")
        if isinstance(rms, (int, float)) and rms:
            refresh = (f"every {rms:.0f}ms "
                       f"({lc.get('refreshSwaps')} swap(s))")
        elif rms:
            refresh = str(rms)  # e.g. "disabled(file)": the reason
        else:
            refresh = "off"
        print(f"{marker}   lifecycle: previous {lc.get('previous')}, "
              f"swaps={lc.get('swaps')}, rollbacks={rollbacks} "
              f"{lc.get('rollbacks')}, "
              f"validateFailures={lc.get('validateFailures')}, "
              f"integrityFailures={integ or 0}, "
              f"refresh {refresh}, pinned: {pins}")
    cache = doc.get("queryCache")
    if cache:
        print(f"[info]   query cache: {cache.get('entries')}/"
              f"{cache.get('maxEntries')} entries, hits={cache.get('hits')}, "
              f"misses={cache.get('misses')}, "
              f"invalidations={cache.get('invalidations')}")
    fi = doc.get("foldin")
    if fi:
        _print_foldin(fi)
    q = doc.get("quality")
    if q:
        _print_quality(q)
    tenants = doc.get("tenants")
    if tenants:
        _print_tenants(tenants)
    fleet = doc.get("fleet")
    if fleet:
        _print_fleet(fleet)
    _print_autoscaler(base)


def _fetch_json(url: str, timeout: float = 5.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


def _print_autoscaler(base: str) -> None:
    """The elastic-fleet line off the FRONT's /healthz (a single server or
    a fixed fleet has no ``elastic`` section and prints nothing):
    current/target/min/max, the last acted decision with its reason and
    age, and what the loop says right now."""
    try:
        doc = _fetch_json(f"{base}/healthz", timeout=3.0)
    except Exception:  # noqa: BLE001 — no front: nothing to print
        return
    el = (doc or {}).get("elastic")
    if not el:
        return
    acted = el.get("decisions") or []
    last = acted[-1] if acted else None
    if last:
        age = max(0.0, time.time() - float(last.get("at") or 0))
        last_s = (f"last decision {last.get('direction')} "
                  f"({last.get('reason')}) {age:.1f}s ago")
    else:
        last_s = "no scale actions yet"
    now_d = el.get("lastDecision") or {}
    gates = now_d.get("gates") or []
    print(f"[info]   autoscaler: {el.get('actual')} active / target "
          f"{el.get('target')} (min {el.get('min')}, max "
          f"{el.get('max')}), {last_s}; now "
          f"{now_d.get('direction', 'hold')}"
          + (f" ({now_d.get('reason')})" if now_d.get("reason") else "")
          + (f" gated by {','.join(gates)}" if gates else ""))


def _print_fleet(fleet: dict) -> None:
    """The per-replica fleet view (the answering replica's store-fed
    aggregation): rollout state, every peer's instance, pins and watch,
    and a warn-marker on divergence or a stale row."""
    from ...workflow import model_artifact

    d = fleet.get("directive") or {}
    peers = fleet.get("peers") or []
    diverged = bool(fleet.get("divergence"))
    marker = "[warn]" if diverged else "[info]"
    canary = (f", canary replica {d.get('canaryReplica')} -> "
              f"{d.get('target')}" if d.get("state") == "canary" else "")
    print(f"{marker}   fleet {fleet.get('group')}: "
          f"{len(peers)}/{fleet.get('replicas')} replica(s) reporting, "
          f"state {d.get('state') or 'bootstrapping'}, instance "
          f"{d.get('instance')}{canary} (epoch {d.get('epoch')}, "
          f"answered by replica {fleet.get('replica')})"
          + (" — REPLICAS DIVERGE" if diverged else ""))
    now = time.time()
    # staleness tracks the fleet's own sync cadence (the coordinator's rule)
    stale_after = model_artifact.fleet_fresh_s(
        float(fleet.get("syncMs") or 1000))
    for peer in sorted(peers, key=lambda x: x.get("replica", -1)):
        age = now - float(peer.get("updatedAt") or now)
        flags = []
        if (d.get("state") == "canary"
                and peer.get("replica") == d.get("canaryReplica")):
            flags.append("canary" + ("" if peer.get("watchDone")
                                     else " (watching)"))
        if peer.get("pinned"):
            flags.append(f"pinned={peer['pinned']}")
        if peer.get("draining"):
            flags.append("draining")
        stale = age > stale_after
        pmarker = "[warn]" if (stale or peer.get("pinned")
                               or peer.get("draining")) else "[info]"
        print(f"{pmarker}     r{peer.get('replica')}: instance "
              f"{peer.get('instance')}"
              + (f" [{', '.join(flags)}]" if flags else "")
              + f", updated {age:.1f}s ago"
              + (" — STALE (wedged or dead?)" if stale else ""))


def _print_foldin(fi: dict) -> None:
    """The fold-in line off /status: cursor, events folded, increments
    published and the freshness lag, warn-marked past 2x the interval."""
    if not fi.get("enabled", True):
        print(f"[warn]   fold-in: disabled — {fi.get('disabledReason')}")
        return
    lag = fi.get("lagSeconds")
    interval_s = float(fi.get("ms") or 0) / 1000.0
    stale = lag is not None and interval_s > 0 and lag > 2 * interval_s
    rollbacks = fi.get("rollbacks") or {}
    marker = "[warn]" if (stale or rollbacks or fi.get("lastError")) \
        else "[info]"
    print(f"{marker}   fold-in: every {float(fi.get('ms') or 0):.0f}ms, "
          f"app {fi.get('app')!r}, cursor {fi.get('cursorBytes')} byte(s), "
          f"{fi.get('events', 0)} event(s) folded, "
          f"{fi.get('publishes', 0)} increment(s) published, "
          f"rollbacks {rollbacks or 0}, freshness lag "
          + (f"{lag:.1f}s" if lag is not None else "n/a")
          + (" — STALE (> 2x the fold-in interval; loop failing?)"
             if stale else "")
          + (f"; last error: {fi['lastError']}" if fi.get("lastError")
             else ""))


def _print_tenants(t: dict) -> None:
    """The per-tenant table off /status: residency, cursor lag, pins, shed
    rate, one row per app, warn-marked when a tenant is pinned, degraded or
    rolled back."""
    print(f"[info]   tenants: {t.get('resident')}/{t.get('maxResident')}"
          f" resident of {t.get('known')} known, "
          f"{t.get('evictions')} eviction(s), "
          f"{t.get('coldLoads')} cold load(s), per-tenant budget "
          f"{t.get('maxPending')}")
    for row in t.get("tenants") or []:
        pinned = row.get("pinned") or {}
        flags = []
        if pinned:
            flags.append("pinned=" + ",".join(
                f"{i} ({r})" for i, r in sorted(pinned.items())))
        if row.get("degraded"):
            flags.append(f"DEGRADED: {row['degraded']}")
        if row.get("watch"):
            flags.append("watching")
        queries = int(row.get("queries") or 0)
        shed = int(row.get("shed") or 0)
        offered = queries + shed
        shed_pct = (100.0 * shed / offered) if offered else 0.0
        lag = row.get("cursorLagS")
        rollbacks = sum((row.get("rollbacks") or {}).values())
        marker = ("[warn]" if (pinned or row.get("degraded") or rollbacks)
                  else "[info]")
        print(f"{marker}     {row.get('app')}: "
              + ("resident" if row.get("resident") else "evicted")
              + f", instance {row.get('instance')}, "
              f"{queries} query(ies), shed {shed} ({shed_pct:.1f}%), "
              f"rollbacks={rollbacks}, cursor lag "
              + (f"{lag:.1f}s" if isinstance(lag, (int, float)) else "n/a")
              + (f" [{'; '.join(flags)}]" if flags else ""))


def _print_quality(q: dict) -> None:
    """The quality line off /status: sampling rate, graded samples, the
    live NDCG@k and the last-good delta, and the open watch."""
    if not q.get("enabled", True):
        print(f"[warn]   quality: disabled — {q.get('disabledReason')}")
        return
    live = q.get("live") or {}
    deltas = q.get("deltas") or {}
    watch = q.get("watch")
    breached = bool(q.get("breached"))
    marker = "[warn]" if breached else "[info]"
    watching = (f", watching {watch.get('instance')} "
                f"({watch.get('remainingMs', 0):.0f}ms left)"
                if watch else "")
    print(f"{marker}   quality: sampling {q.get('sample', 0) * 100:.1f}% "
          f"(k={q.get('k')}), {q.get('sampled', 0)} sampled / "
          f"{q.get('scored', 0)} graded / {q.get('expired', 0)} expired, "
          f"ndcg {live.get('ndcg', 0):.3f} over {live.get('n', 0)} "
          f"sample(s), last-good delta {deltas.get('ndcg', 0):+.3f}"
          f"{watching}"
          + (" — BREACHED (quality rollback armed/fired)"
             if breached else ""))


def _print_foldin_cursors(s: Storage) -> None:
    """``pio status`` rows of the online fold-in cursors: LSN, events
    folded and the freshness lag, warn-marked past 2x the fold-in interval
    (the loop is down, wedged or falling behind)."""
    try:
        from ...workflow import online

        rows = online.cursor_docs(s)
    except Exception:  # noqa: BLE001 — diagnostics only
        return
    now = time.time()
    for r in rows:
        cursor = r.get("cursor") or {}
        total = sum((cursor.get("shards") or {}).values())
        interval_s = float(r.get("intervalMs") or 0) / 1000.0
        anchor = r.get("caughtUpAt") or r.get("updatedAt") or now
        lag = max(0.0, now - float(anchor))
        stale = interval_s > 0 and lag > 2 * interval_s
        marker = "[warn]" if stale else "[info]"
        print(f"{marker} Online fold-in: app {r.get('app')!r} "
              f"(group {r.get('group')}): cursor at {total} byte(s) "
              f"across {len(cursor.get('shards') or {})} shard(s), "
              f"{r.get('events', 0)} event(s) folded, "
              f"{r.get('publishes', 0)} increment(s) published, "
              f"freshness lag {lag:.1f}s"
              + (f" — STALE (> 2x the {interval_s * 1000:.0f}ms "
                 "fold-in interval; loop down or wedged?)"
                 if stale else ""))


def _resolve_app_id(s: Storage, appid: Optional[int],
                    app_name: Optional[str]) -> int:
    if appid is not None:
        return appid
    if app_name:
        a = s.get_meta_data_apps().get_by_name(app_name)
        if a:
            return a.id
        raise SystemExit(f"App {app_name!r} does not exist.")
    raise SystemExit("Provide --appid or --app-name.")


def _channel_id(s: Storage, app_id: int, channel: Optional[str]):
    """(ok, channel id) of ``channel`` (None: the default channel)."""
    if not channel:
        return True, None
    chans = [c for c in s.get_meta_data_channels().get_by_appid(app_id)
             if c.name == channel]
    if not chans:
        print(f"Channel {channel!r} not found.", file=sys.stderr)
        return False, None
    return True, chans[0].id


#: columnar schema of a Parquet export (reference management.py:1049-1113):
#: the scalar event fields as string columns, the schemaless properties map
#: as a JSON-text column, times as UTC strings in the wire format, so a
#: Parquet round trip equals a JSON-lines one
_PARQUET_FIELDS = ("eventId", "event", "entityType", "entityId",
                   "targetEntityType", "targetEntityId", "properties",
                   "eventTime", "tags", "prId", "creationTime")


def _events_to_parquet(events, output: str) -> int:
    import pyarrow as pa
    import pyarrow.parquet as pq

    schema = pa.schema([(name, pa.string()) for name in _PARQUET_FIELDS])
    n = 0
    writer = pq.ParquetWriter(output, schema)
    try:
        cols: dict = {k: [] for k in _PARQUET_FIELDS}
        for e in events:
            doc = e.to_json()
            for k in _PARQUET_FIELDS:
                v = doc.get(k)
                if k == "properties":
                    v = json.dumps(v or {})
                elif k == "tags":
                    v = json.dumps(v) if v else None
                cols[k].append(v)
            n += 1
            if n % 50_000 == 0:
                writer.write_table(pa.table(cols, schema=schema))
                cols = {k: [] for k in _PARQUET_FIELDS}
        if cols["event"]:
            writer.write_table(pa.table(cols, schema=schema))
    finally:
        writer.close()
    return n


def _parquet_rows(path: str):
    """Raw string-typed rows; each is decoded in the import loop's
    per-record try, so one bad cell is a warning and a skip."""
    import pyarrow.parquet as pq

    for batch in pq.ParquetFile(path).iter_batches():
        yield from batch.to_pylist()


def _parquet_row_to_doc(row: dict) -> dict:
    doc = {k: v for k, v in row.items()
           if v is not None and k not in ("properties", "tags")}
    doc["properties"] = json.loads(row.get("properties") or "{}")
    if row.get("tags"):
        doc["tags"] = json.loads(row["tags"])
    return doc


def _detect_format(path: str, flag: str) -> str:
    if flag != "auto":
        return flag
    return "parquet" if path.endswith(".parquet") else "jsonl"


def _have_pyarrow(what: str) -> bool:
    """Whether pyarrow imports; if not, the error that names it."""
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet  # noqa: F401
    except ImportError:
        print(f"[error] parquet {what} needs pyarrow installed",
              file=sys.stderr)
        return False
    return True


def _format_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--format", choices=["auto", "jsonl", "parquet"],
                   default="auto",
                   help="auto = by extension (.parquet); the reference's "
                        "EventsToFile wrote json or parquet")


@verb("export", "export an app's events to JSONL or Parquet")
def export_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio export")
    p.add_argument("--appid", type=int, default=None)
    p.add_argument("--app-name", default=None)
    p.add_argument("--channel", default=None)
    p.add_argument("--output", required=True)
    _format_arg(p)
    ns = p.parse_args(args)
    s = Storage.instance()
    app_id = _resolve_app_id(s, ns.appid, ns.app_name)
    ok, channel_id = _channel_id(s, app_id, ns.channel)
    if not ok:
        return 1
    fmt = _detect_format(ns.output, ns.format)
    if fmt == "parquet" and not _have_pyarrow("export"):
        return 1
    events = s.get_p_events().find(app_id, channel_id)
    if fmt == "parquet":
        n = _events_to_parquet(events, ns.output)
    else:
        n = 0
        with open(ns.output, "w", encoding="utf-8") as f:
            for e in events:
                f.write(json.dumps(e.to_json()) + "\n")
                n += 1
    print(f"[info] Exported {n} events to {ns.output} ({fmt})")
    return 0


@verb("import", "import events from JSONL or Parquet into an app")
def import_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio import")
    p.add_argument("--appid", type=int, default=None)
    p.add_argument("--app-name", default=None)
    p.add_argument("--channel", default=None)
    p.add_argument("--input", required=True)
    _format_arg(p)
    ns = p.parse_args(args)
    s = Storage.instance()
    app_id = _resolve_app_id(s, ns.appid, ns.app_name)
    ok, channel_id = _channel_id(s, app_id, ns.channel)
    if not ok:
        return 1
    fmt = _detect_format(ns.input, ns.format)
    if fmt == "parquet" and not _have_pyarrow("import"):
        return 1
    le = s.get_l_events()
    le.init(app_id, channel_id)
    t0 = time.perf_counter()

    def records():
        """(record number, raw record); decoded inside the per-record try
        below, so a malformed record is a warning and a skip, not an
        aborted import."""
        if fmt == "parquet":
            yield from enumerate(_parquet_rows(ns.input), 1)
            return
        with open(ns.input, encoding="utf-8") as f:
            for line_no, line in enumerate(f, 1):
                line = line.strip()
                if line:
                    yield line_no, line

    # Streamed in batches: buffering a whole large file as Event objects
    # would hold every event in memory at once.
    batch, imported, skipped = [], 0, 0
    for rec_no, raw in records():
        try:
            doc = (_parquet_row_to_doc(raw) if fmt == "parquet"
                   else json.loads(raw))
            batch.append(Event.from_json(doc))
        except Exception as e:  # noqa: BLE001 - report and continue
            skipped += 1
            print(f"[warn] record {rec_no}: {e}", file=sys.stderr)
            continue
        if len(batch) >= IMPORT_BATCH:
            le.insert_batch(batch, app_id, channel_id)
            imported += len(batch)
            batch = []
    if batch:
        le.insert_batch(batch, app_id, channel_id)
        imported += len(batch)
    print(f"[info] Imported {imported} events ({skipped} skipped) in "
          f"{time.perf_counter() - t0:.3f}s.")
    return 0


@verb("eventlog", "compact, scrub, fence, retire or tail the JSONL event log")
def eventlog_cmd(args: list[str]) -> int:
    """Operator surface of the JSONL event log (data/api/event_log.py):
    `compact` seals the newly appended bytes of every log into a columnar
    snapshot generation (crash-safe: shadow file + atomic rename +
    manifest commit), `scrub` CRC-verifies committed snapshots and
    quarantines corrupt ones, `status` prints per-log health and the
    generations' event-time bounds, `fence` force-claims a partition
    lease (split-brain last resort: bumps the epoch so a wedged previous
    owner is refused on its next write), `retire` moves fully expired
    generations to the retired/ tier, `archive` streams one sealed
    generation to the cold source ($PIO_EVENT_ARCHIVE_SOURCE) and
    `restore` fetches it back, and `tail` reads events past a durable
    byte cursor."""
    p = argparse.ArgumentParser(prog="pio eventlog")
    sub = p.add_subparsers(dest="sub", required=True)
    p_compact = sub.add_parser(
        "compact", help="compact JSONL event logs into columnar "
                        "snapshots (additive + crash-safe; scans load "
                        "them instead of re-parsing JSON)")
    p_compact.add_argument("--min-new-bytes", type=int, default=0,
                           help="skip logs that grew less than this "
                                "since the last snapshot")
    sub.add_parser("scrub", help="verify snapshot CRCs; quarantine "
                                 "corrupt ones (never deletes)")
    sub.add_parser("status", help="per-log health: sizes, leases, "
                                  "compaction, generations, quarantine")
    p_fence = sub.add_parser(
        "fence", help="force-claim a partition lease past a held flock "
                      "(ONLY when the owner is wedged/unreachable)")
    p_fence.add_argument("--partition", type=int, required=True)
    p_retire = sub.add_parser(
        "retire", help="move fully-expired generations (event-time "
                       "TTL) to the retired/ tier; without --ttl or "
                       "$PIO_EVENT_RETENTION only the convergence "
                       "sweep runs (finishes a crashed earlier pass)")
    p_retire.add_argument("--ttl", default=None, metavar="DUR",
                          help="retention TTL (90d/12h/30m/45s); "
                               "default $PIO_EVENT_RETENTION")
    p_archive = sub.add_parser(
        "archive", help="stream one sealed generation to the cold "
                        "archive source named by "
                        "$PIO_EVENT_ARCHIVE_SOURCE (round-trip "
                        "CRC-verified before the local copy goes)")
    p_archive.add_argument("--log", required=True, metavar="NAME",
                           help="log file name as printed by "
                                "`pio eventlog status`")
    p_archive.add_argument("--generation", type=int, required=True)
    p_restore = sub.add_parser(
        "restore", help="fetch an archived generation back to the hot "
                        "tier (checksum-verified against the manifest)")
    p_restore.add_argument("--log", required=True, metavar="NAME")
    p_restore.add_argument("--generation", type=int, required=True)
    p_tail = sub.add_parser(
        "tail", help="read events past a durable byte cursor: prints "
                     "events as JSONL on stdout and the advanced cursor "
                     "on stderr — feed it back via --from to resume")
    p_tail.add_argument("--app", dest="app_name", default=None)
    p_tail.add_argument("--appid", type=int, default=None)
    p_tail.add_argument("--channel", default=None)
    p_tail.add_argument("--from", dest="cursor", default=None,
                        metavar="CURSOR",
                        help="JSON cursor from a previous run (or "
                             "'end' to position at the current log end "
                             "and read nothing; default: read from the "
                             "beginning)")
    p_tail.add_argument("--limit", type=int, default=None,
                        help="print at most N events (the cursor still "
                             "advances past everything read)")
    ns = p.parse_args(args)
    from ...data.api import event_log

    s = Storage.instance()
    le = s.get_l_events()
    log_dir = getattr(le, "events_dir", None)
    if log_dir is None:
        print("[error] the configured event store is not a JSONL event "
              "log; `pio eventlog` applies to TYPE=JSONL", file=sys.stderr)
        return 1
    if ns.sub == "tail":
        return _eventlog_tail(s, log_dir, ns)
    if ns.sub == "compact":
        n = 0
        for name in sorted(os.listdir(log_dir)):
            if name.endswith(".jsonl"):
                m = event_log.compact_log(
                    os.path.join(log_dir, name), ns.min_new_bytes)
                if m is not None:
                    print(f"[info] {name}: generation {m['generation']}, "
                          f"{m['events']} event(s), {m['covered']} "
                          "byte(s) covered")
                    n += 1
        print(f"[info] Compacted {n} log(s) in {log_dir}")
        return 0
    if ns.sub == "scrub":
        report = event_log.scrub_log_dir(log_dir)
        marker = "[warn]" if report["quarantined"] else "[info]"
        print(f"{marker} Scrub: {report['checked']} snapshot(s) checked, "
              f"{report['ok']} ok, {report['quarantined']} quarantined, "
              f"{report['stale']} stale (discarded)")
        return 1 if report["quarantined"] else 0
    if ns.sub == "fence":
        lease = event_log.claim_partition(log_dir, ns.partition, force=True)
        print(f"[info] Partition {ns.partition} fenced: new epoch "
              f"{lease.epoch}"
              + (" (FORCED past a held flock — the previous owner will "
                 "be refused on its next write)" if lease.forced else ""))
        lease.release()
        return 0
    if ns.sub == "retire":
        ttl_us = None
        if ns.ttl:
            from ...common import train_window

            ttl_us = train_window.parse_duration_us(ns.ttl)
            if ttl_us is None:
                print(f"[error] --ttl {ns.ttl!r}: expected a duration "
                      "like 90d, 12h, 30m, or 45s", file=sys.stderr)
                return 1
        elif event_log.retention_ttl_us() is None:
            print("[info] No TTL (--ttl / $PIO_EVENT_RETENTION unset): "
                  "running the convergence sweep only")
        retired = swept = 0
        for name in sorted(os.listdir(log_dir)):
            if not name.endswith(".jsonl"):
                continue
            r = event_log.retire_expired(
                os.path.join(log_dir, name), ttl_us=ttl_us)
            if r is None:
                continue
            if r["retired"] or r["swept"]:
                print(f"[info] {name}: {r['retired']} generation(s) "
                      f"retired {r['generations']}, {r['swept']} "
                      f"file(s) swept, parse floor {r['floor']}")
            retired += r["retired"]
            swept += r["swept"]
        print(f"[info] Retired {retired} generation(s) ({swept} "
              f"snapshot file(s) swept to retired/) in {log_dir}")
        return 0
    if ns.sub in ("archive", "restore"):
        path = os.path.join(log_dir, ns.log)
        fn = (event_log.archive_generation if ns.sub == "archive"
              else event_log.restore_generation)
        try:
            entry = fn(path, ns.generation, storage=s)
        except Exception as e:  # noqa: BLE001 - operator-facing
            print(f"[error] {ns.sub} failed: {e}", file=sys.stderr)
            return 1
        arch = entry.get("archive") or {}
        print(f"[info] {ns.log} generation {ns.generation}: "
              f"tier {entry.get('tier')}"
              + (f" (source {arch.get('source')}, blob "
                 f"{arch.get('id')})"
                 if entry.get("tier") == "archived" else ""))
        return 0
    # status
    health = event_log.partition_health(log_dir)
    _print_partition_health(health, log_dir)
    _print_generation_tiers(health)
    return 0


def _eventlog_tail(s: Storage, log_dir: str, ns) -> int:
    """`pio eventlog tail`: one read_since() pass over an app's shards
    — events to stdout (JSONL, pipeable), cursor + accounting to
    stderr so redirecting stdout captures only data."""
    from ...data.api.log_tail import LogCursor, LogTailer

    if ns.appid is None and not ns.app_name:
        # the shared resolver's message names --app-name, which this
        # subcommand spells --app — say the flag that actually exists
        print("[error] provide --app <name> or --appid <id>",
              file=sys.stderr)
        return 1
    app_id = _resolve_app_id(s, ns.appid, ns.app_name)
    channel_id = None
    if ns.channel:
        chans = [c for c in s.get_meta_data_channels().get_by_appid(app_id)
                 if c.name == ns.channel]
        if not chans:
            print(f"Channel {ns.channel!r} not found.", file=sys.stderr)
            return 1
        channel_id = chans[0].id
    tailer = LogTailer(log_dir, app_id, channel_id)
    cursor = None
    if ns.cursor == "end":
        cursor = tailer.end_cursor()
    elif ns.cursor:
        try:
            cursor = LogCursor.from_json(json.loads(ns.cursor))
        except (ValueError, json.JSONDecodeError) as e:
            print(f"[error] --from is not a cursor: {e}", file=sys.stderr)
            return 1
    if ns.limit is None:
        batch = tailer.read_since(cursor)
        events, total, bytes_read = batch.events, len(batch.events), \
            batch.bytes_read
        final, snapshot_seeded, resets = batch.cursor, \
            batch.snapshot_seeded, batch.resets
    else:
        # bounded pagination: read in 1 MiB chunks until the limit is
        # met (or the log runs dry) instead of decoding a multi-GB
        # backlog into memory to slice N events off the front
        limit = max(0, ns.limit)
        events, total, bytes_read, resets = [], 0, 0, 0
        snapshot_seeded = False
        final = cursor
        while True:
            batch = tailer.read_since(final, max_bytes=1 << 20)
            final = batch.cursor
            total += len(batch.events)
            bytes_read += batch.bytes_read
            resets += batch.resets
            snapshot_seeded |= batch.snapshot_seeded
            if len(events) < limit:
                events.extend(batch.events[:limit - len(events)])
            if batch.bytes_read == 0 or total >= limit:
                break
    for doc in events:
        print(json.dumps(doc))
    if ns.limit is not None and total > len(events):
        print(f"[info] {total - len(events)} further "
              "event(s) read but not printed (--limit); the cursor "
              "below covers them", file=sys.stderr)
    print(f"[info] {total} event(s), {bytes_read} "
          f"byte(s) read across {len(final.shards)} shard(s)"
          + (", seeded from a columnar snapshot"
             if snapshot_seeded else "")
          + (f", {resets} shard reset(s)" if resets else ""),
          file=sys.stderr)
    print(f"[info] cursor: {json.dumps(final.to_json())}",
          file=sys.stderr)
    return 0


def _print_partition_health(health: dict, log_dir: str) -> None:
    if not health["logs"]:
        print(f"[info] No event logs in {log_dir}")
    for row in health["logs"]:
        lease = row["lease"]
        lease_s = ""
        if lease is not None:
            state = ("held" if lease["held"]
                     else "STALE" if lease["stale"] else "free")
            lease_s = (f", lease {state} (epoch {lease['epoch']}, "
                       f"pid {lease['pid']})")
        compact_s = (f", compacted {row['compactedEvents']} event(s) at "
                     f"{row['lastCompaction']}"
                     if row["lastCompaction"] else ", never compacted")
        marker = "[warn]" if (lease and lease["stale"]) else "[info]"
        print(f"{marker}   {row['log']}: {row['bytes']} bytes"
              f"{lease_s}{compact_s}")
    if health["quarantinedFiles"]:
        print(f"[warn]   {health['quarantinedFiles']} quarantined "
              f"file(s) in {os.path.join(log_dir, 'quarantine')} — "
              "corrupt segments kept for forensics")


def _print_generation_tiers(health: dict) -> None:
    """`pio eventlog status` detail rows: one line per sealed
    generation with its event-time bounds, tier, and size — the
    operator's view of what a windowed read can skip and what
    retention may retire next. Unbounded legacy (v1) entries are
    warn-marked: they predate time-bounded manifests, so windowed
    reads always decode them and retention never retires them."""
    import datetime as _dt

    def day(us):
        return _dt.datetime.fromtimestamp(
            us / 1e6, _dt.timezone.utc).strftime("%Y-%m-%d")

    for row in health["logs"]:
        for g in row["generations"]:
            if g["legacy"]:
                print(f"[warn]     {row['log']} g{g['generation']}: "
                      "UNBOUNDED (legacy v1 manifest — recompact after "
                      "new appends to seal time-bounded generations)")
                continue
            span = ("no timed rows" if g["minEventUs"] is None
                    else f"{day(g['minEventUs'])} .. "
                         f"{day(g['maxEventUs'])}")
            print(f"[info]     {row['log']} g{g['generation']}: "
                  f"[{span}] tier={g['tier']}, {g['bytes']} byte(s), "
                  f"{g['events']} event(s)")


@verb("fleet", "inspect the elastic serving fleet (plan = dry-run)")
def fleet_cmd(args: list[str]) -> int:
    """`pio fleet plan --engine-url URL`: what would the autoscaler do right
    now? Nothing is changed. Against an elastic front it replays the
    front's own last scrape through the decision function the live loop
    uses; against a fixed fleet it scrapes each backend's /status and
    evaluates $PIO_SCALE_* / $PIO_FLEET_*_REPLICAS from this environment."""
    p = argparse.ArgumentParser(prog="pio fleet")
    sub = p.add_subparsers(dest="sub", required=True)
    p_plan = sub.add_parser(
        "plan", help="print the scaling decision the current telemetry "
                     "implies — dry run, nothing is changed")
    p_plan.add_argument("--engine-url",
                        default=envknobs.env_str(
                            "PIO_ENGINE_URL", "", lower=False) or None,
                        help="fleet front base URL (defaults to "
                             "$PIO_ENGINE_URL)")
    ns = p.parse_args(args)
    if not ns.engine_url:
        print("[error] pio fleet plan needs --engine-url (or "
              "$PIO_ENGINE_URL)", file=sys.stderr)
        return 1
    return _fleet_plan(ns.engine_url)


def _fleet_plan(url: str) -> int:
    from ...workflow import elastic as el

    base = (url if "://" in url else f"http://{url}").rstrip("/")
    try:
        doc = _fetch_json(f"{base}/healthz", timeout=5.0)
    except Exception as e:  # noqa: BLE001 - operator-facing error path
        print(f"[error] could not fetch {base}/healthz: {e}",
              file=sys.stderr)
        return 1
    eld = (doc or {}).get("elastic")
    backends = (doc or {}).get("backends") or []
    sample_fields = ("slot", "alive", "ready", "draining", "pending",
                     "pending_limit", "shed_delta")
    if eld and eld.get("samples"):
        # elastic front: replay its own last scrape and live config
        cfgd = eld.get("config") or {}
        cfg = el.ElasticConfig(**{
            k: cfgd[k] for k in (
                "min_replicas", "max_replicas", "up_threshold",
                "down_threshold", "hysteresis_ticks", "cooldown_ms",
                "tick_ms") if k in cfgd})
        samples = [el.ReplicaSample(**{k: s[k] for k in sample_fields
                                       if k in s})
                   for s in eld["samples"]]
        source = "front's last telemetry scrape"
    else:
        # a fixed fleet (or a plain server): scrape each backend here
        cfg = el.ElasticConfig.from_env(
            default_min=1, default_max=max(1, len(backends)))
        samples = []
        for b in backends:
            smp = el.ReplicaSample(
                slot=int(b.get("replica") or 0), alive=bool(b.get("alive")),
                ready=bool(b.get("ready")), draining=bool(b.get("draining")))
            if b.get("port"):
                try:
                    ov = _fetch_json(f"http://127.0.0.1:{b['port']}/status",
                                     timeout=2.0).get("overload") or {}
                    smp.pending = int(ov.get("pending") or 0)
                    smp.pending_limit = int(ov.get("pendingLimit") or 0)
                except Exception:  # noqa: BLE001 - a backend may be down
                    pass
            samples.append(smp)
        source = "local backend /status scrape + this environment"
    if not samples:
        print(f"[error] {base}/healthz reported no fleet backends — is "
              "this a fleet front?", file=sys.stderr)
        return 1
    d = el.plan(samples, cfg)
    print(f"[info] fleet plan @ {base} ({source}):")
    print(f"[info]   replicas: {d.actual} active, bounds "
          f"[{cfg.min_replicas}, {cfg.max_replicas}]; utilization "
          f"{d.utilization:.2f} (up >= {cfg.up_threshold:.2f}, down <= "
          f"{cfg.down_threshold:.2f}), shed +{d.shed_delta}")
    if d.direction == "up":
        print(f"[info]   would scale UP ({d.reason}) -> {d.target} "
              "replica(s)")
    elif d.direction == "down":
        print(f"[info]   would drain replica {d.slot} ({d.reason}) -> "
              f"{d.target} replica(s)")
    else:
        print(f"[info]   would hold ({d.reason})")
    if eld:
        gates = (eld.get("lastDecision") or {}).get("gates") or []
        if gates:
            print(f"[info]   live loop currently gated by "
                  f"{','.join(gates)} — a raw signal may act later")
    print("[info]   dry run only — nothing was changed")
    return 0


@verb("wal", "inspect or replay the ingest write-ahead log")
def wal_cmd(args: list[str]) -> int:
    """Operator surface of the write-ahead log (PIO_WAL=1,
    data/api/ingest_wal.py): `inspect` lists per-(app, channel) segment
    state without touching storage; `replay` runs the recovery pass the
    event server runs at start-up — replays uncommitted records (deduped
    by event_id) and truncates the segments."""
    p = argparse.ArgumentParser(prog="pio wal")
    sub = p.add_subparsers(dest="sub", required=True)
    sub.add_parser("inspect", help="list WAL segments and uncommitted "
                                   "record counts per (app, channel)")
    sub.add_parser("replay", help="replay uncommitted records into the "
                                  "configured event store, then truncate")
    ns = p.parse_args(args)
    from ...data.api import ingest_wal

    cfg = ingest_wal.WalConfig.from_env()
    if ns.sub == "inspect":
        rows = ingest_wal.inspect(cfg)
        print(f"[info] WAL dir: {cfg.dir} (fsync={cfg.fsync})")
        if not rows:
            print("[info] No WAL segments on disk — nothing to replay.")
            s = Storage.instance()
            log_dir = getattr(s.get_l_events(), "events_dir", None)
            if log_dir is not None and os.path.isdir(log_dir):
                from ...data.api import event_log

                _print_partition_health(
                    event_log.partition_health(log_dir), log_dir)
            return 0
        live = ingest_wal.dir_is_live(cfg)
        if live:
            print("[info] A live event server owns this WAL dir: counts "
                  "below include in-flight writes (uncommitted records "
                  "and even a transient torn tail are expected, not "
                  "corruption).")
        for r in rows:
            chan = "" if r["channelId"] is None else f" channel {r['channelId']}"
            marker = "[warn]" if (r["corruptSegments"]
                                  or r["quarantinedSegments"]
                                  or (not live and (r["uncommittedEvents"]
                                                    or r["tornTailBytes"]))) \
                else "[info]"
            extra = ""
            if r["corruptSegments"]:
                extra += (f", {r['corruptSegments']} CORRUPT segment(s) "
                          "(mid-file; quarantined at next replay)")
            if r["quarantinedSegments"]:
                extra += (f", {r['quarantinedSegments']} quarantined "
                          "segment(s)")
            print(f"{marker}   app {r['appId']}{chan}: "
                  f"{r['segments']} segment(s), {r['bytes']} bytes, "
                  f"{r['uncommittedEvents']} uncommitted event(s), "
                  f"{r['committedRecords']} committed / "
                  f"{r['abortedRecords']} aborted record(s), "
                  f"{r['tornTailBytes']} torn-tail byte(s){extra}")
        # the partitioned event log rides the same operator surface:
        # shard sizes, lease holders + epochs, compaction recency
        s = Storage.instance()
        log_dir = getattr(s.get_l_events(), "events_dir", None)
        if log_dir is not None and os.path.isdir(log_dir):
            from ...data.api import event_log

            _print_partition_health(
                event_log.partition_health(log_dir), log_dir)
        return 0
    # replay
    s = Storage.instance()
    try:
        summary = ingest_wal.recover(s, cfg)
    except ingest_wal.WalLockedError as e:
        print(f"[error] {e}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 - operator-facing
        print(f"[error] WAL replay failed (storage unreachable?): {e}",
              file=sys.stderr)
        return 1
    print(f"[info] WAL replay: {summary['replayed']} event(s) replayed, "
          f"{summary['deduped']} deduped, {summary['discardedBytes']} "
          f"torn-tail byte(s) discarded, {summary['segmentsRemoved']} "
          f"segment(s) truncated across {summary['keys']} key(s).")
    return 0


def _raise_exit(signum, frame):
    raise SystemExit(0)


def _eventserver_scale(args: list[str]) -> int:
    """`pio eventserver scale N` — retarget a RUNNING partitioned
    event-server front to N workers: write the scale-target file the
    front advertised at start-up (atomic replace) and SIGHUP it; the
    front rebalances partition ownership through the lease/epoch protocol
    (retire + release on the way down, claim with an epoch bump on the
    way up)."""
    p = argparse.ArgumentParser(prog="pio eventserver scale")
    p.add_argument("workers", type=int,
                   help="new worker count (>= 1); partitions above the "
                        "target retire and park on the front, scale-up "
                        "hands them back to fresh workers")
    ns = p.parse_args(args)
    from ...data.api.event_log import front_info_path

    info = front_info_path()
    try:
        with open(info, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        print(f"[error] no running partitioned event-server front found "
              f"({info} missing) — start one with "
              f"`pio eventserver --workers N`", file=sys.stderr)
        return 1
    target = max(1, ns.workers)
    scale_file = doc.get("scaleFile")
    if not scale_file:
        print("[error] front info file has no scaleFile entry",
              file=sys.stderr)
        return 1
    tmp = scale_file + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(str(target))
    os.replace(tmp, scale_file)
    try:
        os.kill(int(doc["pid"]), signal.SIGHUP)
    except (OSError, KeyError, TypeError, ValueError) as e:
        print(f"[error] could not signal the front "
              f"(pid {doc.get('pid')}): {e}", file=sys.stderr)
        return 1
    print(f"[info] scale target {target} written; front "
          f"(pid {doc['pid']}) signaled — workers now "
          f"{sorted(doc.get('workers') or [])}, rebalance in progress "
          f"(watch `pio eventlog status` for lease movement)")
    return 0


def _worker_heartbeat(stop) -> None:
    """A supervised worker's liveness: touch the heartbeat file at half
    the configured period until ``stop`` is set."""
    from ...parallel import supervisor

    interval = max(0.05, envknobs.env_ms(
        "PIO_WORKER_HEARTBEAT_MS", 1000.0, lo_ms=20.0) / 2.0)
    while not stop.wait(interval):
        supervisor.beat()


@verb("eventserver", "start the Event Server (REST ingestion, :7070)")
def eventserver_cmd(args: list[str]) -> int:
    if args and args[0] == "scale":
        return _eventserver_scale(args[1:])
    p = argparse.ArgumentParser(prog="pio eventserver")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7070)
    p.add_argument("--stats", action="store_true",
                   help="count ingested events per app, event, entity "
                        "type and status (GET /stats.json, /metrics)")
    p.add_argument("--workers", type=int,
                   default=envknobs.env_int("PIO_EVENT_WORKERS", 0, lo=0),
                   help="run N supervised worker processes owning "
                        "disjoint event-log partitions behind a front "
                        "listener (defaults to $PIO_EVENT_WORKERS; N=1 is "
                        "still supervised + lease-fenced; 0 = plain single "
                        "process, no partitioning)")
    p.add_argument("--worker", action="store_true",
                   help=argparse.SUPPRESS)  # internal: supervised worker
    ns = p.parse_args(args)
    if ns.worker:
        # spawned by the partitioned front (event_log.py): the partition
        # identity and the port arrive through the environment
        port = envknobs.env_int("PIO_EVENT_WORKER_PORT", 0, lo=0)
        if port <= 0:
            print("[error] --worker requires PIO_EVENT_WORKER_PORT "
                  "(set by the supervisor — this flag is internal)",
                  file=sys.stderr)
            return 1
        from ...parallel.supervisor import die_with_parent

        die_with_parent("event-server front")
        return _serve_events("127.0.0.1", port, ns.stats, worker=True)
    if ns.workers >= 1:
        from ...data.api.event_log import run_partitioned_event_server

        return run_partitioned_event_server(ns.ip, ns.port, ns.workers,
                                            enable_stats=ns.stats)
    return _serve_events(ns.ip, ns.port, ns.stats)


def _serve_events(ip: str, port: int, stats: bool,
                  worker: bool = False) -> int:
    """One event-server process until SIGTERM: the accept loop stops, the
    requests in flight finish (every acknowledged write answered), the
    ingest buffer flushes, then the store's handles and the WAL close and
    the partition lease is released."""
    import threading

    from ...data.api.event_server import EventServer

    server = EventServer(Storage.instance(), ip, port, enable_stats=stats)
    stop = threading.Event()
    beats = None
    if worker:
        beats = threading.Thread(target=_worker_heartbeat, args=(stop,),
                                 daemon=True, name="pio-worker-heartbeat")
        beats.start()
    signal.signal(signal.SIGTERM, _raise_exit)
    host, port = server.address
    scheme = "https" if server._httpd.ssl_context is not None else "http"
    print(f"[info] Event Server listening on {scheme}://{host}:{port}"
          + (f" (partition {server.lease.partition})"
             if server.lease is not None else ""), flush=True)
    try:
        server.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        stop.set()
        server.drain(timeout=envknobs.env_ms(
            "PIO_DRAIN_DEADLINE_MS", 30_000.0, lo_ms=0.0))
        server.close()
    return 0


@verb("storageserver", "host this node's storage over HTTP (:7072)")
def storageserver_cmd(args: list[str]) -> int:
    """Serve the DAO surface of this node's PIO_STORAGE_* backends to
    remote hosts (TYPE=HTTP clients): the shared-store role. See
    data/api/storage_server.py."""
    p = argparse.ArgumentParser(prog="pio storageserver")
    p.add_argument("--ip", default="127.0.0.1",
                   help="bind address; non-loopback binds REQUIRE a shared "
                        "secret (--secret / PIO_STORAGESERVER_SECRET)")
    p.add_argument("--port", type=int, default=7072)
    p.add_argument("--secret", default=None,
                   help="shared secret clients must present as "
                        "'Authorization: Bearer <secret>' (clients set "
                        "PIO_STORAGE_SOURCES_<N>_SECRET); defaults to "
                        "$PIO_STORAGESERVER_SECRET")
    ns = p.parse_args(args)
    s = Storage.instance()
    for repo in REPOSITORIES:
        if s.repo_source_type(repo) == "HTTP":
            print("[error] this node's own storage is TYPE=HTTP; serving "
                  "it again would proxy in a loop. Point the server node "
                  "at an embedded backend (SQLITE/JSONL/LOCALFS).",
                  file=sys.stderr)
            return 1
    from ...data.api.storage_server import run_storage_server

    signal.signal(signal.SIGTERM, _raise_exit)
    run_storage_server(ns.ip, ns.port, secret=ns.secret)
    return 0


@verb("adminserver", "start the admin REST API (:7071)")
def adminserver_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio adminserver")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7071)
    ns = p.parse_args(args)
    from ..admin import AdminServer

    server = AdminServer(Storage.instance(), ns.ip, ns.port)
    signal.signal(signal.SIGTERM, _raise_exit)
    host, port = server.address
    print(f"[info] Admin server running on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


def templates_dir() -> str:
    """The port's bundle of engine templates (one directory each, with an
    engine.json naming this package's factory)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "templates")


@verb("template", "list or copy bundled engine templates")
def template_cmd(args: list[str]) -> int:
    """Reference: `pio template get` cloned from GitHub; here it copies a
    template of the port's bundle."""
    import shutil

    p = argparse.ArgumentParser(prog="pio template")
    sub = p.add_subparsers(dest="sub", required=True)
    sub.add_parser("list")
    p_get = sub.add_parser("get")
    p_get.add_argument("name")
    p_get.add_argument("dest")
    ns = p.parse_args(args)
    base = templates_dir()
    if ns.sub == "list":
        for name in sorted(os.listdir(base)):
            if os.path.isfile(os.path.join(base, name, "engine.json")):
                print(name)
        return 0
    src = os.path.join(base, ns.name)
    if not os.path.isfile(os.path.join(src, "engine.json")):
        print(f"[error] unknown template {ns.name!r}; `pio template list`",
              file=sys.stderr)
        return 1
    shutil.copytree(src, ns.dest,
                    ignore=shutil.ignore_patterns("__pycache__"))
    print(f"[info] Template {ns.name!r} copied to {ns.dest}")
    return 0


@verb("run", "run an arbitrary main function with the pio environment")
def run_cmd(args: list[str]) -> int:
    """Reference: `pio run <main class>`; here the dotted path of a
    callable (a path into the JAX package is refused, as in
    engine.json)."""
    p = argparse.ArgumentParser(prog="pio run")
    p.add_argument("main", help="dotted path module.function")
    p.add_argument("--engine-dir", default=".")
    ns, rest = p.parse_known_args(args)
    from ...workflow.json_extractor import resolve_engine_factory

    try:
        fn = resolve_engine_factory(ns.main, ns.engine_dir)
    except ValueError as e:
        print(f"[error] {e}", file=sys.stderr)
        return 1
    result = fn(*rest) if rest else fn()
    if result is not None:
        print(result)
    return 0


@verb("upgrade", "upgrade helper (storage schema is auto-migrating)")
def upgrade_cmd(args: list[str]) -> int:
    print("[info] Nothing to do: storage schemas are created on demand and "
          "engine templates need no rebuild in this distribution.")
    return 0


@verb("shell", "interactive Python shell with the pio environment loaded")
def shell_cmd(args: list[str]) -> int:
    """Reference: bin/pio-shell, a REPL wired to the platform (there:
    spark-shell with the pio assembly on the classpath; here: the Python
    REPL with ``pypio`` preloaded and storage reachable).

    Preloaded names: ``pypio`` (the facade, already init()-ed against the
    configured storage: new_app / delete_app / import_events / find_events
    / find_ratings / train), ``storage`` (the configured Storage) and
    ``np``. Starting the shell imports no torch: it loads when something
    trains. ``pio shell -c 'stmt'`` runs one statement and exits.
    """
    p = argparse.ArgumentParser(prog="pio shell")
    p.add_argument("-c", dest="command", default=None,
                   help="run one statement and exit")
    ns = p.parse_args(args)

    import code

    import numpy as np

    from ... import pypio

    storage = Storage.instance()
    pypio.init(storage)
    banner = ("pio shell — pypio preloaded "
              "(pypio.new_app / import_events / find_events / train ...; "
              "`storage` = configured Storage; np available)")
    local_ns = {"pypio": pypio, "np": np, "storage": storage}
    if ns.command is not None:
        exec(compile(ns.command, "<pio shell -c>", "exec"), local_ns)
        return 0
    try:
        import readline  # noqa: F401 — line editing and history
    except ImportError:  # pragma: no cover — a platform without readline
        pass
    code.interact(banner=banner, local=local_ns)
    return 0
