"""`pio status/eventserver/export/import` (reference: tools/.../commands/
{Management,Export,Import}.scala, tools/export/EventsToFile.scala,
tools/imprt/FileToEvents.scala).

The port's own copy of those verbs of ``incubator_predictionio_tpu/tools/
commands/management.py`` (``status`` :18, ``eventserver`` :538, ``export``
:1113, ``import`` :1155) for JSON-lines files. Parquet, the write-ahead
log, the event log, the fleet, the storage server, the dashboard and the
admin server are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time
from typing import Optional

from ...data.storage.event import Event
from ...data.storage.registry import REPOSITORIES, Storage, base_dir
from . import verb

#: events per ``insert_batch`` of an import (the reference's batch size)
IMPORT_BATCH = 20_000


def _kernel_status() -> str:
    """What the solve kernels would run on (in place of the reference's
    native-codec line): the card and the nvcc that builds them, whether
    the current source is already built, or why the card path is off."""
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
    p.parse_args(args)
    s = Storage.instance()
    print("[info] Inspecting storage backend connections...")
    for repo in REPOSITORIES:
        print(f"[info]   {repo}: {s.repo_source_type(repo)}")
    errors = s.verify_all_data_objects()
    if errors:
        for e in errors:
            print(f"[error] {e}", file=sys.stderr)
        return 1
    print(f"[info] Storage OK. Base dir: {base_dir()}")
    apps = s.get_meta_data_apps().get_all()
    print(f"[info] {len(apps)} app(s) registered.")
    print(f"[info] Solve kernels: {_kernel_status()}")
    return 0


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


@verb("export", "export an app's events to a JSON-lines file")
def export_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio export")
    p.add_argument("--appid", type=int, default=None)
    p.add_argument("--app-name", default=None)
    p.add_argument("--channel", default=None)
    p.add_argument("--output", required=True)
    ns = p.parse_args(args)
    s = Storage.instance()
    app_id = _resolve_app_id(s, ns.appid, ns.app_name)
    ok, channel_id = _channel_id(s, app_id, ns.channel)
    if not ok:
        return 1
    n = 0
    with open(ns.output, "w", encoding="utf-8") as f:
        for e in s.get_p_events().find(app_id, channel_id):
            f.write(json.dumps(e.to_json()) + "\n")
            n += 1
    print(f"[info] Exported {n} events to {ns.output} (jsonl)")
    return 0


@verb("import", "import events from a JSON-lines file into an app")
def import_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio import")
    p.add_argument("--appid", type=int, default=None)
    p.add_argument("--app-name", default=None)
    p.add_argument("--channel", default=None)
    p.add_argument("--input", required=True)
    ns = p.parse_args(args)
    s = Storage.instance()
    app_id = _resolve_app_id(s, ns.appid, ns.app_name)
    ok, channel_id = _channel_id(s, app_id, ns.channel)
    if not ok:
        return 1
    le = s.get_l_events()
    le.init(app_id, channel_id)
    t0 = time.perf_counter()
    # Streamed in batches: buffering a whole large file as Event objects
    # would hold every event in memory at once. A malformed record is a
    # warning and a skip, not an aborted import.
    batch, imported, skipped = [], 0, 0
    with open(ns.input, encoding="utf-8") as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                batch.append(Event.from_json(json.loads(line)))
            except Exception as e:  # noqa: BLE001 - report and continue
                skipped += 1
                print(f"[warn] record {line_no}: {e}", file=sys.stderr)
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


def _raise_exit(signum, frame):
    raise SystemExit(0)


@verb("eventserver", "start the Event Server (REST ingestion, :7070)")
def eventserver_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio eventserver")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7070)
    ns = p.parse_args(args)
    from ...data.api.event_server import EventServer

    server = EventServer(Storage.instance(), ns.ip, ns.port)
    signal.signal(signal.SIGTERM, _raise_exit)
    host, port = server.address
    print(f"[info] Event Server listening on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0
