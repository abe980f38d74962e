"""`pio models list|verify|rollback|gc` — the operator surface of the
verified model lifecycle (``workflow/model_artifact.py``).

The port's own copy of ``incubator_predictionio_tpu/tools/commands/
models.py``. ``list`` shows every engine instance with its artifact's
checksum state, ``verify`` re-verifies every blob offline (nonzero exit on
corruption), ``rollback`` flips a live engine server back to its retained
previous deployment, and ``gc`` deletes model blobs beyond the newest
``--keep`` per engine — never the deployed, previous or pinned ones (with
``--engine-url`` naming the live server), and never as a side effect of a
failed verification (corrupt blobs are forensics). The HTTP clients use
``urllib`` only.
"""

from __future__ import annotations

import argparse
import json
import sys

from ...common import envknobs
from ...common.ssl_config import loopback_client_context
from ...data.storage.registry import Storage
from . import verb


def _artifact_rows(storage):
    """(instance, describe-dict) per engine instance, newest first."""
    from ...workflow import model_artifact

    instances = storage.get_meta_data_engine_instances().get_all()
    instances.sort(key=lambda i: i.start_time, reverse=True)
    for inst in instances:
        row = model_artifact.get_model_row(storage, inst.id)
        yield inst, model_artifact.describe(row.models if row else None)


def _verdict(inst, d) -> tuple[str, bool, bool]:
    """(verdict, warn-worthy, corrupt) for one instance and its artifact.
    A COMPLETED row without a model is warn-worthy (a crash window, or
    what `gc` leaves); only blob damage is corruption."""
    if d["kind"] is None:
        return ("legacy (unverifiable)" if d["format"] == "legacy"
                else "verified"), False, False
    if d["kind"] == "missing":
        if inst.status == "COMPLETED":
            return ("no model (crash window, or GC'd; loader skips it)",
                    True, False)
        return "no model (not completed)", False, False
    return f"CORRUPT ({d['kind']})", True, True


def _base(url: str) -> str:
    return (url if "://" in url else f"http://{url}").rstrip("/")


def engine_status(url: str, timeout: float = 5.0) -> dict:
    """GET /status from a live engine server — the one status client of
    the CLI (`pio status --engine-url`, `pio models gc`)."""
    import urllib.request

    with urllib.request.urlopen(_base(url) + "/status",
                                timeout=timeout) as resp:
        return json.load(resp)


@verb("models", "list, verify, roll back, or GC stored model artifacts")
def models_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio models")
    sub = p.add_subparsers(dest="sub", required=True)
    sub.add_parser("list", help="engine instances with artifact "
                               "checksum/size/verified state")
    sub.add_parser("verify", help="re-verify every stored blob offline; "
                                  "exit 1 on any corruption")
    engine_url = envknobs.env_str("PIO_ENGINE_URL", "", lower=False) or None
    p_rb = sub.add_parser(
        "rollback", help="swap a live engine server back to its retained "
                         "previous deployment (pins the bad instance)")
    p_rb.add_argument("--engine-url", default=engine_url,
                      help="engine server base URL (default "
                           "$PIO_ENGINE_URL)")
    p_gc = sub.add_parser(
        "gc", help="delete model blobs beyond the newest --keep per "
                   "engine (never deployed/previous/pinned)")
    p_gc.add_argument("--keep", type=int,
                      default=envknobs.env_int("PIO_MODEL_KEEP", 5, lo=1),
                      help="COMPLETED instances whose models to keep per "
                           "(engine, version, variant); default "
                           "$PIO_MODEL_KEEP, else 5")
    p_gc.add_argument("--engine-url", default=engine_url,
                      help="also protect the live server's deployed, "
                           "previous and pinned instances (default "
                           "$PIO_ENGINE_URL)")
    p_gc.add_argument("--dry-run", action="store_true",
                      help="report what would be deleted, delete nothing")
    ns = p.parse_args(args)

    if ns.sub == "rollback":
        if not ns.engine_url:
            print("[error] rollback needs --engine-url (or "
                  "$PIO_ENGINE_URL)", file=sys.stderr)
            return 1
        return rollback_via_url(ns.engine_url)
    storage = Storage.instance()
    if ns.sub in ("list", "verify"):
        return _list_or_verify(storage, verify=ns.sub == "verify")
    return _gc(storage, ns)


def _list_or_verify(storage, verify: bool) -> int:
    warns = corrupt = n = 0
    for inst, d in _artifact_rows(storage):
        n += 1
        verdict, problem, is_corrupt = _verdict(inst, d)
        warns += int(problem)
        corrupt += int(is_corrupt)
        marker = "[warn]" if problem else "[info]"
        sha = (d.get("sha256") or "")[:12]
        size = d.get("size") or 0
        print(f"{marker}   {inst.id}  {inst.status:<9} "
              f"{inst.start_time:%Y-%m-%d %H:%M:%S}  "
              f"{d['format']:<8} {size:>10}B  {sha:<12}  {verdict}")
    if n == 0:
        print("[info] No engine instances.")
    if verify:
        print(f"[{'warn' if warns else 'info'}] Verified {n} "
              f"instance(s): {corrupt} corrupt, {warns - corrupt} other "
              "warning(s). Corrupt blobs are kept for forensics "
              "(`pio train` to replace; the serving loader already "
              "skips them). Exit is nonzero only on corruption, so a "
              "cron'd verify stays green across normal GC.")
        return 1 if corrupt else 0
    return 0


def _tls_ctx(base: str, insecure: bool):
    """An unverified TLS context for an https loopback call (the server's
    own certificate need not name 127.0.0.1); None for http or verified
    https."""
    if not insecure or not base.startswith("https://"):
        return None
    return loopback_client_context()


def rollback_via_url(url: str, insecure: bool = False) -> int:
    """POST /rollback to a live engine server — the one rollback client
    (`pio models rollback` and `pio deploy --rollback`; the latter passes
    ``insecure`` for its loopback https call)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(_base(url) + "/rollback", method="POST")
    try:
        with urllib.request.urlopen(
                req, timeout=30,
                context=_tls_ctx(_base(url), insecure)) as resp:
            doc = json.load(resp)
    except urllib.error.HTTPError as e:
        try:
            msg = json.load(e).get("message", "")
        except ValueError:
            msg = str(e)
        print(f"[error] rollback refused ({e.code}): {msg}",
              file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError) as e:
        print(f"[error] engine server at {_base(url)} unreachable: {e}",
              file=sys.stderr)
        return 1
    print(f"[info] {doc.get('message')}: now serving "
          f"{doc.get('engineInstanceId')}")
    return 0


def _gc(storage, ns) -> int:
    from ...workflow import model_artifact

    protected: set[str] = set()
    if ns.engine_url:
        try:
            doc = engine_status(ns.engine_url, timeout=10)
        except Exception as e:  # noqa: BLE001 - refuse to guess
            print(f"[error] engine server at {ns.engine_url} unreachable "
                  f"({e}); refusing to GC without knowing what it serves "
                  "(drop --engine-url to GC offline)", file=sys.stderr)
            return 1
        lc = doc.get("lifecycle") or {}
        protected |= {i for i in (doc.get("engineInstanceId"),
                                  lc.get("instance"),
                                  lc.get("previous")) if i}
        protected |= set(lc.get("pinned") or {})
    instances = storage.get_meta_data_engine_instances().get_all()
    groups: dict[tuple, list] = {}
    for inst in instances:
        if inst.status != "COMPLETED":
            continue
        groups.setdefault(
            (inst.engine_id, inst.engine_version, inst.engine_variant),
            []).append(inst)
    deleted = kept = 0
    for key, group in sorted(groups.items()):
        group.sort(key=lambda i: i.start_time, reverse=True)
        # rank only instances that still HAVE a blob: model-less rows
        # must not fill the keep window and let GC delete every usable
        # model
        ranked = 0
        for inst in group:
            if not model_artifact.model_exists(storage, inst.id):
                continue
            if ranked < ns.keep:
                # the keep window holds DEPLOYABLE artifacts: a corrupt
                # blob stays as forensics without taking a keep slot
                row = model_artifact.get_model_row(storage, inst.id)
                d = model_artifact.describe(row.models if row else None)
                if d["ok"]:
                    ranked += 1
                else:
                    print(f"[warn]   keeping corrupt model {inst.id} "
                          f"({d['kind']}) as forensics; it does not "
                          "count toward --keep")
                kept += 1
                continue
            if inst.id in protected:
                kept += 1
                continue
            if ns.dry_run:
                print(f"[info]   would delete model {inst.id} "
                      f"({key[0]}/{key[2]}, beyond keep window)")
            else:
                model_artifact.delete_model(storage, inst.id)
                print(f"[info]   deleted model {inst.id} "
                      f"({key[0]}/{key[2]}, beyond keep window)")
            deleted += 1
    verb_s = "would delete" if ns.dry_run else "deleted"
    print(f"[info] GC: {verb_s} {deleted} model blob(s), kept {kept} "
          f"(keep={ns.keep}, protected={len(protected)}).")
    return 0
