"""`pio app ...` + `pio accesskey ...` (reference: tools/.../commands/
{App,AccessKey}.scala driven from Console.scala).

The port's own copy of ``incubator_predictionio_tpu/tools/commands/app.py``,
``app data-delete --clean [--ttl-days D]`` (the self-cleaning pass of
``controller/self_cleaning.py``) included.
"""

from __future__ import annotations

import argparse
import sys

from ...data.storage import AccessKey, App, Channel
from ...data.storage.registry import Storage
from . import verb


def _storage() -> Storage:
    return Storage.instance()


@verb("app", "manage apps: new|list|show|delete|channel-new|channel-delete|data-delete")
def app_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio app")
    sub = p.add_subparsers(dest="sub", required=True)
    p_new = sub.add_parser("new")
    p_new.add_argument("name")
    p_new.add_argument("--description", default=None)
    p_new.add_argument("--access-key", default="")
    sub.add_parser("list")
    p_show = sub.add_parser("show")
    p_show.add_argument("name")
    p_del = sub.add_parser("delete")
    p_del.add_argument("name")
    p_del.add_argument("-f", "--force", action="store_true")
    p_cn = sub.add_parser("channel-new")
    p_cn.add_argument("name")
    p_cn.add_argument("channel")
    p_cd = sub.add_parser("channel-delete")
    p_cd.add_argument("name")
    p_cd.add_argument("channel")
    p_dd = sub.add_parser("data-delete")
    p_dd.add_argument("name")
    p_dd.add_argument("--channel", default=None)
    p_dd.add_argument("-f", "--force", action="store_true")
    p_dd.add_argument("--clean", action="store_true",
                      help="self-cleaning pass instead of a full wipe: "
                           "dedupe re-imported events + compact "
                           "$set/$unset/$delete streams (default channel)")
    p_dd.add_argument("--ttl-days", type=float, default=None, metavar="D",
                      help="with --clean: also delete non-property events "
                           "older than D days (requires -f)")
    ns = p.parse_args(args)
    s = _storage()
    apps = s.get_meta_data_apps()

    if ns.sub == "new":
        app_id = apps.insert(App(0, ns.name, ns.description))
        if app_id is None:
            print(f"App {ns.name!r} already exists.", file=sys.stderr)
            return 1
        s.get_l_events().init(app_id)
        key = s.get_meta_data_access_keys().insert(
            AccessKey(ns.access_key, app_id, ())
        )
        print("[info] App created.")
        print(f"      Name: {ns.name}")
        print(f"        ID: {app_id}")
        print(f"Access Key: {key}")
        return 0

    if ns.sub == "list":
        print(f"{'Name':20} | {'ID':4} | Access Key")
        for a in apps.get_all():
            for k in s.get_meta_data_access_keys().get_by_appid(a.id) or [None]:
                print(f"{a.name:20} | {a.id:4} | {k.key if k else '(none)'}")
        return 0

    if ns.sub == "show":
        a = apps.get_by_name(ns.name)
        if a is None:
            print(f"App {ns.name!r} does not exist.", file=sys.stderr)
            return 1
        print(f"    App Name: {a.name}")
        print(f"      App ID: {a.id}")
        print(f" Description: {a.description or ''}")
        for k in s.get_meta_data_access_keys().get_by_appid(a.id):
            events = ",".join(k.events) if k.events else "(all)"
            print(f"  Access Key: {k.key} | {events}")
        for c in s.get_meta_data_channels().get_by_appid(a.id):
            print(f"     Channel: {c.name} (id {c.id})")
        return 0

    a = apps.get_by_name(ns.name)
    if a is None:
        print(f"App {ns.name!r} does not exist.", file=sys.stderr)
        return 1

    if ns.sub == "delete":
        if not ns.force:
            print("Pass -f to confirm deletion.", file=sys.stderr)
            return 1
        for c in s.get_meta_data_channels().get_by_appid(a.id):
            s.get_l_events().remove(a.id, c.id)
            s.get_meta_data_channels().delete(c.id)
        for k in s.get_meta_data_access_keys().get_by_appid(a.id):
            s.get_meta_data_access_keys().delete(k.key)
        s.get_l_events().remove(a.id)
        apps.delete(a.id)
        print(f"[info] App {ns.name!r} deleted.")
        return 0

    if ns.sub == "channel-new":
        cid = s.get_meta_data_channels().insert(Channel(0, ns.channel, a.id))
        if cid is None:
            print(f"Invalid or duplicate channel name {ns.channel!r}.", file=sys.stderr)
            return 1
        s.get_l_events().init(a.id, cid)
        print(f"[info] Channel {ns.channel!r} created (id {cid}).")
        return 0

    if ns.sub == "channel-delete":
        chans = [c for c in s.get_meta_data_channels().get_by_appid(a.id) if c.name == ns.channel]
        if not chans:
            print(f"Channel {ns.channel!r} not found.", file=sys.stderr)
            return 1
        s.get_l_events().remove(a.id, chans[0].id)
        s.get_meta_data_channels().delete(chans[0].id)
        print(f"[info] Channel {ns.channel!r} deleted.")
        return 0

    if ns.sub == "data-delete":
        if ns.clean:
            # compaction and dedupe keep what every query answers; only
            # the TTL age-out loses data, so only it needs -f
            if ns.channel:
                print("--clean operates on the default channel only; "
                      "it cannot be combined with --channel.",
                      file=sys.stderr)
                return 1
            if ns.ttl_days is not None and not ns.force:
                print("Pass -f to confirm TTL deletion.", file=sys.stderr)
                return 1
            import datetime as _dt

            from ...controller.self_cleaning import SelfCleaningDataSource
            from ...workflow.context import WorkflowContext

            ds = SelfCleaningDataSource()
            if ns.ttl_days is not None:
                ds.event_window_duration = _dt.timedelta(days=ns.ttl_days)
                ds.event_window_remove = True
            # the pass reads and writes the store only: no device work
            removed = ds.clean_persisted_data(
                WorkflowContext(storage=s, device="cpu"), ns.name)
            print(f"[info] Self-cleaning removed {removed} events.")
            return 0
        if not ns.force:
            print("Pass -f to confirm deletion.", file=sys.stderr)
            return 1
        if ns.channel:
            chans = [c for c in s.get_meta_data_channels().get_by_appid(a.id) if c.name == ns.channel]
            if not chans:
                print(f"Channel {ns.channel!r} not found.", file=sys.stderr)
                return 1
            s.get_l_events().remove(a.id, chans[0].id)
            s.get_l_events().init(a.id, chans[0].id)
        else:
            s.get_l_events().remove(a.id)
            s.get_l_events().init(a.id)
        print("[info] Data deleted.")
        return 0
    return 1


@verb("accesskey", "manage access keys: new|list|delete")
def accesskey_cmd(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="pio accesskey")
    sub = p.add_subparsers(dest="sub", required=True)
    p_new = sub.add_parser("new")
    p_new.add_argument("app_name")
    p_new.add_argument("--events", nargs="*", default=[])
    p_list = sub.add_parser("list")
    p_list.add_argument("app_name", nargs="?")
    p_del = sub.add_parser("delete")
    p_del.add_argument("key")
    if (len(args) == 2 and args[0] == "delete" and args[1].startswith("-")
            and args[1] not in ("-h", "--help", "--")):
        # a key that starts with "-" is a key here, not an option
        args = ["delete", "--", args[1]]
    ns = p.parse_args(args)
    s = _storage()
    keys = s.get_meta_data_access_keys()

    if ns.sub == "new":
        a = s.get_meta_data_apps().get_by_name(ns.app_name)
        if a is None:
            print(f"App {ns.app_name!r} does not exist.", file=sys.stderr)
            return 1
        key = keys.insert(AccessKey("", a.id, tuple(ns.events)))
        print(f"Access Key: {key}")
        return 0
    if ns.sub == "list":
        rows = keys.get_all()
        if ns.app_name:
            a = s.get_meta_data_apps().get_by_name(ns.app_name)
            if a is None:
                print(f"App {ns.app_name!r} does not exist.", file=sys.stderr)
                return 1
            rows = keys.get_by_appid(a.id)
        for k in rows:
            events = ",".join(k.events) if k.events else "(all)"
            print(f"{k.key} | app {k.appid} | {events}")
        return 0
    if ns.sub == "delete":
        keys.delete(ns.key)
        print("[info] Access key deleted.")
        return 0
    return 1
