"""Single-path confinement rules, the port's copy of the reference's
``tools/lint/rules_confinement.py`` with each table naming the port's
chokepoints.

Each rule pins an architectural chokepoint: ALL traffic of some kind
must flow through ONE module/class, because the chokepoint is where
the system's guarantees live (group commit, admission control, retry/
breaker policy, lease fencing, checksum verification, supervised
spawning, the metrics registry). The port's servers run on
``http.server`` threads, so a handler is a ``def`` there where the
reference's is an ``async def``; the rules accept both."""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from .engine import Finding, Project, rule

__all__ = ["RULES"]


def _class(module, name: str) -> Optional[ast.ClassDef]:
    for n in module.walk():
        if isinstance(n, ast.ClassDef) and n.name == name:
            return n
    return None


#: a request handler: a thread's ``def`` in the port, an ``async def`` in
#: the reference
_HANDLER_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


@rule("ingest-hot-path",
      "event-server write handlers (the threaded EventServer's "
      "handle_create, handle_batch and handle_webhook) must feed the "
      "ingest buffer — a direct per-event DAO insert bypasses group "
      "commit, drain and overload shedding")
def ingest_hot_path(project: Project) -> Iterable[Finding]:
    m = project.module("data/api/event_server.py")
    if m is None or m.tree is None:
        return
    disp = project.display_path(m)
    cls = _class(m, "EventServer")
    if cls is None:
        yield Finding("ingest-hot-path", disp, 1,
                      "class EventServer not found — the hot-path guard "
                      "has nothing to check (was it renamed?)")
        return
    hot = {"handle_create", "handle_batch", "handle_webhook"}
    seen = set()
    for fn in ast.walk(cls):
        if not isinstance(fn, _HANDLER_DEFS) or fn.name not in hot:
            continue
        seen.add(fn.name)
        uses_buffer = False
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
                if n.func.attr in ("insert", "insert_batch",
                                   "insert_canonical_lines"):
                    yield Finding(
                        "ingest-hot-path", disp, n.lineno,
                        f"{fn.name} calls the per-event DAO "
                        f"`.{n.func.attr}(` directly; route writes "
                        "through EventServer.ingest (the group-commit "
                        "buffer)")
            if isinstance(n, ast.Attribute) and n.attr == "ingest":
                uses_buffer = True
        if not uses_buffer:
            yield Finding("ingest-hot-path", disp, fn.lineno,
                          f"{fn.name} does not feed the ingest buffer")
    for missing in sorted(hot - seen):
        yield Finding("ingest-hot-path", disp, cls.lineno,
                      f"hot handler {missing} not found on EventServer — "
                      "renaming it silently drops the guard")


_BANNED_SUB = ("Popen", "run", "call", "check_call", "check_output")
_BANNED_OS = ("fork", "forkpty", "spawnv", "spawnve", "spawnl", "spawnlp",
              "spawnvp", "posix_spawn", "execv", "execve")
# the soak driver's whole job is launching the REAL topology (the
# supervised fronts it spawns are themselves the supervisors); it only
# ever builds argv for this repo's own console entry points
_SPAWN_ALLOWED = ("parallel/supervisor.py", "workflow/soak.py")


@rule("spawn-confinement",
      "parallel/ and workflow/ spawn processes only through "
      "parallel/supervisor.py (plus the soak scenario driver, whose "
      "test subject IS the spawned topology) — a side-channel launch "
      "escapes liveness monitoring, restart accounting and drain")
def spawn_confinement(project: Project) -> Iterable[Finding]:
    for sub in ("parallel/", "workflow/"):
        for m in project.modules(sub):
            if m.relpath in _SPAWN_ALLOWED or m.tree is None:
                continue
            disp = project.display_path(m)
            for node in m.walk():
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if not (isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)):
                    continue
                if (f.value.id == "subprocess" and f.attr in _BANNED_SUB) \
                        or (f.value.id == "os" and f.attr in _BANNED_OS):
                    yield Finding(
                        "spawn-confinement", disp, node.lineno,
                        f"{f.value.id}.{f.attr}() outside "
                        "parallel/supervisor.py — route worker spawning "
                        "through the supervisor")


@rule("resilient-urlopen",
      "storage backends reach HTTP only through the resilience layer "
      "(retries, breakers, fault injection) — raw urlopen bypasses all "
      "three")
def resilient_urlopen(project: Project) -> Iterable[Finding]:
    def urlopen_lines(tree) -> list[int]:
        return [n.lineno for n in ast.walk(tree)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "urlopen"]

    for m in project.modules("data/storage/"):
        if m.tree is None:
            continue
        calls = urlopen_lines(m.tree)
        if not calls:
            continue
        allowed: set[int] = set()
        if m.relpath == "data/storage/http_backend.py":
            # urlopen is legal ONLY inside the resilient _Transport
            # (whose every path applies policy/breaker/faults)
            transport = _class(m, "_Transport")
            if transport is not None:
                allowed = set(urlopen_lines(transport))
        disp = project.display_path(m)
        for ln in calls:
            if ln not in allowed:
                yield Finding(
                    "resilient-urlopen", disp, ln,
                    "urlopen() outside the resilient transport — use "
                    "common.resilience.resilient_urlopen")


_WAL_SUFFIXES = (".wal", ".colseg", ".manifest")
_WAL_ALLOWED = ("data/api/event_log.py", "data/api/ingest_wal.py")
#: tiered-retention artifact names (the retired/ subdir and the cold
#: archive namespace) — exact string constants only, so prose in
#: docstrings never trips the rule; the tier lifecycle (retire sweep,
#: archive round-trip CRC, restore commit order) lives in event_log.py
_TIER_LITERALS = ("retired", "pio_eventlog_archive")


@rule("wal-suffix-confinement",
      "only event_log.py/ingest_wal.py may open .wal/.colseg/.manifest "
      "artifacts or the retired/archive tier paths — touching them "
      "elsewhere forks segment lifecycle (leases, quarantine, manifest "
      "commits, tier moves)")
def wal_suffix_confinement(project: Project) -> Iterable[Finding]:
    for sub in ("data/", "workflow/"):
        for m in project.modules(sub):
            if m.relpath in _WAL_ALLOWED or m.tree is None:
                continue
            disp = project.display_path(m)
            for node in m.walk():
                if not (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)):
                    continue
                if node.value.endswith(_WAL_SUFFIXES):
                    yield Finding(
                        "wal-suffix-confinement", disp, node.lineno,
                        f"segment/manifest suffix {node.value!r} "
                        "referenced outside event_log.py/ingest_wal.py")
                elif node.value in _TIER_LITERALS:
                    yield Finding(
                        "wal-suffix-confinement", disp, node.lineno,
                        f"retention-tier artifact name {node.value!r} "
                        "referenced outside event_log.py — retire/"
                        "archive/restore only through its tier API")


_COUNTERISH = ("count", "counter", "stat", "stats", "metric")
_BANNED_CTOR = ("Counter", "defaultdict", "dict", "OrderedDict")


@rule("no-adhoc-counters",
      "no module-level counter dicts under data/api/ and workflow/ — "
      "ad-hoc counting state belongs to the telemetry registry")
def no_adhoc_counters(project: Project) -> Iterable[Finding]:
    for sub in ("data/api/", "workflow/"):
        for m in project.modules(sub):
            if m.tree is None or "/" in m.relpath[len(sub):]:
                continue  # top level of each dir, like the legacy guard
            disp = project.display_path(m)
            for node in m.tree.body:
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign):
                    targets = [node.target]
                else:
                    continue
                value = node.value
                banned = isinstance(value, (ast.Dict, ast.Set)) or (
                    isinstance(value, ast.Call)
                    and isinstance(value.func, ast.Name)
                    and value.func.id in _BANNED_CTOR)
                if not banned:
                    continue
                for t in targets:
                    if (isinstance(t, ast.Name) and any(
                            s in t.id.lower() for s in _COUNTERISH)):
                        yield Finding(
                            "no-adhoc-counters", disp, node.lineno,
                            f"module-level counter dict {t.id!r} — use a "
                            "common/telemetry.py registry family")


@rule("models-dao-confinement",
      "workflow/ reads model blobs only through model_artifact.py — any "
      "other Models-DAO touch bypasses checksum verification and reopens "
      "the corrupt-model-serves-production hole")
def models_dao_confinement(project: Project) -> Iterable[Finding]:
    for m in project.modules("workflow/"):
        if m.relpath == "workflow/model_artifact.py" or m.tree is None:
            continue
        disp = project.display_path(m)
        for node in m.walk():
            name = None
            if isinstance(node, ast.Attribute):
                name = node.attr
            elif isinstance(node, ast.Name):
                name = node.id
            if name == "get_model_data_models":
                yield Finding(
                    "models-dao-confinement", disp, node.lineno,
                    "get_model_data_models outside model_artifact.py — "
                    "read models via model_artifact.read_model")


#: the resident-cache internals only workflow/multitenant.py may touch:
#: the LRU ordered dict and the eviction victim scan. Everything else
#: goes through TenantMux's public surface (admit/ensure_loaded/
#: release/...), because the public surface is where the isolation
#: guarantees live — refcounted eviction ("never drop a tenant
#: mid-query"), per-tenant pins, the admission budget.
_TENANT_INTERNALS = ("_resident_lru", "_evict_victim")


@rule("tenant-confinement",
      "only workflow/multitenant.py touches the multi-tenant "
      "resident-cache internals (_resident_lru / _evict_victim) — a "
      "side-channel cache touch skips the eviction refcount and the "
      "per-tenant pin/budget isolation")
def tenant_confinement(project: Project) -> Iterable[Finding]:
    chokepoint = project.module("workflow/multitenant.py")
    if chokepoint is None or chokepoint.tree is None:
        return  # scoped scan without the mux module
    if not any(
            isinstance(n, (ast.Attribute, ast.Name))
            and getattr(n, "attr", getattr(n, "id", None))
            == "_resident_lru" for n in chokepoint.walk()):
        yield Finding(
            "tenant-confinement", project.display_path(chokepoint), 1,
            "resident-cache chokepoint (_resident_lru in "
            "workflow/multitenant.py) not found — renamed? The "
            "confinement guard has nothing to protect")
        return
    for m in project.modules(""):
        if m.relpath == "workflow/multitenant.py" or m.tree is None:
            continue
        disp = project.display_path(m)
        for node in m.walk():
            name = None
            if isinstance(node, ast.Attribute):
                name = node.attr
            elif isinstance(node, ast.Name):
                name = node.id
            if name in _TENANT_INTERNALS:
                yield Finding(
                    "tenant-confinement", disp, node.lineno,
                    f"{name} outside workflow/multitenant.py — go "
                    "through TenantMux's public surface "
                    "(admit/ensure_loaded/release/snapshot)")


@rule("query-dispatch-gate",
      "engine-server handlers (the threaded EngineServer's handle_*) "
      "route query compute only through the admission gate "
      "(handle_query → _dispatch_query) — direct executor dispatch "
      "bypasses the bounded executor, shedding and deadline budget")
def query_dispatch_gate(project: Project) -> Iterable[Finding]:
    m = project.module("workflow/create_server.py")
    if m is None or m.tree is None:
        return
    disp = project.display_path(m)
    cls = _class(m, "EngineServer")
    if cls is None:
        yield Finding("query-dispatch-gate", disp, 1,
                      "class EngineServer not found — the dispatch guard "
                      "has nothing to check (was it renamed?)")
        return

    def mentions_query_compute(node) -> bool:
        return any(isinstance(sub, ast.Attribute)
                   and sub.attr in ("query", "batch_query")
                   for sub in ast.walk(node))

    gated = False
    for fn in ast.walk(cls):
        if not isinstance(fn, _HANDLER_DEFS) \
                or not fn.name.startswith("handle_"):
            continue
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            name = _call_name(n)
            if name in ("to_thread", "run_in_executor", "submit") and \
                    any(mentions_query_compute(a) for a in n.args):
                yield Finding(
                    "query-dispatch-gate", disp, n.lineno,
                    f"{fn.name} ships query compute to {name}() directly; "
                    "route it through EngineServer._dispatch_query")
            if fn.name == "handle_query" and name == "_dispatch_query":
                gated = True
    if not gated:
        yield Finding("query-dispatch-gate", disp, cls.lineno,
                      "handle_query no longer routes through "
                      "_dispatch_query")


#: the one models/ module allowed to touch ops.sharded_topk internals
_SHARDED_TOPK_FACADE = "models/_sharded_serving.py"


@rule("sharded-topk-confinement",
      "template code under models/ touches ops.sharded_topk internals "
      "only through the models/_sharded_serving.py facade — the "
      "mesh/host/flat layout choice (and its bit-identity contract) "
      "lives in exactly one place")
def sharded_topk_confinement(project: Project) -> Iterable[Finding]:
    for m in project.modules("models/"):
        if m.relpath == _SHARDED_TOPK_FACADE or m.tree is None:
            continue
        disp = project.display_path(m)
        for node in m.walk():
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if (mod == "sharded_topk" or mod.endswith(".sharded_topk")
                        or any(a.name == "sharded_topk"
                               for a in node.names)):
                    yield Finding(
                        "sharded-topk-confinement", disp, node.lineno,
                        "import from ops.sharded_topk outside the "
                        "_sharded_serving facade — score through "
                        "ShardedCatalog/ShardedIndicators instead")
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.endswith("sharded_topk"):
                        yield Finding(
                            "sharded-topk-confinement", disp, node.lineno,
                            "import of ops.sharded_topk outside the "
                            "_sharded_serving facade — score through "
                            "ShardedCatalog/ShardedIndicators instead")
            elif (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "sharded_topk"):
                yield Finding(
                    "sharded-topk-confinement", disp, node.lineno,
                    f"sharded_topk.{node.attr} referenced outside the "
                    "_sharded_serving facade — score through "
                    "ShardedCatalog/ShardedIndicators instead")


#: merged-view scan entries + shard-file access primitives banned on
#: the training path (see train_feed_confinement)
_FEED_BANNED_REFS = ("_merged_scan", "shard_paths", "scan_log_file")
_FEED_BANNED_CALLS = ("find_batches",)


@rule("train-feed-confinement",
      "training-path modules under workflow/ and ops/ must not read "
      "events through the merged JSON view (_merged_scan / "
      "find_batches) or touch shard files directly (shard_paths / "
      "scan_log_file) — the partition-feed reader API "
      "(data/api/partition_feed.py) is the one sanctioned shard "
      "access, so gang training provably reads zero merged bytes")
def train_feed_confinement(project: Project) -> Iterable[Finding]:
    for sub in ("workflow/", "ops/"):
        for m in project.modules(sub):
            if m.tree is None:
                continue
            disp = project.display_path(m)
            for node in m.walk():
                name = None
                if isinstance(node, ast.Attribute):
                    name = node.attr
                elif isinstance(node, ast.Name):
                    name = node.id
                if name in _FEED_BANNED_REFS:
                    yield Finding(
                        "train-feed-confinement", disp, node.lineno,
                        f"{name} referenced on the training path — "
                        "read events via data/api/partition_feed.py "
                        "(or the row-level store APIs), never the "
                        "merged scan or raw shard files")
                if isinstance(node, ast.Call) \
                        and _call_name(node) in _FEED_BANNED_CALLS:
                    yield Finding(
                        "train-feed-confinement", disp, node.lineno,
                        f"{_call_name(node)}() on the training path — "
                        "the merged-view batch scan bypasses the "
                        "partition feed; use "
                        "data/api/partition_feed.py")


#: the elastic-topology scale entry points: supervisor dynamic
#: membership (add_worker/retire_worker) and the coordinator's fenced
#: scale-directive writes (apply_scale/set_replicas). Only the elastic
#: control loop (workflow/fleet.py hosts it; workflow/elastic.py is the
#: pure decision function), the event-tier rescaler (data/api/
#: event_log.py) and the supervisor itself may call them — a side-
#: channel scale call skips drain-before-SIGTERM ordering, the
#: epoch-fenced decision log, and readiness withdrawal.
_SCALE_ENTRY_POINTS = ("add_worker", "retire_worker",
                       "apply_scale", "set_replicas")
_SCALE_ALLOWED = ("workflow/elastic.py", "workflow/fleet.py",
                  "data/api/event_log.py", "parallel/supervisor.py")


@rule("scale-directive-confinement",
      "only the elastic control loop (workflow/elastic.py + the fleet "
      "coordinator in workflow/fleet.py), the event-tier rescaler and "
      "the supervisor may call scale entry points (add_worker/"
      "retire_worker) or write scale directive rows (apply_scale/"
      "set_replicas) — a side-channel scale call skips drain ordering, "
      "readiness withdrawal and the fenced decision log")
def scale_directive_confinement(project: Project) -> Iterable[Finding]:
    chokepoint = project.module("workflow/fleet.py")
    if chokepoint is None or chokepoint.tree is None:
        return  # scoped scan without the fleet module
    if not any(isinstance(n, ast.Call)
               and _call_name(n) == "apply_scale"
               for n in chokepoint.walk()):
        yield Finding(
            "scale-directive-confinement",
            project.display_path(chokepoint), 1,
            "scale chokepoint (apply_scale in workflow/fleet.py) not "
            "found — renamed? The confinement guard has nothing to "
            "protect")
        return
    for m in project.modules(""):
        if m.relpath in _SCALE_ALLOWED or m.tree is None:
            continue
        disp = project.display_path(m)
        for node in m.walk():
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name in _SCALE_ENTRY_POINTS:
                yield Finding(
                    "scale-directive-confinement", disp, node.lineno,
                    f"{name}() outside the elastic control loop — "
                    "scale only via the autoscaler (workflow/"
                    "elastic.py decisions applied by workflow/"
                    "fleet.py) or `pio eventserver scale`")


RULES = [ingest_hot_path, spawn_confinement, resilient_urlopen,
         wal_suffix_confinement, no_adhoc_counters, models_dao_confinement,
         tenant_confinement, query_dispatch_gate,
         sharded_topk_confinement, train_feed_confinement,
         scale_directive_confinement]
