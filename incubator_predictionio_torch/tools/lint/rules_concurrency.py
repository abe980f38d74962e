"""Concurrency rules: lock-guarded state and event-loop hygiene.

The port's copy of the reference's ``tools/lint/rules_concurrency.py``.
It mechanizes two defect classes:

- **lock-discipline** — attributes REGISTERED as lock-guarded may only
  be read/mutated inside a lexical ``with <lock>:`` block. The
  registry (:data:`LOCK_GUARDED`) is the contract: adding an attribute
  there makes every unguarded access a finding, so the next
  "harmless" counter bump from a worker thread fails lint instead of
  losing increments in production. The port runs threads wherever the
  reference ran an event loop, so its registry is larger.
- **no-blocking-on-loop** — known-blocking stdlib calls inside
  ``async def`` bodies of the modules that run an asyncio loop. One
  blocked event loop freezes EVERY connection on that server.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from .engine import Finding, Project, rule

# _LOOP_SCOPES and the _BLOCKING_* tables are shared with the
# whole-program rules_flow family: ONE definition of "serving module"
# and "known-blocking call" or the lexical and flow rules drift apart.
__all__ = ["RULES", "LOCK_GUARDED", "_LOOP_SCOPES",
           "_BLOCKING_QUALIFIED", "_BLOCKING_BARE"]

# -- lock-discipline registry ----------------------------------------------
# module relpath -> list of (class name or None for module scope,
#                            lock attribute, guarded attributes)
#
# The port's servers are thread pools, so every attribute below is
# touched by more than one thread: the engine server's lifecycle state
# (request threads, the refresh, fold-in, quality and fleet threads) and
# its admission counters (request threads, the query executor, whatever
# thread renders /metrics); the ingest buffer's shed map (handler threads
# and the per-key committers); the event server's shed count; the
# event-log lease fd (commit threads against shutdown); the supervisor's
# heartbeat throttle and its membership; the fold-in rollback counts.
# Construction-time writes (``__init__`` / ``_init_*``) are exempt — no
# second thread exists yet.
LOCK_GUARDED: dict[str, list[tuple[Optional[str], str, frozenset]]] = {
    "workflow/create_server.py": [
        ("EngineServer", "_lock", frozenset({
            "_pinned", "_pins_provisional", "_previous", "_rollbacks",
            "_swap_count", "_validate_failures", "_refresh_swaps",
            "_chain", "_chain_since"})),
        ("EngineServer", "_adm_lock", frozenset({
            "_adm_pending", "_adm_peak", "_shed_count", "_deadline_count",
            "_orphaned", "_draining", "_drain_stragglers", "_unanswered",
            "_reload_conflicts"})),
    ],
    "data/api/ingest_buffer.py": [
        ("IngestBuffer", "_lock", frozenset({"_shed"})),
    ],
    "data/api/event_server.py": [
        ("EventServer", "_shed_lock", frozenset({"shed_count"})),
    ],
    "data/api/event_log.py": [
        ("Lease", "_fd_lock", frozenset({"_fd"})),
    ],
    "parallel/supervisor.py": [
        (None, "_hb_lock", frozenset({"_hb_last", "_hb_interval"})),
    ],
    "workflow/online.py": [
        (None, "_rollback_lock", frozenset({"_rollbacks"})),
    ],
}


def _with_locks(node: ast.With, classscope: bool) -> set[str]:
    """Lock names a ``with`` statement acquires: ``self.<name>`` in
    class scope, bare ``<name>`` at module scope."""
    out = set()
    for item in node.items:
        ce = item.context_expr
        if classscope and isinstance(ce, ast.Attribute) \
                and isinstance(ce.value, ast.Name) and ce.value.id == "self":
            out.add(ce.attr)
        elif not classscope and isinstance(ce, ast.Name):
            out.add(ce.id)
    return out


@rule("lock-discipline",
      "attributes registered as lock-guarded (LOCK_GUARDED) may only be "
      "touched inside a `with <lock>:` block — unguarded cross-thread "
      "access loses updates")
def lock_discipline(project: Project) -> Iterable[Finding]:
    for relpath, entries in LOCK_GUARDED.items():
        m = project.module(relpath)
        if m is None or m.tree is None:
            continue
        disp = project.display_path(m)
        for classname, lock, attrs in entries:
            if classname is not None:
                scope = next(
                    (n for n in m.walk() if isinstance(n, ast.ClassDef)
                     and n.name == classname), None)
                if scope is None:
                    yield Finding(
                        "lock-discipline", disp, 1,
                        f"class {classname} not found but registered in "
                        "LOCK_GUARDED — fix the registry or the rename")
                    continue
            else:
                scope = m.tree
            # guarded attrs must exist at all — a registry entry for a
            # deleted attribute is a stale contract
            found_any = {a: False for a in attrs}
            for fn in ast.walk(scope):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if fn.name == "__init__" or fn.name.startswith("_init"):
                    for n in ast.walk(fn):
                        a = _guarded_access(n, attrs, classname is not None)
                        if a:
                            found_any[a] = True
                    continue
                yield from _check_fn(fn, disp, classname is not None,
                                     lock, attrs, found_any)
            for attr, seen in sorted(found_any.items()):
                if not seen:
                    yield Finding(
                        "lock-discipline", disp, 1,
                        f"LOCK_GUARDED names {attr!r} in "
                        f"{classname or 'module scope'} but no such "
                        "access exists — stale registry entry")


def _guarded_access(node, attrs: frozenset, classscope: bool) \
        -> Optional[str]:
    if classscope:
        if isinstance(node, ast.Attribute) and node.attr in attrs \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            return node.attr
    else:
        if isinstance(node, ast.Name) and node.id in attrs:
            return node.id
    return None


def _check_fn(fn, disp: str, classscope: bool, lock: str,
              attrs: frozenset, found_any: dict) -> Iterable[Finding]:
    def visit(node, held: bool):
        if isinstance(node, ast.With):
            now_held = held or lock in _with_locks(node, classscope)
            for item in node.items:
                yield from visit(item.context_expr, held)
                if item.optional_vars is not None:
                    yield from visit(item.optional_vars, held)
            for child in node.body:
                yield from visit(child, now_held)
            return
        a = _guarded_access(node, attrs, classscope)
        if a is not None:
            found_any[a] = True
            if not held:
                target = f"self.{a}" if classscope else a
                lockname = f"self.{lock}" if classscope else lock
                yield Finding(
                    "lock-discipline", disp, node.lineno,
                    f"{target} accessed outside `with {lockname}:` "
                    f"in {fn.name}()")
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested defs run later, possibly on another thread —
                # they are separate scopes the outer walk visits on
                # their own (with no lock held) and must lock themselves
                continue
            if isinstance(child, ast.Lambda):
                # a lambda body runs later too (collector callbacks are
                # the canonical case) — but unlike a def it CANNOT take
                # the lock itself, so any guarded access inside one is
                # a finding regardless of what the definition site held
                yield from visit(child.body, False)
                continue
            yield from visit(child, held)

    for stmt in fn.body:
        yield from visit(stmt, False)


# -- no-blocking-on-loop ---------------------------------------------------

# modules whose async defs run on an asyncio event loop: the splice
# front, the partitioned event tier's front, and the fleet's front,
# coordinator and elastic loop (the engine and event servers run on
# threads)
_LOOP_SCOPES = ("common/splice.py", "data/api/event_log.py",
                "workflow/elastic.py", "workflow/fleet.py")

# known-blocking stdlib calls: receiver-qualified names
_BLOCKING_QUALIFIED = {
    ("time", "sleep"), ("os", "fsync"), ("os", "fdatasync"),
    ("os", "system"), ("os", "listdir"), ("os", "scandir"),
    ("os", "replace"), ("os", "rename"), ("os", "unlink"),
    ("os", "makedirs"), ("os", "walk"),
    ("subprocess", "run"), ("subprocess", "call"),
    ("subprocess", "check_call"), ("subprocess", "check_output"),
    ("subprocess", "Popen"),
    ("socket", "create_connection"), ("fcntl", "flock"),
    ("shutil", "copy"), ("shutil", "copyfile"), ("shutil", "move"),
    ("shutil", "rmtree"),
}
# bare names (builtins / common from-imports)
_BLOCKING_BARE = {"open", "urlopen"}


@rule("no-blocking-on-loop",
      "no blocking stdlib calls (time.sleep, open, fsync, subprocess, "
      "urlopen, os.listdir, ...) inside async def bodies of the asyncio "
      "modules — a blocked loop freezes every connection on that server")
def no_blocking_on_loop(project: Project) -> Iterable[Finding]:
    mods = []
    for scope in _LOOP_SCOPES:
        if scope.endswith(".py"):
            m = project.module(scope)
            if m is not None:
                mods.append(m)
        else:
            mods.extend(project.modules(scope))
    for m in mods:
        if m.tree is None:
            continue
        disp = project.display_path(m)
        for afn in m.walk():
            if not isinstance(afn, ast.AsyncFunctionDef):
                continue
            stack = list(afn.body)
            while stack:
                n = stack.pop()
                if isinstance(n, (ast.FunctionDef, ast.Lambda,
                                  ast.AsyncFunctionDef)):
                    # nested sync defs are usually shipped to executors
                    # (to_thread/run_in_executor); nested async defs are
                    # visited by the outer module walk
                    continue
                stack.extend(ast.iter_child_nodes(n))
                if not isinstance(n, ast.Call):
                    continue
                f = n.func
                if isinstance(f, ast.Name) and f.id in _BLOCKING_BARE:
                    yield Finding(
                        "no-blocking-on-loop", disp, n.lineno,
                        f"blocking call {f.id}() inside async "
                        f"{afn.name}() — move it off-loop "
                        "(asyncio.to_thread / run_in_executor)")
                elif isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name):
                    recv = f.value.id.lstrip("_")
                    if (recv, f.attr) in _BLOCKING_QUALIFIED:
                        yield Finding(
                            "no-blocking-on-loop", disp, n.lineno,
                            f"blocking call {f.value.id}.{f.attr}() "
                            f"inside async {afn.name}() — move it "
                            "off-loop (asyncio.to_thread / "
                            "run_in_executor)")


RULES = [lock_discipline, no_blocking_on_loop]
