"""Whole-program call graph over the parsed :class:`~.engine.Project`.

The concurrency rules are lexical: they see one function at a time, so
a blocking call reached *through a helper* on the event loop, a lock
order that inverts only across two modules, or a lock held across an
``await`` in a callee would all be invisible.  This module builds, on
top of the same one-parse-per-module forest (torch-free, never importing
the checked code), a repo-wide call graph with per-function summaries
that the ``rules_flow`` family consumes. It is the port's copy of the
reference's ``tools/lint/callgraph.py``, unchanged in substance.

Model
-----
Every ``def`` / ``async def`` / ``lambda`` in the package is a node,
keyed ``"<relpath>::<qualname>"`` (nested functions get
``outer.<locals>.inner``; lambdas get ``outer.<lambda@line>``).  Per
node the builder records:

- **edges** — resolved calls, each tagged with the locks lexically held
  at the call site and whether the edge is *cut* (see below);
- **blocking** — direct known-blocking stdlib calls (the same tables
  the lexical ``no-blocking-on-loop`` rule uses);
- **awaits** — ``await`` expression lines;
- **acquires / nested / across_await** — ``with <lock>:`` facts against
  the lock registry.

Call resolution (the whole-program part) covers exactly:

- bare names → enclosing function's nested defs, then module-level
  functions/classes, then intra-package ``from x import f`` symbols;
- ``self.m()`` → methods of the enclosing class, then same-module base
  classes (one level);
- ``alias.f()`` where ``alias`` is an intra-package module import
  (``from . import event_log`` / ``from ..common import envknobs``).

Anything else — method calls on arbitrary objects, attribute chains,
dynamic dispatch — resolves to **nothing**: the walk simply stops.
That is the conservatism policy: the graph only asserts edges it can
prove, so flow rules may miss defects behind dynamic dispatch but
never invent one (a lint gate that cries wolf gets deleted).

Cut edges
---------
``asyncio.to_thread(fn, ...)``, ``loop.run_in_executor(ex, fn, ...)``,
``executor.submit(fn, ...)`` and ``threading.Thread(target=fn)`` /
``Process(target=fn)`` ship their callable OFF the event loop.  The
callable argument still gets an edge — marked ``cut=True`` — so
loop-reachability walks terminate there while thread-side analyses can
still see the code.  A function referenced only through a cut edge is
exactly the "shipped to an executor" idiom the lexical rule had to
assume about every nested def; the graph proves it per call site.

Lock registry
-------------
A lock is any name assigned ``threading.Lock()`` / ``threading.RLock()``
/ ``asyncio.Lock()`` (module scope or ``self.<attr>`` in a class), plus
everything registered in :data:`~.rules_concurrency.LOCK_GUARDED`.
Identity is ``(module, class|None, name)`` — two instances of the same
class share a key (their lock ORDER discipline is shared), while locks
of different classes never alias.  ``with`` spans resolve only through
``self.<attr>`` / bare module-scope names, so a span on somebody
else's lock (``other._lock``) is out of scope by design.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Optional

from .engine import Module, Project

__all__ = ["CallGraph", "FuncNode", "CallEdge", "LockInfo", "graph_for"]

# call names whose callable argument runs OFF the event loop
_CUT_CALLS = frozenset({"to_thread", "run_in_executor", "submit"})
# constructors whose target=/args callable runs on ANOTHER thread/process
_CUT_CTORS = frozenset({"Thread", "Process"})

_THREAD_LOCK_CTORS = frozenset({"Lock", "RLock"})


@dataclasses.dataclass(frozen=True)
class LockInfo:
    """One lock identity: ``(module, class|None, attr/name)``."""

    relpath: str
    classname: Optional[str]
    name: str
    kind: str        # "thread" | "rthread" | "asyncio"
    lineno: int      # definition site (LOCK_GUARDED entries: 0)

    @property
    def key(self) -> str:
        scope = f"{self.classname}." if self.classname else ""
        return f"{self.relpath}::{scope}{self.name}"

    def render(self) -> str:
        owner = f"{self.classname}." if self.classname else ""
        return f"{owner}{self.name} ({self.relpath})"


@dataclasses.dataclass
class CallEdge:
    lineno: int
    target: str                  # FuncNode key
    cut: bool                    # off-loop boundary
    held: tuple[str, ...]        # lock keys lexically held at the site


@dataclasses.dataclass
class FuncNode:
    key: str
    relpath: str
    qualname: str
    lineno: int
    is_async: bool
    classname: Optional[str]
    edges: list[CallEdge] = dataclasses.field(default_factory=list)
    blocking: list[tuple[int, str]] = dataclasses.field(default_factory=list)
    awaits: list[int] = dataclasses.field(default_factory=list)
    # (lock key, lineno) for every `with <lock>:` span in this function
    acquires: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    # (outer lock key, inner lock key, lineno) for lexically nested spans
    nested: list[tuple[str, str, int]] = dataclasses.field(
        default_factory=list)
    # (lock key, lineno) — a span lexically nested inside a span of the
    # SAME lock (re-entry without any call in between)
    renests: list[tuple[str, int]] = dataclasses.field(
        default_factory=list)
    # (lock key, await lineno) — await inside a `with <lock>:` span
    across_await: list[tuple[str, int]] = dataclasses.field(
        default_factory=list)

    @property
    def short(self) -> str:
        return f"{self.relpath}::{self.qualname}"


class _ModuleIndex:
    """Per-module name tables used by resolution."""

    def __init__(self) -> None:
        self.functions: dict[str, str] = {}        # top-level fn -> key
        self.classes: dict[str, dict[str, str]] = {}   # class -> {meth: key}
        self.class_bases: dict[str, list[str]] = {}    # class -> base names
        self.imports: dict[str, str] = {}          # alias -> module relpath
        self.symbols: dict[str, tuple[str, str]] = {}  # name -> (rel, sym)


class CallGraph:
    def __init__(self, project: Project):
        self.project = project
        self.functions: dict[str, FuncNode] = {}
        self.locks: dict[str, LockInfo] = {}
        self._index: dict[str, _ModuleIndex] = {}
        self._reach_memo: dict[str, dict] = {}
        self._lock_memo: dict[str, dict] = {}
        self._build()

    # -- construction ------------------------------------------------------
    def _build(self) -> None:
        modules = [m for m in self.project.modules() if m.tree is not None]
        for m in modules:
            self._index[m.relpath] = self._index_module(m)
        self._register_guarded_locks()
        for m in modules:
            self._collect_module(m)

    def _index_module(self, m: Module) -> _ModuleIndex:
        idx = _ModuleIndex()
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                idx.functions[node.name] = f"{m.relpath}::{node.name}"
            elif isinstance(node, ast.ClassDef):
                meths = {}
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        meths[sub.name] = \
                            f"{m.relpath}::{node.name}.{sub.name}"
                idx.classes[node.name] = meths
                idx.class_bases[node.name] = [
                    b.id for b in node.bases if isinstance(b, ast.Name)]
        # imports anywhere in the module (function-level included: the
        # lazy-import idiom is everywhere in the serving modules)
        for node in m.walk():
            if isinstance(node, ast.ImportFrom):
                self._index_import_from(m, node, idx)
            elif isinstance(node, ast.Import):
                self._index_import(m, node, idx)
        # module-scope locks
        for node in m.tree.body:
            self._maybe_lock_assign(m, node, None)
        # self.<attr> locks in class __init__-like methods (any method,
        # actually — a lock created lazily is still a lock)
        for node in m.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            for sub in ast.walk(node):
                self._maybe_lock_assign(m, sub, node.name)
        return idx

    def _pkg_module(self, parts: list[str]) -> Optional[str]:
        """relpath for a dotted intra-package module path, or None."""
        if not parts:
            return None
        cand = "/".join(parts) + ".py"
        if self.project.module(cand) is not None:
            return cand
        cand = "/".join(parts) + "/__init__.py"
        if self.project.module(cand) is not None:
            return cand
        return None

    def _index_import_from(self, m: Module, node: ast.ImportFrom,
                           idx: _ModuleIndex) -> None:
        from .engine import PACKAGE_NAME

        dir_parts = m.relpath.split("/")[:-1]
        if node.level > 0:
            up = node.level - 1
            if up > len(dir_parts):
                return
            base = dir_parts[:len(dir_parts) - up] if up else dir_parts
        else:
            mod = node.module or ""
            if not mod.startswith(PACKAGE_NAME):
                return
            base = []
            mod = mod[len(PACKAGE_NAME):].lstrip(".")
            node = ast.ImportFrom(module=mod or None, names=node.names,
                                  level=0)
        mod_parts = base + (node.module.split(".") if node.module else [])
        for alias in node.names:
            name, asname = alias.name, alias.asname or alias.name
            sub = self._pkg_module(mod_parts + [name])
            if sub is not None:
                idx.imports[asname] = sub        # module import
                continue
            owner = self._pkg_module(mod_parts)
            if owner is not None:
                idx.symbols[asname] = (owner, name)

    def _index_import(self, m: Module, node: ast.Import,
                      idx: _ModuleIndex) -> None:
        from .engine import PACKAGE_NAME

        for alias in node.names:
            if not alias.name.startswith(PACKAGE_NAME):
                continue
            parts = alias.name[len(PACKAGE_NAME):].lstrip(".").split(".")
            parts = [p for p in parts if p]
            rel = self._pkg_module(parts)
            if rel is not None and alias.asname:
                idx.imports[alias.asname] = rel

    def _maybe_lock_assign(self, m: Module, node,
                           classname: Optional[str]) -> None:
        """Register ``X = threading.Lock()`` / ``self.X = asyncio.Lock()``."""
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            return
        v = node.value
        if not (isinstance(v, ast.Call)
                and isinstance(v.func, ast.Attribute)
                and isinstance(v.func.value, ast.Name)):
            return
        recv, ctor = v.func.value.id, v.func.attr
        if recv == "threading" and ctor in _THREAD_LOCK_CTORS:
            kind = "rthread" if ctor == "RLock" else "thread"
        elif recv == "asyncio" and ctor == "Lock":
            kind = "asyncio"
        else:
            return
        t = node.targets[0]
        if classname is None and isinstance(t, ast.Name):
            info = LockInfo(m.relpath, None, t.id, kind, node.lineno)
        elif classname is not None and isinstance(t, ast.Attribute) \
                and isinstance(t.value, ast.Name) and t.value.id == "self":
            info = LockInfo(m.relpath, classname, t.attr, kind, node.lineno)
        else:
            return
        self.locks.setdefault(info.key, info)

    def _register_guarded_locks(self) -> None:
        """LOCK_GUARDED names locks the assignment scan may or may not
        have seen (a registered lock created by a helper still counts)."""
        from .rules_concurrency import LOCK_GUARDED

        for relpath, entries in LOCK_GUARDED.items():
            if self.project.module(relpath) is None:
                continue
            for classname, lock, _attrs in entries:
                # kind "guarded" = constructor unseen by the assignment
                # scan (setdefault: a scanned literal wins). It joins
                # the order graph — inversion deadlocks regardless of
                # lock flavour — but makes NO reentrancy or
                # held-across-await claims: those need the real kind,
                # and guessing "thread" would call a helper-built RLock
                # a guaranteed self-deadlock on a clean repo.
                info = LockInfo(relpath, classname, lock, "guarded", 0)
                self.locks.setdefault(info.key, info)

    # -- per-function fact collection --------------------------------------
    def _collect_module(self, m: Module) -> None:
        idx = self._index[m.relpath]

        def visit_scope(body, qualprefix: str, classname: Optional[str],
                        localdefs: dict[str, str],
                        class_body: bool = False):
            """Register functions in ``body`` then walk each.  METHODS
            are never registered as bare names: Python scoping keeps a
            class body out of its methods' name lookup, so a bare
            ``helper()`` inside a method must resolve to the module /
            imported ``helper``, not a sibling method (``self.helper()``
            is the method spelling)."""
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and not class_body:
                    qn = f"{qualprefix}{node.name}"
                    localdefs[node.name] = f"{m.relpath}::{qn}"
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qn = f"{qualprefix}{node.name}"
                    self._collect_function(m, idx, node, qn, classname,
                                           dict(localdefs))
                elif isinstance(node, ast.ClassDef):
                    # always the class's OWN name: methods of a class
                    # nested inside another must not resolve `self.m()`
                    # / `with self._lock:` against the outer class —
                    # the nested class is not indexed, so its methods
                    # resolve to nothing (conservatism) instead of to
                    # the wrong class's members
                    visit_scope(node.body, f"{qualprefix}{node.name}.",
                                node.name, dict(localdefs),
                                class_body=True)

        visit_scope(m.tree.body, "", None, {})

    def _collect_function(self, m: Module, idx: _ModuleIndex, fnode,
                          qualname: str, classname: Optional[str],
                          localdefs: dict[str, str]) -> None:
        key = f"{m.relpath}::{qualname}"
        node = FuncNode(
            key=key, relpath=m.relpath, qualname=qualname,
            lineno=fnode.lineno,
            is_async=isinstance(fnode, ast.AsyncFunctionDef),
            classname=classname)
        self.functions[key] = node

        # nested defs inside THIS function body become their own nodes,
        # resolvable by bare name from here
        inner_defs = dict(localdefs)
        pending_nested: list = []

        def register_nested(body_nodes):
            """Defs lexically in THIS function (any statement depth —
            an ``except``-handler helper is still a local def), but not
            inside deeper nested functions/lambdas — and not inside a
            class defined here: its METHODS are not bare names in the
            function scope (registering them would shadow the real
            module-level target and invent edges), so a function-local
            class is simply out of proof reach."""
            stack = list(body_nodes)
            while stack:
                sub = stack.pop()
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    nq = f"{qualname}.<locals>.{sub.name}"
                    inner_defs[sub.name] = f"{m.relpath}::{nq}"
                    pending_nested.append((sub, nq))
                    continue
                if isinstance(sub, (ast.Lambda, ast.ClassDef)):
                    continue
                stack.extend(ast.iter_child_nodes(sub))

        def lock_key(ce) -> Optional[str]:
            """Resolve a with-item context expr to a lock key."""
            if classname is not None and isinstance(ce, ast.Attribute) \
                    and isinstance(ce.value, ast.Name) \
                    and ce.value.id == "self":
                k = LockInfo(m.relpath, classname, ce.attr, "", 0).key
                return k if k in self.locks else None
            if isinstance(ce, ast.Name):
                k = LockInfo(m.relpath, None, ce.id, "", 0).key
                return k if k in self.locks else None
            return None

        def resolve_ref(ref) -> Optional[str]:
            """A *reference* to a callable (not a call): bare name,
            ``self.m``, or ``alias.f``."""
            if isinstance(ref, ast.Name):
                n = ref.id
                if n in inner_defs:
                    return inner_defs[n]
                if n in idx.functions:
                    return idx.functions[n]
                if n in idx.classes:
                    return idx.classes[n].get("__init__")
                if n in idx.symbols:
                    rel, sym = idx.symbols[n]
                    return self._module_symbol(rel, sym)
                return None
            if isinstance(ref, ast.Attribute) \
                    and isinstance(ref.value, ast.Name):
                recv, attr = ref.value.id, ref.attr
                if recv == "self" and classname is not None:
                    return self._self_method(m.relpath, classname, attr)
                if recv in idx.imports:
                    return self._module_symbol(idx.imports[recv], attr)
            return None

        def callable_args(call: ast.Call) -> Iterable:
            for a in call.args:
                yield a
            for kw in call.keywords:
                yield kw.value

        def handle_call(call: ast.Call, held: tuple):
            f = call.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else ""
            # cut-edge carriers: the callable ARG runs off-loop
            if name in _CUT_CALLS or name in _CUT_CTORS:
                for a in callable_args(call):
                    if isinstance(a, ast.Lambda):
                        lq = f"{qualname}.<lambda@{a.lineno}>"
                        self._collect_function(m, idx, a, lq, classname,
                                               dict(inner_defs))
                        node.edges.append(CallEdge(
                            call.lineno, f"{m.relpath}::{lq}", True, held))
                        continue
                    t = resolve_ref(a)
                    if t is not None:
                        node.edges.append(
                            CallEdge(call.lineno, t, True, held))
                return
            # direct blocking stdlib call?
            from .rules_concurrency import (_BLOCKING_BARE,
                                            _BLOCKING_QUALIFIED)

            if isinstance(f, ast.Name) and f.id in _BLOCKING_BARE:
                node.blocking.append((call.lineno, f"{f.id}"))
            elif isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name):
                recv = f.value.id.lstrip("_")
                if (recv, f.attr) in _BLOCKING_QUALIFIED:
                    node.blocking.append(
                        (call.lineno, f"{f.value.id}.{f.attr}"))
            t = resolve_ref(f)
            if t is not None:
                node.edges.append(CallEdge(call.lineno, t, False, held))

        def walk(n, held: tuple):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return      # separate node (registered by caller scope)
            if isinstance(n, ast.Lambda):
                # a lambda not fed to a cut call: body runs *sometime*
                # (often on the loop — done-callbacks), but the graph
                # can't prove when; give it a node, draw no edge
                lq = f"{qualname}.<lambda@{n.lineno}>"
                if f"{m.relpath}::{lq}" not in self.functions:
                    self._collect_function(m, idx, n, lq, classname,
                                           dict(inner_defs))
                return
            if isinstance(n, (ast.With, ast.AsyncWith)):
                # asyncio locks arrive via `async with` — they join the
                # acquisition-order graph (two coroutines can deadlock
                # on inverted asyncio locks exactly like two threads).
                # Items acquire LEFT TO RIGHT (`with A, B:` is the
                # nested-with sugar), so each item's lock joins `held`
                # before the next item is even evaluated.
                inner_held = held
                for item in n.items:
                    walk(item.context_expr, inner_held)
                    if item.optional_vars is not None:
                        walk(item.optional_vars, inner_held)
                    lk = lock_key(item.context_expr)
                    if lk is not None:
                        node.acquires.append((lk, n.lineno))
                        if lk in inner_held:
                            node.renests.append((lk, n.lineno))
                        for outer in inner_held:
                            if outer != lk:
                                node.nested.append((outer, lk, n.lineno))
                        inner_held = inner_held + (lk,)
                for child in n.body:
                    walk(child, inner_held)
                return
            if isinstance(n, ast.Await):
                node.awaits.append(n.lineno)
                for lk in held:
                    node.across_await.append((lk, n.lineno))
                walk(n.value, held)
                return
            if isinstance(n, ast.Call):
                handle_call(n, held)
                for child in ast.iter_child_nodes(n):
                    walk(child, held)
                return
            for child in ast.iter_child_nodes(n):
                walk(child, held)

        body = fnode.body if not isinstance(fnode, ast.Lambda) \
            else [ast.Expr(value=fnode.body)]
        if not isinstance(fnode, ast.Lambda):
            register_nested(body)
        for stmt in body:
            walk(stmt, ())
        for sub, nq in pending_nested:
            self._collect_function(m, idx, sub, nq, classname,
                                   dict(inner_defs))

    # -- resolution helpers ------------------------------------------------
    def _module_symbol(self, relpath: str, name: str,
                       _depth: int = 0) -> Optional[str]:
        idx = self._index.get(relpath)
        if idx is None:
            return None
        if name in idx.functions:
            return idx.functions[name]
        if name in idx.classes:
            return idx.classes[name].get("__init__")
        # re-exported symbol (common/__init__.py style): follow a few
        # hops, bounded — circular re-exports must degrade to
        # "unresolved" (conservatism), not recurse the linter to death
        if name in idx.symbols and _depth < 4:
            rel, sym = idx.symbols[name]
            if (rel, sym) != (relpath, name):
                return self._module_symbol(rel, sym, _depth + 1)
        return None

    def _self_method(self, relpath: str, classname: str,
                     attr: str) -> Optional[str]:
        idx = self._index.get(relpath)
        if idx is None:
            return None
        seen = set()
        stack = [classname]
        while stack:
            c = stack.pop()
            if c in seen or c not in idx.classes:
                continue
            seen.add(c)
            if attr in idx.classes[c]:
                return idx.classes[c][attr]
            stack.extend(idx.class_bases.get(c, ()))
        return None

    # -- queries -----------------------------------------------------------
    def node(self, key: str) -> Optional[FuncNode]:
        return self.functions.get(key)

    def reachable_blocking(self, key: str) -> dict:
        """``{(relpath, lineno, label): chain}`` for every blocking call
        reachable from ``key`` WITHOUT crossing a cut edge.  ``chain``
        is the function-key path (entry first, blocking owner last).
        Memoized per function; cycles terminate (a cycle adds no new
        blocking sites)."""
        return self._reach_walk(key, ())[0]

    def _reach_walk(self, k: str, path: tuple) -> tuple[dict, bool]:
        """Inner DFS.  Results are memoized only when the subtree walk
        hit no recursion back-edge (``clean``) — a truncated walk is
        correct for ITS caller chain but incomplete for anyone else."""
        memo = self._reach_memo
        if k in memo:
            return memo[k], True
        if k in path:
            return {}, False
        fn = self.functions.get(k)
        if fn is None:
            return {}, True
        local: dict = {}
        clean = True
        for lineno, label in fn.blocking:
            local.setdefault((fn.relpath, lineno, label), (k,))
        for e in fn.edges:
            if e.cut:
                continue
            sub, sub_clean = self._reach_walk(e.target, path + (k,))
            clean = clean and sub_clean
            for site, chain in sub.items():
                local.setdefault(site, (k,) + chain)
        if clean:
            memo[k] = local
        return local, clean

    def transitive_locks(self, key: str) -> dict:
        """``{lock key: (function key, lineno)}`` — locks acquired by
        ``key`` or any non-cut callee (first witness site).  Cut edges
        are NOT followed: a spawned thread acquires its locks in a
        different call stack, which is an ordering only a blocking join
        would serialize — out of proof reach, so out of scope."""
        memo = self._lock_memo
        if key in memo:
            return memo[key]

        def dfs(k: str, path: tuple) -> tuple[dict, bool]:
            if k in memo:
                return memo[k], True
            if k in path:
                return {}, False
            fn = self.functions.get(k)
            if fn is None:
                return {}, True
            local: dict = {}
            clean = True
            for lk, lineno in fn.acquires:
                local.setdefault(lk, (k, lineno))
            for e in fn.edges:
                if e.cut:
                    continue
                sub, sub_clean = dfs(e.target, path + (k,))
                clean = clean and sub_clean
                for lk, site in sub.items():
                    local.setdefault(lk, site)
            if clean:
                memo[k] = local
            return local, clean

        return dfs(key, ())[0]

    def lock_order_edges(self) -> dict:
        """Global acquisition-order graph: ``{(outer, inner): [(fnkey,
        lineno), ...]}`` from lexically nested spans plus call chains
        (call made while holding ``outer`` reaching an acquire of
        ``inner``)."""
        edges: dict = {}
        for fn in list(self.functions.values()):
            for outer, inner, lineno in fn.nested:
                edges.setdefault((outer, inner), []).append(
                    (fn.key, lineno))
            for e in fn.edges:
                if e.cut or not e.held:
                    continue
                for inner, _site in self.transitive_locks(e.target).items():
                    for outer in e.held:
                        if outer != inner:
                            edges.setdefault((outer, inner), []).append(
                                (fn.key, e.lineno))
        return edges

    def self_reacquires(self) -> list:
        """``(lock key, fn key, lineno)`` where a non-reentrant thread
        lock is acquired again while already held (lexically nested or
        through a non-cut call chain) — a guaranteed self-deadlock."""
        out = []
        for fn in list(self.functions.values()):
            for lk, lineno in fn.renests:
                info = self.locks.get(lk)
                if info is not None and info.kind == "thread":
                    out.append((lk, fn.key, lineno))
            for e in fn.edges:
                if e.cut or not e.held:
                    continue
                reach = self.transitive_locks(e.target)
                for lk in e.held:
                    info = self.locks.get(lk)
                    if info is None or info.kind != "thread":
                        continue
                    if lk in reach:
                        out.append((lk, fn.key, e.lineno))
        return out


def graph_for(project: Project) -> CallGraph:
    """The memoized CallGraph for a Project — built once, shared by
    every flow rule (the tier-1 budget contract extends to the graph:
    one parse pass AND one graph build per lint run)."""
    graph = getattr(project, "_flow_callgraph", None)
    if graph is None:
        graph = CallGraph(project)
        project._flow_callgraph = graph
    return graph
