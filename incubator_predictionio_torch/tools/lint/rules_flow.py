"""Whole-program flow rules over the :mod:`.callgraph`.

The port's copy of the reference's ``tools/lint/rules_flow.py``. The
lexical rules see one function at a time; these four see the whole
program, which is where these defect classes live: a blocking call
reached *through a helper* on an event loop, nested lock orders that
invert only across functions, a threading lock held across an
``await``, and chaos fault points no test ever arms.

- **transitive-blocking-on-loop** — async defs of the asyncio modules
  must not REACH a known-blocking stdlib call through any uncut sync
  call chain.  Chains of length 1 (blocking directly in the async body)
  stay with the lexical ``no-blocking-on-loop`` rule; this one owns
  everything deeper.  Cut edges (``to_thread`` / ``run_in_executor`` /
  ``submit`` / ``Thread(target=)``) terminate the walk — that IS the
  fix the finding asks for.
- **lock-order** — the global acquisition-order graph (lexically
  nested ``with`` spans + call chains made while holding a lock) must
  be acyclic; a cycle is a potential deadlock that strikes only under
  the exact interleaving production traffic eventually supplies.  The
  same machinery flags re-acquiring a non-reentrant ``threading.Lock``
  already held on the call stack — not "potential": that one is a
  guaranteed self-deadlock. On the port's thread pools this is the
  rule that matters most.
- **lock-held-across-await** — a ``threading`` lock held across an
  ``await`` parks the LOOP on lock contention: every connection on the
  server stalls until the lock holder resumes.  (``asyncio.Lock`` +
  ``async with`` is the loop-native tool; or release before awaiting.)
- **fault-point-coverage** — every registered fault point must be
  armed by at least one of the port's tests (a ``PIO_FAULT_SPEC``,
  ``PIO_EVENT_WORKER_FAULT_SPEC`` or ``PIO_FLEET_WORKER_FAULT_SPEC``
  literal in ``tests/test_torch_*.py`` or ``tests/torch_*.py``), closing the registry triangle:
  ``fault-point-registry`` syncs code ↔ table, this syncs code ↔
  tests.  An unarmed fault point is chaos tooling that silently stopped
  proving anything.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .callgraph import graph_for
from .engine import PORT_TEST_GLOBS, Finding, Project, rule
from .rules_concurrency import _LOOP_SCOPES

__all__ = ["RULES"]


def _loop_modules(project: Project):
    mods = []
    for scope in _LOOP_SCOPES:
        if scope.endswith(".py"):
            m = project.module(scope)
            if m is not None:
                mods.append(m)
        else:
            mods.extend(project.modules(scope))
    return mods


def _disp(project: Project, relpath: str) -> str:
    m = project.module(relpath)
    return project.display_path(m) if m is not None else relpath


def _chain_render(graph, chain: tuple) -> str:
    parts = []
    for k in chain:
        fn = graph.node(k)
        parts.append(fn.qualname if fn is not None else k)
    return " → ".join(parts)


# Injected latency (faultinject's sleep) is EXEMPT by design: a
# latency fault must simulate the instrumented call being slow *at the
# call site*, including on-loop sites — that stall is the experiment,
# not a defect, and specs are only ever armed by the chaos harness.
_BLOCKING_EXEMPT = ("common/faultinject.py",)


@rule("transitive-blocking-on-loop",
      "async handlers of the asyncio modules must not REACH a blocking "
      "stdlib call through any sync call chain still on the event loop "
      "— a helper that blocks freezes every connection exactly like an "
      "inline call; to_thread/run_in_executor/Thread cut the walk")
def transitive_blocking_on_loop(project: Project) -> Iterable[Finding]:
    graph = graph_for(project)
    loop_rels = {m.relpath for m in _loop_modules(project)}
    # site -> (entry chain, n_entries) — one finding per blocking site,
    # however many handlers reach it (suppressions stay per-line)
    sites: dict = {}
    for fn in graph.functions.values():
        if not fn.is_async or fn.relpath not in loop_rels:
            continue
        for site, chain in graph.reachable_blocking(fn.key).items():
            if len(chain) < 2:
                continue    # direct hit: the lexical rule owns it
            if site[0].startswith(_BLOCKING_EXEMPT):
                continue    # injected latency: the fault IS the point
            if site in sites:
                sites[site] = (sites[site][0], sites[site][1] + 1)
            else:
                sites[site] = (chain, 1)
    for (rel, lineno, label), (chain, n) in sorted(sites.items()):
        extra = f" (+{n - 1} more async entry point(s))" if n > 1 else ""
        yield Finding(
            "transitive-blocking-on-loop", _disp(project, rel), lineno,
            f"blocking call {label}() runs on the event loop via "
            f"{_chain_render(graph, chain)}{extra} — ship it off-loop "
            "(asyncio.to_thread / run_in_executor) or cut the chain")


def _scc(nodes: set, edges: dict) -> list:
    """Tarjan strongly-connected components over the lock digraph.
    ``edges``: {(a, b): sites}.  Returns components as sorted tuples,
    only those with ≥ 2 nodes (self-loops are handled separately —
    reentrant locks make A→A legal)."""
    succ: dict = {}
    for (a, b) in edges:
        succ.setdefault(a, set()).add(b)
    index: dict = {}
    low: dict = {}
    stack: list = []
    on_stack: set = set()
    out: list = []
    counter = [0]

    def strong(v):
        # iterative Tarjan: the lock graph is tiny, but recursion
        # limits are not a failure mode a linter may have
        work = [(v, iter(sorted(succ.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(succ.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    out.append(tuple(sorted(comp)))

    for v in sorted(nodes):
        if v not in index:
            strong(v)
    return out


@rule("lock-order",
      "the global lock acquisition-order graph (nested `with` spans + "
      "cross-function chains) must be acyclic, and a non-reentrant "
      "threading.Lock must never be re-acquired while held — cycles "
      "deadlock under the right interleaving, re-acquisition always")
def lock_order(project: Project) -> Iterable[Finding]:
    graph = graph_for(project)
    edges = graph.lock_order_edges()
    nodes = {a for a, _ in edges} | {b for _, b in edges}
    for comp in _scc(nodes, edges):
        witness = []
        anchor = None
        for (a, b), sites in sorted(edges.items()):
            if a in comp and b in comp and a != b:
                fnkey, lineno = sites[0]
                fn = graph.node(fnkey)
                if anchor is None:
                    anchor = (fn, fnkey, lineno)
                witness.append(
                    f"{graph.locks[a].render()} → "
                    f"{graph.locks[b].render()} in "
                    f"{fn.qualname if fn else fnkey}:{lineno}")
        if anchor is None:
            continue
        fn, fnkey, lineno = anchor
        rel = fn.relpath if fn is not None else fnkey.split("::")[0]
        yield Finding(
            "lock-order", _disp(project, rel), lineno,
            "inconsistent lock acquisition order — potential deadlock: "
            + "; ".join(witness)
            + " — pick ONE global order and stick to it")
    for lk, fnkey, lineno in sorted(graph.self_reacquires()):
        fn = graph.node(fnkey)
        rel = fn.relpath if fn is not None else fnkey.split("::")[0]
        yield Finding(
            "lock-order", _disp(project, rel), lineno,
            f"non-reentrant lock {graph.locks[lk].render()} is "
            f"re-acquired through a call made while already holding it "
            f"(in {fn.qualname if fn else fnkey}) — guaranteed "
            "self-deadlock; release first or use an RLock deliberately")


@rule("lock-held-across-await",
      "a threading lock held across an `await` stalls the WHOLE event "
      "loop whenever another thread holds the lock — release before "
      "awaiting, or use asyncio.Lock for loop-side exclusion")
def lock_held_across_await(project: Project) -> Iterable[Finding]:
    graph = graph_for(project)
    for fn in sorted(graph.functions.values(), key=lambda f: f.key):
        for lk, lineno in fn.across_await:
            info = graph.locks.get(lk)
            if info is None or info.kind not in ("thread", "rthread"):
                continue
            yield Finding(
                "lock-held-across-await", _disp(project, fn.relpath),
                lineno,
                f"threading lock {info.render()} is held across an "
                f"await in {fn.qualname} — under contention this parks "
                "the event loop itself; release before awaiting or use "
                "asyncio.Lock")


# the replicas' first-launch spec arms points too (fleet.spawn runs in a
# replica before its engine loads, so no other spec can reach it)
_FAULT_SPEC_ENVS = ("PIO_FAULT_SPEC", "PIO_EVENT_WORKER_FAULT_SPEC",
                    "PIO_FLEET_WORKER_FAULT_SPEC")


def _armed_literals(project: Project) -> frozenset:
    """Every string literal in one of the port's test modules
    (:data:`~.engine.PORT_TEST_GLOBS`) that mentions a fault-spec env
    knob.  Memoized per Project (same contract as the parsed module
    forest)."""
    cached = getattr(project, "_fault_armed_literals", None)
    if cached is not None:
        return cached
    literals: set = set()
    for p in project.port_py_paths(PORT_TEST_GLOBS):
        try:
            text = p.read_text(encoding="utf-8")
        except OSError:  # pragma: no cover
            continue
        if not any(env in text for env in _FAULT_SPEC_ENVS):
            continue
        try:
            tree = ast.parse(text)
        except SyntaxError:  # pragma: no cover — tier-1 parses
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                literals.add(node.value)
    project._fault_armed_literals = frozenset(literals)
    return project._fault_armed_literals


@rule("fault-point-coverage",
      "every registered fault point is armed by at least one of the "
      "port's tests (a PIO_FAULT_SPEC, PIO_EVENT_WORKER_FAULT_SPEC or "
      "PIO_FLEET_WORKER_FAULT_SPEC literal in tests/test_torch_*.py or "
      "tests/torch_*.py) — an "
      "unarmed point is chaos tooling that proves nothing")
def fault_point_coverage(project: Project) -> Iterable[Finding]:
    armed = _armed_literals(project)

    def is_armed(point: str) -> bool:
        return any(point in lit for lit in armed)

    seen: set = set()
    for m in project.modules():
        if m.tree is None or m.relpath.startswith("tools/lint/"):
            continue
        disp = project.display_path(m)
        for node in m.walk():
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else ""
            if name not in ("fault_point", "stream_fault") or not node.args:
                continue
            a0 = node.args[0]
            if not (isinstance(a0, ast.Constant)
                    and isinstance(a0.value, str)):
                continue    # variable point names: out of static reach
            point = a0.value
            if point in seen:
                continue
            seen.add(point)
            if not is_armed(point):
                yield Finding(
                    "fault-point-coverage", disp, node.lineno,
                    f"fault point {point!r} is never armed by any test "
                    "— no PIO_FAULT_SPEC/PIO_EVENT_WORKER_FAULT_SPEC "
                    "literal in the port's tests mentions it; add a "
                    "chaos test or delete the point")


RULES = [transitive_blocking_on_loop, lock_order, lock_held_across_await,
         fault_point_coverage]
