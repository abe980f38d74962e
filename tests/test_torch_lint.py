"""The port's ``pio lint`` (``incubator_predictionio_torch/tools/lint/``)
held against the reference's (``incubator_predictionio_tpu/tools/lint/``).

- Every seeded-violation case writes the SAME mini-tree twice, once under
  each package's name, runs both engines, and holds their findings equal
  in rule, package-relative path and line (``findings_for``). The rules
  whose tables were retargeted at the port (the threaded servers' hot
  handlers and dispatch gate, the lock registry, the asyncio loop scopes,
  the port's tests as the fault-spec oracle) get seeded cases on the
  port's layout as well, held to the port's exact findings.
- The port's tree is lint-clean, its suppression inventory can only
  shrink, every table entry a rule names exists in the port (no rule
  passes vacuously), and the seven per-subsystem guards of the
  reference's tests have port-side ``assert_rule_clean`` counterparts.
- ``pio lint`` exits 0/1/2 as the reference's does, and a subprocess
  proves it imports neither torch nor jax.
"""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import incubator_predictionio_torch
from incubator_predictionio_tpu.tools import lint as ref_lint
from incubator_predictionio_torch.tools import lint as pio_lint
from incubator_predictionio_torch.tools.lint import (ALL_RULES, Project,
                                                     run_lint)
from incubator_predictionio_torch.tools.lint import (rules_concurrency,
                                                     rules_confinement)
from incubator_predictionio_torch.tools.lint.cli import main as lint_cli

pytestmark = pytest.mark.lint

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
PKG = pathlib.Path(incubator_predictionio_torch.__file__).parent
PORT_NAME = "incubator_predictionio_torch"
REF_NAME = "incubator_predictionio_tpu"


# ---------------------------------------------------------------------------
# seeded-violation harness: one tree, both engines
# ---------------------------------------------------------------------------

def _write_tree(root, pkg_name, docs_dir, files, docs, tests):
    pkg = root / pkg_name
    for rel, src in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    docs_dir.mkdir(parents=True, exist_ok=True)
    for name, text in (docs or {}).items():
        (docs_dir / name).write_text(textwrap.dedent(text))
    if tests:
        tdir = root / "tests"
        tdir.mkdir(parents=True, exist_ok=True)
        for name, text in tests.items():
            (tdir / name).write_text(textwrap.dedent(text))


def make_project(tmp_path, files: dict, docs: dict | None = None,
                 tests: dict | None = None) -> Project:
    """The port's Project over a seeded tree (its docs inside the
    package, as the port keeps its table)."""
    _write_tree(tmp_path, PORT_NAME, tmp_path / PORT_NAME / "docs", files,
                docs, tests)
    return Project(tmp_path)


def make_ref_project(tmp_path, files: dict, docs: dict | None = None,
                     tests: dict | None = None):
    _write_tree(tmp_path, REF_NAME, tmp_path / "docs", files, docs, tests)
    return ref_lint.Project(tmp_path)


def _rel(path: str) -> str:
    """A finding's path without its package prefix."""
    for name in (PORT_NAME, REF_NAME):
        if path.startswith(name + "/"):
            return path[len(name) + 1:]
    return path


def key(f) -> tuple:
    return (f.rule, _rel(f.path), f.line)


def both(tmp_path, files, rules, docs=None, tests=None):
    """(port findings, reference findings) on the same seeded tree."""
    port = run_lint(make_project(tmp_path / "port", files, docs, tests),
                    ALL_RULES, only=rules)["findings"]
    ref = ref_lint.run_lint(
        make_ref_project(tmp_path / "ref", files, docs, tests),
        ref_lint.ALL_RULES, only=rules)["findings"]
    return port, ref


def findings_for(tmp_path, files, rules, docs=None, tests=None):
    """The port's findings, held equal to the reference's in rule,
    package-relative path and line."""
    port, ref = both(tmp_path, files, rules, docs, tests)
    assert sorted(map(key, port)) == sorted(map(key, ref)), (
        [f.render() for f in port], [f.render() for f in ref])
    return port


def port_findings(tmp_path, files, rules, docs=None, tests=None):
    """The port's findings alone: a tree on the port's layout."""
    return run_lint(make_project(tmp_path, files, docs, tests), ALL_RULES,
                    only=rules)["findings"]


# ---------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------

def test_repo_is_lint_clean():
    """Every rule, the whole package, zero findings."""
    result = pio_lint.lint_repo()
    assert not result["findings"], "\n".join(
        f.render() for f in result["findings"])
    assert len(result["rules"]) == 23
    assert result["rules"] == ref_lint.rule_names()


def test_suppression_inventory_can_only_shrink():
    """The port's inline ``# pio-lint: disable=`` inventory: the two the
    reference keeps, for the same reason. An addition needs a reason in
    the source AND a row here."""
    result = pio_lint.lint_repo()
    inventory = [(s.path, s.line, s.rules, s.reason) for s in
                 result["suppressions"]]
    assert inventory == [
        ("incubator_predictionio_torch/parallel/distributed.py", 119,
         ("knob-envknobs",),
         "identity knob: strict crash beats tolerant world=1"),
        ("incubator_predictionio_torch/parallel/distributed.py", 121,
         ("knob-envknobs",),
         "identity knob: strict crash beats tolerant rank=0"),
    ], inventory
    ref = ref_lint.lint_repo()
    assert [(_rel(s.path), s.rules, s.reason)
            for s in ref["suppressions"]] == [
        (_rel(p), r, why) for p, _line, r, why in inventory]


def _module(rel):
    m = Project.from_repo().module(rel)
    assert m is not None and m.tree is not None, rel
    return m


def _class(rel, name):
    cls = rules_confinement._class(_module(rel), name)
    assert cls is not None, (rel, name)
    return cls


def _defs(node) -> dict:
    return {n.name: n for n in ast.walk(node)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def test_rule_target_modules_exist():
    """Each module a rule's table names is in the port."""
    p = Project.from_repo()
    for rel in ("data/api/event_server.py", "data/api/event_log.py",
                "data/api/ingest_wal.py", "data/api/ingest_buffer.py",
                "data/api/partition_feed.py",
                "workflow/create_server.py", "workflow/model_artifact.py",
                "workflow/multitenant.py", "workflow/fleet.py",
                "workflow/elastic.py", "workflow/soak.py",
                "models/_sharded_serving.py", "ops/sharded_topk.py",
                "parallel/supervisor.py", "data/storage/http_backend.py",
                "common/envknobs.py", "common/faultinject.py",
                "common/telemetry.py", "common/splice.py",
                *rules_confinement._SPAWN_ALLOWED,
                *rules_confinement._WAL_ALLOWED,
                *rules_confinement._SCALE_ALLOWED,
                *rules_concurrency.LOCK_GUARDED,
                *rules_concurrency._LOOP_SCOPES):
        assert p.module(rel) is not None, rel


def test_hot_handlers_and_dispatch_gate_are_the_threaded_servers():
    """The confinement rules' classes and handlers exist as the port has
    them: plain ``def`` handlers of the threaded servers that feed the
    ingest buffer and go through ``_dispatch_query``."""
    es = _defs(_class("data/api/event_server.py", "EventServer"))
    for name in ("handle_create", "handle_batch", "handle_webhook"):
        fn = es[name]
        assert isinstance(fn, ast.FunctionDef), name
        assert any(isinstance(n, ast.Attribute) and n.attr == "ingest"
                   for n in ast.walk(fn)), name
    eng = _defs(_class("workflow/create_server.py", "EngineServer"))
    assert isinstance(eng["handle_query"], ast.FunctionDef)
    assert "_dispatch_query" in eng
    assert any(isinstance(n, ast.Call)
               and rules_confinement._call_name(n) == "_dispatch_query"
               for n in ast.walk(eng["handle_query"]))
    transport = _class("data/storage/http_backend.py", "_Transport")
    assert any(isinstance(n, ast.Attribute) and n.attr == "urlopen"
               for n in ast.walk(transport))
    assert "_resident_lru" in _module("workflow/multitenant.py").source
    assert any(isinstance(n, ast.Call)
               and rules_confinement._call_name(n) == "apply_scale"
               for n in _module("workflow/fleet.py").walk())
    assert "get_model_data_models" in _module(
        "workflow/model_artifact.py").source
    assert "sharded_topk" in _module("models/_sharded_serving.py").source


def test_lock_registry_names_real_locks_and_attributes():
    """Every LOCK_GUARDED entry names a class (or module scope) of the
    port, a lock assigned there, and attributes that are accessed."""
    for rel, entries in rules_concurrency.LOCK_GUARDED.items():
        m = _module(rel)
        for classname, lock, attrs in entries:
            scope = (_class(rel, classname) if classname is not None
                     else m.tree)
            names = set()
            for n in ast.walk(scope):
                if classname is not None and isinstance(n, ast.Attribute) \
                        and isinstance(n.value, ast.Name) \
                        and n.value.id == "self":
                    names.add(n.attr)
                elif classname is None and isinstance(n, ast.Name):
                    names.add(n.id)
            assert lock in names, (rel, classname, lock)
            assert attrs <= names, (rel, classname, attrs - names)
            assert f"{lock} = threading." in m.source, (rel, lock)


def test_every_loop_scope_holds_async_defs():
    """The asyncio modules the loop rules scan each run coroutines, and
    the threaded servers the reference scanned run none."""
    for rel in rules_concurrency._LOOP_SCOPES:
        assert any(isinstance(n, ast.AsyncFunctionDef)
                   for n in _module(rel).walk()), rel
    for rel in ("workflow/create_server.py", "data/api/event_server.py"):
        assert not any(isinstance(n, ast.AsyncFunctionDef)
                       for n in _module(rel).walk()), rel


def test_soak_registries_are_literals_of_the_port():
    from incubator_predictionio_torch.tools.lint import rules_registry

    m = _module("workflow/soak.py")
    assert rules_registry._module_const_strings(m, "SLO_METRICS")
    assert rules_registry._module_const_dict(m, "FAULT_POINTS")
    menu = rules_registry._module_const_strings(m, "FAULT_MENU")
    assert set(rules_registry._module_const_dict(m, "FAULT_POINTS")) <= {
        v for v, _ in menu}


def test_all_rules_in_docs_catalog():
    """The port's operations page lists every active rule."""
    ops = (PKG / "docs" / "operations.md").read_text()
    for rule in ALL_RULES:
        assert f"`{rule.name}`" in ops, rule.name
    assert "`unused-suppression`" in ops and "`parse-error`" in ops


def test_lint_marker_registered():
    assert '"lint: ' in (REPO / "pyproject.toml").read_text()


@pytest.mark.parametrize("rule", [
    "wal-suffix-confinement", "spawn-confinement", "ingest-hot-path",
    "models-dao-confinement", "query-dispatch-gate", "resilient-urlopen",
    "no-adhoc-counters"])
def test_subsystem_guard_is_clean(rule):
    """The port's counterparts of the reference's seven per-subsystem
    guards (test_event_log, test_gang_supervisor, test_ingest_buffer,
    test_model_lifecycle, test_query_overload, test_resilience,
    test_telemetry)."""
    pio_lint.assert_rule_clean(rule)


# ---------------------------------------------------------------------------
# seeded violations: one per rule, both engines
# ---------------------------------------------------------------------------

def test_seeded_ingest_hot_path(tmp_path):
    fs = findings_for(tmp_path, {"data/api/event_server.py": """
        class EventServer:
            async def handle_create(self, request):
                self.storage.get_l_events().insert(1, 2)
            async def handle_batch(self, request):
                await self.ingest.ingest_events([])
            async def handle_webhook(self, request):
                await self.ingest.ingest_events([])
        """}, ["ingest-hot-path"])
    assert len(fs) == 2
    assert any("`.insert(`" in f.message for f in fs)
    assert any("does not feed the ingest buffer" in f.message for f in fs)
    assert fs[0].path.endswith("data/api/event_server.py")


def test_seeded_ingest_hot_path_on_threaded_handlers(tmp_path):
    """The port's layout: the hot handlers are thread ``def``s."""
    fs = port_findings(tmp_path, {"data/api/event_server.py": """
        class EventServer:
            def handle_create(self, handler, path, query, raw):
                self.storage.get_l_events().insert_batch([], 1)
            def handle_batch(self, handler, path, query, raw):
                return self.ingest.ingest_events([], None, None)
            def handle_webhook(self, handler, path, query, raw):
                return self.ingest.ingest_event(None, {}, None, None)
        """}, ["ingest-hot-path"])
    assert sorted((f.line, f.message.split()[0]) for f in fs) == [
        (3, "handle_create"), (4, "handle_create")]
    assert any("`.insert_batch(`" in f.message for f in fs)


def test_seeded_hot_handler_rename_is_caught(tmp_path):
    fs = findings_for(tmp_path, {"data/api/event_server.py": """
        class EventServer:
            async def handle_create(self, request):
                await self.ingest.ingest_events([])
        """}, ["ingest-hot-path"])
    assert sorted(f.message for f in fs) == [
        "hot handler handle_batch not found on EventServer — renaming "
        "it silently drops the guard",
        "hot handler handle_webhook not found on EventServer — renaming "
        "it silently drops the guard"]


def test_seeded_spawn_confinement(tmp_path):
    fs = findings_for(tmp_path, {
        "workflow/helper.py": """
            import subprocess
            def go():
                subprocess.Popen(["x"])
            """,
        "parallel/supervisor.py": """
            import subprocess
            def spawn():
                return subprocess.Popen(["worker"])  # the ONE legal site
            """,
    }, ["spawn-confinement"])
    assert [(f.line, f.rule) for f in fs] == [(4, "spawn-confinement")]
    assert "subprocess.Popen() outside parallel/supervisor.py" \
        in fs[0].message


def test_seeded_resilient_urlopen(tmp_path):
    fs = findings_for(tmp_path, {
        "data/storage/custom.py": """
            import urllib.request
            def fetch(url):
                return urllib.request.urlopen(url)
            """,
        "data/storage/http_backend.py": """
            import urllib.request
            class _Transport:
                def call(self, req):
                    return urllib.request.urlopen(req)  # the legal home
            """,
    }, ["resilient-urlopen"])
    assert [(f.path.endswith("custom.py"), f.line) for f in fs] == [(True, 4)]


def test_seeded_wal_suffix_confinement(tmp_path):
    fs = findings_for(tmp_path, {
        "data/api/sidecar.py": 'SEG = "0001.wal"\n',
        "data/api/ingest_wal.py": 'SEG = "0001.wal"\n',
    }, ["wal-suffix-confinement"])
    assert len(fs) == 1 and fs[0].path.endswith("sidecar.py")
    assert "'0001.wal'" in fs[0].message


def test_seeded_adhoc_counter(tmp_path):
    fs = findings_for(tmp_path, {
        "data/api/thing.py": "EVENT_COUNTS = {}\nOTHER = []\n",
    }, ["no-adhoc-counters"])
    assert [(f.line, "EVENT_COUNTS" in f.message) for f in fs] == [(1, True)]


def test_seeded_models_dao_confinement(tmp_path):
    fs = findings_for(tmp_path, {
        "workflow/sneaky.py": """
            def load(storage):
                return storage.get_model_data_models().get("id")
            """,
        "workflow/model_artifact.py": """
            def read_model(storage):
                return storage.get_model_data_models().get("id")
            """,
    }, ["models-dao-confinement"])
    assert len(fs) == 1 and fs[0].path.endswith("sneaky.py")


def test_seeded_tenant_confinement(tmp_path):
    fs = findings_for(tmp_path, {
        "workflow/sneaky.py": """
            def peek(server):
                return server._tenants._resident_lru.popitem()
            """,
        "workflow/multitenant.py": """
            import collections
            class TenantMux:
                def __init__(self):
                    self._resident_lru = collections.OrderedDict()
                def _evict_victim(self):
                    return None
            """,
    }, ["tenant-confinement"])
    assert len(fs) == 1 and fs[0].path.endswith("sneaky.py")
    assert "_resident_lru outside workflow/multitenant.py" in fs[0].message


def test_seeded_tenant_chokepoint_rename_is_caught(tmp_path):
    fs = findings_for(tmp_path, {
        "workflow/multitenant.py": """
            class TenantMux:
                def __init__(self):
                    self._lru = {}
            """,
    }, ["tenant-confinement"])
    assert len(fs) == 1
    assert "chokepoint" in fs[0].message and "renamed?" in fs[0].message


def test_seeded_query_dispatch_gate(tmp_path):
    fs = findings_for(tmp_path, {"workflow/create_server.py": """
        import asyncio
        class EngineServer:
            async def handle_query(self, request):
                return await asyncio.to_thread(self.deployment.query, {})
        """}, ["query-dispatch-gate"])
    msgs = sorted(f.message for f in fs)
    assert len(fs) == 2
    assert "no longer routes through _dispatch_query" in msgs[0]
    assert "ships query compute to to_thread() directly" in msgs[1]


def test_seeded_query_dispatch_gate_on_threaded_handlers(tmp_path):
    """The port's layout: handle_query is a thread ``def`` that must route
    through ``_dispatch_query``; a sibling handler submitting query
    compute to the executor directly is a finding."""
    files = {"workflow/create_server.py": """
        class EngineServer:
            def handle_query(self, request):
                return self._dispatch_query(self.deployment, {}, None)
            def handle_batch(self, request):
                return self._query_executor.submit(
                    self.deployment.batch_query, [])
            def _dispatch_query(self, deployment, query, dl):
                return self._query_executor.submit(deployment.query, query)
        """}
    fs = port_findings(tmp_path, files, ["query-dispatch-gate"])
    assert [(f.line, "handle_batch ships query compute to submit()"
             in f.message) for f in fs] == [(6, True)]
    ungated = {"workflow/create_server.py": files[
        "workflow/create_server.py"].replace(
        "return self._dispatch_query(self.deployment, {}, None)",
        "return self.deployment.query({})")}
    fs = port_findings(tmp_path / "ungated", ungated,
                       ["query-dispatch-gate"])
    assert any("no longer routes through _dispatch_query" in f.message
               for f in fs)


def _engine_server_seed(body: str) -> str:
    """An EngineServer that builds every attribute both lock registries
    name (so neither engine reports a stale entry), then ``body``."""
    return textwrap.dedent("""
        import threading
        class EngineServer:
            def __init__(self):
                self._lock = threading.Lock()
                self._adm_lock = threading.Lock()
                self._pinned = {}
                self._pins_provisional = set()
                self._previous = None
                self._rollbacks = {}
                self._swap_count = 0
                self._validate_failures = 0
                self._refresh_swaps = 0
                self._chain = []
                self._chain_since = 0.0
                self._adm_pending = 0
                self._adm_peak = 0
                self._shed_count = 0
                self._deadline_count = 0
                self._orphaned = 0
                self._draining = False
                self._drain_stragglers = 0
                self._unanswered = 0
                self._reload_conflicts = 0
        """) + textwrap.indent(textwrap.dedent(body), "    ")


def _line_of(src: str, needle: str) -> int:
    return next(i for i, ln in enumerate(src.splitlines(), 1)
                if needle in ln)


def test_seeded_lock_discipline(tmp_path):
    src = _engine_server_seed("""
        def good(self):
            with self._lock:
                return dict(self._pinned)
        def bad(self):
            self._pinned["x"] = "y"
        def wrong_lock(self):
            with self._adm_lock:
                self._pinned.pop("x")
        def chain_outside(self):
            return list(self._chain)
        """)
    fs = port_findings(tmp_path / "port",
                       {"workflow/create_server.py": src},
                       ["lock-discipline"])
    assert [(f.line, f.message.split()[0]) for f in fs] == [
        (_line_of(src, 'self._pinned["x"] = "y"'), "self._pinned"),
        (_line_of(src, 'self._pinned.pop("x")'), "self._pinned"),
        (_line_of(src, "list(self._chain)"), "self._chain")]
    assert "self._pinned accessed outside `with self._lock:` in bad()" \
        in fs[0].message
    # the reference flags the same unguarded accesses of the attributes
    # both registries share (its registry predates the swap chain)
    ref = ref_lint.run_lint(
        make_ref_project(tmp_path / "ref", {"workflow/create_server.py":
                                            src}),
        ref_lint.ALL_RULES, only=["lock-discipline"])["findings"]
    assert [key(f) for f in ref] == [key(f) for f in fs[:2]]


def test_seeded_lock_discipline_stale_registry_entry(tmp_path):
    """A registry entry for an attribute the class no longer has is a
    stale contract, reported rather than silently guarding nothing."""
    fs = port_findings(tmp_path, {"data/api/ingest_buffer.py": """
        import threading
        class IngestBuffer:
            def __init__(self):
                self._lock = threading.Lock()
        """}, ["lock-discipline"])
    assert [(f.line, "stale registry entry" in f.message) for f in fs] == [
        (1, True)]


def test_seeded_lock_discipline_sees_lambda_bodies(tmp_path):
    """A lambda cannot take the lock itself, so a guarded access inside
    one is a finding even where its definition holds the lock."""
    src = _engine_server_seed("""
        def collectors(self):
            with self._adm_lock:
                return [lambda: self._adm_pending + 1]
        """)
    fs = findings_for(tmp_path, {"workflow/create_server.py": src},
                      ["lock-discipline"])
    assert [(f.line,) for f in fs] == [(_line_of(src, "lambda:"),)]


def test_seeded_lock_discipline_module_scope(tmp_path):
    fs = findings_for(tmp_path, {"parallel/supervisor.py": """
        import threading
        _hb_lock = threading.Lock()
        _hb_last = 0.0
        _hb_interval = None
        def beat():
            global _hb_last
            with _hb_lock:
                _hb_last = 1.0    # guarded: fine
        def peek():
            return _hb_last       # line 11: unguarded module global
        """}, ["lock-discipline"])
    unguarded = [f for f in fs if "accessed outside" in f.message]
    assert [(f.line,) for f in unguarded] == [(11,)]
    assert "_hb_last accessed outside `with _hb_lock:` in peek()" \
        in unguarded[0].message


_BLOCKING_SEED = """
    import os
    import time
    class Front:
        async def handle(self, request):
            time.sleep(0.1)            # line 6
            names = os.listdir("/x")   # line 7
            with open("f") as fh:      # line 8
                return fh.read()
        async def fine(self):
            def blocking_is_shipped_off_loop():
                time.sleep(1)          # nested sync def: exempt
            return blocking_is_shipped_off_loop
        def sync_ok(self):
            time.sleep(0.1)            # not async: out of scope
    """


def test_seeded_blocking_on_loop(tmp_path):
    """data/api/event_log.py is an asyncio module for both engines."""
    fs = findings_for(tmp_path, {"data/api/event_log.py": _BLOCKING_SEED},
                      ["no-blocking-on-loop"])
    assert sorted(f.line for f in fs) == [6, 7, 8]
    assert all("inside async handle()" in f.message for f in fs)


@pytest.mark.parametrize("rel,scanned", [
    ("common/splice.py", True), ("workflow/fleet.py", True),
    ("workflow/elastic.py", True), ("data/api/event_server.py", False),
    ("workflow/create_server.py", False)])
def test_seeded_blocking_on_loop_scopes_are_the_ports(tmp_path, rel,
                                                      scanned):
    """The port's loop scopes: its asyncio modules, not its threaded
    engine and event servers."""
    fs = port_findings(tmp_path, {rel: _BLOCKING_SEED},
                       ["no-blocking-on-loop"])
    assert sorted(f.line for f in fs) == ([6, 7, 8] if scanned else [])


def test_seeded_knob_envknobs_and_suppression(tmp_path):
    files = {"data/api/knobby.py": """
        import os
        A = os.environ.get("PIO_SEEDED_KNOB")
        B = os.getenv("PIO_SEEDED_KNOB", "x")
        C = os.environ["PIO_SEEDED_KNOB"]
        D = os.environ.get("NOT_A_KNOB")
        """}
    fs = findings_for(tmp_path, files, ["knob-envknobs"])
    assert sorted(f.line for f in fs) == [3, 4, 5]
    files["data/api/knobby.py"] = files["data/api/knobby.py"].replace(
        'A = os.environ.get("PIO_SEEDED_KNOB")',
        'A = os.environ.get("PIO_SEEDED_KNOB")'
        "  # pio-lint: disable=knob-envknobs -- seeded exception")
    project = make_project(tmp_path / "sup", files)
    result = run_lint(project, ALL_RULES, only=["knob-envknobs"])
    assert sorted(f.line for f in result["findings"]) == [4, 5]
    assert result["suppressed"] == 1


def test_seeded_knob_docs_sync_both_directions(tmp_path):
    docs = {"operations.md": """
        | Env | Default | Meaning |
        |---|---|---|
        | `PIO_SEEDED_DOCUMENTED` | 1 | real |
        | `PIO_SEEDED_DEAD_ROW` | 1 | gone from code |
        """}
    fs = findings_for(tmp_path, {"data/api/knobby.py": """
        from ...common.envknobs import env_int
        A = env_int("PIO_SEEDED_DOCUMENTED", 1)
        B = env_int("PIO_SEEDED_UNDOCUMENTED", 2)
        """}, ["knob-docs-sync"], docs=docs)
    assert len(fs) == 2
    undocumented = next(f for f in fs if "PIO_SEEDED_UNDOCUMENTED"
                        in f.message)
    assert undocumented.line == 4 and "no row" in undocumented.message
    dead = next(f for f in fs if "PIO_SEEDED_DEAD_ROW" in f.message)
    assert dead.path == f"{PORT_NAME}/docs/operations.md"
    assert dead.line == 5 and "delete the dead row" in dead.message


def test_knob_table_oracle_is_the_ports_own_python(tmp_path):
    """A row stays live while the port's tests or card script name the
    knob; the reference's tests do not keep a port row alive."""
    docs = {"operations.md": "| `PIO_SEEDED_TESTONLY` | 1 | x |\n"
                             "| `PIO_SEEDED_REFONLY` | 1 | y |\n"
                             "| `PIO_SEEDED_CARD` | 1 | z |\n"}
    tests = {"torch_helper.py": 'X = "PIO_SEEDED_TESTONLY"\n',
             "test_reference_side.py": 'Y = "PIO_SEEDED_REFONLY"\n'}
    project = make_project(tmp_path, {"data/api/x.py": "X = 1\n"}, docs,
                           tests)
    (tmp_path / "chip_smoke.py").write_text('Z = "PIO_SEEDED_CARD"\n')
    fs = run_lint(project, ALL_RULES, only=["knob-docs-sync"])["findings"]
    assert [(f.line, "PIO_SEEDED_REFONLY" in f.message) for f in fs] == [
        (2, True)]


def test_seeded_fault_point_registry(tmp_path):
    docs = {"operations.md": "Points: `seeded.documented` exists.\n"}
    fs = findings_for(tmp_path, {"data/api/chaotic.py": """
        from ...common.faultinject import fault_point
        def work(name):
            fault_point("seeded.documented")
            fault_point("seeded.undocumented")
            fault_point("BadConvention")
            fault_point(name)     # variable: out of static reach
        """}, ["fault-point-registry"], docs=docs)
    assert sorted((f.line, f.message.split()[2]) for f in fs) == [
        (5, "'seeded.undocumented'"), (6, "'BadConvention'")]
    assert any("naming convention" in f.message for f in fs)


def test_seeded_metric_name_registry(tmp_path):
    docs = {"operations.md": "| `pio_seeded_documented_total` | counter |\n"}
    fs = findings_for(tmp_path, {"common/metricky.py": """
        import contextvars
        from . import telemetry
        A = telemetry.registry().counter(
            "pio_seeded_documented_total", "fine")
        B = telemetry.registry().counter(
            "pio_seeded_bad_counter", "no _total suffix")
        V = contextvars.ContextVar("pio_seeded_ctxvar", default=None)
        """}, ["metric-name-registry"], docs=docs)
    msgs = sorted(f.message for f in fs)
    assert len(fs) == 2
    assert "must end in _total" in msgs[0]
    assert "'pio_seeded_bad_counter' is not documented" in msgs[1]
    assert not any("pio_seeded_ctxvar" in m for m in msgs)


def test_seeded_tier_literal_confinement(tmp_path):
    fs = findings_for(tmp_path, {
        "data/storage/side.py":
            'TIER = "retired"\nNS = "pio_eventlog_archive"\n',
        "data/api/event_log.py":
            'RETIRED_DIR = "retired"\n'
            'ARCHIVE_NAMESPACE = "pio_eventlog_archive"\n',
        "data/storage/prose.py":
            '"""Rows from a generation retired last week."""\nX = 1\n',
    }, ["wal-suffix-confinement"])
    assert sorted((f.path.endswith("side.py"), f.line) for f in fs) == \
        [(True, 1), (True, 2)]
    assert all("retention-tier artifact name" in f.message for f in fs)


def test_seeded_window_metric_family_registry(tmp_path):
    docs = {"operations.md":
            "| `pio_train_window_generations_skipped_total` | counter "
            "|\n"}
    fs = findings_for(tmp_path, {"common/winmetrics.py": """
        from . import telemetry
        A = telemetry.registry().counter(
            "pio_train_window_generations_skipped_total", "documented")
        B = telemetry.registry().counter(
            "pio_train_window_rows_filtered_total", "not in the docs")
        """}, ["metric-name-registry"], docs=docs)
    assert len(fs) == 1
    assert "'pio_train_window_rows_filtered_total' is not documented" \
        in fs[0].message


def test_seeded_parse_error_is_a_finding(tmp_path):
    files = {"data/api/broken.py": "def f(:\n"}
    port = run_lint(make_project(tmp_path / "p", files), ALL_RULES)
    ref = ref_lint.run_lint(make_ref_project(tmp_path / "r", files),
                            ref_lint.ALL_RULES)
    pe = [f for f in port["findings"] if f.rule == "parse-error"]
    assert len(pe) == 1 and pe[0].path.endswith("broken.py")
    assert [key(f) for f in pe] == [
        key(f) for f in ref["findings"] if f.rule == "parse-error"]


def test_unused_suppression_is_a_finding(tmp_path):
    files = {"data/api/clean.py": """
        X = 1  # pio-lint: disable=knob-envknobs -- nothing here anymore
        Y = 2  # pio-lint: disable=not-a-rule -- typo'd name
        """}
    result = run_lint(make_project(tmp_path / "p", files), ALL_RULES)
    ref = ref_lint.run_lint(make_ref_project(tmp_path / "r", files),
                            ref_lint.ALL_RULES)
    unused = sorted(f.message for f in result["findings"]
                    if f.rule == "unused-suppression")
    assert len(unused) == 2
    assert "'knob-envknobs' is unused (nothing to suppress here)" \
        in unused[0]
    assert "'not-a-rule' is unused (unknown rule)" in unused[1]
    assert sorted(map(key, result["findings"])) == sorted(
        map(key, ref["findings"]))
    restricted = run_lint(make_project(tmp_path / "r2", {
        "data/api/clean.py": "X = 1  # pio-lint: disable=knob-envknobs\n"}),
        ALL_RULES, only=["knob-envknobs"])
    assert restricted["findings"] == []


def test_unknown_rule_name_raises():
    with pytest.raises(ValueError, match="unknown rule"):
        run_lint(Project.from_repo(), ALL_RULES, only=["no-such-rule"])


# ---------------------------------------------------------------------------
# the rules keep their teeth on the port's real modules
# ---------------------------------------------------------------------------

def test_migration_kept_coverage_on_real_event_server(tmp_path):
    """A direct DAO insert added to the REAL threaded handle_create is
    flagged at its line."""
    src = (PKG / "data" / "api" / "event_server.py").read_text()
    cls = next(n for n in ast.walk(ast.parse(src))
               if isinstance(n, ast.ClassDef) and n.name == "EventServer")
    fn = _defs(cls)["handle_create"]
    insert_at = fn.body[0].lineno - 1
    indent = " " * fn.body[0].col_offset
    lines = src.splitlines()
    lines.insert(insert_at,
                 f"{indent}self.storage.get_l_events().insert(None, 0)")
    fs = port_findings(tmp_path, {"data/api/event_server.py":
                                  "\n".join(lines) + "\n"},
                       ["ingest-hot-path"])
    assert [(f.line, "`.insert(`" in f.message) for f in fs] == [
        (insert_at + 1, True)]


def test_migration_kept_coverage_on_real_create_server(tmp_path):
    """An unguarded ``self._pinned`` or ``self._chain`` write added to the
    real create_server.py fails lock-discipline."""
    src = (PKG / "workflow" / "create_server.py").read_text()
    marker = "    def overload_snapshot(self) -> dict:"
    assert marker in src
    violated = src.replace(marker, (
        "    def sneak_a_pin(self):\n"
        "        self._pinned['x'] = 'race'\n"
        "        self._chain.append('x')\n\n" + marker), 1)
    fs = port_findings(tmp_path, {"workflow/create_server.py": violated},
                       ["lock-discipline"])
    flagged = [f for f in fs if "sneak_a_pin" in f.message]
    assert [f.message.split()[0] for f in flagged] == [
        "self._pinned", "self._chain"]
    assert all("outside `with self._lock:`" in f.message for f in flagged)


# ---------------------------------------------------------------------------
# the defects the rules guard against, on the port's classes
# ---------------------------------------------------------------------------

def test_lease_verify_after_release_fences_cleanly(tmp_path):
    from incubator_predictionio_torch.data.api import event_log

    lease = event_log.claim_partition(str(tmp_path), 0)
    lease.verify()
    lease.release()
    with pytest.raises(event_log.PartitionFencedError):
        lease.verify()
    lease.release()             # idempotent


def _hammer(workers, seconds=0.4):
    stop = threading.Event()
    errors = []

    def run(fn):
        try:
            while not stop.is_set():
                fn()
        except Exception as e:  # noqa: BLE001 - the assertion
            errors.append(e)

    threads = [threading.Thread(target=run, args=(w,)) for w in workers]
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join()
    return errors


def test_ingest_shed_map_is_thread_safe():
    """Committer threads flip a key's shed mode while handler threads
    admit and snapshot: every access holds ``_lock`` (lint-enforced)."""
    from incubator_predictionio_torch.data.api.ingest_buffer import (
        AppendShedError, IngestBuffer, IngestConfig)

    buf = IngestBuffer(None, None, None, config=IngestConfig())

    def noter(i):
        k = (i % 4, None)
        return lambda: (buf._note_append_error(k, "faulted"),
                        buf._note_append_ok(k))

    def admitter():
        with buf._lock:
            try:
                buf._admit(1, buf._shed.get((0, None)))
            except AppendShedError:
                pass

    errors = _hammer([noter(i) for i in range(4)]
                     + [buf.snapshot, buf.snapshot, admitter])
    assert not errors, errors
    assert buf.snapshot().get("shedding", 0) <= 4


def test_admission_counters_exact_under_contention():
    from incubator_predictionio_torch.workflow.create_server import (
        AdmissionShed, EngineServer)

    s = EngineServer.__new__(EngineServer)
    s.engine = object()       # a store-backed server (not the file form)
    s._init_overload_state(query_conc=4, query_max_pending=8)
    shed = []

    def churn():
        for _ in range(2000):
            try:
                s._admit()
            except AdmissionShed:
                shed.append(1)
            else:
                s._release_slot()

    threads = [threading.Thread(target=churn) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = s.overload_snapshot()
    assert snap["pending"] == 0
    assert 0 < snap["peakPending"] <= 12
    s._query_executor.shutdown(wait=False)


def test_event_server_shed_count_is_read_under_its_lock():
    from incubator_predictionio_torch.data.api.event_server import (
        EventServer)

    es = EventServer.__new__(EventServer)
    es.shed_count = 0
    es._shed_lock = threading.Lock()
    errors = _hammer([es.count_shed] * 4)
    assert not errors
    with es._shed_lock:
        assert es.shed_count > 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_rc1_and_json_on_seeded_violation(tmp_path, capsys):
    make_project(tmp_path, {"data/api/knobby.py": """
        import os
        A = os.environ.get("PIO_SEEDED_KNOB")
        """})
    rc = lint_cli(["--root", str(tmp_path), "--rule", "knob-envknobs",
                   "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["clean"] is False
    assert doc["findings"][0]["rule"] == "knob-envknobs"
    assert doc["findings"][0]["line"] == 3
    assert doc["findings"][0]["path"] == \
        f"{PORT_NAME}/data/api/knobby.py"


def test_cli_clean_rc0_and_filters(tmp_path, capsys):
    make_project(tmp_path, {"data/api/fine.py": "X = 1\n"})
    assert lint_cli(["--root", str(tmp_path)]) == 0
    assert lint_cli(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "lock-discipline" in out and "knob-envknobs" in out
    assert len([ln for ln in out.splitlines() if ln.strip()]) == 23
    assert lint_cli(["--rule", "definitely-not-a-rule"]) == 2
    assert lint_cli(["--rule", ","]) == 2


def test_console_lint_verb_imports_neither_torch_nor_jax():
    """``pio lint`` is a parse pass: the console dispatches it before
    anything that could import torch. One full run (the flow rules'
    call graph and the tests scan included, and --profile) in a fresh
    process, whose modules are then inspected."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import json, sys\n"
         "from incubator_predictionio_torch.tools.console import main\n"
         "rc = main(['lint', '--profile'])\n"
         "print(json.dumps({'rc': rc, 'mods': sorted(m for m in "
         "sys.modules if m.split('.')[0] in ('torch', 'jax', 'jaxlib', "
         "'incubator_predictionio_tpu'))}))\n"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc == {"rc": 0, "mods": []}, doc
    assert "transitive-blocking-on-loop" in r.stderr
    assert "fault-point-coverage" in r.stderr


def test_lint_verb_is_registered():
    from incubator_predictionio_torch.tools import commands

    assert "lint" in commands._MODULES
    assert "  lint " in commands.usage()


# ---------------------------------------------------------------------------
# soak registry rules
# ---------------------------------------------------------------------------

def test_soak_slo_registry_seeded_violations(tmp_path):
    files = {"workflow/soak.py": '''
        SLO_METRICS = (
            "pio_documented_total",
            "pio_ghost_family_total",
            "BadName_total",
        )
        FAULT_POINTS = {}
    '''}
    docs = {"operations.md": "| `pio_documented_total` | counts |\n"}
    fs = findings_for(tmp_path / "a", files, ["soak-slo-registry"], docs)
    msgs = [f.message for f in fs]
    assert len(fs) == 2, msgs
    assert any("pio_ghost_family_total" in m for m in msgs)
    assert any("BadName_total" in m and "naming convention" in m
               for m in msgs)
    fs = findings_for(tmp_path / "renamed",
                      {"workflow/soak.py": "OTHER = 1\n"},
                      ["soak-slo-registry"], docs)
    assert len(fs) == 1 and "SLO_METRICS" in fs[0].message
    assert findings_for(tmp_path / "nosoak",
                        {"workflow/other.py": "X = 1\n"},
                        ["soak-slo-registry"], docs) == []


def test_soak_fault_registry_seeded_violations(tmp_path):
    files = {
        "workflow/soak.py": '''
            SLO_METRICS = ()
            FAULT_POINTS = {
                "worker_kill": "ingest.commit",
                "ghost_fault": "nobody.arms",
            }
        ''',
        "data/api/thing.py": '''
            from ...common import faultinject

            def commit():
                faultinject.fault_point("ingest.commit")
        ''',
    }
    fs = findings_for(tmp_path / "a", files, ["soak-fault-registry"])
    assert len(fs) == 1
    assert "ghost_fault" in fs[0].message and "nobody.arms" in fs[0].message
    fs = findings_for(tmp_path / "renamed",
                      {"workflow/soak.py": "SLO_METRICS = ()\n"},
                      ["soak-fault-registry"])
    assert len(fs) == 1 and "FAULT_POINTS" in fs[0].message


def test_soak_fault_registry_holds_points_to_the_menu(tmp_path):
    """The port reads FAULT_MENU too: a spec fault the menu cannot
    schedule is a finding (a tree without FAULT_MENU keeps the
    reference's result)."""
    fs = port_findings(tmp_path, {
        "workflow/soak.py": '''
            SLO_METRICS = ()
            FAULT_POINTS = {
                "worker_kill": "ingest.commit",
                "orphan": "ingest.commit",
            }
            FAULT_MENU = ("worker_kill",)
        ''',
        "data/api/thing.py": '''
            from ...common import faultinject

            def commit():
                faultinject.fault_point("ingest.commit")
        '''}, ["soak-fault-registry"])
    assert [(f.line, "'orphan'" in f.message and "FAULT_MENU" in f.message)
            for f in fs] == [(5, True)]


def test_seeded_quality_metric_family_coverage(tmp_path):
    src = """
        from . import telemetry
        B = telemetry.registry().counter(
            "pio_engine_quality_breaches_total", "breach verdicts")
        M = telemetry.registry().gauge(
            "pio_engine_quality_metric", "live quality", ("metric",))
        """
    fs = findings_for(tmp_path / "red", {"common/qualmetrics.py": src},
                      ["metric-name-registry"],
                      docs={"operations.md": "no rows here\n"})
    assert len(fs) == 2
    assert all("is not documented" in f.message for f in fs)
    assert findings_for(
        tmp_path / "docd", {"common/qualmetrics.py": src},
        ["metric-name-registry"],
        docs={"operations.md":
              "| `pio_engine_quality_breaches_total` | counter |\n"
              "| `pio_engine_quality_metric` | gauge |\n"}) == []


def test_seeded_quality_slo_row_coverage(tmp_path):
    files = {"workflow/soak.py": '''
        SLO_METRICS = (
            "pio_engine_quality_samples_total",
            "pio_engine_quality_breaches_total",
        )
        FAULT_POINTS = {}
    '''}
    assert findings_for(
        tmp_path / "green", files, ["soak-slo-registry"],
        {"operations.md":
         "| `pio_engine_quality_samples_total` | counter |\n"
         "| `pio_engine_quality_breaches_total` | counter |\n"}) == []
    fs = findings_for(
        tmp_path / "red", files, ["soak-slo-registry"],
        {"operations.md":
         "| `pio_engine_quality_samples_total` | counter |\n"})
    assert len(fs) == 1
    assert "pio_engine_quality_breaches_total" in fs[0].message


def test_seeded_train_feed_confinement(tmp_path):
    src = '''
        def read(store, app):
            scan = store._merged_scan(app, None, [])
            for b in store.find_batches(app):
                pass
            return scan
    '''
    fs = findings_for(tmp_path / "wf", {"workflow/rogue_read.py": src},
                      ["train-feed-confinement"])
    assert len(fs) == 2
    shard_src = '''
        from ..data.storage.jsonl import scan_log_file, shard_paths

        def feed(d, app):
            return [scan_log_file(p) for p in shard_paths(d, app)]
    '''
    fs = findings_for(tmp_path / "ops", {"ops/rogue_feed.py": shard_src},
                      ["train-feed-confinement"])
    assert {m for f in fs for m in ("shard_paths", "scan_log_file")
            if m in f.message} == {"shard_paths", "scan_log_file"}
    assert findings_for(
        tmp_path / "api", {"data/api/partition_feed.py": shard_src},
        ["train-feed-confinement"]) == []


def test_spawn_confinement_still_fires_outside_the_soak_driver(tmp_path):
    src = '''
        import subprocess

        def launch():
            subprocess.Popen(["x"])
    '''
    fs = findings_for(tmp_path / "rogue", {"workflow/rogue.py": src},
                      ["spawn-confinement"])
    assert len(fs) == 1 and "rogue" in fs[0].path
    assert findings_for(tmp_path / "driver", {"workflow/soak.py": src},
                        ["spawn-confinement"]) == []


def test_seeded_sharded_topk_confinement(tmp_path):
    rogue = '''
        from ..ops.sharded_topk import host_sharded_top_k_items
        from ..ops import sharded_topk

        def score(vec, cat, k):
            sharded_topk.put_host_sharded_catalog(cat, 64)
            return host_sharded_top_k_items(vec, cat, k)
    '''
    fs = findings_for(tmp_path / "a", {"models/rogue_template.py": rogue},
                      ["sharded-topk-confinement"])
    assert len(fs) == 3
    assert all("_sharded_serving facade" in f.message for f in fs)
    assert findings_for(
        tmp_path / "facade", {"models/_sharded_serving.py": rogue},
        ["sharded-topk-confinement"]) == []
    assert findings_for(
        tmp_path / "ops", {"ops/other_kernels.py": rogue},
        ["sharded-topk-confinement"]) == []


def test_seeded_query_cache_metric_family_coverage(tmp_path):
    src = """
        from . import telemetry
        H = telemetry.registry().counter(
            "pio_query_cache_hits_total", "cache hits")
        I = telemetry.registry().counter(
            "pio_query_cache_invalidations_total", "by trigger",
            ("reason",))
        B = telemetry.registry().counter(
            "pio_query_cache_evictions", "no _total suffix")
        """
    docs = {"operations.md":
            "| `pio_query_cache_hits_total` | counter |\n"
            "| `pio_query_cache_invalidations_total` | counter |\n"}
    fs = findings_for(tmp_path / "a", {"common/cachemetrics.py": src},
                      ["metric-name-registry"], docs=docs)
    assert len(fs) == 2
    assert any("must end in _total" in f.message for f in fs)


def test_seeded_scale_directive_confinement(tmp_path):
    files = {
        "workflow/fleet.py": """
            def tick(coord):
                coord.apply_scale(3)
            """,
        "workflow/rogue.py": """
            def bump(sup):
                sup.add_worker()
            """,
        "data/api/event_log.py": """
            def rescale(sup):
                sup.retire_worker(1)
            """,
    }
    fs = findings_for(tmp_path, files, ["scale-directive-confinement"])
    assert [(f.path.endswith("rogue.py"), f.line) for f in fs] == [(True, 3)]
