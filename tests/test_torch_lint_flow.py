"""The port's whole-program flow lint held against the reference's:
call-graph blocking reachability, lock-order deadlock detection,
lock-held-across-await, fault-point test coverage, and the call-graph
resolver itself.

Every seeded tree runs through both engines with findings held equal in
rule, package-relative path and line (``test_torch_lint.findings_for``);
the loop seeds live in ``data/api/event_log.py``, an asyncio module of
both packages. The port reads its own tests as the fault-spec oracle
(``tests/test_torch_*.py``, ``tests/torch_*.py``), so the coverage seeds
name their test files that way, and the port-only cases show what that
changes. ``--changed``, ``--profile`` and the run-time budget are
covered on the port's CLI.
"""

from __future__ import annotations

import pathlib
import stat
import subprocess
import textwrap

import pytest

from incubator_predictionio_tpu.tools.lint.callgraph import (
    graph_for as ref_graph_for,
)
from incubator_predictionio_torch.tools.lint import ALL_RULES, run_lint
from incubator_predictionio_torch.tools.lint.callgraph import graph_for
from incubator_predictionio_torch.tools.lint.cli import main as lint_cli
from test_torch_lint import (findings_for, make_project, make_ref_project,
                             port_findings)

pytestmark = pytest.mark.lint

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
LOOP = "data/api/event_log.py"     # an asyncio module in both packages


# ---------------------------------------------------------------------------
# transitive-blocking-on-loop
# ---------------------------------------------------------------------------

def test_seeded_transitive_blocking_chain(tmp_path):
    fs = findings_for(tmp_path, {LOOP: """
        import time
        class EventFront:
            async def handle_create(self, request):
                self._helper()
            def _helper(self):
                self._deeper()
            def _deeper(self):
                time.sleep(1)          # line 9: reached on the loop
            async def handle_direct(self, request):
                time.sleep(1)          # direct: the LEXICAL rule owns it
        """}, ["transitive-blocking-on-loop"])
    assert [(f.line, f.rule) for f in fs] == \
        [(9, "transitive-blocking-on-loop")]
    assert "time.sleep()" in fs[0].message
    assert ("EventFront.handle_create → EventFront._helper → "
            "EventFront._deeper") in fs[0].message


def test_seeded_transitive_blocking_cross_module_alias(tmp_path):
    fs = findings_for(tmp_path, {
        "data/api/util.py": """
            import time
            def slow():
                time.sleep(1)
            """,
        LOOP: """
            from . import util
            from .util import slow as quick
            class EventFront:
                async def handle_a(self, request):
                    util.slow()
                async def handle_b(self, request):
                    quick()
            """,
    }, ["transitive-blocking-on-loop"])
    assert len(fs) == 1
    assert fs[0].path.endswith("util.py") and fs[0].line == 4
    assert "+1 more async entry point(s)" in fs[0].message


@pytest.mark.parametrize("rel,scanned", [
    ("workflow/fleet.py", True), ("common/splice.py", True),
    ("data/api/event_server.py", False)])
def test_seeded_transitive_blocking_scopes_are_the_ports(tmp_path, rel,
                                                         scanned):
    fs = port_findings(tmp_path, {rel: """
        import time
        class Front:
            async def serve(self, reader, writer):
                self._pick()
            def _pick(self):
                time.sleep(0.01)
        """}, ["transitive-blocking-on-loop"])
    assert [f.line for f in fs] == ([7] if scanned else [])


def test_cut_edge_true_negatives(tmp_path):
    fs = findings_for(tmp_path, {LOOP: """
        import asyncio
        import threading
        import time
        class EventFront:
            async def via_to_thread(self, request):
                await asyncio.to_thread(self._w)
            async def via_executor(self, request):
                loop = asyncio.get_running_loop()
                await loop.run_in_executor(None, self._w)
            async def via_thread(self, request):
                t = threading.Thread(target=self._w)
                t.start()
            async def via_submit(self, request):
                return self._pool.submit(self._w)
            def _w(self):
                time.sleep(1)
        """}, ["transitive-blocking-on-loop"])
    assert fs == []


def test_nested_def_called_inline_is_not_exempt(tmp_path):
    fs = findings_for(tmp_path, {LOOP: """
        import time
        class EventFront:
            async def handle(self, request):
                def work():
                    time.sleep(1)      # line 6
                work()                 # called INLINE: on the loop
        """}, ["transitive-blocking-on-loop"])
    assert [(f.line,) for f in fs] == [(6,)]
    assert "<locals>.work" in fs[0].message


def test_unresolvable_calls_are_conservative(tmp_path):
    fs = findings_for(tmp_path, {LOOP: """
        class EventFront:
            async def handle(self, request):
                self.storage.get_l_events().insert_things(1)
                mystery_function()
                (lambda: None)()
        """}, ["transitive-blocking-on-loop"])
    assert fs == []


# ---------------------------------------------------------------------------
# lock-order
# ---------------------------------------------------------------------------

def test_seeded_lock_order_cycle_nested(tmp_path):
    fs = findings_for(tmp_path, {"workflow/helpers.py": """
        import threading
        class Engine:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
            def one(self):
                with self._a:
                    with self._b:
                        pass
            def two(self):
                with self._b:
                    with self._a:
                        pass
        """}, ["lock-order"])
    assert len(fs) == 1
    assert "potential deadlock" in fs[0].message
    assert "Engine._a" in fs[0].message and "Engine._b" in fs[0].message


def test_seeded_lock_order_cycle_cross_function(tmp_path):
    fs = findings_for(tmp_path, {"workflow/helpers.py": """
        import threading
        _a = threading.Lock()
        _b = threading.Lock()
        def outer1():
            with _a:
                inner1()
        def inner1():
            with _b:
                pass
        def outer2():
            with _b:
                inner2()
        def inner2():
            with _a:
                pass
        """}, ["lock-order"])
    assert len(fs) == 1 and "potential deadlock" in fs[0].message


def test_seeded_lock_order_across_the_engine_servers_locks(tmp_path):
    """The port's own shape: the reload lock taken under the lifecycle
    lock in one path and the other way round in another."""
    fs = findings_for(tmp_path, {"workflow/create_server.py": """
        import threading
        class EngineServer:
            def __init__(self):
                self._lock = threading.Lock()
                self._reload_lock = threading.Lock()
            def publish(self):
                with self._reload_lock:
                    self._swap()
            def _swap(self):
                with self._lock:
                    pass
            def rollback(self):
                with self._lock:
                    with self._reload_lock:
                        pass
        """}, ["lock-order"])
    assert len(fs) == 1
    assert "EngineServer._lock" in fs[0].message
    assert "EngineServer._reload_lock" in fs[0].message


def test_seeded_lock_self_reacquire(tmp_path):
    fs = findings_for(tmp_path, {"workflow/helpers.py": """
        import threading
        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
            def take(self):
                with self._lock:
                    self.helper()      # line 8: re-acquires below
            def helper(self):
                with self._lock:
                    pass
        """}, ["lock-order"])
    assert [(f.line,) for f in fs] == [(8,)]
    assert "self-deadlock" in fs[0].message


def test_seeded_lock_lexical_renest(tmp_path):
    fs = findings_for(tmp_path, {"workflow/helpers.py": """
        import threading
        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
            def take(self):
                with self._lock:
                    with self._lock:   # line 8
                        pass
        """}, ["lock-order"])
    assert [(f.line,) for f in fs] == [(8,)]


def test_rlock_reacquire_is_legal(tmp_path):
    fs = findings_for(tmp_path, {"workflow/helpers.py": """
        import threading
        class Engine:
            def __init__(self):
                self._lock = threading.RLock()
            def take(self):
                with self._lock:
                    self.helper()
            def helper(self):
                with self._lock:
                    pass
        """}, ["lock-order"])
    assert fs == []


def test_consistent_order_is_clean(tmp_path):
    fs = findings_for(tmp_path, {"workflow/helpers.py": """
        import threading
        class Engine:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
            def one(self):
                with self._a:
                    with self._b:
                        pass
            def two(self):
                with self._a:
                    with self._b:
                        pass
        """}, ["lock-order"])
    assert fs == []


def test_multi_item_with_acquires_left_to_right(tmp_path):
    fs = findings_for(tmp_path, {"workflow/helpers.py": """
        import threading
        _a = threading.Lock()
        _b = threading.Lock()
        def one():
            with _a, _b:
                pass
        def two():
            with _b:
                with _a:
                    pass
        """}, ["lock-order"])
    assert len(fs) == 1 and "potential deadlock" in fs[0].message


def test_guarded_registry_lock_without_literal_ctor_stays_modest(tmp_path):
    fs = findings_for(tmp_path, {"workflow/create_server.py": """
        import asyncio
        class EngineServer:
            def __init__(self):
                self._lock = self._make_lock()   # ctor unseen
            async def maybe_fine(self):
                with self._lock:
                    await asyncio.sleep(0)       # kind unknown: no claim
            def maybe_reentrant(self):
                with self._lock:
                    self.helper()
            def helper(self):
                with self._lock:
                    pass
        """}, ["lock-order", "lock-held-across-await"])
    assert fs == []


# ---------------------------------------------------------------------------
# lock-held-across-await
# ---------------------------------------------------------------------------

def test_seeded_lock_held_across_await(tmp_path):
    fs = findings_for(tmp_path, {LOOP: """
        import asyncio
        import threading
        class EventFront:
            def __init__(self):
                self._lock = threading.Lock()
                self._alock = asyncio.Lock()
            async def bad(self, request):
                with self._lock:
                    await asyncio.sleep(0)     # line 10
            async def good_async_lock(self, request):
                async with self._alock:
                    await asyncio.sleep(0)
            async def good_release_first(self, request):
                with self._lock:
                    x = 1
                await asyncio.sleep(x)
        """}, ["lock-held-across-await"])
    assert [(f.line, f.rule) for f in fs] == \
        [(10, "lock-held-across-await")]
    assert "EventFront._lock" in fs[0].message
    assert "parks the event loop" in fs[0].message


# ---------------------------------------------------------------------------
# fault-point-coverage
# ---------------------------------------------------------------------------

_CHAOTIC = {"data/api/chaotic.py": """
    from ...common.faultinject import fault_point
    def work():
        fault_point("seed.armed")
        fault_point("seed.unarmed")
    """}


def test_seeded_fault_point_coverage(tmp_path):
    fs = findings_for(tmp_path, _CHAOTIC, ["fault-point-coverage"],
                      tests={"test_torch_chaos.py": """
        def test_armed(monkeypatch):
            monkeypatch.setenv("PIO_FAULT_SPEC", "seed.armed:fail:1")
        """})
    assert len(fs) == 1 and fs[0].line == 5
    assert "'seed.unarmed' is never armed by any test" in fs[0].message


def test_fault_point_coverage_requires_spec_env_in_same_file(tmp_path):
    fs = findings_for(tmp_path, _CHAOTIC, ["fault-point-coverage"],
                      tests={"test_torch_names.py": """
        def test_names():
            assert "seed.armed" != "seed.unarmed"
        """})
    assert sorted(f.message.split()[2] for f in fs) == \
        ["'seed.armed'", "'seed.unarmed'"]


def test_fault_point_coverage_without_tests_dir(tmp_path):
    fs = findings_for(tmp_path, _CHAOTIC, ["fault-point-coverage"])
    assert len(fs) == 2


def test_worker_fault_spec_also_arms(tmp_path):
    fs = findings_for(tmp_path, _CHAOTIC, ["fault-point-coverage"],
                      tests={"torch_worker.py": """
        ENV = {"PIO_EVENT_WORKER_FAULT_SPEC": "seed.armed:crash:1;"
                                              "seed.unarmed:crash:2"}
        """})
    assert fs == []


def test_only_the_ports_tests_arm_its_fault_points(tmp_path):
    """A reference-side test file arms the reference's points, not the
    port's; the replicas' first-launch spec arms points too."""
    fs = port_findings(tmp_path, _CHAOTIC, ["fault-point-coverage"],
                       tests={"test_chaos.py": """
        ENV = {"PIO_FAULT_SPEC": "seed.armed:fail:1"}
        """, "test_torch_fleet.py": """
        ENV = {"PIO_FLEET_WORKER_FAULT_SPEC": "seed.unarmed:crash:1"}
        """})
    assert [f.message.split()[2] for f in fs] == ["'seed.armed'"]


# ---------------------------------------------------------------------------
# call-graph resolver units: both graphs draw the same edges
# ---------------------------------------------------------------------------

def _graphs(tmp_path, files):
    return (graph_for(make_project(tmp_path / "port", files)),
            ref_graph_for(make_ref_project(tmp_path / "ref", files)))


def _edges(graphs, key, cut=False):
    out = []
    for g in graphs:
        node = g.node(key)
        out.append({(e.target, e.cut) if cut else e.target
                    for e in node.edges})
    assert out[0] == out[1], out
    return out[0]


def test_resolver_self_and_base_methods(tmp_path):
    gs = _graphs(tmp_path, {"data/api/x.py": """
        class Base:
            def shared(self):
                pass
        class Child(Base):
            def go(self):
                self.shared()
                self.local()
            def local(self):
                pass
        """})
    assert _edges(gs, "data/api/x.py::Child.go") == {
        "data/api/x.py::Base.shared", "data/api/x.py::Child.local"}


def test_resolver_import_aliasing(tmp_path):
    gs = _graphs(tmp_path, {
        "common/util.py": "def fn():\n    pass\n",
        "data/api/x.py": """
            from ...common import util
            from ...common.util import fn as renamed
            def a():
                util.fn()
            def b():
                renamed()
            def c():
                from ...common import util as lazy
                lazy.fn()
            """,
    })
    want = {"common/util.py::fn"}
    for fn in ("a", "b", "c"):
        assert _edges(gs, f"data/api/x.py::{fn}") == want, fn


def test_resolver_absolute_imports_of_the_package(tmp_path):
    """An absolute import of the package's own name resolves; each
    engine resolves only its own package's name."""
    files = {
        "common/util.py": "def fn():\n    pass\n",
        "data/api/x.py": """
            from incubator_predictionio_torch.common import util
            def a():
                util.fn()
            """,
    }
    port, ref = _graphs(tmp_path, files)
    assert {e.target for e in port.node("data/api/x.py::a").edges} == {
        "common/util.py::fn"}
    assert ref.node("data/api/x.py::a").edges == []


def test_resolver_bare_name_in_method_skips_sibling_methods(tmp_path):
    gs = _graphs(tmp_path, {"data/api/x.py": """
        def helper():
            pass
        class C:
            def helper(self):
                import time
                time.sleep(1)
            def go(self):
                helper()
            def go_self(self):
                self.helper()
        """})
    assert _edges(gs, "data/api/x.py::C.go") == {"data/api/x.py::helper"}
    assert _edges(gs, "data/api/x.py::C.go_self") == {
        "data/api/x.py::C.helper"}


def test_function_local_class_methods_are_not_bare_names(tmp_path):
    fs = findings_for(tmp_path, {LOOP: """
        import time
        def helper():
            return 1
        class EventFront:
            async def handle_create(self, request):
                make_adapter()
        def make_adapter():
            class Adapter:
                def helper(self):
                    time.sleep(1)
            helper()
            return Adapter
        """}, ["transitive-blocking-on-loop"])
    assert fs == []


def test_resolver_circular_reexports_degrade_unresolved(tmp_path):
    gs = _graphs(tmp_path, {
        "data/api/a.py": "from .b import helper\ndef go():\n    helper()\n",
        "data/api/b.py": "from .a import helper\n",
    })
    assert _edges(gs, "data/api/a.py::go") == set()


def test_resolver_nested_class_does_not_alias_outer(tmp_path):
    gs = _graphs(tmp_path, {"data/api/x.py": """
        class Outer:
            def close(self):
                pass
            class Inner:
                def go(self):
                    self.close()
        """})
    assert _edges(gs, "data/api/x.py::Outer.Inner.go") == set()


def test_resolver_unresolvable_draws_no_edge(tmp_path):
    gs = _graphs(tmp_path, {"data/api/x.py": """
        def go(obj):
            obj.method()
            unknown_name()
            a.b.c.deep_chain()
        """})
    assert _edges(gs, "data/api/x.py::go") == set()


def test_resolver_cut_edges_marked(tmp_path):
    gs = _graphs(tmp_path, {"data/api/x.py": """
        import asyncio
        import threading
        def w():
            pass
        async def ship():
            await asyncio.to_thread(w)
            threading.Thread(target=w).start()
        def direct():
            w()
        """})
    assert _edges(gs, "data/api/x.py::ship", cut=True) == {
        ("data/api/x.py::w", True)}
    assert _edges(gs, "data/api/x.py::direct", cut=True) == {
        ("data/api/x.py::w", False)}


def test_graph_is_memoized_per_project(tmp_path):
    p = make_project(tmp_path, {"data/api/x.py": "def f():\n    pass\n"})
    assert graph_for(p) is graph_for(p)


# ---------------------------------------------------------------------------
# repo-level guards: the rules are live on the port's tree
# ---------------------------------------------------------------------------

def test_repo_clean_under_flow_rules():
    from incubator_predictionio_torch.tools.lint import assert_rule_clean

    assert_rule_clean("transitive-blocking-on-loop", "lock-order",
                      "lock-held-across-await", "fault-point-coverage")


def test_every_repo_fault_point_is_armed():
    from incubator_predictionio_torch.tools.lint import lint_repo

    fs = lint_repo(only=["fault-point-coverage"])["findings"]
    assert fs == [], "\n".join(f.render() for f in fs)


def test_the_call_graph_sees_the_ports_threads_and_loops():
    """Non-vacuity of the flow rules on the real tree: the graph holds
    the asyncio modules' coroutines and the threaded servers' locks with
    the ``with`` spans that take them (the lock-order graph over them
    has no edge today: no path nests two of them)."""
    from incubator_predictionio_torch.tools.lint import Project
    from incubator_predictionio_torch.tools.lint.rules_concurrency import (
        _LOOP_SCOPES)

    g = graph_for(Project.from_repo())
    async_rels = {f.relpath for f in g.functions.values() if f.is_async}
    assert set(_LOOP_SCOPES) <= async_rels
    for lock in ("workflow/create_server.py::EngineServer._lock",
                 "workflow/create_server.py::EngineServer._adm_lock",
                 "workflow/create_server.py::EngineServer._reload_lock",
                 "data/api/ingest_buffer.py::IngestBuffer._lock"):
        assert lock in g.locks, lock
    acquired = {lk for f in g.functions.values() for lk, _ in f.acquires}
    assert "workflow/create_server.py::EngineServer._lock" in acquired
    assert "data/api/ingest_buffer.py::IngestBuffer._lock" in acquired


# ---------------------------------------------------------------------------
# --changed incremental mode
# ---------------------------------------------------------------------------

def _git(root, *args):
    subprocess.run(
        ["git", "-C", str(root), "-c", "user.email=pio@test",
         "-c", "user.name=pio", *args],
        check=True, capture_output=True, text=True, timeout=60)


def test_cli_changed_scopes_findings_to_diff(tmp_path, capsys):
    make_project(tmp_path, {"data/api/old.py": """
        import os
        A = os.environ.get("PIO_OLD_KNOB")
        """})
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", "-A")
    _git(tmp_path, "commit", "-qm", "seed")
    new = tmp_path / "incubator_predictionio_torch" / "data" / "api" / "new.py"
    new.write_text('import os\nB = os.environ.get("PIO_NEW_KNOB")\n')
    rc = lint_cli(["--root", str(tmp_path), "--rule", "knob-envknobs",
                   "--changed", "HEAD"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "new.py" in out and "old.py" not in out
    _git(tmp_path, "add", "-A")
    _git(tmp_path, "commit", "-qm", "new knob")
    assert lint_cli(["--root", str(tmp_path), "--rule", "knob-envknobs",
                     "--changed", "HEAD"]) == 0
    assert lint_cli(["--root", str(tmp_path),
                     "--rule", "knob-envknobs"]) == 1
    assert lint_cli(["--root", str(tmp_path), "--changed",
                     "no-such-ref"]) == 2


def test_cli_changed_with_root_below_git_toplevel(tmp_path, capsys):
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "commit", "-q", "--allow-empty", "-m", "seed")
    sub = tmp_path / "sub"
    make_project(sub, {"data/api/knobby.py": """
        import os
        A = os.environ.get("PIO_NEST_KNOB")
        """})
    rc = lint_cli(["--root", str(sub), "--rule", "knob-envknobs",
                   "--changed", "HEAD"])
    out = capsys.readouterr().out
    assert rc == 1 and "knobby.py" in out


def test_precommit_hook_sample_exists_and_points_at_changed():
    hook = REPO / "incubator_predictionio_torch" / "tools" / "lint" \
        / "pre-commit"
    text = hook.read_text()
    assert "--changed HEAD" in text
    assert "incubator_predictionio_torch.tools.lint.cli" in text
    assert hook.stat().st_mode & stat.S_IXUSR, "the sample must be executable"


# ---------------------------------------------------------------------------
# profile + run-time budget
# ---------------------------------------------------------------------------

def test_run_lint_reports_per_rule_timings(tmp_path):
    project = make_project(tmp_path, {"data/api/fine.py": "X = 1\n"})
    result = run_lint(project, ALL_RULES)
    names = [n for n, _ in result["timings"]]
    assert names == result["rules"]
    assert all(secs >= 0 for _, secs in result["timings"])


def test_cli_profile_prints_rule_times(tmp_path, capsys):
    make_project(tmp_path, {"data/api/fine.py": "X = 1\n"})
    assert lint_cli(["--root", str(tmp_path), "--profile"]) == 0
    err = capsys.readouterr().err
    assert "transitive-blocking-on-loop" in err and "ms" in err


def test_whole_repo_lint_stays_inside_budget():
    """All 23 rules over the port: a few seconds on this kind of host; the
    bound leaves room for a loaded host without letting the gate creep
    an order of magnitude. The per-rule timings of the process's one
    memoized full run carry the whole cost (parse, call graph and the
    tests scan are paid inside the first rules that need them)."""
    from incubator_predictionio_torch.tools.lint import lint_repo

    result = lint_repo()
    wall = sum(secs for _, secs in result["timings"])
    assert wall < 15.0, f"pio lint took {wall:.1f}s — budget creep"


def test_lint_reads_no_file_of_the_reference(tmp_path):
    """The port's engine parses the port's package only: a seeded tree
    holding both packages lints the port's modules alone."""
    project = make_project(tmp_path, {"data/api/x.py": "X = 1\n"})
    ref_pkg = tmp_path / "incubator_predictionio_tpu" / "data"
    ref_pkg.mkdir(parents=True)
    (ref_pkg / "y.py").write_text(textwrap.dedent("""
        import os
        A = os.environ.get("PIO_REF_KNOB")
        """))
    result = run_lint(project, ALL_RULES)
    assert result["modules"] == 1 and result["findings"] == []
