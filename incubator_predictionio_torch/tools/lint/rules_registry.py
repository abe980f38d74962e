"""Registry-sync rules: knobs, fault points and metric names must
match convention AND the port's operator table — both directions.

The port's copy of the reference's ``tools/lint/rules_registry.py``. The
operator surface (``PIO_*`` env knobs, ``faultinject`` point names,
``pio_*`` telemetry families) is documented in the package's own
``docs/operations.md``; these rules fail lint whenever code and table
drift, so "update the knob table" stops being a review-time memory
test. In untyped Python the lint pass is the compiler's contract check
that the upstream project got from Scala's compiler."""

from __future__ import annotations

import ast
import re
from typing import Iterable, Optional

from .engine import Finding, Module, Project, rule

__all__ = ["RULES"]

_PIO_KNOB = re.compile(r"^PIO_[A-Z0-9_]+$")
_DOC_KNOB_ROW = re.compile(r"^\|(?P<cell>[^|]*`PIO_[A-Z0-9_]+`[^|]*)\|")
_DOC_KNOB_NAME = re.compile(r"`(PIO_[A-Z0-9_]+)`")
_FAULT_POINT = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")
_METRIC = re.compile(r"^pio_[a-z][a-z0-9_]*$")

_ENV_FNS = ("env_int", "env_float", "env_ms", "env_flag", "env_str")

# the linter's own sources mention the very patterns it hunts
_SELF = "tools/lint/"


def _skip(m: Module) -> bool:
    return m.tree is None or m.relpath.startswith(_SELF)


def _env_read(node: ast.AST) -> Optional[tuple[str, int]]:
    """(knob, line) when ``node`` reads a PIO_* env var directly:
    ``os.environ.get("PIO_X")``, ``os.getenv("PIO_X")`` or
    ``os.environ["PIO_X"]`` (load context). Dynamic names (f-strings,
    ``PIO_STORAGE_SOURCES_%s``-style config families, reads through a
    variable) are invisible to static analysis and out of scope."""
    if isinstance(node, ast.Call):
        f = node.func
        lit = (node.args[0].value
               if node.args and isinstance(node.args[0], ast.Constant)
               and isinstance(node.args[0].value, str) else None)
        if lit is None or not _PIO_KNOB.match(lit):
            return None
        if isinstance(f, ast.Attribute) and f.attr == "get" \
                and isinstance(f.value, ast.Attribute) \
                and f.value.attr == "environ" \
                and isinstance(f.value.value, ast.Name):
            return lit, node.lineno
        if isinstance(f, ast.Attribute) and f.attr == "getenv" \
                and isinstance(f.value, ast.Name):
            return lit, node.lineno
    if isinstance(node, ast.Subscript) \
            and isinstance(node.ctx, ast.Load) \
            and isinstance(node.value, ast.Attribute) \
            and node.value.attr == "environ" \
            and isinstance(node.slice, ast.Constant) \
            and isinstance(node.slice.value, str) \
            and _PIO_KNOB.match(node.slice.value):
        return node.slice.value, node.lineno
    return None


def _envknobs_read(node: ast.AST) -> Optional[tuple[str, int]]:
    """(knob, line) when ``node`` parses a PIO_* knob via envknobs."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        f.id if isinstance(f, ast.Name) else ""
    if name not in _ENV_FNS or not node.args:
        return None
    a0 = node.args[0]
    if isinstance(a0, ast.Constant) and isinstance(a0.value, str) \
            and _PIO_KNOB.match(a0.value):
        return a0.value, node.lineno
    return None


@rule("knob-envknobs",
      "every PIO_* env knob is parsed through common/envknobs.py — one "
      "tolerant parser, one malformed-value policy, instead of a fourth "
      "divergent copy of _env_int")
def knob_envknobs(project: Project) -> Iterable[Finding]:
    for m in project.modules():
        if _skip(m) or m.relpath == "common/envknobs.py":
            continue
        disp = project.display_path(m)
        for node in m.walk():
            hit = _env_read(node)
            if hit is not None:
                knob, line = hit
                yield Finding(
                    "knob-envknobs", disp, line,
                    f"{knob} read directly from os.environ — parse it "
                    "via common/envknobs.py (env_int/env_float/env_ms/"
                    "env_flag/env_str)")


def _code_knobs(project: Project) -> dict[str, tuple[str, int]]:
    """Every PIO_* knob the package READS (direct or envknobs), mapped
    to its first read site."""
    out: dict[str, tuple[str, int]] = {}
    for m in project.modules():
        if _skip(m):
            continue
        disp = project.display_path(m)
        for node in m.walk():
            hit = _env_read(node) or _envknobs_read(node)
            if hit is not None:
                out.setdefault(hit[0], (disp, hit[1]))
    return out


def _doc_knob_rows(project: Project) -> dict[str, tuple[str, int]]:
    """Knob-table rows across the docs' *.md: {knob: (docs path, line)}.
    A name ending in ``_`` documents a prefix family (PIO_SSL_...)."""
    rows: dict[str, tuple[str, int]] = {}
    for fname, text in project.docs().items():
        for i, line in enumerate(text.splitlines(), 1):
            match = _DOC_KNOB_ROW.match(line.strip())
            if match:  # every knob named in the row's FIRST cell
                for name in _DOC_KNOB_NAME.findall(match.group("cell")):
                    rows.setdefault(name, (project.docs_display(fname), i))
    return rows


@rule("knob-docs-sync",
      "the PIO_* knob set and the docs knob tables agree: every knob "
      "the package reads has a table row, every table row names a knob "
      "that still exists in the repo")
def knob_docs_sync(project: Project) -> Iterable[Finding]:
    code = _code_knobs(project)
    rows = _doc_knob_rows(project)
    prefixes = tuple(k for k in rows if k.endswith("_"))
    for knob, (disp, line) in sorted(code.items()):
        if knob in rows or any(knob.startswith(p) for p in prefixes):
            continue
        yield Finding(
            "knob-docs-sync", disp, line,
            f"{knob} is read here but has no row in any docs knob "
            "table — document it (the package's docs/operations.md)")
    if not rows and code:
        # docs missing entirely (seeded test trees get this instead of
        # a silent pass)
        return
    repo_text = project.repo_python_text()
    for knob, (docpath, line) in sorted(rows.items()):
        # prefix-family rows (PIO_SSL_...) probe as plain substrings too
        if knob not in repo_text:
            yield Finding(
                "knob-docs-sync", docpath, line,
                f"documented knob {knob} no longer appears anywhere in "
                "the repo's Python — delete the dead row")


@rule("fault-point-registry",
      "faultinject point names follow the dotted lowercase convention "
      "and are documented in the package's docs/operations.md — an "
      "undocumented point "
      "is chaos tooling nobody can aim")
def fault_point_registry(project: Project) -> Iterable[Finding]:
    ops = project.docs().get("operations.md", "")
    for m in project.modules():
        if _skip(m):
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
                continue  # variable point names (resilience endpoints)
            point = a0.value
            if not _FAULT_POINT.match(point):
                yield Finding(
                    "fault-point-registry", disp, node.lineno,
                    f"fault point {point!r} breaks the "
                    "subsystem.operation naming convention")
            elif f"`{point}`" not in ops:
                yield Finding(
                    "fault-point-registry", disp, node.lineno,
                    f"fault point {point!r} is not documented in "
                    "the package's docs/operations.md (fault points)")


# C-ABI symbol names (pio_col_*, pio_pdd_*) and the upstream
# PredictionIO storage repository names (pio_metadata/eventdata/
# modeldata) are fixed wire/DB contracts, not telemetry families.
_METRIC_SKIP_DIRS = ("native/", "data/storage/")
_METRIC_ALLOW = frozenset({
    "pio_pr",  # server-generated entity_type prefix (wire protocol)
})


@rule("metric-name-registry",
      "telemetry family names follow the pio_* convention (counters end "
      "_total) and every family is documented — an undocumented metric "
      "is a dashboard nobody will build")
def metric_name_registry(project: Project) -> Iterable[Finding]:
    docs = project.docs()

    def documented(name: str) -> bool:
        # accept `name` and the labelled form `name{label,...}`
        probe = re.compile(rf"`{re.escape(name)}(?![a-z0-9_])")
        return any(probe.search(text) for text in docs.values())

    for m in project.modules():
        if _skip(m) or m.relpath.startswith(_METRIC_SKIP_DIRS):
            continue
        # family names reach the registry in too many shapes for call-
        # site anchoring alone (collector loops build GaugeFamily from
        # name tuples), so the scan covers every pio_* snake literal —
        # but only in modules that actually touch telemetry, so a
        # pio_*-shaped wire constant elsewhere isn't misread as an
        # undocumented family
        if "telemetry" not in m.source:
            continue
        disp = project.display_path(m)
        # ContextVar debug names are runtime identifiers, not families —
        # exempt their first args so they never force a rename
        ctxvar_names = {
            n.args[0].value for n in m.walk()
            if isinstance(n, ast.Call) and n.args
            and isinstance(n.args[0], ast.Constant)
            and isinstance(n.args[0].value, str)
            and (getattr(n.func, "attr", "") == "ContextVar"
                 or getattr(n.func, "id", "") == "ContextVar")}
        seen: set[str] = set()
        for node in m.walk():
            # counters must end _total (Prometheus convention)
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "counter" \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    cname = node.args[0].value
                    if _METRIC.match(cname) \
                            and not cname.endswith("_total"):
                        yield Finding(
                            "metric-name-registry", disp, node.lineno,
                            f"counter family {cname!r} must end in "
                            "_total")
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            name = node.value
            if not _METRIC.match(name) or name in _METRIC_ALLOW \
                    or name in ctxvar_names or name in seen:
                continue
            seen.add(name)
            if not documented(name):
                yield Finding(
                    "metric-name-registry", disp, node.lineno,
                    f"telemetry family {name!r} is not documented in "
                    "the package's docs/ (operations.md metrics table)")


# ---------------------------------------------------------------------------
# soak registries: the scenario driver's SLO/fault contracts stay live
# ---------------------------------------------------------------------------

_SOAK_MODULE = "workflow/soak.py"


def _module_const_strings(m: Module, name: str):
    """String literals of a module-level ``NAME = (...)`` tuple/list
    assignment: [(value, lineno)], or None when no such literal
    assignment exists."""
    for node in m.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == name
                   for t in node.targets):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            return [(e.value, e.lineno) for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)]
    return None


def _module_const_dict(m: Module, name: str):
    """{key: (value, lineno)} of a module-level ``NAME = {...}`` dict
    literal with string keys/values, or None when absent."""
    for node in m.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == name
                   for t in node.targets):
            continue
        if isinstance(node.value, ast.Dict):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) \
                        and isinstance(k.value, str) \
                        and isinstance(v, ast.Constant) \
                        and isinstance(v.value, str):
                    out[k.value] = (v.value, v.lineno)
            return out
    return None


@rule("soak-slo-registry",
      "every telemetry family the soak driver asserts SLOs/evidence "
      "from (workflow/soak.py SLO_METRICS) is a documented metric "
      "family — a renamed family must not silently blind the scorecard")
def soak_slo_registry(project: Project) -> Iterable[Finding]:
    m = project.module(_SOAK_MODULE)
    if m is None or m.tree is None:
        return
    disp = project.display_path(m)
    entries = _module_const_strings(m, "SLO_METRICS")
    if entries is None:
        yield Finding(
            "soak-slo-registry", disp, 1,
            "SLO_METRICS tuple literal not found in workflow/soak.py — "
            "the soak SLO registry contract moved (rename breaks the "
            "lint coverage, restore the literal)")
        return
    docs = project.docs()

    def documented(name: str) -> bool:
        probe = re.compile(rf"`{re.escape(name)}(?![a-z0-9_])")
        return any(probe.search(text) for text in docs.values())

    for name, line in entries:
        if not _METRIC.match(name):
            yield Finding(
                "soak-slo-registry", disp, line,
                f"soak SLO metric {name!r} breaks the pio_* family "
                "naming convention")
        elif not documented(name):
            yield Finding(
                "soak-slo-registry", disp, line,
                f"soak SLO metric {name!r} is not a documented metric "
                "family (the package's docs/operations.md metrics "
                "tables) — the "
                "scorecard would assert evidence from a family nobody "
                "exports")


def _armed_points(project: Project) -> set:
    """Every fault-point literal named in a fault_point()/stream_fault()
    call anywhere in the package (the armed set)."""
    out: set = set()
    for m in project.modules():
        if m.tree is None:
            continue
        for node in m.walk():
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else ""
            if name in ("fault_point", "stream_fault") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                out.add(node.args[0].value)
    return out


@rule("soak-fault-registry",
      "every spec fault the soak scheduler can inject "
      "(workflow/soak.py FAULT_POINTS) names a fault point that is "
      "actually armed by a fault_point() call in the repo, and is on the "
      "scheduler's FAULT_MENU — a timeline aimed at a removed point "
      "would silently inject nothing")
def soak_fault_registry(project: Project) -> Iterable[Finding]:
    m = project.module(_SOAK_MODULE)
    if m is None or m.tree is None:
        return
    disp = project.display_path(m)
    mapping = _module_const_dict(m, "FAULT_POINTS")
    if mapping is None:
        yield Finding(
            "soak-fault-registry", disp, 1,
            "FAULT_POINTS dict literal not found in workflow/soak.py — "
            "the soak fault registry contract moved (rename breaks the "
            "lint coverage, restore the literal)")
        return
    armed = _armed_points(project)
    menu = _module_const_strings(m, "FAULT_MENU")
    on_menu = {v for v, _line in menu or ()}
    for fault, (point, line) in sorted(mapping.items()):
        if point not in armed:
            yield Finding(
                "soak-fault-registry", disp, line,
                f"soak fault {fault!r} schedules fault point {point!r}, "
                "which no fault_point()/stream_fault() call arms "
                "anywhere — the scheduled rule would never fire")
        elif menu is not None and fault not in on_menu:
            yield Finding(
                "soak-fault-registry", disp, line,
                f"soak fault {fault!r} maps a fault point but is not on "
                "FAULT_MENU — no scenario can schedule it")


RULES = [knob_envknobs, knob_docs_sync, fault_point_registry,
         metric_name_registry, soak_slo_registry, soak_fault_registry]
