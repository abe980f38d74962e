"""`pio lint` rule engine: one AST parse per module, declarative rules.

The port's copy of the reference's ``tools/lint/engine.py``. It turns the
package's conventions into an enforced checker: every module is parsed
ONCE into a :class:`Project`, rules are small functions over the parsed
forest, findings carry file:line anchors, and per-line suppressions are
themselves checked (an unused suppression is a finding, so dead
exemptions can't accumulate).

Torch-free and import-light: the engine reads SOURCE, it never imports
the modules it checks, so ``pio lint`` runs in seconds as a tier-1 test
and on a host whose runtime is broken. The knob, fault-point and metric
tables it holds the code to are the port's own
(``incubator_predictionio_torch/docs/operations.md``); the tests it reads
are the port's (``tests/test_torch_*.py``, ``tests/torch_*.py``) and
``chip_smoke.py``.

Suppression syntax (per physical line, reason recommended)::

    something_exempt()  # pio-lint: disable=rule-name -- why it is safe
    other()             # pio-lint: disable=rule-a,rule-b -- shared reason
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
import time
from typing import Callable, Iterable, Optional

__all__ = [
    "Finding", "Module", "Project", "Rule", "rule", "run_lint",
    "PACKAGE_NAME", "PORT_PY_GLOBS", "PORT_TEST_GLOBS",
]

PACKAGE_NAME = "incubator_predictionio_torch"

#: the port's own tests: where fault-spec literals arm its fault points
#: (the reference's tests are held to the reference's package, not this)
PORT_TEST_GLOBS = ("tests/test_torch_*.py", "tests/torch_*.py")
#: ...and its card script: together, the knob table's existence oracle
PORT_PY_GLOBS = ("chip_smoke.py", *PORT_TEST_GLOBS)

# rule names reserved by the engine itself (not declarative rules)
PARSE_ERROR = "parse-error"
UNUSED_SUPPRESSION = "unused-suppression"

_SUPPRESS_RE = re.compile(
    r"#\s*pio-lint:\s*disable=([A-Za-z0-9_,-]+)(?:\s+--\s*(.*\S))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a repo-relative file:line."""

    rule: str
    path: str          # repo-relative, posix separators
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    """A ``# pio-lint: disable=`` comment found in a module."""

    path: str               # repo-relative
    line: int
    rules: tuple[str, ...]
    reason: str
    used: set = dataclasses.field(default_factory=set)  # rule names hit


class Module:
    """One parsed source file. ``tree`` is None when parsing failed
    (the engine reports that as a ``parse-error`` finding — a module
    the compiler can't read is a module no rule can vouch for)."""

    def __init__(self, path: pathlib.Path, relpath: str):
        self.path = path
        self.relpath = relpath          # relative to the PACKAGE root
        self.source = path.read_text(encoding="utf-8")
        self.lines = self.source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(self.source, filename=str(path))
        except SyntaxError as e:  # pragma: no cover — repo always parses
            self.parse_error = f"{e.msg} (line {e.lineno})"

    def walk(self) -> Iterable[ast.AST]:
        return ast.walk(self.tree) if self.tree is not None else ()


class Project:
    """The parsed package + the docs it must stay in sync with (by
    default the package's own ``docs/``).

    Parsing is done lazily and exactly once per file; rules receive the
    same Project instance, so a full ``pio lint`` run is a single parse
    pass over the package (the tier-1 budget constraint)."""

    def __init__(self, repo_root: pathlib.Path,
                 pkg_root: Optional[pathlib.Path] = None,
                 docs_dir: Optional[pathlib.Path] = None):
        self.repo_root = pathlib.Path(repo_root)
        self.pkg_root = pathlib.Path(
            pkg_root if pkg_root is not None
            else self.repo_root / PACKAGE_NAME)
        self.docs_dir = pathlib.Path(
            docs_dir if docs_dir is not None else self.pkg_root / "docs")
        self._modules: Optional[dict[str, Module]] = None
        self._docs: Optional[dict[str, str]] = None
        self._repo_py_text: Optional[str] = None

    @classmethod
    def from_repo(cls, repo_root=None) -> "Project":
        if repo_root is None:
            # tools/lint/engine.py → package root is three parents up
            pkg = pathlib.Path(__file__).resolve().parent.parent.parent
            repo_root = pkg.parent
        return cls(pathlib.Path(repo_root))

    # -- package sources ---------------------------------------------------
    def modules(self, under: str = "") -> list[Module]:
        """All package modules, or those whose relpath starts with
        ``under`` (posix prefix like ``"data/api/"``)."""
        if self._modules is None:
            mods = {}
            for path in sorted(self.pkg_root.rglob("*.py")):
                if "__pycache__" in path.parts:
                    continue
                rel = path.relative_to(self.pkg_root).as_posix()
                mods[rel] = Module(path, rel)
            self._modules = mods
        if not under:
            return list(self._modules.values())
        return [m for r, m in self._modules.items() if r.startswith(under)]

    def module(self, relpath: str) -> Optional[Module]:
        self.modules()
        assert self._modules is not None
        return self._modules.get(relpath)

    def display_path(self, module: Module) -> str:
        """Repo-relative path for findings (clickable in terminals)."""
        try:
            return module.path.relative_to(self.repo_root).as_posix()
        except ValueError:  # pkg outside repo root (seeded test trees)
            return f"{PACKAGE_NAME}/{module.relpath}"

    # -- docs --------------------------------------------------------------
    def docs(self) -> dict[str, str]:
        """{filename: text} for every markdown file under docs/."""
        if self._docs is None:
            self._docs = {}
            if self.docs_dir.is_dir():
                for p in sorted(self.docs_dir.glob("*.md")):
                    self._docs[p.name] = p.read_text(encoding="utf-8")
        return self._docs

    def docs_display(self, filename: str) -> str:
        """Repo-relative path of a docs file, for findings."""
        try:
            rel = self.docs_dir.relative_to(self.repo_root).as_posix()
        except ValueError:  # docs outside the repo root
            rel = "docs"
        return f"{rel}/{filename}"

    def docs_line(self, filename: str, needle: str) -> int:
        """1-based line of the first occurrence of ``needle`` in a docs
        file (0 when absent) — used to anchor docs-side findings."""
        text = self.docs().get(filename, "")
        for i, line in enumerate(text.splitlines(), 1):
            if needle in line:
                return i
        return 0

    # -- repo-wide literal search (docs dead-row check) --------------------
    def port_py_paths(self, globs=PORT_PY_GLOBS) -> list[pathlib.Path]:
        """The port's test modules and card script (:data:`PORT_PY_GLOBS`),
        or the files of ``globs``."""
        out = []
        for pattern in globs:
            for p in sorted(self.repo_root.glob(pattern)):
                if "__pycache__" not in p.parts:
                    out.append(p)
        return out

    def repo_python_text(self) -> str:
        """Concatenated text of the package, the port's tests and
        ``chip_smoke.py``: the existence oracle for documented knobs that
        live outside the package."""
        if self._repo_py_text is None:
            chunks = []
            for p in self.port_py_paths():
                try:
                    chunks.append(p.read_text(encoding="utf-8"))
                except OSError:  # pragma: no cover
                    pass
            for m in self.modules():
                chunks.append(m.source)
            self._repo_py_text = "\n".join(chunks)
        return self._repo_py_text

    # -- suppressions ------------------------------------------------------
    def suppressions(self) -> dict[tuple[str, int], Suppression]:
        out = {}
        for m in self.modules():
            if m.relpath.startswith("tools/lint/"):
                continue  # the linter's own docs show the syntax
            disp = self.display_path(m)
            for i, line in enumerate(m.lines, 1):
                match = _SUPPRESS_RE.search(line)
                if match is None:
                    continue
                rules = tuple(
                    r.strip() for r in match.group(1).split(",") if r.strip())
                out[(disp, i)] = Suppression(
                    disp, i, rules, (match.group(2) or "").strip())
        return out


class Rule:
    """A named check over a :class:`Project`. ``fn(project)`` yields
    :class:`Finding`s; ``rationale`` is the one-line catalog entry."""

    def __init__(self, name: str, rationale: str,
                 fn: Callable[[Project], Iterable[Finding]]):
        self.name = name
        self.rationale = rationale
        self._fn = fn

    def check(self, project: Project) -> list[Finding]:
        return list(self._fn(project))


def rule(name: str, rationale: str):
    """Decorator: register a generator function as a Rule."""
    def deco(fn):
        return Rule(name, rationale, fn)
    return deco


def run_lint(project: Project, rules: list[Rule],
             only: Optional[Iterable[str]] = None) -> dict:
    """Run ``rules`` (optionally restricted to the ``only`` names) over
    ``project``. Returns::

        {"findings": [Finding...],       # post-suppression, sorted
         "suppressed": int,
         "suppressions": [Suppression...],
         "rules": [names run],
         "timings": [(rule name, seconds)],   # per-rule wall time
         "modules": int}

    Per-line ``# pio-lint: disable=<rule>`` comments swallow findings
    of that rule on that physical line. On a FULL run (``only`` is
    None) every suppression must have earned its keep: a disable
    comment whose rule produced no finding on that line — or that
    names an unknown rule — becomes an ``unused-suppression`` finding,
    so stale exemptions surface instead of silently rotting. Restricted
    runs skip that check (a single rule can't know what the others
    would have hit).
    """
    known = {r.name for r in rules}
    if only is not None:
        wanted = set(only)
        unknown = wanted - known
        if unknown:
            raise ValueError(
                f"unknown rule(s): {', '.join(sorted(unknown))}; "
                f"known: {', '.join(sorted(known))}")
        selected = [r for r in rules if r.name in wanted]
    else:
        selected = list(rules)

    raw: list[Finding] = []
    timings: list[tuple[str, float]] = []
    for r in selected:
        t0 = time.perf_counter()
        raw.extend(r.check(project))
        timings.append((r.name, time.perf_counter() - t0))
    # modules the compiler can't parse are findings, not crashes
    for m in project.modules():
        if m.parse_error is not None:
            raw.append(Finding(PARSE_ERROR, project.display_path(m),
                               1, f"syntax error: {m.parse_error}"))

    sups = project.suppressions()
    kept: list[Finding] = []
    suppressed = 0
    for f in raw:
        s = sups.get((f.path, f.line))
        if s is not None and f.rule in s.rules:
            s.used.add(f.rule)
            suppressed += 1
        else:
            kept.append(f)

    if only is None:
        for s in sups.values():
            for rname in s.rules:
                if rname in s.used:
                    continue
                why = ("unknown rule" if rname not in known
                       else "nothing to suppress here")
                kept.append(Finding(
                    UNUSED_SUPPRESSION, s.path, s.line,
                    f"suppression of {rname!r} is unused ({why}) — "
                    "delete it or fix the rule name"))

    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return {
        "findings": kept,
        "suppressed": suppressed,
        "suppressions": sorted(sups.values(), key=lambda s: (s.path, s.line)),
        "rules": [r.name for r in selected],
        "timings": timings,
        "modules": len(project.modules()),
    }


def report_json(result: dict) -> str:
    """Stable machine-readable form for ``pio lint --json``."""
    return json.dumps({
        "clean": not result["findings"],
        "findings": [f.to_json() for f in result["findings"]],
        "suppressed": result["suppressed"],
        "suppressions": [
            {"path": s.path, "line": s.line, "rules": list(s.rules),
             "reason": s.reason}
            for s in result["suppressions"]],
        "rules": result["rules"],
        "modules": result["modules"],
    }, indent=2, sort_keys=True)
