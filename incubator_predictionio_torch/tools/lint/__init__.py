"""``pio lint`` — the port's static-analysis pass.

See :mod:`.engine` for the model (one parse per module, declarative
rules, checked suppressions) and the port's operations page
(``incubator_predictionio_torch/docs/operations.md``, "Static analysis")
for the operator surface. Rule catalog::

    from incubator_predictionio_torch.tools.lint import ALL_RULES
"""

from __future__ import annotations

from .engine import (Finding, Module, Project, Rule, report_json, rule,
                     run_lint)
from . import (rules_concurrency, rules_confinement, rules_flow,
               rules_registry)

__all__ = ["ALL_RULES", "Finding", "Module", "Project", "Rule",
           "lint_repo", "report_json", "rule", "run_lint",
           "rule_names", "assert_rule_clean"]

ALL_RULES: list[Rule] = (rules_confinement.RULES
                         + rules_concurrency.RULES
                         + rules_registry.RULES
                         + rules_flow.RULES)


def rule_names() -> list[str]:
    return [r.name for r in ALL_RULES]


_project_cache: dict = {}
_full_result_cache: dict = {}


def lint_repo(repo_root=None, only=None) -> dict:
    """Run the full rule set (or ``only``) against this repo.

    The parsed Project is memoized per root: the tier-1 repo-clean test
    plus the per-subsystem guard tests would otherwise each re-parse
    every module — one parse pass total is the budget contract.
    FULL runs (``only=None``) memoize their whole result too: they are
    deterministic per process, and the repo-clean gate, the suppression
    inventory and the runtime-budget tests all want the same run — its
    ``timings`` carry the true cost (parse, call graph and tests/ scan
    are paid lazily inside the first rules that need them)."""
    project = _project_cache.get(repo_root)
    if project is None:
        project = _project_cache[repo_root] = Project.from_repo(repo_root)
    if only is None:
        result = _full_result_cache.get(repo_root)
        if result is None:
            result = _full_result_cache[repo_root] = run_lint(
                project, ALL_RULES)
        return result
    return run_lint(project, ALL_RULES, only=only)


def assert_rule_clean(*names: str) -> None:
    """Test helper: the repo must be clean under the named rule(s).

    The per-subsystem guard tests route through this — one engine, no
    duplicated ast.walk code. Raises AssertionError listing every
    finding."""
    result = lint_repo(only=list(names))
    findings = result["findings"]
    assert not findings, (
        f"pio lint rule(s) {', '.join(names)} found "
        f"{len(findings)} violation(s):\n"
        + "\n".join(f.render() for f in findings))
