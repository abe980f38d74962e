"""``pio lint`` CLI: exit 1 on findings, ``--json`` for machines.

Kept torch-free and imported by the console before anything that could
pull in torch, so linting a broken tree costs a parse pass, not a
device initialization; it never touches the card.

``--changed [REF]`` is the incremental mode (pre-commit hooks, big
refactors): the WHOLE-program analysis still runs — a call-graph rule
cannot be correct on a file subset — but findings are reported only
into modules (and docs files) that differ from ``REF`` (default
``HEAD``, untracked files included). ``--profile`` prints per-rule
wall time so a rule that starts eating the tier-1 budget is named, not
guessed at."""

from __future__ import annotations

import argparse
import subprocess
import sys

from . import ALL_RULES, Project, report_json, run_lint


def _changed_paths(repo_root: str, ref: str) -> set:
    """repo_root-relative paths differing from ``ref`` (tracked diff +
    untracked files). Git reports paths relative to its TOPLEVEL, which
    is not necessarily the lint root (a repo nested in a larger
    checkout) — re-anchor them or the filter silently drops every
    finding and reports a false "clean". Raises ValueError with git's
    own words when the ref is unusable."""
    import pathlib

    def git(*args: str) -> str:
        proc = subprocess.run(
            ["git", "-C", repo_root, *args],
            capture_output=True, text=True, timeout=60)
        if proc.returncode != 0:
            raise ValueError(proc.stderr.strip()
                             or f"git {' '.join(args)} failed")
        return proc.stdout

    toplevel = pathlib.Path(git("rev-parse", "--show-toplevel").strip())
    prefix = pathlib.Path(repo_root).resolve().relative_to(
        toplevel).as_posix()
    prefix = "" if prefix == "." else prefix + "/"

    changed = set()
    # --full-name: ls-files is cwd-relative from a subdirectory while
    # diff is toplevel-relative — force both onto toplevel paths
    for args in (("diff", "--name-only", "-z", ref, "--"),
                 ("ls-files", "--others", "--exclude-standard",
                  "--full-name", "-z")):
        for chunk in git(*args).split("\0"):
            if chunk.startswith(prefix):
                changed.add(chunk[len(prefix):])
    changed.discard("")
    return changed


def main(args: list[str]) -> int:
    p = argparse.ArgumentParser(
        prog="pio lint",
        description="repo-wide static analysis: concurrency/convention/"
                    "flow rules over one AST parse pass "
                    "(incubator_predictionio_torch/docs/operations.md "
                    "'Static analysis')")
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings on stdout")
    p.add_argument("--rule", action="append", default=None,
                   metavar="NAME[,NAME...]",
                   help="run only these rules (repeatable, comma-ok); "
                        "skips the unused-suppression check")
    p.add_argument("--changed", nargs="?", const="HEAD", default=None,
                   metavar="REF",
                   help="report findings only in files differing from "
                        "REF (default HEAD; untracked included) — the "
                        "whole-program rules still see the full repo")
    p.add_argument("--profile", action="store_true",
                   help="print per-rule wall time to stderr")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--root", default=None,
                   help="repo root to lint (default: this checkout)")
    ns = p.parse_args(args)

    if ns.list_rules:
        for r in ALL_RULES:
            print(f"{r.name:<28} {r.rationale}")
        return 0

    only = None
    if ns.rule:
        only = [n.strip() for chunk in ns.rule for n in chunk.split(",")
                if n.strip()]
        if not only:
            # `--rule ""` selecting nothing must not report "clean"
            print("pio lint: --rule selected no rules", file=sys.stderr)
            return 2
    project = Project.from_repo(ns.root)
    changed = None
    if ns.changed is not None:
        try:
            changed = _changed_paths(str(project.repo_root), ns.changed)
        except (ValueError, OSError) as e:
            print(f"pio lint: --changed {ns.changed}: {e}",
                  file=sys.stderr)
            return 2
    try:
        result = run_lint(project, ALL_RULES, only=only)
    except ValueError as e:  # unknown --rule name
        print(f"pio lint: {e}", file=sys.stderr)
        return 2

    findings = result["findings"]
    scope = ""
    if changed is not None:
        findings = [f for f in findings if f.path in changed]
        scope = f", scoped to {len(changed)} changed file(s)"

    if ns.profile:
        for name, secs in sorted(result["timings"],
                                 key=lambda t: -t[1]):
            print(f"pio lint: {name:<28} {secs * 1e3:8.1f} ms",
                  file=sys.stderr)

    if ns.json:
        print(report_json({**result, "findings": findings}))
    else:
        for f in findings:
            print(f.render())
        n = len(findings)
        status = "clean" if n == 0 else f"{n} finding(s)"
        print(f"pio lint: {status} — {len(result['rules'])} rule(s) over "
              f"{result['modules']} module(s), "
              f"{result['suppressed']} suppression(s) honoured{scope}",
              file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":   # pragma: no cover — the pre-commit hook
    sys.exit(main(sys.argv[1:]))
