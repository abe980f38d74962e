"""`pio lint` — repo-wide static analysis (tools/lint/).

The console also dispatches this verb BEFORE anything that could import
torch (see console.main): linting must work, fast, on a tree whose
runtime is broken — that is when you need it most."""

from __future__ import annotations

from . import verb


@verb("lint", "repo-wide static analysis (concurrency/convention rules)")
def lint_cmd(args: list[str]) -> int:
    from ..lint.cli import main

    return main(args)
