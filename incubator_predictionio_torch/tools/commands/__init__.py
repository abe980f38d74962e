"""CLI verb registry (reference: tools/.../tools/commands/).

The port's own copy of ``incubator_predictionio_tpu/tools/commands/
__init__.py``: each command module registers its verbs with :func:`verb`
at import; :func:`dispatch` runs one.
"""

from __future__ import annotations

import importlib
import sys
from typing import Callable

_VERBS: dict[str, tuple[Callable[[list[str]], int], str]] = {}
_MODULES = ("app", "engine", "evaluation", "lint", "management", "models",
            "soak")
_loaded = False


def verb(name: str, help_text: str):
    def deco(fn):
        _VERBS[name] = (fn, help_text)
        return fn

    return deco


def _load_all() -> None:
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f".{m}", __package__)
    _loaded = True


def usage() -> str:
    _load_all()
    lines = ["usage: python -m incubator_predictionio_torch.tools.console "
             "<command> [args]", "", "commands:"]
    lines += [f"  {n:<14} {h}" for n, (_, h) in sorted(_VERBS.items())]
    lines += ["  version        print version", ""]
    return "\n".join(lines)


def dispatch(name: str, args: list[str]) -> int:
    _load_all()
    if name not in _VERBS:
        print(f"pio: unknown or not-yet-ported command: {name}", file=sys.stderr)
        print(usage(), file=sys.stderr)
        return 1
    return _VERBS[name][0](args)
