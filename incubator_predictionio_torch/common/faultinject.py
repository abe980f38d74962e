"""Deterministic fault injection at named fault points.

The port's own copy of the ``fail`` and ``crash`` modes of
``incubator_predictionio_tpu/common/faultinject.py``: the event log's
fault points (``jsonl.append``, ``compact.write``, ``compact.rename``,
``compact.manifest``, ``retire.rename``), the engine server's
(``query.featurize``, ``query.predict``, ``query.serve``,
``query.batch_predict``, ``swap.validate``) and the online fold-in's
(``foldin.read``, ``foldin.apply``, ``foldin.publish``) consult it. The active plan
comes from the ``PIO_FAULT_SPEC`` environment variable, so a scenario
works the same in-process and across subprocesses:

    PIO_FAULT_SPEC="rule[;rule...]"
    rule = <point-pattern>:<fail|crash>:<count>

- ``point-pattern`` — fnmatch pattern against the fault-point name
  (``compact.write``, ``compact.*``, ``*``).
- ``fail:N`` — the first N matching calls raise :class:`InjectedFault`
  (a ``ConnectionError``).
- ``crash:N`` — the N-th matching call kills the process: SIGKILL to
  itself, no Python cleanup (a deterministic ``kill -9``).

The reference's other modes (``latency``, ``drop``, ``oserr``, ``at``)
belong to transports the port does not have yet; a spec naming one raises
``ValueError``.

Counts are per-rule and deterministic: "fail first 2 calls" means
exactly the first two matching calls in this process fail, then the
rule is spent. ``reset()`` re-arms the plan (tests call it after
setting the env var); parsing is cached and re-checked against the env
value on every fault point, so flipping the variable mid-process takes
effect immediately.
"""

from __future__ import annotations

import fnmatch
import os
import threading
from typing import Optional

__all__ = ["InjectedFault", "fault_point", "reset"]

ENV_VAR = "PIO_FAULT_SPEC"


class InjectedFault(ConnectionError):
    """A deterministic, injected failure."""


class _Rule:
    __slots__ = ("pattern", "mode", "remaining")

    def __init__(self, pattern: str, mode: str, count: int):
        self.pattern = pattern
        self.mode = mode
        self.remaining = count


def _parse(spec: str) -> list[_Rule]:
    rules: list[_Rule] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) < 3:
            raise ValueError(
                f"{ENV_VAR}: malformed rule {raw!r} "
                "(want point:mode:count)")
        pattern, mode, count = parts[0], parts[1].lower(), parts[2]
        if mode not in ("fail", "crash"):
            raise ValueError(f"{ENV_VAR}: unknown fault mode {mode!r} "
                             "(only 'fail' and 'crash' are supported)")
        try:
            n = int(count)
        except ValueError as e:
            raise ValueError(f"{ENV_VAR}: bad count in {raw!r}") from e
        rules.append(_Rule(pattern, mode, n))
    return rules


_lock = threading.Lock()
_cached_spec: Optional[str] = None
_rules: list[_Rule] = []


def _active_rules() -> list[_Rule]:
    """Current rule set, re-parsed whenever the env value changes.
    A changed value re-arms all counts (it is a NEW plan)."""
    global _cached_spec, _rules
    spec = os.environ.get(ENV_VAR, "")
    if spec != _cached_spec:
        _rules = _parse(spec)
        _cached_spec = spec
    return _rules


def reset() -> None:
    """Forget the cached plan so counts re-arm from the env value."""
    global _cached_spec, _rules
    with _lock:
        _cached_spec = None
        _rules = []


def _crash() -> None:  # pragma: no cover - the process dies
    """``kill -9`` of this process: no Python-level cleanup runs."""
    import signal

    try:
        os.kill(os.getpid(), signal.SIGKILL)
    except (OSError, AttributeError, ValueError):
        pass
    os._exit(137)


def fault_point(name: str) -> None:
    """Raise :class:`InjectedFault` if a ``fail`` rule matching ``name``
    has calls left, or die on the N-th match of a ``crash`` rule; a no-op
    (one dict lookup) when the spec is unset."""
    if not os.environ.get(ENV_VAR):
        return
    with _lock:
        for rule in _active_rules():
            if rule.remaining > 0 and fnmatch.fnmatch(name, rule.pattern):
                rule.remaining -= 1
                if rule.mode == "fail":
                    raise InjectedFault(
                        f"injected fault at {name!r} ({ENV_VAR})")
                if rule.remaining <= 0:
                    # the count selects WHICH call crashes
                    _crash()
