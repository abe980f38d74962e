"""Deterministic fault injection at named fault points.

The port's own copy of ``incubator_predictionio_tpu/common/faultinject.py``.
The event log's fault points (``jsonl.append``, ``compact.write``,
``compact.rename``, ``compact.manifest``, ``retire.rename``,
``archive.put``, ``archive.manifest``), the ingest path's
(``ingest.commit``, once per group commit; ``wal.append``, ``wal.mark``),
the engine server's (``query.featurize``, ``query.predict``,
``query.serve``, ``query.batch_predict``, ``swap.validate``), the online
fold-in's (``foldin.read``, ``foldin.apply``, ``foldin.publish``) and the
ALS trainers' (``train.sweep``, before each dispatch of iterations: the
gang supervisor's chaos point) and the HTTP storage transport's
(``http.call``, ``http.ping``, ``http.blob``, ``http.stream``) consult it. The active plan comes from the
``PIO_FAULT_SPEC`` environment variable, so a scenario works the same
in-process and across subprocesses:

    PIO_FAULT_SPEC="rule[;rule...]"
    rule = <point-pattern>:<mode>:<count>[:<param>]

- ``point-pattern`` — fnmatch pattern against the fault-point name
  (``compact.write``, ``compact.*``, ``*``).
- ``fail:N`` — the first N matching calls raise :class:`InjectedFault`
  (a ``ConnectionError``).
- ``latency:N:SECONDS`` — the first N matching calls sleep SECONDS before
  going on.
- ``drop:N:AFTER`` — streaming points only (:func:`stream_fault`): the
  first N matching streams raise :class:`InjectedFault` after AFTER items
  have been produced.
- ``crash:N`` — the N-th matching call kills the process: SIGKILL to
  itself, no Python cleanup (a deterministic ``kill -9``).
  ``ingest.commit:crash:3`` survives two group commits and dies inside
  the third.
- ``oserr:N:ERRNO`` — the first N matching calls raise a plain
  ``OSError(ERRNO, ...)`` (not the retryable :class:`InjectedFault`): the
  deterministic disk fault (``oserr:1:28`` = ENOSPC), which the ingest
  path classifies as resource exhaustion and sheds.
- ``at:MS[:SUBMODE[:PARAM]]`` — time-scheduled arming: the FIRST matching
  call at or after MS milliseconds past plan arming fires SUBMODE
  (``fail`` by default; ``crash``; ``latency`` with PARAM seconds;
  ``oserr`` with PARAM = errno), then the rule is spent. The clock starts
  when the plan is armed in THIS process: :func:`arm` (the event server
  calls it at construction) or the first fault-point consult that sees
  the current spec value.

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
import time
from typing import Optional

__all__ = ["InjectedFault", "arm", "fault_point", "stream_fault",
           "reset", "active_spec"]

ENV_VAR = "PIO_FAULT_SPEC"


class InjectedFault(ConnectionError):
    """A deterministic, injected failure."""


class _Rule:
    __slots__ = ("pattern", "mode", "remaining", "param", "at_s",
                 "submode")

    def __init__(self, pattern: str, mode: str, count: int, param: float,
                 at_s: float = 0.0, submode: str = "fail"):
        self.pattern = pattern
        self.mode = mode
        self.remaining = count
        self.param = param
        self.at_s = at_s          # "at" rules: offset past plan arming
        self.submode = submode    # "at" rules: what fires at the offset


_AT_SUBMODES = ("fail", "crash", "latency", "oserr")


def _parse_at(raw: str, parts: list[str]) -> _Rule:
    """``point:at:MS[:SUBMODE[:PARAM]]`` — monotonic-offset arming."""
    try:
        at_ms = float(parts[2])
    except ValueError as e:
        raise ValueError(f"{ENV_VAR}: bad offset in {raw!r}") from e
    if at_ms < 0:
        raise ValueError(f"{ENV_VAR}: negative offset in {raw!r}")
    submode = parts[3].lower() if len(parts) > 3 else "fail"
    if submode not in _AT_SUBMODES:
        raise ValueError(
            f"{ENV_VAR}: unknown at-submode {submode!r} in {raw!r} "
            f"(want one of {'/'.join(_AT_SUBMODES)})")
    param = 0.0
    if len(parts) > 4:
        try:
            param = float(parts[4])
        except ValueError as e:
            raise ValueError(f"{ENV_VAR}: bad param in {raw!r}") from e
    elif submode in ("latency", "oserr"):
        raise ValueError(f"{ENV_VAR}: at-submode {submode!r} needs a "
                         f"param ({raw!r})")
    return _Rule(parts[0], "at", 1, param, at_s=at_ms / 1000.0,
                 submode=submode)


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
                "(want point:mode:count[:param])")
        pattern, mode, count = parts[0], parts[1].lower(), parts[2]
        if mode == "at":
            rules.append(_parse_at(raw, parts))
            continue
        if mode not in ("fail", "latency", "drop", "crash", "oserr"):
            raise ValueError(f"{ENV_VAR}: unknown fault mode {mode!r}")
        try:
            n = int(count)
        except ValueError as e:
            raise ValueError(f"{ENV_VAR}: bad count in {raw!r}") from e
        param = 0.0
        if len(parts) > 3:
            try:
                param = float(parts[3])
            except ValueError as e:
                raise ValueError(f"{ENV_VAR}: bad param in {raw!r}") from e
        elif mode in ("latency", "drop", "oserr"):
            raise ValueError(f"{ENV_VAR}: mode {mode!r} needs a param "
                             f"({raw!r})")
        rules.append(_Rule(pattern, mode, n, param))
    return rules


_lock = threading.Lock()
_cached_spec: Optional[str] = None
_rules: list[_Rule] = []
_armed_at: float = 0.0   # monotonic instant the current plan armed


def _active_rules() -> list[_Rule]:
    """Current rule set, re-parsed whenever the env value changes.
    A changed value re-arms all counts (it is a NEW plan) and restarts
    the ``at``-mode offset clock."""
    global _cached_spec, _rules, _armed_at
    spec = os.environ.get(ENV_VAR, "")
    if spec != _cached_spec:
        _rules = _parse(spec)
        _cached_spec = spec
        _armed_at = time.monotonic()
    return _rules


def reset() -> None:
    """Forget the cached plan so counts re-arm from the env value."""
    global _cached_spec, _rules
    with _lock:
        _cached_spec = None
        _rules = []


def arm() -> None:
    """Parse the current plan NOW, starting the ``at``-mode offset
    clock, instead of waiting for the first fault-point consult.
    Servers call this at construction so scheduled offsets measure
    from "server up", not "first request". No-op when chaos is off."""
    if not os.environ.get(ENV_VAR):
        return
    with _lock:
        _active_rules()


def active_spec() -> str:
    """The raw spec currently in force ('' when chaos is off)."""
    return os.environ.get(ENV_VAR, "")


def _crash(name: str) -> None:  # pragma: no cover - the process dies
    """``kill -9`` of this process: no Python-level cleanup runs, so
    whatever the code under test had flushed to the OS is exactly what a
    recovery pass gets to see."""
    import signal

    try:
        os.kill(os.getpid(), signal.SIGKILL)
    except (OSError, AttributeError, ValueError):
        pass
    os._exit(137)


def fault_point(name: str) -> None:
    """Apply the ``fail``, ``latency``, ``crash``, ``oserr`` and ``at``
    rules matching ``name``; a no-op (one dict lookup) when the spec is
    unset."""
    if not os.environ.get(ENV_VAR):
        return
    delay = 0.0
    boom: Optional[Exception] = None
    die = False
    with _lock:
        for rule in _active_rules():
            if rule.remaining <= 0 or rule.mode == "drop":
                continue
            if not fnmatch.fnmatch(name, rule.pattern):
                continue
            if rule.mode == "at":
                # time-scheduled arming: the first matching call at or
                # past the offset fires the submode, earlier calls pass
                # untouched (and never consume the rule)
                if time.monotonic() - _armed_at < rule.at_s:
                    continue
                rule.remaining -= 1
                if rule.submode == "crash":
                    die = True
                    break
                if rule.submode == "fail":
                    boom = InjectedFault(
                        f"injected scheduled fault at {name!r} "
                        f"({ENV_VAR})")
                    break
                if rule.submode == "oserr":
                    boom = OSError(
                        int(rule.param),
                        f"injected scheduled disk fault at {name!r} "
                        f"({ENV_VAR})")
                    break
                delay += rule.param          # latency
                continue
            rule.remaining -= 1
            if rule.mode == "crash":
                # the count selects WHICH call crashes: survive the
                # first N-1 matches, die inside the N-th
                if rule.remaining <= 0:
                    die = True
                    break
                continue
            if rule.mode == "fail":
                boom = InjectedFault(
                    f"injected fault at {name!r} ({ENV_VAR})")
                break
            if rule.mode == "oserr":
                boom = OSError(
                    int(rule.param),
                    f"injected disk fault at {name!r} ({ENV_VAR})")
                break
            delay += rule.param
    if die:
        _crash(name)
    if delay > 0:
        time.sleep(delay)
    if boom is not None:
        raise boom


class StreamFault:
    """Armed mid-stream drop: call :meth:`on_item` once per produced
    item; raises :class:`InjectedFault` when the drop threshold hits."""

    def __init__(self, name: str, after: int):
        self.name = name
        self.after = after
        self._produced = 0

    def on_item(self) -> None:
        self._produced += 1
        if self._produced > self.after:
            raise InjectedFault(
                f"injected mid-stream drop at {self.name!r} after "
                f"{self.after} item(s) ({ENV_VAR})")


def stream_fault(name: str) -> Optional[StreamFault]:
    """Arm a ``drop`` rule for one stream (consumes one count), or
    ``None`` when no drop rule matches."""
    if not os.environ.get(ENV_VAR):
        return None
    with _lock:
        for rule in _active_rules():
            if (rule.mode == "drop" and rule.remaining > 0
                    and fnmatch.fnmatch(name, rule.pattern)):
                rule.remaining -= 1
                return StreamFault(name, int(rule.param))
    return None
