"""One tolerant parser for ``PIO_*`` environment knobs.

The port's own copy of the parts of
``incubator_predictionio_tpu/common/envknobs.py`` that the port reads
(``PIO_TRAIN_WINDOW*``, ``PIO_EVENT_RETENTION``, ``PIO_INGEST_FSYNC``,
``PIO_UR_FULL_MATRIX_ELEMS`` and the engine server's ``PIO_QUERY_*``,
``PIO_DRAIN_DEADLINE_MS``, ``PIO_SWAP_*``, ``PIO_MODEL_REFRESH_MS``,
``PIO_QUERY_CACHE_*``, ``PIO_GOLDEN_QUERY``,
``PIO_ENGINE_SERVER_PLUGINS``, the online fold-in's ``PIO_FOLDIN_MS``, the
quality watch's ``PIO_QUALITY_{SAMPLE,K,MIN_SAMPLES,MAX_DROP,WATCH_MS,
RESOLVE_MS,MS}`` and the tenant mux's
``PIO_TENANT_{MAX_RESIDENT,MAX_PENDING,KEY_TTL_MS}``, the serving fleet's
``PIO_QUERY_REPLICAS``, ``PIO_FLEET_{SYNC,READY,CONNECT_RETRY}_MS``,
``PIO_FLEET_{MIN,MAX}_REPLICAS``, ``PIO_FLEET_APP``,
``PIO_FLEET_WORKER_FAULT_SPEC[_<i>]`` and ``PIO_SCALE_*``, and the
supervisor's ``PIO_WORKER_*``, ``PIO_TRAIN_MAX_RESTARTS``,
``PIO_TRAIN_DRAIN_MS`` and ``PIO_SUPERVISOR_POLL_MS``, and the network
stores' ``PIO_PG_FETCH_SIZE``, ``PIO_SQL_PAGE_SIZE`` and
``PIO_STORAGESERVER_SECRET``), with the same semantics:

- unset / empty         → ``default`` (always)
- unparsable            → ``default`` (an operator typo must never crash
  a deploy or a train); integer knobs take no float spelling, so
  ``PIO_FOO=3.5`` falls back rather than silently truncating, unless
  ``float_ok=True`` (``"1e3"`` → 1000); ``warn=True`` also emits a
  ``UserWarning`` naming the variable and the value it fell back to
- ``lo``                → clamp the PARSED integer from below (clamping is
  not an error)
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

__all__ = ["env_int", "env_float", "env_ms", "env_flag", "env_str"]


def _fallback(name: str, raw: str, default, warn: bool):
    if warn:
        warnings.warn(f"{name}={raw!r} is not a valid value; using {default}",
                      stacklevel=4)
    return default


def env_int(name: str, default: int, *, lo: Optional[int] = None,
            float_ok: bool = False, warn: bool = False) -> int:
    """Integer knob (see the module docstring)."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        v = int(raw.strip())
    except ValueError:
        if not float_ok:
            return _fallback(name, raw, default, warn)
        try:
            f = float(raw.strip())
            if f != f or f in (float("inf"), float("-inf")):
                return _fallback(name, raw, default, warn)
            v = int(f)
        except (ValueError, OverflowError):
            return _fallback(name, raw, default, warn)
    if lo is not None:
        v = max(lo, v)
    return v


def env_float(name: str, default: float, *, lo: Optional[float] = None,
              hi: Optional[float] = None) -> float:
    """Float knob: nan/inf spellings count as malformed (→ default);
    the parsed value is clamped to [lo, hi]."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        v = float(raw.strip())
    except (ValueError, OverflowError):
        return default
    if v != v or v in (float("inf"), float("-inf")):
        return default
    if lo is not None:
        v = max(lo, v)
    if hi is not None:
        v = min(hi, v)
    return v


def env_ms(name: str, default_ms: float, *, lo_ms: float = 0.0) -> float:
    """Millisecond knob returned in SECONDS (what time.monotonic math
    wants); malformed/non-finite → default, clamped at ``lo_ms``."""
    return env_float(name, default_ms, lo=lo_ms) / 1000.0


def env_flag(name: str, default: bool) -> bool:
    """Boolean knob: 1/true/yes/on vs 0/false/no/off (case-insensitive);
    anything else → default."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    v = raw.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    return default


def env_str(name: str, default: str, *, lower: bool = True) -> str:
    """String knob, stripped and (unless ``lower=False``) lower-cased."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    return raw.strip().lower() if lower else raw.strip()
