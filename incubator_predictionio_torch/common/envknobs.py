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
``PIO_TENANT_{MAX_RESIDENT,MAX_PENDING,KEY_TTL_MS}``), with the same
semantics:

- unset / empty         → ``default`` (always)
- unparsable            → ``default`` (an operator typo must never crash
  a deploy or a train); integer knobs take no float spelling, so
  ``PIO_FOO=3.5`` falls back rather than silently truncating, unless
  ``float_ok=True`` (``"1e3"`` → 1000)
- ``lo``                → clamp the PARSED integer from below (clamping is
  not an error)
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["env_int", "env_float", "env_flag", "env_str"]


def env_int(name: str, default: int, *, lo: Optional[int] = None,
            float_ok: bool = False) -> int:
    """Integer knob (see the module docstring)."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        v = int(raw.strip())
    except ValueError:
        if not float_ok:
            return default
        try:
            f = float(raw.strip())
            if f != f or f in (float("inf"), float("-inf")):
                return default
            v = int(f)
        except (ValueError, OverflowError):
            return default
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
