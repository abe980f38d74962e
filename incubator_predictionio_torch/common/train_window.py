"""Event-time training windows: one resolver for "train on the last
N days".

The port's own copy of ``incubator_predictionio_tpu/common/train_window.py``.

Production training is windowed — "last 90 days" — and the whole point
of time-bounded log generations (``data/api/event_log.py``) is that a
windowed read can skip cold generations without decoding them. This
module is the single place the window is *decided*, so every consumer
(``PEventStore.find_ratings`` / ``find_batches``, the partition-local
train feed, the manifest-chain loader) cuts the SAME window:

- ``PIO_TRAIN_WINDOW`` — a duration (``90d``, ``12h``, ``30m``,
  ``45s``), resolved against "now" at read time.
- ``PIO_TRAIN_WINDOW_START_US`` / ``PIO_TRAIN_WINDOW_UNTIL_US`` —
  absolute microsecond bounds; they OVERRIDE the duration form.

Gang determinism: ``pio train --window 90d`` resolves the duration to
an absolute start ONCE in the launching process and exports
``PIO_TRAIN_WINDOW_START_US`` before the gang spawns — each worker
inherits the absolute bound instead of re-reading its own clock, so
every partition cuts the log at the identical microsecond.

Explicit beats ambient: a caller that passes its own
``start_time``/``until_time`` is never second-guessed — the env window
only fills bounds the caller left as ``None`` (and only when it left
BOTH as None, so a deliberate open-ended query stays open-ended).
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Optional

from . import envknobs

__all__ = [
    "apply_window", "parse_duration_us", "resolve_us", "window_datetimes",
]

#: duration spellings accepted by PIO_TRAIN_WINDOW / PIO_EVENT_RETENTION
_DURATION = re.compile(r"^(?P<n>\d+(?:\.\d+)?)(?P<unit>[dhms])$")
_UNIT_US = {
    "d": 86_400_000_000,
    "h": 3_600_000_000,
    "m": 60_000_000,
    "s": 1_000_000,
}


def now_us() -> int:
    """Current wall-clock time in epoch microseconds (UTC)."""
    return int(_dt.datetime.now(_dt.timezone.utc).timestamp() * 1_000_000)


def parse_duration_us(raw: Optional[str]) -> Optional[int]:
    """``"90d"``/``"12h"``/``"30m"``/``"45s"`` → microseconds, or None
    for unset/malformed input (a typo'd window must degrade to the full
    scan, never crash a train or drop data on the floor)."""
    if not raw:
        return None
    m = _DURATION.match(raw.strip().lower())
    if m is None:
        return None
    try:
        us = int(float(m.group("n")) * _UNIT_US[m.group("unit")])
    except (ValueError, OverflowError):
        return None
    return us if us > 0 else None


def _env_us(name: str) -> Optional[int]:
    # -1 is the "unset" sentinel: epoch bounds are non-negative
    v = envknobs.env_int(name, -1, lo=-1)
    return None if v < 0 else v


def resolve_us(now: Optional[int] = None) -> tuple[Optional[int],
                                                   Optional[int]]:
    """The ambient training window as absolute microsecond bounds
    ``(start_us, until_us)`` — each None when unbounded on that side.

    Absolute knobs win over the duration knob; the duration is anchored
    at ``now`` (injectable for tests and for the one-shot CLI
    resolution that pins the gang's shared window)."""
    start = _env_us("PIO_TRAIN_WINDOW_START_US")
    until = _env_us("PIO_TRAIN_WINDOW_UNTIL_US")
    if start is None and until is None:
        dur = parse_duration_us(envknobs.env_str("PIO_TRAIN_WINDOW", ""))
        if dur is not None:
            start = (now if now is not None else now_us()) - dur
    return start, until


def _to_datetime(us: Optional[int]) -> Optional[_dt.datetime]:
    if us is None:
        return None
    return _dt.datetime.fromtimestamp(us / 1_000_000, _dt.timezone.utc)


def window_datetimes() -> tuple[Optional[_dt.datetime],
                                Optional[_dt.datetime]]:
    """:func:`resolve_us` as tz-aware datetimes — the type the event
    store's ``start_time``/``until_time`` parameters take."""
    start, until = resolve_us()
    return _to_datetime(start), _to_datetime(until)


def apply_window(start_time: Optional[_dt.datetime],
                 until_time: Optional[_dt.datetime]) -> tuple:
    """Fill an all-``None`` time range from the ambient window; any
    explicitly passed bound disables the ambient window entirely."""
    if start_time is not None or until_time is not None:
        return start_time, until_time
    return window_datetimes()
