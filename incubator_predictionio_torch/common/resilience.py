"""Jittered ``Retry-After`` for load shedding.

The port's own copy of ``retry_after_jitter`` from
``incubator_predictionio_tpu/common/resilience.py`` (:49). The circuit
breakers, ``RetryPolicy`` and ``resilient_urlopen`` come with the network
storage backends (ROADMAP Queue 1, item 3.4).
"""

from __future__ import annotations

import random
from typing import Optional

__all__ = ["retry_after_jitter"]

_jitter_rng = random.Random()


def retry_after_jitter(base: float,
                       rng: Optional[random.Random] = None) -> int:
    """Full-jittered integer ``Retry-After`` seconds for a 503 shed.

    A constant Retry-After synchronizes every client that honours it into
    one retry wave exactly N seconds later. Full jitter, ``1 + U(0,
    2·base)`` truncated to whole seconds (the header is integer
    delta-seconds per RFC 9110), keeps the mean near ``1 + base`` while
    the herd spreads over ``[1, 2·base + 1]``.
    """
    spread = (rng or _jitter_rng).uniform(0.0, 2.0 * max(0.0, base))
    return 1 + int(spread)
