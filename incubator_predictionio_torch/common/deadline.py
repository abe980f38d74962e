"""Per-request deadline budgets that ride a contextvar through the stack.

The port's own copy of ``incubator_predictionio_tpu/common/deadline.py``.
A serving request gets ONE wall-clock budget at admission
(``PIO_QUERY_DEADLINE_MS`` default, ``X-Pio-Deadline-Ms`` header
override) and the serving stages spend from it (``Deployment.query``
checks between supplement, predict and serve).

The budget travels as a :mod:`contextvars` value. A thread does not
inherit the context, so the engine server hands it to its worker threads
with ``contextvars.copy_context().run``. Threads can't be killed: an
expired deadline makes the NEXT spend-point raise
:class:`DeadlineExceeded`, so a worker frees itself at the next stage
boundary instead of finishing a query whose client already got its 504.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import time
from typing import Iterator, Optional

__all__ = ["Deadline", "DeadlineExceeded", "current", "remaining",
           "running"]


class DeadlineExceeded(Exception):
    """The request's deadline budget is spent. Servers map this to
    HTTP 504 (the request was accepted but could not finish in time —
    distinct from the 503 admission shed, which never started work)."""

    def __init__(self, budget_ms: float, overrun_ms: float,
                 stage: str = ""):
        at = f" at {stage}" if stage else ""
        super().__init__(
            f"query deadline of {budget_ms:.0f}ms exceeded{at} "
            f"(overran by {overrun_ms:.0f}ms)")
        self.budget_ms = budget_ms
        self.overrun_ms = overrun_ms
        self.stage = stage


class Deadline:
    """Monotonic-clock budget: ``budget_ms`` from the moment of
    construction (admission time, so queue wait spends the budget too)."""

    __slots__ = ("budget_ms", "_expires_at")

    def __init__(self, budget_ms: float):
        self.budget_ms = float(budget_ms)
        if not math.isfinite(self.budget_ms):
            # nan poisons every comparison below (expired would be False
            # forever): refuse rather than mint a budget never spent
            raise ValueError(f"deadline budget must be finite, "
                             f"got {budget_ms!r}")
        self._expires_at = time.monotonic() + self.budget_ms / 1000.0

    def remaining(self) -> float:
        """Seconds left; clamped at 0.0 once spent."""
        return max(0.0, self._expires_at - time.monotonic())

    def remaining_ms(self) -> float:
        return self.remaining() * 1000.0

    def overrun_ms(self) -> float:
        """How far past the deadline we are (0.0 while still inside)."""
        return max(0.0, (time.monotonic() - self._expires_at) * 1000.0)

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self._expires_at

    def check(self, stage: str = "") -> None:
        """Spend-point: raise :class:`DeadlineExceeded` once expired."""
        if self.expired:
            raise DeadlineExceeded(self.budget_ms, self.overrun_ms(), stage)


_current: contextvars.ContextVar[Optional[Deadline]] = \
    contextvars.ContextVar("pio_query_deadline", default=None)


def current() -> Optional[Deadline]:
    """The deadline governing this context (None = unbounded)."""
    return _current.get()


def remaining() -> Optional[float]:
    """Seconds left in this context's budget, or None when unbounded."""
    dl = _current.get()
    return None if dl is None else dl.remaining()


@contextlib.contextmanager
def running(dl: Optional[Deadline]) -> Iterator[Optional[Deadline]]:
    """Install ``dl`` as the context's deadline for the duration.
    ``None`` is allowed (explicitly unbounded — shadows any outer
    deadline), which keeps call sites branch-free."""
    token = _current.set(dl)
    try:
        yield dl
    finally:
        _current.reset(token)
