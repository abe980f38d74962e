"""Unified resilience layer: retries, circuit breakers, resilient I/O.

The port's own copy of ``incubator_predictionio_tpu/common/resilience.py``.
Every wire client in ``data/storage/`` routes its socket work through
this module so one policy governs the whole stack:

- :class:`RetryPolicy` — exponential backoff with FULL jitter
  (delay ~ U(0, min(cap, base·2^attempt))), a per-attempt timeout cap,
  an overall deadline budget, and retryable-vs-fatal classification.
- :class:`CircuitBreaker` — per-endpoint closed → open → half-open with
  state/transition counters; open circuits fail fast with
  :class:`CircuitOpenError` carrying a ``retry_after`` hint the servers
  surface as HTTP 503 + ``Retry-After``.
- :func:`resilient_urlopen` — the one place storage backends call
  ``urllib.request.urlopen``, so every HTTP-speaking backend gets fault
  injection (``common/faultinject.py``), retries and breaker accounting.
- :func:`retry_after_jitter` — the jittered ``Retry-After`` of every
  503 shed.

Breakers register themselves in a process-wide registry so ``pio
status``, the storage registry, and the serving /readyz endpoint can
report per-backend circuit state without owning the breaker objects.
"""

from __future__ import annotations

import http.client as _http_client
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Iterable, Optional

from . import deadline as _deadline
from . import faultinject, telemetry

__all__ = [
    "CircuitBreaker", "CircuitOpenError", "RetryPolicy", "RetryBudgetExceeded",
    "all_breakers", "breaker_snapshots", "is_retryable", "resilient_urlopen",
    "retry_after_jitter",
]

_jitter_rng = random.Random()


def retry_after_jitter(base: float,
                       rng: Optional[random.Random] = None) -> int:
    """Full-jittered integer ``Retry-After`` seconds for a 503 shed.

    A constant Retry-After synchronizes every SDK that honoured it into
    one retry wave exactly N seconds later — the thundering herd the
    shed was meant to prevent. Same cure as :meth:`RetryPolicy.backoff`:
    full jitter, here ``1 + U(0, 2·base)`` truncated to whole seconds
    (the header is integer delta-seconds per RFC 9110), so the mean
    stays ~``1 + base`` while the herd spreads over ``[1, 2·base + 1]``.
    """
    spread = (rng or _jitter_rng).uniform(0.0, 2.0 * max(0.0, base))
    return 1 + int(spread)


# ---------------------------------------------------------------------------
# telemetry: every wire transport reports through these two families
# (labelled by the transport's fault point, e.g. "es.request",
# "http.call", "hbase.rpc"), and the breaker registry doubles as the
# live source of the per-endpoint breaker-state gauge.
# ---------------------------------------------------------------------------

STORAGE_OP_SECONDS = telemetry.registry().histogram(
    "pio_storage_op_seconds",
    "Storage transport operation latency per backend endpoint "
    "(one observation per attempt, including failed attempts)",
    ("backend",))
STORAGE_OP_ERRORS = telemetry.registry().counter(
    "pio_storage_op_errors_total",
    "Storage transport operation failures per backend endpoint",
    ("backend",))

#: breaker-state gauge encoding (Prometheus has no string values)
_BREAKER_STATE_CODE = {"closed": 0, "half-open": 1, "open": 2}


def _breaker_collector():
    """Render-time gauge family from the live breaker registry —
    breakers are owned by storage clients (and vanish with them), so
    their state is collected, not recorded."""
    fam = telemetry.GaugeFamily(
        "pio_storage_breaker_state",
        "Circuit breaker state per endpoint (0=closed, 1=half-open, "
        "2=open)", ("endpoint",))
    fails = telemetry.GaugeFamily(
        "pio_storage_breaker_failures_total",
        "Connectivity failures accounted to each endpoint breaker",
        ("endpoint",))
    for snap in breaker_snapshots():
        fam.labels(snap["name"]).set(
            _BREAKER_STATE_CODE.get(snap["state"], -1))
        fails.labels(snap["name"]).set(snap["failure"])
    return [fam, fails]


telemetry.registry().register_collector("resilience.breakers",
                                        _breaker_collector)


# ---------------------------------------------------------------------------
# error classification
# ---------------------------------------------------------------------------

#: HTTP statuses that signal a transient server/infrastructure condition.
#: 429/503 are explicit backpressure; 502/504 are proxy-path failures.
RETRYABLE_HTTP = frozenset({429, 502, 503, 504})


def is_retryable(exc: BaseException) -> bool:
    """Default retryable-vs-fatal classification.

    Retryable: anything that can heal on its own — socket-level failures
    (``OSError`` covers refused/reset/unreachable/timeouts and the
    injected faults, which subclass ``ConnectionError``), torn HTTP
    framing, and the transient HTTP statuses. Fatal: everything else
    (4xx protocol errors, server-side application exceptions, bugs).
    """
    if isinstance(exc, CircuitOpenError):
        return False            # fail fast: the breaker already said no
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in RETRYABLE_HTTP
    if isinstance(exc, (urllib.error.URLError, _http_client.HTTPException,
                        OSError, TimeoutError)):
        return True
    retriable = getattr(exc, "retriable", None)
    if retriable is not None:   # protocol errors may self-classify
        return bool(retriable)
    return False


class RetryBudgetExceeded(Exception):
    """Deadline budget ran out before an attempt could start; carries
    the last attempt's error as ``__cause__``."""


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

class RetryPolicy:
    """Exponential backoff with full jitter under a deadline budget.

    ``call(fn)`` runs ``fn`` up to ``max_attempts`` times. After a
    retryable failure it sleeps ``U(0, min(max_delay, base_delay ·
    2^attempt))`` — full jitter, so a fleet of clients retrying the same
    dead store doesn't synchronize into waves. The overall ``deadline``
    is a budget across ALL attempts and sleeps: once spent, the last
    error is raised rather than starting another attempt.

    ``per_attempt_timeout`` is advisory — callers that take a timeout
    (urlopen, sockets) cap theirs with :meth:`attempt_timeout` so one
    black-holed attempt can't eat the whole budget.
    """

    def __init__(self, max_attempts: int = 4, base_delay: float = 0.05,
                 max_delay: float = 2.0, deadline: float = 15.0,
                 per_attempt_timeout: Optional[float] = None,
                 retryable: Callable[[BaseException], bool] = is_retryable,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.deadline = float(deadline)
        self.per_attempt_timeout = per_attempt_timeout
        self.retryable = retryable
        self._sleep = sleep
        self._rng = rng or random.Random()

    def backoff(self, attempt: int) -> float:
        """Jittered delay before retry number ``attempt`` (0-based).
        The exponent is clamped so huge attempt counts (operator sets
        RETRY_ATTEMPTS in the thousands) can't overflow float range."""
        cap = min(self.max_delay, self.base_delay * (2 ** min(attempt, 62)))
        return self._rng.uniform(0.0, cap)

    def attempt_timeout(self, default: float) -> float:
        """Per-attempt timeout: the caller's default, capped by the
        policy's explicit per-attempt cap (when one was configured).
        The deadline budget deliberately does NOT truncate an in-flight
        attempt — it only gates whether ANOTHER attempt may start, so a
        legitimately slow single operation (a multi-GB model blob
        transfer) keeps its full configured TIMEOUT; worst-case total
        time is bounded by deadline + one attempt timeout.

        A request-scoped deadline (``common/deadline.py`` contextvar —
        storage egress running inside a served query) is the exception:
        it DOES truncate the attempt, because past that point nobody is
        waiting for the answer. A small floor keeps a nearly-spent
        budget from degenerating into timeout=0 (invalid for sockets)."""
        t = default
        if self.per_attempt_timeout is not None:
            t = min(t, self.per_attempt_timeout)
        dl = _deadline.current()
        if dl is not None:
            t = min(t, max(dl.remaining(), 0.05))
        return t

    def call(self, fn: Callable[[], object], *,
             breaker: Optional["CircuitBreaker"] = None,
             on_retry: Optional[Callable[[BaseException, int], None]] = None,
             retryable: Optional[Callable[[BaseException], bool]] = None):
        """Run ``fn`` under this policy, optionally through ``breaker``
        (checked before every attempt, outcome recorded after).
        ``retryable`` overrides the policy's classifier for THIS call
        (e.g. "never retry" for non-idempotent requests).

        Breaker accounting is always the CONNECTIVITY classification
        (:func:`is_retryable`), independent of the retry decision: a
        fatal application error from an endpoint that answered records
        a breaker SUCCESS (the endpoint is healthy), and a connectivity
        failure records a breaker failure even when the caller chose
        not to retry it."""
        classify = retryable or self.retryable
        started = time.monotonic()
        # Request-scoped deadline (serving a query): the retry budget
        # is capped to the request's remaining balance, and an already-
        # spent budget refuses to start at all — a dead store must not
        # hold a query thread for this policy's full 15 s default when
        # the client's 504 fires in 200 ms.
        dl = _deadline.current()
        budget = self.deadline if dl is None \
            else min(self.deadline, dl.remaining())
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            if dl is not None:
                dl.check("storage egress")
            if breaker is not None:
                breaker.check()
            try:
                result = fn()
            except BaseException as e:  # noqa: BLE001 — reclassified below
                if breaker is not None and not isinstance(e, CircuitOpenError):
                    if is_retryable(e):
                        breaker.record_failure()
                    else:
                        breaker.record_success()
                if not classify(e) or attempt == self.max_attempts - 1:
                    raise
                last = e
                delay = self.backoff(attempt)
                if time.monotonic() - started + delay > budget:
                    raise RetryBudgetExceeded(
                        f"retry deadline budget ({budget:.3g}s) "
                        f"exhausted after {attempt + 1} attempt(s): {e}"
                    ) from e
                if on_retry is not None:
                    on_retry(e, attempt)
                if isinstance(e, urllib.error.HTTPError):
                    # drain the abandoned response so retried 429/5xx
                    # answers don't pin sockets until cyclic GC
                    try:
                        e.close()
                    except Exception:
                        pass
                if delay > 0:
                    self._sleep(delay)
                continue
            if breaker is not None:
                breaker.record_success()
            return result
        raise last  # pragma: no cover — loop always raises or returns


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitOpenError(ConnectionError):
    """Fail-fast refusal: the endpoint's circuit is open.

    Subclasses ``ConnectionError`` so existing ``except OSError``
    transport plumbing treats it as a connectivity failure, while
    servers can still catch the specific type to shed load (503 +
    ``Retry-After: retry_after``).
    """

    def __init__(self, name: str, retry_after: float):
        super().__init__(
            f"circuit breaker open for {name}; service unreachable — "
            f"retry after {retry_after:.1f}s")
        self.breaker_name = name
        self.retry_after = max(0.0, retry_after)


class CircuitBreaker:
    """Per-endpoint closed → open → half-open breaker.

    ``failure_threshold`` consecutive failures trip the circuit OPEN;
    calls then fail fast (no socket work) until ``reset_timeout``
    elapses, after which ONE probe call is let through HALF-OPEN — its
    success re-closes the circuit, its failure re-opens it for another
    ``reset_timeout``. Counters track every transition for operability
    (`pio status`, /readyz, the storage registry report them).
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout = float(reset_timeout)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started_at = 0.0
        self.counters = {"success": 0, "failure": 0, "rejected": 0,
                         "opened": 0, "half_opened": 0, "closed": 0}
        _register_breaker(self)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        # caller holds the lock
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout):
            self._state = self.HALF_OPEN
            self._probe_inflight = False
            self.counters["half_opened"] += 1

    def check(self) -> bool:
        """Gate an attempt: raises :class:`CircuitOpenError` when open
        (or when half-open and the single probe slot is taken). Returns
        True when THIS caller took the half-open probe slot (so it can
        release it if it ends with no verdict), False for a plain
        closed-state pass. A probe whose owner never reported an
        outcome (died mid-call, abandoned generator) expires after
        ``reset_timeout`` so the circuit can never wedge permanently
        half-open."""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return False
            if self._state == self.HALF_OPEN:
                stale = (self._probe_inflight
                         and self._clock() - self._probe_started_at
                         >= self.reset_timeout)
                if not self._probe_inflight or stale:
                    self._probe_inflight = True
                    self._probe_started_at = self._clock()
                    return True
            self.counters["rejected"] += 1
            remaining = self.reset_timeout - (self._clock() - self._opened_at)
            raise CircuitOpenError(self.name, remaining)

    def release_probe(self) -> None:
        """Release an unreported probe slot without biasing the state —
        for attempts that ended with no verdict (e.g. a scan generator
        dropped mid-iteration by its consumer)."""
        with self._lock:
            self._probe_inflight = False

    def record_success(self) -> None:
        with self._lock:
            self.counters["success"] += 1
            self._consecutive_failures = 0
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self.counters["closed"] += 1
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self.counters["failure"] += 1
            self._consecutive_failures += 1
            if self._state == self.HALF_OPEN:
                # the probe failed: straight back to open
                self._state = self.OPEN
                self._opened_at = self._clock()
                self.counters["opened"] += 1
                self._probe_inflight = False
            elif (self._state == self.CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self.counters["opened"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            self._maybe_half_open()
            return {
                "name": self.name,
                "state": self._state,
                "consecutiveFailures": self._consecutive_failures,
                **{k: v for k, v in self.counters.items()},
            }


# -- process-wide breaker registry (reporting only: weakly held, so a
# closed storage client's breakers vanish with it) --------------------------
import weakref as _weakref

_BREAKERS: "_weakref.WeakSet[CircuitBreaker]" = _weakref.WeakSet()
_BREAKERS_LOCK = threading.Lock()


def _register_breaker(b: CircuitBreaker) -> None:
    with _BREAKERS_LOCK:
        _BREAKERS.add(b)


def all_breakers() -> list[CircuitBreaker]:
    with _BREAKERS_LOCK:
        return sorted(_BREAKERS, key=lambda b: b.name)


def breaker_snapshots() -> list[dict]:
    """State of every live breaker in the process (``pio status``)."""
    return [b.snapshot() for b in all_breakers()]


# ---------------------------------------------------------------------------
# resilient urlopen — the storage backends' single HTTP egress point
# ---------------------------------------------------------------------------

#: Idempotent HTTP methods that are always safe to retry. Other methods
#: are retried only when the caller opts in (e.g. the HTTP storage
#:  backend's RPC POSTs, whose fault classification guarantees the
#: request never reached the application layer or is a wire-level POST
#: of an idempotent DAO read).
IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "PUT", "DELETE", "OPTIONS"})


def resilient_urlopen(req: "urllib.request.Request | str", *,
                      timeout: float,
                      policy: Optional[RetryPolicy] = None,
                      breaker: Optional[CircuitBreaker] = None,
                      point: str = "http",
                      retry_non_idempotent: bool = False,
                      context=None):
    """``urllib.request.urlopen`` with fault injection, retry and breaker.

    This is the only place modules under ``data/storage/`` may reach
    urlopen (guard-tested), so every backend inherits the same behavior:
    ``faultinject.fault_point(point)`` fires before each attempt
    (deterministic chaos testing), retryable failures back off per
    ``policy``, and ``breaker`` accounts every outcome. Responses are
    returned open — the caller reads/closes them; ``HTTPError`` with a
    non-retryable status propagates to the caller unchanged.
    """
    if isinstance(req, str):
        req = urllib.request.Request(req)
    method = (req.get_method() or "GET").upper()
    retryable: Optional[Callable[[BaseException], bool]] = None
    if method not in IDEMPOTENT_METHODS and not retry_non_idempotent:
        def retryable(_e: BaseException) -> bool:
            return False
    op_lat = STORAGE_OP_SECONDS.labels(point)
    op_err = STORAGE_OP_ERRORS.labels(point)

    def attempt():
        faultinject.fault_point(point)
        t = (policy.attempt_timeout(timeout)
             if policy is not None else timeout)
        t0 = telemetry.timer_start()
        try:
            return urllib.request.urlopen(req, timeout=t, context=context)
        except BaseException:
            op_err.inc()
            raise
        finally:
            op_lat.observe_since(t0)

    if policy is None:
        # single attempt, but with the SAME breaker accounting as the
        # retried path (RetryPolicy.call owns that logic in one place)
        policy = _SINGLE_ATTEMPT
    return policy.call(attempt, breaker=breaker, retryable=retryable)


#: Degenerate policy for "no retries, still account the breaker".
_SINGLE_ATTEMPT = RetryPolicy(max_attempts=1)


def prop_float(props: dict, key: str, fallback: float) -> float:
    """Tolerant numeric property: unset or unparsable values fall back
    (a typo'd knob must degrade to the default, not crash a deploy)."""
    raw = props.get(key)
    if raw is None:
        return fallback
    try:
        return float(raw)
    except (TypeError, ValueError):
        return fallback


def policy_from_props(props: dict, prefix: str = "RETRY_",
                      **defaults) -> RetryPolicy:
    """Build a RetryPolicy from PIO_STORAGE_SOURCES_<N>_* properties:
    ``RETRY_ATTEMPTS``, ``RETRY_BASE`` (s), ``RETRY_MAX`` (s),
    ``RETRY_DEADLINE`` (s). Unset values fall back to ``defaults`` then
    the RetryPolicy constructor defaults."""
    def num(key, fallback):
        return prop_float(props, prefix + key, fallback)
    return RetryPolicy(
        max_attempts=int(num("ATTEMPTS", defaults.get("max_attempts", 4))),
        base_delay=num("BASE", defaults.get("base_delay", 0.05)),
        max_delay=num("MAX", defaults.get("max_delay", 2.0)),
        deadline=num("DEADLINE", defaults.get("deadline", 15.0)),
    )


def breaker_from_props(props: dict, name: str,
                       prefix: str = "BREAKER_") -> CircuitBreaker:
    """Build a CircuitBreaker from source properties:
    ``BREAKER_THRESHOLD`` (consecutive failures), ``BREAKER_RESET`` (s)."""
    return CircuitBreaker(
        name,
        failure_threshold=int(prop_float(props, prefix + "THRESHOLD", 5)),
        reset_timeout=prop_float(props, prefix + "RESET", 30.0),
    )
