"""Elastic topology: the fleet sizes itself under load.

The port's own copy of ``incubator_predictionio_tpu/workflow/elastic.py``
(stdlib only), with the reference's decisions, knobs and JSON:

- :func:`sample_status` scrapes one replica's ``/status`` (the overload
  snapshot ``pio status`` reads): queue depth (``pending`` /
  ``pendingLimit``) and the shed counter.
- :class:`ElasticController` folds a per-tick list of
  :class:`ReplicaSample` into a :class:`Decision` against the operator
  bounds (``PIO_FLEET_MIN/MAX_REPLICAS``) and thresholds
  (``PIO_SCALE_UP/DOWN_THRESHOLD``), with hysteresis
  (``PIO_SCALE_HYSTERESIS_TICKS`` consecutive agreeing ticks) and a
  cooldown (``PIO_SCALE_COOLDOWN_MS``).
- The controller only DECIDES. The fleet front (``workflow/fleet.py``)
  acts: it spawns through the supervisor and drains through the front's
  draining mark and the supervisor's retirement, and the
  :class:`~.fleet.FleetCoordinator` commits every acted decision into its
  fenced directive record.

Scale-up reasons: ``floor`` (below the operator minimum; skips the
hysteresis), ``shed`` (replicas refused work this tick), ``utilization``
(queue depth at or above ``PIO_SCALE_UP_THRESHOLD``). Scale-down has one
reason, ``quiet``, and drains the least-loaded READY replica (ties toward
the highest slot, so the canary's slot 0 stays); while a spawned replica
is still settling toward ready the loop holds (``settling``).

Telemetry: ``pio_fleet_scale_events_total{direction,reason}`` counts
acted decisions; ``pio_fleet_replicas_target`` gauges the current target
(the front process's registry). The acted decisions also ride the front's
``/healthz`` (``elastic.decisions``) and the directive record's ``scale``
payload.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from typing import Optional, Sequence

from ..common import envknobs, telemetry

__all__ = [
    "Decision", "ElasticConfig", "ElasticController", "ReplicaSample",
    "plan", "sample_status",
]


def _metrics():
    reg = telemetry.registry()
    return (
        reg.counter("pio_fleet_scale_events_total",
                    "Acted autoscaler decisions, by direction "
                    "(up/down) and reason (floor/shed/utilization/"
                    "quiet)", ("direction", "reason")),
        reg.gauge("pio_fleet_replicas_target",
                  "Replica count the autoscaler is currently driving "
                  "the fleet toward").labels(),
    )


# ---------------------------------------------------------------------------
# config + snapshot types
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ElasticConfig:
    """Operator bounds + loop damping (all overridable via env).

    - ``PIO_FLEET_MIN_REPLICAS`` / ``PIO_FLEET_MAX_REPLICAS`` — the
      envelope the fleet may size itself within
    - ``PIO_SCALE_UP_THRESHOLD`` — queue utilization
      (pending/pendingLimit, worst ready replica) at/above which a tick
      votes scale-up (default 0.8)
    - ``PIO_SCALE_DOWN_THRESHOLD`` — utilization at/below which a tick
      votes scale-down (default 0.2; sheds always veto down-votes)
    - ``PIO_SCALE_HYSTERESIS_TICKS`` — consecutive agreeing ticks
      before acting (default 3)
    - ``PIO_SCALE_COOLDOWN_MS`` — minimum spacing between acted
      decisions (default 5000)
    - ``PIO_SCALE_TICK_MS`` — scrape/decide cadence (default 500)
    """

    min_replicas: int = 1
    max_replicas: int = 1
    up_threshold: float = 0.8
    down_threshold: float = 0.2
    hysteresis_ticks: int = 3
    cooldown_ms: float = 5000.0
    tick_ms: float = 500.0

    @classmethod
    def from_env(cls, default_min: int = 1,
                 default_max: Optional[int] = None) -> "ElasticConfig":
        mn = envknobs.env_int("PIO_FLEET_MIN_REPLICAS", default_min, lo=1)
        mx = envknobs.env_int(
            "PIO_FLEET_MAX_REPLICAS",
            default_max if default_max is not None else max(mn, 2), lo=1)
        up = min(envknobs.env_float("PIO_SCALE_UP_THRESHOLD", 0.8,
                                    lo=0.01), 1.0)
        down = envknobs.env_float("PIO_SCALE_DOWN_THRESHOLD", 0.2, lo=0.0)
        return cls(
            min_replicas=mn,
            max_replicas=max(mx, mn),
            up_threshold=up,
            down_threshold=min(down, up),
            hysteresis_ticks=envknobs.env_int(
                "PIO_SCALE_HYSTERESIS_TICKS", 3, lo=1),
            cooldown_ms=envknobs.env_float(
                "PIO_SCALE_COOLDOWN_MS", 5000.0, lo=0.0),
            tick_ms=envknobs.env_float("PIO_SCALE_TICK_MS", 500.0,
                                       lo=50.0),
        )

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ReplicaSample:
    """One replica's telemetry at one tick, as the front sees it."""

    slot: int
    alive: bool = False
    ready: bool = False
    draining: bool = False
    pending: int = 0
    pending_limit: int = 0
    #: sheds observed since the PREVIOUS tick (counter delta, not the
    #: process-lifetime total — a replica that shed once an hour ago
    #: must not vote scale-up forever)
    shed_delta: int = 0

    def utilization(self) -> float:
        if self.pending_limit <= 0:
            return 0.0
        return self.pending / float(self.pending_limit)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Decision:
    """One tick's verdict. ``direction`` is what the caller should DO
    (``hold`` when gated); ``gates`` names what held an up/down
    recommendation back (hysteresis, cooldown) so ``pio fleet plan``
    can show the difference between "nothing to do" and "waiting"."""

    direction: str  # "up" | "down" | "hold"
    reason: str
    target: int
    slot: Optional[int] = None  # the replica a scale-down drains
    utilization: float = 0.0
    shed_delta: int = 0
    actual: int = 0
    gates: tuple = ()

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["gates"] = list(self.gates)
        d["utilization"] = round(self.utilization, 4)
        return d


# ---------------------------------------------------------------------------
# the decision function (pure — `pio fleet plan` runs it in the CLI process)
# ---------------------------------------------------------------------------

def _signals(samples: Sequence[ReplicaSample]):
    active = [s for s in samples if s.alive and not s.draining]
    ready = [s for s in active if s.ready]
    util = max((s.utilization() for s in ready), default=0.0)
    shed = sum(max(0, s.shed_delta) for s in samples)
    return active, ready, util, shed


def _drain_candidate(ready: Sequence[ReplicaSample]) -> Optional[int]:
    """Least-loaded ready replica; ties break toward the HIGHEST slot
    so slot 0 (the canary seat) stays populated when load is equal."""
    if not ready:
        return None
    return min(ready, key=lambda s: (s.pending, -s.slot)).slot


def _recommend(samples: Sequence[ReplicaSample],
               cfg: ElasticConfig) -> Decision:
    """The un-damped recommendation for one snapshot."""
    active, ready, util, shed = _signals(samples)
    actual = len(active)
    if actual < cfg.min_replicas:
        return Decision("up", "floor", target=actual + 1,
                        utilization=util, shed_delta=shed, actual=actual)
    pressure = shed > 0 or util >= cfg.up_threshold
    if pressure:
        if actual < cfg.max_replicas:
            return Decision("up", "shed" if shed > 0 else "utilization",
                            target=actual + 1, utilization=util,
                            shed_delta=shed, actual=actual)
        return Decision("hold", "at-max", target=actual,
                        utilization=util, shed_delta=shed, actual=actual)
    if util <= cfg.down_threshold and shed == 0 \
            and actual > cfg.min_replicas:
        if len(ready) < len(active):
            # mid-scale: a spawned replica has not probed ready yet.
            # Draining now would pick the only READY replica (the
            # newcomer is ineligible), cancel the scale-up it is
            # settling, and leave a window with nothing routable —
            # the up/down flap this hold exists to break.
            return Decision("hold", "settling", target=actual,
                            utilization=util, shed_delta=shed,
                            actual=actual)
        slot = _drain_candidate(ready)
        if slot is not None:
            return Decision("down", "quiet", target=actual - 1,
                            slot=slot, utilization=util, shed_delta=shed,
                            actual=actual)
        return Decision("hold", "no-ready-candidate", target=actual,
                        utilization=util, shed_delta=shed, actual=actual)
    return Decision("hold", "steady", target=actual, utilization=util,
                    shed_delta=shed, actual=actual)


def plan(samples: Sequence[ReplicaSample],
         cfg: ElasticConfig) -> Decision:
    """What the scaler WOULD do from this snapshot with hysteresis and
    cooldown satisfied — the dry-run entry ``pio fleet plan`` prints.
    Pure: no state is read or written, nothing acts."""
    return _recommend(samples, cfg)


class ElasticController:
    """The damped loop: feed it one sample list per tick via
    :meth:`observe`, act on ``up``/``down`` decisions, and confirm each
    act with :meth:`record_action` (which starts the cooldown, resets
    the hysteresis counters, bumps the scale-events metric, and appends
    to the decision log the directive payload carries)."""

    def __init__(self, cfg: ElasticConfig):
        self.cfg = cfg
        self.decisions: list[dict] = []  # acted decisions, newest last
        self.last_decision: Optional[Decision] = None
        self.last_action_at: Optional[float] = None  # monotonic
        self._over = 0
        self._under = 0

    def observe(self, samples: Sequence[ReplicaSample],
                now: Optional[float] = None) -> Decision:
        now = time.monotonic() if now is None else now
        rec = _recommend(samples, self.cfg)
        gates: list[str] = []
        if rec.direction == "up":
            self._under = 0
            self._over += 1
            # a fleet below its floor is failing NOW — no hysteresis
            need = 1 if rec.reason == "floor" else self.cfg.hysteresis_ticks
            if self._over < need:
                gates.append("hysteresis")
        elif rec.direction == "down":
            self._over = 0
            self._under += 1
            if self._under < self.cfg.hysteresis_ticks:
                gates.append("hysteresis")
        else:
            self._over = self._under = 0
        if rec.direction != "hold" and self.last_action_at is not None \
                and (now - self.last_action_at) * 1000.0 \
                < self.cfg.cooldown_ms:
            gates.append("cooldown")
        if gates:
            rec = dataclasses.replace(rec, direction="hold",
                                      gates=tuple(gates))
        self.last_decision = rec
        return rec

    def record_action(self, decision: Decision,
                      now: Optional[float] = None) -> dict:
        """Confirm an acted up/down decision; returns the JSON payload
        the caller hands to the coordinator's fenced directive write."""
        now = time.monotonic() if now is None else now
        self.last_action_at = now
        self._over = self._under = 0
        events_c, target_g = _metrics()
        events_c.labels(decision.direction, decision.reason).inc()
        target_g.set(float(decision.target))
        entry = {**decision.to_json(), "at": time.time()}
        self.decisions.append(entry)
        del self.decisions[:-16]
        return entry


# ---------------------------------------------------------------------------
# the scraper (front-side; hand-rolled like splice.probe_ready so the
# front needs no HTTP client stack)
# ---------------------------------------------------------------------------

async def sample_status(host: str, port: int,
                        timeout: float = 2.0) -> Optional[dict]:
    """``GET /status`` against one replica, parsed JSON or None. The
    request carries ``Connection: close`` so the body is simply
    everything after the header block."""
    try:
        r, w = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout)
    except (OSError, asyncio.TimeoutError):
        return None
    try:
        w.write(b"GET /status HTTP/1.1\r\nHost: front\r\n"
                b"Connection: close\r\n\r\n")
        await w.drain()
        raw = await asyncio.wait_for(r.read(), timeout)
    except (ConnectionError, OSError, asyncio.TimeoutError,
            asyncio.IncompleteReadError):
        return None
    finally:
        try:
            w.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
    head, sep, body = raw.partition(b"\r\n\r\n")
    if not sep or b" 200" not in head.split(b"\r\n", 1)[0]:
        return None
    try:
        return json.loads(body.decode("utf-8", errors="replace"))
    except ValueError:
        return None
