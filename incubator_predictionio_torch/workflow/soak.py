""""Production day" soak: ONE scenario driver that runs the whole story
under SLOs.

Port of ``incubator_predictionio_tpu/workflow/soak.py`` on the port's
console. Every subsystem has its own chaos harness (WAL crash replay, gang
kill, mid-compaction SIGKILL, poisoned retrain and fold-in, fleet canary
rollback); this driver exercises them TOGETHER: it launches the REAL
topology as subprocesses of ``python -m incubator_predictionio_torch.
tools.console`` (the partitioned event server ``--workers N``, the engine
fleet ``pio deploy --replicas N`` with ``--online-foldin``, or one engine
process with ``--model-refresh-ms``), runs zipfian multi-app open-loop
traffic (ingest floods of singles and batches, enqueue and commit acks
through ``X-Pio-Ack``, interleaved with deadline-carrying queries) for a
wall budget while a fault scheduler injects the fault menu on a seeded
timeline (``PIO_FAULT_SPEC`` ``at:`` rules per worker or replica, plus
driver-side poison events and retrains), then grades end-to-end SLOs from
the telemetry (driver-side scrapes of both fronts' ``/metrics`` and
``/status``) and the stores:

- **zero acked-event loss**: every event the flood got a 201 for is
  present EXACTLY once in the merged shards after the WAL settles (the
  exactly-once ledger, reconciled offline)
- **zero non-{200,503,504}** HTTP responses (201 is ingest's 200)
- **accepted-query p99** under a bound
- **rollback within the watch window** for every poisoned publish
- **quality regression rolled back**: the shadow scorer graded real
  traffic, and a gate-passing, non-erroring, ranking-degrading publish
  (``poison_quality``) was rolled back with an explicit ``quality`` pin
  inside the window
- **fold-in freshness lag** under ``freshness_factor`` × the fold-in
  interval once traffic quiesces
- **clean drain**: both fronts exit 0 on SIGTERM

The scorecard (``SOAK.json``, and with ``baseline_key`` a
``measured_soak_*`` row in the BASELINE.json beside it) carries the
scenario seed, so any red soak replays: the zipfian generators AND the
fault timeline derive from one ``--seed``.

What differs from the reference: ``SoakConfig.device`` (``"cuda"`` unless
``"cpu"`` is asked for) goes to every ``train`` and ``deploy`` the driver
spawns, as the port's device rule wants (the event server runs no device
code and takes no device); the HTTP clients are the standard library's
(the card host has no ``requests``), with the same keep-alive sessions and
the same connection-error accounting; the scraper also reads each event
worker's and each engine replica's ``/metrics`` at the address its
front's ``/healthz`` lists (a front scrape reaches one backend: one
worker's ENOSPC counter, or the quality breach of the replica that
canaried a poisoned increment, could go unseen); the driver imports
neither torch nor jax; and
the scorecard also lists each spawned train's solve-kernel launches
(``trains``) and the recovery seconds (``recovery``).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import os
import random
import re
import select
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Optional
from urllib.parse import urlsplit

log = logging.getLogger("pio.torch.soak")

__all__ = ["SoakConfig", "SoakPlan", "FaultAction", "SoakRunner",
           "plan_scenario", "run_soak", "evaluate_slos",
           "reconcile_ledger", "write_scorecard", "read_scorecard",
           "SLO_METRICS", "FAULT_POINTS", "FAULT_MENU"]

# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

# telemetry families the driver scrapes and asserts fault evidence /
# SLO inputs from
SLO_METRICS = (
    "pio_ingest_events_total",
    "pio_ingest_append_errors_total",
    "pio_engine_rollbacks_total",
    "pio_fleet_rollbacks_total",
    "pio_foldin_publishes_total",
    "pio_foldin_rollbacks_total",
    "pio_foldin_freshness_lag_seconds",
    "pio_engine_quality_samples_total",
    "pio_engine_quality_breaches_total",
    "pio_query_cache_hits_total",
    "pio_query_cache_misses_total",
    "pio_query_cache_invalidations_total",
    "pio_tenant_shed_total",
    "pio_tenant_evictions_total",
    "pio_tenant_rollbacks_total",
    "pio_fleet_scale_events_total",
)

# spec-armed scenario faults → the fault POINT their PIO_FAULT_SPEC
# rule names (each is a fault point of the port: ingest_buffer.py,
# event_log.py, jsonl.py, controller/engine.py)
FAULT_POINTS = {
    "worker_kill": "ingest.commit",
    "compact_crash": "compact.rename",
    "enospc_shed": "jsonl.append",
    "replica_kill": "query.serve",
}

# the full menu: spec faults above + driver-side scenario actions
# (poison events ride the data, retrains ride `pio train`)
FAULT_MENU = (
    "enospc_shed",      # scheduled OSError(ENOSPC) on one worker's log
    "poison_foldin",    # poison-serve event → increment rolls back
    "worker_kill",      # SIGKILL inside a group commit (WAL replay)
    "replica_kill",     # SIGKILL one replica mid-query (fleet only)
    "good_retrain",     # ordinary retrain → staged rollout/hot swap
    "compact_crash",    # SIGKILL inside a compaction rename
    "poison_retrain",   # gate-passing poisoned retrain → watch rollback
    "poison_quality",   # poison-rank event → non-erroring ranking
    #                     degradation; the QUALITY watch rolls it back
)

# where each fault lands inside the wall budget (fractions): rollback-
# sensitive faults stay early enough that their watch windows settle
_FAULT_WINDOWS = {
    "enospc_shed": (0.10, 0.20),
    "poison_foldin": (0.18, 0.30),
    "worker_kill": (0.30, 0.40),
    "replica_kill": (0.38, 0.48),
    "good_retrain": (0.45, 0.55),
    "compact_crash": (0.50, 0.60),
    "poison_retrain": (0.58, 0.66),
    # last: the degraded chain stays refused until the wall ends, so
    # nothing downstream should depend on fresh promotions
    "poison_quality": (0.66, 0.74),
}

# catalog size for the zipfian item popularity the floods rate against:
# ranking popular items first is MEASURABLY better than ranking them
# last, which is what gives the shadow scorer its NDCG signal
_ITEMS = 50


# ---------------------------------------------------------------------------
# config + plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SoakConfig:
    """One scenario. Everything observable derives from ``seed``."""

    engine_dir: str
    workdir: str
    seed: int = 20260804
    duration_s: float = 60.0
    event_workers: int = 2
    replicas: int = 2             # 0 = single-process engine server
    apps: int = 3
    primary_app: Optional[str] = None   # default: engine.json appName
    users: int = 400
    zipf_s: float = 1.1           # app/user popularity skew
    ingest_rps: float = 50.0      # offered, across all apps
    query_rps: float = 20.0
    batch_every: int = 8          # every Nth ingest is a batch POST
    batch_size: int = 6
    enqueue_frac: float = 0.5     # singles acked on enqueue vs commit
    query_deadline_ms: float = 8000.0
    foldin_ms: float = 250.0
    refresh_ms: float = 500.0     # single-process refresh poll
    swap_watch_ms: float = 2500.0
    swap_max_error_rate: float = 0.3
    # shadow scorer: every query sampled; the quality watch outlives
    # the error watch so the resolve pipeline (labels tail in, samples
    # age past the resolve window) fits inside it on a starved host
    quality_sample: float = 1.0
    quality_watch_ms: float = 6000.0
    # million-item serving: queries run with the served-
    # result cache armed and the host-shard threshold set, so the
    # kill/poison timeline fires AGAINST cached results — the
    # cache-freshness SLO row asserts rollbacks never left stale
    # entries serving. catalog_items widens the item universe the
    # floods rate against (zipf keeps the popularity head, so the
    # shadow scorer's NDCG signal survives a large catalog).
    catalog_items: int = _ITEMS
    query_cache_size: int = 256
    query_cache_ttl_ms: float = 30000.0
    serve_shard_items: int = 131072
    # multi-tenant serving: tenant_apps > 0 widens the app
    # universe to that many apps, trains EVERY app its own instance,
    # arms the engine's tenant mux (PIO_TENANT_MAX_RESIDENT) and
    # routes the query flood zipfian across all apps via X-Pio-App —
    # the `tenant-isolation` SLO row grades per-tenant availability
    # (a hot tenant's shed never reds a cold tenant's row) and that
    # the resident LRU actually churned. tenant_max_resident 0 = auto:
    # half the apps, min 2 — always smaller than the app count, so
    # evictions are guaranteed load-bearing, not incidental.
    tenant_apps: int = 0
    tenant_max_resident: int = 0
    # elastic topology: elastic=True deploys the engine
    # with `--replicas auto` and arms a RAMP phase — offered query
    # load steps ramp_factor× up at ~30% of the wall budget and back
    # down at ~65% — so the autoscaler is graded under a real load
    # step, both directions: `scale-up-within-bound` (a new replica
    # READY within scale_up_bound_s of the step) and `drain-on-quiet`
    # (fleet back at the floor within scale_down_bound_s of the load
    # going away, drained with zero non-{200,503,504})
    elastic: bool = False
    ramp_factor: float = 10.0
    ramp_up_frac: float = 0.30
    ramp_down_frac: float = 0.65
    scale_up_bound_s: float = 30.0
    scale_down_bound_s: float = 45.0
    elastic_max: int = 3          # PIO_FLEET_MAX_REPLICAS (min is 1)
    fleet_sync_ms: float = 200.0
    compact_interval_ms: float = 2000.0
    faults: tuple = FAULT_MENU
    # SLO thresholds
    p99_ms: float = 4000.0
    rollback_deadline_s: float = 30.0
    freshness_factor: float = 2.0
    freshness_settle_s: float = 20.0
    max_conn_errors: Optional[int] = None   # None → auto from kill count
    drain_timeout_s: float = 90.0
    ready_timeout_s: float = 120.0
    keep_workdir: bool = False
    out_path: Optional[str] = None          # default <cwd>/SOAK.json
    baseline_key: Optional[str] = None      # publish measured_soak_<key>
    env_extra: dict = dataclasses.field(default_factory=dict)
    # where every spawned train and deploy runs: the card unless the CPU
    # is asked for (the port's device rule)
    device: str = "cuda"


@dataclasses.dataclass
class FaultAction:
    """One scheduled fault: either a PIO_FAULT_SPEC ``at:`` rule armed
    on a worker/replica at launch, or a driver-side action fired by the
    scheduler thread at ``at_s`` past traffic start."""

    name: str
    kind: str                    # "spec" | "event" | "train"
    at_s: float
    point: Optional[str] = None  # spec faults: the fault point named
    target: Optional[str] = None # "worker:<i>" | "replica:<i>" | app
    spec: Optional[str] = None   # the PIO_FAULT_SPEC rule text
    detail: str = ""


@dataclasses.dataclass
class SoakPlan:
    cfg: SoakConfig
    app_names: list
    app_weights: list            # zipfian popularity over apps
    user_weights: list
    item_weights: list           # zipfian item popularity (NDCG signal)
    faults: list                 # [FaultAction]
    worker_specs: dict           # worker idx -> joined spec string
    replica_specs: dict          # replica idx -> joined spec string
    notes: list
    slos: dict                   # name -> bound (threshold snapshot)
    conn_budget: int = 0         # resolved once; the evaluator asserts
    #                              the SAME bound the dry run printed
    ramp: Optional[dict] = None  # elastic load step: {upAtS, downAtS,
    #                              factor, min, max}

    def describe(self) -> str:
        """The resolved scenario, human-readable (``--dry-run``)."""
        cfg = self.cfg
        lines = [
            f"Soak scenario (seed {cfg.seed}, {cfg.duration_s:.0f}s "
            "wall budget)",
            f"  topology: event server --workers {cfg.event_workers} "
            "(WAL on, compaction every "
            f"{cfg.compact_interval_ms:.0f}ms); engine "
            + (f"fleet --replicas auto [1, {max(2, cfg.elastic_max)}]"
               if cfg.elastic
               else f"fleet --replicas {cfg.replicas}" if cfg.replicas
               else "single process")
            + f", fold-in every {cfg.foldin_ms:.0f}ms, watch "
              f"{cfg.swap_watch_ms:.0f}ms",
            f"  apps: {', '.join(self.app_names)} (zipf s={cfg.zipf_s}"
            f", {cfg.users} users)",
            f"  traffic: ingest {cfg.ingest_rps:.0f}/s offered "
            f"(batch every {cfg.batch_every}, size {cfg.batch_size}, "
            f"{cfg.enqueue_frac:.0%} enqueue-acked), queries "
            f"{cfg.query_rps:.0f}/s with "
            f"{cfg.query_deadline_ms:.0f}ms deadlines",
            f"  serving: {cfg.catalog_items} items (host shards past "
            f"{cfg.serve_shard_items} rows); result cache "
            + (f"{cfg.query_cache_size} entries, TTL "
               f"{cfg.query_cache_ttl_ms:.0f}ms" if cfg.query_cache_size
               else "off"),
            *([f"  tenants: mux armed — {len(self.app_names)} apps "
               f"through one process, {_tenant_resident(cfg)} resident "
               "(X-Pio-App routed, per-app instances trained up front)"]
              if cfg.tenant_apps else []),
            "  phases: workspace+train -> launch+ready -> "
            f"{cfg.duration_s:.0f}s mixed load under faults -> "
            f"quiesce (freshness settle <= {cfg.freshness_settle_s:.0f}s)"
            " -> SIGTERM drain -> offline ledger reconcile -> scorecard",
            "  fault timeline:",
        ]
        for f in sorted(self.faults, key=lambda f: f.at_s):
            where = f" on {f.target}" if f.target else ""
            point = f" [{f.point}]" if f.point else ""
            lines.append(f"    t+{f.at_s:6.1f}s  {f.name}{where}"
                         f"{point}  ({f.kind}) {f.detail}")
        lines.append("  SLOs:")
        for name, bound in self.slos.items():
            lines.append(f"    {name}: {bound}")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)


def _engine_json_app(engine_dir: str) -> Optional[str]:
    """The datasource appName the template trains/queries/folds on:
    that app is the scenario's PRIMARY (queries + poisons target it;
    the other apps are ingest-only background load)."""
    try:
        with open(os.path.join(engine_dir, "engine.json")) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    params = (doc.get("datasource") or {}).get("params") or {}
    return params.get("appName") or params.get("app_name") or None


def _conn_budget(cfg: SoakConfig, kills: int) -> int:
    """Connection-drop allowance: each crash fault opens a kill window
    (relaunch + WAL replay, ~5 s on a starved host) during which the
    open-loop floods keep offering — the budget scales with offered
    rate so it catches systemic connection failure, not TCP reality."""
    if cfg.max_conn_errors is not None:
        return cfg.max_conn_errors
    per_kill = int((cfg.ingest_rps + cfg.query_rps) * 5.0)
    return 20 + per_kill * max(1, kills)


def _tenant_resident(cfg: SoakConfig) -> int:
    """The resolved PIO_TENANT_MAX_RESIDENT bound (0 = mux off)."""
    if cfg.tenant_apps <= 0:
        return 0
    return cfg.tenant_max_resident or max(2, cfg.tenant_apps // 2)


def _zipf_weights(n: int, s: float, rng: random.Random) -> list:
    w = [1.0 / (i + 1) ** s for i in range(n)]
    rng.shuffle(w)
    total = sum(w)
    return [x / total for x in w]


def plan_scenario(cfg: SoakConfig) -> SoakPlan:
    """Resolve a config into the deterministic scenario: app/user
    popularity, the fault timeline with per-process spec assignments,
    and the SLO threshold snapshot. Same seed → same plan."""
    rng = random.Random(cfg.seed)
    primary = cfg.primary_app or _engine_json_app(cfg.engine_dir) \
        or "soak_a0"
    n_apps = max(cfg.apps, cfg.tenant_apps) if cfg.tenant_apps \
        else cfg.apps
    app_names = [primary] + [f"soak_a{i}" for i in range(1, n_apps)]
    app_weights = _zipf_weights(n_apps, cfg.zipf_s, rng)
    user_weights = _zipf_weights(cfg.users, cfg.zipf_s, rng)
    item_weights = _zipf_weights(max(1, cfg.catalog_items), cfg.zipf_s,
                                 rng)
    notes: list = []
    faults: list = []

    def offset(name: str) -> float:
        lo, hi = _FAULT_WINDOWS[name]
        return round(cfg.duration_s * rng.uniform(lo, hi), 1)

    requested = [f for f in cfg.faults if f in FAULT_MENU]
    for f in cfg.faults:
        if f not in FAULT_MENU:
            notes.append(f"unknown fault {f!r} dropped")
    if "replica_kill" in requested and (cfg.replicas < 2 or cfg.elastic):
        requested.remove("replica_kill")
        notes.append("replica_kill dropped: needs --replicas >= 2 "
                     "(a 0/1-replica deploy has no survivor to serve "
                     "through the kill)" if not cfg.elastic else
                     "replica_kill dropped: elastic membership is "
                     "dynamic — a launch-time spec cannot target a "
                     "slot the autoscaler owns")

    # spec faults are grouped per target process; a first-launch
    # process dies at its FIRST crash rule (restarts come up clean), so
    # the planner gives each crash fault its own worker when it can and
    # drops the extras loudly when it cannot
    worker_specs: dict = {}
    replica_specs: dict = {}
    crash_worker = 0

    for name in requested:
        at_s = offset(name)
        if name == "enospc_shed":
            w = cfg.event_workers - 1       # keep worker 0 for crashes
            rule = f"jsonl.append:at:{at_s * 1000:.0f}:oserr:28"
            worker_specs[w] = (worker_specs.get(w, "") + ";" + rule).strip(";")
            faults.append(FaultAction(
                name, "spec", at_s, point=FAULT_POINTS[name],
                target=f"worker:{w}", spec=rule,
                detail="one append fails ENOSPC → 503 shed window, "
                       "half-open recovery"))
        elif name in ("worker_kill", "compact_crash"):
            if crash_worker >= cfg.event_workers:
                notes.append(f"{name} dropped: every first-launch "
                             "worker already carries a crash rule "
                             "(one crash per process)")
                continue
            w = crash_worker
            crash_worker += 1
            point = FAULT_POINTS[name]
            rule = f"{point}:at:{at_s * 1000:.0f}:crash"
            worker_specs[w] = (worker_specs.get(w, "") + ";" + rule).strip(";")
            faults.append(FaultAction(
                name, "spec", at_s, point=point, target=f"worker:{w}",
                spec=rule,
                detail=("SIGKILL inside a group commit → supervisor "
                        "relaunch + WAL replay" if name == "worker_kill"
                        else "SIGKILL inside the compaction rename → "
                             "old snapshot stays active, rerun "
                             "converges")))
        elif name == "replica_kill":
            r = cfg.replicas - 1    # replica 0 is producer AND canary
            rule = f"query.serve:at:{at_s * 1000:.0f}:crash"
            replica_specs[r] = (replica_specs.get(r, "") + ";"
                                + rule).strip(";")
            faults.append(FaultAction(
                name, "spec", at_s, point=FAULT_POINTS[name],
                target=f"replica:{r}", spec=rule,
                detail="SIGKILL mid-query under flood → front routes "
                       "around it, supervisor relaunches"))
        elif name == "poison_foldin":
            app = app_names[0]
            faults.append(FaultAction(
                name, "event", at_s, target=app,
                detail="poison-serve event → gate-passing increment "
                       "rolls back through the watch, pinned"))
        elif name == "good_retrain":
            faults.append(FaultAction(
                name, "train", at_s,
                detail="ordinary retrain → staged canary/hot swap "
                       "promotes under live fire"))
        elif name == "poison_retrain":
            faults.append(FaultAction(
                name, "train", at_s, target=app_names[0],
                detail="poison-train event + retrain → gate passes, "
                       "watch rolls back + pins fleet-wide"))
        elif name == "poison_quality":
            faults.append(FaultAction(
                name, "event", at_s, target=app_names[0],
                detail="poison-rank event → gate-passing, NON-erroring "
                       "increment that ranks worst-first; only the "
                       "quality watch can catch it (reason `quality`). "
                       "No antidote: the poison rides ONE event, "
                       "consumed once by the fold-in cursor"))

    kills = sum(1 for f in faults if "kill" in f.name
                or f.name == "compact_crash")
    conn_budget = _conn_budget(cfg, kills)
    slos = {
        "acked-event-loss": "0 lost, 0 duplicated (exactly-once ledger"
                            " vs merged shards + WAL)",
        "http-codes": "ingest ⊆ {201,503}; query ⊆ {200,503,504}",
        "query-p99": f"accepted p99 <= {cfg.p99_ms:.0f}ms",
        "rollback-window": "every poisoned publish rolled back within "
                           f"{cfg.rollback_deadline_s:.0f}s",
        "quality-regression": (
            f"shadow scorer sampled live traffic "
            f"({cfg.quality_sample:.0%} of queries) and every quality "
            "poison was rolled back with reason `quality` within "
            f"{cfg.rollback_deadline_s:.0f}s"),
        "foldin-freshness": "settled lag <= "
                            f"{cfg.freshness_factor:.1f}x fold-in "
                            f"interval ({cfg.foldin_ms:.0f}ms)",
        "conn-errors": f"<= {conn_budget} connection-level drops "
                       "(kill-window TCP reality)",
        "clean-drain": "both fronts exit 0 on SIGTERM inside "
                       f"{cfg.drain_timeout_s:.0f}s",
        "cache-freshness": (
            f"armed result cache ({cfg.query_cache_size} entries, TTL "
            f"{cfg.query_cache_ttl_ms:.0f}ms) saw traffic and every "
            "rollback observation was covered by a cache invalidation "
            "event — no stale cached results after rollback"
            if cfg.query_cache_size > 0 else "cache disabled"),
    }
    if cfg.tenant_apps:
        bound = _tenant_resident(cfg)
        slos["tenant-isolation"] = (
            f"every offered tenant answered 200 ({n_apps} apps through "
            f"ONE engine process, X-Pio-App routed); a hot tenant's "
            f"503 shed never reds a cold tenant's row; resident LRU "
            f"bound {bound} < {n_apps} apps → evictions observed")
        notes.append(
            f"multi-tenant: {n_apps} apps, PIO_TENANT_MAX_RESIDENT="
            f"{bound}; the query flood's first sweep visits every app "
            "in order (guaranteed coverage + LRU churn), then goes "
            "zipfian")
    ramp = None
    if cfg.elastic:
        ramp = {
            "upAtS": round(cfg.duration_s * cfg.ramp_up_frac, 1),
            "downAtS": round(cfg.duration_s * cfg.ramp_down_frac, 1),
            "factor": cfg.ramp_factor,
            "min": 1,
            "max": max(2, cfg.elastic_max),
        }
        slos["scale-up-within-bound"] = (
            f"a replica beyond the floor READY within "
            f"{cfg.scale_up_bound_s:.0f}s of the {cfg.ramp_factor:.0f}x "
            f"load step at t+{ramp['upAtS']:.0f}s")
        slos["drain-on-quiet"] = (
            f"fleet back at the floor ({ramp['min']}) within "
            f"{cfg.scale_down_bound_s:.0f}s of the step-down at "
            f"t+{ramp['downAtS']:.0f}s — drained, never killed "
            "(non-{200,503,504} already reds http-codes)")
        notes.append(
            f"elastic: --replicas auto, bounds [1, {ramp['max']}]; the "
            "query flood multiplies its offered rate by "
            f"{cfg.ramp_factor:.0f} between t+{ramp['upAtS']:.0f}s and "
            f"t+{ramp['downAtS']:.0f}s; PIO_QUERY_MAX_PENDING is "
            "pinned low so the step is visible as utilization")
    notes.append("observations are scraped through quiesce: rollback "
                 "pins and fault evidence landing after the wall "
                 "budget (starved-host double-load) still count")
    return SoakPlan(cfg=cfg, app_names=app_names,
                    app_weights=app_weights, user_weights=user_weights,
                    item_weights=item_weights,
                    faults=faults, worker_specs=worker_specs,
                    replica_specs=replica_specs, notes=notes, slos=slos,
                    conn_budget=conn_budget, ramp=ramp)


# ---------------------------------------------------------------------------
# ledger + scrape state (shared, lock-guarded)
# ---------------------------------------------------------------------------

class _Ledger:
    """Everything the traffic threads observed, reconciled offline."""

    def __init__(self):
        self.lock = threading.Lock()
        self.acked: list = []         # (app, marker, event_id, mode)
        self.unacked: list = []       # (app, marker, why) — ambiguous
        self.ingest_codes: dict = {}
        self.query_codes: dict = {}
        self.latencies: list = []     # accepted (200) query seconds
        self.ingest_conn_errors = 0
        self.query_conn_errors = 0
        self.sent = 0
        self.violations: list = []    # first N non-contract responses
        self.tenant_codes: dict = {}  # app -> {code: n} (mux runs)

    _OK = {"ingest": (201, 503), "query": (200, 503, 504)}

    def code(self, table: str, code: int, t_off: float = -1.0,
             body: str = "") -> None:
        with self.lock:
            d = self.ingest_codes if table == "ingest" else self.query_codes
            d[code] = d.get(code, 0) + 1
            if code not in self._OK[table] and len(self.violations) < 10:
                # a red http-codes SLO must be diagnosable from the
                # scorecard: keep when/what for the first offenders
                self.violations.append(
                    {"table": table, "code": code,
                     "atS": round(t_off, 1), "body": body[:300]})

    def tenant_code(self, app: str, code: int) -> None:
        """Per-tenant response census (multi-tenant runs): the
        tenant-isolation SLO grades each app's OWN availability off
        this, so one hot tenant's shed cannot red a cold tenant."""
        with self.lock:
            d = self.tenant_codes.setdefault(app, {})
            d[code] = d.get(code, 0) + 1


class _Samples:
    """Driver-side scraper state: /status + /metrics samples from both
    fronts, keyed max() for counters, plus rollback / served-instance
    observations stamped with seconds past traffic start."""

    def __init__(self):
        self.lock = threading.Lock()
        self.metric_max: dict = {}    # "family{labels}" -> max value
        self.rollback_seen: list = [] # (t_off_s, key, detail)
        self.served: list = []        # (t_off_s, instance_id)
        self.foldin_lag: list = []    # (t_off_s, lag_seconds)
        self.foldin_publishes = 0
        self.restarts: dict = {}      # "replica:<i>" -> max restarts
        self.fleet_size: list = []    # (t_off_s, active, ready, target)
        self.query_cache: dict = {}   # /status queryCache counters, max
        self.tenants: dict = {}       # /status tenants doc, latest
        self._rollback_keys: set = set()

    def note_metrics(self, text: str) -> None:
        with self.lock:
            for name, value in _parse_prometheus(text):
                if value > self.metric_max.get(name, float("-inf")):
                    self.metric_max[name] = value

    def note_rollback(self, t_off: float, key: str, detail: str) -> None:
        with self.lock:
            if key in self._rollback_keys:
                return
            self._rollback_keys.add(key)
            self.rollback_seen.append((t_off, key, detail))


_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?)\s+([0-9eE+.\-]+)\s*$")


def _parse_prometheus(text: str):
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _PROM_LINE.match(line.strip())
        if m:
            try:
                yield m.group(1), float(m.group(2))
            except ValueError:
                continue


# ---------------------------------------------------------------------------
# HTTP (the standard library: the card host has no `requests`)
# ---------------------------------------------------------------------------

class _ConnError(OSError):
    """A request that got no HTTP response (refused, reset, timed out, a
    connection dropped mid-exchange): the traffic loops count it as a
    connection-level drop, as the reference counts requests' errors."""


class _Response:
    def __init__(self, status: int, content: bytes):
        self.status_code = status
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self):
        return json.loads(self.content)


class _Session:
    """A keep-alive client of one ``http://host:port`` (like a requests
    Session): one connection reused until a failure or the server's close;
    a pooled connection the peer dropped while idle is replaced before it
    is reused, never written into."""

    def __init__(self, base: str):
        u = urlsplit(base)
        self.host, self.port = u.hostname or "127.0.0.1", u.port or 80
        self._conn: Optional[http.client.HTTPConnection] = None

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _connection(self, timeout: float) -> http.client.HTTPConnection:
        conn = self._conn
        if conn is not None and conn.sock is not None:
            # readable while idle = the peer closed (or sent junk)
            if select.select([conn.sock], [], [], 0)[0]:
                self.close()
                conn = None
            else:
                conn.sock.settimeout(timeout)
        if conn is None:
            conn = self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=timeout)
        return conn

    def request(self, method: str, url: str, *, json_body=None,
                headers: Optional[dict] = None,
                timeout: float = 5.0) -> _Response:
        u = urlsplit(url)
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        data = None
        hdrs = dict(headers or {})
        if json_body is not None:
            data = json.dumps(json_body).encode()
            hdrs["Content-Type"] = "application/json"
        conn = self._connection(timeout)
        try:
            conn.request(method, path, body=data, headers=hdrs)
            r = conn.getresponse()
            content = r.read()
        except (OSError, http.client.HTTPException) as e:
            self.close()
            raise _ConnError(f"{method} {path}: {e!r}") from e
        if r.will_close:
            self.close()
        return _Response(r.status, content)

    def post(self, url: str, json=None, headers: Optional[dict] = None,
             timeout: float = 5.0) -> _Response:
        return self.request("POST", url, json_body=json, headers=headers,
                            timeout=timeout)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host_loop_mops() -> float:
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i
    return 2.0 / (time.perf_counter() - t0)


class SoakRunner:
    """One soak run: workspace → topology → traffic + faults →
    quiesce → drain → reconcile → scorecard."""

    def __init__(self, plan: SoakPlan):
        self.plan = plan
        self.cfg = plan.cfg
        self.ledger = _Ledger()
        self.samples = _Samples()
        self.stop = threading.Event()
        # deploy freeze: while set, ingest skips the PRIMARY app so a
        # retrain is not leapfrogged by ever-newer fold-in increments
        # (the producer commits one per tick under load — "newest
        # COMPLETED wins" means sustained freshness starves retrains);
        # background apps and ALL queries continue at full rate
        self.pause_primary = threading.Event()
        # the scraper outlives `stop`: it keeps observing through
        # quiesce so rollback pins / fault evidence that land after
        # the wall budget (starved-host double-load) still count
        self.scrape_stop = threading.Event()
        self.procs: dict = {}
        self.logs: dict = {}
        self.app_ids: dict = {}
        self.access_keys: dict = {}
        self.instances: dict = {}     # label -> instance id
        self.trains: list = []        # each spawned train's report
        self.fault_log: list = []     # scheduler's fired actions
        # elastic ramp: the query loops multiply their offered rate by
        # this each tick (the ramp thread steps it factor× up/down)
        self.rate_mult = 1.0
        self.event_port = _free_port()
        self.engine_port = _free_port()
        self.t0 = 0.0                 # traffic start (monotonic)
        self._storage = None

    # -- workspace ---------------------------------------------------------

    def _base_env(self) -> dict:
        cfg = self.cfg
        wd = cfg.workdir
        env = {
            **os.environ,
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "JL",
            "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(wd, "meta.sqlite"),
            "PIO_STORAGE_SOURCES_JL_TYPE": "JSONL",
            "PIO_STORAGE_SOURCES_JL_PATH": os.path.join(wd, "events"),
            "PIO_FS_BASEDIR": os.path.join(wd, "store"),
            "PIO_WAL": "1",
            "PIO_WAL_FSYNC": "group",
            "PIO_WAL_DIR": os.path.join(wd, "wal"),
            "PIO_COMPACT_INTERVAL_MS": f"{cfg.compact_interval_ms:.0f}",
            "PIO_COMPACT_MIN_BYTES": "1",
            "PIO_FOLDIN_MS": f"{cfg.foldin_ms:.0f}",
            "PIO_SWAP_WATCH_MS": f"{cfg.swap_watch_ms:.0f}",
            # shadow-scored serving: sample everything, small minimum
            # so the thin-traffic gate still clears inside one watch
            "PIO_QUALITY_SAMPLE": f"{cfg.quality_sample}",
            "PIO_QUALITY_WATCH_MS": f"{cfg.quality_watch_ms:.0f}",
            "PIO_QUALITY_MIN_SAMPLES": "5",
            "PIO_QUALITY_RESOLVE_MS": "400",
            "PIO_QUALITY_MS": "100",
            "PIO_SWAP_MAX_ERROR_RATE": f"{cfg.swap_max_error_rate}",
            # million-item serving: cache + host-shard threshold armed
            # so the fault timeline fires against cached results (the
            # cache-freshness SLO row grades the invalidation contract)
            "PIO_QUERY_CACHE_SIZE": f"{cfg.query_cache_size:d}",
            "PIO_QUERY_CACHE_TTL_MS": f"{cfg.query_cache_ttl_ms:.0f}",
            "PIO_SERVE_SHARD_ITEMS": f"{cfg.serve_shard_items:d}",
            "PIO_FLEET_SYNC_MS": f"{cfg.fleet_sync_ms:.0f}",
            "PIO_FLEET_READY_MS": "150",
            # starved-host slack: mid-relaunch workers/replicas and
            # accept-queue droughts retry inside the fronts instead of
            # dropping clients (a starved host's network stack may refuse
            # connects on a starved-but-healthy listener)
            "PIO_FLEET_CONNECT_RETRY_MS": "8000",
            "PIO_EVENT_CONNECT_RETRY_MS": "6000",
        }
        if cfg.tenant_apps:
            # tenant mux armed in every engine process (fleet replicas
            # inherit): one process serves the whole app universe with
            # the resident LRU smaller than it
            env["PIO_TENANT_MAX_RESIDENT"] = str(_tenant_resident(cfg))
        if cfg.elastic:
            # elastic fleet: small pending limit so the ramp's load
            # step reads as utilization (pending/pendingLimit) fast;
            # quick ticks so detect→spawn fits the scale-up bound on a
            # 2-core host
            env["PIO_FLEET_MIN_REPLICAS"] = "1"
            env["PIO_FLEET_MAX_REPLICAS"] = str(max(2, cfg.elastic_max))
            env["PIO_QUERY_MAX_PENDING"] = "8"
            env["PIO_SCALE_TICK_MS"] = "200"
            env["PIO_SCALE_COOLDOWN_MS"] = "1500"
            env["PIO_SCALE_HYSTERESIS_TICKS"] = "2"
        for k in ("PIO_FAULT_SPEC", "PIO_EVENT_WORKER_FAULT_SPEC",
                  "PIO_FLEET_WORKER_FAULT_SPEC"):
            env.pop(k, None)
        env.update({k: str(v) for k, v in self.cfg.env_extra.items()})
        return env

    def storage(self):
        if self._storage is None:
            from ..data.storage.registry import Storage

            env = self._base_env()
            self._storage = Storage({
                k: v for k, v in env.items()
                if k.startswith("PIO_STORAGE")})
        return self._storage

    def _setup_workspace(self) -> None:
        from ..data.storage.base import AccessKey, App
        from ..data.storage.datamap import DataMap
        from ..data.storage.event import Event

        os.makedirs(self.cfg.workdir, exist_ok=True)
        os.makedirs(os.path.join(self.cfg.workdir, "logs"), exist_ok=True)
        s = self.storage()
        le = s.get_l_events()
        rng = random.Random(self.cfg.seed ^ 0x5EED)
        for name in self.plan.app_names:
            app_id = s.get_meta_data_apps().insert(App(0, name))
            le.init(app_id)
            key = s.get_meta_data_access_keys().insert(
                AccessKey("", app_id, ()))
            self.app_ids[name] = app_id
            self.access_keys[name] = key
            # seed ratings so the initial train has signal
            for i in range(8):
                le.insert(Event(
                    event="rate", entity_type="user",
                    entity_id=f"u{rng.randrange(self.cfg.users)}",
                    target_entity_type="item",
                    target_entity_id=f"i{i}",
                    properties=DataMap({"rating": float(i % 5 + 1)})),
                    app_id)

    # -- subprocess topology ----------------------------------------------

    def _console_argv(self, *args) -> list:
        return [sys.executable, "-m",
                "incubator_predictionio_torch.tools.console", *args]

    def _spawn(self, label: str, argv: list, env: dict) -> subprocess.Popen:
        path = os.path.join(self.cfg.workdir, "logs", f"{label}.log")
        f = open(path, "ab")
        self.logs[label] = path
        proc = subprocess.Popen(argv, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
        f.close()
        self.procs[label] = proc
        return proc

    def tail(self, label: str, n: int = 4000) -> str:
        try:
            with open(self.logs[label], "rb") as f:
                return f.read().decode(errors="replace")[-n:]
        except Exception:  # noqa: BLE001 — post-mortem best effort
            return "<no output>"

    def _train(self, label: str, engine_dir: Optional[str] = None) -> str:
        """One `pio train` subprocess against the workspace, on
        ``cfg.device``; returns the COMPLETED instance id parsed from its
        output (its report line, with the solve-kernel launches, joins
        ``self.trains``)."""
        out = subprocess.run(
            self._console_argv("train", "--engine-dir",
                               engine_dir or self.cfg.engine_dir,
                               "--device", self.cfg.device),
            env=self._base_env(), capture_output=True, text=True,
            timeout=300)
        if out.returncode != 0:
            raise RuntimeError(
                f"soak {label} train failed rc={out.returncode}: "
                f"{(out.stdout + out.stderr)[-2000:]}")
        m = re.search(r"Engine instance ID: (\S+)", out.stdout)
        if not m:
            raise RuntimeError(
                f"soak {label} train printed no instance id: "
                f"{out.stdout[-2000:]}")
        self.instances[label] = m.group(1)
        report: dict = {}
        for line in reversed(out.stdout.splitlines()):
            if line.startswith("{"):
                try:
                    report = json.loads(line)
                except ValueError:
                    pass
                break
        self.trains.append({
            "label": label, "instance": m.group(1),
            "seconds": report.get("seconds"),
            "kernelLaunches": report.get("kernel_launches")})
        return m.group(1)

    def _tenant_engine_dir(self, app: str) -> str:
        """A per-app copy of the engine template with the datasource
        appName swapped: `pio train` against it stamps env.appName =
        the tenant, which is what the mux's app-filtered candidate
        walk routes on. Same factory, same variant — every tenant's
        instances live in ONE metadata namespace, disambiguated by the
        app binding alone."""
        dst = os.path.join(self.cfg.workdir, "engines", app)
        if not os.path.isdir(dst):
            shutil.copytree(self.cfg.engine_dir, dst)
            path = os.path.join(dst, "engine.json")
            with open(path) as f:
                doc = json.load(f)
            params = doc.setdefault("datasource", {}).setdefault(
                "params", {})
            params.pop("app_name", None)
            params["appName"] = app
            with open(path, "w") as f:
                json.dump(doc, f)
        return dst

    def _train_tenants(self) -> None:
        """One instance per non-primary app, BEFORE the primary's
        initial train — the primary stays the newest COMPLETED row, so
        the deploy's default load picks it and every other app is
        served only through the mux."""
        for app in self.plan.app_names[1:]:
            self._train(f"tenant:{app}",
                        engine_dir=self._tenant_engine_dir(app))

    def _launch_event_server(self) -> None:
        env = self._base_env()
        for w, spec in self.plan.worker_specs.items():
            env[f"PIO_EVENT_WORKER_FAULT_SPEC_{w}"] = spec
        self._spawn("eventserver", self._console_argv(
            "eventserver", "--ip", "127.0.0.1",
            "--port", str(self.event_port),
            "--workers", str(self.cfg.event_workers)), env)

    def _launch_engine(self) -> None:
        cfg = self.cfg
        env = self._base_env()
        argv = self._console_argv(
            "deploy", "--engine-dir", cfg.engine_dir,
            "--ip", "127.0.0.1", "--port", str(self.engine_port),
            "--online-foldin", "--device", cfg.device)
        if cfg.elastic:
            argv += ["--replicas", "auto"]
        elif cfg.replicas:
            for r, spec in self.plan.replica_specs.items():
                env[f"PIO_FLEET_WORKER_FAULT_SPEC_{r}"] = spec
            argv += ["--replicas", str(cfg.replicas)]
        else:
            argv += ["--model-refresh-ms", f"{cfg.refresh_ms:.0f}"]
        self._spawn("engine", argv, env)

    def _http(self, method: str, url: str, *, timeout: float = 5.0,
              headers: Optional[dict] = None, body=None) -> _Response:
        """One request on a connection of its own."""
        sess = _Session(url)
        try:
            return sess.request(method, url, json_body=body,
                                headers=headers, timeout=timeout)
        finally:
            sess.close()

    def _wait_ready(self, labels: tuple) -> None:
        """The fronts of ``labels`` answering before traffic starts."""
        deadline = time.monotonic() + self.cfg.ready_timeout_s
        ev_base = f"http://127.0.0.1:{self.event_port}"
        en_base = f"http://127.0.0.1:{self.engine_port}"
        ev_ok = "eventserver" not in labels
        en_ok = "engine" not in labels
        while time.monotonic() < deadline and not (ev_ok and en_ok):
            for label in labels:
                p = self.procs[label]
                if p.poll() is not None:
                    raise RuntimeError(
                        f"soak {label} died at startup "
                        f"(rc={p.returncode}): {self.tail(label)}")
            try:
                if not ev_ok:
                    ev_ok = self._http(
                        "GET", ev_base + "/", timeout=2).status_code == 200
            except Exception:  # noqa: BLE001 — still booting
                pass
            try:
                if not en_ok:
                    if self.cfg.elastic:
                        doc = self._http("GET", en_base + "/healthz",
                                         timeout=2).json()
                        # the floor is enough: the ramp grows the rest
                        en_ok = (doc.get("readyReplicas") or 0) >= 1
                    elif self.cfg.replicas:
                        doc = self._http("GET", en_base + "/healthz",
                                         timeout=2).json()
                        en_ok = (doc.get("readyReplicas")
                                 == self.cfg.replicas)
                    else:
                        en_ok = self._http(
                            "GET", en_base + "/status",
                            timeout=2).status_code == 200
            except Exception:  # noqa: BLE001 — still booting
                pass
            time.sleep(0.25)
        if not (ev_ok and en_ok):
            raise RuntimeError(
                "soak topology not ready in "
                f"{self.cfg.ready_timeout_s:.0f}s — eventserver "
                f"ok={ev_ok} engine ok={en_ok}\n"
                + "\n".join(f"{label}: {self.tail(label, 1500)}"
                            for label in labels))

    # -- traffic -----------------------------------------------------------

    def _pick(self, rng: random.Random, names: list, weights: list):
        return rng.choices(names, weights=weights, k=1)[0]

    def _pick_item(self, rng: random.Random) -> int:
        # zipfian item popularity: the floods concentrate their ratings
        # on a head of popular items, so a ranking that puts the head
        # first scores measurably better than one that buries it — the
        # signal the quality watch grades poison_quality against
        return rng.choices(range(len(self.plan.item_weights)),
                           weights=self.plan.item_weights, k=1)[0]

    def _ingest_loop(self, idx: int, rate: float) -> None:
        """Open-loop single/batch ingest at ``rate``/s, zipfian over
        apps and users, alternating enqueue/commit acks. Failures are
        recorded, never retried — the ledger owns the truth."""
        cfg = self.cfg
        rng = random.Random(cfg.seed * 1000 + idx)
        base = f"http://127.0.0.1:{self.event_port}"
        # keep-alive like a real SDK: the L4 front splices the
        # connection once, so steady state costs zero connects; after
        # any failure the pool is dropped and the next request
        # re-splices (possibly onto a different worker)
        sess = _Session(base)
        period = 1.0 / rate
        nxt = time.monotonic()
        n = 0
        while not self.stop.is_set():
            nxt += period * (0.5 + rng.random())   # jittered open loop
            delay = nxt - time.monotonic()
            if delay > 0:
                if self.stop.wait(delay):
                    break
            else:
                nxt = time.monotonic()             # fell behind: skip
            n += 1
            app = self._pick(rng, self.plan.app_names,
                             self.plan.app_weights)
            if self.pause_primary.is_set() \
                    and app == self.plan.app_names[0]:
                others = self.plan.app_names[1:]
                if not others:
                    continue        # single-app scenario: skip the send
                app = others[rng.randrange(len(others))]
            key = self.access_keys[app]
            user = rng.choices(range(cfg.users),
                               weights=self.plan.user_weights, k=1)[0]
            if n % cfg.batch_every == 0:
                events, markers = [], []
                for _ in range(cfg.batch_size):
                    marker = self._next_marker(idx)
                    markers.append(marker)
                    events.append(self._event_json(
                        f"u{user}", self._pick_item(rng), marker, rng))
                try:
                    r = sess.post(
                        f"{base}/batch/events.json?accessKey={key}",
                        json=events, timeout=12)
                except _ConnError:
                    sess.close()
                    with self.ledger.lock:
                        self.ledger.ingest_conn_errors += 1
                        for mk in markers:
                            self.ledger.unacked.append(
                                (app, mk, "conn-error"))
                    continue
                if r.status_code == 200:
                    for mk, item in zip(markers, r.json()):
                        self.ledger.code(
                            "ingest", item["status"],
                            time.monotonic() - self.t0,
                            str(item.get("message", "")))
                        if item["status"] == 201:
                            with self.ledger.lock:
                                self.ledger.acked.append(
                                    (app, mk, item["eventId"], "batch"))
                        else:
                            with self.ledger.lock:
                                self.ledger.unacked.append(
                                    (app, mk, f"item-{item['status']}"))
                else:
                    self.ledger.code("ingest", r.status_code,
                                     time.monotonic() - self.t0,
                                     r.text)
                    with self.ledger.lock:
                        for mk in markers:
                            self.ledger.unacked.append(
                                (app, mk, f"batch-{r.status_code}"))
            else:
                marker = self._next_marker(idx)
                mode = ("enqueue" if rng.random() < cfg.enqueue_frac
                        else "commit")
                try:
                    r = sess.post(
                        f"{base}/events.json?accessKey={key}",
                        json=self._event_json(
                            f"u{user}", self._pick_item(rng), marker,
                            rng),
                        headers={"X-Pio-Ack": mode}, timeout=12)
                except _ConnError:
                    sess.close()
                    with self.ledger.lock:
                        self.ledger.ingest_conn_errors += 1
                        self.ledger.unacked.append(
                            (app, marker, "conn-error"))
                    continue
                self.ledger.code("ingest", r.status_code,
                                 time.monotonic() - self.t0, r.text)
                if r.status_code == 201:
                    with self.ledger.lock:
                        self.ledger.acked.append(
                            (app, marker, r.json()["eventId"], mode))
                else:
                    with self.ledger.lock:
                        self.ledger.unacked.append(
                            (app, marker, f"http-{r.status_code}"))

    _marker_lock = threading.Lock()

    def _next_marker(self, idx: int) -> str:
        with self._marker_lock:
            self.ledger.sent += 1
            return f"soak-{idx}-{self.ledger.sent}"

    @staticmethod
    def _event_json(user: str, item: int, marker: str,
                    rng: random.Random) -> dict:
        return {"event": "rate", "entityType": "user", "entityId": user,
                "targetEntityType": "item", "targetEntityId": f"i{item}",
                "properties": {"rating": float(rng.randrange(1, 6)),
                               "marker": marker}}

    def _query_loop(self, idx: int, rate: float) -> None:
        """Open-loop deadline-carrying queries against the engine."""
        cfg = self.cfg
        rng = random.Random(cfg.seed * 2000 + idx)
        base = f"http://127.0.0.1:{self.engine_port}"
        sess = _Session(base)
        nxt = time.monotonic()
        apps = self.plan.app_names
        n = 0
        while not self.stop.is_set():
            period = 1.0 / (rate * max(0.01, self.rate_mult))
            nxt += period * (0.5 + rng.random())
            delay = nxt - time.monotonic()
            if delay > 0:
                if self.stop.wait(delay):
                    break
            else:
                nxt = time.monotonic()
            user = rng.choices(range(cfg.users),
                               weights=self.plan.user_weights, k=1)[0]
            headers = {"X-Pio-Deadline-Ms":
                       f"{cfg.query_deadline_ms:.0f}"}
            app = None
            if cfg.tenant_apps:
                # first sweep visits every app in order — guaranteed
                # per-tenant coverage AND forced LRU churn (the sweep
                # is wider than the resident bound) — then zipfian
                app = (apps[(idx + n) % len(apps)] if n < len(apps)
                       else self._pick(rng, apps,
                                       self.plan.app_weights))
                headers["X-Pio-App"] = app
            n += 1
            body: dict = {"user": f"u{user}"}
            if cfg.elastic:
                # each query holds its admission slot ~50ms: capacity
                # becomes conc/holdS per replica, so the ramp's 10x
                # step builds real queue depth (a microsecond-answer
                # engine reads as quiet at ANY offered rate); the
                # nonce keeps each query cache-unique — a result-cache
                # hit answers before admission, so a zipfian flood
                # served from cache would be invisible to the scaler
                body["holdS"] = 0.05
                body["nonce"] = f"{idx}-{n}"
            t0 = time.monotonic()
            try:
                r = sess.post(
                    base + "/queries.json", json=body,
                    headers=headers,
                    timeout=max(15.0, cfg.query_deadline_ms / 1000 + 5))
            except _ConnError:
                sess.close()
                if not self.stop.is_set():
                    with self.ledger.lock:
                        self.ledger.query_conn_errors += 1
                continue
            self.ledger.code("query", r.status_code,
                             time.monotonic() - self.t0, r.text)
            if app is not None:
                self.ledger.tenant_code(app, r.status_code)
            if r.status_code == 200:
                with self.ledger.lock:
                    self.ledger.latencies.append(time.monotonic() - t0)

    def _ramp_loop(self) -> None:
        """Elastic load step: multiply the offered query rate by
        ``ramp_factor`` at ``upAtS``, back to 1x at ``downAtS`` — the
        autoscaler's detect→spawn→ready and drain-on-quiet brackets
        are graded against these two instants."""
        ramp = self.plan.ramp
        if not ramp:
            return
        for at_s, mult in ((ramp["upAtS"], ramp["factor"]),
                           (ramp["downAtS"], 1.0)):
            delay = at_s - (time.monotonic() - self.t0)
            if delay > 0 and self.stop.wait(delay):
                return
            self.rate_mult = mult
            self.fault_log.append({
                "name": "ramp", "ok": True,
                "firedAtS": round(time.monotonic() - self.t0, 1),
                "detail": f"offered query rate x{mult:g}"})

    # -- scraper -----------------------------------------------------------

    def _scrape_loop(self) -> None:
        ev_base = f"http://127.0.0.1:{self.event_port}"
        en_base = f"http://127.0.0.1:{self.engine_port}"
        while not self.scrape_stop.wait(1.0):
            self._scrape_once(ev_base, en_base)
        self._scrape_once(ev_base, en_base)     # final sample

    def _scrape_once(self, ev_base: str, en_base: str) -> None:
        fleet = self.cfg.replicas or self.cfg.elastic
        for base in (ev_base, en_base, *self._backend_bases(ev_base),
                     *(self._backend_bases(en_base) if fleet else ())):
            try:
                self.samples.note_metrics(self._http(
                    "GET", base + "/metrics", timeout=4).text)
            except Exception:  # noqa: BLE001 — kill windows drop scrapes
                pass
        try:
            doc = self._http("GET", en_base + "/status", timeout=4).json()
        except Exception:  # noqa: BLE001
            return
        t_off = time.monotonic() - self.t0
        with self.samples.lock:
            iid = doc.get("engineInstanceId")
            if iid and (not self.samples.served
                        or self.samples.served[-1][1] != iid):
                self.samples.served.append((t_off, iid))
        lc = doc.get("lifecycle") or {}
        for inst, reason in (lc.get("pinned") or {}).items():
            if reason in ("error-rate", "validate", "quality") \
                    or reason.startswith("integrity"):
                self.samples.note_rollback(
                    t_off, f"lifecycle:{inst}", f"pinned {reason}")
        fleet = doc.get("fleet") or {}
        directive = fleet.get("directive") or {}
        for inst, reason in (directive.get("pinned") or {}).items():
            self.samples.note_rollback(
                t_off, f"fleet:{inst}", f"directive pin {reason}")
        tn = doc.get("tenants")
        if isinstance(tn, dict):
            with self.samples.lock:
                # eviction counter is monotonic per process; keep the
                # freshest snapshot (fleet scrapes splice to ONE
                # replica per connection — a lower bound, like the
                # cache counters below)
                if (tn.get("evictions", 0)
                        >= self.samples.tenants.get("evictions", 0)):
                    self.samples.tenants = tn
            # a mux tenant's own rollback pin is a rollback
            # observation like any lifecycle/directive pin — a poison
            # landing on a resident tenant must still satisfy the
            # rollback-window row
            for row in tn.get("tenants") or []:
                for inst, reason in (row.get("pinned") or {}).items():
                    self.samples.note_rollback(
                        t_off, f"tenant:{row.get('app')}:{inst}",
                        f"tenant {row.get('app')} pin {reason}")
        qc = doc.get("queryCache")
        if isinstance(qc, dict):
            # counters are monotonic per replica; keyed max() mirrors
            # note_metrics (fleet scrapes splice to ONE replica per
            # connection, so this is a lower bound across the fleet)
            with self.samples.lock:
                for key in ("hits", "misses", "invalidations",
                            "invalidatedEntries", "evictions",
                            "entries"):
                    v = qc.get(key)
                    if isinstance(v, (int, float)):
                        self.samples.query_cache[key] = max(
                            self.samples.query_cache.get(key, 0), v)
        fold = doc.get("foldin") or {}
        if fold.get("producer") and fold.get("enabled", True):
            lag = fold.get("lagSeconds")
            with self.samples.lock:
                if lag is not None:
                    self.samples.foldin_lag.append((t_off, float(lag)))
                self.samples.foldin_publishes = max(
                    self.samples.foldin_publishes,
                    int(fold.get("publishes") or 0))
        if self.cfg.replicas or self.cfg.elastic:
            try:
                h = self._http("GET", en_base + "/healthz",
                               timeout=4).json()
            except Exception:  # noqa: BLE001
                return
            with self.samples.lock:
                for b in h.get("backends", []):
                    k = f"replica:{b.get('replica')}"
                    self.samples.restarts[k] = max(
                        self.samples.restarts.get(k, 0),
                        int(b.get("restarts") or 0))
                if self.cfg.elastic:
                    self.samples.fleet_size.append((
                        round(t_off, 1),
                        int(h.get("activeReplicas") or 0),
                        int(h.get("readyReplicas") or 0),
                        int(h.get("targetReplicas") or 0)))

    def _backend_bases(self, front: str) -> list:
        """Each backend's own address (an event worker, an engine replica),
        from its front's /healthz (the front answers it itself): a front
        /metrics scrape reaches one backend, so a counter that only one
        backend moves (a worker's ENOSPC shed, the quality breach of the
        replica that canaried an increment) could go unseen for the whole
        run."""
        try:
            doc = self._http("GET", front + "/healthz", timeout=4).json()
        except Exception:  # noqa: BLE001 — kill windows drop scrapes
            return []
        return [f"http://127.0.0.1:{b['port']}"
                for b in doc.get("backends") or [] if b.get("port")]

    # -- fault scheduler ---------------------------------------------------

    def _fault_loop(self) -> None:
        """Driver-side actions on the timeline (spec faults are armed
        in the worker/replica environments and fire themselves)."""
        actions = sorted((f for f in self.plan.faults
                          if f.kind in ("event", "train")),
                         key=lambda f: f.at_s)
        for f in actions:
            delay = self.t0 + f.at_s - time.monotonic()
            if delay > 0 and self.stop.wait(delay):
                return
            if self.stop.is_set():
                return
            try:
                t_fire = time.monotonic()
                entry = {"name": f.name, "atS": f.at_s,
                         "firedAtS": round(t_fire - self.t0, 2),
                         "ok": True}
                if f.name == "poison_foldin":
                    self._insert_control(f.target, "poison-serve")
                elif f.name == "poison_quality":
                    self._insert_control(f.target, "poison-rank")
                elif f.name == "good_retrain":
                    entry["instance"], t_pub = self._retrain_frozen(
                        "good_retrain")
                    entry["firedAtS"] = round(t_pub - self.t0, 2)
                elif f.name == "poison_retrain":
                    n_rb = len(self.samples.rollback_seen)
                    self._insert_control(f.target, "poison-train")
                    try:
                        entry["instance"], t_pub = self._retrain_frozen(
                            "poison_retrain",
                            settled=lambda: len(
                                self.samples.rollback_seen) > n_rb)
                        # the rollback-window clock starts when the
                        # poisoned instance became publishable (the
                        # COMPLETED stamp), not when the control event
                        # landed — `pio train` wall time is not watch
                        # time
                        entry["firedAtS"] = round(t_pub - self.t0, 2)
                    finally:
                        # later retrains come up clean: the antidote
                        # out-dates the poison marker
                        self._insert_control(f.target, "antidote")
                self.fault_log.append(entry)
            except Exception as e:  # noqa: BLE001 — scorecard decides
                log.exception("soak fault %s failed", f.name)
                self.fault_log.append(
                    {"name": f.name, "atS": f.at_s, "ok": False,
                     "error": str(e)})

    def _retrain_frozen(self, label: str, settled=None):
        """One retrain under a deploy freeze: primary-app ingest pauses
        (fold-in increments stop outdating the retrain), the retrain
        lands and rides the normal staged rollout, and ingest resumes
        once the rollout settled — the new instance observed serving
        (good) or its rollback observed (poisoned) — or a bounded wait
        elapsed. Queries and background-app ingest never pause.
        Returns (instance id, monotonic instant the instance became
        publishable)."""
        self.pause_primary.set()
        try:
            iid = self._train(label)
            t_pub = time.monotonic()
            if settled is None:
                def settled():
                    with self.samples.lock:
                        return any(i == iid
                                   for _t, i in self.samples.served)
            deadline = t_pub + self.cfg.rollback_deadline_s
            while time.monotonic() < deadline and not settled():
                if self.stop.wait(0.25):
                    break
            return iid, t_pub
        finally:
            self.pause_primary.clear()

    def _insert_control(self, app: str, event: str) -> None:
        """Scenario control events ride the DATA (the fold-in threat
        model): inserted straight into the base shard, which every
        merged read and the log tailer already cover."""
        from ..data.storage.event import Event

        self.storage().get_l_events().insert(
            Event(event=event, entity_type="sys", entity_id="soak"),
            self.app_ids[app])

    # -- quiesce + drain + reconcile ---------------------------------------

    def _quiesce(self) -> dict:
        """After traffic stops: wait for fold-in to catch up and any
        in-flight watch windows to settle; returns freshness result."""
        cfg = self.cfg
        en_base = f"http://127.0.0.1:{self.engine_port}"
        bound_s = cfg.freshness_factor * cfg.foldin_ms / 1000.0
        deadline = time.monotonic() + cfg.freshness_settle_s
        final_lag = None
        while time.monotonic() < deadline:
            try:
                doc = self._http("GET", en_base + "/status",
                                 timeout=4).json()
            except Exception:  # noqa: BLE001
                time.sleep(0.3)
                continue
            fold = doc.get("foldin") or {}
            if fold.get("producer") and fold.get("enabled", True):
                lag = fold.get("lagSeconds")
                if lag is not None:
                    final_lag = float(lag)
                    if final_lag <= bound_s:
                        break
            time.sleep(0.3)
        # let a watch window opened by the last publishes close — the
        # QUALITY watch is the longest one, and the scrape loop is
        # still running, so late rollback pins are still observed
        time.sleep(min(6.0, max(cfg.swap_watch_ms,
                                cfg.quality_watch_ms) / 1000.0 + 0.5))
        return {"finalLagS": final_lag, "boundS": bound_s}

    def _drain(self) -> dict:
        out = {}
        for label in ("engine", "eventserver"):
            p = self.procs.get(label)
            if p is None:
                continue
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    rc = p.wait(timeout=self.cfg.drain_timeout_s)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=10)
                    rc = -9
            else:
                rc = p.returncode
            out[label] = rc
        return out

    def kill_all(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass

    def _event_supervisor_doc(self) -> Optional[dict]:
        p = self.procs.get("eventserver")
        if p is None:
            return None
        path = os.path.join(self._base_env()["PIO_FS_BASEDIR"], "gang",
                            f"pid{p.pid}", "supervisor.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- the run -----------------------------------------------------------

    def run(self) -> dict:
        cfg = self.cfg
        plan = self.plan
        started = time.time()
        mops = _host_loop_mops()
        self._setup_workspace()
        if cfg.tenant_apps:
            self._train_tenants()
        self._train("initial")
        # the engine first: the event workers arm their spec faults' clock
        # when they start, so they start once the engine answers, and their
        # faults land on the scenario's timeline, not inside the engine's
        # start (seconds on the card). Armed earlier, a worker's ENOSPC and
        # its compaction crash both came due by the first append, and the
        # counter that is the ENOSPC's evidence died with the worker
        # before a scrape could read it
        self._launch_engine()
        self._wait_ready(("engine",))
        self._launch_event_server()
        self._wait_ready(("eventserver",))

        scrape_t = threading.Thread(target=self._scrape_loop,
                                    daemon=True, name="soak-scrape")
        scrape_t.start()
        threads = [threading.Thread(target=self._fault_loop,
                                    daemon=True, name="soak-faults")]
        if plan.ramp:
            threads.append(threading.Thread(
                target=self._ramp_loop, daemon=True, name="soak-ramp"))
        n_ing = 2 if cfg.ingest_rps > 25 else 1
        for i in range(n_ing):
            threads.append(threading.Thread(
                target=self._ingest_loop, args=(i, cfg.ingest_rps / n_ing),
                daemon=True, name=f"soak-ingest-{i}"))
        n_q = 2 if cfg.query_rps > 15 else 1
        if plan.ramp:
            # the ramp must be able to SATURATE: a synchronous client
            # lane holds ONE query in flight, so replica queue depth
            # is bounded by the fan-out — 16 lanes let the 10x step
            # push the floor replica past the scale-up threshold,
            # then spread thin once the fleet grows
            n_q = 16
        for i in range(n_q):
            threads.append(threading.Thread(
                target=self._query_loop, args=(i, cfg.query_rps / n_q),
                daemon=True, name=f"soak-query-{i}"))
        self.t0 = time.monotonic()
        for t in threads:
            t.start()
        try:
            time.sleep(cfg.duration_s)
        finally:
            self.stop.set()
        for t in threads:
            t.join(45)
        freshness = self._quiesce()
        self.scrape_stop.set()
        scrape_t.join(20)
        t_drain = time.monotonic()
        drain = self._drain()
        drain_s = time.monotonic() - t_drain
        supervisor_doc = self._event_supervisor_doc()
        reconciliation = reconcile_ledger(self.storage(), self.ledger,
                                          self.app_ids,
                                          self._base_env())
        slos, faults = evaluate_slos(
            plan, self.ledger, self.samples, reconciliation, freshness,
            drain, supervisor_doc, self.fault_log)
        verdict = "PASS" if all(s["ok"] for s in slos) else "FAIL"
        with self.ledger.lock:
            traffic = {
                "sentMarkers": self.ledger.sent,
                "acked": len(self.ledger.acked),
                "unacked": len(self.ledger.unacked),
                "ingestCodes": dict(sorted(
                    self.ledger.ingest_codes.items())),
                "queryCodes": dict(sorted(
                    self.ledger.query_codes.items())),
                "ingestConnErrors": self.ledger.ingest_conn_errors,
                "queryConnErrors": self.ledger.query_conn_errors,
                "acceptedQueries": len(self.ledger.latencies),
                "queryP50Ms": round(_pct(self.ledger.latencies, 50)
                                    * 1000, 1),
                "queryP99Ms": round(_pct(self.ledger.latencies, 99)
                                    * 1000, 1),
            }
        with self.samples.lock:
            query_cache = dict(self.samples.query_cache)
            tenant_snap = dict(self.samples.tenants)
            served = list(self.samples.served)
            foldin_publishes = self.samples.foldin_publishes
        scorecard = {
            "v": 1,
            "verdict": verdict,
            "seed": cfg.seed,
            "startedAt": started,
            "wallS": round(time.time() - started, 1),
            "durationS": cfg.duration_s,
            "topology": {
                "eventWorkers": cfg.event_workers,
                "replicas": cfg.replicas,
                "apps": plan.app_names,
                "foldinMs": cfg.foldin_ms,
                "watchMs": cfg.swap_watch_ms,
                "tenantApps": cfg.tenant_apps,
                "tenantMaxResident": _tenant_resident(cfg),
                "elastic": cfg.elastic,
                "ramp": plan.ramp,
                "device": cfg.device,
            },
            "slos": slos,
            "faults": faults,
            "traffic": traffic,
            "freshness": freshness,
            "queryCache": query_cache,
            "tenants": tenant_snap if cfg.tenant_apps else None,
            "drainRc": drain,
            "reconciliation": {k: v for k, v in reconciliation.items()
                               if k != "perMarker"},
            "trains": list(self.trains),
            "recovery": _recovery(self.fault_log, served, drain_s,
                                  foldin_publishes),
            "host": {
                "loopMops": round(mops, 2),
                "cpus": os.cpu_count(),
                "note": "offered rates are upper bounds; the achieved "
                        "counts are recorded above",
            },
            "planNotes": plan.notes,
        }
        return scorecard


def _recovery(fault_log: list, served: list, drain_s: float,
              foldin_publishes: int) -> dict:
    """The port's recovery numbers (the reference's scorecard has none):
    each retrain's seconds from publishable to first observed serving
    (None: never observed), the drain's seconds, and the fold-in
    increments the producer published."""
    out: dict = {"drainS": round(drain_s, 2),
                 "foldinPublishes": foldin_publishes, "retrains": []}
    for f in fault_log:
        iid = f.get("instance")
        if not iid:
            continue
        seen = [t for t, i in served if i == iid]
        out["retrains"].append({
            "name": f["name"], "instance": iid,
            "servedAfterS": (round(seen[0] - f["firedAtS"], 2)
                             if seen else None)})
    return out


def _pct(values: list, p: float) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    return vs[min(len(vs) - 1, int(len(vs) * p / 100.0))]


# ---------------------------------------------------------------------------
# reconciliation + SLO evaluation (pure, unit-testable)
# ---------------------------------------------------------------------------

def reconcile_ledger(storage, ledger: _Ledger, app_ids: dict,
                     env: dict) -> dict:
    """The exactly-once census: replay leftover WAL segments (enqueue
    acks deferred by the drain), then count every ledger marker in the
    merged shards. Ack semantics: every ACKED marker must appear
    exactly once; ambiguous sends (conn errors) may appear 0 or 1
    times; NOTHING may appear twice."""
    from ..data.api import ingest_wal

    wal_summary = None
    cfg = ingest_wal.WalConfig(
        enabled=env.get("PIO_WAL") == "1",
        fsync=env.get("PIO_WAL_FSYNC", "group"),
        dir=env.get("PIO_WAL_DIR") or None)
    if cfg.enabled:
        try:
            wal_summary = ingest_wal.recover(storage, cfg)
        except ingest_wal.WalLockedError:
            wal_summary = {"error": "wal dir still live"}
    counts: dict = {}
    le = storage.get_l_events()
    for app, app_id in app_ids.items():
        for ev in le.find(app_id):
            marker = None
            if ev.properties is not None:
                marker = ev.properties.get_or_else("marker", None)
            if marker:
                counts[(app, marker)] = counts.get((app, marker), 0) + 1
    with ledger.lock:
        acked = list(ledger.acked)
        unacked = list(ledger.unacked)
    lost = [(app, mk) for app, mk, _id, _m in acked
            if counts.get((app, mk), 0) == 0]
    dup = [(app, mk, n) for (app, mk), n in counts.items() if n > 1]
    ambiguous_landed = sum(1 for app, mk, _why in unacked
                           if counts.get((app, mk), 0) > 0)
    return {
        "ackedEvents": len(acked),
        "storeMarkers": len(counts),
        "lostAcked": lost[:20],
        "lostAckedCount": len(lost),
        "duplicated": dup[:20],
        "duplicatedCount": len(dup),
        "ambiguousSends": len(unacked),
        "ambiguousLanded": ambiguous_landed,
        "walReplay": wal_summary,
        "perMarker": counts,
    }


def evaluate_slos(plan: SoakPlan, ledger: _Ledger, samples: _Samples,
                  reconciliation: dict, freshness: dict, drain: dict,
                  supervisor_doc: Optional[dict],
                  fault_log: list) -> tuple:
    """Scorecard SLO rows + per-fault evidence rows. Pure: everything
    it reads arrived as data, so seeded-violation fixtures unit-test
    every red path."""
    cfg = plan.cfg
    slos: list = []

    def slo(name: str, ok: bool, value, bound, detail: str = ""):
        slos.append({"name": name, "ok": bool(ok), "value": value,
                     "bound": bound, "detail": detail})

    lost = reconciliation["lostAckedCount"]
    dups = reconciliation["duplicatedCount"]
    slo("acked-event-loss", lost == 0 and dups == 0,
        {"lost": lost, "duplicated": dups}, 0,
        f"{reconciliation['ackedEvents']} acked events reconciled "
        "against merged shards + WAL replay")

    with ledger.lock:
        ingest_codes = dict(ledger.ingest_codes)
        query_codes = dict(ledger.query_codes)
        latencies = list(ledger.latencies)
        conn_errors = (ledger.ingest_conn_errors
                       + ledger.query_conn_errors)
        violations = list(ledger.violations)
    bad_ingest = {c: n for c, n in ingest_codes.items()
                  if c not in (201, 503)}
    bad_query = {c: n for c, n in query_codes.items()
                 if c not in (200, 503, 504)}
    slo("http-codes", not bad_ingest and not bad_query,
        {"ingest": bad_ingest, "query": bad_query},
        "ingest {201,503} / query {200,503,504}",
        f"ingest codes {ingest_codes}, query codes {query_codes}"
        + ("".join(f"; [{v['atS']}s] {v['table']} {v['code']}: "
                   f"{v['body']}" for v in violations)))

    p99_ms = _pct(latencies, 99) * 1000
    slo("query-p99", bool(latencies) and p99_ms <= cfg.p99_ms,
        round(p99_ms, 1), cfg.p99_ms,
        f"{len(latencies)} accepted queries")

    # rollback-within-window: every poison action needs its OWN
    # rollback observation after it, within the bound (one observation
    # cannot satisfy two poisons — keys are consumed)
    poisons = sorted((f for f in fault_log
                      if f["name"] in ("poison_foldin", "poison_retrain",
                                       "poison_quality")
                      and f.get("ok")),
                     key=lambda f: f.get("firedAtS", 0.0))
    with samples.lock:
        rollbacks = sorted(samples.rollback_seen)
    consumed: set = set()
    rb_rows = []
    ok_rb = True
    for f in poisons:
        fired = float(f.get("firedAtS", 0.0))
        matched = None
        for t_off, key, detail in rollbacks:
            if key in consumed or t_off < fired - 1.0:
                continue
            delta = t_off - fired
            if delta <= cfg.rollback_deadline_s:
                consumed.add(key)
                matched = {"key": key, "detail": detail,
                           "afterS": round(delta, 1)}
            break
        rb_rows.append({"fault": f["name"], "firedAtS": fired,
                        "observed": matched})
        if matched is None:
            ok_rb = False
    slo("rollback-window", ok_rb, rb_rows,
        f"<= {cfg.rollback_deadline_s}s after each poisoned publish",
        f"{len(rollbacks)} rollback observation(s): "
        + "; ".join(f"{k} @{t:.1f}s ({d})" for t, k, d in rollbacks))

    bound_s = cfg.freshness_factor * cfg.foldin_ms / 1000.0
    lag = freshness.get("finalLagS")
    slo("foldin-freshness", lag is not None and lag <= bound_s,
        lag, round(bound_s, 2),
        f"{samples.foldin_publishes} increment(s) published; settled "
        "lag after quiesce")

    budget = plan.conn_budget
    slo("conn-errors", conn_errors <= budget, conn_errors, budget,
        "connection-level drops across both floods (kill-window TCP "
        "reality; every HTTP response is already covered above)")

    slo("clean-drain",
        all(rc == 0 for rc in drain.values()) and len(drain) == 2,
        drain, 0, "SIGTERM drain exit codes (engine, eventserver)")

    # -- elastic topology: the fleet sized itself under the ramp -----------
    # two rows, one per direction of the load step. Graded purely from
    # the scraped /healthz fleet-size series, so seeded fixtures
    # unit-test both red paths (never grew / never came back down).
    if cfg.elastic and plan.ramp:
        up_at = float(plan.ramp["upAtS"])
        down_at = float(plan.ramp["downAtS"])
        floor = int(plan.ramp["min"])
        with samples.lock:
            sizes = list(samples.fleet_size)
            scale_events = sum(
                v for k, v in samples.metric_max.items()
                if k.startswith("pio_fleet_scale_events_total"))
        grew = [t for t, _active, ready, _target in sizes
                if t >= up_at and ready > floor]
        up_delta = round(grew[0] - up_at, 1) if grew else None
        slo("scale-up-within-bound",
            up_delta is not None and up_delta <= cfg.scale_up_bound_s,
            up_delta, cfg.scale_up_bound_s,
            f"{len(sizes)} fleet-size sample(s); first >{floor}-ready "
            f"observation "
            + (f"{up_delta}s after the step" if grew
               else "never seen after the step")
            + f"; scale events {scale_events:.0f}")
        shrunk = [t for t, active, _ready, _target in sizes
                  if t >= down_at and active <= floor]
        down_delta = round(shrunk[0] - down_at, 1) if shrunk else None
        slo("drain-on-quiet",
            down_delta is not None
            and down_delta <= cfg.scale_down_bound_s,
            down_delta, cfg.scale_down_bound_s,
            f"first back-at-floor ({floor}) observation "
            + (f"{down_delta}s after the step-down" if shrunk
               else "never seen after the step-down")
            + " — draining replicas finish in-flight work "
              "(non-{200,503,504} reds http-codes)")

    # -- per-fault evidence ------------------------------------------------
    with samples.lock:
        metric_max = dict(samples.metric_max)
        restarts = dict(samples.restarts)
    sup_restarts = {}
    if supervisor_doc:
        for w in supervisor_doc.get("workers", []):
            sup_restarts[f"worker:{w.get('worker')}"] = \
                int(w.get("restarts") or 0)

    def metric_at_least(prefix: str, n: float = 1) -> bool:
        return any(v >= n for k, v in metric_max.items()
                   if k.startswith(prefix))

    # -- cache freshness: rollbacks must not leave stale results -----------
    # Two legs: (a) the armed served-result cache saw real traffic —
    # an armed cache that never counted a hit or miss is a dead cache
    # nobody exercised; (b) every rollback observation is covered by
    # at least one cache invalidation EVENT apiece — the flush the
    # swap/rollback path owes the cache, so a kill/poison fault cannot
    # keep serving the rolled-back model's cached answers.
    def metric_total(family: str) -> float:
        return sum(v for k, v in metric_max.items()
                   if k == family or k.startswith(family + "{"))

    with samples.lock:
        qc = dict(samples.query_cache)
    hits = max(metric_total("pio_query_cache_hits_total"),
               float(qc.get("hits", 0)))
    misses = max(metric_total("pio_query_cache_misses_total"),
                 float(qc.get("misses", 0)))
    inv = max(metric_total("pio_query_cache_invalidations_total"),
              float(qc.get("invalidations", 0)))
    cache_armed = cfg.query_cache_size > 0
    ok_cache = (not cache_armed) or (
        hits + misses >= 1 and inv >= len(rollbacks))
    slo("cache-freshness", ok_cache,
        {"hits": hits, "misses": misses, "invalidations": inv,
         "rollbacks": len(rollbacks)},
        plan.slos.get("cache-freshness"),
        (f"{len(rollbacks)} rollback observation(s) vs {inv:.0f} cache"
         f" invalidation event(s), {hits + misses:.0f} lookups"
         if cache_armed else "cache disabled (query_cache_size=0)"))

    # -- tenant isolation: per-tenant availability + LRU churn -------------
    # One row per app, graded on that app's OWN evidence alone: a row
    # reds only when ITS tenant was offered traffic and never answered
    # a 200, or answered outside the contract — a hot tenant burning
    # its admission budget (503 shed) can never red a cold neighbor.
    # The mux must also have actually churned: with the resident bound
    # below the app count, zero evictions means the LRU was never
    # exercised and "N apps through one process" was not proven.
    if cfg.tenant_apps:
        with ledger.lock:
            tcodes = {a: dict(c)
                      for a, c in ledger.tenant_codes.items()}
        with samples.lock:
            tsnap = dict(samples.tenants)
        bound = _tenant_resident(cfg)
        rows = []
        ok_t = True
        for app in plan.app_names:
            codes = tcodes.get(app, {})
            offered = sum(codes.values())
            accepted = codes.get(200, 0)
            bad = {c: n for c, n in codes.items()
                   if c not in (200, 503, 504)}
            row_ok = (offered == 0) or (accepted >= 1 and not bad)
            rows.append({"app": app, "ok": row_ok, "offered": offered,
                         "accepted": accepted,
                         "shed": codes.get(503, 0),
                         "timeout": codes.get(504, 0), "bad": bad})
            ok_t = ok_t and row_ok
        unoffered = [r["app"] for r in rows if r["offered"] == 0]
        # the query loops' opening sweep visits every app, so an
        # unoffered tenant means the sweep never ran — red
        ok_t = ok_t and not unoffered
        evictions = tsnap.get("evictions")
        churn_ok = (len(plan.app_names) <= bound
                    or (evictions or 0) >= 1)
        slo("tenant-isolation", ok_t and churn_ok,
            {"perTenant": rows, "evictions": evictions,
             "resident": tsnap.get("resident"),
             "maxResident": tsnap.get("maxResident"),
             "coldLoads": tsnap.get("coldLoads")},
            plan.slos.get("tenant-isolation"),
            f"{len(rows)} tenant row(s), "
            f"{sum(r['accepted'] for r in rows)} accepted, "
            f"{sum(r['shed'] for r in rows)} shed; "
            + (f"{evictions} eviction(s), {tsnap.get('resident')}/"
               f"{tsnap.get('maxResident')} resident"
               if tsnap else "no tenants snapshot scraped")
            + (f"; never offered: {unoffered}" if unoffered else ""))

    fired_by_name = {f["name"]: f for f in fault_log}
    fault_rows = []
    for f in plan.faults:
        ev: dict = {"name": f.name, "kind": f.kind, "atS": f.at_s,
                    "target": f.target, "point": f.point}
        if f.kind in ("event", "train"):
            entry = fired_by_name.get(f.name)
            ev["fired"] = bool(entry and entry.get("ok"))
        else:
            ev["fired"] = True      # armed in the env; evidence decides
        if f.name == "enospc_shed":
            ev["evidence"] = metric_at_least(
                "pio_ingest_append_errors_total")
            ev["detail"] = "pio_ingest_append_errors_total >= 1"
        elif f.name in ("worker_kill", "compact_crash"):
            w = f.target or ""
            ev["evidence"] = sup_restarts.get(w, 0) >= 1
            ev["detail"] = f"supervisor.json {w} restarts " \
                           f"{sup_restarts.get(w, 0)}"
        elif f.name == "replica_kill":
            ev["evidence"] = restarts.get(f.target or "", 0) >= 1
            ev["detail"] = f"front /healthz {f.target} restarts " \
                           f"{restarts.get(f.target or '', 0)}"
        elif f.name == "poison_foldin":
            ev["evidence"] = metric_at_least("pio_foldin_rollbacks_total")
            ev["detail"] = "pio_foldin_rollbacks_total >= 1"
        elif f.name == "poison_retrain":
            ev["evidence"] = (
                metric_at_least("pio_fleet_rollbacks_total")
                or metric_at_least(
                    'pio_engine_rollbacks_total{reason="error-rate"}'))
            ev["detail"] = "fleet/engine rollback counter >= 1"
        elif f.name == "poison_quality":
            ev["evidence"] = (
                metric_at_least("pio_engine_quality_breaches_total")
                or metric_at_least(
                    'pio_engine_rollbacks_total{reason="quality"}'))
            ev["detail"] = "quality breach / quality-reason rollback " \
                           "counter >= 1"
        elif f.name == "good_retrain":
            entry = fired_by_name.get("good_retrain")
            with samples.lock:
                served_iids = {i for _t, i in samples.served}
            rolled_out = bool(entry and entry.get("instance")
                              in served_iids)
            ev["evidence"] = bool(entry and entry.get("ok")
                                  and rolled_out)
            ev["detail"] = ("retrain completed and its instance was "
                            "observed serving (staged rollout under "
                            "live fire)" if rolled_out else
                            "retrain completed but its instance was "
                            "never observed serving")
        fault_rows.append(ev)

    # -- quality SLO: the scorer graded relevance, not just uptime ---------
    # two legs: (a) the shadow scorer actually sampled live traffic
    # (armed but never sampling = a dead scorer grading nothing), and
    # (b) every fired quality poison has a rollback observation whose
    # pin reason is EXPLICITLY `quality` within the window — an
    # error-rate pin does not count, the poison never errors
    q_poisons = [f for f in poisons if f["name"] == "poison_quality"]
    q_consumed: set = set()
    q_rows = []
    ok_q = True
    for f in q_poisons:
        fired = float(f.get("firedAtS", 0.0))
        matched = None
        for t_off, key, detail in rollbacks:
            if key in q_consumed or t_off < fired - 1.0 \
                    or "quality" not in detail:
                continue
            delta = t_off - fired
            if delta <= cfg.rollback_deadline_s:
                q_consumed.add(key)
                matched = {"key": key, "detail": detail,
                           "afterS": round(delta, 1)}
            break
        q_rows.append({"fault": f["name"], "firedAtS": fired,
                       "observed": matched})
        if matched is None:
            ok_q = False
    armed = cfg.quality_sample > 0
    scorer_live = (not armed) or metric_at_least(
        "pio_engine_quality_samples_total")
    slo("quality-regression", ok_q and scorer_live,
        {"sampled": scorer_live, "rollbacks": q_rows},
        plan.slos.get("quality-regression"),
        f"{len(q_poisons)} quality poison(s) fired; scorer "
        + ("sampled live traffic" if scorer_live else "NEVER sampled"))

    missing = [r["name"] for r in fault_rows
               if r["fired"] and not r.get("evidence", True)]
    slo("fault-evidence", not missing, missing, "[]",
        "every injected fault left its telemetry/supervision trace")
    return slos, fault_rows


# ---------------------------------------------------------------------------
# scorecard persistence
# ---------------------------------------------------------------------------

def write_scorecard(scorecard: dict, out_path: str,
                    baseline_key: Optional[str] = None) -> None:
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(scorecard, f, indent=2, default=str)
        f.write("\n")
    os.replace(tmp, out_path)
    if baseline_key:
        base = os.path.join(os.path.dirname(os.path.abspath(out_path)),
                            "BASELINE.json")
        try:
            with open(base) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
        row = {
            "verdict": scorecard["verdict"],
            "seed": scorecard["seed"],
            "wallS": scorecard["wallS"],
            "topology": scorecard["topology"],
            "faultsInjected": sum(
                1 for f in scorecard["faults"] if f.get("fired")),
            "slos": {s["name"]: s["ok"] for s in scorecard["slos"]},
            "traffic": scorecard["traffic"],
            "hostLoopMops": scorecard["host"]["loopMops"],
            "note": scorecard["host"]["note"],
        }
        doc.setdefault("published", {})[
            f"measured_soak_{baseline_key}"] = row
        tmp = base + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, base)


def read_scorecard(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def run_soak(plan: SoakPlan,
             progress: Callable[[str], None] = lambda s: None) -> dict:
    """Run one planned soak end to end; returns the scorecard (also
    persisted to ``cfg.out_path`` / BASELINE when configured)."""
    cfg = plan.cfg
    runner = SoakRunner(plan)
    progress(plan.describe())
    try:
        scorecard = runner.run()
    finally:
        runner.kill_all()
        if runner._storage is not None:
            try:
                runner._storage.close()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
        if not cfg.keep_workdir:
            shutil.rmtree(cfg.workdir, ignore_errors=True)
    out_path = cfg.out_path or os.path.join(os.getcwd(), "SOAK.json")
    write_scorecard(scorecard, out_path, cfg.baseline_key)
    progress(f"scorecard → {out_path} ({scorecard['verdict']})")
    return scorecard
