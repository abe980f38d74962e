"""Engine (deploy) server — serves a trained engine on :8000.

Port of ``incubator_predictionio_tpu/workflow/create_server.py`` on the
standard library's ``http.server.ThreadingHTTPServer`` (one thread per
connection) in place of aiohttp, with the reference's names, JSON keys and
status codes:

- ``POST /queries.json`` through plugins, the served-result cache and the
  admission gate: a bounded executor of ``query_conc`` workers plus
  ``query_max_pending`` waiting slots; excess load sheds 503 with a
  jittered ``Retry-After``, a spent deadline answers 504. With
  ``batch_window_ms`` > 0 one batcher thread coalesces the queries of a
  window into one ``Deployment.batch_query``.
- ``GET /`` and ``/status`` (overload, lifecycle, query cache, probe
  latency), ``/healthz``, ``/readyz`` (503 while a storage circuit
  breaker is open, named in ``openBreakers``), ``/plugins.json``, and
  ``/metrics``: the process registry as Prometheus text (the query stage
  histograms, this server's ``pio_engine_*`` gauges, the query cache's
  counters, fold-in, quality, tenants, storage transport and breakers).
- Sampled tracing: ``PIO_TRACE`` samples a request (an incoming
  ``X-Pio-Trace-Id`` is honoured), the handler thread binds it for the
  whole dispatch (``telemetry.traced_dispatch``), the query worker gets
  it with its copied context and adds the ``query.featurize`` /
  ``query.predict`` / ``query.serve`` spans, and the answer carries
  ``X-Pio-Trace-Id``.
- TLS: with ``PIO_SSL_CERTFILE`` and ``PIO_SSL_KEYFILE`` set the server
  answers HTTPS only (``common/ssl_config.py``).
- The validated model lifecycle: every (re)load passes warm-up, the
  NaN guard and a golden-query smoke predict before it goes live; one
  previous deployment stays resident for an instant ``/rollback``; a
  post-swap watch window hedges failing queries onto it and rolls back on
  the error rate; ``/reload[?instance=]`` and the refresh loop
  (``model_refresh_ms``) pin what they refuse.
- ``/stop``, SIGTERM and SIGINT drain: ``/readyz`` answers 503 at once,
  new queries shed 503, accepted ones finish (up to ``drain_deadline_ms``),
  then the server stops.
- Online fold-in (``foldin_ms`` > 0, ``workflow/online.py``): a thread
  tails the app's event log, folds new events into a copy of the served
  models, commits each increment as a COMPLETED instance and publishes it
  through ``_publish_once``, the refresh loop's gate.
- Continuous quality evaluation (``quality_sample`` > 0,
  ``workflow/quality.py``): a sampled slice of answered queries is replayed
  on the retained last-good deployment and both are graded against the
  users' next events; a breach inside the quality watch of a swap rolls it
  back with reason ``quality``.
- Multi-tenant serving (``tenant_max_resident`` > 0,
  ``workflow/multitenant.py``): queries that name another app (by
  ``X-Pio-App``, ``app``, ``accessKey`` or ``X-Pio-Access-Key``) are served
  from that app's own resident deployment, lifecycle, admission budget and
  fold-in runner.
- A fleet replica (``fleet_replica`` ≥ 0, ``PIO_FLEET_REPLICA``, set by the
  fleet supervisor of ``workflow/fleet.py``): the initial load honours the
  fleet's directive record, a sync thread applies the coordinator's
  directives through this replica's own gate and publishes its status
  row every ``PIO_FLEET_SYNC_MS``, ``/rollback`` pins fleet-wide,
  ``/reload`` and ``/stop`` answer 409, the refresh knob is refused, only
  replica 0 produces fold-in increments (and never publishes them itself),
  and a heartbeat thread touches the supervisor's heartbeat file.

The deployment form (``EngineServer(deployment=...)``, the console's
``deploy --model`` file) serves one fixed deployment: it has no model
store, so ``/reload`` and ``/rollback`` answer 409, and refresh, fold-in,
quality and tenants are off.

What rides ``/status`` (fold-in, quality, tenants, the fleet view) stays
there as well as on ``/metrics``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextvars
import copy
import datetime as _dt
import hmac
import json
import logging
import math
import os
import queue
import secrets
import threading
import time as _time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, NamedTuple, Optional

import torch

from ..common import deadline, envknobs, faultinject, telemetry
from ..common.resilience import retry_after_jitter
from ..common.ssl_config import (
    TLSServerMixin,
    loopback_client_context,
    ssl_context_from_env,
)
from ..data.storage.datamap import DataMap
from ..data.storage.event import Event
from ..data.storage.registry import Storage
from ..device import resolve_device
from .context import WorkflowContext
from .core_workflow import load_deployment
from .plugins import EngineServerPluginContext
from .swap_chain import SwapChain

log = logging.getLogger("pio.torch.engineserver")


def _env_int(name: str, default: int) -> int:
    """Tolerant integer knob: unset/unparsable degrades to the default;
    float spellings like ``"1e3"`` are accepted."""
    return envknobs.env_int(name, default, float_ok=True)


# query-cache telemetry is process-wide monotonic (counters survive a
# server object being rebuilt in-process, like the fold-in counters)
_M_CACHE_HITS = telemetry.registry().counter(
    "pio_query_cache_hits_total",
    "Queries answered from the served-result cache without a model "
    "dispatch").labels()
_M_CACHE_MISSES = telemetry.registry().counter(
    "pio_query_cache_misses_total",
    "Cache-armed queries that had to run a model dispatch (entry "
    "absent, expired, or invalidated)").labels()
_M_CACHE_INVALIDATIONS = telemetry.registry().counter(
    "pio_query_cache_invalidations_total",
    "Query-cache invalidation events by trigger: foldin = targeted "
    "per-user eviction from an increment's freshness footprint; swap "
    "= full flush on any other model swap; rollback = full flush "
    "when a rollback restores the previous model", ("reason",))


class _Text(str):
    """A plain-text answer body (``GET /metrics``)."""


class QueryResultCache:
    """Per-user served-result cache (``PIO_QUERY_CACHE_SIZE`` > 0 arms
    it). Keyed on (user, canonical query fingerprint, app): a
    byte-identical repeat of a query within the TTL is answered without
    touching the model.

    Freshness: a fold-in increment naming the users it touched evicts
    exactly those users; any other swap and every rollback flush
    everything; the TTL bounds staleness that no swap observes. The
    ``generation`` guard drops an insert whose dispatch began before an
    invalidation, so a result computed by the old model never lands after
    a swap.

    Entries store a deep copy and hits return a deep copy: results flow
    through after_query plugins that may mutate them. Thread-safe (its own
    lock)."""

    def __init__(self, max_entries: int, ttl_s: float):
        self.max_entries = int(max_entries)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        # key → (expires_monotonic, result); insertion order is LRU order
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidated_entries = 0
        self.invalidations = 0
        self.generation = 0

    @staticmethod
    def key_for(query, app: Optional[str] = None) -> tuple:
        """(user-or-None, canonical JSON fingerprint, app-or-None), on the
        post-``before_query`` form of the query."""
        user = query.get("user") if isinstance(query, dict) else None
        fp = json.dumps(query, sort_keys=True, separators=(",", ":"),
                        default=str)
        return (None if user is None else str(user), fp,
                None if app is None else str(app))

    def get(self, key: tuple):
        now = _time.monotonic()
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent[0] > now:
                self._entries.move_to_end(key)
                self.hits += 1
                _M_CACHE_HITS.inc()
                return copy.deepcopy(ent[1])
            if ent is not None:
                del self._entries[key]  # expired
            self.misses += 1
        _M_CACHE_MISSES.inc()
        return None

    def put(self, key: tuple, result, generation: Optional[int] = None
            ) -> None:
        entry = (_time.monotonic() + self.ttl_s, copy.deepcopy(result))
        with self._lock:
            if generation is not None and generation != self.generation:
                return  # an invalidation ran mid-dispatch: result stale
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def _drop(self, doomed: list) -> int:
        """Delete ``doomed`` keys as one invalidation (lock held)."""
        for k in doomed:
            del self._entries[k]
        self.invalidated_entries += len(doomed)
        self.invalidations += 1
        self.generation += 1
        return len(doomed)

    def invalidate_users(self, users, app: Optional[str] = None) -> int:
        """Drop every entry keyed to one of ``users`` (of ``app`` only,
        when given); userless entries survive."""
        users = {str(u) for u in users}
        app = None if app is None else str(app)
        with self._lock:
            n = self._drop([k for k in self._entries
                            if k[0] in users and (app is None or k[2] == app)])
        _M_CACHE_INVALIDATIONS.labels("foldin").inc()
        return n

    def flush_app(self, app: str, reason: str) -> int:
        """Drop every entry of one app."""
        app = str(app)
        with self._lock:
            n = self._drop([k for k in self._entries if k[2] == app])
        _M_CACHE_INVALIDATIONS.labels(reason).inc()
        return n

    def flush(self, reason: str) -> int:
        with self._lock:
            n = self._drop(list(self._entries))
        _M_CACHE_INVALIDATIONS.labels(reason).inc()
        return n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "maxEntries": self.max_entries,
                "ttlMs": round(self.ttl_s * 1e3, 3),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "invalidatedEntries": self.invalidated_entries,
            }


class AdmissionShed(Exception):
    """The admission gate refused this query (queue full or server
    draining). Maps to HTTP 503 + jittered ``Retry-After``: the query
    never started, so a retry elsewhere or later is safe."""

    def __init__(self, message: str, retry_after_base: float, reason: str):
        super().__init__(message)
        self.retry_after_base = retry_after_base
        self.reason = reason


class SwapValidationError(RuntimeError):
    """The validation gate refused to put a (re)loaded model live
    (NaN guard hit, warm-up failed, or the golden-query smoke predict
    raised). The last-good deployment keeps serving; the reload/refresh
    caller decides whether to pin the refused instance."""

    def __init__(self, instance_id: str, reason: str):
        super().__init__(
            f"engine instance {instance_id} failed swap validation: "
            f"{reason}")
        self.instance_id = instance_id
        self.reason = reason


class Request(NamedTuple):
    """What a route handler sees of one HTTP request."""

    headers: Any
    params: dict
    body: bytes


#: a route handler's answer: (status, JSON body or :class:`_Text`, extra
#: headers)
Reply = tuple


def _json(status: int, obj, headers: Optional[dict] = None) -> Reply:
    return status, obj, headers or {}


def _missing_field(e: KeyError) -> Reply:
    return _json(400, {"message": f"missing query field {e.args[0]!r}"})


def _shed_reply(e: AdmissionShed) -> Reply:
    return _json(503, {"message": f"query shed: {e}"},
                 {"Retry-After": str(retry_after_jitter(e.retry_after_base))})


#: deadline stages that are queueing, not the model's compute: an overrun
#: there is overload, never evidence against a freshly swapped model
_QUEUE_STAGES = ("admission", "executor pickup", "batch queue", "queued")


class EngineServer:
    """The engine server of one engine (``engine`` + the model store's
    instances) or of one fixed ``deployment`` (the file form). Serving
    starts with :meth:`start` (a background thread) or
    :func:`run_engine_server` (blocking, with the signal handlers)."""

    def __init__(
        self,
        engine=None,
        engine_factory_name: str = "",
        engine_variant: str = "default",
        instance_id: Optional[str] = None,
        storage: Optional[Storage] = None,
        feedback: bool = False,
        feedback_app_name: Optional[str] = None,
        plugins: Optional[EngineServerPluginContext] = None,
        batch_window_ms: float = 0.0,
        max_batch: int = 64,
        query_conc: Optional[int] = None,
        query_max_pending: Optional[int] = None,
        query_deadline_ms: Optional[float] = None,
        drain_deadline_ms: Optional[float] = None,
        swap_validate: Optional[bool] = None,
        swap_watch_ms: Optional[float] = None,
        swap_max_error_rate: Optional[float] = None,
        model_refresh_ms: Optional[float] = None,
        query_cache_size: Optional[int] = None,
        query_cache_ttl_ms: Optional[float] = None,
        foldin_ms: Optional[float] = None,
        quality_sample: Optional[float] = None,
        tenant_max_resident: Optional[int] = None,
        tenant_max_pending: Optional[int] = None,
        fleet_replica: Optional[int] = None,
        fleet_replicas: Optional[int] = None,
        fleet_sync_ms: Optional[float] = None,
        device: "str | torch.device" = "cuda",
        deployment=None,
    ):
        if (engine is None) == (deployment is None):
            raise ValueError("EngineServer serves an engine (with its model "
                             "store) or one deployment: pass exactly one")
        self.engine = engine
        self.engine_factory_name = engine_factory_name
        self.engine_variant = engine_variant
        self.device = resolve_device(device)
        # the file form needs no store unless feedback asks for one
        self.storage = (storage if deployment is not None
                        else storage or Storage.instance())
        self.feedback = feedback
        self.feedback_app_name = feedback_app_name
        self.plugins = plugins or EngineServerPluginContext()
        # Micro-batching window (0 = off): queries arriving within
        # batch_window_ms are coalesced into ONE Deployment.batch_query.
        self.batch_window_ms = float(batch_window_ms)
        # ops.topk pads batches to a power of two only up to 256
        self.max_batch = min(int(max_batch), 256)
        self.start_time = _dt.datetime.now(_dt.timezone.utc)
        self._lock = threading.Lock()
        self._query_count = 0
        self._init_overload_state(query_conc, query_max_pending,
                                  query_deadline_ms, drain_deadline_ms,
                                  swap_validate, swap_watch_ms,
                                  swap_max_error_rate, model_refresh_ms,
                                  query_cache_size, query_cache_ttl_ms)
        self._init_online_state(foldin_ms, quality_sample,
                                tenant_max_resident, tenant_max_pending)
        self._init_fleet_state(fleet_replica, fleet_replicas, fleet_sync_ms)
        # synthetic probe traffic is excluded from queryCount/feedback; the
        # marker must carry this per-process token, never exposed, so an
        # external "X-Pio-Probe: 1" cannot bypass the accounting
        self._probe_token = secrets.token_hex(16)
        # degraded mode: serving goes on with the last-good model after a
        # failed reload; /status and /readyz surface it
        self._degraded_reason: Optional[str] = None
        self._dropped_feedback = 0
        # per-algorithm warm-up accounting of the live instance (gauges: a
        # reload measures the new instance's warm-up from scratch, and
        # _load_once swaps in fresh families so a variant's dead labels go)
        self._m_compile_count, self._m_compile_seconds = \
            self._new_compile_families()
        telemetry.registry().register_collector(
            "engineserver", self._collect_metrics)
        self._feedback_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pio-feedback")
        self.deployment = None
        self.instance = None
        self._httpd: Optional[_HTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._batch_queue: Optional[queue.Queue] = None
        self._batch_thread: Optional[threading.Thread] = None
        self._refresh_stop = threading.Event()
        self._refresh_thread: Optional[threading.Thread] = None
        if deployment is not None:
            self._m_compile_count, self._m_compile_seconds = self._prepare(
                deployment, "deployment", None)
            self.deployment = deployment
        elif self.fleet_mode and instance_id is None:
            self._fleet_bootstrap_load()
        else:
            self._load(instance_id)
        if self.tenant_max_resident > 0:
            from . import multitenant

            self._tenants = multitenant.TenantMux(
                self, self.tenant_max_resident, self.tenant_max_pending)

    @property
    def file_form(self) -> bool:
        """Serving one fixed deployment, with no model store behind it."""
        return self.engine is None

    def _init_overload_state(self, query_conc=None, query_max_pending=None,
                             query_deadline_ms=None, drain_deadline_ms=None,
                             swap_validate=None, swap_watch_ms=None,
                             swap_max_error_rate=None, model_refresh_ms=None,
                             query_cache_size=None,
                             query_cache_ttl_ms=None) -> None:
        """Admission control, deadlines, drain, the model lifecycle and the
        result cache. Arguments override the ``PIO_*`` knobs."""
        self.query_conc = max(1, int(
            query_conc if query_conc is not None
            else _env_int("PIO_QUERY_CONC",
                          min(32, (os.cpu_count() or 4) + 4))))
        self.query_max_pending = max(0, int(
            query_max_pending if query_max_pending is not None
            else _env_int("PIO_QUERY_MAX_PENDING", 128)))
        # per-query budget (0 = unbounded); X-Pio-Deadline-Ms overrides it
        # per request, up to the ceiling below
        self.query_deadline_ms = float(
            query_deadline_ms if query_deadline_ms is not None
            else _env_int("PIO_QUERY_DEADLINE_MS", 30_000))
        # what a client header may loosen the budget TO (0 = uncapped): a
        # client must not park unkillable workers on a hung model
        self.query_deadline_max_ms = max(0.0, float(
            _env_int("PIO_QUERY_DEADLINE_MAX_MS", 600_000)))
        self.drain_deadline_ms = max(0.0, float(
            drain_deadline_ms if drain_deadline_ms is not None
            else _env_int("PIO_DRAIN_DEADLINE_MS", 10_000)))
        self._query_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.query_conc, thread_name_prefix="pio-query")
        self._adm_lock = threading.Lock()
        self._adm_pending = 0
        self._adm_peak = 0
        self._shed_count = 0
        self._deadline_count = 0
        self._orphaned = 0
        self._draining = False
        self._drain_stragglers = 0
        # admitted queries whose answer is not written yet (the slot frees
        # when compute finishes, before the handler writes): a drain waits
        # for both; _tls.admitted counts the admissions of this handler's
        # request
        self._unanswered = 0
        self._tls = threading.local()
        self._reload_lock = threading.Lock()
        self._reload_conflicts = 0
        # validation gate: NaN guard, warm-up success and the golden query
        # before any (re)loaded model goes live
        self.swap_validate = (
            bool(swap_validate) if swap_validate is not None
            else envknobs.env_flag("PIO_SWAP_VALIDATE", True))
        # post-swap watch: failures count against the NEW model (and are
        # hedged onto the previous one); past the rate it is rolled back
        self.swap_watch_ms = max(0.0, float(
            swap_watch_ms if swap_watch_ms is not None
            else _env_int("PIO_SWAP_WATCH_MS", 60_000)))
        self.swap_max_error_rate = float(
            swap_max_error_rate if swap_max_error_rate is not None
            else envknobs.env_float("PIO_SWAP_MAX_ERROR_RATE", 0.5,
                                    lo=0.0, hi=1.0))
        # continuous refresh: poll for newer COMPLETED instances (0 = off)
        self.model_refresh_ms = max(0.0, float(
            model_refresh_ms if model_refresh_ms is not None
            else _env_int("PIO_MODEL_REFRESH_MS", 0)))
        self._refresh_disabled: Optional[str] = None
        if self.file_form and self.model_refresh_ms > 0:
            log.warning("refresh every %.0f ms refused: a deployment "
                        "served from a model file has no model store to "
                        "poll; /status reports refreshMs: disabled(file)",
                        self.model_refresh_ms)
            self._refresh_disabled = "file"
            self.model_refresh_ms = 0.0
        self.query_cache_size = max(0, int(
            query_cache_size if query_cache_size is not None
            else _env_int("PIO_QUERY_CACHE_SIZE", 0)))
        self.query_cache_ttl_ms = max(0.0, float(
            query_cache_ttl_ms if query_cache_ttl_ms is not None
            else _env_int("PIO_QUERY_CACHE_TTL_MS", 10_000)))
        self._query_cache = (
            QueryResultCache(self.query_cache_size,
                             self.query_cache_ttl_ms / 1e3)
            if self.query_cache_size > 0 and self.query_cache_ttl_ms > 0
            else None)
        # the resident previous deployment, the post-swap watch and the
        # chain of unobserved swaps (workflow/swap_chain.py)
        self._chain = SwapChain()
        self._pinned: dict[str, str] = {}  # instance id → pin reason
        self._rollbacks: dict[str, int] = {}   # reason → count
        self._swap_count = 0
        self._validate_failures = 0
        self._refresh_swaps = 0

    def _init_online_state(self, foldin_ms=None, quality_sample=None,
                           tenant_max_resident=None,
                           tenant_max_pending=None) -> None:
        """Online fold-in, the quality watch and the tenant mux; arguments
        override the ``PIO_FOLDIN_MS``, ``PIO_QUALITY_*`` and
        ``PIO_TENANT_*`` knobs. The file form has no model store and no
        event log to tail: all three are off there."""
        # tail the app's event log and fold new events into the served
        # model every foldin_ms, through the refresh loop's gate (0 = off)
        self.foldin_ms = max(0.0, float(
            foldin_ms if foldin_ms is not None
            else _env_int("PIO_FOLDIN_MS", 0)))
        self._foldin_stop = threading.Event()
        self._foldin_thread: Optional[threading.Thread] = None
        self._foldin_runner = None
        self._foldin_view: Optional[dict] = None
        self._foldin_tick_errors = 0
        # shadow-score a slice of the answered queries on the retained
        # last-good deployment; a breach inside a swap's quality watch
        # rolls it back with reason "quality" (0 = off)
        self.quality_sample = min(1.0, max(0.0, float(
            quality_sample if quality_sample is not None
            else envknobs.env_float("PIO_QUALITY_SAMPLE", 0.0,
                                    lo=0.0, hi=1.0))))
        self.quality_k = max(1, _env_int("PIO_QUALITY_K", 10))
        self.quality_min_samples = max(1, _env_int(
            "PIO_QUALITY_MIN_SAMPLES", 20))
        self.quality_max_drop = envknobs.env_float(
            "PIO_QUALITY_MAX_DROP", 0.2, lo=0.0)
        # labels are the user's NEXT events, so the quality watch usually
        # outlives the error watch; 0 = the error watch's window
        self.quality_watch_ms = max(0.0, float(
            _env_int("PIO_QUALITY_WATCH_MS", 0))) or self.swap_watch_ms
        self.quality_resolve_ms = max(0.0, float(
            _env_int("PIO_QUALITY_RESOLVE_MS", 2000)))
        self.quality_ms = max(50.0, float(_env_int("PIO_QUALITY_MS", 500)))
        self._quality_stop = threading.Event()
        self._quality_thread: Optional[threading.Thread] = None
        self._quality_runner = None
        self._quality_view: Optional[dict] = None
        self._quality_watch = None       # active post-swap quality watch
        # > 0 arms the tenant mux: that many per-app deployments resident
        self.tenant_max_resident = max(0, int(
            tenant_max_resident if tenant_max_resident is not None
            else _env_int("PIO_TENANT_MAX_RESIDENT", 0)))
        # one tenant's admitted queries, below the process cap
        self.tenant_max_pending = max(1, int(
            tenant_max_pending if tenant_max_pending is not None
            else _env_int("PIO_TENANT_MAX_PENDING", 32)))
        self._tenants = None
        if self.file_form and (self.foldin_ms > 0 or self.quality_sample > 0
                               or self.tenant_max_resident > 0):
            log.warning("fold-in, quality evaluation and tenants refused: a "
                        "deployment served from a model file has no model "
                        "store or event log")
            self.foldin_ms = self.quality_sample = 0.0
            self.tenant_max_resident = 0

    def _init_fleet_state(self, fleet_replica=None, fleet_replicas=None,
                          fleet_sync_ms=None) -> None:
        """Replica-fleet wiring; arguments override ``PIO_FLEET_REPLICA``,
        ``PIO_FLEET_REPLICAS`` and ``PIO_FLEET_SYNC_MS``.

        A fleet replica does not chase the newest COMPLETED instance on
        its own: the fleet coordinator (``workflow/fleet.py``) stages
        rollouts through a store-mediated directive record, and this
        replica's sync thread applies directives (each swap through this
        replica's OWN validation gate) and publishes the status row the
        coordinator and `pio status --engine-url` aggregate. The file
        form has no store: it is never a fleet replica."""
        self.fleet_replica = int(
            fleet_replica if fleet_replica is not None
            else envknobs.env_int("PIO_FLEET_REPLICA", -1))
        if self.file_form:
            self.fleet_replica = -1
        self.fleet_replicas = max(0, int(
            fleet_replicas if fleet_replicas is not None
            else envknobs.env_int("PIO_FLEET_REPLICAS", 0, lo=0)))
        self.fleet_sync_ms = max(50.0, float(
            fleet_sync_ms if fleet_sync_ms is not None
            else _env_int("PIO_FLEET_SYNC_MS", 1000)))
        self.fleet_mode = self.fleet_replica >= 0
        # the sync thread's last directive + peer view: /status reads the
        # reference atomically, never the store
        self._fleet_view: Optional[dict] = None
        self._fleet_diverged = False
        # pins mid-application (a store-walk rollback in flight): honored by
        # this replica's own walks but NOT published to the fleet, because
        # the coordinator merges pins irreversibly
        self._pins_provisional: set = set()
        self._fleet_stop = threading.Event()
        # /rollback pokes the sync thread so the pin propagates at once
        self._fleet_poke = threading.Event()
        self._fleet_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if self.fleet_mode and self.model_refresh_ms > 0:
            # a replica chasing the newest instance on its own would race
            # the coordinator's staged canary
            log.warning(
                "fleet mode: PIO_MODEL_REFRESH_MS=%.0f refused — the fleet "
                "coordinator owns refresh (staged canary); /status reports "
                "refreshMs: disabled(fleet)", self.model_refresh_ms)
            self._refresh_disabled = "fleet"
            self.model_refresh_ms = 0.0

    def _fleet_group(self) -> str:
        """This replica's directive group: the coordinator's, including the
        app a tenant-aware fleet is scoped to (``PIO_FLEET_APP``)."""
        from . import model_artifact, multitenant

        return model_artifact.fleet_group(self.engine_factory_name,
                                          self.engine_variant,
                                          multitenant.replica_fleet_app())

    # -- lifecycle --------------------------------------------------------
    def _load(self, instance_id: Optional[str],
              skip_if_current: bool = False, on_reject=None,
              chain: bool = False) -> bool:
        """(Re)load a deployment; True when one was published, False when
        ``skip_if_current`` short-circuited. ``chain`` (the automatic
        publishes) lets the swap keep the last instance observed healthy
        as the previous deployment (:meth:`_load_once`).

        At the initial deploy (nothing serving yet) a validation-refused
        newest instance is pinned and the walk retries older COMPLETED
        instances. Once something IS serving, a validation failure raises
        so the caller keeps the last-good deployment."""
        while True:
            try:
                return self._load_once(instance_id, skip_if_current,
                                       on_reject, chain)
            except SwapValidationError as e:
                with self._lock:
                    has_current = self.deployment is not None
                if instance_id is not None or has_current:
                    raise
                with self._lock:
                    self._validate_failures += 1
                    self._pinned[e.instance_id] = "validate"
                log.warning(
                    "initial deploy: %s; pinning it and walking back to "
                    "an older COMPLETED instance", e)

    def _load_once(self, instance_id: Optional[str],
                   skip_if_current: bool = False, on_reject=None,
                   chain: bool = False) -> bool:
        """One load and swap. The previous deployment kept resident is the
        last instance OBSERVED healthy, whose post-swap watch closed
        without tripping. An automatic publish (``chain``) that lands
        while the outgoing instance's watch is still open keeps the
        previous deployment and appends the new instance to the chain of
        unobserved swaps; the outgoing one is released. The decision is
        made under ``_lock`` on one clock reading: a watch whose window
        has passed at that instant closed clean, and its instance becomes
        the previous deployment. Any other swap (an operator reload, a
        fleet directive) makes the outgoing instance the previous one and
        starts a new chain."""
        ctx = WorkflowContext(storage=self.storage, device=self.device)
        with self._lock:
            pinned = tuple(self._pinned) if instance_id is None else ()
        # with the tenant mux armed the default deployment stays within its
        # own app: a tenant's increment is newer, never the default model
        capp = self._cache_app() if instance_id is None else None
        deployment, instance, _ = load_deployment(
            self.engine, instance_id, ctx,
            engine_factory_name=self.engine_factory_name,
            engine_variant=self.engine_variant,
            # latest-completed mode never re-picks a pinned instance; an
            # explicit id is the operator overriding the pin on purpose
            exclude_ids=pinned,
            on_reject=on_reject,
            app_name=capp,
        )
        with self._lock:
            current = self.instance
        if (skip_if_current and current is not None
                and instance.id == current.id):
            log.info("refresh: no newer deployable instance than %s",
                     current.id)
            return False
        m_count, m_seconds = self._prepare(deployment, instance.id, instance)
        self._m_compile_count, self._m_compile_seconds = m_count, m_seconds
        with self._lock:
            prev_dep, prev_inst = self.deployment, self.instance
            # ONE previous deployment stays resident (its tensors on the
            # card intact) for an instant /rollback and the hedge
            swapped = self._chain.swap(prev_dep, prev_inst, instance,
                                       _time.monotonic(), chain=chain,
                                       watch_ms=self.swap_watch_ms)
            if swapped:
                self._swap_count += 1
            self.deployment = deployment
            self.instance = instance
            if (swapped and self.quality_sample > 0
                    and self.quality_watch_ms > 0):
                # the quality watch rides every swap beside the error watch
                self._quality_watch = {
                    "until": (_time.monotonic()
                              + self.quality_watch_ms / 1e3),
                    "instance": instance.id,
                }
        if swapped and self._query_cache is not None:
            users = self._foldin_footprint(instance, prev_inst)
            capp = self._cache_app()
            if users is None:
                # with the mux armed, only the default app's entries: the
                # other tenants' lifecycles invalidate theirs
                n = (self._query_cache.flush("swap") if capp is None
                     else self._query_cache.flush_app(capp, "swap"))
                log.info("query cache: flushed %d entrie(s) on swap "
                         "to %s", n, instance.id)
            else:
                n = self._query_cache.invalidate_users(users, app=capp)
                log.info("query cache: fold-in %s evicted %d entrie(s) "
                         "for %d touched user(s)", instance.id, n,
                         len(users))
        log.info("deployed engine instance %s", instance.id)
        return True

    @staticmethod
    def _new_compile_families():
        """The warm-up gauges, under the reference's names: "compile"
        there is XLA's, here the warm-up (catalog upload, first launch)."""
        return (telemetry.GaugeFamily(
                    "pio_engine_compile_count",
                    "Warm-up compilations performed for the live engine "
                    "instance, per algorithm", ("algorithm",)),
                telemetry.GaugeFamily(
                    "pio_engine_compile_seconds",
                    "Warm-up compilation wall seconds for the live engine "
                    "instance, per algorithm", ("algorithm",)))

    def _prepare(self, deployment, label: str, instance):
        """Warm every model up (its catalog resident on the card), run
        each pow2 batch shape the micro-batcher can produce once, then the
        validation gate. Returns the deployment's warm-up families (the
        caller publishes them with the deployment); raises
        :class:`SwapValidationError`."""
        m_count, m_seconds = self._new_compile_families()
        warmup_errors: list[str] = []
        for (algo_name, _algo), model in zip(deployment.algo_list,
                                             deployment.models):
            warm = getattr(model, "warm_up", None)
            if callable(warm):
                name = algo_name or type(model).__name__
                t0 = _time.perf_counter()
                try:
                    warm()
                except Exception as e:  # noqa: BLE001 - gate decides below
                    log.exception("model warm-up failed")
                    warmup_errors.append(f"{name}: {e}")
                else:
                    m_count.labels(name).set(1)
                    m_seconds.labels(name).set(_time.perf_counter() - t0)
        if self.batch_window_ms > 0:
            example = self._find_example_query(deployment)
            if example is not None:
                # up to the next pow2 ≥ max_batch: a full window pads there
                top = 1 << max(self.max_batch - 1, 0).bit_length()
                b = 1
                n_shapes = 0
                t0 = _time.perf_counter()
                while b <= top:
                    try:
                        deployment.batch_query([dict(example)] * b)
                    except Exception as e:  # noqa: BLE001 - gate below
                        log.exception("batch warm-up failed at size %d", b)
                        warmup_errors.append(f"batch[{b}]: {e}")
                        break
                    n_shapes += 1
                    b *= 2
                m_count.labels("batch").set(n_shapes)
                m_seconds.labels("batch").set(_time.perf_counter() - t0)
        if self.swap_validate and warmup_errors:
            raise SwapValidationError(
                label, "warm-up failed: " + "; ".join(warmup_errors))
        self._validate_swap(deployment, label, instance)
        return m_count, m_seconds

    @staticmethod
    def _foldin_footprint(instance, prev_inst) -> Optional[list]:
        """The incoming instance's targeted-invalidation user list, or
        None when only a full flush is safe: both halves of a fold-in
        marker (``users``, and ``bases`` naming the instance being
        served) are needed."""
        try:
            raw = (instance.runtime_conf or {}).get("foldin")
            if not raw or prev_inst is None:
                return None
            doc = json.loads(raw) if isinstance(raw, str) else raw
            users = doc.get("users")
            bases = doc.get("bases")
            if not isinstance(users, list):
                return None
            if not isinstance(bases, list) or prev_inst.id not in bases:
                return None
            return users
        except Exception:  # noqa: BLE001 — on any doubt, full flush
            return None

    def _validate_swap(self, deployment, label: str, instance) -> None:
        """The swap gate (``PIO_SWAP_VALIDATE``, default on): the NaN
        guard over every model plus a smoke predict of the golden query,
        after the ``swap.validate`` fault point. Any failure raises
        :class:`SwapValidationError`; the model never goes live."""
        if not self.swap_validate:
            return
        from ..common.nan_guard import check_finite

        try:
            faultinject.fault_point("swap.validate")
            for (algo_name, _algo), model in zip(deployment.algo_list,
                                                 deployment.models):
                check_finite(
                    model, f"swap.validate[{algo_name or 'default'}]")
            golden = self._golden_query(instance, deployment)
            if golden is not None:
                # the DASE stages directly, not Deployment.query: gate
                # traffic must not consume the query.* fault points
                q = deployment.serving.supplement(dict(golden))
                predictions = [
                    algo.predict(model, q)
                    for (_n, algo), model in zip(deployment.algo_list,
                                                 deployment.models)
                ]
                deployment.serving.serve(q, predictions)
            else:
                log.debug("swap validation: no golden query available; "
                          "skipping smoke predict")
        except Exception as e:  # noqa: BLE001 - any failure refuses it
            raise SwapValidationError(label, str(e)) from e

    def _golden_query(self, instance, deployment) -> Optional[dict]:
        """The smoke-predict query: the instance row's
        ``runtime_conf["golden_query"]``, ``$PIO_GOLDEN_QUERY``, or the
        models' ``example_query()``."""
        raw = ((instance.runtime_conf or {}).get("golden_query")
               if instance is not None else None) or envknobs.env_str(
                   "PIO_GOLDEN_QUERY", "", lower=False)
        if raw:
            try:
                doc = json.loads(raw)
                if isinstance(doc, dict):
                    return doc
                log.warning("golden_query is not a JSON object; "
                            "falling back to example_query")
            except json.JSONDecodeError:
                log.warning("golden_query is not valid JSON; falling "
                            "back to example_query")
        return self._find_example_query(deployment)

    @staticmethod
    def _find_example_query(deployment) -> Optional[dict]:
        """The first model offering a non-None ``example_query()``."""
        for model in deployment.models:
            ex = getattr(model, "example_query", None)
            if callable(ex):
                example = ex()
                if example is not None:
                    return example
        return None

    # -- status endpoints --------------------------------------------------
    def handle_status(self, request: Request) -> Reply:
        with self._lock:
            instance = self.instance
            query_count = self._query_count
        out = {
            "status": "alive",
            "engineInstanceId": instance.id if instance else None,
            "engineFactory": self.engine_factory_name,
            "engineVariant": self.engine_variant,
            "startTime": self.start_time.isoformat(),
            "queryCount": query_count,
            "plugins": self.plugins.plugin_names(),
            "degraded": self._degraded_reason is not None,
            "degradedReason": self._degraded_reason,
            "droppedFeedback": self._dropped_feedback,
            "overload": self.overload_snapshot(),
            "lifecycle": self.lifecycle_snapshot(),
        }
        if self.foldin_ms > 0:
            out["foldin"] = self.foldin_snapshot()
        if self._query_cache is not None:
            out["queryCache"] = self._query_cache.snapshot()
        if self._tenants is not None:
            out["tenants"] = self._tenants.snapshot()
        if self.quality_sample > 0:
            out["quality"] = self.quality_snapshot()
        if self.fleet_mode:
            # the sync thread's cached aggregation (no store I/O here): the
            # directive, every peer's status row and the divergence flag,
            # so `pio status --engine-url <front>` sees the whole fleet
            # from whichever replica answers
            out["fleet"] = self._fleet_view or {
                "group": self._fleet_group(),
                "replica": self.fleet_replica,
                "replicas": self.fleet_replicas,
                "directive": None, "peers": [], "divergence": False,
            }
        # the serving-latency split, when a probe ran (deploy
        # --probe-latency persists it to the instance row)
        probe = (instance.runtime_conf.get("probe_latency")
                 if instance is not None else None)
        if probe:
            try:
                out["probeLatency"] = json.loads(probe)
            except (TypeError, json.JSONDecodeError):
                pass
        return _json(200, out)

    def handle_healthz(self, request: Request) -> Reply:
        """Liveness: the process serves HTTP."""
        return _json(200, {"status": "alive"})

    def _collect_metrics(self):
        """Render-time families owned by THIS server instance."""
        qc = telemetry.GaugeFamily(
            "pio_engine_query_count",
            "Queries served by the live engine server (excludes "
            "synthetic startup probes)")
        qc.labels().set(self._query_count)
        dropped = telemetry.GaugeFamily(
            "pio_engine_dropped_feedback_total",
            "Feedback self-log events dropped by event-store failures")
        dropped.labels().set(self._dropped_feedback)
        ov = self.overload_snapshot()
        fams = [self._m_compile_count, self._m_compile_seconds, qc,
                dropped]
        for name, help_, value in (
            ("pio_engine_query_pending",
             "Accepted queries currently queued or running in the "
             "admission-gated executor", ov["pending"]),
            ("pio_engine_query_pending_limit",
             "Admission cap: PIO_QUERY_CONC + PIO_QUERY_MAX_PENDING",
             ov["pendingLimit"]),
            ("pio_engine_query_pending_peak",
             "High-water mark of accepted in-flight + queued queries",
             ov["peakPending"]),
            ("pio_engine_query_shed_total",
             "Queries refused 503 at admission (queue full or "
             "draining)", ov["shed"]),
            ("pio_engine_query_deadline_exceeded_total",
             "Queries answered 504 because their deadline budget ran "
             "out", ov["deadlineExceeded"]),
            ("pio_engine_query_orphaned_total",
             "Deadline-exceeded queries whose worker thread was still "
             "running at 504 time (freed at the next spend-point)",
             ov["orphaned"]),
            ("pio_engine_draining",
             "1 while the server drains for shutdown (readyz answers "
             "503)", 1 if ov["draining"] else 0),
            ("pio_engine_drain_stragglers",
             "Accepted queries still unfinished when the drain "
             "deadline expired", ov["drainStragglers"]),
        ):
            fam = telemetry.GaugeFamily(name, help_)
            fam.labels().set(value)
            fams.append(fam)
        lc = self.lifecycle_snapshot()
        rb = telemetry.GaugeFamily(
            "pio_engine_rollbacks_total",
            "Deployment rollbacks to the retained previous model, by "
            "reason (error-rate = automatic post-swap watch, quality = "
            "shadow-scorer breach, manual = /rollback)", ("reason",))
        # the automatic-rollback rows always show, so an alert can fire on
        # their first increment, plus any reason already seen
        for reason in sorted({"error-rate", "quality", *lc["rollbacks"]}):
            rb.labels(reason).set(lc["rollbacks"].get(reason, 0))
        fams.append(rb)
        for name, help_, value in (
            ("pio_engine_model_swaps_total",
             "Hot swaps to a different engine instance since start "
             "(reload, explicit target, or refresh)", lc["swaps"]),
            ("pio_engine_swap_validate_failures_total",
             "Reload/refresh attempts refused by the swap validation "
             "gate (nan_guard, warm-up, golden-query smoke predict)",
             lc["validateFailures"]),
            ("pio_engine_pinned_instances",
             "Engine instances pinned against redeployment (rolled "
             "back or validation-refused)", len(lc["pinned"])),
            ("pio_engine_model_refresh_swaps_total",
             "Hot swaps performed by the continuous-refresh loop",
             lc["refreshSwaps"]),
        ):
            fam = telemetry.GaugeFamily(name, help_)
            fam.labels().set(value)
            fams.append(fam)
        if self.fleet_mode:
            view = self._fleet_view
            div = telemetry.GaugeFamily(
                "pio_fleet_divergence",
                "1 while this replica's cached peer view shows the "
                "fleet serving more than one engine instance (mixed "
                "brain; converges within PIO_FLEET_SYNC_MS)")
            div.labels().set(1 if (view and view.get("divergence")) else 0)
            fams.append(div)
        return fams

    def handle_metrics(self, request: Request) -> Reply:
        """Prometheus text exposition of the process registry."""
        return _json(200, _Text(telemetry.render_all()))

    def _storage_breakers(self) -> list[dict]:
        if self.storage is None:
            return []
        try:
            return [b for states in self.storage.breaker_states().values()
                    for b in states]
        except Exception:  # noqa: BLE001 - readiness must never crash
            log.exception("breaker state collection failed")
            return []

    def handle_readyz(self, request: Request) -> Reply:
        """Readiness: a model is loaded, no storage circuit breaker is
        open and the server is not draining; 503 otherwise, so load
        balancers rotate it out. The degraded flag is telemetry, not a
        rotation signal."""
        with self._lock:
            loaded = self.deployment is not None
        open_breakers = [b["name"] for b in self._storage_breakers()
                         if b.get("state") == "open"]
        with self._adm_lock:
            draining = self._draining
        ready = loaded and not open_breakers and not draining
        return _json(200 if ready else 503, {
            "ready": ready,
            "modelLoaded": loaded,
            "degraded": self._degraded_reason is not None,
            "draining": draining,
            "openBreakers": open_breakers,
        })

    def handle_plugins(self, request: Request) -> Reply:
        return _json(200, {"plugins": self.plugins.plugin_names()})

    # -- admission control / deadlines / drain ----------------------------
    def overload_snapshot(self) -> dict:
        """Shed/deadline/drain counters for /status and `pio status`."""
        with self._adm_lock:
            pending, peak = self._adm_pending, self._adm_peak
            shed, deadline_exceeded = self._shed_count, self._deadline_count
            orphaned, draining = self._orphaned, self._draining
            stragglers = self._drain_stragglers
            conflicts = self._reload_conflicts
        return {
            "conc": self.query_conc,
            "pending": pending,
            "pendingLimit": self.query_conc + self.query_max_pending,
            "peakPending": peak,
            "shed": shed,
            "deadlineExceeded": deadline_exceeded,
            "orphaned": orphaned,
            "deadlineMsDefault": self.query_deadline_ms,
            "draining": draining,
            "drainDeadlineMs": self.drain_deadline_ms,
            "drainStragglers": stragglers,
            "reloadConflicts": conflicts,
        }

    def _request_deadline(self, request: Request
                          ) -> Optional[deadline.Deadline]:
        """Per-request budget: the X-Pio-Deadline-Ms header, else the
        server default (0 = unbounded). A malformed, non-positive or
        non-finite header falls back to the default, and a header may
        loosen only up to PIO_QUERY_DEADLINE_MAX_MS."""
        budget_ms = self.query_deadline_ms
        raw = request.headers.get("X-Pio-Deadline-Ms")
        if raw:
            try:
                hdr = float(raw)
            except ValueError:
                hdr = float("nan")
            if math.isfinite(hdr) and hdr > 0:
                budget_ms = hdr
                if self.query_deadline_max_ms > 0:
                    budget_ms = min(budget_ms, self.query_deadline_max_ms)
        if budget_ms <= 0:
            return None
        return deadline.Deadline(budget_ms)

    def _admit(self) -> None:
        """Take one admission slot or refuse. A slot covers the query
        from acceptance until its compute FINISHES — an orphaned worker
        (past its deadline; threads can't be killed) keeps its slot."""
        with self._adm_lock:
            if self._draining:
                raise AdmissionShed(
                    "server is draining for shutdown", 1.0, "draining")
            cap = self.query_conc + self.query_max_pending
            if self._adm_pending >= cap:
                raise AdmissionShed(
                    f"query admission queue full ({self._adm_pending}"
                    f"/{cap})", 1.0, "full")
            self._adm_pending += 1
            if self._adm_pending > self._adm_peak:
                self._adm_peak = self._adm_pending
            self._unanswered += 1
        self._tls.admitted = getattr(self._tls, "admitted", 0) + 1

    def _shed(self, e: AdmissionShed) -> Reply:
        """Count one shed query; its 503."""
        with self._adm_lock:
            self._shed_count += 1
        return _shed_reply(e)

    def _expired(self, e: deadline.DeadlineExceeded) -> Reply:
        """Count one query past its deadline; its 504."""
        with self._adm_lock:
            self._deadline_count += 1
        return _json(504, {"message": str(e)})

    def _release_slot(self, fut=None) -> None:
        """Admission-slot release, also a future's done-callback; reads
        the future's exception so an orphan failing after its 504 is
        accounted."""
        if fut is not None and not fut.cancelled():
            exc = fut.exception()
            if exc is not None and not isinstance(
                    exc, deadline.DeadlineExceeded):
                log.debug("orphaned/abandoned query failed: %s", exc)
        with self._adm_lock:
            self._adm_pending -= 1

    def _run_admitted_query(self, deployment, query):
        """Executor-thread entry: a query that spent its whole deadline
        waiting in the queue frees the worker at once."""
        dl = deadline.current()
        if dl is not None:
            dl.check("executor pickup")
        return deployment.query(query)

    def _dispatch_query(self, deployment, query, dl, direct: bool = False,
                        on_done: Optional["_Once"] = None):
        """The admission gate — the only way a handler hands a query to
        compute. ``direct=True`` skips the micro-batch queue (whose
        worker always uses the LIVE deployment): the watch window's hedge
        and a tenant's query must run on a deployment of their own.
        ``on_done`` (a tenant's budget) is released with the admission
        slot: when the compute finishes, even after a 504.

        Raises :class:`AdmissionShed` (→ 503) or
        :class:`deadline.DeadlineExceeded` (→ 504)."""
        if dl is not None:
            dl.check("admission")
        self._admit()
        slot_owned_by_future = False
        try:
            timeout = dl.remaining() if dl is not None else None
            bq = self._batch_queue
            if bq is not None and not direct:
                fut: concurrent.futures.Future = concurrent.futures.Future()
                fut.add_done_callback(self._release_slot)
                slot_owned_by_future = True
                bq.put((query, fut))
                try:
                    return fut.result(timeout)
                except concurrent.futures.TimeoutError:
                    # still queued: the batcher drops it; already in a
                    # batch: its slot frees when the batch finishes
                    fut.cancel()
                    raise deadline.DeadlineExceeded(
                        dl.budget_ms, dl.overrun_ms(),
                        "batch queue") from None
            # the deadline rides a copied context into the worker thread
            with deadline.running(dl):
                ctx = contextvars.copy_context()
            cfut = self._query_executor.submit(
                ctx.run, self._run_admitted_query, deployment, query)
            cfut.add_done_callback(self._release_slot)
            if on_done is not None:
                on_done.owned = True
                cfut.add_done_callback(lambda _f: on_done())
            slot_owned_by_future = True
            try:
                return cfut.result(timeout)
            except concurrent.futures.TimeoutError:
                if cfut.cancel():
                    # still queued: the model never saw this query, which
                    # the post-swap watch must not blame on the canary
                    stage = "queued"
                else:
                    # running: the thread frees itself at its next
                    # deadline spend-point and releases its slot then
                    with self._adm_lock:
                        self._orphaned += 1
                    stage = "await"
                raise deadline.DeadlineExceeded(
                    dl.budget_ms, dl.overrun_ms(), stage) from None
        finally:
            if not slot_owned_by_future:
                self._release_slot()

    # -- micro-batching ---------------------------------------------------
    def _start_batcher(self) -> None:
        self._batch_queue = queue.Queue()
        self._batch_thread = threading.Thread(
            target=self._batch_worker, args=(self._batch_queue,),
            name="pio-batcher", daemon=True)
        self._batch_thread.start()

    def _stop_batcher(self) -> None:
        """Stop accepting, let the worker finish its batch, and fail the
        queries still queued instead of leaving their handlers waiting."""
        bq, self._batch_queue = self._batch_queue, None
        if bq is None:
            return
        bq.put(None)
        if self._batch_thread is not None:
            self._batch_thread.join(timeout=10)
        while True:
            try:
                item = bq.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _settle(item[1], exc=RuntimeError(
                    "engine server shutting down"))

    def _batch_worker(self, bq: queue.Queue) -> None:
        """Coalesce queued queries: wait for the first, gather more until
        the window closes (or max_batch), one vectorized dispatch. A
        ``None`` item stops the worker."""
        window = self.batch_window_ms / 1000.0
        while True:
            first = bq.get()
            if first is None:
                return
            batch = [first]
            stop = False
            end = _time.monotonic() + window
            while len(batch) < self.max_batch:
                timeout = end - _time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = bq.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
            # claim each future; one whose deadline cancelled it while
            # queued is dropped instead of burning a batch slot
            batch = [(q, f) for q, f in batch
                     if f.set_running_or_notify_cancel()]
            if batch:
                self._run_batch(batch)
            if stop:
                return

    def _run_batch(self, batch: list) -> None:
        with self._lock:
            deployment = self.deployment
        queries = [q for q, _ in batch]
        try:
            results = deployment.batch_query(queries)
        except Exception:  # noqa: BLE001
            # one bad query (a missing field) must not poison its
            # batchmates: each gets ITS OWN result or error, exactly as
            # on the unbatched path
            for q, fut in batch:
                try:
                    fut.set_result(deployment.query(q))
                except Exception as qe:  # noqa: BLE001
                    fut.set_exception(qe)
            return
        for (_, fut), res in zip(batch, results):
            fut.set_result(res)

    # -- queries -----------------------------------------------------------
    def handle_query(self, request: Request) -> Reply:
        try:
            query = json.loads(request.body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return _json(400, {"message": "invalid JSON body"})
        if self._tenants is not None:
            routed = self._route_tenant_query(request, query)
            if routed is not None:
                return routed
        with self._lock:
            deployment = self.deployment
        if deployment is None:
            return _json(503, {"message": "no model deployed"},
                         {"Retry-After": str(retry_after_jitter(2.0))})
        dl = self._request_deadline(request)
        # plugin hooks run OUTSIDE the watch accounting: a plugin raising
        # on client input is no evidence against a freshly swapped model
        try:
            query = self.plugins.before_query(query)
        except KeyError as e:
            return _missing_field(e)
        except Exception as e:  # noqa: BLE001
            log.exception("before_query plugin failed")
            return _json(500, {"message": str(e)})
        cache = self._query_cache
        ckey = None
        cgen = 0
        if cache is not None and "X-Pio-Probe" not in request.headers:
            # probe traffic bypasses the cache both ways: the probe must
            # measure the real dispatch and not pollute hit/miss counts
            ckey = QueryResultCache.key_for(query, self._cache_app())
            cgen = cache.generation
            cached = cache.get(ckey)
            if cached is not None:
                return self._finish_query(request, query, cached)
        try:
            result = self._dispatch_query(deployment, query, dl)
            self._note_watch(ok=True, deployment=deployment)
            quality = self._quality_runner
            if quality is not None and self._is_live(deployment):
                # one RNG draw here; the scoring runs on its own thread
                quality.offer(query, result)
            if ckey is not None:
                # only clean dispatch results are cached (never a hedged
                # answer); the generation guard drops a stale insert
                cache.put(ckey, result, cgen)
        except AdmissionShed as e:
            return self._shed(e)
        except deadline.DeadlineExceeded as e:
            # accepted but out of time: 504, not 503 — work started
            reply = self._expired(e)
            # a pathologically SLOW new model trips the watch too (compute
            # stages only; queueing is overload, not the model)
            if (e.stage not in _QUEUE_STAGES
                    and self._note_watch(ok=False, deployment=deployment)):
                self._rollback_to_previous("error-rate")
            return reply
        except KeyError as e:
            return _missing_field(e)
        except Exception as e:  # noqa: BLE001 - surfaced as HTTP 500
            log.exception("query failed")
            # inside a post-swap watch: count the failure against the new
            # model and hedge this query onto the retained last-good one;
            # the hedge's own overload/deadline outcomes keep 503/504
            try:
                hedged = self._watched_failure(deployment, query, dl)
            except AdmissionShed as e2:
                return self._shed(e2)
            except deadline.DeadlineExceeded as e2:
                return self._expired(e2)
            if hedged is None:
                return _json(500, {"message": str(e)})
            result = hedged
        return self._finish_query(request, query, result)

    # -- multi-tenant routing (the mux is workflow/multitenant.py) --------
    def _default_app_name(self) -> str:
        """The app of the process's default deployment: anonymous queries
        and this app's named ones take the single-tenant path."""
        from . import model_artifact

        with self._lock:
            inst = self.instance
        name = (model_artifact.instance_app_name(inst)
                if inst is not None else "")
        return name or (self.feedback_app_name or "")

    def _cache_app(self) -> Optional[str]:
        """The cache-key app of the DEFAULT query path: None while
        single-tenant, the default app once the mux is armed (the default
        tenant's entries are app-scoped like everyone else's)."""
        if self._tenants is None:
            return None
        return self._default_app_name() or None

    def _tenant_cache_invalidate(self, app: str, users=None) -> None:
        """Invalidate ONE tenant's cached results: by the fold-in footprint
        when there is one, else all of that tenant's; never a neighbor's."""
        cache = self._query_cache
        if cache is None:
            return
        n = (cache.invalidate_users(users, app=app) if users
             else cache.flush_app(app, "tenant"))
        if n:
            log.info("tenant %r: invalidated %d cached result(s)", app, n)

    def _route_tenant_query(self, request: Request, query) -> Optional[Reply]:
        """Route a query to its tenant, or None for the default path (an
        anonymous query, or one naming the default app). A bad credential
        is 401 and an unknown app 404, never a fallthrough to the default
        app's model."""
        from . import multitenant

        mux = self._tenants
        try:
            app = mux.resolve_app(request)
        except multitenant.UnknownTenant as e:
            return _json(401, {"message": str(e)})
        if app is None or app == self._default_app_name():
            return None
        dl = self._request_deadline(request)
        # plugin hooks run OUTSIDE the tenant's watch accounting
        try:
            query = self.plugins.before_query(query)
        except KeyError as e:
            return _missing_field(e)
        except Exception as e:  # noqa: BLE001
            log.exception("before_query plugin failed")
            return _json(500, {"message": str(e)})
        try:
            state = mux.admit(app)
        except multitenant.UnknownTenant as e:
            return _json(404, {"message": str(e)})
        except AdmissionShed as e:
            # the TENANT's budget refused; the process gate still guards
            # the dispatch below
            return _shed_reply(e)
        release = _Once(lambda: mux.release(state))
        try:
            return self._tenant_query(request, state, query, dl, release)
        finally:
            # a dispatched query's budget frees with its compute (an
            # orphan past its deadline keeps it until it finishes)
            if not release.owned:
                release()

    def _tenant_query(self, request: Request, state, query, dl,
                      release: "_Once") -> Reply:
        """One admitted tenant query: lazy load, the app-scoped cache, the
        process admission gate, and the tenant's watch with the
        rollback-and-answer hedge."""
        mux = self._tenants
        try:
            mux.ensure_loaded(state)
        except Exception as e:  # noqa: BLE001 — nothing deployable for
            # THIS app: the tenant is unavailable, the process is healthy
            log.warning("tenant %r load failed: %s", state.name, e)
            return _json(503, {"message": f"tenant {state.name!r}: {e}"},
                         {"Retry-After": str(retry_after_jitter(2.0))})
        cache = self._query_cache
        ckey = None
        cgen = 0
        if cache is not None and "X-Pio-Probe" not in request.headers:
            ckey = QueryResultCache.key_for(query, state.name)
            cgen = cache.generation
            cached = cache.get(ckey)
            if cached is not None:
                return self._finish_query(request, query, cached)
        deployment = state.deployment
        try:
            # direct: the micro-batch worker serves the default deployment
            result = self._dispatch_query(deployment, query, dl,
                                          direct=True, on_done=release)
            mux.note_result(state, ok=True)
            if ckey is not None:
                cache.put(ckey, result, cgen)
        except AdmissionShed as e:
            return self._shed(e)
        except deadline.DeadlineExceeded as e:
            reply = self._expired(e)
            # compute-stage overruns count against the tenant's OWN watch
            if (e.stage not in _QUEUE_STAGES
                    and mux.note_result(state, ok=False)):
                mux.rollback_tenant(state, "error-rate")
            return reply
        except KeyError as e:
            return _missing_field(e)
        except Exception as e:  # noqa: BLE001 — the tenant's watch + hedge
            log.exception("tenant %r query failed", state.name)
            restored = None
            if mux.note_result(state, ok=False):
                # watch breach: pin and roll back THIS tenant alone
                restored = mux.rollback_tenant(state, "error-rate")
            if restored is None:
                return _json(500, {"message": str(e)})
            # answer the triggering query on the restored deployment
            try:
                result = self._dispatch_query(restored, query, dl,
                                              direct=True)
            except AdmissionShed as e2:
                return self._shed(e2)
            except deadline.DeadlineExceeded as e2:
                return self._expired(e2)
            except Exception:  # noqa: BLE001 — the original verdict
                return _json(500, {"message": str(e)})
        return self._finish_query(request, query, result)

    def _finish_query(self, request: Request, query, result) -> Reply:
        """The response tail of dispatched AND cache-hit results:
        after_query plugins, the probe-marker bypass, the query count and
        the feedback self-log."""
        try:
            result = self.plugins.after_query(query, result)
        except KeyError as e:
            return _missing_field(e)
        except Exception as e:  # noqa: BLE001
            log.exception("after_query plugin failed")
            return _json(500, {"message": str(e)})
        probe = request.headers.get("X-Pio-Probe")
        # bytes comparison: compare_digest raises TypeError on non-ASCII
        # str, which a hostile header could use to 500 an answered query
        if probe and hmac.compare_digest(
                probe.encode("utf-8", "surrogateescape"),
                self._probe_token.encode()):
            return _json(200, result)
        with self._lock:
            self._query_count += 1
        if self.feedback:
            # not fire-and-forget: a failing event store is logged and
            # counted (droppedFeedback on /status)
            fut = self._feedback_executor.submit(self._log_feedback, query,
                                                 result)
            fut.add_done_callback(self._feedback_done)
        return _json(200, result)

    def _feedback_done(self, fut: concurrent.futures.Future) -> None:
        if fut.cancelled() or fut.exception() is not None:
            with self._lock:
                self._dropped_feedback += 1
                dropped = self._dropped_feedback
            if not fut.cancelled():
                log.error("feedback logging failed (dropped=%d): %s",
                          dropped, fut.exception())

    def _log_feedback(self, query: Any, result: Any) -> None:
        """Self-log the prediction as a "predict" event (reference:
        CreateServer's feedback loop). Raises on failure; the
        done-callback owns logging and the dropped counter."""
        app_name = self.feedback_app_name
        if not app_name or self.storage is None:
            return
        app = self.storage.get_meta_data_apps().get_by_name(app_name)
        if app is None:
            return
        self.storage.get_l_events().insert(
            Event(
                event="predict",
                entity_type="pio_pr",  # server-generated: prefix allowed
                entity_id=(str(query.get("user", ""))
                           if isinstance(query, dict) else ""),
                properties=DataMap({"query": query, "result": result}),
            ),
            app.id,
        )

    # -- startup latency probe --------------------------------------------
    def probe_and_record(self, base_url: str, n: int = 60) -> Optional[dict]:
        """Measure the full-path query latency split against the LIVE
        server (real HTTP over loopback, one keep-alive connection) and
        persist it to the instance row (``runtime_conf["probe_latency"]``):
        http_full (wire to wire), predict (``Deployment.query``: host
        gather, top-k on the device, the read back), the bare device
        round trip (a one-element op and its read back) and the JSON
        parse. http − predict = the server's HTTP and queueing overhead;
        predict − rtt ≈ the top-k's device work and transfer."""
        import http.client
        import time

        with self._lock:
            deployment, instance = self.deployment, self.instance
        example = self._find_example_query(deployment)
        if example is None:
            log.warning("probe-latency: no deployed model provides "
                        "example_query(); skipping")
            return None
        body = json.dumps(example).encode()
        parsed = urllib.parse.urlsplit(base_url)
        conn_box: list = [None]

        def connect():
            if parsed.scheme != "https":
                return http.client.HTTPConnection(
                    parsed.hostname, parsed.port, timeout=60)
            return http.client.HTTPSConnection(
                parsed.hostname, parsed.port, timeout=60,
                context=loopback_client_context())

        def post():
            for attempt in (0, 1):
                if conn_box[0] is None:
                    conn_box[0] = connect()
                conn = conn_box[0]
                try:
                    conn.request(
                        "POST", "/queries.json", body=body,
                        headers={"Content-Type": "application/json",
                                 "X-Pio-Probe": self._probe_token})
                    conn.getresponse().read()
                    return
                except (http.client.HTTPException, OSError):
                    # the server dropped the idle connection: reconnect
                    # and retry the sample once
                    conn.close()
                    conn_box[0] = None
                    if attempt:
                        raise

        def pct(a, p):
            a = sorted(a)
            return a[min(len(a) - 1, round(p / 100 * (len(a) - 1)))]

        for _ in range(5):  # warm the connection and the device path
            post()
        http_ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            post()
            http_ms.append((time.perf_counter() - t0) * 1e3)
        if conn_box[0] is not None:
            conn_box[0].close()
        parse_ms, predict_ms = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            q = json.loads(body)
            parse_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            deployment.query(q)
            predict_ms.append((time.perf_counter() - t0) * 1e3)
        rtt_ms = []
        x = torch.zeros(8, device=self.device)
        (x + 1).cpu()
        for _ in range(n):
            t0 = time.perf_counter()
            (x + 1).cpu()
            rtt_ms.append((time.perf_counter() - t0) * 1e3)

        result = {
            "n": n,
            "attachment": _device_attachment(self.device),
            "http_p50_ms": round(pct(http_ms, 50), 3),
            "http_p99_ms": round(pct(http_ms, 99), 3),
            "predict_p50_ms": round(pct(predict_ms, 50), 3),
            "predict_p99_ms": round(pct(predict_ms, 99), 3),
            "dispatch_rtt_p50_ms": round(pct(rtt_ms, 50), 3),
            "parse_p50_ms": round(pct(parse_ms, 50), 4),
        }
        result["overhead_p50_ms"] = round(
            max(result["http_p50_ms"] - result["predict_p50_ms"], 0.0), 3)
        result["onchip_plus_transfer_p50_ms"] = round(
            max(result["predict_p50_ms"] - result["dispatch_rtt_p50_ms"],
                0.0), 3)
        print(f"[probe] full-path p50={result['http_p50_ms']}ms "
              f"p99={result['http_p99_ms']}ms over {n} queries "
              f"({result['attachment']})")
        print(f"[probe]   predict (gather+top-k+read back) "
              f"p50={result['predict_p50_ms']}ms")
        print(f"[probe]   bare device round trip "
              f"p50={result['dispatch_rtt_p50_ms']}ms → on-device+transfer "
              f"≈ {result['onchip_plus_transfer_p50_ms']}ms")
        print(f"[probe]   http+queue overhead p50="
              f"{result['overhead_p50_ms']}ms, json parse "
              f"p50={result['parse_p50_ms']}ms", flush=True)
        if instance is None:
            return result  # the file form has no instance row
        try:
            import dataclasses as _dc

            instances = self.storage.get_meta_data_engine_instances()
            fresh = instances.get(instance.id) or instance
            updated = _dc.replace(
                fresh,
                runtime_conf={**fresh.runtime_conf,
                              "probe_latency": json.dumps(result)})
            instances.update(updated)
            with self._lock:
                # keep the live status page in sync with the stored row
                if (self.instance is not None
                        and self.instance.id == updated.id):
                    self.instance = updated
        except Exception:  # noqa: BLE001 - persistence is best-effort
            log.exception("probe-latency: persisting to instance row failed")
        return result

    # -- post-swap watch + rollback ---------------------------------------
    def lifecycle_snapshot(self) -> dict:
        """Model-lifecycle state for /status and `pio status
        --engine-url`."""
        from . import model_artifact

        with self._lock:
            cur, prev = self.instance, self._chain.previous
            pinned = dict(self._pinned)
            rollbacks = dict(self._rollbacks)
            swaps = self._swap_count
            validate_failures = self._validate_failures
            refresh_swaps = self._refresh_swaps
            w = self._chain.watch
            watch = ({"total": w["total"], "errors": w["errors"]}
                     if w is not None else None)
        return {
            "instance": cur.id if cur else None,
            "previous": prev[1].id if prev else None,
            # process-wide: every blob the verifying loader refused here
            "integrityFailures": model_artifact.integrity_failure_counts(),
            "pinned": pinned,
            "rollbacks": rollbacks,
            "swaps": swaps,
            "validateFailures": validate_failures,
            "validate": self.swap_validate,
            "refreshMs": (f"disabled({self._refresh_disabled})"
                          if self._refresh_disabled
                          else self.model_refresh_ms),
            "refreshSwaps": refresh_swaps,
            "watchMs": self.swap_watch_ms,
            "maxErrorRate": self.swap_max_error_rate,
            "watch": watch,
        }

    def _is_live(self, deployment) -> bool:
        """Whether ``deployment`` is the one published: outcomes of
        queries dispatched to a pre-swap deployment don't count."""
        with self._lock:
            return self.deployment is deployment

    def _live_id(self) -> Optional[str]:
        """Lock held: the live instance's id, or None."""
        return self.instance.id if self.instance is not None else None

    def _note_watch(self, ok: bool, deployment=None) -> bool:
        """Record one query outcome against the post-swap watch (only
        when ``deployment``, if given, is still the live one: outcomes of
        queries dispatched to a pre-swap deployment don't count). True
        when the error rate tripped the rollback threshold: at least 2
        failures AND a failure fraction above PIO_SWAP_MAX_ERROR_RATE, so
        one flaky query can't roll back a healthy model; within a chain
        of unobserved swaps, counted back from the live link
        (:meth:`SwapChain.note`)."""
        with self._lock:
            if deployment is not None and self.deployment is not deployment:
                return False
            return self._chain.note(ok, self._live_id(), _time.monotonic(),
                                    self.swap_max_error_rate)

    def _chain_full(self) -> bool:
        """Whether an automatic publish must wait (:meth:`SwapChain.full`):
        a chain spans at most one watch window plus one load, and the
        previous deployment is at most two windows older than the live
        one."""
        with self._lock:
            return self._chain.full(self._live_id(), _time.monotonic(),
                                    self.swap_watch_ms)

    def _rollback_to_previous(self, reason: str) -> Optional[str]:
        """Instant swap back to the resident previous deployment (no
        store round trip: it stayed warm on the card). The bad instance,
        and every instance of the chain swapped in since the previous
        one went out, is PINNED, so neither the latest-completed walk nor
        the refresh loop re-picks a poisoned link; no blob is deleted.
        Returns the restored instance id, or None when no previous
        deployment is resident."""
        with self._lock:
            if self._chain.previous is None:
                return None
            bad_inst = self.instance
            prev, pins = self._chain.rollback(bad_inst.id)
            self.deployment, self.instance = prev
            restored = self.instance
            # the bad instance's quality watch dies with it: the restored
            # model is the last-good baseline, not a canary
            self._quality_watch = None
            for iid in pins:
                self._pinned.setdefault(iid, reason)
            self._rollbacks[reason] = self._rollbacks.get(reason, 0) + 1
        if self._query_cache is not None:
            # every cached result came from the model rolled away from
            n = self._query_cache.flush("rollback")
            log.info("query cache: flushed %d entrie(s) on rollback", n)
        self._degraded_reason = (
            f"rolled back from {bad_inst.id} to {restored.id} ({reason}) "
            f"at {_dt.datetime.now(_dt.timezone.utc).isoformat()}; "
            f"{bad_inst.id} pinned until an operator reloads it "
            "explicitly")
        from . import online

        if online.is_foldin_instance(bad_inst):
            # a poisoned increment counts on the fold-in family too
            online.note_rollback(reason)
        log.warning("automatic rollback (%s): %s → %s; %s pinned",
                    reason, bad_inst.id, restored.id, ", ".join(pins))
        return restored.id

    def _watched_failure(self, deployment, query, dl):
        """A query failed on ``deployment``: inside its post-swap watch,
        hedge it onto the last-good deployment and — only when last-good
        SUCCEEDS (a query failing on both is the query's problem) — count
        the failure against the new model, rolling back past the error
        rate. Returns the hedged result, or None (the caller answers the
        original error). The hedge's own AdmissionShed /
        DeadlineExceeded propagate: they are the server's state, 503/504,
        and never count against the watch."""
        with self._lock:
            w = self._chain.watch
            live_dep = self.deployment
            prev = self._chain.previous
            stale = w is not None and self._chain.close_stale(
                w, self._live_id(), _time.monotonic())
        if w is None:
            # no watch, but the failed deployment is no longer live: a
            # rollback or swap landed mid-flight, and the client deserves
            # the live model's answer, not the retired model's 500
            if live_dep is not None and live_dep is not deployment:
                try:
                    return self._dispatch_query(live_dep, query, dl,
                                                direct=True)
                except (AdmissionShed, deadline.DeadlineExceeded):
                    raise
                except Exception:  # noqa: BLE001 - original error stands
                    log.exception("retry on live model failed")
            return None
        if stale:
            # outside the watch the client gets the live model's error
            return None
        if live_dep is not deployment:
            # a concurrent query already rolled back: serve the restored
            try:
                return self._dispatch_query(live_dep, query, dl,
                                            direct=True)
            except (AdmissionShed, deadline.DeadlineExceeded):
                raise
            except Exception:  # noqa: BLE001 - original error stands
                log.exception("retry on restored model failed")
                return None
        if prev is None:
            return None
        try:
            # direct: the micro-batch queue would use the live canary
            result = self._dispatch_query(prev[0], query, dl, direct=True)
        except (AdmissionShed, deadline.DeadlineExceeded):
            raise
        except Exception:  # noqa: BLE001 - fails on BOTH models
            log.exception("hedged retry on last-good model failed too; "
                          "not counting against the new model")
            return None
        if self._note_watch(ok=False):
            self._rollback_to_previous("error-rate")
        return result

    def _note_reload_conflict(self) -> None:
        with self._adm_lock:
            self._reload_conflicts += 1

    def _no_store(self, what: str) -> Reply:
        return _json(409, {
            "message": f"{what} needs the model store: this server serves "
                       "one deployment from a model file (deploy --model) "
                       "and has no engine instances to swap between",
            "engineInstanceId": None})

    def handle_rollback(self, request: Request) -> Reply:
        """Operator rollback to the retained previous deployment (`pio
        models rollback`, `pio deploy --rollback`): instant, and pins the
        rolled-back instance."""
        if self.file_form:
            return self._no_store("rollback")
        if not self._reload_lock.acquire(blocking=False):
            self._note_reload_conflict()
            return _json(409, {"message": "reload in progress; retry "
                                          "shortly"})
        try:
            restored = self._rollback_to_previous("manual")
            if restored is None and self.fleet_mode:
                restored = self._fleet_rollback_via_store()
        finally:
            self._reload_lock.release()
        if restored is None:
            return _json(409, {"message": "no previous deployment resident "
                                          "to roll back to"})
        if self.fleet_mode:
            # propagate now instead of at the next tick: the pin lands in
            # this replica's status row, the coordinator merges it and the
            # whole fleet converges on last-good
            self._fleet_poke.set()
        return _json(200, {"message": "Rolled back",
                           "engineInstanceId": restored,
                           **({"fleet": True} if self.fleet_mode else {})})

    # -- continuous refresh ------------------------------------------------
    def _start_refresher(self) -> None:
        if self.model_refresh_ms <= 0:
            return
        self._refresh_stop.clear()
        self._refresh_thread = threading.Thread(
            target=self._refresh_loop, name="pio-refresh", daemon=True)
        self._refresh_thread.start()

    def _stop_refresher(self) -> None:
        self._refresh_stop.set()
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=30)
            self._refresh_thread = None

    def _refresh_loop(self) -> None:
        """Poll for a newer COMPLETED instance and hot-swap it through the
        SAME validated gate as /reload. A poll or storage error is logged
        and retried next tick: the loop never dies."""
        log.info("model refresh loop armed (every %.0f ms)",
                 self.model_refresh_ms)
        while not self._refresh_stop.wait(self.model_refresh_ms / 1000.0):
            try:
                self._refresh_once()
            except Exception:  # noqa: BLE001 - poll errors never kill it
                log.exception("model refresh poll failed; retrying next "
                              "tick")

    def _refresh_once(self) -> None:
        candidate = self._newer_candidate()
        if candidate is None:
            return
        log.info("refresh: newer COMPLETED instance %s; validating "
                 "hot swap", candidate.id)
        if self._publish_once("refresh") == "swapped":
            with self._lock:
                self._refresh_swaps += 1

    def _publish_once(self, source: str) -> str:
        """THE publish-through-gate entry point outside an operator
        /reload (the refresh loop; the online fold-in will share it):
        validated load of the newest deployable instance (skip-if-
        current), gate refusal pinned with degraded mode, integrity
        rejections pinned, the post-swap watch armed by the swap itself.
        Returns "swapped" | "current" | "busy" | "deferred" | "refused" |
        "error"; "deferred" while the chain of unobserved swaps is full
        (:meth:`_chain_full`)."""
        if self._chain_full():
            return "deferred"
        if not self._reload_lock.acquire(blocking=False):
            return "busy"
        try:
            rejected: list[tuple[str, str]] = []
            result = "current"
            try:
                swapped = self._load(
                    None, True,
                    lambda iid, kind: rejected.append((iid, kind)),
                    chain=True)
            except SwapValidationError as e:
                with self._lock:
                    self._validate_failures += 1
                    self._pinned[e.instance_id] = "validate"
                self._degraded_reason = (
                    f"{source}: {e}; serving last-good model "
                    f"({e.instance_id} pinned)")
                log.warning("%s swap refused: %s", source, e)
                # a refused fold-in increment counts on its family whichever
                # loop's gate caught it
                self._count_foldin_refusal(e.instance_id)
                result = "refused"
            except Exception as e:  # noqa: BLE001 - stay on last-good
                self._degraded_reason = (
                    f"{source} reload failed at "
                    f"{_dt.datetime.now(_dt.timezone.utc).isoformat()}: "
                    f"{e}; serving last-good model")
                log.exception("%s reload failed; continuing on "
                              "last-good model", source)
                result = "error"
            else:
                if swapped:
                    result = "swapped"
                # the load succeeded: an earlier degraded reason no longer
                # describes reality
                self._degraded_reason = None
            # a corrupt blob won't heal: pin it so every poll does not
            # re-walk (and re-count) it
            for iid, kind in rejected:
                with self._lock:
                    self._pinned.setdefault(iid, f"integrity:{kind}")
                log.warning("%s: pinned undeployable instance %s "
                            "(%s)", source, iid, kind)
            return result
        finally:
            self._reload_lock.release()

    def _count_foldin_refusal(self, instance_id: str) -> None:
        """A gate-refused instance that carries the fold-in marker counts
        one ``validate`` fold-in rollback. Best-effort accounting."""
        from . import online

        try:
            row = self.storage.get_meta_data_engine_instances().get(
                instance_id)
        except Exception:  # noqa: BLE001 — accounting only
            log.debug("fold-in refusal classification failed",
                      exc_info=True)
            return
        if row is not None and online.is_foldin_instance(row):
            online.note_rollback("validate")

    def _newer_candidate(self):
        """The newest non-pinned COMPLETED instance strictly newer than
        the live one (of the default app, with the tenant mux armed), or
        None when up to date."""
        from . import model_artifact

        with self._lock:
            cur = self.instance
            pinned = set(self._pinned)
        return model_artifact.newer_completed_instance(
            self.storage.get_meta_data_engine_instances(),
            self.engine_factory_name, self.engine_variant, cur,
            exclude=pinned, app_name=self._cache_app())

    # -- streaming online fold-in -------------------------------------------
    def foldin_snapshot(self) -> dict:
        """The /status "foldin" section: the runner's last view (the cursor,
        events, publishes) with the freshness lag recomputed at read time
        (a wedged tick freezes the view), the fold-in refusals and
        rollbacks by reason, and the loop's failed ticks."""
        from . import online

        fv = self._foldin_view
        if fv and fv.get("caughtUpAt"):
            fv = {**fv, "lagSeconds": round(
                max(0.0, _time.time() - fv["caughtUpAt"]), 3)}
        return {**(fv or {"enabled": True, "ms": self.foldin_ms,
                          "events": 0, "publishes": 0,
                          "lagSeconds": None}),
                "producer": self._foldin_producer,
                "rollbacks": online.rollback_counts(),
                "tickErrors": self._foldin_tick_errors}

    @property
    def _foldin_producer(self) -> bool:
        """One producer per fleet: replica 0 (any single server)."""
        return not self.fleet_mode or self.fleet_replica == 0

    def _start_foldin(self) -> None:
        if self.foldin_ms <= 0:
            return
        if not self._foldin_producer:
            # replica 0 commits the increments and the coordinator canaries
            # them to everyone: N replicas folding the same events would
            # race N duplicate instance rows into the store
            log.info("fold-in: replica %d stands by — replica 0 is the "
                     "fleet's fold-in producer", self.fleet_replica)
            return
        from . import online

        runner = self._foldin_runner = online.FoldInRunner(
            self.storage, self.engine_factory_name, self.engine_variant,
            interval_ms=self.foldin_ms, device=self.device)
        with self._lock:
            instance = self.instance
        if instance is not None:
            # arm BEFORE the port opens: a cursor anchored on the first
            # tick would skip the events of the start → first-tick window
            try:
                runner.arm(instance)
            except Exception:  # noqa: BLE001 — the first tick retries
                log.exception("fold-in arm failed; the first tick retries")
        self._foldin_view = runner.view()
        self._foldin_stop.clear()
        self._foldin_thread = threading.Thread(
            target=self._foldin_loop, name="pio-foldin", daemon=True)
        self._foldin_thread.start()

    def _stop_foldin(self) -> None:
        self._foldin_stop.set()
        if self._foldin_thread is not None:
            # a tick in flight finishes its increment first
            self._foldin_thread.join(timeout=120)
            self._foldin_thread = None

    def _foldin_loop(self) -> None:
        """Every ``foldin_ms``: fold the app's new events into a copy of
        the served models, commit the increment and publish it through the
        refresh loop's gate. A failed tick is logged, counted and retried;
        the freshness lag grows until a tick lands."""
        log.info("online fold-in loop armed (every %.0f ms)", self.foldin_ms)
        while not self._foldin_stop.wait(self.foldin_ms / 1000.0):
            try:
                self._foldin_once()
            except Exception:  # noqa: BLE001 - tick errors never kill it
                self._foldin_tick_errors += 1
                log.exception("fold-in tick failed; retrying next tick")

    def _foldin_once(self) -> None:
        if self._tenants is not None:
            # each resident tenant's runner reads its own cursor row and
            # publishes through that tenant's gate and watch
            self._tenants.foldin_tick()
        with self._lock:
            deployment, instance = self.deployment, self.instance
            pinned = tuple(self._pinned)
        runner = self._foldin_runner
        if deployment is None or instance is None or runner is None:
            return
        try:
            view = runner.run_once(deployment, instance, pinned)
        finally:
            self._foldin_view = runner.view()
        if self.fleet_mode:
            if view.get("instance"):
                # the coordinator finds the new COMPLETED row on its next
                # tick and stages it as a canary; publishing here would
                # bypass the staged rollout
                log.info("fold-in: instance %s committed; awaiting the "
                         "fleet coordinator's canary staging",
                         view["instance"])
            return
        # produced this tick OR still pending from an earlier one (a busy
        # gate must not strand a committed increment until the next event)
        if not view.get("instance") and not view.get("pendingInstance"):
            return
        self._publish_once("foldin")
        self._foldin_view = runner.view()

    # -- continuous quality evaluation --------------------------------------
    def quality_snapshot(self) -> dict:
        """The /status "quality" section: the scorer's last view and the
        open quality watch."""
        qw = self._quality_watch
        return {
            **(self._quality_view or {"enabled": True,
                                      "sample": self.quality_sample,
                                      "sampled": 0, "scored": 0}),
            "watchMs": self.quality_watch_ms,
            "watch": ({"instance": qw["instance"],
                       "remainingMs": round(max(
                           0.0, (qw["until"] - _time.monotonic()) * 1e3),
                           1)}
                      if qw is not None else None),
        }

    def _start_quality(self) -> None:
        if self.quality_sample <= 0:
            return
        from . import quality

        self._quality_runner = quality.QualityShadow(
            self.storage, sample=self.quality_sample, k=self.quality_k,
            min_samples=self.quality_min_samples,
            max_drop=self.quality_max_drop,
            resolve_ms=self.quality_resolve_ms, device=self.device)
        self._quality_view = self._quality_runner.view()
        self._quality_stop.clear()
        self._quality_thread = threading.Thread(
            target=self._quality_loop, name="pio-quality", daemon=True)
        self._quality_thread.start()

    def _stop_quality(self) -> None:
        self._quality_stop.set()
        if self._quality_thread is not None:
            self._quality_thread.join(timeout=60)
            self._quality_thread = None

    def _quality_loop(self) -> None:
        """Every ``quality_ms``: shadow-score the sampled queries and roll
        a quality-watch breach back through the error-rate rollback path
        (reason "quality"). A failed tick is logged and retried."""
        log.info("quality shadow loop armed (sample %.3f, every %.0f ms, "
                 "watch %.0f ms, min %d samples, max ndcg drop %.3f)",
                 self.quality_sample, self.quality_ms,
                 self.quality_watch_ms, self.quality_min_samples,
                 self.quality_max_drop)
        while not self._quality_stop.wait(self.quality_ms / 1000.0):
            try:
                self._quality_once()
            except Exception:  # noqa: BLE001 - tick errors never kill it
                log.exception("quality tick failed; retrying next tick")

    def _quality_once(self) -> None:
        runner = self._quality_runner
        with self._lock:
            deployment, instance = self.deployment, self.instance
            prev = self._chain.previous
            qw = self._quality_watch
            if qw is not None and (instance is None
                                   or instance.id != qw["instance"]
                                   or _time.monotonic() > qw["until"]):
                # superseded by a newer swap or rollback, or closed clean
                if instance is not None and instance.id == qw["instance"]:
                    log.info("quality watch for %s closed clean",
                             qw["instance"])
                self._quality_watch = qw = None
        if runner is None or deployment is None or instance is None:
            return
        try:
            view = runner.run_once(deployment, instance,
                                   prev[0] if prev is not None else None)
        finally:
            self._quality_view = runner.view()
        if not view.get("breach") or qw is None:
            return
        with self._lock:
            live = self.instance
            armed = (self._quality_watch is qw and live is not None
                     and live.id == qw["instance"])
        if not armed:
            return
        restored = self._rollback_to_previous("quality")
        if restored:
            log.warning("quality watch breach on %s (ndcg drop %.4f > %.4f "
                        "over %d graded samples): rolled back to %s",
                        qw["instance"], view["deltas"].get("ndcg", 0.0),
                        self.quality_max_drop,
                        view.get("live", {}).get("n", 0), restored)

    def handle_reload(self, request: Request) -> Reply:
        """Hot-swap to the latest completed instance (reference: /reload →
        MasterActor ! ReloadServer) or, with ``?instance=<id>``, to that
        instance (verified and validated like any swap, and un-pinned on
        success). A failed reload never takes serving down: the last-good
        model stays live in degraded mode. Two concurrent reloads: the
        loser gets 409."""
        if self.file_form:
            return self._no_store("reload")
        if self.fleet_mode:
            # through the front a reload lands on ONE replica and the next
            # directive sync reverts it: rollouts are the coordinator's
            with self._lock:
                inst = self.instance
            return _json(409, {
                "message": "fleet mode: model rollout is coordinator-driven "
                           "— retrain to stage a canary, POST /rollback for "
                           "a fleet rollback",
                "engineInstanceId": inst.id if inst else None})
        target = (request.params.get("instance") or [None])[0] or None
        if not self._reload_lock.acquire(blocking=False):
            self._note_reload_conflict()
            with self._lock:
                inst = self.instance
            return _json(409, {"message": "reload already in progress",
                               "engineInstanceId": inst.id if inst else None})
        try:
            try:
                self._load(target)
            except Exception as e:  # noqa: BLE001
                if isinstance(e, SwapValidationError):
                    with self._lock:
                        self._validate_failures += 1
                self._degraded_reason = (
                    f"reload failed at "
                    f"{_dt.datetime.now(_dt.timezone.utc).isoformat()}: {e}; "
                    "serving last-good model")
                log.exception("reload failed; continuing on last-good model")
                with self._lock:
                    inst = self.instance
                return _json(500, {"message": str(e), "degraded": True,
                                   "engineInstanceId":
                                       inst.id if inst else None})
            if target:
                # the operator chose (and the gate passed) this version:
                # a standing pin no longer applies
                with self._lock:
                    self._pinned.pop(target, None)
        finally:
            self._reload_lock.release()
        self._degraded_reason = None
        with self._lock:
            inst = self.instance
        return _json(200, {"message": "Reloaded",
                           "engineInstanceId": inst.id})

    # -- replica fleet (store-mediated staged rollout) ---------------------
    def _fleet_bootstrap_load(self) -> None:
        """Initial load of a fleet replica: honour the fleet record BEFORE
        the instance walk, so a replica relaunched after a fleet rollback
        comes up on the directed last-good instance with the fleet's pins
        applied, not on the newest COMPLETED row (which may be exactly the
        poisoned artifact the fleet just rolled back)."""
        from . import model_artifact

        row_id = model_artifact.fleet_row_id(self._fleet_group())
        directive = model_artifact.read_fleet_doc(self.storage, row_id)
        if directive is None:
            # one short retry separates "no directive yet" from a read that
            # lands in a backend's delete-then-insert gap
            _time.sleep(0.05)
            directive = model_artifact.read_fleet_doc(self.storage, row_id)
        directive = directive or {}
        with self._lock:
            for iid, reason in (directive.get("pinned") or {}).items():
                self._pinned.setdefault(iid, reason)
            pinned = set(self._pinned)
        want = directive.get("instance")
        if want and want not in pinned:
            try:
                self._load(want)
                return
            except Exception:  # noqa: BLE001 - degrade to the walk
                log.warning("fleet directive instance %s not deployable at "
                            "startup; walking back to latest", want,
                            exc_info=True)
        self._load(None)

    def _start_fleet(self) -> None:
        if not self.fleet_mode:
            return
        self._fleet_stop.clear()
        self._fleet_thread = threading.Thread(
            target=self._fleet_loop, name="pio-fleet-sync", daemon=True)
        self._fleet_thread.start()

    def _stop_fleet(self) -> None:
        self._fleet_stop.set()
        self._fleet_poke.set()
        if self._fleet_thread is not None:
            self._fleet_thread.join(timeout=60)
            self._fleet_thread = None

    def _fleet_loop(self) -> None:
        """Every ``PIO_FLEET_SYNC_MS`` (or at once when ``/rollback`` pokes
        it): apply the coordinator's directive and publish this replica's
        status row. Single-flight (only this thread syncs); a storage error
        is logged and retried next tick."""
        log.info("fleet sync loop armed (replica %d, every %.0f ms)",
                 self.fleet_replica, self.fleet_sync_ms)
        while not self._fleet_stop.is_set():
            try:
                self._fleet_sync()
            except Exception:  # noqa: BLE001 - poll errors never kill it
                log.exception("fleet sync failed; retrying next tick")
            self._fleet_poke.wait(self.fleet_sync_ms / 1000.0)
            self._fleet_poke.clear()

    def _fleet_sync(self) -> None:
        from . import model_artifact

        directive = model_artifact.read_fleet_doc(
            self.storage,
            model_artifact.fleet_row_id(self._fleet_group())) or {}
        with self._lock:
            # fleet pins propagate to every replica: no walk here may ever
            # re-pick an instance a peer rolled back
            for iid, reason in (directive.get("pinned") or {}).items():
                self._pinned.setdefault(iid, reason)
            pinned = set(self._pinned)
            cur = self.instance
        want = directive.get("instance")
        if (directive.get("state") == "canary"
                and directive.get("canaryReplica") == self.fleet_replica
                and directive.get("target")):
            # staged rollout: ONLY the canary swaps to the target; the rest
            # hold the directed instance until a clean window promotes
            want = directive.get("target")
        if (want and want not in pinned and (cur is None or want != cur.id)
                and self._reload_lock.acquire(blocking=False)):
            try:
                with self._lock:
                    cur = self.instance
                if cur is None or want != cur.id:
                    self._fleet_apply(want)
            finally:
                self._reload_lock.release()
        self._fleet_publish(directive)

    def _fleet_apply(self, want: str) -> None:
        """Apply one directive target through this replica's own gate
        (caller holds the reload lock). A directed rollback to the still
        resident previous deployment swaps back at once; other targets take
        the full verified and validated load. A refusal pins (validate,
        integrity) and a transient failure degrades: the coordinator sees
        the pin in the next status row and propagates it."""
        from . import model_artifact

        with self._lock:
            prev = self._chain.previous
        if prev is not None and prev[1].id == want:
            self._rollback_to_previous("fleet")
            return
        try:
            self._load(want)
        except SwapValidationError as e:
            with self._lock:
                self._validate_failures += 1
                self._pinned.setdefault(e.instance_id, "validate")
            self._degraded_reason = (
                f"fleet: {e}; serving last-good model "
                f"({e.instance_id} pinned)")
            log.warning("fleet swap refused by gate: %s", e)
            self._count_foldin_refusal(e.instance_id)
        except model_artifact.ModelIntegrityError as e:
            with self._lock:
                self._pinned.setdefault(e.instance_id,
                                        f"integrity:{e.kind}")
            self._degraded_reason = (
                f"fleet: directed instance {e.instance_id} failed "
                f"integrity ({e.kind}); serving last-good model")
            log.warning("fleet swap refused by integrity: %s", e)
        except Exception as e:  # noqa: BLE001 - transient: retry next tick
            self._degraded_reason = (
                f"fleet reload failed at "
                f"{_dt.datetime.now(_dt.timezone.utc).isoformat()}: {e}; "
                "serving last-good model")
            log.exception("fleet swap failed; continuing on last-good")
        else:
            self._degraded_reason = None

    def _fleet_publish(self, directive: dict) -> None:
        """Write this replica's status row (single writer: us) and refresh
        the cached peer view /status reads."""
        from . import model_artifact

        with self._lock:
            cur, prev = self.instance, self._chain.previous
            pinned = {i: r for i, r in self._pinned.items()
                      if i not in self._pins_provisional}
            rollbacks = dict(self._rollbacks)
            w = self._chain.watch
        with self._adm_lock:
            draining = self._draining
        qw = self._quality_watch
        now = _time.monotonic()
        # a canary promotes only once BOTH its error watch and its quality
        # watch closed clean
        watch_done = ((w is None or cur is None
                       or w.get("instance") != cur.id or now > w["until"])
                      and (qw is None or cur is None
                           or qw.get("instance") != cur.id
                           or now > qw["until"]))
        group = self._fleet_group()
        status = {
            "replica": self.fleet_replica,
            "pid": os.getpid(),
            "instance": cur.id if cur else None,
            "previous": prev[1].id if prev else None,
            "pinned": pinned,
            "rollbacks": rollbacks,
            "draining": draining,
            "watchDone": watch_done,
            "epochSeen": directive.get("epoch", 0),
            "updatedAt": _time.time(),
        }
        model_artifact.write_fleet_doc(
            self.storage, model_artifact.fleet_row_id(
                group, self.fleet_replica), status)
        peers = directive.get("peers")
        if peers is None:
            # no coordinator snapshot yet: read each peer row directly
            peers = []
            for i in range(max(self.fleet_replicas,
                               self.fleet_replica + 1)):
                doc = model_artifact.read_fleet_doc(
                    self.storage, model_artifact.fleet_row_id(group, i))
                if doc is not None:
                    peers.append(doc)
        else:
            # the coordinator ships every status row inside the directive
            # (one store read per tick); our own just-written row replaces
            # its copy so this replica's view never lags itself
            peers = [p for p in peers
                     if p.get("replica") != self.fleet_replica]
            peers.append(status)
            peers.sort(key=lambda p: p.get("replica") or 0)
        serving = {p.get("instance") for p in peers if p.get("instance")}
        diverged = len(serving) > 1
        if diverged != self._fleet_diverged:
            # the reference's pio_fleet_divergence gauge, as a log line
            (log.warning if diverged else log.info)(
                "fleet %s: replicas %s serving %s", group,
                "now diverge," if diverged else "converged again,",
                sorted(serving))
            self._fleet_diverged = diverged
        self._fleet_view = {
            "group": group,
            "replica": self.fleet_replica,
            "replicas": self.fleet_replicas,
            "syncMs": self.fleet_sync_ms,
            "directive": {k: directive.get(k) for k in
                          ("state", "instance", "target", "canaryReplica",
                           "lastGood", "epoch", "pinned")},
            "peers": peers,
            "divergence": diverged,
        }

    def _fleet_rollback_via_store(self) -> Optional[str]:
        """Fleet rollback on a replica with NO resident previous deployment
        (relaunched, booted straight onto the current instance): pin the
        current instance and walk back through the store, so `pio models
        rollback --engine-url <front>` works whichever replica answers.
        Caller holds the reload lock. The restored instance id, or None
        (the pin reverted) when nothing older is deployable."""
        with self._lock:
            cur = self.instance
            if cur is None:
                return None
            # provisional until the walk lands: a publish during the walk
            # must not ship this pin (pins merge irreversibly). Only a pin
            # inserted HERE is provisional and poppable
            inserted = cur.id not in self._pinned
            if inserted:
                self._pinned[cur.id] = "manual"
                self._pins_provisional.add(cur.id)
        try:
            self._load(None)
        except Exception:  # noqa: BLE001 - nothing older deployable
            if inserted:
                with self._lock:
                    self._pinned.pop(cur.id, None)
                    self._pins_provisional.discard(cur.id)
            log.exception("fleet rollback: no older deployable instance; "
                          "keeping %s live", cur.id)
            return None
        # the reload retained the PINNED instance as "previous" and opened a
        # watch on the restored one: both wrong for a rollback
        with self._lock:
            self._pins_provisional.discard(cur.id)
            self._chain.reset()
            self._rollbacks["manual"] = self._rollbacks.get("manual", 0) + 1
            restored = self.instance
        log.warning("fleet rollback via store: %s pinned, restored %s",
                    cur.id, restored.id)
        return restored.id

    def _start_heartbeat(self) -> None:
        if not envknobs.env_str("PIO_WORKER_HEARTBEAT_FILE", "",
                                lower=False):
            return
        self._hb_stop.clear()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="pio-heartbeat", daemon=True)
        self._hb_thread.start()

    def _stop_heartbeat(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10)
            self._hb_thread = None

    def _heartbeat_loop(self) -> None:
        """Supervised-replica liveness: touch the heartbeat file, so a
        process that stops running Python (not only a dead one) is
        detected and relaunched."""
        from ..parallel import supervisor

        interval = max(0.05, envknobs.env_ms(
            "PIO_WORKER_HEARTBEAT_MS", 1000.0, lo_ms=20.0) / 2.0)
        while True:
            supervisor.beat()
            if self._hb_stop.wait(interval):
                return

    # -- graceful drain ----------------------------------------------------
    def drain_then_stop(self, stopper=None) -> None:
        """The SIGTERM / /stop sequence: flip /readyz to 503 FIRST (new
        queries shed 503 at admission), wait until every ACCEPTED query is
        computed and its answer written, up to PIO_DRAIN_DEADLINE_MS, then
        stop serving. Runs on a thread of its own, never on the one in
        ``serve_forever`` (whose shutdown it waits for)."""
        with self._adm_lock:
            if self._draining:
                return      # second SIGTERM / /stop: the first drain owns it
            self._draining = True
        log.info("draining: readyz → 503, waiting for in-flight queries "
                 "(budget %.0f ms)", self.drain_deadline_ms)
        _time.sleep(0.05)   # let the triggering response flush
        t_end = _time.monotonic() + self.drain_deadline_ms / 1000.0
        while _time.monotonic() < t_end:
            with self._adm_lock:
                busy = self._adm_pending + self._unanswered
            if busy == 0:
                break
            _time.sleep(0.02)
        with self._adm_lock:
            stragglers = self._adm_pending
            if stragglers:
                self._drain_stragglers = stragglers
        if stragglers:
            log.warning("drain deadline (%.0f ms) expired with %d "
                        "query(ies) unfinished; failing them",
                        self.drain_deadline_ms, stragglers)
        else:
            log.info("drain complete: all accepted queries answered")
        (stopper or self._shutdown_httpd)()

    def _start_drain(self) -> None:
        threading.Thread(target=self.drain_then_stop, name="pio-drain",
                         daemon=True).start()

    def finalize_shutdown(self, grace: float = 2.0) -> None:
        """After serving stopped. Worker threads can't be killed: cancel
        what is still queued, give running orphans a short grace, then
        hard-exit rather than let a hung model call block interpreter
        shutdown forever."""
        self.close()
        t_end = _time.monotonic() + grace
        while _time.monotonic() < t_end:
            with self._adm_lock:
                if self._adm_pending <= 0:
                    return
            _time.sleep(0.02)
        with self._adm_lock:
            left = self._adm_pending
        log.warning("%d query worker(s) still running after shutdown "
                    "grace; exiting anyway", left)
        os._exit(0)

    def handle_stop(self, request: Request) -> Reply:
        if self.fleet_mode:
            # through the front this drains ONE replica, which the
            # supervisor then relaunches: the fleet stops as a unit
            return _json(409, {
                "message": "fleet mode: a single-replica stop would silently "
                           "shrink the fleet — stop the whole fleet by "
                           "terminating the `pio deploy --replicas` front "
                           "process (SIGTERM)"})
        log.info("stop requested")
        with self._adm_lock:
            draining = self._draining
        if draining:
            return _json(200, {"message": "Already draining."})
        self._start_drain()
        return _json(200, {"message": "Shutting down."})

    # -- HTTP --------------------------------------------------------------
    def routes(self) -> dict:
        """(method, path) → handler."""
        out = {}
        for path, handler in (("/", self.handle_status),
                              ("/status", self.handle_status),
                              ("/healthz", self.handle_healthz),
                              ("/readyz", self.handle_readyz),
                              ("/metrics", self.handle_metrics),
                              ("/plugins.json", self.handle_plugins)):
            out[("GET", path)] = handler
        out[("POST", "/queries.json")] = self.handle_query
        for path, handler in (("/reload", self.handle_reload),
                              ("/rollback", self.handle_rollback),
                              ("/stop", self.handle_stop)):
            out[("GET", path)] = out[("POST", path)] = handler
        return out

    def _answered(self) -> None:
        """The handler wrote its answer: its admissions are answered."""
        n, self._tls.admitted = getattr(self._tls, "admitted", 0), 0
        if n:
            with self._adm_lock:
                self._unanswered -= n

    def bind(self, host: str = "127.0.0.1", port: int = 0
             ) -> tuple[str, int]:
        """Arm the fold-in cursor, open the listening socket (port 0 picks
        a free one) and start the batcher, the refresh, fold-in and quality
        loops and, in a fleet replica, the sync and heartbeat threads;
        returns (host, port)."""
        self._start_foldin()
        self._httpd = _HTTPServer((host, port), self)
        if self.batch_window_ms > 0:
            self._start_batcher()
        self._start_refresher()
        self._start_quality()
        self._start_fleet()
        self._start_heartbeat()
        return self.address

    @property
    def address(self) -> tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    def serve_forever(self) -> None:
        """Serve on the calling thread until the server is stopped."""
        self._httpd.serve_forever()

    def start(self, host: str = "127.0.0.1", port: int = 0
              ) -> tuple[str, int]:
        """Bind and serve on a background thread; returns (host, port)."""
        addr = self.bind(host, port)
        self._serve_thread = threading.Thread(
            target=self.serve_forever, name="pio-engine-server", daemon=True)
        self._serve_thread.start()
        return addr

    def _shutdown_httpd(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()

    def close(self) -> None:
        """Release what serving holds (after serving has stopped): the
        batcher (stranded queries fail), the refresh, fold-in and quality
        loops, the fleet sync and heartbeat threads, the socket and the
        executors' idle workers."""
        self._stop_heartbeat()
        self._stop_fleet()
        self._stop_refresher()
        self._stop_foldin()
        self._stop_quality()
        self._stop_batcher()
        if self._httpd is not None:
            self._httpd.server_close()
        self._query_executor.shutdown(wait=False, cancel_futures=True)
        self._feedback_executor.shutdown(wait=False)

    def stop(self) -> None:
        """Stop a server started with :meth:`start`."""
        self._shutdown_httpd()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)
        self.close()


class _Once:
    """A release that runs once, whoever calls it first: a tenant's budget
    frees with its query's compute when that was dispatched (``owned``),
    else when the handler is done."""

    def __init__(self, fn):
        self._fn = fn
        self._lock = threading.Lock()
        self.owned = False

    def __call__(self) -> None:
        with self._lock:
            fn, self._fn = self._fn, None
        if fn is not None:
            fn()


def _settle(fut: concurrent.futures.Future, exc: BaseException) -> None:
    """Fail ``fut`` unless it already settled (cancelled by its
    deadline)."""
    try:
        fut.set_exception(exc)
    except concurrent.futures.InvalidStateError:
        pass


class _Handler(BaseHTTPRequestHandler):
    server: "_HTTPServer"
    protocol_version = "HTTP/1.1"
    # buffered writes: a response's headers and body leave in one send
    # (two small sends meet Nagle's algorithm and the client's delayed
    # ACK, ~40 ms per keep-alive request)
    wbufsize = -1

    def _route(self, method: str) -> None:
        path, _, qs = self.path.partition("?")
        try:
            length = max(0, int(self.headers.get("Content-Length") or 0))
        except ValueError:
            self.send_error(400, "bad Content-Length")
            return
        body = self.rfile.read(length) if length else b""
        telemetry.traced_dispatch(
            self.headers, method, path,
            lambda: self._serve(method, path, qs, body))

    def _serve(self, method: str, path: str, qs: str, body: bytes) -> int:
        es = self.server.engine_server
        table = self.server.routes
        handler = table.get((method, path))
        try:
            if handler is not None:
                status, obj, headers = handler(Request(
                    self.headers, urllib.parse.parse_qs(qs), body))
            elif any(p == path for _, p in table):
                status, obj, headers = _json(
                    405, {"message": f"{method} not allowed on {path}"})
            else:
                status, obj, headers = _json(
                    404, {"message": f"no route {path}"})
            if isinstance(obj, _Text):
                data = obj.encode()
                ctype = "text/plain; charset=utf-8"
            else:
                data = json.dumps(obj).encode()
                ctype = "application/json; charset=utf-8"
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers.items():
                self.send_header(k, v)
            tr = telemetry.current_trace()
            if tr is not None:
                self.send_header(telemetry.TRACE_HEADER, tr.trace_id)
            self.end_headers()
            self.wfile.write(data)
            self.wfile.flush()
            return status
        finally:
            es._answered()

    def do_GET(self):  # noqa: N802 - http.server's naming
        self._route("GET")

    def do_POST(self):  # noqa: N802
        self._route("POST")

    def log_message(self, fmt, *args):  # one line per request is noise
        log.debug("%s - " + fmt, self.address_string(), *args)


class _HTTPServer(TLSServerMixin, ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: a burst of new keep-alive clients must not meet
    # dropped SYNs (the default 5 costs a 1 s retransmit each)
    request_queue_size = 128

    def __init__(self, addr, engine_server: EngineServer):
        self.engine_server = engine_server
        self.routes = engine_server.routes()
        # HTTPS only when PIO_SSL_CERTFILE and PIO_SSL_KEYFILE are set; a
        # bad file raises here, before the socket is bound
        self.ssl_context = ssl_context_from_env()
        super().__init__(addr, _Handler)


def _device_attachment(device: torch.device) -> str:
    """Where the served models live (probe output)."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return "cpu"


def run_engine_server(server: EngineServer, host: str = "0.0.0.0",
                      port: int = 8000, probe_latency: bool = False) -> None:
    """Blocking entry point (reference: CreateServer.main). SIGTERM and
    SIGINT start a graceful drain; the process's own thread keeps
    serving until the drain stops it."""
    import signal as _signal

    server.bind(host, port)
    bound_host, bound_port = server.address
    log.info("Engine Server listening on %s:%d", bound_host, bound_port)

    def _on_term(signum, frame):
        # signal handlers run on the main thread, which is inside
        # serve_forever: only mark and hand the drain to a thread
        log.info("%s received: graceful drain",
                 _signal.Signals(signum).name)
        server._start_drain()

    for signame in ("SIGTERM", "SIGINT"):
        _signal.signal(getattr(_signal, signame), _on_term)
    if probe_latency:
        scheme = "https" if server._httpd.ssl_context is not None else "http"

        def probe():
            try:
                server.probe_and_record(f"{scheme}://127.0.0.1:{bound_port}")
            except Exception:  # noqa: BLE001 - diagnostics never kill serving
                log.exception("startup latency probe failed; serving anyway")

        threading.Thread(target=probe, name="pio-probe", daemon=True).start()
    try:
        server.serve_forever()
    finally:
        server.finalize_shutdown()
