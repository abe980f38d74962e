"""Multi-tenant engine serving: one process, many apps.

The port's own copy of ``incubator_predictionio_tpu/workflow/multitenant.py``,
with the reference's names and ``/status`` keys. :class:`TenantMux` lets one
engine server serve N apps:

- **Routing**: a query names its tenant by app (``X-Pio-App`` header, then
  the ``app`` query parameter) or by access key (the ``accessKey`` query
  parameter, then the ``X-Pio-Access-Key`` header, resolved through the
  AccessKeys repository the event server authorizes against, TTL-cached).
  An anonymous query falls through to the process's default app, so a
  single-tenant deploy behaves as before.
- **Resident-model cache**: the tenants' deployments live in an LRU bounded
  by ``PIO_TENANT_MAX_RESIDENT``. A tenant's first query loads its newest
  COMPLETED instance through the verified read (checksum walk-back) and
  the validation gate. Eviction never drops a tenant mid-query: every
  in-flight query holds a refcount, the victim scan skips busy tenants,
  and the debt is collected at release. An evicted tenant keeps its
  lifecycle state (pins survive eviction, so a reload cannot re-pick a
  poisoned artifact).
- **Per-tenant lifecycle**: each tenant owns its post-swap watch, pin set
  and retained previous deployment (a :class:`~.swap_chain.SwapChain`, the
  engine server's own rule): a poisoned tenant rolls back alone.
- **Per-tenant fold-in**: each resident tenant gets its own
  :class:`~.online.FoldInRunner` (its cursor row keys on its app id),
  ticked by the server's fold-in thread; its increments publish through
  the tenant's own gate and watch. A publish that lands while the
  outgoing instance's watch is open extends the tenant's chain of
  unobserved swaps (the previous deployment stays on the last instance
  observed healthy, and a rollback pins every link), and publishes wait
  ("deferred") once that chain is a watch window old. Operator loads
  keep the one-step rule. The reference's mux swaps one step at a time.
- **Per-tenant admission budgets**: ``PIO_TENANT_MAX_PENDING`` bounds one
  app's admitted queries below the process cap, so a hot app sheds 503
  while the others serve. A slot is released in :meth:`TenantMux.release`
  when the query's compute finishes (a query past its deadline keeps its
  slot until then, as the process gate's orphans do), never when the
  reply is written.

The resident-cache internals (``_resident_lru``, ``_evict_victim``) are
touched only by this module; the engine server, the status verb and the
tests use the public surface: ``resolve_app`` / ``admit`` /
``ensure_loaded`` / ``note_result`` / ``rollback_tenant`` / ``release`` /
``foldin_tick`` / ``snapshot``. In a replica fleet the coordinator and
every replica scope their directive group to the default app
(:func:`fleet_app`, :func:`replica_fleet_app`).

Telemetry (the engine server's ``/metrics``):
``pio_tenant_queries_total{app}``, ``pio_tenant_shed_total{app}``,
``pio_tenant_rollbacks_total{app}``, ``pio_tenant_loads_total``,
``pio_tenant_evictions_total`` and the ``pio_tenant_resident`` gauge; the
same counts ride :meth:`TenantMux.snapshot`, which ``/status`` reports.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Optional

from ..common import envknobs, telemetry
from . import model_artifact
from .context import WorkflowContext
from .core_workflow import load_deployment
from .swap_chain import SwapChain

log = logging.getLogger("pio.torch.multitenant")

__all__ = ["TenantMux", "TenantState", "UnknownTenant", "fleet_app",
           "replica_fleet_app"]

#: the app a tenant-aware fleet is scoped to: the front sets it on every
#: replica so both sides derive the same directive group
FLEET_APP_ENV = "PIO_FLEET_APP"


def fleet_app(engine_json: dict, armed: bool) -> str:
    """The app a fleet front's coordinator stages rollouts for: with the
    tenant mux armed, every replica serves N apps but the coordinator stages
    the DEFAULT app (engine.json's datasource ``appName``) only, since an
    unconfined candidate walk would promote some tenant's fold-in increment
    fleet-wide as the default deployment. "" when the mux is off."""
    if not armed:
        return ""
    ds = (engine_json.get("datasource") or {}).get("params") or {}
    return str(ds.get("appName") or ds.get("app_name") or "")


def replica_fleet_app() -> Optional[str]:
    """The replica side of :func:`fleet_app`: the app the front scoped this
    fleet to (``PIO_FLEET_APP``), or None for an unscoped fleet."""
    return envknobs.env_str(FLEET_APP_ENV, "", lower=False) or None

_M_QUERIES = telemetry.registry().counter(
    "pio_tenant_queries_total",
    "Queries admitted to a non-default tenant, per app", ("app",))
_M_SHED = telemetry.registry().counter(
    "pio_tenant_shed_total",
    "Queries refused 503 by a tenant's OWN admission budget "
    "(PIO_TENANT_MAX_PENDING) — the process-level gate counts "
    "separately", ("app",))
_M_ROLLBACKS = telemetry.registry().counter(
    "pio_tenant_rollbacks_total",
    "Per-tenant rollbacks (watch breach or validation refusal pinning "
    "that app's instance alone), per app", ("app",))
_M_LOADS = telemetry.registry().counter(
    "pio_tenant_loads_total",
    "Tenant model loads: lazy first-query loads, post-eviction "
    "reloads, rollback walk-backs and fold-in publishes").labels()
_M_EVICTIONS = telemetry.registry().counter(
    "pio_tenant_evictions_total",
    "Tenant deployments evicted from the resident LRU "
    "(PIO_TENANT_MAX_RESIDENT)").labels()
_M_RESIDENT = telemetry.registry().gauge(
    "pio_tenant_resident",
    "Tenant deployments currently resident in the multi-tenant LRU "
    "cache").labels()


class UnknownTenant(Exception):
    """The request named a tenant this deployment cannot serve: an access
    key no AccessKeys row matches, or an app name the metadata store does
    not know. Maps to 401/404, never a fallthrough to the default tenant
    (serving app A's model to app B's key would leak across tenants)."""


def _param(request, name: str) -> Optional[str]:
    """One query-string parameter of a request (``Request.params`` is
    ``urllib.parse.parse_qs``'s dict of lists)."""
    values = request.params.get(name)
    return values[0] if values else None


class TenantState:
    """One app's serving state. The deployment/instance pair is the heavy
    part (models on the card) and the only part eviction drops; the pins,
    counters and admission ledger survive eviction."""

    def __init__(self, name: str, app_id: int):
        self.name = name
        self.app_id = app_id
        # serializes loads, swaps and watch accounting for THIS tenant
        # only: tenant A's cold load never blocks tenant B's queries
        self.lock = threading.Lock()
        self.deployment = None
        self.instance = None
        # the previous deployment, post-swap watch and chain of unobserved
        # swaps of THIS tenant
        self.chain = SwapChain(f"tenant {name!r}: ")
        self.pinned: dict[str, str] = {}        # instance id → reason
        self.degraded: Optional[str] = None
        self.inflight = 0       # refcount: queries between admit/release
        self.pending = 0        # admission ledger
        self.shed = 0
        self.queries = 0
        self.loads = 0
        self.swaps = 0
        self.rollbacks: dict[str, int] = {}
        self.last_used = time.monotonic()
        self.foldin = None                      # per-tenant FoldInRunner
        self.foldin_view: Optional[dict] = None

    def row(self, resident: bool) -> dict:
        """Status row for /status "tenants" and ``pio status``."""
        w = self.chain.watch
        prev = self.chain.previous
        fv = self.foldin_view or {}
        return {
            "app": self.name,
            "appId": self.app_id,
            "resident": resident,
            "instance": self.instance.id if self.instance else None,
            "previous": prev[1].id if prev else None,
            "pinned": dict(self.pinned),
            "watch": ({"total": w["total"], "errors": w["errors"]}
                      if w is not None else None),
            "degraded": self.degraded,
            "inflight": self.inflight,
            "pending": self.pending,
            "shed": self.shed,
            "queries": self.queries,
            "loads": self.loads,
            "swaps": self.swaps,
            "rollbacks": dict(self.rollbacks),
            "idleS": round(max(0.0, time.monotonic() - self.last_used), 1),
            "cursorLagS": fv.get("lagSeconds"),
            "foldinEvents": fv.get("events"),
            "foldinPublishes": fv.get("publishes"),
        }


class TenantMux:
    """The tenant multiplexer an engine server owns when
    ``PIO_TENANT_MAX_RESIDENT`` > 0. ``_lock`` guards the resident LRU, the
    parked map and the mux-level counters; each tenant's ``state.lock``
    serializes that tenant's loads and watch accounting. The mux lock is
    never held across storage I/O: loads run under the tenant lock only."""

    def __init__(self, server, max_resident: int, max_pending: int):
        self._server = server
        self.max_resident = max(1, int(max_resident))
        self.max_pending = max(1, int(max_pending))
        self._lock = threading.Lock()
        # app name → TenantState WITH a loaded deployment; insertion order
        # is LRU order (move_to_end on every admit)
        self._resident_lru: "collections.OrderedDict[str, TenantState]" \
            = collections.OrderedDict()
        # evicted / not-yet-loaded tenants (pins survive eviction here)
        self._parked: dict[str, TenantState] = {}
        self._evictions = 0
        self._cold_loads = 0
        self._total_loads = 0
        # access key → (expires_monotonic, app name): a deleted key stops
        # resolving within the TTL
        self._key_ttl_s = envknobs.env_float(
            "PIO_TENANT_KEY_TTL_MS", 30_000.0, lo=0.0) / 1e3
        self._keys: dict[str, tuple[float, Optional[str]]] = {}

    # -- routing ------------------------------------------------------------
    def resolve_app(self, request) -> Optional[str]:
        """The tenant a request names, or None for an anonymous request
        (→ the process's default app). Raises :class:`UnknownTenant` for a
        key nothing resolves: a bad credential never falls through to the
        default tenant."""
        app = request.headers.get("X-Pio-App") or _param(request, "app")
        if app:
            return str(app)
        key = (_param(request, "accessKey")
               or request.headers.get("X-Pio-Access-Key"))
        if not key:
            return None
        app = self._app_for_key(str(key))
        if app is None:
            raise UnknownTenant("access key does not match any app")
        return app

    def _app_for_key(self, key: str) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            hit = self._keys.get(key)
            if hit is not None and hit[0] > now:
                return hit[1]
        name: Optional[str] = None
        try:
            row = self._server.storage.get_meta_data_access_keys().get(key)
            if row is not None:
                app = self._server.storage.get_meta_data_apps().get(
                    row.appid)
                name = app.name if app is not None else None
        except Exception:  # noqa: BLE001 — a storage flake is not a bad key
            log.exception("access-key resolution failed")
            return None
        with self._lock:
            self._keys[key] = (now + self._key_ttl_s, name)
            if len(self._keys) > 4096:   # bound a key scan's footprint
                self._keys.pop(next(iter(self._keys)))
        return name

    # -- admission ----------------------------------------------------------
    def admit(self, app: str) -> TenantState:
        """Take one slot of ``app``'s admission budget (which also holds the
        tenant against eviction) or refuse. Raises :class:`UnknownTenant`
        (→ 404) for an unregistered app and the server's AdmissionShed (→
        503 + Retry-After) past the budget. Every admit is paired with
        :meth:`release`."""
        from .create_server import AdmissionShed

        state = self._state_for(app)
        with self._lock:
            if state.pending >= self.max_pending:
                state.shed += 1
                _M_SHED.labels(app).inc()
                raise AdmissionShed(
                    f"tenant {app!r} admission budget full "
                    f"({state.pending}/{self.max_pending})", 1.0, "tenant")
            state.pending += 1
            state.inflight += 1
            state.queries += 1
            state.last_used = time.monotonic()
            if app in self._resident_lru:
                self._resident_lru.move_to_end(app)
        _M_QUERIES.labels(app).inc()
        return state

    def release(self, state: TenantState) -> None:
        """Drop the admit refcount and collect any eviction debt a busy
        victim deferred."""
        with self._lock:
            state.pending = max(0, state.pending - 1)
            state.inflight = max(0, state.inflight - 1)
            self._shrink_locked()

    def _state_for(self, app: str) -> TenantState:
        with self._lock:
            state = self._resident_lru.get(app) or self._parked.get(app)
            if state is not None:
                return state
        # registration check outside the mux lock (storage I/O)
        row = self._server.storage.get_meta_data_apps().get_by_name(app)
        if row is None:
            raise UnknownTenant(f"app {app!r} is not registered")
        with self._lock:
            state = self._resident_lru.get(app) or self._parked.get(app)
            if state is None:
                state = self._parked[app] = TenantState(app, row.id)
            return state

    # -- resident cache (the confined internals) ----------------------------
    def ensure_loaded(self, state: TenantState) -> TenantState:
        """Make ``state``'s deployment resident (verified read + validation
        gate + warm-up), evicting the least recently used idle tenant past
        the bound. A no-op when already resident."""
        with state.lock:
            if state.deployment is None:
                self._load_tenant_locked(state)
                with self._lock:
                    self._cold_loads += 1
        with self._lock:
            if state.name not in self._resident_lru:
                self._parked.pop(state.name, None)
                self._resident_lru[state.name] = state
            self._resident_lru.move_to_end(state.name)
            self._shrink_locked()
            _M_RESIDENT.set(len(self._resident_lru))
        return state

    def _shrink_locked(self) -> None:
        """Evict past the bound (mux lock held). Busy tenants (inflight >
        0) are skipped, and the debt is collected at the next release."""
        while len(self._resident_lru) > self.max_resident:
            victim = self._evict_victim()
            if victim is None:
                break           # everyone busy: collect at release time
            self._resident_lru.pop(victim.name, None)
            self._parked[victim.name] = victim
            # drop ONLY the heavy halves: pins and counters survive, so a
            # reload cannot re-pick a poisoned artifact
            victim.deployment = None
            victim.instance = None
            victim.chain.reset()
            victim.foldin = None
            self._evictions += 1
            _M_EVICTIONS.inc()
            log.info("tenant %r evicted from the resident cache (%d/%d "
                     "resident)", victim.name, len(self._resident_lru),
                     self.max_resident)
        _M_RESIDENT.set(len(self._resident_lru))

    def _evict_victim(self) -> Optional[TenantState]:
        """LRU-order scan for the first idle (refcount-zero) tenant."""
        for state in self._resident_lru.values():
            if state.inflight <= 0:
                return state
        return None

    # -- per-tenant lifecycle -----------------------------------------------
    def _load_tenant_locked(self, state: TenantState,
                            instance_id: Optional[str] = None,
                            chain: bool = False) -> None:
        """Load ``state``'s newest deployable instance (or ``instance_id``)
        through the verified-read walk-back and the validation gate,
        pinning refused candidates for this tenant. ``chain`` (the fold-in
        publish) lets the swap keep the last instance observed healthy as
        the previous deployment (:meth:`SwapChain.swap`). The caller holds
        ``state.lock``. Raises when nothing of this app is deployable."""
        from .create_server import SwapValidationError

        srv = self._server
        while True:
            ctx = WorkflowContext(storage=srv.storage, app_name=state.name,
                                  device=srv.device)
            deployment, instance, _ = load_deployment(
                srv.engine, instance_id, ctx,
                engine_factory_name=srv.engine_factory_name,
                engine_variant=srv.engine_variant,
                exclude_ids=tuple(state.pinned),
                on_reject=lambda iid, kind: state.pinned.setdefault(
                    iid, f"integrity:{kind}"),
                app_name=state.name,
            )
            try:
                for model in deployment.models:
                    warm = getattr(model, "warm_up", None)
                    if callable(warm):
                        warm()
                srv._validate_swap(deployment, instance.id, instance)
            except SwapValidationError as e:
                state.pinned.setdefault(e.instance_id, "validate")
                if instance_id is not None:
                    raise
                log.warning("tenant %r: %s; pinned, walking back",
                            state.name, e)
                continue
            break
        # EVERY tenant load arms the watch (not just swaps): a lazily
        # loaded model is unvetted in this process
        if state.chain.swap(state.deployment, state.instance, instance,
                            time.monotonic(), chain=chain,
                            watch_ms=srv.swap_watch_ms, arm=True):
            state.swaps += 1
        state.deployment = deployment
        state.instance = instance
        state.loads += 1
        state.degraded = None
        with self._lock:
            self._total_loads += 1
        _M_LOADS.inc()
        if srv.foldin_ms > 0 and state.foldin is None:
            from . import online

            state.foldin = online.FoldInRunner(
                srv.storage, srv.engine_factory_name, srv.engine_variant,
                interval_ms=srv.foldin_ms, app_name=state.name,
                device=srv.device)
            try:
                state.foldin.arm(instance)
            except Exception:  # noqa: BLE001 — the first tick retries
                log.exception("tenant %r: fold-in arm failed; the first "
                              "tick retries", state.name)
            state.foldin_view = state.foldin.view()
        log.info("tenant %r: deployed engine instance %s", state.name,
                 instance.id)

    def note_result(self, state: TenantState, ok: bool) -> bool:
        """Record one query outcome against the tenant's watch. True when
        the error rate tripped the rollback threshold (the process watch's
        rule: ≥ 2 failures AND a failure fraction above
        PIO_SWAP_MAX_ERROR_RATE, counted back from the live link of the
        tenant's chain); the caller then runs :meth:`rollback_tenant`."""
        with state.lock:
            cur = state.instance
            return state.chain.note(ok, cur.id if cur else None,
                                    time.monotonic(),
                                    self._server.swap_max_error_rate)

    def rollback_tenant(self, state: TenantState, reason: str):
        """Pin the bad instance, and every link of the tenant's chain of
        unobserved swaps, and restore service for THIS app alone: an
        instant swap to its resident previous deployment (the last
        instance observed healthy), else a pin and walk-back reload.
        Returns the restored deployment (to answer the triggering query),
        or None when nothing older is deployable (the tenant goes
        degraded; every other tenant is untouched)."""
        with state.lock:
            bad = state.instance
            if bad is None:
                return None
            w = state.chain.watch
            if w is not None and w.get("instance") != bad.id:
                return state.deployment   # a concurrent swap won
            prev, pins = state.chain.rollback(bad.id)
            for iid in pins:
                state.pinned.setdefault(iid, reason)
            state.rollbacks[reason] = state.rollbacks.get(reason, 0) + 1
            _M_ROLLBACKS.labels(state.name).inc()
            if prev is not None:
                state.deployment, state.instance = prev
                log.warning("tenant %r: rolled back %s → %s (%s); %s "
                            "pinned", state.name, bad.id,
                            state.instance.id, reason, ", ".join(pins))
            else:
                state.deployment = state.instance = None
                try:
                    self._load_tenant_locked(state)
                except Exception as e:  # noqa: BLE001 — tenant degraded
                    state.degraded = (
                        f"rollback ({reason}) found nothing older "
                        f"deployable: {e}")
                    log.warning("tenant %r: %s", state.name,
                                state.degraded)
                    self._untrack(state)
                    return None
            self._note_foldin_pin(bad, reason)
            self._server._tenant_cache_invalidate(state.name, None)
            return state.deployment

    def _untrack(self, state: TenantState) -> None:
        """A tenant whose deployment went away (a failed rollback reload)
        leaves the resident LRU: it holds no model."""
        with self._lock:
            if self._resident_lru.pop(state.name, None) is not None:
                self._parked[state.name] = state
            _M_RESIDENT.set(len(self._resident_lru))

    @staticmethod
    def _note_foldin_pin(instance, reason: str) -> None:
        from . import online

        if online.is_foldin_instance(instance):
            online.note_rollback(reason)

    # -- per-tenant fold-in -------------------------------------------------
    def foldin_tick(self) -> None:
        """One fold-in pass over every resident tenant (the server's fold-in
        thread). Failures stay per tenant: one app's storage flake must not
        starve its neighbors' increments."""
        with self._lock:
            states = list(self._resident_lru.values())
        for state in states:
            try:
                self._foldin_tick_one(state)
            except Exception:  # noqa: BLE001 — the next tick retries
                log.exception("tenant %r: fold-in tick failed; retrying "
                              "next tick", state.name)

    def _foldin_tick_one(self, state: TenantState) -> None:
        with state.lock:
            runner = state.foldin
            deployment, instance = state.deployment, state.instance
            pinned = tuple(state.pinned)
        if runner is None or deployment is None or instance is None:
            return
        try:
            view = runner.run_once(deployment, instance, pinned)
        finally:
            state.foldin_view = runner.view()
        if view.get("instance") or view.get("pendingInstance"):
            self._publish_tenant(state)
            state.foldin_view = runner.view()

    def _publish_tenant(self, state: TenantState) -> str:
        """Publish a newer COMPLETED instance of THIS app through the
        tenant's own gate and watch (the per-tenant ``_publish_once``): a
        validation refusal pins for this tenant, a swap extends the
        tenant's chain of unobserved swaps (or starts one, retaining the
        outgoing deployment for the watch's instant rollback), and this
        tenant's cache entries are invalidated by the increment's freshness
        footprint. Returns "swapped" | "current" | "deferred" (the chain
        is a window old: :meth:`SwapChain.full`) | "refused" | "error"."""
        from .create_server import EngineServer, SwapValidationError

        srv = self._server
        with state.lock:
            cur = state.instance
            if cur is None:
                return "current"
            if state.chain.full(cur.id, time.monotonic(), srv.swap_watch_ms):
                return "deferred"
            cand = model_artifact.newer_completed_instance(
                srv.storage.get_meta_data_engine_instances(),
                srv.engine_factory_name, srv.engine_variant, cur,
                exclude=set(state.pinned), app_name=state.name)
            if cand is None:
                return "current"
            try:
                self._load_tenant_locked(state, cand.id, chain=True)
            except SwapValidationError as e:
                state.degraded = (f"fold-in publish refused: {e}; "
                                  f"{e.instance_id} pinned")
                self._note_foldin_pin(cand, "validate")
                log.warning("tenant %r: %s", state.name, state.degraded)
                return "refused"
            except Exception as e:  # noqa: BLE001 — the next tick retries
                state.degraded = f"fold-in publish failed: {e}"
                log.exception("tenant %r: fold-in publish failed",
                              state.name)
                return "error"
            users = EngineServer._foldin_footprint(state.instance, cur)
        srv._tenant_cache_invalidate(state.name, users)
        return "swapped"

    # -- status surface -----------------------------------------------------
    def snapshot(self) -> dict:
        """The /status "tenants" document (``pio status --engine-url``
        prints the per-tenant table off this)."""
        with self._lock:
            resident = list(self._resident_lru.values())
            parked = [s for s in self._parked.values()
                      if s.queries or s.pinned]
            evictions, cold = self._evictions, self._cold_loads
            loads = self._total_loads
        rows = ([s.row(True) for s in resident]
                + [s.row(False) for s in parked])
        rows.sort(key=lambda r: r["app"])
        return {
            "maxResident": self.max_resident,
            "maxPending": self.max_pending,
            "resident": len(resident),
            "known": len(rows),
            "evictions": evictions,
            "coldLoads": cold,
            "loads": loads,
            "tenants": rows,
        }
