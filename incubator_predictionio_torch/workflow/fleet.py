"""Engine replica fleet: supervised serving replicas behind the splice
front, staged canary rollout, fleet-wide rollback.

The port's own copy of ``incubator_predictionio_tpu/workflow/fleet.py``,
with the reference's store protocol, knobs, fault points and ``/healthz``
keys. ``pio deploy --replicas N`` (or ``PIO_QUERY_REPLICAS``) runs N
engine-server processes (each with its own interpreter lock, CUDA context,
admission gate and validation gate) behind the L4 splice front
(``common/splice.py``), supervised per replica by
``parallel/supervisor.py`` (``restart_scope="worker"``: a dead or wedged
replica is SIGKILLed and relaunched alone while the rest serve). The front
itself never touches the card.

- **One coordinated lifecycle through the model store.** The front's
  :class:`FleetCoordinator` is the single writer of an epoch-fenced
  *directive record*; each replica is the single writer of its own
  *status row* (``workflow/model_artifact.py`` fleet records). Both
  sides poll on ``PIO_FLEET_SYNC_MS``.
- **Staged canary rollout.** A newer COMPLETED instance is directed to
  exactly ONE canary replica, which swaps through its own validation
  gate and serves its ``PIO_SWAP_WATCH_MS`` watch window under live
  traffic; only a clean window promotes the rest (fault point
  ``fleet.promote``).
- **Fleet-wide rollback.** A watch breach, a refused gate or a manual
  ``/rollback`` on ANY replica surfaces as a pin in that replica's status
  row; the coordinator merges it into the directive and re-directs the
  whole fleet to last-good.
- **Online fold-in.** Only replica 0 produces increments (the others
  stand by); the coordinator stages each one through the canary.
- **Elastic mode** (``--replicas auto``, ``workflow/elastic.py``).

Chaos hooks: ``PIO_FLEET_WORKER_FAULT_SPEC`` (``_<i>`` for replica i
alone) becomes the replicas' ``PIO_FAULT_SPEC`` on their FIRST launch
only; ``fleet.spawn`` fires in the replica entry, ``fleet.promote``
before a promote commits, ``fleet.record`` in front of directive writes.

The reference's ``pio_fleet_*`` telemetry waits for the port's metrics
registry (ROADMAP Queue 1, item 3.3): the same counts
(:attr:`FleetCoordinator.counts`) ride the front's ``/healthz``
(``metrics``).
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
import threading
import time
from typing import Optional, Sequence

from ..common import envknobs, faultinject
from ..common.splice import FrontProxy, probe_ready

log = logging.getLogger("pio.torch.fleet")

__all__ = ["FleetCoordinator", "run_fleet"]


class FleetCoordinator:
    """The staged-rollout state machine. Single writer of the fleet
    directive record; reads replica status rows and the engine-instance
    metadata. All methods are BLOCKING (storage I/O) — the front runs
    :meth:`step` off-loop on the ``PIO_FLEET_SYNC_MS`` cadence, and a
    step that raises (storage flake, injected fault) leaves the
    in-memory record dirty so the next step retries the write.

    States: ``steady`` (everyone on ``instance``) and ``canary``
    (``canaryReplica`` directed to ``target``, everyone else held on
    ``instance``). Transitions:

    - steady → canary: a newer non-pinned COMPLETED instance exists
    - canary → steady (promote): the canary serves the target with its
      watch window done and no pin → ``instance = target``,
      ``lastGood =`` the previous instance (fault point
      ``fleet.promote``)
    - canary → steady (refused): the target shows up pinned (gate
      failure or watch breach on the canary) → fleet stays put
    - steady → steady (fleet rollback): the DIRECTED instance shows up
      pinned on any replica (manual ``/rollback``, post-promote watch
      breach) → ``instance = lastGood``
    """

    def __init__(self, storage, replicas: int,
                 engine_factory_name: str,
                 engine_variant: str = "default",
                 sync_ms: float = 1000.0,
                 app_name: str = ""):
        from . import model_artifact

        self._ma = model_artifact
        self.storage = storage
        self.replicas = max(1, int(replicas))
        self.engine_factory_name = engine_factory_name
        self.engine_variant = engine_variant
        # an app-scoped coordinator (multi-tenant fleets) keys its
        # directive/status rows per app and stages only that app's
        # instances — two apps' rollouts can never fence each other
        self.app_name = str(app_name or "")
        self.group = model_artifact.fleet_group(
            engine_factory_name, engine_variant,
            self.app_name or None)
        # a status row older than this is a dead/wedged replica's — it
        # must neither block a promote forever nor vote on adoption
        # (the shared rule: `pio status` uses the same one)
        self.fresh_s = model_artifact.fleet_fresh_s(sync_ms)
        # the reference's pio_fleet_* families, by name; the front's
        # /healthz reports them (the port has no metrics registry yet)
        self.counts: dict = {
            "pio_fleet_state": 0,
            "pio_fleet_promotes_total": 0,
            "pio_fleet_rollbacks_total": {},
            "pio_fleet_canary_refusals_total": {},
            "pio_fleet_replicas_ready": 0,
        }
        # scaling decisions queued by the elastic loop (event-loop thread)
        # for the next fenced directive commit on the coordinator thread:
        # this queue is the ONLY writer of the scale payload
        self._scale_lock = threading.Lock()
        self._scale_queue: list[dict] = []
        # a front restart resumes the durable record: pins survive, and a
        # crash mid-canary re-enters the canary state. The STARTUP
        # adoption is dirty: our first write must bump PAST the adopted
        # epoch, or a superseded incumbent (whose fence check is strictly
        # `>`) would never detect us and both coordinators would keep
        # committing at the same epoch indefinitely
        self._adopt(model_artifact.read_fleet_doc(
            storage, model_artifact.fleet_row_id(self.group)) or {})
        self._dirty = True

    def _adopt(self, on_disk: dict) -> None:
        """(Re)build the in-memory record from an on-disk one — used at
        startup and when a rival coordinator's epoch overtakes ours."""
        self.rec = {
            "epoch": int(on_disk.get("epoch", 0)),
            "state": on_disk.get("state", "steady"),
            "instance": on_disk.get("instance"),
            "target": on_disk.get("target"),
            "canaryReplica": on_disk.get("canaryReplica"),
            "lastGood": on_disk.get("lastGood"),
            "pinned": dict(on_disk.get("pinned") or {}),
            "scale": dict(on_disk.get("scale") or {}),
        }
        self._epoch_base = self.rec["epoch"]
        self._dirty = False

    # -- elastic topology --------------------------------------------------
    def set_replicas(self, n: int) -> None:
        """Widen the slot range the coordinator reads status rows over
        (the elastic loop's scale entry point). High-water only: a retired
        slot's stale row already ages out of `_rows` via `fresh_s`, and
        shrinking the range would hide a straggler's pin."""
        self.replicas = max(self.replicas, int(n))

    def apply_scale(self, decision: dict) -> None:
        """Queue an acted scaling decision for the next fenced
        directive commit (the elastic loop's scale entry point).
        Thread-safe: the elastic loop runs on the front's event loop, the
        commit on the coordinator thread."""
        with self._scale_lock:
            self._scale_queue.append(dict(decision))

    # -- storage views -----------------------------------------------------
    def _rows(self) -> dict[int, dict]:
        now = time.time()
        rows = {}
        for i in range(self.replicas):
            doc = self._ma.read_fleet_doc(
                self.storage, self._ma.fleet_row_id(self.group, i))
            if doc is not None and \
                    now - float(doc.get("updatedAt") or 0) <= self.fresh_s:
                rows[i] = doc
        return rows

    def _candidate(self):
        """Newest non-pinned COMPLETED instance strictly newer than the
        fleet's current one, or None (the shared definition in
        model_artifact — the replicas' refresh poll uses the same
        one)."""
        return self._ma.newer_completed_instance(
            self.storage.get_meta_data_engine_instances(),
            self.engine_factory_name, self.engine_variant,
            self.rec["instance"], exclude=self.rec["pinned"],
            app_name=self.app_name or None)

    # -- the state machine -------------------------------------------------
    def step(self) -> dict:
        """One coordinator tick; returns a snapshot of the record."""
        counts = self.counts
        rows = self._rows()
        rec = self.rec
        # 1. merge replica-reported pins (manual /rollback, watch
        #    breaches, gate refusals) into the fleet record
        for row in rows.values():
            for iid, reason in (row.get("pinned") or {}).items():
                if iid and iid not in rec["pinned"]:
                    rec["pinned"][iid] = str(reason)
                    self._dirty = True
                    log.warning("fleet: replica %s pinned %s (%s); "
                                "propagating", row.get("replica"), iid,
                                reason)
        # 1b. commit queued scaling decisions: each acted decision is a
        #     STATE TRANSITION of the directive record (epoch bump
        #     through the fenced write below), carrying a bounded
        #     decision log for `pio status` / the front's /healthz
        with self._scale_lock:
            pending_scale, self._scale_queue = self._scale_queue, []
        if pending_scale:
            scale = dict(rec.get("scale") or {})
            decisions = list(scale.get("decisions") or [])
            for d in pending_scale:
                if d.get("target") is not None:
                    scale["target"] = d["target"]
                decisions.append(d)
            scale["decisions"] = decisions[-16:]
            rec["scale"] = scale
            self._dirty = True
        # 2. canary resolution
        if rec["state"] == "canary":
            if rec["target"] in rec["pinned"]:
                # refused, not rolled back: the fleet never served the
                # target — only the canary burned (its own rollback is
                # in ITS pio_engine_rollbacks_total)
                reason = rec["pinned"][rec["target"]]
                log.warning("fleet: canary target %s was pinned (%s); "
                            "fleet stays on %s", rec["target"], reason,
                            rec["instance"])
                refusals = counts["pio_fleet_canary_refusals_total"]
                refusals[reason] = refusals.get(reason, 0) + 1
                rec.update(state="steady", target=None,
                           canaryReplica=None)
                self._dirty = True
            else:
                crow = rows.get(rec["canaryReplica"])
                if (crow is not None
                        and crow.get("instance") == rec["target"]
                        and crow.get("watchDone")):
                    # the canary served its whole watch window clean —
                    # promote the remaining replicas
                    faultinject.fault_point("fleet.promote")
                    rec["lastGood"] = (rec["instance"]
                                       or crow.get("previous"))
                    log.info("fleet: canary %s clean on %s; promoting "
                             "the fleet (lastGood=%s)",
                             rec["canaryReplica"], rec["target"],
                             rec["lastGood"])
                    counts["pio_fleet_promotes_total"] += 1
                    rec.update(state="steady", instance=rec["target"],
                               target=None, canaryReplica=None)
                    self._dirty = True
        if rec["state"] == "steady":
            # 3. fleet-wide rollback: the directed instance got pinned
            if rec["instance"] and rec["instance"] in rec["pinned"]:
                back = rec["lastGood"]
                if not back:
                    for row in rows.values():
                        inst = row.get("instance")
                        if inst and inst not in rec["pinned"]:
                            back = inst
                            break
                if back:
                    reason = rec["pinned"][rec["instance"]]
                    log.warning("fleet: directed instance %s pinned "
                                "(%s); rolling the fleet back to %s",
                                rec["instance"], reason, back)
                    rollbacks = counts["pio_fleet_rollbacks_total"]
                    rollbacks[reason] = rollbacks.get(reason, 0) + 1
                    rec.update(instance=back, lastGood=None)
                    self._dirty = True
                else:
                    log.error("fleet: directed instance %s pinned and "
                              "no unpinned instance served anywhere; "
                              "replicas hold last-good until a "
                              "deployable candidate appears (staged as "
                              "a canary)", rec["instance"])
                    rec.update(instance=None, lastGood=None)
                    self._dirty = True
            elif rec["instance"] is None and rows:
                # bootstrap adoption: directives need a reference
                # point. Converged fleet → adopt it; diverged (two
                # replicas booted around a train, or some replica on a
                # pinned instance) → adopt the NEWEST non-pinned served
                # instance and direct everyone there — leaving the
                # directive unset would wedge the fleet diverged
                # forever (replicas never self-refresh in fleet mode)
                serving = {row.get("instance") for row in rows.values()
                           if row.get("instance")}
                good = [i for i in serving if i not in rec["pinned"]]
                if len(good) == 1:
                    rec["instance"] = good[0]
                    self._dirty = True
                elif len(good) > 1:
                    instances = \
                        self.storage.get_meta_data_engine_instances()
                    rows_by_id = {i: instances.get(i) for i in good}
                    known = {i: r for i, r in rows_by_id.items()
                             if r is not None}
                    if known:
                        rec["instance"] = max(
                            known, key=lambda i: known[i].start_time)
                        self._dirty = True
                        log.warning(
                            "fleet: bootstrap found replicas diverged "
                            "across %s; converging on newest %s",
                            sorted(good), rec["instance"])
            # 4. canary start — needs at least one fresh replica to
            #    stage on. A None reference instance does NOT block
            #    staging: after a rollback that found no last-good
            #    (every served instance pinned), the only way the
            #    fleet can ever converge again is a canary onto the
            #    newest non-pinned COMPLETED instance — `_candidate`
            #    with current=None returns exactly that, and the
            #    promote path re-establishes `instance`
            if (rec["state"] == "steady"
                    and rec["target"] is None and rows):
                cand = self._candidate()
                if cand is not None:
                    canary = min(rows)
                    log.info("fleet: staging canary %s on replica %d "
                             "(fleet stays on %s)", cand.id, canary,
                             rec["instance"])
                    rec.update(state="canary", target=cand.id,
                               canaryReplica=canary)
                    self._dirty = True
        # EVERY tick commits the record — state changes bump through
        # the fenced write, and the directive also carries the
        # aggregated replica status rows ("peers"), so each replica's
        # /status view costs ONE directive read instead of re-reading
        # every peer row itself (O(N) store traffic fleet-wide per
        # tick, not O(N^2))
        self._write(peers=[rows[i] for i in sorted(rows)])
        # read back through self.rec: a fenced write ADOPTS the rival
        # coordinator's record, replacing the dict `rec` aliases
        rec = self.rec
        counts["pio_fleet_state"] = 1 if rec["state"] == "canary" else 0
        return {**rec, "pinned": dict(rec["pinned"]),
                "scale": dict(rec.get("scale") or {})}

    def _write(self, peers=None) -> None:
        """Epoch-fenced directive commit: bump past the last epoch WE
        own; if the on-disk record has overtaken it, another
        coordinator is live — adopt its record and skip this write (the
        fenced-writer half of the lease idiom; ownership trades back on
        our next state transition, which bumps past the rival).
        ``peers`` rides along as display/aggregation payload (never
        part of the adopted state machine record)."""
        on_disk = self._ma.read_fleet_doc(
            self.storage, self._ma.fleet_row_id(self.group))
        if on_disk is not None \
                and int(on_disk.get("epoch", 0)) > self._epoch_base:
            log.warning(
                "fleet directive epoch %s has overtaken ours (%s): "
                "another coordinator owns this fleet; adopting its "
                "record", on_disk.get("epoch"), self._epoch_base)
            self._adopt(on_disk)
            return
        if self._dirty:
            # the epoch versions the STATE MACHINE record: peer-refresh
            # writes re-commit the same epoch, state transitions bump it
            self.rec["epoch"] = self._epoch_base + 1
        self.rec["updatedAt"] = time.time()
        self._ma.write_fleet_doc(
            self.storage, self._ma.fleet_row_id(self.group),
            {**self.rec, "peers": list(peers or ())},
            fault=True)
        self._epoch_base = self.rec["epoch"]
        self._dirty = False


def run_fleet(worker_argv: Sequence[str], replicas: int, host: str,
              port: int, *, engine_factory_name: str,
              engine_variant: str = "default",
              run_dir: Optional[str] = None,
              app_name: str = "",
              elastic: bool = False) -> int:
    """Blocking entry for ``pio deploy --replicas N``: spawn N
    supervised replica processes, splice client connections to them,
    and run the staged-rollout coordinator.

    ``worker_argv`` is the full command line of ONE replica (the CLI
    passes ``pio deploy --replica-worker ...``; the test harness passes
    its jax-free server script); the supervisor adds the fleet identity
    env (``PIO_FLEET_REPLICA``, ``PIO_FLEET_REPLICAS``,
    ``PIO_QUERY_REPLICA_PORT``) per worker. Spawning stays confined to
    ``parallel/supervisor.py``.

    ``elastic=True`` (``pio deploy --replicas auto``) arms the
    autoscaler (``workflow/elastic.py``): the fleet starts at
    ``PIO_FLEET_MIN_REPLICAS`` (or the explicit ``replicas`` clamped
    into the [min, max] envelope; pass ``replicas <= 0`` for "start at
    the floor"), and the front's elastic loop scrapes every replica's
    ``/status`` each ``PIO_SCALE_TICK_MS``, growing the fleet through
    the supervisor's :meth:`~..parallel.supervisor.Supervisor.add_worker`
    and shrinking it by draining the least-loaded ready replica
    (routing withdrawn FIRST, then the supervisor's graceful
    retirement). Replica identity is slot-based: a drained slot frees
    its index, a scale-up reuses the lowest free one."""
    from ..data.storage.registry import Storage
    from ..parallel.supervisor import Supervisor

    ecfg = None
    if elastic:
        from .elastic import (ElasticConfig, ElasticController,
                              ReplicaSample, sample_status)

        ecfg = ElasticConfig.from_env(
            default_min=max(1, int(replicas)) if replicas > 0 else 1)
        if replicas <= 0:
            replicas = ecfg.min_replicas
        replicas = min(max(int(replicas), ecfg.min_replicas),
                       ecfg.max_replicas)
    else:
        replicas = max(1, int(replicas))
    sync_ms = envknobs.env_float("PIO_FLEET_SYNC_MS", 1000.0, lo=50.0)
    ready_ms = envknobs.env_float("PIO_FLEET_READY_MS", 500.0, lo=50.0)
    connect_retry_ms = envknobs.env_ms(
        "PIO_FLEET_CONNECT_RETRY_MS", 1000.0, lo_ms=0.0)
    # slot-indexed ports: None marks a freed slot (elastic scale-down);
    # a later scale-up reassigns the slot with a fresh port
    ports: list[Optional[int]] = [Supervisor._free_port()
                                  for _ in range(replicas)]
    base_env = dict(os.environ)
    chaos = base_env.pop("PIO_FLEET_WORKER_FAULT_SPEC", None)
    # per-replica chaos (a scheduled fault timeline):
    # PIO_FLEET_WORKER_FAULT_SPEC_<i> overrides the shared spec for
    # replica i only — a scheduled crash can target ONE replica
    # instead of SIGKILLing the whole fleet at the same offset
    _chaos_prefix = "PIO_FLEET_WORKER_FAULT_SPEC_"
    per_replica_chaos = {}
    for key in [k for k in base_env if k.startswith(_chaos_prefix)]:
        try:
            per_replica_chaos[int(key[len(_chaos_prefix):])] = \
                base_env.pop(key)
        except ValueError:
            pass
    base_env.pop("PIO_QUERY_REPLICAS", None)
    if app_name:
        # replicas must derive the SAME app-scoped directive group as
        # this coordinator (create_server._fleet_group reads this)
        base_env["PIO_FLEET_APP"] = app_name

    def env_for(attempt: int, idx: int) -> dict:
        if attempt > 0:
            # port TOCTOU on respawn: re-pick, the front routes off
            # the live list (the event-server front convention)
            ports[idx] = Supervisor._free_port()
        env = {
            "PIO_FLEET_REPLICA": str(idx),
            "PIO_FLEET_REPLICAS": str(replicas),
            "PIO_QUERY_REPLICA_PORT": str(ports[idx]),
        }
        spec = per_replica_chaos.get(idx, chaos)
        if spec and attempt == 0:
            env["PIO_FAULT_SPEC"] = spec
        return env

    sup = Supervisor(list(worker_argv), replicas, env=base_env,
                     per_worker_env=env_for, restart_scope="worker",
                     run_dir=run_dir)
    coordinator = FleetCoordinator(
        Storage.instance(), replicas, engine_factory_name,
        engine_variant, sync_ms=sync_ms, app_name=app_name)
    sup_done = threading.Event()
    outcome = {}

    def run_sup():
        try:
            outcome["state"] = sup.run()
        except BaseException:  # noqa: BLE001 — a crashed supervisor is
            # a FAILED fleet, not a clean drain: without the explicit
            # state, run_fleet would default to "drained" and exit 0
            # with nothing serving
            log.exception("fleet supervisor crashed")
            outcome["state"] = "error"
        finally:
            sup_done.set()

    t = threading.Thread(target=run_sup, daemon=True)
    t.start()
    log.info("engine fleet: front on %s:%d, %d replica(s) on ports %s "
             "(group %s, run dir %s)", host, port, replicas, ports,
             coordinator.group, sup.run_dir)

    # loop-confined snapshots the /healthz provider reads (the
    # coordinator's own dict mutates on a worker thread)
    last_rec: dict = {"rec": dict(coordinator.rec)}
    # allocated slots (live or draining); the elastic loop is the only
    # mutator, so the other loops can iterate a sorted copy freely
    slots: set[int] = set(range(replicas))
    draining_slots: set[int] = set()
    elastic_state: dict = {"target": replicas, "lastDecision": None}

    def healthz() -> dict:
        rec = last_rec["rec"]
        backends = []
        for i in sorted(slots):
            pid = sup.worker_pid(i)
            backends.append({
                "replica": i,
                "port": ports[i] if i < len(ports) else None,
                "pid": pid,
                "alive": pid is not None,
                "ready": front.is_ready(i) and not front.is_draining(i),
                "draining": front.is_draining(i),
                "restarts": (sup.worker_restarts[i]
                             if i < len(sup.worker_restarts) else 0),
            })
        active = [i for i in sorted(slots) if not front.is_draining(i)]
        # target vs actual (not the launch-time N): a mid-scale fleet
        # reads as "2 of target 3 active, 2 ready" rather than
        # degraded, and a DRAINING replica is reported as such — an
        # intentional drain is not a dead backend
        doc = {
            "status": "alive",
            "group": coordinator.group,
            "replicas": elastic_state["target"],
            "targetReplicas": elastic_state["target"],
            "activeReplicas": len(active),
            "readyReplicas": front.ready_count(),
            "drainingReplicas": sorted(draining_slots),
            "state": rec.get("state"),
            "instance": rec.get("instance"),
            "target": rec.get("target"),
            "canaryReplica": rec.get("canaryReplica"),
            "epoch": rec.get("epoch"),
            "pinned": rec.get("pinned") or {},
            "backends": backends,
            "runDir": sup.run_dir,
            # the reference's pio_fleet_* counts (no /metrics in the port)
            "metrics": {k: (dict(v) if isinstance(v, dict) else v)
                        for k, v in coordinator.counts.items()},
        }
        if ecfg is not None:
            last = elastic_state["lastDecision"]
            doc["elastic"] = {
                "enabled": True,
                "min": ecfg.min_replicas,
                "max": ecfg.max_replicas,
                "target": elastic_state["target"],
                "actual": len(active),
                "config": ecfg.to_json(),
                "lastDecision": last,
                "decisions": list(controller.decisions[-5:]),
                "samples": list(elastic_state.get("samples") or ()),
            }
        return doc

    front = FrontProxy(ports, healthz_provider=healthz,
                       connect_retry_s=connect_retry_ms / 1000.0)
    for i in range(replicas):
        # seed not-ready: FrontProxy treats UNPROBED backends as ready
        # (the event-server-compat default), which would report
        # readyReplicas == N on /healthz before any replica has even
        # bound its port — readiness gates (bench fleet_up, monitors)
        # must see 0 until the first probe pass really answers
        front.set_ready(i, False)

    async def ready_loop() -> None:
        while True:
            # probe concurrently: one wedged replica (accepts but never
            # answers — exactly the heartbeat-stall window before the
            # supervisor kills it) must cost the pass ONE probe timeout,
            # not serialize every other replica's mark stale behind it.
            # Draining slots are skipped (their not-ready mark is
            # intentional and already set) and freed slots have no port.
            idxs = [i for i in sorted(slots)
                    if i < len(ports) and ports[i] is not None
                    and not front.is_draining(i)]
            marks = await asyncio.gather(
                *(probe_ready("127.0.0.1", ports[i]) for i in idxs),
                return_exceptions=True)
            for i, ok in zip(idxs, marks):
                front.set_ready(i, ok is True)
            coordinator.counts["pio_fleet_replicas_ready"] = \
                front.ready_count()
            await asyncio.sleep(ready_ms / 1000.0)

    async def coord_loop() -> None:
        while True:
            try:
                last_rec["rec"] = await asyncio.to_thread(
                    coordinator.step)
            except Exception:  # noqa: BLE001 — retried next tick
                log.exception("fleet coordinator step failed; retrying")
            await asyncio.sleep(sync_ms / 1000.0)

    if ecfg is not None:
        controller = ElasticController(ecfg)
        prev_shed: dict[int, int] = {}

        async def scrape_samples() -> list:
            idxs = [i for i in sorted(slots)
                    if i < len(ports) and ports[i] is not None]
            docs = await asyncio.gather(
                *(sample_status("127.0.0.1", ports[i]) for i in idxs),
                return_exceptions=True)
            samples = []
            for i, doc in zip(idxs, docs):
                drng = front.is_draining(i)
                s = ReplicaSample(
                    slot=i, alive=sup.worker_pid(i) is not None,
                    ready=front.is_ready(i) and not drng, draining=drng)
                if isinstance(doc, dict):
                    ov = doc.get("overload") or {}
                    s.pending = int(ov.get("pending") or 0)
                    s.pending_limit = int(ov.get("pendingLimit") or 0)
                    shed_total = int(ov.get("shed") or 0)
                    prev = prev_shed.get(i)
                    s.shed_delta = (max(0, shed_total - prev)
                                    if prev is not None else 0)
                    prev_shed[i] = shed_total
                samples.append(s)
            return samples

        def do_scale_up() -> int:
            # lowest free slot — slot identity is stable, so the
            # coordinator's status rows and the front's readiness
            # marks never alias across scale cycles
            idx = 0
            while idx in slots:
                idx += 1
            while len(ports) <= idx:
                ports.append(None)
            ports[idx] = Supervisor._free_port()
            slots.add(idx)
            front.set_backend(idx, ports[idx])
            front.set_ready(idx, False)
            coordinator.set_replicas(idx + 1)
            sup.add_worker(idx)
            return idx

        def do_scale_down(slot: int) -> None:
            # ordering is the lossless-drain contract: routing is
            # withdrawn FIRST (draining excludes the slot from BOTH
            # connect passes), THEN the supervisor SIGTERMs it — the
            # replica finishes its in-flight queries and cuts
            # keep-alives on its own graceful drain path, and clients
            # reconnect through the front to the survivors
            front.set_ready(slot, False)
            front.set_draining(slot, True)
            draining_slots.add(slot)
            sup.retire_worker(slot)

        def reap_drained() -> None:
            for i in sorted(draining_slots):
                if sup.worker_pid(i) is None and not sup.is_retiring(i):
                    # booked out by the supervisor: the slot is free
                    front.set_backend(i, None)
                    ports[i] = None
                    slots.discard(i)
                    draining_slots.discard(i)
                    prev_shed.pop(i, None)
                    log.info("elastic: slot %d released", i)

        async def elastic_loop() -> None:
            while True:
                try:
                    reap_drained()
                    samples = await scrape_samples()
                    decision = controller.observe(samples)
                    elastic_state["samples"] = [s.to_json()
                                                for s in samples]
                    elastic_state["lastDecision"] = decision.to_json()
                    if decision.direction == "up":
                        idx = do_scale_up()
                        entry = controller.record_action(decision)
                        entry["slot"] = idx
                        elastic_state["target"] = decision.target
                        coordinator.apply_scale(entry)
                        log.info("elastic: scale-up (%s) -> replica %d "
                                 "spawning, target %d", decision.reason,
                                 idx, decision.target)
                    elif decision.direction == "down":
                        do_scale_down(decision.slot)
                        entry = controller.record_action(decision)
                        elastic_state["target"] = decision.target
                        coordinator.apply_scale(entry)
                        log.info("elastic: scale-down (%s) -> replica "
                                 "%d draining, target %d",
                                 decision.reason, decision.slot,
                                 decision.target)
                except Exception:  # noqa: BLE001 — retried next tick
                    log.exception("elastic tick failed; retrying")
                await asyncio.sleep(ecfg.tick_ms / 1000.0)

    async def front_main() -> None:
        await front.start(host, port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        import signal as _signal
        for sig in (_signal.SIGTERM, _signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):  # pragma: no cover
                pass
        tasks = [loop.create_task(ready_loop()),
                 loop.create_task(coord_loop())]
        if ecfg is not None:
            tasks.append(loop.create_task(elastic_loop()))
        # the front lives exactly as long as its replicas: a supervisor
        # that gave up must take the front down rather than keep
        # accepting connections nothing can serve
        while not stop.is_set() and not sup_done.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=0.25)
            except asyncio.TimeoutError:
                pass
        for task in tasks:
            task.cancel()
        for task in tasks:
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        await front.stop()
        sup.request_stop()

    try:
        asyncio.run(front_main())
    finally:
        # runs on the crash path too (e.g. EADDRINUSE binding the
        # front): the supervisor was started BEFORE the front, so an
        # early exception must still drain the N replica processes —
        # a daemon thread dying with the CLI would orphan them all
        sup.request_stop()
        sup_done.wait(timeout=60)
        t.join(timeout=5)
    # outcome is only empty when the supervisor never reached a
    # terminal state within the wait — a wedge, not a clean drain
    state = outcome.get("state", "wedged")
    log.info("engine fleet stopped (%s)", state)
    return 0 if state in ("drained", "completed") else 1


def replica_worker_entry() -> int:
    """Entry body of one fleet replica process (`pio deploy
    --replica-worker` and the test harness land here after loading
    their engine): resolves the supervisor-assigned identity. Returns
    the replica's listen port. The ``fleet.spawn`` fault point fires
    here — first-launch chaos (``PIO_FLEET_WORKER_FAULT_SPEC``) proves
    a replica crashing at spawn is relaunched by the supervisor without
    client impact."""
    from ..parallel.supervisor import die_with_parent

    die_with_parent("fleet front")
    faultinject.fault_point("fleet.spawn")
    port = envknobs.env_int("PIO_QUERY_REPLICA_PORT", 0, lo=0)
    if port <= 0:
        print("[error] --replica-worker requires PIO_QUERY_REPLICA_PORT "
              "(set by the fleet supervisor — this flag is internal)",
              file=sys.stderr)
        return -1
    return port
