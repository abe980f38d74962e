"""The port's fleet coordinator, replica side and splice front on the CPU.

- ``FleetCoordinator.step`` against the reference's: the same replica
  status rows fed to both coordinators, each on its own package's memory
  storage holding the same engine-instance rows, through a bootstrap
  adoption, a canary candidate, a watch still open, a clean watch
  (promote), a pin (fleet rollback), an all-pinned fleet, the heal by a
  canary and a fenced stale epoch: the directive documents written are
  byte-identical (sorted-key JSON) at every step.
- The reference's coordinator cases (``tests/test_fleet.py``): the state
  machine under injected ``fleet.promote`` / ``fleet.record`` faults, epoch
  fencing, the heal from an all-pinned fleet; the replica's ``/reload`` and
  ``/stop`` refused and ``/rollback`` with no previous deployment, the
  provisional pin kept out of the status row and the peer snapshot; a
  relaunched replica booting on the directive; the tenant-aware fleet app
  (``PIO_FLEET_APP``); the TLS refusal of ``deploy --replicas``.
- The front: readiness skip and the front's own ``/healthz`` (a request
  line split across segments included), the connect-refused retry, the
  connect-retry budget, the draining marks.
"""

import asyncio
import datetime as dt
import json
import socket
import time

import pytest

pytest.importorskip("torch")

import torch_serving as ts  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.storage.base import (  # noqa: E402
    EngineInstance as RefEngineInstance,
)
from incubator_predictionio_tpu.workflow import fleet as ref_fleet  # noqa: E402
from incubator_predictionio_tpu.workflow import model_artifact as ref_ma  # noqa: E402
from incubator_predictionio_torch.common import faultinject  # noqa: E402
from incubator_predictionio_torch.common.faultinject import InjectedFault  # noqa: E402
from incubator_predictionio_torch.common.splice import FrontProxy  # noqa: E402
from incubator_predictionio_torch.data.storage.base import EngineInstance  # noqa: E402
from incubator_predictionio_torch.workflow import fleet, model_artifact  # noqa: E402
from incubator_predictionio_torch.workflow.create_server import EngineServer  # noqa: E402

GROUP = "lifecycle::default"
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)


@pytest.fixture()
def chaos(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("PIO_FAULT_SPEC", spec)
        faultinject.reset()
    yield arm
    monkeypatch.delenv("PIO_FAULT_SPEC", raising=False)
    faultinject.reset()


def _row(replica, **kw):
    doc = {"replica": replica, "pid": 1, "instance": None,
           "previous": None, "pinned": {}, "rollbacks": {},
           "draining": False, "watchDone": True, "epochSeen": 0,
           "updatedAt": time.time()}
    doc.update(kw)
    return doc


def _write_row(ma, storage, replica, **kw):
    ma.write_fleet_doc(storage, ma.fleet_row_id(GROUP, replica),
                       _row(replica, **kw))


# -- the coordinator against the reference's ----------------------------------

def _instance(cls, iid: str, minute: int):
    return cls(id=iid, status="COMPLETED",
               start_time=T0 + dt.timedelta(minutes=minute),
               end_time=T0 + dt.timedelta(minutes=minute, seconds=30),
               engine_id="lifecycle", engine_version="1",
               engine_variant="default", engine_factory="lifecycle")


def test_fleet_record_helpers_match_the_reference():
    for group in (GROUP, "f::v::app=a"):
        for replica in (None, 0, 3):
            assert model_artifact.fleet_row_id(group, replica) == \
                ref_ma.fleet_row_id(group, replica)
    for sync_ms in (50.0, 200.0, 1000.0, 2000.0, 30_000.0):
        assert model_artifact.fleet_fresh_s(sync_ms) == \
            ref_ma.fleet_fresh_s(sync_ms)


def test_coordinator_step_matches_the_reference(monkeypatch):
    clock = [1_700_000_000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    port = ts.memory_storage()
    ref = ref_storage.Storage(dict(ts.MEM_ENV))
    sides = [(port, model_artifact, EngineInstance, fleet.FleetCoordinator),
             (ref, ref_ma, RefEngineInstance, ref_fleet.FleetCoordinator)]

    def add_instance(iid, minute):
        for storage, _ma, cls, _c in sides:
            storage.get_meta_data_engine_instances().insert(
                _instance(cls, iid, minute))

    def rows(replica, **kw):
        for storage, ma, _cls, _c in sides:
            _write_row(ma, storage, replica, **kw)

    add_instance("inst-a", 0)
    coords = [c(storage, 2, "lifecycle", sync_ms=250.0)
              for storage, _ma, _cls, c in sides]
    trace = []

    def step(what):
        clock[0] += 1.0
        snaps = [json.dumps(c.step(), sort_keys=True) for c in coords]
        disk = [bytes(storage.get_model_data_models().get(
                    ma.fleet_row_id(GROUP)).models)
                for storage, ma, _cls, _c in sides]
        assert snaps[0] == snaps[1], what
        assert disk[0] == disk[1], what
        trace.append(json.loads(disk[0]))
        return trace[-1]

    rows(0, instance="inst-a")
    rows(1, instance="inst-a")
    assert step("bootstrap adoption")["instance"] == "inst-a"
    add_instance("inst-b", 1)
    d = step("canary candidate")
    assert (d["state"], d["target"], d["canaryReplica"]) == \
        ("canary", "inst-b", 0)
    rows(0, instance="inst-b", previous="inst-a", watchDone=False)
    assert step("watch open")["state"] == "canary"
    rows(0, instance="inst-b", previous="inst-a", watchDone=True)
    d = step("clean watch: promote")
    assert (d["state"], d["instance"], d["lastGood"]) == \
        ("steady", "inst-b", "inst-a")
    for c in coords:
        c.apply_scale({"direction": "up", "reason": "shed", "target": 3})
    rows(1, instance="inst-a", pinned={"inst-b": "manual"})
    d = step("a pin: fleet rollback")
    assert d["instance"] == "inst-a" and d["pinned"] == {"inst-b": "manual"}
    assert d["scale"]["target"] == 3
    rows(0, instance="inst-a", pinned={"inst-a": "error-rate"})
    rows(1, instance="inst-a", pinned={"inst-a": "error-rate"})
    d = step("all pinned")
    assert d["instance"] is None and d["state"] == "steady"
    add_instance("inst-c", 2)
    d = step("heal: canary without a reference instance")
    assert (d["state"], d["target"]) == ("canary", "inst-c")
    rows(0, instance="inst-c", watchDone=True)
    assert step("heal promoted")["instance"] == "inst-c"
    for storage, ma, _cls, _c in sides:
        rival = {**trace[-1], "epoch": trace[-1]["epoch"] + 5,
                 "instance": "rival-inst"}
        ma.write_fleet_doc(storage, ma.fleet_row_id(GROUP), rival)
    add_instance("inst-d", 3)
    d = step("fenced stale epoch: adopt the rival")
    assert d["instance"] == "rival-inst"
    assert [t["epoch"] for t in trace] == sorted(t["epoch"] for t in trace)
    port.close()
    ref.close()


# -- the reference's coordinator cases ------------------------------------------

def test_coordinator_state_machine_with_fault_points(chaos):
    storage = ts.memory_storage()
    iid_a = ts.train_lifecycle(storage, "one")
    coord = fleet.FleetCoordinator(storage, 2, "lifecycle", sync_ms=250.0)
    _write_row(model_artifact, storage, 0, instance=iid_a)
    _write_row(model_artifact, storage, 1, instance=iid_a)
    rec = coord.step()
    assert rec["state"] == "steady" and rec["instance"] == iid_a

    iid_b = ts.train_lifecycle(storage, "two")
    rec = coord.step()
    assert rec["state"] == "canary"
    assert rec["target"] == iid_b and rec["canaryReplica"] == 0

    _write_row(model_artifact, storage, 0, instance=iid_b, previous=iid_a,
               watchDone=False)
    rec = coord.step()
    assert rec["state"] == "canary" and rec["instance"] == iid_a

    # the first promote is fault-injected: nothing advances, the next
    # tick promotes
    _write_row(model_artifact, storage, 0, instance=iid_b, previous=iid_a,
               watchDone=True)
    chaos("fleet.promote:fail:1")
    with pytest.raises(InjectedFault):
        coord.step()
    assert coord.rec["state"] == "canary"
    rec = coord.step()
    assert rec["state"] == "steady" and rec["instance"] == iid_b
    assert rec["lastGood"] == iid_a
    on_disk = model_artifact.read_fleet_doc(
        storage, model_artifact.fleet_row_id(GROUP))
    assert on_disk["instance"] == iid_b

    # replica 1 pins the promoted instance: the fleet rolls back, and the
    # first directive write is fault-injected, so the next tick commits
    _write_row(model_artifact, storage, 1, instance=iid_a,
               pinned={iid_b: "manual"})
    chaos("fleet.record:fail:1")
    with pytest.raises(InjectedFault):
        coord.step()
    rec = coord.step()
    assert rec["instance"] == iid_a
    assert rec["pinned"] == {iid_b: "manual"}
    on_disk = model_artifact.read_fleet_doc(
        storage, model_artifact.fleet_row_id(GROUP))
    assert on_disk["instance"] == iid_a
    assert on_disk["pinned"] == {iid_b: "manual"}
    # no double count: exactly one fleet rollback recorded
    assert coord.counts["pio_fleet_rollbacks_total"] == {"manual": 1}
    assert coord.counts["pio_fleet_promotes_total"] == 1


def test_coordinator_epoch_fencing():
    storage = ts.memory_storage()
    iid_a = ts.train_lifecycle(storage, "one")
    coord = fleet.FleetCoordinator(storage, 1, "lifecycle")
    _write_row(model_artifact, storage, 0, instance=iid_a)
    rec = coord.step()
    assert rec["instance"] == iid_a
    # a rival coordinator bumps the epoch past ours: our next write ADOPTS
    rival = {**rec, "epoch": rec["epoch"] + 5, "instance": "rival-inst"}
    model_artifact.write_fleet_doc(
        storage, model_artifact.fleet_row_id(GROUP), rival)
    ts.train_lifecycle(storage, "two")     # would normally stage
    rec = coord.step()
    assert rec["instance"] == "rival-inst", rec
    assert rec["epoch"] == rival["epoch"]
    on_disk = model_artifact.read_fleet_doc(
        storage, model_artifact.fleet_row_id(GROUP))
    assert on_disk["instance"] == "rival-inst"


def test_fleet_heals_from_all_pinned_via_canary():
    storage = ts.memory_storage()
    iid_a = ts.train_lifecycle(storage, "one")
    coord = fleet.FleetCoordinator(storage, 2, "lifecycle")
    _write_row(model_artifact, storage, 0, instance=iid_a)
    _write_row(model_artifact, storage, 1, instance=iid_a)
    assert coord.step()["instance"] == iid_a
    _write_row(model_artifact, storage, 0, instance=iid_a,
               pinned={iid_a: "error-rate"})
    rec = coord.step()
    assert rec["instance"] is None and rec["state"] == "steady"
    iid_b = ts.train_lifecycle(storage, "two")
    rec = coord.step()
    assert rec["state"] == "canary" and rec["target"] == iid_b
    assert rec["canaryReplica"] == 0
    _write_row(model_artifact, storage, 0, instance=iid_b, watchDone=True)
    rec = coord.step()
    assert rec["state"] == "steady" and rec["instance"] == iid_b


# -- the replica side ------------------------------------------------------------

def _replica(storage, replica=0, replicas=1, **kw):
    return EngineServer(ts.lifecycle_engine(), engine_factory_name="lifecycle",
                        storage=storage, device="cpu", fleet_replica=replica,
                        fleet_replicas=replicas, fleet_sync_ms=200, **kw)


def test_fleet_mode_reload_refused_and_rollback_without_previous():
    """/reload and /stop answer 409 on a fleet replica, and /rollback on a
    replica with NO resident previous deployment pins the current instance
    and walks back through the store."""
    from incubator_predictionio_torch.tools.commands.engine import undeploy_cmd

    storage = ts.memory_storage()
    iid_a = ts.train_lifecycle(storage, "one")
    iid_b = ts.train_lifecycle(storage, "two")
    server = _replica(storage)
    assert server.instance.id == iid_b      # fresh boot: no previous
    with ts.serving(server) as base:
        status, body, _ = ts.call(base, "GET", "/reload")
        assert status == 409 and "coordinator-driven" in body["message"]
        status, body, _ = ts.call(base, "POST", "/stop")
        assert status == 409 and "shrink the fleet" in body["message"]
        assert undeploy_cmd(["--port", base.rsplit(":", 1)[1]]) == 1

        status, body, _ = ts.call(base, "POST", "/rollback")
        assert status == 200, body
        assert body["engineInstanceId"] == iid_a and body["fleet"] is True
        lc = ts.status(base)["lifecycle"]
        assert lc["instance"] == iid_a
        assert lc["pinned"] == {iid_b: "manual"}
        assert lc["rollbacks"] == {"manual": 1}
        # the pinned instance is no hedge or swap-back target, and no watch
        # blames the restored last-good
        assert lc["previous"] is None and lc["watch"] is None
        assert ts.query(base, {"user": "u"})[1]["tag"] == "one"
        # the rollback poked the sync thread: the pin is in the status row
        row = ts.wait_for(lambda: (lambda r: r if r and r.get("pinned")
                                   else None)(model_artifact.read_fleet_doc(
                                       storage, model_artifact.fleet_row_id(
                                           GROUP, 0))), 10)
        assert row["pinned"] == {iid_b: "manual"}
        assert ts.status(base)["fleet"]["replica"] == 0


def test_provisional_pin_unpublished_and_peer_snapshot():
    storage = ts.memory_storage()
    ts.train_lifecycle(storage, "one")
    server = _replica(storage, replicas=2)
    cur = server.instance.id
    with server._lock:
        server._pinned["ghost"] = "manual"
        server._pins_provisional.add("ghost")
    server._fleet_publish({})
    row = model_artifact.read_fleet_doc(
        storage, model_artifact.fleet_row_id(GROUP, 0))
    assert "ghost" not in row["pinned"], row
    with server._lock:
        server._pins_provisional.discard("ghost")
    server._fleet_publish({})
    row = model_artifact.read_fleet_doc(
        storage, model_artifact.fleet_row_id(GROUP, 0))
    assert row["pinned"] == {"ghost": "manual"}

    # the stale copy of OUR row in the coordinator's snapshot is replaced by
    # the just-written one; the peer's row rides through untouched
    server._fleet_publish({"peers": [
        {"replica": 0, "instance": "stale-snapshot"},
        {"replica": 1, "instance": "peer-inst"}]})
    view = server._fleet_view
    assert [p["replica"] for p in view["peers"]] == [0, 1]
    assert view["peers"][0]["instance"] == cur
    assert view["peers"][1]["instance"] == "peer-inst"
    assert view["divergence"] is True
    server.close()


def test_fleet_bootstrap_honours_the_directive():
    """A replica relaunched after a fleet rollback boots on the directed
    instance with the fleet's pins, not on the newest COMPLETED row."""
    storage = ts.memory_storage()
    iid_a = ts.train_lifecycle(storage, "one")
    iid_b = ts.train_lifecycle(storage, "two")
    model_artifact.write_fleet_doc(
        storage, model_artifact.fleet_row_id(GROUP),
        {"epoch": 3, "state": "steady", "instance": iid_a,
         "pinned": {iid_b: "manual"}})
    server = _replica(storage)
    assert server.instance.id == iid_a
    assert server.lifecycle_snapshot()["pinned"] == {iid_b: "manual"}
    server.close()


def test_tenant_aware_fleet_app_scopes_both_sides(monkeypatch):
    """With the tenant mux armed the front scopes its coordinator to the
    default app, and every replica (told through PIO_FLEET_APP) derives
    the same directive group as the coordinator and the reference."""
    from incubator_predictionio_torch.workflow import multitenant

    engine_json = {"datasource": {"params": {"appName": "shop"}}}
    assert multitenant.fleet_app(engine_json, armed=False) == ""
    app = multitenant.fleet_app(engine_json, armed=True)
    assert app == "shop"
    storage = ts.memory_storage()
    ts.train_lifecycle(storage, "one")
    coord = fleet.FleetCoordinator(storage, 1, "lifecycle", app_name=app)
    monkeypatch.setenv("PIO_FLEET_APP", app)
    server = _replica(storage)
    assert server._fleet_group() == coord.group == \
        ref_ma.fleet_group("lifecycle", "default", "shop")
    server._fleet_publish({})
    assert model_artifact.read_fleet_doc(
        storage, model_artifact.fleet_row_id(coord.group, 0)) is not None
    server.close()


def test_deploy_replicas_refuses_tls(monkeypatch, capsys):
    from incubator_predictionio_torch.tools.commands.engine import (
        _strip_replicas, deploy_cmd,
    )

    monkeypatch.setenv("PIO_SSL_CERTFILE", "/nonexistent/cert.pem")
    monkeypatch.setenv("PIO_SSL_KEYFILE", "/nonexistent/key.pem")
    assert deploy_cmd(["--replicas", "2"]) == 1
    assert "plaintext L4" in capsys.readouterr().err
    assert _strip_replicas(["--replicas", "2", "--port", "9",
                            "--replicas=3", "--device", "cpu"]) == \
        ["--port", "9", "--device", "cpu"]


# -- the front -------------------------------------------------------------------

def _ok_backend(hits, idx):
    async def handle(reader, writer):
        hits[idx] += 1
        await reader.read(65536)
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n"
                     b"Connection: close\r\n\r\nok")
        await writer.drain()
        writer.close()
    return handle


async def _get(port, path):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(f"GET {path} HTTP/1.1\r\nHost: f\r\n"
            "Connection: close\r\n\r\n".encode())
    await w.drain()
    data = await r.read()
    w.close()
    return data


def test_front_readiness_skip_and_healthz():
    async def run():
        hits = {0: 0, 1: 0}
        servers, ports = [], []
        for i in range(2):
            srv = await asyncio.start_server(_ok_backend(hits, i),
                                             "127.0.0.1", 0)
            servers.append(srv)
            ports.append(srv.sockets[0].getsockname()[1])
        front = FrontProxy(ports, healthz_provider=lambda: {
            "status": "alive", "n": 2})
        await front.start("127.0.0.1", 0)
        fport = front._server.sockets[0].getsockname()[1]

        # /healthz answered by the FRONT itself, not a backend
        body = await _get(fport, "/healthz")
        assert b"200 OK" in body
        assert json.loads(body.split(b"\r\n\r\n", 1)[1])["n"] == 2
        assert hits == {0: 0, 1: 0}

        # a request line split across segments is still the front's
        r, w = await asyncio.open_connection("127.0.0.1", fport)
        w.write(b"GET /hea")
        await w.drain()
        await asyncio.sleep(0.05)
        w.write(b"lthz HTTP/1.1\r\nHost: f\r\nConnection: close\r\n\r\n")
        await w.drain()
        body = await r.read()
        w.close()
        assert json.loads(body.split(b"\r\n\r\n", 1)[1])["n"] == 2
        assert hits == {0: 0, 1: 0}

        # a not-ready backend is skipped for new connections
        front.set_ready(0, False)
        for _ in range(4):
            assert b"ok" in await _get(fport, "/queries.json")
        assert hits[0] == 0 and hits[1] == 4
        assert front.ready_count() == 1

        # a connect-refused backend: retried onto the survivor within the
        # same accept, though the survivor is marked not-ready
        front.set_ready(0, True)
        front.set_ready(1, False)
        servers[0].close()
        await servers[0].wait_closed()
        assert b"ok" in await _get(fport, "/queries.json")
        assert hits[1] == 5

        await front.stop()
        servers[1].close()
        await servers[1].wait_closed()

    asyncio.run(run())


def test_front_connect_retry_budget():
    """With ``connect_retry_s`` > 0 a window where EVERY backend refuses
    costs the client a short wait, not a drop."""
    async def run():
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        front = FrontProxy([port], connect_retry_s=3.0)
        await front.start("127.0.0.1", 0)
        fport = front._server.sockets[0].getsockname()[1]

        async def backend_up_later():
            await asyncio.sleep(0.4)
            return await asyncio.start_server(_ok_backend({0: 0}, 0),
                                              "127.0.0.1", port)

        t = asyncio.get_running_loop().create_task(backend_up_later())
        body = await _get(fport, "/q")      # issued while NOTHING accepts
        srv = await t
        assert b"ok" in body, body
        await front.stop()
        srv.close()
        await srv.wait_closed()

    asyncio.run(run())


def test_front_draining_marks():
    front = FrontProxy([1001, 1002])
    front.set_ready(0, True)
    front.set_ready(1, True)
    assert (front.active_count(), front.ready_count()) == (2, 2)
    front.set_draining(1, True)
    assert front.is_draining(1)
    assert (front.active_count(), front.ready_count()) == (1, 1)
    assert not front._routable(1)
    front = FrontProxy([1001])
    front.set_backend(3, 1004)            # pads slots 1..2 as None
    assert front.worker_ports == [1001, None, None, 1004]
    assert front.active_count() == 2
    front.set_ready(3, True)
    front.set_draining(3, True)
    front.set_backend(3, None)            # freeing clears the marks
    assert not front.is_draining(3) and front.is_ready(3)
    front.set_backend(3, 1005)
    assert front._routable(3)
