"""The port's write-behind group commit (``incubator_predictionio_torch/
data/api/ingest_buffer.py``, on threads): groups cut by size and by the
collection window, both ack modes (``PIO_INGEST_ACK`` and ``X-Pio-Ack``),
a 503 + ``Retry-After`` once ``PIO_INGEST_MAX_PENDING`` is reached, a
drain that settles every waiter in flight, a mid-group ``ingest.commit``
failure that aborts the group's WAL frame and defers the enqueue-acked
events to the next recovery, and a real server process with
``PIO_WAL=1``, ``ack=enqueue`` and ``ingest.commit:crash:N`` that restarts
with every acknowledged event exactly once. The stored events of a
group-committed flood equal the JAX package's buffer's on the same
POSTs.
"""

import collections
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import requests

pytest.importorskip("torch")

from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.api.event_server import (  # noqa: E402
    EventServer as RefEventServer,
)
from incubator_predictionio_torch.common import faultinject  # noqa: E402
from incubator_predictionio_torch.data import storage as port_pkg  # noqa: E402
from incubator_predictionio_torch.data.api import ingest_wal  # noqa: E402
from incubator_predictionio_torch.data.api.event_server import (  # noqa: E402
    EventServer,
)
from incubator_predictionio_torch.data.api.ingest_buffer import (  # noqa: E402
    IngestBuffer, IngestConfig, IngestOverloadError,
)
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.data.storage.event import Event  # noqa: E402
from incubator_predictionio_torch.workflow.plugins import (  # noqa: E402
    EventServerPluginContext,
)

from server_utils import ServerThread, free_port  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSOLE = [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]
T = "2026-01-01T00:00:00.000Z"
KEY = "bufkey"


def _ev(i, **kw):
    d = {"event": "view", "entityType": "user", "entityId": f"u{i}",
         "targetEntityType": "item", "targetEntityId": f"i{i % 7}",
         "eventTime": T}
    d.update(kw)
    return d


def _env(tmp_path, name):
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
            for r in ("METADATA", "MODELDATA")} | {
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
        "PIO_STORAGE_SOURCES_M_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_M_PATH": str(tmp_path / f"{name}.sqlite"),
        "PIO_STORAGE_SOURCES_EV_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_EV_PATH": str(tmp_path / f"{name}-events")}


def _store(pkg, tmp_path, name):
    storage = pkg.Storage(_env(tmp_path, name))
    app_id = storage.get_meta_data_apps().insert(pkg.App(0, "bufapp"))
    storage.get_meta_data_access_keys().insert(pkg.AccessKey(KEY, app_id, ()))
    storage.get_l_events().init(app_id)
    return storage, app_id


class _Key:
    def __init__(self, appid, events=()):
        self.appid = appid
        self.events = events


class _Recorder:
    """An event store proxy that records the size of each canonical-lines
    write (one per group) and can hold writes until released."""

    def __init__(self, le):
        self._le = le
        self.writes = []
        self.entered = threading.Event()  # a write reached the store
        self.gate = threading.Event()
        self.gate.set()

    def insert_canonical_lines(self, data, app_id, channel_id=None):
        self.entered.set()
        self.gate.wait(30)
        self.writes.append(data.count(b"\n"))
        return self._le.insert_canonical_lines(data, app_id, channel_id)

    def __getattr__(self, name):
        return getattr(self._le, name)


class _Storage:
    def __init__(self, storage, le):
        self._s, self._le = storage, le

    def get_l_events(self):
        return self._le

    def __getattr__(self, name):
        return getattr(self._s, name)


def _buffer(tmp_path, config, wal=None):
    storage, app_id = _store(port_pkg, tmp_path, "buf")
    rec = _Recorder(storage.get_l_events())
    buf = IngestBuffer(_Storage(storage, rec), None,
                       EventServerPluginContext(), config, wal=wal)
    return buf, rec, storage, app_id


def _raw(i):
    return json.dumps(_ev(i)).encode()


def _in_threads(fn, n):
    out, errs = [None] * n, []

    def run(j):
        try:
            out[j] = fn(j)
        except BaseException as e:  # noqa: BLE001 - reported to the test
            out[j] = e
            errs.append(e)

    ts = [threading.Thread(target=run, args=(j,)) for j in range(n)]
    for t in ts:
        t.start()
    return ts, out, errs


@pytest.mark.parametrize("by", ["max", "ms"])
def test_groups_cut_by_max_and_by_window(tmp_path, by):
    """8 concurrent POSTs: with a long window and a group of at most 4
    they commit as two full groups well before the window; with room for
    all of them they wait out the window and commit as one group."""
    group_max, window = (4, 5000.0) if by == "max" else (64, 1000.0)
    buf, rec, storage, app_id = _buffer(tmp_path, IngestConfig(
        group_max=group_max, group_ms=window))
    rec.gate.clear()  # the first group waits for the others to queue
    key = _Key(app_id)
    t0 = time.monotonic()
    ts, out, errs = _in_threads(
        lambda j: buf.ingest_raw(_raw(j), key, None), 8)
    deadline = time.monotonic() + 30
    while buf.snapshot()["pending"] < 8 and time.monotonic() < deadline:
        time.sleep(0.005)
    rec.gate.set()
    for t in ts:
        t.join(30)
    took = time.monotonic() - t0
    assert not errs, errs
    assert len(set(out)) == 8
    if by == "max":
        assert rec.writes == [4, 4] and took < 4.0
    else:
        assert rec.writes == [8] and took >= 0.9
    assert sorted(e.event_id for e in storage.get_l_events().find(
        app_id)) == sorted(out)
    snap = buf.snapshot()
    assert snap["eventsCommitted"] == 8 and snap["pending"] == 0
    assert snap["maxGroup"] == (4 if by == "max" else 8)
    assert buf.drain(10)
    storage.close()


def test_default_window_is_write_behind(tmp_path):
    """The reference's default (group window 0): a lone request commits
    at once, and requests that queue behind a running commit ride the
    next group together."""
    cfg = IngestConfig.from_env()
    assert (cfg.group_ms, cfg.group_max, cfg.ack) == (0.0, 256, "commit")
    buf, rec, storage, app_id = _buffer(tmp_path, cfg)
    key = _Key(app_id)
    buf.ingest_raw(_raw(0), key, None)
    assert rec.writes == [1]
    rec.gate.clear()
    rec.entered.clear()
    first = threading.Thread(target=buf.ingest_raw,
                             args=(_raw(1), key, None))
    first.start()
    assert rec.entered.wait(30)  # the first group is cut and held
    ts, out, errs = _in_threads(
        lambda j: buf.ingest_raw(_raw(10 + j), key, None), 5)
    while buf.snapshot()["pending"] < 6:
        time.sleep(0.002)
    rec.gate.set()
    first.join(30)
    for t in ts:
        t.join(30)
    assert not errs and rec.writes == [1, 1, 5]
    assert buf.drain(10)
    storage.close()


def test_ack_modes_and_overload(tmp_path):
    """ack=commit returns after the store write; ack=enqueue returns the
    id while the store write is held; past max_pending the buffer sheds
    (IngestOverloadError with a Retry-After of at least 1 s)."""
    buf, rec, storage, app_id = _buffer(tmp_path, IngestConfig(
        max_pending=3, ack="enqueue"))
    assert buf.ack_on_enqueue
    key = _Key(app_id)
    eid = buf.ingest_raw(_raw(0), key, None)  # commit mode, explicitly
    assert storage.get_l_events().get(eid, app_id) is not None
    rec.gate.clear()
    ids = [buf.enqueue_event(Event.from_json(_ev(j)), _ev(j), key, None)
           for j in (1, 2, 3)]
    assert storage.get_l_events().get(ids[0], app_id) is None
    with pytest.raises(IngestOverloadError) as e:
        buf.enqueue_event(Event.from_json(_ev(4)), _ev(4), key, None)
    assert e.value.retry_after >= 1.0 and "buffer full" in str(e.value)
    rec.gate.set()
    assert buf.drain(10)
    with pytest.raises(IngestOverloadError, match="shutting down"):
        buf.ingest_raw(_raw(5), key, None)
    got = sorted(e.event_id for e in storage.get_l_events().find(app_id))
    assert got == sorted([eid] + ids)
    storage.close()


def test_overload_is_503_with_retry_after(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_INGEST_MAX_PENDING", "2")
    monkeypatch.setenv("PIO_INGEST_GROUP_MS", "1500")
    monkeypatch.setenv("PIO_INGEST_GROUP_MAX", "100")
    monkeypatch.setenv("PIO_ACCESSKEY_CACHE_SECS", "0")
    storage, app_id = _store(port_pkg, tmp_path, "ovl")
    server = EventServer(storage, "127.0.0.1", 0)
    host, port = server.start()
    base = f"http://{host}:{port}/events.json?accessKey={KEY}"
    try:
        ts, out, errs = _in_threads(
            lambda j: requests.post(base, json=_ev(j), timeout=30), 2)
        while server.ingest.snapshot()["pending"] < 2:
            time.sleep(0.005)
        r = requests.post(base, json=_ev(9), timeout=30)
        assert r.status_code == 503, r.text
        assert int(r.headers["Retry-After"]) >= 1
        assert "buffer full" in r.json()["message"]
        for t in ts:
            t.join(30)
        assert [x.status_code for x in out] == [201, 201]
        root = requests.get(f"http://{host}:{port}/", timeout=30).json()
        assert root["shedRequests"] == 1
        assert root["ingest"]["groupsCommitted"] == 1
    finally:
        server.stop()
    storage.close()


def test_drain_settles_every_waiter_in_flight(tmp_path):
    """Commit-mode waiters blocked behind a held store write: drain()
    returns only once every waiter is settled, and nobody hangs."""
    buf, rec, storage, app_id = _buffer(tmp_path, IngestConfig())
    key = _Key(app_id)
    rec.gate.clear()
    ts, out, errs = _in_threads(
        lambda j: buf.ingest_raw(_raw(j), key, None), 6)
    while buf.snapshot()["pending"] < 6:
        time.sleep(0.002)
    drained = []
    d = threading.Thread(target=lambda: drained.append(buf.drain(30)))
    d.start()
    d.join(0.3)
    assert d.is_alive(), "drain returned with waiters in flight"
    rec.gate.set()
    d.join(30)
    for t in ts:
        t.join(30)
    assert drained == [True] and not errs
    assert all(not t.is_alive() for t in ts)
    assert len(set(out)) == 6
    storage.close()


def test_mid_group_commit_failure_aborts_and_defers(tmp_path, monkeypatch):
    """A group holding two enqueue-acked events and two commit-mode
    requests fails at ``ingest.commit``: the commit-mode clients get the
    error and an abort marker covers their frame (replay must not
    resurrect what they will retry), the enqueue-acked events stay
    uncommitted in the WAL (deferred, not dropped) and the next recovery
    lands them exactly once."""
    wal_dir = tmp_path / "wal"
    wal = ingest_wal.IngestWal(ingest_wal.WalConfig(enabled=True,
                                                    dir=str(wal_dir)))
    buf, rec, storage, app_id = _buffer(tmp_path, IngestConfig(), wal=wal)
    key = _Key(app_id)
    rec.gate.clear()
    blocker = threading.Thread(target=buf.ingest_raw,
                               args=(_raw(0), key, None))
    blocker.start()
    assert rec.entered.wait(30)  # its group is cut and held
    acked = [buf.enqueue_event(Event.from_json(_ev(j)), _ev(j), key, None)
             for j in (1, 2)]
    ts, out, errs = _in_threads(
        lambda j: buf.ingest_raw(_raw(3 + j), key, None), 2)
    while buf.snapshot()["pending"] < 5:
        time.sleep(0.002)
    monkeypatch.setenv("PIO_FAULT_SPEC", "ingest.commit:fail:1")
    faultinject.reset()
    # the blocker's group already passed its fault point: it commits
    rec.gate.set()
    blocker.join(30)
    for t in ts:
        t.join(30)
    assert len(errs) == 2 and all(
        isinstance(e, faultinject.InjectedFault) for e in errs)
    snap = buf.snapshot()
    assert snap["deferredEvents"] == 2 and snap["droppedEvents"] == 0
    assert buf.drain(10)
    wal.close()
    monkeypatch.delenv("PIO_FAULT_SPEC")
    faultinject.reset()
    le = storage.get_l_events()
    assert [le.get(a, app_id) for a in acked] == [None, None]
    rows = ingest_wal.inspect(ingest_wal.WalConfig(enabled=True,
                                                   dir=str(wal_dir)))
    assert [(r["uncommittedEvents"], r["abortedRecords"]) for r in rows] \
        == [(2, 1)]
    summary = ingest_wal.recover(storage, ingest_wal.WalConfig(
        enabled=True, dir=str(wal_dir)))
    assert (summary["replayed"], summary["deduped"]) == (2, 0)
    ids = collections.Counter(e.event_id for e in le.find(app_id))
    assert all(ids[a] == 1 for a in acked) and sum(ids.values()) == 3
    names = sorted(e.entity_id for e in le.find(app_id))
    assert names == ["u0", "u1", "u2"]
    storage.close()


def test_group_committed_flood_equals_reference(tmp_path, monkeypatch):
    """16 concurrent single-event POSTs (with a bad one and a forbidden
    one) through each package's buffer: the same statuses and the same
    stored events."""
    monkeypatch.setenv("PIO_ACCESSKEY_CACHE_SECS", "0")
    bodies = [_ev(j) for j in range(16)]
    bodies[5] = {"event": "view"}
    results = {}
    for name in ("port", "ref"):
        pkg = port_pkg if name == "port" else ref_storage
        storage, app_id = _store(pkg, tmp_path, name)
        storage.get_meta_data_access_keys().insert(
            pkg.AccessKey("limited", app_id, ("buy",)))

        def flood(base):
            ts, out, errs = _in_threads(lambda j: requests.post(
                f"{base}/events.json?accessKey="
                f"{'limited' if j == 9 else KEY}",
                json=bodies[j], timeout=30), 16)
            for t in ts:
                t.join(60)
            return [r.status_code for r in out]

        if name == "port":
            server = EventServer(storage, "127.0.0.1", 0)
            host, port = server.start()
            try:
                statuses = flood(f"http://{host}:{port}")
            finally:
                server.stop()
        else:
            with ServerThread(RefEventServer(storage).app) as st:
                statuses = flood(st.base)
        stored = sorted((e.entity_id, e.target_entity_id, e.event)
                        for e in storage.get_l_events().find(app_id))
        results[name] = (statuses, stored)
        storage.close()
    assert results["port"] == results["ref"]
    assert results["port"][0].count(201) == 14


def test_stress_mixed_acks_lose_no_update(tmp_path):
    """32 threads (more than this host's cores) interleave commit- and
    enqueue-mode submissions with the WAL on and a tiny switch interval:
    every id lands once, the pending count returns to 0 and the committed
    count equals the submissions (a lost update would break either)."""
    wal = ingest_wal.IngestWal(ingest_wal.WalConfig(
        enabled=True, dir=str(tmp_path / "wal"), fsync="off"))
    buf, rec, storage, app_id = _buffer(tmp_path, IngestConfig(
        group_max=16), wal=wal)
    key = _Key(app_id)

    def client(j):
        ids = []
        for n in range(25):
            if (j + n) % 2:
                ids.append(buf.ingest_raw(_raw(j * 100 + n), key, None))
            else:
                ev = _ev(j * 100 + n)
                ids.append(buf.enqueue_event(Event.from_json(ev), ev, key,
                                             None))
        return ids

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts, out, errs = _in_threads(client, 32)
        for t in ts:
            t.join(120)
        assert all(not t.is_alive() for t in ts) and not errs, errs
        assert buf.drain(60)
    finally:
        sys.setswitchinterval(old)
    wal.close()
    snap = buf.snapshot()
    assert snap["pending"] == 0 and snap["eventsCommitted"] == 800
    assert snap["wal"]["pendingRecords"] == 0
    ids = collections.Counter(e.event_id for e in storage.get_l_events()
                              .find(app_id, limit=None))
    assert sorted(ids) == sorted(x for ids in out for x in ids)
    assert max(ids.values()) == 1 and sum(rec.writes) == 800
    storage.close()


# ---------------------------------------------------------------------------
# a real server process: PIO_WAL=1, ack=enqueue, crash mid-flood
# ---------------------------------------------------------------------------

def _serve(env, port):
    return subprocess.Popen(
        CONSOLE + ["eventserver", "--ip", "127.0.0.1", "--port", str(port)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait_up(proc, base, deadline):
    while True:
        assert proc.poll() is None, proc.stdout.read()[-3000:]
        assert time.monotonic() < deadline, "event server not up"
        try:
            if requests.get(base + "/", timeout=5).status_code == 200:
                return
        except requests.RequestException:
            pass
        time.sleep(0.05)


def _enqueue_flood(base, tag, acked, lock):
    import http.client

    host, port = base.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        for n in range(400):
            conn.request("POST", f"/events.json?accessKey={KEY}",
                         body=json.dumps(_ev(n, entityId=f"{tag}-{n}")),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            doc = json.loads(resp.read())
            assert resp.status == 201, (resp.status, doc)
            with lock:
                acked.append(doc["eventId"])
    except (OSError, http.client.HTTPException, ValueError):
        return  # the server died between two requests
    finally:
        conn.close()


def test_crashed_server_restarts_with_every_ack_exactly_once(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_STORAGE_", "PIO_EVENT", "PIO_FAULT",
                                "PIO_WAL", "PIO_INGEST"))}
    env.update(_env(tmp_path, "crash"))
    env.update({"PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
                "PIO_FS_BASEDIR": str(tmp_path / "base"),
                "PIO_WAL": "1", "PIO_WAL_DIR": str(tmp_path / "wal"),
                "PIO_WAL_FSYNC": "group", "PIO_INGEST_ACK": "enqueue"})
    storage, app_id = _store(port_pkg, tmp_path, "crash")
    storage.close()
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 120
    proc = _serve(env | {"PIO_FAULT_SPEC": "ingest.commit:crash:40"}, port)
    acked, lock = [], threading.Lock()
    try:
        _wait_up(proc, base, deadline)
        clients = [threading.Thread(target=_enqueue_flood,
                                    args=(base, f"c{j}", acked, lock))
                   for j in range(6)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(60)
        assert proc.wait(30) != 0, "the server did not crash"
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    assert len(acked) > 40
    rows = ingest_wal.inspect(ingest_wal.WalConfig(
        enabled=True, dir=str(tmp_path / "wal")))
    assert rows and rows[0]["uncommittedEvents"] > 0, rows
    proc = _serve(env, port)
    try:
        _wait_up(proc, base, deadline)
        metrics = requests.get(base + "/metrics", timeout=30).text
        replayed = [float(line.split()[-1]) for line in metrics.splitlines()
                    if line.startswith("pio_wal_replayed_events_total")]
        assert replayed and replayed[0] > 0, replayed
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out[-3000:]
    assert ingest_wal.inspect(ingest_wal.WalConfig(
        enabled=True, dir=str(tmp_path / "wal"))) == []
    storage = Storage(_env(tmp_path, "crash"))
    ids = collections.Counter(
        e.event_id for e in storage.get_l_events().find(app_id, limit=None))
    storage.close()
    assert all(ids[a] == 1 for a in acked), "an acknowledged event is " \
        "missing or doubled"
    assert max(ids.values()) == 1
