"""The port's partitioned event log on the CPU (``data/api/event_log.py``
leases and ``run_partitioned_event_server``, ``data/storage/jsonl.py``'s
``.p<i>`` writes, ``data/api/event_server.py``'s fencing, ``pio eventserver
--workers`` / ``scale`` and ``pio eventlog fence``), held against the JAX
package's lease files, write paths and fenced-write answer:

- claim, a rival process refused (``PartitionHeldError``), force, verify
  and release;
- a lease written by one package is claimed by the other with epoch + 1;
- a stolen lease fences the old owner before any byte, with the
  reference server's status and body for the same scenario;
- the ``.p<i>`` write paths equal the reference's, and the merged read
  returns base + partitions;
- ``eventserver --workers 2``: the test waits until EVERY worker is ready
  on the front's ``/healthz`` (not just the first to answer), writes land
  in disjoint shards, the merged read returns every acknowledged event,
  SIGTERM drains with exit 0;
- ``drain`` returns only after an in-flight answer has left, and refuses
  a later request with a 503 before any byte; SIGTERM under load: every
  event in the log reached its client as a 201 and nothing landed twice;
- a SIGKILLed worker is reported ready only once its relaunch holds the
  lease;
- ``eventserver scale 3`` then ``scale 2``: the lease of partition 2 is
  parked on the front with a bumped epoch, and a further ``scale 3``
  hands it back;
- ``eventlog fence --partition i`` fences a live holder.

Every subprocess runs under its own time limit.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import requests

pytest.importorskip("torch")

from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.api import event_log as ref_log  # noqa: E402
from incubator_predictionio_tpu.data.api.event_server import (  # noqa: E402
    EventServer as RefEventServer,
)
from incubator_predictionio_tpu.data.storage import jsonl as ref_jsonl  # noqa: E402
from incubator_predictionio_torch.data import storage as port_pkg  # noqa: E402
from incubator_predictionio_torch.data.api import event_log  # noqa: E402
from incubator_predictionio_torch.data.api.event_server import EventServer  # noqa: E402
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.data.storage import jsonl as port_jsonl  # noqa: E402

from server_utils import ServerThread, free_port  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSOLE = [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]
KEY = "key-part"


def _ev(i: int) -> dict:
    return {"event": "rate", "entityType": "user", "entityId": f"u{i}",
            "targetEntityType": "item", "targetEntityId": f"i{i % 7}",
            "properties": {"rating": 4.0},
            "eventTime": "2024-01-01T00:00:00.000Z"}


def _env(tmp_path, name: str) -> dict:
    return {
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / f"{name}.sqlite"),
        "PIO_STORAGE_SOURCES_EV_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_EV_PATH": str(tmp_path / f"{name}-events"),
    }


def _seed(pkg, storage) -> int:
    app_id = storage.get_meta_data_apps().insert(pkg.App(0, "partapp"))
    storage.get_meta_data_access_keys().insert(pkg.AccessKey(KEY, app_id, ()))
    return app_id


# ---------------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------------

def test_claim_held_force_verify_release(tmp_path):
    """A rival PROCESS cannot claim a held partition; force bumps the
    epoch past the flock and fences the holder; a released lease fences
    itself."""
    d = str(tmp_path)
    lease = event_log.claim_partition(d, 0)
    assert (lease.partition, lease.epoch, lease.forced) == (0, 1, False)
    lease.verify()
    marker = tmp_path / "rival_wrote"
    code = (
        "import sys\n"
        "from incubator_predictionio_torch.data.api import event_log\n"
        "try:\n"
        f"    event_log.claim_partition({d!r}, 0)\n"
        "except event_log.PartitionHeldError:\n"
        "    sys.exit(42)\n"
        f"open({str(marker)!r}, 'w').write('claimed')\n")
    rc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                        capture_output=True, timeout=60).returncode
    assert rc == 42 and not marker.exists()
    lease.verify()  # still ours
    info = event_log.lease_info(d, 0)
    assert info["held"] and info["epoch"] == 1 and info["pid"] == os.getpid()
    rival = event_log.claim_partition(d, 0, force=True)
    assert rival.forced and rival.epoch == 2
    with pytest.raises(event_log.PartitionFencedError, match="fenced"):
        lease.verify()
    assert isinstance(event_log.PartitionFencedError("x"),
                      event_log.IngestOverloadError)
    rival.verify()
    assert rival.to_json() == {"partition": 0, "epoch": 2, "forced": True}
    rival.release()
    with pytest.raises(event_log.PartitionFencedError, match="unreadable"):
        rival.verify()
    lease.release()
    again = event_log.claim_partition(d, 0)  # no holder left: a plain claim
    assert again.epoch == 3 and not again.forced
    again.release()


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_leases_cross_packages(tmp_path, first, second):
    """One lease file, two packages: each claims what the other wrote with
    epoch + 1, and a lease held by one is refused to the other."""
    mods = {"ref": ref_log, "port": event_log}
    d = str(tmp_path)
    a = mods[first].claim_partition(d, 2)
    with pytest.raises(mods[second].PartitionHeldError):
        mods[second].claim_partition(d, 2)
    a.release()
    b = mods[second].claim_partition(d, 2)
    assert b.epoch == a.epoch + 1
    assert (mods[first].lease_info(d, 2)["epoch"]
            == mods[second].lease_info(d, 2)["epoch"] == b.epoch)
    forced = mods[first].claim_partition(d, 2, force=True)
    assert forced.epoch == b.epoch + 1 and forced.forced
    with pytest.raises(mods[second].PartitionFencedError):
        b.verify()
    forced.release()
    b.release()


# ---------------------------------------------------------------------------
# the .p<i> write path
# ---------------------------------------------------------------------------

def test_partition_write_paths_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_EVENT_PARTITION", "3")
    port = port_jsonl.JSONLEvents(str(tmp_path / "port"))
    ref = ref_jsonl.JSONLEvents(str(tmp_path / "ref"))
    for chan in (None, 5):
        assert (os.path.basename(port._path(1, chan))
                == os.path.basename(ref._path(1, chan)))
    assert os.path.basename(port._path(1, None)) == "events_1.p3.jsonl"
    assert os.path.basename(port._path(1, 5)) == "events_1_5.p3.jsonl"
    # one directory written by both: the base log by a plain process, the
    # partition by the port's worker, a second partition by the reference
    shared = str(tmp_path / "shared")
    monkeypatch.delenv("PIO_EVENT_PARTITION")
    plain = port_jsonl.JSONLEvents(shared)
    e = [port_pkg.Event.from_json(_ev(i)) for i in range(6)]
    plain.insert_batch(e[:2], 1)
    monkeypatch.setenv("PIO_EVENT_PARTITION", "0")
    port_jsonl.JSONLEvents(shared).insert_batch(e[2:4], 1)
    monkeypatch.setenv("PIO_EVENT_PARTITION", "1")
    ref_jsonl.JSONLEvents(shared).insert_batch(
        [ref_storage.Event.from_json(_ev(i)) for i in (4, 5)], 1)
    monkeypatch.delenv("PIO_EVENT_PARTITION")
    assert sorted(n for n in os.listdir(shared) if n.endswith(".jsonl")) == [
        "events_1.jsonl", "events_1.p0.jsonl", "events_1.p1.jsonl"]
    reader = port_jsonl.JSONLEvents(shared)
    got = [x.entity_id for x in reader.find(1)]
    want = [x.entity_id for x in ref_jsonl.JSONLEvents(shared).find(1)]
    assert got == want and sorted(got) == [f"u{i}" for i in range(6)]


# ---------------------------------------------------------------------------
# fencing through a live server
# ---------------------------------------------------------------------------

def _post_fenced_scenario(base: str, log_dir: str, mods) -> dict:
    """One write acknowledged, the lease stolen, then a single write and a
    batch that must be refused before any byte, then a delete (the
    reference lands its tombstone; the port refuses it too)."""
    log_path = os.path.join(log_dir, "events_1.p0.jsonl")
    r = requests.post(f"{base}/events.json?accessKey={KEY}", json=_ev(1),
                      timeout=30)
    assert r.status_code == 201, r.text
    first = r.json()["eventId"]
    size = os.path.getsize(log_path)
    rival = mods.claim_partition(log_dir, 0, force=True)
    out = {}
    try:
        for name, call in (
                ("single", lambda: requests.post(
                    f"{base}/events.json?accessKey={KEY}", json=_ev(2),
                    timeout=30)),
                ("batch", lambda: requests.post(
                    f"{base}/batch/events.json?accessKey={KEY}",
                    json=[_ev(3), _ev(4)], timeout=30))):
            r = call()
            out[name] = (r.status_code, r.json(),
                         int(r.headers.get("Retry-After", "0")))
        assert os.path.getsize(log_path) == size, "a fenced worker wrote"
        r = requests.delete(f"{base}/events/{first}.json?accessKey={KEY}",
                            timeout=30)
        out["delete"] = (r.status_code, r.json(),
                         int(r.headers.get("Retry-After", "0")))
        out["delete_wrote"] = os.path.getsize(log_path) - size
        out["root"] = requests.get(f"{base}/", timeout=30).json()
    finally:
        rival.release()
    return out


def test_stolen_lease_fences_old_owner_before_any_byte(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_EVENT_PARTITION", "0")
    monkeypatch.setenv("PIO_ACCESSKEY_CACHE_SECS", "0")
    port_store = Storage(_env(tmp_path, "port"))
    _seed(port_pkg, port_store)
    server = EventServer(port_store, "127.0.0.1", 0)
    assert server.lease is not None and server.lease.partition == 0
    host, port = server.start()
    try:
        got = _post_fenced_scenario(f"http://{host}:{port}",
                                    port_store.get_l_events().events_dir,
                                    event_log)
    finally:
        server.stop()
    # the lease is released when the server stops
    assert not event_log.lease_info(
        port_store.get_l_events().events_dir, 0)["held"]
    ref = ref_storage.Storage(_env(tmp_path, "ref"))
    _seed(ref_storage, ref)
    with ServerThread(RefEventServer(ref).app) as st:
        want = _post_fenced_scenario(st.base, ref.get_l_events()._dir,
                                     ref_log)
    for name in ("single", "batch"):
        assert got[name][:2] == want[name][:2], name
        assert got[name][0] == 503 and got[name][2] >= 1
    # a tombstone is a write: the port refuses it as well (the reference's
    # delete skips the lease and lands its tombstone)
    assert got["delete"][0] == 503 and got["delete"][2] >= 1
    assert got["delete_wrote"] == 0 and want["delete_wrote"] > 0
    assert got["root"]["partition"] == want["root"]["partition"] == 0
    assert got["root"]["shedRequests"] == 3
    assert want["root"]["shedRequests"] == 2
    names = [e.entity_id for e in port_store.get_l_events().find(1)]
    assert names == ["u1"]
    port_store.close()
    ref.close()


# ---------------------------------------------------------------------------
# the multi-worker event server
# ---------------------------------------------------------------------------

def _front_env(tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_STORAGE_", "PIO_EVENT_", "PIO_FAULT"))}
    env.update(_env(tmp_path, "mw"))
    env.update({"PIO_FS_BASEDIR": str(tmp_path / "base"),
                "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
                "PIO_SUPERVISOR_POLL_MS": "50",
                "PIO_ACCESSKEY_CACHE_SECS": "0"})
    os.makedirs(env["PIO_FS_BASEDIR"], exist_ok=True)
    store = Storage({k: v for k, v in env.items()
                     if k.startswith("PIO_STORAGE_")})
    _seed(port_pkg, store)
    store.close()
    return env


class _Front:
    """``pio eventserver --workers N`` in its own process (SIGKILLed at
    the end if it is still up)."""

    def __init__(self, env: dict, workers: int, deadline_s: float):
        self.env = env
        self.port = free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.deadline = time.monotonic() + deadline_s
        self.proc = subprocess.Popen(
            CONSOLE + ["eventserver", "--workers", str(workers), "--ip",
                       "127.0.0.1", "--port", str(self.port)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)

    def healthz(self) -> dict:
        return requests.get(f"{self.base}/healthz", timeout=5).json()

    def wait(self, what: str, pred) -> dict:
        """Poll the front's /healthz until ``pred`` holds."""
        last = None
        while time.monotonic() < self.deadline:
            if self.proc.poll() is not None:
                raise AssertionError(f"front died ({self.proc.returncode}):"
                                     f" {self.proc.stdout.read()[-3000:]}")
            try:
                last = self.healthz()
                if pred(last):
                    return last
            except (requests.RequestException, ValueError):
                pass
            time.sleep(0.1)
        raise AssertionError(f"front: {what} not reached; last {last}")

    def all_ready(self, n: int) -> dict:
        # EVERY worker ready, not just the first one to answer
        return self.wait(f"{n} ready workers", lambda h: (
            h["readyWorkers"] == n and len(h["workers"]) == n
            and all(b["ready"] and b["pid"] for b in h["backends"])))

    def verb(self, *args) -> subprocess.CompletedProcess:
        out = subprocess.run(CONSOLE + list(args), env=self.env, cwd=ROOT,
                             capture_output=True, text=True,
                             timeout=max(5.0, self.deadline
                                         - time.monotonic()))
        assert out.returncode == 0, out.stderr[-2000:]
        return out

    def stop(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        out, _ = self.proc.communicate(
            timeout=max(5.0, self.deadline - time.monotonic()))
        self.output = out.decode(errors="replace")
        return self.proc.returncode

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def test_two_workers_disjoint_shards_and_merged_reads(tmp_path):
    env = _front_env(tmp_path)
    front = _Front(env, 2, deadline_s=150)
    try:
        health = front.all_ready(2)
        assert sorted(b["worker"] for b in health["backends"]) == [0, 1]
        acked = []
        # a session pins one connection to one worker; the two sessions
        # are spliced to the two workers in turn
        for s in (requests.Session(), requests.Session()):
            for _ in range(10):
                r = s.post(f"{front.base}/events.json?accessKey={KEY}",
                           json=_ev(len(acked)), timeout=30)
                assert r.status_code == 201, r.text
                acked.append(r.json()["eventId"])
            r = s.post(f"{front.base}/batch/events.json?accessKey={KEY}",
                       json=[_ev(100 + j) for j in range(5)], timeout=30)
            assert [x["status"] for x in r.json()] == [201] * 5
            acked += [x["eventId"] for x in r.json()]
            s.close()
        r = requests.get(f"{front.base}/events.json?accessKey={KEY}"
                         "&limit=-1", timeout=30)
        assert sorted(e["eventId"] for e in r.json()) == sorted(acked)
        ev_dir = env["PIO_STORAGE_SOURCES_EV_PATH"] + "/pio_eventdata"
        shards = {n: os.path.getsize(os.path.join(ev_dir, n))
                  for n in os.listdir(ev_dir) if n.endswith(".jsonl")}
        assert shards.get("events_1.p0.jsonl", 0) > 0, shards
        assert shards.get("events_1.p1.jsonl", 0) > 0, shards
        for p in (0, 1):
            info = event_log.lease_info(ev_dir, p)
            assert info["held"] and info["pid"] in {
                b["pid"] for b in health["backends"]}, info
        status = front.verb("status").stdout
        assert f"Event-server front: pid {front.proc.pid}" in status
        assert "workers [0, 1]" in status
        assert front.stop() == 0, front.output[-2000:]
        assert not os.path.exists(os.path.join(env["PIO_FS_BASEDIR"],
                                               "eventserver_front.json"))
        for p in (0, 1):
            assert not event_log.lease_info(ev_dir, p)["held"]
    finally:
        front.kill()


def test_drain_waits_for_the_answer_then_refuses(tmp_path, monkeypatch):
    """``drain`` returns only after the answer of an in-flight write has
    left (its write is in the log, its 201 still held back here), and a
    request that comes after the accept loop stopped is refused with a
    503 before any byte."""
    import http.client
    import threading

    from incubator_predictionio_torch.data.api import event_server

    monkeypatch.setenv("PIO_EVENT_PARTITION", "0")
    monkeypatch.setenv("PIO_ACCESSKEY_CACHE_SECS", "0")
    store = Storage(_env(tmp_path, "drain"))
    app_id = _seed(port_pkg, store)
    entered, release = threading.Event(), threading.Event()
    plain_reply = event_server._Handler._reply

    def held_reply(self, status, obj, headers=()):
        if status == 201:
            entered.set()
            release.wait(30)
        plain_reply(self, status, obj, headers)

    monkeypatch.setattr(event_server._Handler, "_reply", held_reply)
    server = EventServer(store, "127.0.0.1", 0)
    host, port = server.start()
    conn = http.client.HTTPConnection(host, port, timeout=30)
    got = {}

    def post(name, i):
        conn.request("POST", f"/events.json?accessKey={KEY}",
                     body=json.dumps(_ev(i)).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        got[name] = (resp.status, json.loads(resp.read()))

    try:
        first = threading.Thread(target=post, args=("first", 1))
        first.start()
        assert entered.wait(30)
        server._httpd.shutdown()  # the accept loop stops, as on SIGTERM
        drained = []
        drainer = threading.Thread(
            target=lambda: drained.append(server.drain(timeout=30)))
        drainer.start()
        drainer.join(0.5)
        assert drainer.is_alive(), "drain returned before the answer left"
        release.set()
        first.join(30)
        drainer.join(30)
        assert drained == [True]
        assert got["first"][0] == 201
        post("late", 2)  # the same keep-alive connection
        assert got["late"][0] == 503, got["late"]
        assert "shutting down" in got["late"][1]["message"]
    finally:
        release.set()
        conn.close()
        server.close()
    logged = [e.event_id for e in store.get_l_events().find(app_id)]
    assert logged == [got["first"][1]["eventId"]]
    store.close()


def _flood(base: str, tag: str, batch: int, stop, acked: list) -> None:
    """One keep-alive client: POST until ``stop`` is set or the server
    refuses or goes away; every 201 it READ lands in ``acked`` as
    (eventId, entityId)."""
    import http.client

    host, port = base.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    n = 0
    try:
        while not stop.is_set():
            evs = [dict(_ev(0), entityId=f"{tag}-{n + j}")
                   for j in range(batch)]
            path = (f"/batch/events.json?accessKey={KEY}" if batch > 1
                    else f"/events.json?accessKey={KEY}")
            body = evs if batch > 1 else evs[0]
            conn.request("POST", path, body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            doc = json.loads(resp.read())
            if batch > 1 and resp.status == 200:
                for ev, item in zip(evs, doc, strict=True):
                    assert item["status"] == 201, item
                    acked.append((item["eventId"], ev["entityId"]))
            elif resp.status == 201:
                acked.append((doc["eventId"], evs[0]["entityId"]))
            else:
                assert resp.status == 503, (resp.status, doc)
                return
            n += batch
    except (OSError, http.client.HTTPException):
        return  # the server went away between two requests
    finally:
        conn.close()


def test_sigterm_under_load_answers_every_write(tmp_path):
    """SIGTERM while 8 clients write: every event in the log was
    acknowledged to its client (no answer lost in the drain), nothing
    landed twice, and every acknowledged event is in the log."""
    import threading

    env = _front_env(tmp_path) | {"PIO_EVENT_PARTITION": "0"}
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        CONSOLE + ["eventserver", "--ip", "127.0.0.1", "--port", str(port)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.stdout.read()[-3000:]
            assert time.monotonic() < deadline, "event server not up"
            try:
                if requests.get(base + "/", timeout=5).json().get(
                        "partition") == 0:
                    break
            except (requests.RequestException, ValueError):
                pass
            time.sleep(0.1)
        stop = threading.Event()
        acked: list = []
        clients = [threading.Thread(target=_flood, args=(
            base, f"c{j}", 1 if j % 2 else 5, stop, acked))
            for j in range(8)]
        for c in clients:
            c.start()
        while len(acked) < 400 and time.monotonic() < deadline:
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        stop.set()
        for c in clients:
            c.join(30)
        assert proc.returncode == 0, out.decode(errors="replace")[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert len(acked) >= 400
    store = Storage({k: v for k, v in env.items()
                     if k.startswith("PIO_STORAGE_")})
    app_id = store.get_meta_data_apps().get_by_name("partapp").id
    logged = [(e.event_id, e.entity_id)
              for e in store.get_l_events().find(app_id)]
    store.close()
    assert len({eid for _, eid in logged}) == len(logged)  # nothing twice
    assert sorted(logged) == sorted(acked)


def test_relaunched_worker_is_ready_only_after_its_claim(tmp_path):
    """SIGKILL worker 0: the front reports the relaunched worker (a new
    pid) ready only once that worker holds the lease, at epoch + 1 — never
    on its predecessor's last readiness probe."""
    env = _front_env(tmp_path)
    ev_dir = env["PIO_STORAGE_SOURCES_EV_PATH"] + "/pio_eventdata"
    front = _Front(env, 2, deadline_s=120)
    try:
        health = front.all_ready(2)
        pid0 = next(b["pid"] for b in health["backends"] if b["worker"] == 0)
        epoch0 = event_log.lease_info(ev_dir, 0)["epoch"]
        os.kill(pid0, signal.SIGKILL)
        while True:
            assert time.monotonic() < front.deadline, "not relaunched"
            try:
                b = next(b for b in front.healthz()["backends"]
                         if b["worker"] == 0)
            except (requests.RequestException, ValueError):
                continue
            if b["ready"] and b["pid"] not in (None, pid0):
                # the lease as it stands when the front calls it ready
                info = event_log.lease_info(ev_dir, 0)
                break
            time.sleep(0.01)
        assert info["held"] and info["pid"] == b["pid"], (info, b)
        assert info["epoch"] == epoch0 + 1
        assert front.stop() == 0, front.output[-2000:]
    finally:
        front.kill()


def test_scale_parks_and_hands_back_the_lease(tmp_path):
    env = _front_env(tmp_path)
    ev_dir = env["PIO_STORAGE_SOURCES_EV_PATH"] + "/pio_eventdata"
    front = _Front(env, 2, deadline_s=200)
    try:
        front.all_ready(2)
        out = front.verb("eventserver", "scale", "3").stdout
        assert "scale target 3 written" in out
        health = front.all_ready(3)
        pid2 = next(b["pid"] for b in health["backends"] if b["worker"] == 2)
        owned = event_log.lease_info(ev_dir, 2)
        assert owned["held"] and owned["pid"] == pid2
        front.verb("eventserver", "scale", "2")
        front.wait("partition 2 parked", lambda h: (
            h["parkedPartitions"] == [2] and h["workers"] == [0, 1]))
        parked = event_log.lease_info(ev_dir, 2)
        assert parked["held"] and parked["pid"] == front.proc.pid
        assert parked["epoch"] == owned["epoch"] + 1
        with open(os.path.join(env["PIO_FS_BASEDIR"],
                               "eventserver_front.json")) as f:
            assert json.load(f)["parkedPartitions"] == [2]
        # a write through the survivors still lands
        r = requests.post(f"{front.base}/events.json?accessKey={KEY}",
                          json=_ev(1), timeout=30)
        assert r.status_code == 201, r.text
        front.verb("eventserver", "scale", "3")
        health = front.all_ready(3)
        assert health["parkedPartitions"] == []
        back = event_log.lease_info(ev_dir, 2)
        pid2 = next(b["pid"] for b in health["backends"] if b["worker"] == 2)
        assert back["held"] and back["pid"] == pid2
        assert back["epoch"] == parked["epoch"] + 1
        assert front.stop() == 0, front.output[-2000:]
    finally:
        front.kill()


def test_wal_with_workers_is_refused(tmp_path):
    env = _front_env(tmp_path) | {"PIO_WAL": "1"}
    out = subprocess.run(CONSOLE + ["eventserver", "--workers", "2",
                                    "--port", str(free_port())],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode != 0 and "item 3.2" in out.stderr


def test_eventlog_fence_verb(tmp_path):
    env = _front_env(tmp_path)
    ev_dir = env["PIO_STORAGE_SOURCES_EV_PATH"] + "/pio_eventdata"
    held = event_log.claim_partition(ev_dir, 1)
    out = subprocess.run(CONSOLE + ["eventlog", "fence", "--partition", "1"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert (f"Partition 1 fenced: new epoch {held.epoch + 1} (FORCED"
            in out.stdout)
    with pytest.raises(event_log.PartitionFencedError):
        held.verify()
    held.release()
    out = subprocess.run(CONSOLE + ["eventlog", "fence", "--partition", "1"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0 and "FORCED" not in out.stdout
    assert event_log.lease_info(ev_dir, 1)["epoch"] == held.epoch + 2
