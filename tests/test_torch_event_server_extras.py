"""The port's event-server surface beyond the request path, held against
the JAX package's server on the same requests: webhooks (segmentio JSON,
mailchimp form, an unknown connector, a bad message type, a forbidden
event) store the reference's connectors' events for the reference's
fixtures; ``/stats.json`` under ``--stats`` equals the reference's for the
same POSTs (and 404 without it); the access-key cache serves a revoked key
only within its TTL and keeps its bound; ``GET /metrics`` holds the ingest
families (and with ``--stats`` the per-app counts, with the WAL its
families); the telemetry renders like the reference's.
"""

import json
import time

import pytest
import requests

pytest.importorskip("torch")

from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.api.event_server import (  # noqa: E402
    EventServer as RefEventServer,
)
from incubator_predictionio_tpu.data.webhooks import (  # noqa: E402
    get_connector as ref_connector,
)
from incubator_predictionio_torch.data import storage as port_pkg  # noqa: E402
from incubator_predictionio_torch.data.api import event_server  # noqa: E402
from incubator_predictionio_torch.data.api.event_server import (  # noqa: E402
    EventServer,
)
from incubator_predictionio_torch.data.storage.event import (  # noqa: E402
    EventValidationError,
)
from incubator_predictionio_torch.data.webhooks import (  # noqa: E402
    get_connector,
)

from server_utils import ServerThread  # noqa: E402

KEY, LIMITED = "extras-key", "extras-limited"

SEGMENTIO = [
    {"type": "track", "userId": "u9", "event": "Signed Up",
     "properties": {"plan": "Pro"}, "timestamp": "2024-02-01T00:00:00.000Z"},
    {"type": "identify", "anonymousId": "a7", "traits": {"email": "x@y"},
     "context": {"ip": "1.2.3.4"}},
    {"type": "page", "userId": 42, "properties": {}},
    {"type": "alias", "userId": "u1", "timestamp": "2024-02-02T00:00:00Z"},
]
MAILCHIMP = [
    {"type": "subscribe", "fired_at": "2024-02-01 10:00:00",
     "data[id]": "8a25ff1d98", "data[email]": "api@mailchimp.com",
     "data[merges][FNAME]": "Ann", "data[merges][LNAME]": "Lee"},
    {"type": "upemail", "data[email]": "new@mailchimp.com",
     "data[old_email]": "old@mailchimp.com"},
    {"type": "campaign", "data[id]": "c1", "data[subject]": "Hi"},
]
BAD = [("segmentio", {"type": "bogus", "userId": "x"}),
       ("segmentio", {"type": "track"}),
       ("mailchimp", {"type": "nope", "data[id]": "1"}),
       ("mailchimp", {"type": "profile"}),
       ("mailchimp", {"type": "profile", "data[a]": "1", "data[a][b]": "2"})]


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
    app_id = storage.get_meta_data_apps().insert(pkg.App(0, "xapp"))
    keys = storage.get_meta_data_access_keys()
    keys.insert(pkg.AccessKey(KEY, app_id, ()))
    keys.insert(pkg.AccessKey(LIMITED, app_id, ("view", "subscribe")))
    storage.get_l_events().init(app_id)
    return storage, app_id


def _on_both(tmp_path, monkeypatch, scenario, stats=False):
    """Run ``scenario(base)`` against the port's and the reference's
    servers, each on its own fresh store: {name: (answer, storage,
    app_id)} (the storages left open for the caller)."""
    monkeypatch.setenv("PIO_ACCESSKEY_CACHE_SECS", "0")
    out = {}
    for name in ("port", "ref"):
        pkg = port_pkg if name == "port" else ref_storage
        storage, app_id = _store(pkg, tmp_path, name)
        if name == "port":
            server = EventServer(storage, "127.0.0.1", 0,
                                 enable_stats=stats)
            host, port = server.start()
            try:
                got = scenario(f"http://{host}:{port}")
            finally:
                server.stop()
        else:
            with ServerThread(RefEventServer(storage,
                                             enable_stats=stats).app) as st:
                got = scenario(st.base)
        out[name] = (got, storage, app_id)
    return out


def _stored(storage, app_id):
    """The stored events without their server-assigned fields (the id,
    the creation time, and the event time of a payload that had none)."""
    def masked(e):
        d = e.to_json()
        if abs(time.time() - e.event_time.timestamp()) < 3600:
            d["eventTime"] = "<now>"
        return {k: v for k, v in d.items()
                if k not in ("eventId", "creationTime")}

    return sorted(json.dumps(masked(e), sort_keys=True)
                  for e in storage.get_l_events().find(app_id))


# ---------------------------------------------------------------------------
# webhooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,payload",
                         [("segmentio", p) for p in SEGMENTIO]
                         + [("mailchimp", p) for p in MAILCHIMP] + BAD)
def test_connectors_equal_reference(name, payload):
    try:
        want = ref_connector(name).to_event_json(dict(payload))
    except Exception as e:  # noqa: BLE001 - the reference's verdict
        with pytest.raises(EventValidationError) as got:
            get_connector(name).to_event_json(dict(payload))
        assert str(got.value) == str(e)
        return
    assert get_connector(name).to_event_json(dict(payload)) == want


def _webhook_scenario(base):
    out = []
    for payload in SEGMENTIO:
        r = requests.post(f"{base}/webhooks/segmentio.json?accessKey={KEY}",
                          json=payload, timeout=30)
        out.append((r.status_code, sorted(r.json())))
    for payload in MAILCHIMP:
        r = requests.post(f"{base}/webhooks/mailchimp.json?accessKey={KEY}",
                          data=payload, timeout=30)
        out.append((r.status_code, sorted(r.json())))
    for name, payload in BAD:
        kw = {"json": payload} if name == "segmentio" else {"data": payload}
        r = requests.post(f"{base}/webhooks/{name}.json?accessKey={KEY}",
                          timeout=30, **kw)
        out.append((r.status_code, r.json()))
    r = requests.post(f"{base}/webhooks/nope.json?accessKey={KEY}", json={},
                      timeout=30)
    out.append((r.status_code, r.json()))
    r = requests.post(f"{base}/webhooks/segmentio.json?accessKey={LIMITED}",
                      json=SEGMENTIO[0], timeout=30)
    out.append((r.status_code, r.json()))
    r = requests.post(f"{base}/webhooks/segmentio.json?accessKey=nokey",
                      json=SEGMENTIO[0], timeout=30)
    out.append((r.status_code, r.json()))
    r = requests.post(f"{base}/webhooks/segmentio.json?accessKey={KEY}",
                      data=b"{not json", timeout=30,
                      headers={"Content-Type": "application/json"})
    out.append((r.status_code, r.json()))
    return out


def test_webhooks_store_the_reference_events(tmp_path, monkeypatch):
    got = _on_both(tmp_path, monkeypatch, _webhook_scenario)
    (port_answers, port_store, port_app) = got["port"]
    (ref_answers, ref_store, ref_app) = got["ref"]
    assert port_answers == ref_answers
    assert [s for s, _ in port_answers[:7]] == [201] * 7
    assert _stored(port_store, port_app) == _stored(ref_store, ref_app)
    assert len(_stored(port_store, port_app)) == 7
    port_store.close()
    ref_store.close()


def test_webhooks_under_enqueue_ack(tmp_path, monkeypatch):
    """With PIO_INGEST_ACK=enqueue a webhook is acknowledged once queued
    and lands after the drain."""
    monkeypatch.setenv("PIO_INGEST_ACK", "enqueue")
    monkeypatch.setenv("PIO_ACCESSKEY_CACHE_SECS", "0")
    storage, app_id = _store(port_pkg, tmp_path, "enq")
    server = EventServer(storage, "127.0.0.1", 0)
    host, port = server.start()
    try:
        r = requests.post(f"http://{host}:{port}/webhooks/segmentio.json"
                          f"?accessKey={KEY}", json=SEGMENTIO[0], timeout=30)
        assert r.status_code == 201
    finally:
        server.stop()
    assert storage.get_l_events().get(r.json()["eventId"], app_id) is not None
    storage.close()


# ---------------------------------------------------------------------------
# /stats.json
# ---------------------------------------------------------------------------

def _stats_scenario(base):
    ok = {"event": "rate", "entityType": "user", "entityId": "u1",
          "targetEntityType": "item", "targetEntityId": "i1",
          "properties": {"rating": 4.0}}
    for j in range(3):
        requests.post(f"{base}/events.json?accessKey={KEY}",
                      json=dict(ok, entityId=f"u{j}"), timeout=30)
    requests.post(f"{base}/events.json?accessKey={KEY}",
                  json={"event": "rate"}, timeout=30)
    requests.post(f"{base}/events.json?accessKey={LIMITED}",
                  json=ok, timeout=30)
    requests.post(f"{base}/events.json?accessKey={KEY}",
                  json=dict(ok, event="view"), headers={
                      "X-Pio-Ack": "enqueue"}, timeout=30)
    requests.post(f"{base}/events.json?accessKey={KEY}",
                  data=b"[1]", timeout=30)
    requests.post(f"{base}/batch/events.json?accessKey={KEY}",
                  json=[ok, {"event": "$bad"}, dict(ok, event="buy"), 7],
                  timeout=30)
    requests.post(f"{base}/batch/events.json?accessKey={LIMITED}",
                  json=[dict(ok, event="view"), ok], timeout=30)
    requests.post(f"{base}/webhooks/segmentio.json?accessKey={KEY}",
                  json=SEGMENTIO[0], timeout=30)
    time.sleep(0.3)  # the enqueue-acked event's group commit
    r = requests.get(f"{base}/stats.json?accessKey={KEY}", timeout=30)
    doc = r.json()
    doc.pop("uptime", None)
    return r.status_code, doc


def test_stats_json_equals_reference(tmp_path, monkeypatch):
    got = _on_both(tmp_path, monkeypatch, _stats_scenario, stats=True)
    assert got["port"][0] == got["ref"][0]
    status, doc = got["port"][0]
    assert status == 200 and sum(
        c["count"] for c in doc["counts"] if c["status"] == 201) == 8
    for _, storage, _ in got.values():
        storage.close()


def test_stats_json_needs_the_flag(tmp_path, monkeypatch):
    def scenario(base):
        r = requests.get(f"{base}/stats.json?accessKey={KEY}", timeout=30)
        return r.status_code, r.json()

    got = _on_both(tmp_path, monkeypatch, scenario)
    assert got["port"][0] == got["ref"][0]
    assert got["port"][0][0] == 404
    for _, storage, _ in got.values():
        storage.close()


# ---------------------------------------------------------------------------
# the access-key cache
# ---------------------------------------------------------------------------

def test_access_key_cache_ttl_and_bound(tmp_path, monkeypatch):
    """A revoked key is served within the TTL, refused past it; a bad key
    stays refused (a cached negative); the cache holds its bound."""
    monkeypatch.setenv("PIO_ACCESSKEY_CACHE_SECS", "0.5")
    storage, app_id = _store(port_pkg, tmp_path, "ttl")
    server = EventServer(storage, "127.0.0.1", 0)
    host, port = server.start()
    base = f"http://{host}:{port}"
    body = {"event": "view", "entityType": "user", "entityId": "u1"}
    try:
        url = f"{base}/events.json?accessKey={KEY}"
        assert requests.post(url, json=body, timeout=30).status_code == 201
        storage.get_meta_data_access_keys().delete(KEY)
        assert requests.post(url, json=body, timeout=30).status_code == 201
        time.sleep(0.6)
        assert requests.post(url, json=body, timeout=30).status_code == 401
        for _ in range(2):
            r = requests.post(f"{base}/events.json?accessKey=bogus",
                              json=body, timeout=30)
            assert r.status_code == 401
        # a key inserted after a negative lookup shows only past the TTL
        storage.get_meta_data_access_keys().insert(
            port_pkg.AccessKey("bogus", app_id, ()))
        r = requests.post(f"{base}/events.json?accessKey=bogus", json=body,
                          timeout=30)
        assert r.status_code == 401
        time.sleep(0.6)
        r = requests.post(f"{base}/events.json?accessKey=bogus", json=body,
                          timeout=30)
        assert r.status_code == 201
        # the bound: past KEY_CACHE_MAX the expired entries go, then the
        # oldest half of the fresh ones
        monkeypatch.setattr(event_server, "KEY_CACHE_MAX", 8)
        for j in range(20):
            server._lookup_key(f"k{j}")
        assert len(server._key_cache) <= 9
    finally:
        server.stop()
    storage.close()


# ---------------------------------------------------------------------------
# /metrics
# ---------------------------------------------------------------------------

def _families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_metrics_hold_the_ingest_families(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_WAL", "1")
    monkeypatch.setenv("PIO_WAL_DIR", str(tmp_path / "wal"))

    def scenario(base):
        for j in range(5):
            requests.post(f"{base}/events.json?accessKey={KEY}", json={
                "event": "view", "entityType": "user", "entityId": f"u{j}"},
                timeout=30)
        r = requests.get(f"{base}/metrics", timeout=30)
        return r.status_code, r.headers["Content-Type"], r.text

    got = _on_both(tmp_path, monkeypatch, scenario, stats=True)
    status, ctype, text = got["port"][0]
    assert status == 200 and ctype.startswith("text/plain")
    want = {"pio_ingest_commit_seconds", "pio_ingest_group_size",
            "pio_ingest_queue_wait_seconds", "pio_ingest_events_total",
            "pio_ingest_dropped_events_total", "pio_wal_records_total",
            "pio_wal_appended_bytes_total", "pio_wal_replayed_events_total",
            "pio_eventlog_compactions_total"}
    assert want <= _families(text)
    assert want <= _families(got["ref"][0][2])
    line = next(x for x in text.splitlines()
                if x.startswith("pio_ingest_events_total{"))
    assert 'event="view"' in line and 'status="201"' in line
    assert line.endswith(" 5")
    for _, storage, _ in got.values():
        storage.close()
