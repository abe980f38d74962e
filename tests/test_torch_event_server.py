"""The port's event server (``incubator_predictionio_torch/data/api/
event_server.py``) over HTTP on the CPU, held against the JAX package's
``EventServer`` on the same requests: the same statuses and the same JSON
bodies (event ids and server-assigned creation times aside), for
acknowledged writes read back by id and through ``find_ratings``, missing
and invalid keys (401), an event outside the key's allow-list (403),
invalid events and a batch of 51 (400), a mixed batch's per-event
statuses, channels, finds and DELETE. Every case runs on an SQLite store
and on a JSONL event log (metadata on SQLite), where a valid batch takes
the event codec's one-pass path in both servers.
"""

import base64
import json

import numpy as np
import pytest
import requests

pytest.importorskip("torch")

from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.api.event_server import (  # noqa: E402
    EventServer as RefEventServer,
)
from incubator_predictionio_torch.data.api.event_server import (  # noqa: E402
    MAX_BATCH_SIZE, EventServer,
)
from incubator_predictionio_torch.data import storage as port_pkg  # noqa: E402
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.data.store import PEventStore  # noqa: E402

from server_utils import ServerThread  # noqa: E402

KEY, LIMITED = "key-all", "key-views"


def _env(tmp_path, name, backend="sqlite"):
    env = {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
           for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path / f"{name}.sqlite")}
    if backend == "jsonl":
        env |= {"PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
                "PIO_STORAGE_SOURCES_LOG_TYPE": "JSONL",
                "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / f"{name}-events")}
    return env


def _seed(pkg, storage):
    app_id = storage.get_meta_data_apps().insert(pkg.App(0, "evapp"))
    keys = storage.get_meta_data_access_keys()
    keys.insert(pkg.AccessKey(KEY, app_id, ()))
    keys.insert(pkg.AccessKey(LIMITED, app_id, ("view",)))
    cid = storage.get_meta_data_channels().insert(
        pkg.Channel(0, "mobile", app_id))
    storage.get_l_events().init(app_id)
    storage.get_l_events().init(app_id, cid)
    return app_id


@pytest.fixture(params=["sqlite", "jsonl"])
def servers(request, tmp_path, monkeypatch):
    """(port base URL, port storage, reference base URL), each server on
    its own store (SQLite, or a JSONL log) seeded alike."""
    # the reference caches access-key verdicts; per-request lookups as here
    monkeypatch.setenv("PIO_ACCESSKEY_CACHE_SECS", "0")
    port_storage = Storage(_env(tmp_path, "port", request.param))
    _seed(port_pkg, port_storage)
    server = EventServer(port_storage, "127.0.0.1", 0)
    host, port = server.start()
    ref = ref_storage.Storage(_env(tmp_path, "ref", request.param))
    _seed(ref_storage, ref)
    with ServerThread(RefEventServer(ref).app) as st:
        yield f"http://{host}:{port}", port_storage, st.base
    server.stop()
    port_storage.close()
    ref.close()


def _rate(user, item, rating=4.0, second=0, **extra):
    return {"event": "rate", "entityType": "user", "entityId": user,
            "targetEntityType": "item", "targetEntityId": item,
            "properties": {"rating": rating},
            "eventTime": f"2024-01-01T00:00:{second:02d}.000Z", **extra}


def _normalized(body):
    """Event ids and creation times are the server's own: masked."""
    if isinstance(body, list):
        return [_normalized(x) for x in body]
    if isinstance(body, dict):
        return {k: ("<id>" if k == "eventId" else
                    "<now>" if k == "creationTime" else _normalized(v))
                for k, v in body.items()}
    return body


def _call(base, method, path, body=None, raw=None, headers=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body))
    r = requests.request(method, base + path, data=data, timeout=10,
                         headers={"Content-Type": "application/json",
                                  **(headers or {})})
    try:
        return r.status_code, r.json()
    except ValueError:
        return r.status_code, r.text


def _both(servers, method, path, body=None, raw=None, headers=None, ids=None):
    """The same request to both servers: (port answer, reference answer).
    ``{id}`` in the path takes each server's own id from ``ids``."""
    port, _, ref = servers
    out = []
    for base, key in ((port, "port"), (ref, "ref")):
        p = path.format(id=ids[key]) if ids else path
        out.append(_call(base, method, p, body, raw, headers))
    return out


def _same(servers, method, path, body=None, **kw):
    got, want = _both(servers, method, path, body, **kw)
    assert got[0] == want[0], (method, path, got, want)
    assert _normalized(got[1]) == _normalized(want[1]), (method, path, got, want)
    return got, want


def test_root_and_auth(servers):
    _same(servers, "GET", "/")
    for path in ("/events.json", "/events.json?accessKey=wrong"):
        (status, body), _ = _same(servers, "POST", path, _rate("u", "i"))
        assert status == 401 and "accessKey" in body["message"]
    _same(servers, "GET", "/events.json")
    _same(servers, "GET", "/events/x.json?accessKey=nope")
    _same(servers, "POST", "/batch/events.json", [_rate("u", "i")])
    basic = {"Authorization": "Basic " + base64.b64encode(
        f"{KEY}:".encode()).decode()}
    (status, _), _ = _same(servers, "POST", "/events.json", _rate("u", "i"),
                           headers=basic)
    assert status == 201


def test_create_read_back_and_delete(servers):
    port, storage, _ = servers
    body = _rate("u1", "i1", 5, second=1, tags=["t"], prId="p")
    got, want = _same(servers, "POST", f"/events.json?accessKey={KEY}", body)
    assert got[0] == 201 and len(got[1]["eventId"]) == 32
    ids = {"port": got[1]["eventId"], "ref": want[1]["eventId"]}
    # committed before the 201: the store already holds it
    assert storage.get_l_events().get(ids["port"], 1) is not None
    (status, event), _ = _same(servers, "GET",
                               f"/events/{{id}}.json?accessKey={KEY}", ids=ids)
    assert status == 200 and event["properties"] == {"rating": 5}
    assert event["eventId"] == ids["port"]
    # a client-sent creationTime is ignored, a client eventId honoured
    _same(servers, "POST", f"/events.json?accessKey={KEY}",
          _rate("u2", "i2", 3, second=2, eventId="client-id-1",
                creationTime="2000-01-01T00:00:00.000Z"))
    (_, event), _ = _same(servers, "GET",
                          f"/events/client-id-1.json?accessKey={KEY}")
    assert event["eventId"] == "client-id-1"
    assert event["creationTime"] != "2000-01-01T00:00:00.000Z"
    u, i, r, users, items = PEventStore.find_ratings(
        "evapp", event_names=["rate"], storage=storage)
    assert list(users.keys()) == ["u1", "u2"] and r.tolist() == [5.0, 3.0]
    _same(servers, "DELETE", f"/events/{{id}}.json?accessKey={KEY}", ids=ids)
    _same(servers, "GET", f"/events/{{id}}.json?accessKey={KEY}", ids=ids)
    (status, _), _ = _same(servers, "DELETE",
                           f"/events/{{id}}.json?accessKey={KEY}", ids=ids)
    assert status == 404


@pytest.mark.parametrize("body", [
    {"event": "$unset", "entityType": "u", "entityId": "1"},
    {"event": "", "entityType": "u", "entityId": "1"},
    {"event": "rate", "entityType": "pio_user", "entityId": "1"},
    {"event": "rate", "entityType": "user", "entityId": "1",
     "targetEntityType": "item"},
    {"event": "rate", "entityType": "user"},
    {"event": "rate", "entityType": "user", "entityId": "1",
     "eventTime": "yesterday"},
    [1, 2],
    "text",
], ids=["unset-no-props", "empty-name", "reserved-prefix", "half-target",
        "no-entity-id", "bad-time", "array", "string"])
def test_invalid_events_are_400(servers, body):
    (status, answer), _ = _same(servers, "POST",
                                f"/events.json?accessKey={KEY}", body)
    assert status == 400 and answer["message"]


def test_invalid_json_is_400(servers):
    (status, _), _ = _same(servers, "POST", f"/events.json?accessKey={KEY}",
                           raw="{not json")
    assert status == 400
    (status, _), _ = _same(servers, "POST",
                           f"/batch/events.json?accessKey={KEY}",
                           raw="{not json")
    assert status == 400
    _same(servers, "POST", f"/batch/events.json?accessKey={KEY}",
          {"not": "a list"})


def test_allow_list_is_403_and_a_per_item_400_in_a_batch(servers):
    (status, body), _ = _same(servers, "POST",
                              f"/events.json?accessKey={LIMITED}",
                              _rate("u", "i"))
    assert status == 403 and "not allowed" in body["message"]
    view = {"event": "view", "entityType": "user", "entityId": "u",
            "eventTime": "2024-01-01T00:00:00.000Z"}
    (status, _), _ = _same(servers, "POST",
                           f"/events.json?accessKey={LIMITED}", view)
    assert status == 201
    (status, body), _ = _same(servers, "POST",
                              f"/batch/events.json?accessKey={LIMITED}",
                              [view, _rate("u", "i")])
    assert [x["status"] for x in body] == [201, 400]


def test_batches(servers):
    port, storage, _ = servers
    batch = [_rate(f"u{j}", "i1", second=j) for j in range(3)] + [
        {"event": "", "entityType": "u", "entityId": "x"},
        _rate("u9", "i9", "abc", second=9),
        {"event": "$delete", "entityType": "item", "entityId": "i1",
         "properties": {"a": 1}},
    ]
    (status, body), _ = _same(servers, "POST",
                              f"/batch/events.json?accessKey={KEY}", batch)
    assert status == 200
    assert [x["status"] for x in body] == [201, 201, 201, 400, 201, 400]
    committed = [x["eventId"] for x in body if x["status"] == 201]
    assert all(storage.get_l_events().get(eid, 1) for eid in committed)
    full = [_rate(f"f{j}", "i", second=j % 60) for j in range(MAX_BATCH_SIZE)]
    (status, body), _ = _same(servers, "POST",
                              f"/batch/events.json?accessKey={KEY}", full)
    assert status == 200 and {x["status"] for x in body} == {201}
    (status, body), _ = _same(servers, "POST",
                              f"/batch/events.json?accessKey={KEY}",
                              full + [_rate("one", "more")])
    assert status == 400 and "less than or equal to 50" in body["message"]
    _same(servers, "POST", f"/batch/events.json?accessKey={KEY}", [])
    u, _, _, users, _ = PEventStore.find_ratings("evapp", storage=storage)
    assert len(u) == 4 + MAX_BATCH_SIZE and "one" not in users


def test_channels_and_find(servers):
    for j, ch in enumerate(["", "&channel=mobile", "", "&channel=mobile", ""]):
        _same(servers, "POST", f"/events.json?accessKey={KEY}{ch}",
              _rate(f"u{j}", f"i{j % 2}", j, second=j))
    (status, body), _ = _same(servers, "POST",
                              f"/events.json?accessKey={KEY}&channel=ghost",
                              _rate("u", "i"))
    assert status == 400 and "channel" in body["message"]
    for query in ("", "&channel=mobile", "&event=rate", "&event=buy",
                  "&entityId=u2", "&targetEntityId=i1", "&limit=2",
                  "&reversed=true&entityType=user&entityId=u0",
                  "&startTime=2024-01-01T00:00:01.000Z"
                  "&untilTime=2024-01-01T00:00:04.000Z",
                  "&limit=-1", "&limit=x", "&startTime=bad",
                  "&channel=ghost"):
        (status, body), _ = _same(servers, "GET",
                                  f"/events.json?accessKey={KEY}{query}")
        if status == 200:
            assert isinstance(body, list)
    (_, body), _ = _same(servers, "GET", f"/events.json?accessKey={KEY}")
    assert [e["entityId"] for e in body] == ["u0", "u2", "u4"]
    (_, body), _ = _same(servers, "GET",
                         f"/events.json?accessKey={KEY}&channel=mobile")
    assert [e["entityId"] for e in body] == ["u1", "u3"]


def test_keep_alive_connection_serves_many_requests(servers):
    """One connection, many POSTs: every acknowledged event is stored."""
    port, storage, _ = servers
    with requests.Session() as s:
        ids = [s.post(f"{port}/events.json?accessKey={KEY}",
                      json=_rate(f"k{j}", "i", second=j % 60),
                      timeout=10).json()["eventId"] for j in range(40)]
    assert len(set(ids)) == 40
    u, _, _, users, _ = PEventStore.find_ratings("evapp", storage=storage)
    assert len(u) == 40 and np.all(np.diff(u) >= 0)
