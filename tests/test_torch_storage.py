"""The port's storage layer (``incubator_predictionio_torch/data/storage``,
``data/store``, ``workflow/model_artifact.py``) on the CPU, held against
the JAX package's.

The reference's storage contract (``tests/test_storage_contract.py``) runs
as one parametrised test over the port's MEMORY, SQLITE and JSONL backends
and its network stores: HTTP (the port's ``pio storageserver`` over
SQLite), PGSQL (``tests/pg_mock.py``), MYSQL (``tests/mysql_mock.py``), and
the object and search stores on the reference's mocks: ELASTICSEARCH
(metadata and events), HBASE over REST and over the native RPC (a table
in two regions; events), S3 and HDFS (models; the models-only sources
keep metadata and events on SQLite, as the reference's contract does). Across
packages: one SQLite file is written by either package's ``Storage`` and
read by the other with equal rows; ``PEventStore.find_ratings`` gives the
identical triple and id maps from either package (tied event times,
``buy`` default ratings, unusable ratings); the model envelope is
byte-identical and ``describe`` / ``unwrap_verified`` give the same
verdicts on intact, truncated and bit-flipped blobs.
"""

import contextlib
import dataclasses
import datetime as dt
import json
import pickle

import numpy as np
import pytest

pytest.importorskip("torch")

from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.store.p_event_store import (  # noqa: E402
    PEventStore as RefPEventStore,
)
from incubator_predictionio_tpu.workflow import model_artifact as ref_artifact  # noqa: E402
from incubator_predictionio_torch.data import storage as port_storage  # noqa: E402
from incubator_predictionio_torch.data.events import (  # noqa: E402
    event_time_us, find_ratings as wire_find_ratings,
)
from incubator_predictionio_torch.data.storage import (  # noqa: E402
    AccessKey, App, Channel, DataMap, EngineInstance, EvaluationInstance,
    Event, EventValidationError, Model, Storage, StorageError,
)
from incubator_predictionio_torch.data.store import (  # noqa: E402
    LEventStore, PEventStore,
)
from incubator_predictionio_torch.workflow import model_artifact  # noqa: E402


def _env(kind, tmp_path, name="S"):
    if kind == "jsonl":  # metadata and models on SQLite, events on the log
        return _env("sqlite", tmp_path, name) | {
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
            "PIO_STORAGE_SOURCES_LOG_TYPE": "JSONL",
            "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "events")}
    if kind == "memory":
        return {
            f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": name
            for r in ("METADATA", "EVENTDATA", "MODELDATA")
        } | {f"PIO_STORAGE_SOURCES_{name}_TYPE": "MEMORY"}
    return {
        f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": name
        for r in ("METADATA", "EVENTDATA", "MODELDATA")
    } | {f"PIO_STORAGE_SOURCES_{name}_TYPE": "SQLITE",
         f"PIO_STORAGE_SOURCES_{name}_PATH": str(tmp_path / "pio.sqlite")}


def _net_env(name, stype, props):
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": name
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        f"PIO_STORAGE_SOURCES_{name}_TYPE": stype} | {
        f"PIO_STORAGE_SOURCES_{name}_{k}": v for k, v in props.items()}


#: the object and search stores: the repositories each serves
_OBJECT_REPOS = {"es": ("METADATA", "EVENTDATA"),
                 "hbase-rest": ("EVENTDATA",), "hbase-rpc": ("EVENTDATA",),
                 "s3": ("MODELDATA",), "hdfs": ("MODELDATA",)}


def object_store_env(kind, port, tmp_path) -> dict:
    """The ``PIO_STORAGE_*`` lines of an object or search store on
    ``port`` for the repositories it serves; SQLite for the rest."""
    props = {
        "es": {"TYPE": "ELASTICSEARCH", "HOSTS": "127.0.0.1",
               "PORTS": str(port)},
        "hbase-rest": {"TYPE": "HBASE", "HOSTS": "127.0.0.1",
                       "PORTS": str(port), "PROTOCOL": "rest"},
        "hbase-rpc": {"TYPE": "HBASE", "HOSTS": "127.0.0.1",
                      "PORTS": str(port), "PROTOCOL": "rpc"},
        "s3": {"TYPE": "S3", "ENDPOINT": f"http://127.0.0.1:{port}",
               "BUCKET": "pio-models", "ACCESS_KEY": "AKPIOTEST",
               "SECRET_KEY": "s3cr3t"},
        "hdfs": {"TYPE": "HDFS", "HOSTS": "127.0.0.1", "PORTS": str(port),
                 "PATH": "/pio/models"},
    }[kind]
    env = _env("sqlite", tmp_path, "DB")
    for repo in _OBJECT_REPOS[kind]:
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "OBJ"
    return env | {f"PIO_STORAGE_SOURCES_OBJ_{k}": v for k, v in props.items()}


@contextlib.contextmanager
def reference_mock(kind):
    """The reference's mock server of an object or search store."""
    if kind == "hbase-rpc":
        from hbase_rpc_mock import MockHBaseRpcServer

        # every event table in two regions: index rows | data rows
        with MockHBaseRpcServer(split_keys={
                f"pio_eventdata_{app}": [b"t:"] for app in range(1, 100)}
                ) as srv:
            yield srv
        return
    from server_utils import ServerThread

    if kind == "es":
        from es_mock import build_es_app as build
    elif kind == "hbase-rest":
        from hbase_mock import build_hbase_app as build
    elif kind == "hdfs":
        from hdfs_mock import build_hdfs_app as build
    else:
        from s3_mock import build_s3_app

        def build():
            return build_s3_app("AKPIOTEST", "s3cr3t")
    with ServerThread(build()) as srv:
        yield srv


@contextlib.contextmanager
def _store(kind, tmp_path):
    """A port ``Storage`` of ``kind``, with its server for a network one."""
    if kind in _OBJECT_REPOS:
        with reference_mock(kind) as srv:
            s = Storage(object_store_env(kind, srv.port, tmp_path))
            yield s
            s.close()
        return
    if kind == "http":
        from incubator_predictionio_torch.data.api.storage_server import (
            StorageServer,
        )

        backing = Storage(_env("sqlite", tmp_path, "B"))
        srv = StorageServer(backing, "127.0.0.1", 0)
        host, port = srv.start()
        try:
            s = Storage(_net_env("NET", "HTTP",
                                 {"HOSTS": host, "PORTS": str(port)}))
            yield s
            s.close()
        finally:
            srv.stop()
            backing.close()
        return
    if kind in ("pgsql", "mysql"):
        if kind == "pgsql":
            from pg_mock import MockPGServer as Mock
        else:
            from mysql_mock import MockMySQLServer as Mock
        with Mock(user="pio", password="piosecret") as srv:
            s = Storage(_net_env("DB", kind.upper(), {
                "HOST": "127.0.0.1", "PORT": str(srv.port),
                "USERNAME": "pio", "PASSWORD": "piosecret"}))
            yield s
            s.close()
        return
    s = Storage(_env(kind, tmp_path))
    yield s
    s.close()


def _ts(i):
    return dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc) + dt.timedelta(minutes=i)


# -- the reference's storage contract, one case per function ---------------


def _apps_crud(storage):
    apps = storage.get_meta_data_apps()
    app_id = apps.insert(App(0, "myapp", "desc"))
    assert app_id
    assert apps.get(app_id).name == "myapp"
    assert apps.get_by_name("myapp").id == app_id
    assert apps.insert(App(0, "myapp")) is None  # duplicate name
    apps.update(App(app_id, "myapp", "newdesc"))
    assert apps.get(app_id).description == "newdesc"
    assert len(apps.get_all()) == 1
    apps.delete(app_id)
    assert apps.get(app_id) is None


def _access_keys_crud(storage):
    keys = storage.get_meta_data_access_keys()
    k = keys.insert(AccessKey("", appid=3, events=("rate",)))
    assert k
    got = keys.get(k)
    assert got.appid == 3 and tuple(got.events) == ("rate",)
    assert keys.get_by_appid(3)[0].key == k
    assert keys.insert(AccessKey(k, appid=4)) is None  # duplicate key
    keys.delete(k)
    assert keys.get(k) is None


def _channels_crud(storage):
    channels = storage.get_meta_data_channels()
    cid = channels.insert(Channel(0, "ch1", appid=7))
    assert cid
    assert channels.insert(Channel(0, "bad name!", appid=7)) is None
    assert channels.get(cid).name == "ch1"
    assert [c.id for c in channels.get_by_appid(7)] == [cid]
    channels.delete(cid)
    assert channels.get(cid) is None


def _engine_instances(storage):
    dao = storage.get_meta_data_engine_instances()
    i1 = EngineInstance(
        id="", status="RUNNING", start_time=_ts(0), end_time=None,
        engine_id="e", engine_version="1", engine_variant="default",
        engine_factory="my.Factory",
    )
    iid = dao.insert(i1)
    assert dao.get(iid).status == "RUNNING"
    done = dao.get(iid).with_status("COMPLETED", _ts(1))
    dao.update(done)
    assert dao.get_latest_completed("e", "1", "default").id == iid
    # a later completed run wins
    iid2 = dao.insert(
        EngineInstance(
            id="", status="COMPLETED", start_time=_ts(5), end_time=_ts(6),
            engine_id="e", engine_version="1", engine_variant="default",
            engine_factory="my.Factory",
        )
    )
    assert dao.get_latest_completed("e", "1", "default").id == iid2
    assert [i.id for i in dao.get_completed("e", "1", "default")] == [iid2, iid]
    assert dao.get_completed("other", "1", "default") == []
    dao.delete(iid2)
    assert dao.get(iid2) is None


def _evaluation_instances(storage):
    dao = storage.get_meta_data_evaluation_instances()
    iid = dao.insert(
        EvaluationInstance(
            id="", status="EVALCOMPLETED", start_time=_ts(0), end_time=_ts(1),
            evaluation_class="my.Eval", engine_params_generator_class="my.Gen",
            evaluator_results="mse=0.5",
        )
    )
    assert dao.get(iid).evaluator_results == "mse=0.5"
    assert dao.get_completed()[0].id == iid


def _models_blob(storage):
    models = storage.get_model_data_models()
    models.insert(Model("m1", b"\x00\x01binary"))
    assert models.get("m1").models == b"\x00\x01binary"
    assert models.exists("m1") and not models.exists("m2")
    models.delete("m1")
    assert models.get("m1") is None


def _levents_crud_and_find(storage):
    le = storage.get_l_events()
    assert le.init(1)
    events = [
        Event("rate", "user", "u1", "item", "i1", DataMap({"rating": 3.0}), _ts(0)),
        Event("rate", "user", "u1", "item", "i2", DataMap({"rating": 5.0}), _ts(1)),
        Event("buy", "user", "u2", "item", "i1", DataMap(), _ts(2)),
    ]
    ids = [le.insert(e, 1) for e in events]
    assert len(set(ids)) == 3
    got = le.get(ids[0], 1)
    assert got.properties.require("rating") == 3.0
    assert got.event_id == ids[0]

    assert len(list(le.find(1))) == 3
    assert len(list(le.find(1, event_names=["rate"]))) == 2
    assert len(list(le.find(1, entity_id="u1"))) == 2
    assert len(list(le.find(1, target_entity_id="i1"))) == 2
    assert len(list(le.find(1, start_time=_ts(1)))) == 2
    assert len(list(le.find(1, until_time=_ts(1)))) == 1
    assert len(list(le.find(1, limit=2))) == 2
    rev = list(le.find(1, reversed_order=True))
    assert rev[0].event == "buy"

    assert le.delete(ids[2], 1)
    assert not le.delete(ids[2], 1)
    assert len(list(le.find(1))) == 2
    # channels are isolated
    le.init(1, 5)
    le.insert(events[0], 1, 5)
    assert len(list(le.find(1))) == 2
    assert len(list(le.find(1, channel_id=5))) == 1
    assert le.remove(1, 5)


def _levents_reinsert_after_delete(storage):
    le = storage.get_l_events()
    le.init(9)
    e = Event("rate", "user", "u1", "item", "i1", DataMap({"rating": 4.0}),
              _ts(0), event_id="re-1")
    le.insert(e, 9)
    assert le.delete("re-1", 9)
    assert le.get("re-1", 9) is None
    le.insert(e, 9)
    got = le.get("re-1", 9)
    assert got is not None and got.properties.require("rating") == 4.0
    assert len(list(le.find(9))) == 1


def _levents_delete_batch(storage):
    le = storage.get_l_events()
    le.init(10)
    ids = [le.insert(
        Event("view", "user", f"u{n}", "item", "i", DataMap(), _ts(n)), 10)
        for n in range(6)]
    out = le.delete_batch(ids[:4] + ["nope"], 10)
    assert out == [True] * 4 + [False]
    assert len(list(le.find(10))) == 2


def _levents_tie_order(storage):
    """Equal-timestamp events come back in insertion order, forward and
    under reversed_order (stable descending)."""
    le = storage.get_l_events()
    le.init(11)
    for n in range(4):
        le.insert(Event("e", "u", f"u{n}", None, None, DataMap(), _ts(0)), 11)
    le.insert(Event("e", "u", "early", None, None, DataMap(), _ts(-1)), 11)
    assert [e.entity_id for e in le.find(11)] == ["early", "u0", "u1", "u2", "u3"]
    order = [e.entity_id for e in le.find(11, reversed_order=True)]
    assert order == ["u0", "u1", "u2", "u3", "early"]


def _levents_upsert_moves_to_tie_end(storage):
    le = storage.get_l_events()
    le.init(12)
    le.insert(Event("e", "u", "a", None, None, DataMap({"v": 1}), _ts(0),
                    event_id="ua"), 12)
    le.insert(Event("e", "u", "b", None, None, DataMap(), _ts(0),
                    event_id="ub"), 12)
    le.insert(Event("e", "u", "a", None, None, DataMap({"v": 2}), _ts(0),
                    event_id="ua"), 12)  # upsert
    got = list(le.find(12))
    assert [e.entity_id for e in got] == ["b", "a"]
    assert got[1].properties.require("v") == 2
    assert len(got) == 2


def _aggregate_properties(storage):
    le = storage.get_l_events()
    le.init(2)
    le.insert(Event("$set", "item", "i1", properties=DataMap({"a": 1, "b": 2}), event_time=_ts(0)), 2)
    le.insert(Event("$set", "item", "i1", properties=DataMap({"b": 3, "c": 4}), event_time=_ts(1)), 2)
    le.insert(Event("$unset", "item", "i1", properties=DataMap({"a": 0}), event_time=_ts(2)), 2)
    le.insert(Event("$set", "item", "i2", properties=DataMap({"a": 9}), event_time=_ts(3)), 2)
    le.insert(Event("$delete", "item", "i3", event_time=_ts(4)), 2)
    le.insert(Event("$set", "item", "i3", properties=DataMap({"z": 1}), event_time=_ts(3)), 2)

    for props in (le.aggregate_properties(2, "item"),
                  storage.get_p_events().aggregate_properties(2, "item")):
        assert set(props) == {"i1", "i2"}  # i3 deleted after its $set
        assert props["i1"] == {"b": 3, "c": 4}
        assert props["i1"].first_updated == _ts(0)
        assert props["i1"].last_updated == _ts(2)
    assert set(le.aggregate_properties(2, "item", required=["c"])) == {"i1"}


def _pevents_write_and_find(storage):
    pe = storage.get_p_events()
    events = [
        Event("view", "user", f"u{i}", "item", f"i{i % 3}", DataMap(), _ts(i))
        for i in range(10)
    ]
    pe.write(events, 9)
    assert len(list(pe.find(9))) == 10
    assert len(list(pe.find(9, target_entity_id="i0"))) == 4
    pe.delete([e.event_id for e in pe.find(9, target_entity_id="i0")], 9)
    assert len(list(pe.find(9))) == 6


def _verify_all_data_objects(storage):
    assert storage.verify_all_data_objects() == []


def _insert_without_init_autocreates(storage):
    le = storage.get_l_events()
    eid = le.insert(Event("view", "user", "u1", event_time=_ts(0)), 42)
    assert le.get(eid, 42) is not None
    assert not le.delete("nonexistent", 4242)  # missing table → False


def _empty_event_names_matches_nothing(storage):
    le = storage.get_l_events()
    le.init(43)
    le.insert(Event("view", "user", "u1", event_time=_ts(0)), 43)
    assert list(le.find(43, event_names=[])) == []
    assert len(list(le.find(43, event_names=None))) == 1


def _event_stores_by_app_name(storage):
    """PEventStore / LEventStore resolve an app (and channel) by name."""
    app_id = storage.get_meta_data_apps().insert(App(0, "named"))
    cid = storage.get_meta_data_channels().insert(Channel(0, "side", app_id))
    le = storage.get_l_events()
    for n in range(3):
        le.insert(Event("view", "user", "u1", "item", f"i{n}",
                        event_time=_ts(n)), app_id)
    le.insert(Event("view", "user", "u1", "item", "side", event_time=_ts(9)),
              app_id, cid)
    assert [e.target_entity_id for e in PEventStore.find(
        "named", storage=storage)] == ["i0", "i1", "i2"]
    assert [e.target_entity_id for e in PEventStore.find(
        "named", channel_name="side", storage=storage)] == ["side"]
    latest = LEventStore.find_by_entity("named", "user", "u1", limit=2,
                                        storage=storage)
    assert [e.target_entity_id for e in latest] == ["i2", "i1"]
    with pytest.raises(ValueError, match="does not exist"):
        PEventStore.find("nope", storage=storage)
    with pytest.raises(ValueError, match="not found"):
        PEventStore.find("named", channel_name="nope", storage=storage)


CONTRACT = [
    _apps_crud, _access_keys_crud, _channels_crud, _engine_instances,
    _evaluation_instances, _models_blob, _levents_crud_and_find,
    _levents_reinsert_after_delete, _levents_delete_batch, _levents_tie_order,
    _levents_upsert_moves_to_tie_end, _aggregate_properties,
    _pevents_write_and_find, _verify_all_data_objects,
    _insert_without_init_autocreates, _empty_event_names_matches_nothing,
    _event_stores_by_app_name,
]


@pytest.mark.parametrize("case", CONTRACT, ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("backend", ["memory", "sqlite", "jsonl", "http",
                                     "pgsql", "mysql", "es", "hbase-rest",
                                     "hbase-rpc", "s3", "hdfs"])
def test_storage_contract(backend, case, tmp_path):
    with _store(backend, tmp_path) as storage:
        case(storage)


# -- registry --------------------------------------------------------------


def test_default_store_is_the_reference_sqlite_file(tmp_path, monkeypatch):
    """No PIO_STORAGE_* set: one SQLite file at $PIO_FS_BASEDIR/pio.sqlite
    (the basedir created on demand) for all three repositories — the
    reference's file."""
    base = tmp_path / "deep" / "base"
    monkeypatch.setenv("PIO_FS_BASEDIR", str(base))
    s = Storage({})
    s.get_meta_data_apps().insert(App(0, "a"))
    s.close()
    assert (base / "pio.sqlite").is_file()
    ref = ref_storage.Storage({})
    assert ref.get_meta_data_apps().get_by_name("a") is not None
    ref.close()
    assert [r for r in ("METADATA", "EVENTDATA", "MODELDATA")
            if Storage({}).repo_source_type(r) != "SQLITE"] == []


@pytest.mark.parametrize("stype", ["S3", "ELASTICSEARCH", "HBASE", "HDFS",
                                   "BOGUS"])
def test_unported_backend_raises(stype, tmp_path):
    """A source the registry cannot open raises StorageError naming it:
    an unknown type, or one of the object and search stores without the
    properties that locate it (they are served now; nothing falls back)."""
    env = _env("sqlite", tmp_path) | {"PIO_STORAGE_SOURCES_S_TYPE": stype}
    with pytest.raises(StorageError, match=f"source S \\({stype}\\) cannot "
                       "be opened" if stype != "BOGUS"
                       else "Unknown storage type"):
        Storage(env).get_l_events()
    assert Storage(env).verify_all_data_objects()  # reported, not raised


def test_namespace_isolation(tmp_path):
    def env(name):
        return {
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "S",
            "PIO_STORAGE_REPOSITORIES_METADATA_NAME": name,
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "S",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": name + "_ev",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S",
            "PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path / "shared.sqlite"),
        }

    s1, s2 = Storage(env("ns_a")), Storage(env("ns_b"))
    s1.get_meta_data_apps().insert(App(0, "only-in-a"))
    assert s2.get_meta_data_apps().get_by_name("only-in-a") is None
    s1.get_l_events().insert(Event("x", "u", "1", event_time=_ts(0)), 1)
    assert list(s2.get_l_events().find(1)) == []
    assert len(list(s1.get_l_events().find(1))) == 1
    s1.close()
    s2.close()


def test_localfs_models(tmp_path):
    env = _env("sqlite", tmp_path) | {
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
        "PIO_STORAGE_SOURCES_FS_TYPE": "LOCALFS",
        "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "models")}
    _models_blob(Storage(env))
    Storage(env).get_model_data_models().insert(Model("k", b"abc"))
    ref = ref_storage.Storage(env).get_model_data_models()
    assert ref.get("k").models == b"abc"


# -- events: the wire codec ------------------------------------------------


def test_event_json_round_trip_and_validation():
    e = Event.from_json(
        {"event": "x", "entityType": "u", "entityId": 1,
         "eventTime": "2024-01-01T00:00:00.000Z",
         "creationTime": "2024-01-01T00:00:01.000Z", "tags": ["t"],
         "prId": "p"})
    ref = ref_storage.Event.from_json(e.to_json())
    assert e.to_json() == ref.to_json()
    assert e.to_json()["creationTime"] == "2024-01-01T00:00:01.000Z"
    for bad in (
        {"event": 5, "entityType": "u", "entityId": "1"},
        {"event": "x", "entityType": ["u"], "entityId": "1"},
        {"event": "x", "entityType": "u", "entityId": "1", "eventTime": 12345},
        {"event": "x", "entityType": "u", "entityId": "1", "targetEntityType": 3,
         "targetEntityId": "4"},
        {"event": "$unset", "entityType": "u", "entityId": "1"},
        {"event": "$bogus", "entityType": "u", "entityId": "1"},
        {"event": "x", "entityType": "pio_u", "entityId": "1"},
        {"event": "x", "entityType": "u", "entityId": "1",
         "targetEntityType": "i"},
        {"entityType": "u", "entityId": "1"},
    ):
        with pytest.raises(EventValidationError) as port_err:
            Event.from_json(bad)
        with pytest.raises(ref_storage.EventValidationError) as ref_err:
            ref_storage.Event.from_json(bad)
        assert str(port_err.value) == str(ref_err.value)


#: wire times the event server and `pio import` see, with the epoch-µs the
#: file reader (``data/events.event_time_us``) and the store agree on
WIRE_TIMES = [
    "2024-01-01T00:00:00.000Z", "2024-01-01T00:00:00.5Z",
    "2024-01-01T00:00:00.123456Z", "2024-02-29T23:59:59.999Z",
    "2024-01-01T02:00:00.250+02:00", "2023-12-31T19:00:00-05:00",
    "2024-01-01T00:00:00", "1999-12-31T23:59:59.001Z",
    "2038-01-19T03:14:08.000Z", "2024-06-01T12:00:00.000001Z",
]


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_event_time_parsing_matches_the_file_reader(backend, tmp_path):
    """``Event.from_json`` (the store path) and the file reader's
    ``event_time_us`` give the same epoch-µs for every wire time, and the
    store hands the time back unchanged."""
    storage = Storage(_env(backend, tmp_path))
    le = storage.get_l_events()
    for j, t in enumerate(WIRE_TIMES):
        e = Event.from_json({"event": "v", "entityType": "u",
                             "entityId": str(j), "eventTime": t})
        ref = ref_storage.Event.from_json({"event": "v", "entityType": "u",
                                           "entityId": str(j), "eventTime": t})
        us = (e.event_time - dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)) \
            // dt.timedelta(microseconds=1)
        assert us == event_time_us(t), t
        assert e.event_time == ref.event_time, t
        le.insert(e, 1)
    back = {e.entity_id: e.event_time for e in le.find(1)}
    for j, t in enumerate(WIRE_TIMES):
        assert back[str(j)] == Event.from_json(
            {"event": "v", "entityType": "u", "entityId": "x",
             "eventTime": t}).event_time, t
    storage.close()


# -- one SQLite file, two packages -------------------------------------------


def _write_store(pkg, storage):
    """Apps, keys, channels, an engine instance, a model and events with
    tied times, through one package's DAOs; returns the app id."""
    apps = storage.get_meta_data_apps()
    app_id = apps.insert(pkg.App(0, "shared", "both packages"))
    storage.get_meta_data_access_keys().insert(
        pkg.AccessKey("key-1", app_id, ("rate", "buy")))
    cid = storage.get_meta_data_channels().insert(pkg.Channel(0, "side", app_id))
    storage.get_meta_data_engine_instances().insert(pkg.EngineInstance(
        id="ei-1", status="COMPLETED", start_time=_ts(0), end_time=_ts(1),
        engine_id="e", engine_version="1", engine_variant="default",
        engine_factory="f", env={"appName": "shared"},
        algorithms_params='[{"name": "als", "params": {"rank": 4}}]'))
    storage.get_meta_data_evaluation_instances().insert(pkg.EvaluationInstance(
        id="ev-1", status="EVALCOMPLETED", start_time=_ts(0), end_time=None,
        evaluation_class="c", engine_params_generator_class="g"))
    storage.get_model_data_models().insert(pkg.Model("ei-1", b"\x00blob\xff"))
    le = storage.get_l_events()
    le.init(app_id)
    le.insert_batch([pkg.Event.from_json(e) for e in _wire_events()], app_id)
    le.insert(pkg.Event("view", "user", "c1", "item", "x", event_time=_ts(3)),
              app_id, cid)
    return app_id, cid


def _wire_events():
    """Rates with tied times (insertion order must survive), times out of
    insertion order, buys without a rating, unusable and string ratings,
    a rate without a target and a name outside the selection."""
    rng = np.random.default_rng(3)
    evs = []
    for j in range(120):
        e = {"event": "rate", "entityType": "user",
             "entityId": f"u{int(rng.integers(15))}",
             "targetEntityType": "item",
             "targetEntityId": f"i{int(rng.integers(12))}",
             "properties": {"rating": float(rng.integers(1, 11)) / 2},
             # 8 distinct times over 120 events: long tie runs
             "eventTime": f"2024-01-01T00:00:0{int(rng.integers(8))}.000Z"}
        evs.append(e)
    evs += [
        {"event": "buy", "entityType": "user", "entityId": "buyer",
         "targetEntityType": "item", "targetEntityId": "i3",
         "eventTime": "2024-01-01T00:00:03.000Z"},
        {"event": "buy", "entityType": "user", "entityId": "u1",
         "targetEntityType": "item", "targetEntityId": "bought",
         "properties": {"rating": 2.0},
         "eventTime": "2024-01-01T00:00:01.000Z"},
        {"event": "rate", "entityType": "user", "entityId": "u2",
         "targetEntityType": "item", "targetEntityId": "i4",
         "properties": {"rating": "abc"}, "eventTime": "2024-01-01T00:00:05.000Z"},
        {"event": "rate", "entityType": "user", "entityId": "u6",
         "targetEntityType": "item", "targetEntityId": "i5",
         "properties": {"rating": "3.5"}, "eventTime": "2024-01-01T00:00:05.000Z"},
        {"event": "rate", "entityType": "user", "entityId": "u7",
         "targetEntityType": "item", "targetEntityId": "i6",
         "properties": {"rating": True}, "eventTime": "2024-01-01T00:00:02.000Z"},
        {"event": "rate", "entityType": "user", "entityId": "u8",
         "targetEntityType": "item", "targetEntityId": "i7",
         "properties": {"rating": "inf"}, "eventTime": "2024-01-01T00:00:02.000Z"},
        {"event": "rate", "entityType": "user", "entityId": "lonely",
         "properties": {"rating": 2.0}, "eventTime": "2024-01-01T00:00:00.000Z"},
        {"event": "view", "entityType": "user", "entityId": "viewer",
         "targetEntityType": "item", "targetEntityId": "iview",
         "eventTime": "2024-01-01T00:00:04.000Z"},
    ]
    return evs


def _rows(pkg, storage, app_id, cid):
    """Every row a store holds, as plain values."""
    def plain(obj):
        d = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj
        return json.loads(json.dumps(d, default=str))

    le = storage.get_l_events()
    return {
        "apps": [plain(a) for a in storage.get_meta_data_apps().get_all()],
        "keys": [plain(k) for k in storage.get_meta_data_access_keys().get_all()],
        "channels": [plain(c) for c in
                     storage.get_meta_data_channels().get_by_appid(app_id)],
        "instances": [plain(i) for i in
                      storage.get_meta_data_engine_instances().get_all()],
        "evaluations": [plain(i) for i in
                        storage.get_meta_data_evaluation_instances().get_all()],
        "model": storage.get_model_data_models().get("ei-1").models,
        "events": [e.to_json() for e in le.find(app_id)],
        "channel_events": [e.to_json() for e in le.find(app_id, cid)],
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sqlite_file_is_shared_by_both_packages(writer, tmp_path):
    """A store written by one package reads back with equal rows from the
    other, and from the writer itself."""
    env = _env("sqlite", tmp_path)
    pkgs = {"jax": ref_storage, "port": port_storage}
    reader = "port" if writer == "jax" else "jax"
    w = pkgs[writer].Storage(env)
    app_id, cid = _write_store(pkgs[writer], w)
    w.close()
    got = {}
    for name in (writer, reader):
        s = pkgs[name].Storage(env)
        got[name] = _rows(pkgs[name], s, app_id, cid)
        s.close()
    assert got[reader] == got[writer]
    assert len(got[reader]["events"]) == len(_wire_events())


def _triples(pkg_store, storage, **kw):
    return pkg_store.find_ratings("shared", storage=storage, **kw)


@pytest.mark.parametrize("kw", [
    dict(event_names=["rate", "buy"], event_default_ratings={"buy": 4.0}),
    dict(event_names=["rate"]),
    dict(event_names=None, rating_from_props=False, default_rating=2.5),
    dict(event_names=["view"], rating_from_props=False),
], ids=["rate+buy", "rate", "all-unrated", "view"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_find_ratings_identical_in_both_packages(writer, kw, tmp_path):
    """Same file, same triple: u, i, r and both id maps (first-seen order
    over a time-sorted read whose ties keep insertion order) — and the
    same as the file reader's over the wire events."""
    env = _env("sqlite", tmp_path)
    pkgs = {"jax": ref_storage, "port": port_storage}
    w = pkgs[writer].Storage(env)
    _write_store(pkgs[writer], w)
    w.close()
    port_s, ref_s = port_storage.Storage(env), ref_storage.Storage(env)
    pu, pi, pr, pusers, pitems = _triples(PEventStore, port_s, **kw)
    ru, ri, rr, rusers, ritems = _triples(RefPEventStore, ref_s, **kw)
    wu, wi, wr, wusers, witems = wire_find_ratings(_wire_events(), **kw)
    for port, ref, wire in ((pu, ru, wu), (pi, ri, wi), (pr, rr, wr)):
        np.testing.assert_array_equal(port, ref)
        np.testing.assert_array_equal(port, wire)
    assert list(pusers.to_dict().items()) == list(rusers.to_dict().items()) \
        == list(wusers.to_dict().items())
    assert list(pitems.to_dict().items()) == list(ritems.to_dict().items()) \
        == list(witems.to_dict().items())
    assert len(pu) > 0
    port_s.close()
    ref_s.close()


def test_aggregate_properties_identical_in_both_packages(tmp_path):
    env = _env("sqlite", tmp_path)
    w = ref_storage.Storage(env)
    app_id = w.get_meta_data_apps().insert(ref_storage.App(0, "shared"))
    le = w.get_l_events()
    rng = np.random.default_rng(4)
    for j in range(60):
        name = ["$set", "$set", "$unset", "$delete"][int(rng.integers(4))]
        props = ({} if name == "$delete" else
                 {f"p{int(rng.integers(3))}": int(rng.integers(9))})
        le.insert(ref_storage.Event(
            name, "item", f"i{int(rng.integers(6))}",
            properties=ref_storage.DataMap(props),
            event_time=_ts(int(rng.integers(10)))), app_id)
    w.close()
    port_s, ref_s = port_storage.Storage(env), ref_storage.Storage(env)
    for required in (None, ["p0"]):
        port = PEventStore.aggregate_properties("shared", "item",
                                                required=required, storage=port_s)
        ref = RefPEventStore.aggregate_properties("shared", "item",
                                                  required=required, storage=ref_s)
        assert {k: (dict(v), v.first_updated, v.last_updated)
                for k, v in port.items()} == \
            {k: (dict(v), v.first_updated, v.last_updated)
             for k, v in ref.items()}
    port_s.close()
    ref_s.close()


# -- the model envelope ---------------------------------------------------------


def _blobs():
    payload = np.arange(50, dtype=np.float32).tobytes() + b"npz-ish payload"
    intact = ref_artifact.wrap(payload)
    header_end = len(intact) - len(payload)
    flipped = bytearray(intact)
    flipped[header_end + 7] ^= 0x01
    header_flip = bytearray(intact)
    header_flip[10] ^= 0xFF
    newer = ref_artifact.MAGIC + ref_artifact._LEN.pack(
        len(b'{"sha256": "x", "size": 1, "v": 9}')) + \
        b'{"sha256": "x", "size": 1, "v": 9}' + b"x"
    return {
        "intact": intact,
        "truncated": intact[:-5],
        "payload-bit-flip": bytes(flipped),
        "header-byte-flip": bytes(header_flip),
        "newer-version": newer,
        "short": ref_artifact.MAGIC + b"\x00",
        "legacy-pickle": pickle.dumps({"a": 1}, protocol=4),
        "garbage": b"not a model",
        "missing": None,
    }


def test_envelope_is_byte_identical():
    for payload in (b"", b"x", np.ones(1000, np.float32).tobytes()):
        assert model_artifact.wrap(payload) == ref_artifact.wrap(payload)
        sha = model_artifact.compute_sha256(payload)
        assert model_artifact.wrap(payload, sha) == ref_artifact.wrap(payload, sha)


@pytest.mark.parametrize("name", list(_blobs()))
def test_envelope_verdicts_match_the_reference(name):
    blob = _blobs()[name]
    assert model_artifact.describe(blob) == ref_artifact.describe(blob)
    if blob is None:
        return

    def verdict(mod):
        try:
            return "ok", mod.unwrap_verified(blob, "inst")
        except mod.ModelIntegrityError as e:
            return e.kind, str(e)

    assert verdict(model_artifact) == verdict(ref_artifact)


def test_model_rows_round_trip_through_either_package(tmp_path):
    """write_model of one package, read_model of the other; a corrupted
    row is refused by both with the same kind, and never deleted."""
    env = _env("sqlite", tmp_path)
    port_s, ref_s = Storage(env), ref_storage.Storage(env)
    payload = b"PK\x03\x04" + bytes(range(256)) * 10
    model_artifact.write_model(port_s, "a", payload)
    ref_artifact.write_model(ref_s, "b", payload)
    assert ref_artifact.read_model(ref_s, "a") == payload
    assert model_artifact.read_model(port_s, "b") == payload
    assert port_s.get_model_data_models().get("a").models == \
        ref_s.get_model_data_models().get("b").models
    blob = bytearray(port_s.get_model_data_models().get("a").models)
    blob[-1] ^= 0x40
    port_s.get_model_data_models().insert(Model("a", bytes(blob)))
    before = model_artifact.integrity_failure_counts().get("checksum", 0)
    for mod, s in ((model_artifact, port_s), (ref_artifact, ref_s)):
        with pytest.raises(mod.ModelIntegrityError) as err:
            mod.read_model(s, "a")
        assert err.value.kind == "checksum"
    assert model_artifact.integrity_failure_counts()["checksum"] == before + 1
    with pytest.raises(model_artifact.ModelIntegrityError, match="missing"):
        model_artifact.read_model(port_s, "nope")
    assert port_s.get_model_data_models().exists("a")
    model_artifact.delete_model(port_s, "b")
    assert not ref_s.get_model_data_models().exists("b")
    port_s.close()
    ref_s.close()
