"""The port's object and search stores on the CPU, held against the
reference's: S3 and HDFS (model data), ELASTICSEARCH (metadata and
events) and HBASE over the REST gateway and the native RPC (events).

- **The stand-ins.** ``tests/torch_{s3,es,hbase,hbase_rpc,hdfs}_server.py``
  (standard library, the servers ``chip_smoke.py`` runs on the card
  host) run the reference's storage contract under the port's clients,
  and a scripted conversation gives the same results on each stand-in as
  on the reference's mock of the same store.
- **Across packages, both ways.** The reference writes apps, keys,
  channels, instances, a model and events through its clients into a
  shared server and the port reads equal rows, and the reverse;
  ``PEventStore.find_ratings`` gives the identical triple and id maps
  from either package on Elasticsearch and on HBase.
- **Wire bytes.** The port's clients send the bytes of
  ``tests/fixtures/{s3,es,hdfs}_http_golden.txt`` and
  ``hbase_rpc_golden.hex`` (read, never written).
- **The reference's specific cases**, one port case each: the S3 bad
  secret, models only and reserved keys; HBase filter push-down; the ES
  sliced scan's global order and its degrade modes; the HBase scanners
  across regions; the RPC chaos retries.
- **The registry.** A dead store of each type raises ``StorageError``
  naming the source; ``pio status`` prints each store's breaker.
- **The cold tier.** ``pio eventlog archive`` to an S3 source, then a
  windowed train restores the generation on demand and trains bit-equal
  to the train before the archive.
"""

import contextlib
import datetime as dt
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import test_hbase_rpc_golden as rpc_golden  # noqa: E402
import test_http_golden as http_golden  # noqa: E402
import test_torch_eventlog_archive as archive_cases  # noqa: E402
import test_torch_storage as store_cases  # noqa: E402
import torch_serving as ts  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.store.p_event_store import (  # noqa: E402
    PEventStore as RefPEventStore,
)
from incubator_predictionio_torch.common import faultinject  # noqa: E402
from incubator_predictionio_torch.data import storage as port_storage  # noqa: E402
from incubator_predictionio_torch.data.storage import (  # noqa: E402
    DataMap, Event, Model, Storage, StorageError,
)
from incubator_predictionio_torch.data.storage import (  # noqa: E402
    elasticsearch as es_mod, hbase_rpc, s3 as s3_mod,
)
from incubator_predictionio_torch.data.storage.base import (  # noqa: E402
    StorageClientConfig,
)
from incubator_predictionio_torch.data.store import PEventStore  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ["es", "hbase-rest", "hbase-rpc", "s3", "hdfs"]
PKGS = {"jax": ref_storage, "port": port_storage}
RATINGS_KW = dict(event_names=["rate", "buy"],
                  event_default_ratings={"buy": 4.0})


@contextlib.contextmanager
def stand_in(kind, **kw):
    """The port's stand-in server of an object or search store."""
    if kind == "es":
        from torch_es_server import ESServer as Server
    elif kind == "hbase-rest":
        from torch_hbase_server import HBaseRestServer as Server
    elif kind == "hbase-rpc":
        from torch_hbase_rpc_server import HBaseRpcServer as Server

        kw.setdefault("default_split", b"t:")
    elif kind == "hdfs":
        from torch_hdfs_server import HDFSServer as Server
    else:
        from torch_s3_server import S3Server

        def Server(**kw):
            return S3Server("AKPIOTEST", "s3cr3t", **kw)
    with Server(**kw) as srv:
        yield srv


def server(kind, which):
    return (store_cases.reference_mock(kind) if which == "mock"
            else stand_in(kind))


def _state(kind, which, srv):
    """What the server holds, as comparable plain values."""
    if kind == "s3":
        return sorted((srv.app["objects"] if which == "mock"
                       else srv.objects).items())
    if kind == "hdfs":
        # the blobs alone: the reference's mock decodes a path twice
        # (aiohttp once, then unquote), the stand-in once as WebHDFS
        # does, so a model id's percent-encoding stays in its file name
        return sorted((srv.app["files"] if which == "mock"
                       else srv.files).values())
    if kind == "hbase-rest":
        return srv.app["rows_served"] if which == "mock" else srv.rows_served
    if kind == "hbase-rpc":
        return srv.rows_served
    return None


def _events(n, t0=None):
    t0 = t0 or dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    return [Event("rate", "user", str(k % 97), "item", str(k % 31),
                  DataMap({"rating": (k % 5) + 1}),
                  t0 + dt.timedelta(seconds=k // 7))  # plenty of ties
            for k in range(n)]


def _client(cls, **props):
    return cls(StorageClientConfig(properties=props))


# -- the stand-ins -----------------------------------------------------------


@pytest.mark.parametrize("case", store_cases.CONTRACT,
                         ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("kind", KINDS)
def test_contract_on_the_stand_ins(kind, case, tmp_path):
    with stand_in(kind) as srv:
        s = Storage(store_cases.object_store_env(kind, srv.port, tmp_path))
        case(s)
        s.close()


def _conversation(kind, srv, which, tmp_path):
    """One scripted session of the port's clients: every answer, without
    the random event ids and the wall-clock creation times, and what the
    server holds after it."""
    s = Storage(store_cases.object_store_env(kind, srv.port, tmp_path))
    out = {}
    if kind in ("s3", "hdfs"):
        m = s.get_model_data_models()
        m.insert(Model("m/1 x", b"\x00one"))
        m.insert(Model("m2", b"two"))
        m.insert(Model("m2", b"two again"))
        out["get"] = [m.get(i) and m.get(i).models
                      for i in ("m/1 x", "m2", "nope")]
        out["exists"] = [m.exists("m2"), m.exists("nope")]
        m.delete("m2")
        out["after"] = m.get("m2")
    else:
        app_id = 1
        if kind == "es":
            app_id, _cid = store_cases._write_store(port_storage, s)
        le = s.get_l_events()
        le.init(app_id)
        le.insert_batch([Event.from_json(e)
                         for e in store_cases._wire_events()], app_id)
        le.insert(Event("rate", "user", "u1", "item", "i1",
                        DataMap({"rating": 1.0}), store_cases._ts(0),
                        event_id="fixed"), app_id)

        def plain(evs):
            return [{k: v for k, v in e.to_json().items()
                     if k not in ("eventId", "creationTime")} for e in evs]
        out["all"] = plain(le.find(app_id))
        out["reversed"] = plain(le.find(app_id, reversed_order=True,
                                        limit=7))
        out["filtered"] = plain(le.find(app_id, entity_id="u1",
                                        event_names=["rate"]))
        out["window"] = plain(le.find(
            app_id, start_time=dt.datetime(2024, 1, 1, 0, 0, 2,
                                           tzinfo=dt.timezone.utc),
            until_time=dt.datetime(2024, 1, 1, 0, 0, 5,
                                   tzinfo=dt.timezone.utc)))
        out["fixed"] = plain([le.get("fixed", app_id)])
        out["deleted"] = [le.delete("fixed", app_id),
                          le.delete("fixed", app_id)]
        if kind == "es":
            out["apps"] = [(a.id, a.name) for a in
                           s.get_meta_data_apps().get_all()]
            out["instances"] = [
                i.id for i in s.get_meta_data_engine_instances().get_all()]
            u, i, r, users, items = PEventStore.find_ratings(
                "shared", storage=s, **RATINGS_KW)
            out["triple"] = [u.tolist(), i.tolist(), r.tolist(),
                             list(users.to_dict().items()),
                             list(items.to_dict().items())]
    s.close()
    out["server"] = _state(kind, which, srv)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_stand_in_answers_as_the_reference_mock(kind, tmp_path):
    got = {}
    for which in ("mock", "stand-in"):
        with server(kind, which) as srv:
            got[which] = _conversation(kind, srv, which, tmp_path / which)
    assert got["stand-in"] == got["mock"]
    assert got["mock"]


# -- across packages ----------------------------------------------------------


def _topology_env(topo, ports, tmp_path):
    """METADATA on Elasticsearch; events and models per ``topo``."""
    events, models = topo.split("+")
    env = store_cases.object_store_env("es", ports["es"], tmp_path)
    side = store_cases.object_store_env(events, ports[events], tmp_path)
    env |= {k.replace("_OBJ", "_EV"): v for k, v in side.items()
            if "SOURCES_OBJ" in k}
    env["PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE"] = (
        "OBJ" if events == "es" else "EV")
    side = store_cases.object_store_env(models, ports[models], tmp_path)
    env |= {k.replace("_OBJ", "_MOD"): v for k, v in side.items()
            if "SOURCES_OBJ" in k}
    env["PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE"] = "MOD"
    return env


@pytest.mark.parametrize("which", ["mock", "stand-in"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("topo", ["es+s3", "hbase-rest+hdfs",
                                  "hbase-rpc+hdfs"])
def test_object_stores_shared_by_both_packages(topo, writer, which,
                                               tmp_path):
    kinds = sorted({"es", *topo.split("+")})
    with contextlib.ExitStack() as stack:
        ports = {k: stack.enter_context(server(k, which)).port
                 for k in kinds}
        env = _topology_env(topo, ports, tmp_path)
        reader = "port" if writer == "jax" else "jax"
        w = PKGS[writer].Storage(env)
        app_id, cid = store_cases._write_store(PKGS[writer], w)
        w.close()
        rows, triples = {}, {}
        for name in (writer, reader):
            s = PKGS[name].Storage(env)
            rows[name] = store_cases._rows(PKGS[name], s, app_id, cid)
            finder = RefPEventStore if name == "jax" else PEventStore
            triples[name] = finder.find_ratings("shared", storage=s,
                                                **RATINGS_KW)
            s.close()
    assert rows["port"] == rows["jax"]
    assert rows["port"]["model"] == b"\x00blob\xff"
    assert len(rows["port"]["events"]) == len(store_cases._wire_events())
    pu, pi, pr, pusers, pitems = triples["port"]
    ru, ri, rr, rusers, ritems = triples["jax"]
    for port, ref in ((pu, ru), (pi, ri), (pr, rr)):
        np.testing.assert_array_equal(port, ref)
    assert list(pusers.to_dict().items()) == list(rusers.to_dict().items())
    assert list(pitems.to_dict().items()) == list(ritems.to_dict().items())
    assert len(pu) > 0


@pytest.mark.parametrize("kind", ["es", "hbase-rest", "hbase-rpc"])
def test_aggregate_properties_identical_in_both_packages(kind, tmp_path):
    with store_cases.reference_mock(kind) as srv:
        env = store_cases.object_store_env(kind, srv.port, tmp_path)
        ref = ref_storage.Storage(env)
        le = ref.get_l_events()
        le.init(3)
        rng = np.random.default_rng(11)
        for k in range(60):
            name = ("$set", "$set", "$unset", "$delete")[int(rng.integers(4))]
            props = {f"a{int(rng.integers(3))}": int(rng.integers(9))}
            le.insert(ref_storage.Event(
                name, "item", f"i{int(rng.integers(6))}",
                properties=ref_storage.DataMap(
                    {} if name == "$delete" else props),
                event_time=store_cases._ts(int(rng.integers(20)))), 3)
        want = ref.get_p_events().aggregate_properties(3, "item")
        ref.close()
        port = Storage(env)
        got = port.get_p_events().aggregate_properties(3, "item")
        port.close()
    assert set(got) == set(want)
    for k in want:
        assert got[k].to_dict() == want[k].to_dict()
        assert got[k].first_updated == want[k].first_updated
        assert got[k].last_updated == want[k].last_updated


# -- wire bytes ---------------------------------------------------------------


def _golden(name):
    with open(os.path.join(http_golden.FIXTURES, name)) as f:
        return f.read()


def test_es_client_sends_the_golden_requests(monkeypatch):
    from es_mock import build_es_app
    from server_utils import ServerThread

    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    with ServerThread(build_es_app()) as srv:
        env = {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "S",
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "ES",
               "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S",
               "PIO_STORAGE_SOURCES_S_TYPE": "MEMORY",
               "PIO_STORAGE_SOURCES_ES_TYPE": "ELASTICSEARCH",
               "PIO_STORAGE_SOURCES_ES_HOSTS": "127.0.0.1",
               "PIO_STORAGE_SOURCES_ES_PORTS": str(srv.port)}

        def conversation():
            s = Storage(env)
            le = s.get_l_events()
            le.insert(Event("view", "user", "u1", "item", "i1", DataMap(),
                            t0, event_id="ev-golden-1", creation_time=t0), 1)
            le.insert_batch([
                Event("buy", "user", "u2", "item", "i2", DataMap({"q": 2}),
                      t0 + dt.timedelta(seconds=1), event_id="ev-golden-2",
                      creation_time=t0),
                Event("$set", "item", "i3", properties=DataMap({"cat": "a"}),
                      event_time=t0 + dt.timedelta(seconds=2),
                      event_id="ev-golden-3", creation_time=t0),
            ], 1)
            list(le.find(1, event_names=["buy"]))
            le.get("ev-golden-1", 1)
            le.delete("ev-golden-3", 1)
            s.close()

        rendered = http_golden._record_requests(monkeypatch, conversation,
                                                srv.port)
    assert rendered == _golden("es_http_golden.txt")


@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_hdfs_client_sends_the_golden_requests(monkeypatch, which):
    with server("hdfs", which) as srv:
        env = {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "S",
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "S",
               "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DFS",
               "PIO_STORAGE_SOURCES_S_TYPE": "MEMORY",
               "PIO_STORAGE_SOURCES_DFS_TYPE": "HDFS",
               "PIO_STORAGE_SOURCES_DFS_HOSTS": "127.0.0.1",
               "PIO_STORAGE_SOURCES_DFS_PORTS": str(srv.port),
               "PIO_STORAGE_SOURCES_DFS_PATH": "/pio/models"}

        def conversation():
            s = Storage(env)
            models = s.get_model_data_models()
            models.insert(Model("m-golden", b"\x00\x01blob"))
            models.get("m-golden")
            models.delete("m-golden")
            s.close()

        rendered = http_golden._record_requests(monkeypatch, conversation,
                                                srv.port)
    assert rendered == _golden("hdfs_http_golden.txt")


def test_s3_client_sends_the_golden_requests(monkeypatch):
    """The fixed port and clock of the reference's golden: the SigV4
    signature covers the host and x-amz-date."""
    from torch_s3_server import S3Server

    class FixedDateTime(dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 1, 2, 3, 4, 5, tzinfo=tz)

    monkeypatch.setattr(s3_mod._dt, "datetime", FixedDateTime)
    try:
        srv = S3Server("AKGOLDEN", "s3cr3t", port=http_golden.S3_GOLDEN_PORT)
    except OSError:
        pytest.skip(f"port {http_golden.S3_GOLDEN_PORT} unavailable")
    with srv:
        env = {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "S",
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "S",
               "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "OBJ",
               "PIO_STORAGE_SOURCES_S_TYPE": "MEMORY",
               "PIO_STORAGE_SOURCES_OBJ_TYPE": "S3",
               "PIO_STORAGE_SOURCES_OBJ_ENDPOINT":
                   f"http://127.0.0.1:{srv.port}",
               "PIO_STORAGE_SOURCES_OBJ_BUCKET": "pio-models",
               "PIO_STORAGE_SOURCES_OBJ_ACCESS_KEY": "AKGOLDEN",
               "PIO_STORAGE_SOURCES_OBJ_SECRET_KEY": "s3cr3t"}

        def conversation():
            s = Storage(env)
            models = s.get_model_data_models()
            models.insert(Model("m-golden", b"\x00\x01blob"))
            assert models.get("m-golden").models == b"\x00\x01blob"
            models.delete("m-golden")
            s.close()

        rendered = http_golden._record_requests(monkeypatch, conversation,
                                                srv.port)
    assert rendered == _golden("s3_http_golden.txt")


@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_hbase_rpc_client_sends_the_golden_bytes(monkeypatch, which):
    monkeypatch.setattr(rpc_golden, "hbase_rpc", hbase_rpc)
    if which == "mock":
        from hbase_rpc_mock import MockHBaseRpcServer as Server
    else:
        from torch_hbase_rpc_server import HBaseRpcServer as Server
    with Server() as srv:
        streams = rpc_golden._canonical_conversation(srv.port)
    rendered = "\n".join(f"# connection {i}\n{s.hex()}"
                         for i, s in enumerate(streams)) + "\n"
    with open(rpc_golden.GOLDEN) as f:
        assert rendered == f.read()


# -- the reference's specific cases -------------------------------------------


def _s3(srv, secret="s3cr3t"):
    return _client(s3_mod.S3Client, ENDPOINT=f"http://127.0.0.1:{srv.port}",
                   BUCKET="b", ACCESS_KEY="AKPIOTEST", SECRET_KEY=secret)


@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_s3_signature_rejected_on_bad_secret(which):
    with server("s3", which) as srv:
        with pytest.raises(s3_mod.S3StorageError, match="HTTP 403"):
            _s3(srv, "WRONGsecret").models().insert(Model("m1", b"blob"))


@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_s3_source_serves_models_only(which):
    with server("s3", which) as srv:
        client = _s3(srv)
        with pytest.raises(NotImplementedError):
            client.l_events()
        with pytest.raises(NotImplementedError):
            client.apps()


@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_s3_key_with_reserved_characters(which):
    with server("s3", which) as srv:
        models = _s3(srv).models("name space+ns")
        models.insert(Model("id with space+plus", b"\x01blob"))
        assert models.get("id with space+plus").models == b"\x01blob"
        models.delete("id with space+plus")
        assert models.get("id with space+plus") is None


def test_s3_clock_skew_names_the_cause():
    with stand_in("s3", mode="clock_skew") as srv:
        with pytest.raises(s3_mod.S3StorageError,
                           match="RequestTimeTooSkewed"):
            _s3(srv).models().get("m")


@pytest.mark.parametrize("mode", ["no_redirect", "redirect_no_location"])
@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_hdfs_gateway_modes(which, mode):
    from incubator_predictionio_torch.data.storage import hdfs

    if which == "mock":
        from hdfs_mock import build_hdfs_app
        from server_utils import ServerThread

        ctx = ServerThread(build_hdfs_app(mode=mode))
    else:
        ctx = stand_in("hdfs", mode=mode)
    with ctx as srv:
        models = _client(hdfs.HDFSClient, HOSTS="127.0.0.1",
                         PORTS=str(srv.port)).models()
        if mode == "no_redirect":
            models.insert(Model("m", b"payload"))
            assert models.get("m").models == b"payload"
        else:
            with pytest.raises(hdfs.HDFSStorageError, match="Location"):
                models.insert(Model("m", b"payload"))


@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_hbase_filter_pushdown_only_transfers_matches(which):
    from incubator_predictionio_torch.data.storage.hbase import HBaseClient

    with server("hbase-rest", which) as srv:
        def served(reset=False):
            if which == "mock":
                if reset:
                    srv.app["rows_served"] = 0
                return srv.app["rows_served"]
            if reset:
                srv.rows_served = 0
            return srv.rows_served

        le = _client(HBaseClient, HOSTS="127.0.0.1",
                     PORTS=str(srv.port)).l_events()
        evs = [Event("view", "user", str(k % 7), "item", str(k % 5),
                     DataMap(), store_cases._ts(k)) for k in range(60)]
        evs += [Event("$set", "item", f"i{k}", properties=DataMap({"a": k}),
                      event_time=store_cases._ts(100 + k)) for k in range(8)]
        le.insert_batch(evs, 77)
        served(reset=True)
        assert len(list(le.find(77, entity_type="item",
                                event_names=["$set"]))) == 8
        assert served() == 8                 # the 60 views never crossed
        served(reset=True)
        got = list(le.find(77, target_entity_id="3", event_names=["view"]))
        assert {e.target_entity_id for e in got} == {"3"}
        assert served() == len(got) == 12
        served(reset=True)
        got = list(le.find(77, entity_type="user", entity_id="2",
                           event_names=["view", "buy"]))
        assert served() == len(got) > 0
        served(reset=True)
        assert list(le.find(77, event_names=[])) == []
        assert served() == 0
        served(reset=True)
        assert set(le.aggregate_properties(77, "item")) == \
            {f"i{k}" for k in range(8)}
        assert served() == 8


def _es(srv):
    return _client(es_mod.ESClient, HOSTS="127.0.0.1", PORTS=str(srv.port))


@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_es_sliced_parallel_scan_preserves_global_order(monkeypatch, which):
    monkeypatch.setattr(es_mod, "_PAGE", 100)
    n = 2500
    with server("es", which) as srv:
        client = _es(srv)
        client.l_events().insert_batch(_events(n), 1)
        monkeypatch.setenv("PIO_ES_SLICES", "4")
        sliced = [e.event_id for e in client.p_events().find(1)]
        monkeypatch.setenv("PIO_ES_SLICES", "1")
        serial = [e.event_id for e in client.p_events().find(1)]
        assert sliced == serial and len(sliced) == n
        pits = srv.app["pits"] if which == "mock" else srv.pits
        assert not pits                      # every PIT closed
        if which == "stand-in":
            assert srv.stats["sliced_search"] >= 4 * (n // 4 // 100)
        monkeypatch.setenv("PIO_ES_SLICES", "4")
        got = list(client.p_events().find(1, entity_id="5"))
        assert len(got) == len([k for k in range(n) if k % 97 == 5])


@pytest.mark.parametrize("mode", ["opensearch", "pit_no_slice"])
@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_es_sliced_scan_degrades_gracefully(monkeypatch, which, mode):
    monkeypatch.setattr(es_mod, "_PAGE", 100)
    monkeypatch.setenv("PIO_ES_SLICES", "4")
    n = 600
    if which == "mock":
        from es_mock import build_es_app
        from server_utils import ServerThread

        ctx = ServerThread(build_es_app(mode=mode))
    else:
        ctx = stand_in("es", mode=mode)
    with ctx as srv:
        client = _es(srv)
        client.l_events().insert_batch(_events(n), 1)
        got = [e.event_id for e in client.p_events().find(1)]
        monkeypatch.setenv("PIO_ES_SLICES", "1")
        assert got == [e.event_id for e in client.p_events().find(1)]
        assert len(got) == n
        assert not (srv.app["pits"] if which == "mock" else srv.pits)


@pytest.mark.parametrize("mode", ["shard_failure", "search_timeout",
                                  "bulk_partial_failure"])
def test_es_partial_results_are_refused(mode):
    with stand_in("es", mode=mode) as srv:
        le = _es(srv).l_events()
        if mode == "bulk_partial_failure":
            with pytest.raises(es_mod.ESStorageError, match="bulk"):
                le.insert_batch(_events(5), 1)
            return
        le.insert_batch(_events(5), 1)
        with pytest.raises(es_mod.ESStorageError, match="partial|timeout"):
            list(le.find(1))


@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_hbase_rpc_scanner_pages_across_regions_at_scale(which):
    from incubator_predictionio_torch.data.storage.event import event_time_us
    from incubator_predictionio_torch.data.storage.hbase import (
        HBaseClient, HBLEvents,
    )

    n = 2500
    evs = _events(n)
    mid = HBLEvents._data_key(event_time_us(evs[n // 2].event_time), 0)
    if which == "mock":
        from hbase_rpc_mock import MockHBaseRpcServer

        ctx = MockHBaseRpcServer(split_keys={"pio_eventdata_9": [mid]})
    else:
        ctx = stand_in("hbase-rpc", default_split=mid)
    with ctx as srv:
        client = _client(HBaseClient, HOSTS="127.0.0.1", PORTS=str(srv.port),
                         PROTOCOL="rpc")
        le = client.l_events()
        le.insert_batch(evs, 9)
        t = srv.tables["pio_eventdata_9"]
        counts = [sum(1 for k in t.region_rows(name) if k.startswith(b"t:"))
                  for _s, _e, name in t.regions]
        assert len(counts) == 2 and all(c > 0 for c in counts), counts
        srv.rows_served = 0
        got = list(le.find(9))
        assert len(got) == n
        times = [e.event_time for e in got]
        assert times == sorted(times)
        assert srv.rows_served == n          # every row crossed once
        srv.rows_served = 0
        got_r = list(le.find(9, reversed_order=True, limit=50))
        assert len(got_r) == 50 and got_r[0].event_time == times[-1]
        client.close()


@pytest.fixture()
def chaos(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("PIO_FAULT_SPEC", spec)
        faultinject.reset()

    yield arm
    monkeypatch.delenv("PIO_FAULT_SPEC", raising=False)
    faultinject.reset()


@pytest.mark.chaos
@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_rpc_fault_retries_like_torn_socket(chaos, which):
    """An injected ``hbase.rpc`` fault is a lost connection: the
    relocate-and-retry loop absorbs it and the caller gets its row."""
    with server("hbase-rpc", which) as srv:
        t = hbase_rpc.HBaseRpcTransport("127.0.0.1", srv.port)
        try:
            t.create_table("chaos_tbl")
            t.put_rows("chaos_tbl", [(b"r1", {"v": b"x"})])
            chaos("hbase.rpc:fail:1")
            assert t.get_row("chaos_tbl", b"r1") == {"v": b"x"}
        finally:
            t.close()


@pytest.mark.chaos
@pytest.mark.parametrize("which", ["mock", "stand-in"])
def test_ping_fault_retried_then_exhausts_policy(chaos, which):
    with server("hbase-rpc", which) as srv:
        t = hbase_rpc.HBaseRpcTransport("127.0.0.1", srv.port)
        try:
            chaos("hbase.ping:fail:1")
            t.ping()                         # retried within the policy
            chaos("hbase.ping:fail:99")
            with pytest.raises(ConnectionError):
                t.ping()                     # the policy is exhausted
        finally:
            t.close()


@pytest.mark.parametrize("mode", ["notserving", "unknown_scanner",
                                  "garbage"])
def test_hbase_rpc_stand_in_adversarial_modes(mode):
    """The stand-in's fault knobs, as the reference mock's: a region that
    is not serving is relocated and retried, a lost scanner and a garbled
    frame surface as HBaseRpcError."""
    with stand_in("hbase-rpc") as srv:
        t = hbase_rpc.HBaseRpcTransport("127.0.0.1", srv.port)
        try:
            t.create_table("adv")
            t.put_rows("adv", [(b"t:1", {"v": b"x"}), (b"i:1", {"k": b"y"})])
            if mode == "notserving":
                srv.notserving_once("adv")
                assert t.get_row("adv", b"t:1") == {"v": b"x"}
                assert [k for k, _ in t.scan("adv", b"", b"")] == \
                    [b"i:1", b"t:1"]
            elif mode == "unknown_scanner":
                srv.fail_next(
                    "Scan", "org.apache.hadoop.hbase.UnknownScannerException",
                    do_not_retry=True)
                with pytest.raises(hbase_rpc.HBaseRpcError):
                    list(t.scan("adv", b"", b""))
            else:
                srv.garbage_frame_next()
                with pytest.raises(hbase_rpc.HBaseRpcError):
                    t.delete_table("adv")
        finally:
            t.close()


# -- the registry ---------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_dead_object_store_raises_storage_error(kind, tmp_path):
    """No fallback: an unreachable store raises StorageError naming the
    source when it is opened."""
    env = store_cases.object_store_env(kind, ts.free_port(), tmp_path)
    env["PIO_STORAGE_SOURCES_OBJ_RETRY_ATTEMPTS"] = "1"
    s = Storage(env)
    repo = store_cases._OBJECT_REPOS[kind][0]
    open_repo = {"METADATA": s.get_meta_data_apps,
                 "EVENTDATA": s.get_l_events,
                 "MODELDATA": s.get_model_data_models}[repo]
    with pytest.raises(StorageError) as err:
        open_repo()
    msg = str(err.value)
    assert "Storage source OBJ" in msg and "cannot be opened" in msg
    assert "refused" in msg.lower() or "unreachable" in msg.lower()
    errors = s.verify_all_data_objects()
    assert errors and any("OBJ" in e for e in errors)


def test_pio_status_prints_each_object_store_breaker(tmp_path, monkeypatch,
                                                     capsys):
    from incubator_predictionio_torch.tools.commands import management

    with contextlib.ExitStack() as stack:
        ports = {k: stack.enter_context(stand_in(k)).port
                 for k in ("es", "hbase-rpc", "s3")}
        env = _topology_env("hbase-rpc+s3", ports, tmp_path)
        for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
            monkeypatch.delenv(k)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
        Storage.reset_instance()
        try:
            assert management.status_cmd([]) == 0
        finally:
            Storage.reset_instance()
    out = capsys.readouterr().out
    assert f"METADATA: breaker es:http://127.0.0.1:{ports['es']} is closed" \
        in out
    assert f"EVENTDATA: breaker hbase-rpc:127.0.0.1:{ports['hbase-rpc']} " \
        "is closed" in out
    assert f"MODELDATA: breaker s3:http://127.0.0.1:{ports['s3']}/" \
        "pio-models is closed" in out


# -- the cold tier on S3 ----------------------------------------------------------


def test_eventlog_archive_to_s3_then_a_windowed_train_restores(
        tmp_path, monkeypatch):
    """``pio eventlog archive`` sends a sealed generation to an S3 source;
    a windowed train read that needs it restores it on demand (through
    the process's registry, as ``pio train`` does) and trains bit-equal
    to the train before the archive."""
    from incubator_predictionio_torch.ops.als import ALSParams, train_als

    archive_cases._build(tmp_path)
    until = archive_cases.T0.replace(month=4)

    def train():
        u, i, r, users, items = PEventStore.find_ratings(
            "arch", until_time=until, **archive_cases.KW)
        f = train_als(u, i, r, len(users), len(items),
                      ALSParams(rank=4, num_iterations=3), device="cpu")
        return len(u), f.user_factors, f.item_factors

    with stand_in("s3") as srv:
        env = archive_cases._env(tmp_path) | {
            "PIO_STORAGE_SOURCES_COLD_TYPE": "S3",
            "PIO_STORAGE_SOURCES_COLD_ENDPOINT": f"http://127.0.0.1:{srv.port}",
            "PIO_STORAGE_SOURCES_COLD_BUCKET": "cold",
            "PIO_STORAGE_SOURCES_COLD_ACCESS_KEY": "AKPIOTEST",
            "PIO_STORAGE_SOURCES_COLD_SECRET_KEY": "s3cr3t"}
        del env["PIO_STORAGE_SOURCES_COLD_PATH"]
        for k in [k for k in os.environ
                  if k.startswith(("PIO_STORAGE_", "PIO_EVENT"))]:
            monkeypatch.delenv(k)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
        monkeypatch.setenv("PIO_EVENT_ARCHIVE_SOURCE", "COLD")
        Storage.reset_instance()
        try:
            before = train()
            out = subprocess.run(
                [sys.executable, "-m",
                 "incubator_predictionio_torch.tools.console", "eventlog",
                 "archive", "--log", "events_1.jsonl", "--generation", "1"],
                env=dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                         + os.environ.get("PYTHONPATH", "")),
                cwd=ROOT, capture_output=True, text=True, timeout=120)
            assert out.returncode == 0, out.stderr
            assert "tier archived (source COLD, blob events_1.jsonl.g1)" \
                in out.stdout
            assert archive_cases._tiers(tmp_path)[0] == (1, "archived")
            assert [k for k in srv.objects if k.startswith("/cold/")]
            monkeypatch.setenv("PIO_EVENT_RESTORE_ON_DEMAND", "1")
            Storage.reset_instance()     # a fresh `pio train` process
            after = train()
        finally:
            Storage.reset_instance({})
    assert archive_cases._tiers(tmp_path)[0] == (1, "hot")
    assert before[0] == after[0] == 100
    for a, b in zip(before[1:], after[1:]):
        assert np.array_equal(a, b)
