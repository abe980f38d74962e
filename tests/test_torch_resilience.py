"""The port's resilience layer (``common/resilience.py``) and what rides on
it, on the CPU: the counterpart of ``tests/test_resilience.py``.

The retry policy and the circuit breaker run the same scripted scenarios
in both packages and must end in the same call counts and the same
breaker snapshots (exact equality of integer counters). Then the port's
own stack: a dead network store surfaces as ``StorageError`` (never a
fallback), a wrong password too; two injected transient faults are
retried through a write and a read; a persistent failure trips the
breaker and the event server sheds 503 with an integer ``Retry-After``
within ``[1, 2·base + 1]``; ``/readyz`` names an open breaker and answers
503 until it closes; a dropped scan stream resumes without loss or
duplicates; a client built while its storage server still binds waits for
it with a clean breaker; a train on a dead store fails loudly and lands
no COMPLETED instance; a reload under query traffic tears nothing; and no
module of the port's storage layer calls ``urlopen`` past the resilient
transport.
"""

import ast
import io
import os
import threading
import time
import urllib.error

import pytest

pytest.importorskip("torch")

import torch_serving as ts  # noqa: E402
from incubator_predictionio_tpu.common import faultinject as ref_fi  # noqa: E402
from incubator_predictionio_tpu.common import resilience as ref_res  # noqa: E402
from incubator_predictionio_torch.common import faultinject  # noqa: E402
from incubator_predictionio_torch.common import resilience  # noqa: E402
from incubator_predictionio_torch.data.api.event_server import EventServer  # noqa: E402
from incubator_predictionio_torch.data.api.storage_server import StorageServer  # noqa: E402
from incubator_predictionio_torch.data.storage import (  # noqa: E402
    AccessKey, App, Storage, StorageError,
)
from incubator_predictionio_torch.models.recommendation import (  # noqa: E402
    RecommendationEngine,
)
from incubator_predictionio_torch.workflow.create_server import EngineServer  # noqa: E402

PKGS = {"ref": (ref_res, ref_fi), "port": (resilience, faultinject)}


@pytest.fixture
def fault_spec(monkeypatch):
    """Install a PIO_FAULT_SPEC plan (re-armed in both packages)."""
    def install(spec: str) -> None:
        monkeypatch.setenv("PIO_FAULT_SPEC", spec)
        faultinject.reset()
        ref_fi.reset()
    yield install
    monkeypatch.delenv("PIO_FAULT_SPEC", raising=False)
    faultinject.reset()
    ref_fi.reset()


class _FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


# -- the policy and the breaker, scripted in both packages ------------------


def _retry_transient(res, fi, install):
    install("unit.tr:fail:2")
    calls = []
    pol = res.RetryPolicy(max_attempts=4, base_delay=0.001, max_delay=0.002,
                          deadline=5.0)

    def op():
        calls.append(1)
        fi.fault_point("unit.tr")
        return 42

    return {"result": pol.call(op), "calls": len(calls)}


def _deadline_budget(res, fi, install):
    install("unit.dl:fail:1000")
    pol = res.RetryPolicy(max_attempts=1000, base_delay=0.05, max_delay=0.05,
                          deadline=0.15)
    t0 = time.monotonic()
    with pytest.raises(res.RetryBudgetExceeded):
        pol.call(lambda: fi.fault_point("unit.dl"))
    return {"fast": time.monotonic() - t0 < 2.0}


def _breaker_cycle(res, fi, install):
    clock = _FakeClock()
    br = res.CircuitBreaker("unit:endpoint", failure_threshold=2,
                            reset_timeout=10.0, clock=clock)
    pol = res.RetryPolicy(max_attempts=1, base_delay=0.0, deadline=5.0)
    install("unit.br:fail:3")

    def op():
        fi.fault_point("unit.br")
        return "ok"

    states = []
    for _ in range(2):
        with pytest.raises(ConnectionError):
            pol.call(op, breaker=br)
    states.append(br.state)
    with pytest.raises(res.CircuitOpenError) as ei:
        pol.call(op, breaker=br)
    retry_after = ei.value.retry_after
    clock.advance(10.0)
    states.append(br.state)
    with pytest.raises(ConnectionError):
        pol.call(op, breaker=br)
    states.append(br.state)
    clock.advance(10.0)
    result = pol.call(op, breaker=br)
    states.append(br.state)
    return {"states": states, "retryAfter": retry_after, "result": result,
            "snapshot": br.snapshot()}


def _app_errors(res, fi, install):
    br = res.CircuitBreaker("unit:app-errors", failure_threshold=2,
                            reset_timeout=10.0)
    pol = res.RetryPolicy(max_attempts=3, base_delay=0.0, deadline=5.0)

    def miss():
        raise urllib.error.HTTPError("http://x", 404, "not found", {},
                                     io.BytesIO(b""))

    for _ in range(5):
        with pytest.raises(urllib.error.HTTPError):
            pol.call(miss, breaker=br)
    return {"snapshot": br.snapshot(),
            "retryable": [res.is_retryable(e) for e in (
                ConnectionRefusedError(), TimeoutError(),
                urllib.error.HTTPError("http://x", 503, "", {}, None),
                urllib.error.HTTPError("http://x", 400, "", {}, None),
                res.CircuitOpenError("x", 1.0), ValueError())]}


def _props(res, fi, install):
    props = {"RETRY_ATTEMPTS": "7", "RETRY_BASE": "0.2", "RETRY_MAX": "x",
             "BREAKER_THRESHOLD": "2", "BREAKER_RESET": "1.5"}
    pol = res.policy_from_props(props)
    br = res.breaker_from_props(props, "unit:props")
    return {"policy": (pol.max_attempts, pol.base_delay, pol.max_delay,
                       pol.deadline),
            "breaker": (br.failure_threshold, br.reset_timeout),
            "float": res.prop_float({"A": "nan?"}, "A", 3.0)}


@pytest.mark.parametrize("scenario", [_retry_transient, _deadline_budget,
                                      _breaker_cycle, _app_errors, _props],
                         ids=lambda f: f.__name__[1:])
def test_policy_and_breaker_match_reference(scenario, fault_spec):
    """Same script, same outcome: call counts, breaker states and every
    counter of the snapshot are equal across the packages."""
    out = {name: scenario(res, fi, fault_spec)
           for name, (res, fi) in PKGS.items()}
    assert out["port"] == out["ref"]


# -- the port's storage stack ------------------------------------------------


def _backing():
    return Storage({f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
                    for r in ("METADATA", "EVENTDATA", "MODELDATA")}
                   | {"PIO_STORAGE_SOURCES_S_TYPE": "MEMORY"})


def _http_env(port: int) -> dict:
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "NET"
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_NET_TYPE": "HTTP",
        "PIO_STORAGE_SOURCES_NET_HOSTS": "127.0.0.1",
        "PIO_STORAGE_SOURCES_NET_PORTS": str(port),
        # tiny backoff floors keep the chaos fast
        "PIO_STORAGE_SOURCES_NET_RETRY_ATTEMPTS": "3",
        "PIO_STORAGE_SOURCES_NET_RETRY_BASE": "0.01",
        "PIO_STORAGE_SOURCES_NET_RETRY_MAX": "0.05",
        "PIO_STORAGE_SOURCES_NET_RETRY_DEADLINE": "5",
        "PIO_STORAGE_SOURCES_NET_BREAKER_THRESHOLD": "3",
        "PIO_STORAGE_SOURCES_NET_BREAKER_RESET": "5",
        "PIO_STORAGE_SOURCES_NET_CONNECT_DEADLINE": "1",
    }


def _seed_event_app(backing):
    app_id = backing.get_meta_data_apps().insert(App(0, "chaosapp"))
    key = backing.get_meta_data_access_keys().insert(AccessKey("", app_id, ()))
    backing.get_l_events().init(app_id)
    return app_id, key


class _Served:
    """A port storage server over ``backing`` on ``port`` (0: free)."""

    def __init__(self, backing, port=0):
        self.srv = StorageServer(backing, "127.0.0.1", port)
        self.port = self.srv.start()[1]

    def stop(self):
        self.srv.stop()


@pytest.mark.parametrize("stype", ["HTTP", "PGSQL", "MYSQL"])
def test_dead_network_store_raises_storage_error(stype):
    """No fallback: an unreachable store raises StorageError naming the
    source and the refused connection."""
    port = ts.free_port()
    props = ({"HOSTS": "127.0.0.1", "PORTS": str(port),
              "CONNECT_DEADLINE": "0.3"} if stype == "HTTP" else
             {"HOST": "127.0.0.1", "PORT": str(port), "USERNAME": "pio",
              "PASSWORD": "x"})
    env = {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "X"
           for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_X_TYPE": stype} | {
        f"PIO_STORAGE_SOURCES_X_{k}": v for k, v in props.items()}
    with pytest.raises(StorageError) as err:
        Storage(env).get_l_events()
    msg = str(err.value).lower()
    assert "cannot be opened" in msg
    assert "refused" in msg or "unreachable" in msg or "connect" in msg


@pytest.mark.parametrize("stype", ["PGSQL", "MYSQL"])
def test_wrong_password_raises_storage_error(stype):
    if stype == "PGSQL":
        from pg_mock import MockPGServer as Mock
    else:
        from mysql_mock import MockMySQLServer as Mock
    with Mock(user="pio", password="rightpw") as srv:
        env = {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "DB"
               for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
            "PIO_STORAGE_SOURCES_DB_TYPE": stype,
            "PIO_STORAGE_SOURCES_DB_HOST": "127.0.0.1",
            "PIO_STORAGE_SOURCES_DB_PORT": str(srv.port),
            "PIO_STORAGE_SOURCES_DB_USERNAME": "pio",
            "PIO_STORAGE_SOURCES_DB_PASSWORD": "wrongpw"}
        with pytest.raises(StorageError) as err:
            Storage(env).get_meta_data_apps()
    msg = str(err.value).lower()
    assert "authentication" in msg or "access denied" in msg


def test_two_transient_faults_retry_write_and_read_through(fault_spec):
    backing = _backing()
    app_id, key = _seed_event_app(backing)
    store = _Served(backing)
    es = EventServer(Storage(_http_env(store.port)), "127.0.0.1", 0)
    base = "http://%s:%d" % es.start()
    try:
        body = {"event": "buy", "entityType": "user", "entityId": "u1"}
        path = f"/events.json?accessKey={key}"
        assert ts.call(base, "POST", path, body)[0] == 201  # key cached
        fault_spec("http.call:fail:2")
        code, doc, _ = ts.call(base, "POST", path, body)
        assert code == 201, doc
        fault_spec("http.call:fail:2")
        got = es.storage.get_l_events().get(doc["eventId"], app_id)
        assert got is not None and got.event == "buy"
        assert es.storage.breaker_states()["NET"][0]["state"] == "closed"
    finally:
        es.stop()
        store.stop()


def test_breaker_opens_and_event_server_sheds_503(fault_spec):
    backing = _backing()
    _app_id, key = _seed_event_app(backing)
    store = _Served(backing)
    client = Storage(_http_env(store.port))
    es = EventServer(client, "127.0.0.1", 0)
    base = "http://%s:%d" % es.start()
    try:
        body = {"event": "buy", "entityType": "user", "entityId": "u1"}
        path = f"/events.json?accessKey={key}"
        assert ts.call(base, "POST", path, body)[0] == 201
        fault_spec("http.call:fail:100000")
        shed = None
        for _ in range(8):
            code, doc, headers = ts.call(base, "POST", path, body)
            if code == 503:
                shed = (doc, headers)
                break
            assert code == 500, doc  # retries exhausted before the trip
        assert shed is not None, "the breaker never opened"
        doc, headers = shed
        reset = 5.0  # BREAKER_RESET
        assert 1 <= int(headers["Retry-After"]) <= 2 * reset + 1
        assert doc["message"] == ("event store temporarily unavailable "
                                  f"(http:http://127.0.0.1:{store.port}); "
                                  "retry later")
        states = client.breaker_states()["NET"]
        assert states[0]["state"] == "open" and states[0]["opened"] >= 1
        assert ts.call(base, "GET", "/")[1]["shedRequests"] >= 1
    finally:
        es.stop()
        store.stop()


def test_readyz_names_open_breaker_until_it_closes():
    """A dead store opens the engine server's storage breaker (a reload
    reaches it); /readyz answers 503 naming it, and 200 again once the
    restarted store answers the half-open probe."""
    backing = ts.memory_storage()
    ts.seed_ratings(backing)
    store = _Served(backing)
    env = _http_env(store.port) | {
        "PIO_STORAGE_SOURCES_NET_RETRY_ATTEMPTS": "1",
        "PIO_STORAGE_SOURCES_NET_BREAKER_THRESHOLD": "1",
        "PIO_STORAGE_SOURCES_NET_BREAKER_RESET": "0.5"}
    client = Storage(env)
    ts.train(client)
    server = EngineServer(RecommendationEngine()(), engine_factory_name="rec",
                          storage=client, device="cpu")
    port = store.port
    with ts.serving(server) as base:
        code, doc, _ = ts.call(base, "GET", "/readyz")
        assert code == 200 and doc["openBreakers"] == []
        store.stop()
        ts.call(base, "GET", "/reload")  # reaches the dead store
        code, doc, _ = ts.call(base, "GET", "/readyz")
        name = f"http:http://127.0.0.1:{port}"
        assert code == 503 and doc["openBreakers"] == [name]
        assert doc["modelLoaded"] is True and doc["ready"] is False
        store = _Served(backing, port)
        time.sleep(0.6)  # the reset time passes: half-open
        ts.call(base, "GET", "/reload")  # the probe succeeds
        code, doc, _ = ts.call(base, "GET", "/readyz")
        assert code == 200 and doc["openBreakers"] == []
    store.stop()


def test_scan_stream_resumes_after_mid_stream_drop(fault_spec):
    import datetime as dt

    from incubator_predictionio_torch.data.storage import DataMap, Event

    backing = _backing()
    app_id, _key = _seed_event_app(backing)
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    backing.get_l_events().insert_batch(
        [Event("view", "user", f"u{i}", None, None, DataMap({"i": i}),
               t0 + dt.timedelta(seconds=i)) for i in range(25)], app_id)
    store = _Served(backing)
    try:
        client = Storage(_http_env(store.port))
        fault_spec("http.stream:drop:1:10")
        ids = [e.properties.get("i")
               for e in client.get_l_events().find(app_id)]
        assert ids == list(range(25))
    finally:
        store.stop()


def test_http_client_survives_storage_bind_race():
    backing = _backing()
    _seed_event_app(backing)
    port = ts.free_port()
    holder = {}

    def late_bind():
        time.sleep(0.5)
        holder["srv"] = _Served(backing, port)

    th = threading.Thread(target=late_bind)
    th.start()
    try:
        t0 = time.monotonic()
        client = Storage(_http_env(port) | {
            "PIO_STORAGE_SOURCES_NET_CONNECT_DEADLINE": "5"})
        apps = client.get_meta_data_apps().get_all()
        assert time.monotonic() - t0 >= 0.4
        assert [a.name for a in apps] == ["chaosapp"]
        snap = client.breaker_states()["NET"][0]
        assert snap["state"] == "closed" and snap["consecutiveFailures"] == 0
    finally:
        th.join()
        if "srv" in holder:
            holder["srv"].stop()


def test_train_on_dead_store_fails_loudly_and_aborts():
    """The store dies after the client opened it: the train raises a
    storage error (not a hang, not an empty model) and no COMPLETED
    instance lands."""
    backing = ts.memory_storage()
    ts.seed_ratings(backing)
    store = _Served(backing)
    port = store.port
    client = Storage(_http_env(port))
    assert client.get_meta_data_apps().get_by_name("testapp")
    store.stop()
    with pytest.raises(Exception) as err:
        ts.train(client)
    msg = str(err.value).lower()
    assert "storage" in msg or "connect" in msg or "circuit" in msg
    assert [i.status for i in
            backing.get_meta_data_engine_instances().get_all()
            if i.status == "COMPLETED"] == []


def test_reload_under_query_traffic_over_http_store():
    backing = ts.memory_storage()
    ts.seed_ratings(backing)
    store = _Served(backing)
    client = Storage(_http_env(store.port))
    ts.train(client)
    server = EngineServer(RecommendationEngine()(), engine_factory_name="rec",
                          storage=client, device="cpu")
    stop = threading.Event()
    failures, ok = [], [0]
    with ts.serving(server) as base:
        def hammer():
            while not stop.is_set():
                code, doc, _ = ts.query(base, {"user": "1", "num": 3})
                if code != 200 or not doc["itemScores"]:
                    failures.append((code, doc))
                    return
                ok[0] += 1

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            for _ in range(2):
                ts.train(client)
                assert ts.call(base, "GET", "/reload")[0] == 200
        finally:
            stop.set()
            for t in threads:
                t.join(30)
    store.stop()
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:3]
    assert ok[0] > 5


def test_no_raw_urlopen_outside_resilient_transport():
    """Every call of ``urlopen`` in the port's storage layer goes through
    ``resilience.resilient_urlopen`` or the HTTP transport's stream."""
    import incubator_predictionio_torch.data.storage as pkg

    root = os.path.dirname(pkg.__file__)
    offenders = []
    for name in sorted(os.listdir(root)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(root, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute) and node.attr == "urlopen"
                    and not (name == "http_backend.py")):
                offenders.append(f"{name}:{node.lineno}")
            if (isinstance(node, ast.Attribute) and node.attr == "urlopen"
                    and name == "http_backend.py"
                    and node.lineno not in _stream_lines(tree)):
                offenders.append(f"{name}:{node.lineno}")
    assert offenders == []


def _stream_lines(tree) -> set:
    """Line span of ``_Transport._stream_once`` (the stream's own retry
    loop in ``_Transport.stream`` owns its breaker accounting)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_stream_once":
            return set(range(node.lineno, node.end_lineno + 1))
    return set()


def test_pio_status_prints_breaker_lines(capsys, monkeypatch, tmp_path):
    from incubator_predictionio_torch.data.storage.registry import (
        Storage as Registry,
    )
    from incubator_predictionio_torch.tools.commands import management

    backing = _backing()
    store = _Served(backing)
    try:
        client = Storage(_http_env(store.port))
        monkeypatch.setattr(Registry, "instance", classmethod(
            lambda cls: client))
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
        management.status_cmd([])
        out = capsys.readouterr().out
    finally:
        store.stop()
    assert (f"breaker http:http://127.0.0.1:{store.port} is closed"
            in out)
