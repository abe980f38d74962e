"""TLS on the port's servers (``common/ssl_config.py``), on the CPU.

With ``PIO_SSL_CERTFILE`` and ``PIO_SSL_KEYFILE`` set to the throwaway
pair under ``tests/fixtures/torch_tls/``, the reference serves HTTPS from
its engine server, event server, dashboard and storage server
(``incubator_predictionio_tpu/common/ssl_config.py``). Each of the port's
servers must do the same: answer HTTPS to a client that trusts the
certificate, refuse plaintext, and stop at start-up on a missing or bad
file (the reference's ``load_cert_chain`` raises there). A silent client
holds only its own connection (the handshake runs in the connection's
thread), and the engine server's drain still answers a query in flight
over TLS. Answers over HTTPS equal the reference's over HTTPS.
"""

import http.client
import json
import os
import socket
import ssl
import threading
import time

import pytest

pytest.importorskip("torch")

import torch_serving as ts  # noqa: E402
from incubator_predictionio_torch.data.api.event_server import EventServer  # noqa: E402
from incubator_predictionio_torch.data.api.storage_server import StorageServer  # noqa: E402
from incubator_predictionio_torch.data.storage import AccessKey, App  # noqa: E402
from incubator_predictionio_torch.models.recommendation import (  # noqa: E402
    RecommendationEngine,
)
from incubator_predictionio_torch.tools.dashboard import Dashboard  # noqa: E402
from incubator_predictionio_torch.workflow.create_server import EngineServer  # noqa: E402

TLS_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "torch_tls")
CERT = os.path.join(TLS_DIR, "cert.pem")
KEY = os.path.join(TLS_DIR, "key.pem")


@pytest.fixture()
def tls_env(monkeypatch):
    monkeypatch.setenv("PIO_SSL_CERTFILE", CERT)
    monkeypatch.setenv("PIO_SSL_KEYFILE", KEY)


def https(port, method, path, body=None, headers=None):
    """One request over HTTPS to 127.0.0.1 trusting only the fixture
    certificate → (status, body bytes, headers)."""
    ctx = ssl.create_default_context(cafile=CERT)
    conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=30,
                                       context=ctx)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


def plaintext_refused(port) -> bool:
    """A plain HTTP request to the TLS port gets no HTTP answer."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/")
        conn.getresponse().read()
    except (http.client.HTTPException, OSError):
        return True
    finally:
        conn.close()
    return False


def _engine(storage):
    return EngineServer(RecommendationEngine()(), engine_factory_name="rec",
                        storage=storage, device="cpu")


def _start(kind, storage):
    """(server, port, readiness path) of one of the port's servers."""
    if kind == "engine":
        srv = _engine(storage)
        return srv, srv.start("127.0.0.1", 0)[1], "/readyz"
    if kind == "event":
        srv = EventServer(storage, "127.0.0.1", 0)
        return srv, srv.start()[1], "/"
    if kind == "dashboard":
        srv = Dashboard(storage, "127.0.0.1", 0)
        return srv, srv.start()[1], "/instances.json"
    srv = StorageServer(storage, "127.0.0.1", 0)
    return srv, srv.start()[1], "/health"


@pytest.fixture()
def trained():
    storage = ts.memory_storage()
    ts.seed_ratings(storage)
    ts.train(storage)
    return storage


@pytest.mark.parametrize("kind", ["engine", "event", "dashboard", "storage"])
def test_server_answers_https_only(kind, tls_env, trained):
    """Repairs F8: the port read the TLS knobs only to refuse a fleet, so
    every single-process server answered plaintext under a configuration
    that asked for HTTPS."""
    srv, port, path = _start(kind, trained)
    try:
        code, body, _ = https(port, "GET", path)
        assert code == 200, body
        assert plaintext_refused(port)
        # keep-alive over TLS: several requests on one connection
        ctx = ssl.create_default_context(cafile=CERT)
        conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=30,
                                           context=ctx)
        for _ in range(3):
            conn.request("GET", path)
            r = conn.getresponse()
            assert r.status == 200
            r.read()
        conn.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("kind", ["engine", "event", "dashboard", "storage"])
@pytest.mark.parametrize("fault", ["missing", "garbage"])
def test_bad_tls_file_stops_startup(kind, fault, monkeypatch, tmp_path,
                                    trained):
    if fault == "missing":
        cert = str(tmp_path / "nope.pem")
    else:
        cert = str(tmp_path / "garbage.pem")
        with open(cert, "w") as f:
            f.write("-----BEGIN CERTIFICATE-----\nnot a cert\n")
    monkeypatch.setenv("PIO_SSL_CERTFILE", cert)
    monkeypatch.setenv("PIO_SSL_KEYFILE", KEY)
    with pytest.raises((OSError, ssl.SSLError)):
        srv, _port, _path = _start(kind, trained)
        srv.stop()


def test_engine_answers_over_https_equal_plaintext(trained, monkeypatch):
    """The same model answers the same over HTTPS and plaintext, and the
    latency probe reaches a TLS server (https scheme)."""
    queries = [{"user": str(u), "num": 4} for u in range(6)]
    plain = _engine(trained)
    with ts.serving(plain) as base:
        want = [ts.query(base, q)[1] for q in queries]
    monkeypatch.setenv("PIO_SSL_CERTFILE", CERT)
    monkeypatch.setenv("PIO_SSL_KEYFILE", KEY)
    srv = _engine(trained)
    port = srv.start("127.0.0.1", 0)[1]
    try:
        got = [json.loads(https(port, "POST", "/queries.json",
                                json.dumps(q).encode())[1])
               for q in queries]
        probe = srv.probe_and_record(f"https://127.0.0.1:{port}", n=5)
    finally:
        srv.stop()
    assert got == want
    assert probe is not None and probe["http_p50_ms"] > 0


def test_silent_client_does_not_stall_accept(tls_env, trained):
    """A client that connects and never sends a ClientHello holds its own
    connection thread only: other clients are served meanwhile."""
    srv, port, path = _start("event", trained)
    silent = socket.create_connection(("127.0.0.1", port))
    try:
        t0 = time.monotonic()
        assert https(port, "GET", path)[0] == 200
        assert time.monotonic() - t0 < 5.0
    finally:
        silent.close()
        srv.stop()


def test_drain_answers_inflight_query_over_tls(tls_env):
    storage = ts.memory_storage()
    ts.train_lifecycle(storage, "one")
    srv = EngineServer(ts.lifecycle_engine(), engine_factory_name="lifecycle",
                       storage=storage, device="cpu", query_conc=2,
                       query_deadline_ms=20_000, drain_deadline_ms=10_000)
    port = srv.start("127.0.0.1", 0)[1]
    out = {}
    t = threading.Thread(target=lambda: out.update(r=https(
        port, "POST", "/queries.json",
        json.dumps({"user": "u1", "sleepS": 1.0}).encode())))
    try:
        t.start()
        assert ts.wait_for(lambda: json.loads(https(
            port, "GET", "/status")[1])["overload"]["pending"] == 1, 5)
        code, body, _ = https(port, "POST", "/stop")
        assert json.loads(body)["message"] == "Shutting down."
        assert https(port, "GET", "/readyz")[0] == 503
        t.join(15)
        assert not t.is_alive()
    finally:
        srv.stop()
    code, body, _ = out["r"]
    assert code == 200 and json.loads(body)["tag"] == "one"


def _TLSServerThread(app, ctx):
    """tests/server_utils.py's ServerThread serving ``app`` over TLS."""
    import asyncio

    from aiohttp import web
    from server_utils import ServerThread

    class _Thread(ServerThread):
        def _run(self):
            asyncio.set_event_loop(self._loop)

            async def main():
                self._stop = asyncio.Event()
                runner = web.AppRunner(self.app)
                await runner.setup()
                await web.TCPSite(runner, "127.0.0.1", self.port,
                                  ssl_context=ctx).start()
                self._started.set()
                await self._stop.wait()
                await runner.cleanup()

            self._loop.run_until_complete(main())

    return _Thread(app)


def test_event_server_https_matches_reference(tls_env, memory_storage):
    """The reference's event server and the port's, both over HTTPS with
    the fixture pair, give the same status and body shape to one POST
    and one GET."""
    from incubator_predictionio_tpu.data.api.event_server import (
        EventServer as RefEventServer,
    )
    from incubator_predictionio_tpu.data.storage import (
        AccessKey as RefAccessKey, App as RefApp,
    )
    ref_app = memory_storage.get_meta_data_apps().insert(RefApp(0, "a"))
    ref_key = memory_storage.get_meta_data_access_keys().insert(
        RefAccessKey("", ref_app, ()))
    memory_storage.get_l_events().init(ref_app)
    port_store = ts.memory_storage()
    app = port_store.get_meta_data_apps().insert(App(0, "a"))
    key = port_store.get_meta_data_access_keys().insert(AccessKey("", app, ()))
    port_store.get_l_events().init(app)
    body = json.dumps({"event": "buy", "entityType": "user",
                       "entityId": "u1", "eventTime":
                       "2024-01-01T00:00:00.000Z"}).encode()
    from incubator_predictionio_tpu.common.ssl_config import (
        ssl_context_from_env,
    )

    ref = RefEventServer(memory_storage)
    with _TLSServerThread(ref.app, ssl_context_from_env()) as st:
        ref_port = st.port
        ref_post = https(ref_port, "POST", f"/events.json?accessKey={ref_key}",
                         body)
        ref_get = https(ref_port, "GET", f"/events.json?accessKey={ref_key}")
    srv = EventServer(port_store, "127.0.0.1", 0)
    port = srv.start()[1]
    try:
        got_post = https(port, "POST", f"/events.json?accessKey={key}", body)
        got_get = https(port, "GET", f"/events.json?accessKey={key}")
    finally:
        srv.stop()
    assert got_post[0] == ref_post[0] == 201
    assert set(json.loads(got_post[1])) == set(json.loads(ref_post[1]))
    assert got_get[0] == ref_get[0] == 200
    strip = [{k: v for k, v in e.items() if k not in ("eventId",
                                                      "creationTime")}
             for e in json.loads(ref_get[1])]
    assert [{k: v for k, v in e.items() if k not in ("eventId",
                                                     "creationTime")}
            for e in json.loads(got_get[1])] == strip
