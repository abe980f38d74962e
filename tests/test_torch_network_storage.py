"""The port's network stores on the CPU, held against the reference's.

- **Shared stores, both ways.** One PostgreSQL (``tests/pg_mock.py``) or
  MySQL (``tests/mysql_mock.py``) server, or one storage server over
  SQLite (the reference's aiohttp ``pio storageserver`` or the port's
  ``http.server`` one), is written through one package's ``Storage`` and
  read through the other's: every row equal, the model blob byte-equal,
  and ``PEventStore.find_ratings`` identical (triples and id maps). The
  port's HTTP client talks to the reference's server and the reference's
  client to the port's.
- **Wire goldens.** The port's ``pgwire`` and ``mysqlwire`` replay
  ``tests/test_wire_golden.py``'s conversations and send the bytes of
  ``tests/fixtures/{pg,mysql}_wire_golden.hex`` exactly (the fixtures are
  read, never written).
- **``pio storageserver``** of the port: a subprocess over SQLite serves
  the port's HTTP client; the bearer token is enforced; a non-loopback
  bind without a secret and a node whose own store is HTTP are refused.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import test_torch_storage as store_cases  # noqa: E402
import test_wire_golden as golden  # noqa: E402
import torch_serving as ts  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.store.p_event_store import (  # noqa: E402
    PEventStore as RefPEventStore,
)
from incubator_predictionio_torch.data import storage as port_storage  # noqa: E402
from incubator_predictionio_torch.data.store import PEventStore  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": ref_storage, "port": port_storage}
RATINGS_KW = dict(event_names=["rate", "buy"],
                  event_default_ratings={"buy": 4.0})


def _env(name, stype, props):
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": name
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        f"PIO_STORAGE_SOURCES_{name}_TYPE": stype} | {
        f"PIO_STORAGE_SOURCES_{name}_{k}": v for k, v in props.items()}


class _Topology:
    """One shared network store: ``env`` opens it from either package."""

    def __init__(self, kind, tmp_path):
        self.kind = kind
        self._stop = []
        if kind in ("pgsql", "mysql"):
            if kind == "pgsql":
                from pg_mock import MockPGServer as Mock
            else:
                from mysql_mock import MockMySQLServer as Mock
            srv = Mock(user="pio", password="piosecret").__enter__()
            self._stop.append(lambda: srv.__exit__(None, None, None))
            self.env = _env("DB", kind.upper(), {
                "HOST": "127.0.0.1", "PORT": str(srv.port),
                "USERNAME": "pio", "PASSWORD": "piosecret"})
            return
        sqlite_env = _env("B", "SQLITE",
                          {"PATH": str(tmp_path / "backing.sqlite")})
        if kind == "http-port-server":
            from incubator_predictionio_torch.data.api.storage_server import (
                StorageServer,
            )

            backing = port_storage.Storage(sqlite_env)
            srv = StorageServer(backing, "127.0.0.1", 0, secret="tok")
            port = srv.start()[1]
            self._stop += [srv.stop, backing.close]
        else:
            from incubator_predictionio_tpu.data.api.storage_server import (
                build_app,
            )
            from server_utils import ServerThread

            backing = ref_storage.Storage(sqlite_env)
            st = ServerThread(build_app(backing, secret="tok")).__enter__()
            port = st.port
            self._stop += [lambda: st.__exit__(None, None, None),
                           backing.close]
        self.env = _env("NET", "HTTP", {"HOSTS": "127.0.0.1",
                                        "PORTS": str(port), "SECRET": "tok"})

    def close(self):
        for fn in self._stop:
            fn()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["pgsql", "mysql", "http-port-server",
                                  "http-ref-server"])
def test_network_store_shared_by_both_packages(kind, writer, tmp_path):
    topo = _Topology(kind, tmp_path)
    try:
        reader = "port" if writer == "jax" else "jax"
        w = PKGS[writer].Storage(topo.env)
        app_id, cid = store_cases._write_store(PKGS[writer], w)
        w.close()
        rows, triples = {}, {}
        for name in (writer, reader):
            s = PKGS[name].Storage(topo.env)
            rows[name] = store_cases._rows(PKGS[name], s, app_id, cid)
            finder = RefPEventStore if name == "jax" else PEventStore
            triples[name] = finder.find_ratings("shared", storage=s,
                                                **RATINGS_KW)
            s.close()
    finally:
        topo.close()
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


def _golden_text(name):
    with open(os.path.join(golden.FIXTURES, name)) as f:
        return f.read()


def _rendered(streams):
    return "\n".join(f"# connection {i}\n{s.hex()}"
                     for i, s in enumerate(streams)) + "\n"


def test_pgwire_sends_the_golden_bytes(monkeypatch):
    from pg_mock import MockPGServer

    from incubator_predictionio_torch.data.storage import pgwire

    with MockPGServer(user="pio", password="piosecret") as srv:
        def conversation():
            c = pgwire.PGConnection("127.0.0.1", srv.port, "pio",
                                    "piosecret", "pio")
            c.query("CREATE TABLE IF NOT EXISTS g "
                    "(id BIGINT PRIMARY KEY, name TEXT, blob BYTEA)")
            c.query("INSERT INTO g (id, name, blob) VALUES ($1, $2, $3)",
                    (1, "alpha", b"\x00\xffbytes"))
            c.query("INSERT INTO g (id, name, blob) VALUES ($1, $2, $3)",
                    (2, "beta", b""))
            c.query("SELECT id, name FROM g WHERE id >= $1 ORDER BY id",
                    (1,))
            for _row in c.query_stream("SELECT id FROM g ORDER BY id",
                                       fetch_size=1):
                pass
            c.close()

        streams = golden._record(monkeypatch, pgwire, conversation)
    assert _rendered(streams) == _golden_text("pg_wire_golden.hex")


def test_mysqlwire_sends_the_golden_bytes(monkeypatch):
    from mysql_mock import MockMySQLServer

    from incubator_predictionio_torch.data.storage import mysqlwire

    with MockMySQLServer(user="pio", password="piosecret") as srv:
        def conversation():
            c = mysqlwire.MySQLConnection("127.0.0.1", srv.port, "pio",
                                          "piosecret", "pio")
            c.query("CREATE TABLE IF NOT EXISTS g "
                    "(id BIGINT PRIMARY KEY, name LONGTEXT, blob LONGBLOB)")
            c.query("INSERT INTO g (id, name, blob) VALUES ($1, $2, $3)",
                    (1, "alpha", b"\x00\xffbytes"))
            c.query("SELECT id, name FROM g WHERE id >= $1 ORDER BY id",
                    (1,))
            c.close()

        streams = golden._record(monkeypatch, mysqlwire, conversation)
    assert _rendered(streams) == _golden_text("mysql_wire_golden.hex")


@pytest.mark.parametrize("request_line,headers,status", [
    ("PUT /models/pio/m", "", 401),
    ("PUT /models/pio/m", "Authorization: Bearer wrong\r\n", 401),
    ("GET /health", "", 200),
], ids=["no-token", "wrong-token", "health"])
def test_storage_server_answers_before_reading_the_body(
        request_line, headers, status, tmp_path):
    """A 401 (and /health) is answered from the headers alone: a request
    that announces an 8 GiB body without sending it gets its answer and
    a closed connection, so an unauthenticated upload is never buffered
    and the unread body is never parsed as a next request."""
    import socket

    from incubator_predictionio_torch.data.api.storage_server import (
        StorageServer,
    )

    backing = port_storage.Storage(
        _env("B", "SQLITE", {"PATH": str(tmp_path / "b.sqlite")}))
    srv = StorageServer(backing, "127.0.0.1", 0, secret="tok")
    port = srv.start()[1]
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(f"{request_line} HTTP/1.1\r\nHost: x\r\n{headers}"
                      f"Content-Length: {1 << 33}\r\n\r\n".encode())
            data = b""
            while chunk := s.recv(65536):  # EOF: the server closed
                data += chunk
        head = data.split(b"\r\n\r\n", 1)[0].lower()
        assert head.startswith(f"http/1.1 {status}".encode())
        assert b"connection: close" in head
        assert backing.get_model_data_models().get("m") is None
    finally:
        srv.stop()
        backing.close()


def _console(args, env, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
         *args], env=env, cwd=ROOT, **kw)


def _clean_env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_STORAGE_", "PIO_SSL_"))}
    env["PIO_FS_BASEDIR"] = str(tmp_path / "base")
    env.update(extra)
    return env


def test_storageserver_verb_serves_the_http_client(tmp_path):
    port = ts.free_port()
    env = _clean_env(tmp_path, PIO_STORAGESERVER_SECRET="tok")
    proc = _console(["storageserver", "--port", str(port)], env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().startswith(
            f"[info] Storage server running on http://127.0.0.1:{port}")
        client_env = _env("NET", "HTTP", {"HOSTS": "127.0.0.1",
                                          "PORTS": str(port),
                                          "SECRET": "tok"})
        s = port_storage.Storage(client_env)
        app_id = s.get_meta_data_apps().insert(port_storage.App(0, "a"))
        s.get_model_data_models().insert(port_storage.Model("m", b"\x01"))
        assert s.get_model_data_models().get("m").models == b"\x01"
        bad = port_storage.Storage(client_env | {
            "PIO_STORAGE_SOURCES_NET_SECRET": "wrong"})
        with pytest.raises(Exception, match="401"):
            bad.get_meta_data_apps().get(app_id)
    finally:
        proc.terminate()
        proc.wait(10)
    assert proc.returncode == 0  # SIGTERM stops it cleanly
    assert (tmp_path / "base" / "pio.sqlite").is_file()


def test_storageserver_verb_refusals(tmp_path):
    env = _clean_env(tmp_path)
    proc = _console(["storageserver", "--ip", "0.0.0.0", "--port", "0"], env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0 and "shared secret" in err
    env = _clean_env(tmp_path, **_env("NET", "HTTP", {
        "HOSTS": "127.0.0.1", "PORTS": "1"}))
    proc = _console(["storageserver"], env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 1 and "proxy in a loop" in err
