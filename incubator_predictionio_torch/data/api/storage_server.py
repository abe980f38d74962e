"""Storage server — this node's DAO surface over HTTP (``pio storageserver``).

Port of ``incubator_predictionio_tpu/data/api/storage_server.py`` on the
standard library's ``http.server.ThreadingHTTPServer`` (one thread per
connection) in place of aiohttp, with the reference's routes, JSON bodies
and status codes, so either package's ``TYPE=HTTP`` client
(``data/storage/http_backend.py``) talks to either package's server:

    GET    /health                        → 200 {"status": "ok"}
    POST   /rpc/<dao>/<method>            → 200 {"result": ...}
                                             | 4xx/5xx {"error": ...}
    POST   /rpc/l_events/find (p_events)  → chunked NDJSON event stream
    PUT    /models/<namespace>/<id>       → 200 {"result": true}
    GET    /models/<namespace>/<id>       → the raw blob | 404
    DELETE /models/<namespace>/<id>       → 200 {"result": true}

Auth: with a shared secret every route but ``/health`` needs
``Authorization: Bearer <secret>`` (401 otherwise). A non-loopback bind
without a secret is refused. TLS with ``PIO_SSL_CERTFILE`` and
``PIO_SSL_KEYFILE`` (``common/ssl_config.py``).

``find`` streams: the first slab of 500 events is pulled before the status
line goes out, so a bad argument or a backend error answers a clean 500;
a later failure is written in-band as one ``{"__error__": ...}`` line (the
client raises on it). The stream is HTTP/1.1 chunked transfer coding,
written by hand (``http.server`` has no streaming response).
"""

from __future__ import annotations

import hmac
import itertools
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import unquote, urlsplit

from ...common import envknobs
from ...common.ssl_config import TLSServerMixin, ssl_context_from_env
from ..storage import http_backend as codec
from ..storage.base import Model
from ..storage.event import Event, EventValidationError
from ..storage.registry import Storage

log = logging.getLogger("pio.torch.storageserver")

#: request bodies past this are refused (model blobs can run to GBs: the
#: reference's cap, 8 GiB)
MAX_BODY = 1 << 33

#: events per NDJSON slab of a find stream
STREAM_SLAB = 500

# dao name → (repository, client accessor attribute)
_DAO_ROUTES = {
    "apps": ("METADATA", "apps"),
    "access_keys": ("METADATA", "access_keys"),
    "channels": ("METADATA", "channels"),
    "engine_instances": ("METADATA", "engine_instances"),
    "evaluation_instances": ("METADATA", "evaluation_instances"),
    "models": ("MODELDATA", "models"),
    "l_events": ("EVENTDATA", "l_events"),
    "p_events": ("EVENTDATA", "p_events"),
}

# The wire surface per DAO: exactly the methods the HTTP client speaks.
# Anything else 404s (the DAOs carry non-wire methods such as compact).
# Model blobs ride the /models/... routes.
_ALLOWED_METHODS = {
    "apps": {"insert", "get", "get_by_name", "get_all", "update", "delete"},
    "access_keys": {"insert", "get", "get_all", "get_by_appid", "update",
                    "delete"},
    "channels": {"insert", "get", "get_by_appid", "delete"},
    "engine_instances": {"insert", "get", "get_all", "get_latest_completed",
                         "get_completed", "update", "delete"},
    "evaluation_instances": {"insert", "get", "get_all", "get_completed",
                             "update", "delete"},
    "models": set(),  # blob routes only
    "l_events": {"init", "remove", "insert", "insert_batch", "get", "delete",
                 "delete_batch", "find", "aggregate_properties"},
    # aggregate_properties runs server-side: one dict per entity is far
    # smaller on the wire than the $set/$unset/$delete stream it replaces
    "p_events": {"find", "write", "delete", "aggregate_properties"},
}

# record-valued "record" argument decoders, per DAO
_RECORD_FROM = {
    "apps": codec.app_from_json,
    "access_keys": codec.access_key_from_json,
    "channels": codec.channel_from_json,
    "engine_instances": codec.engine_instance_from_json,
    "evaluation_instances": codec.evaluation_instance_from_json,
}
_RESULT_CODECS = {
    "apps": codec.app_to_json,
    "access_keys": codec.access_key_to_json,
    "channels": codec.channel_to_json,
    "engine_instances": codec.engine_instance_to_json,
    "evaluation_instances": codec.evaluation_instance_to_json,
}
_TIME_ARGS = ("start_time", "until_time")


def _dao_for(storage: Storage, dao: str, namespace: str):
    repo, accessor = _DAO_ROUTES[dao]
    client = storage._client(repo)  # same-package registry internal
    return getattr(client, accessor)(namespace)


def _decode_args(dao: str, method: str, args: dict) -> dict:
    out = dict(args)
    if "record" in out and out["record"] is not None:
        out["record"] = _RECORD_FROM[dao](out["record"])
    for t in _TIME_ARGS:
        if out.get(t) is not None:
            out[t] = codec._dt_from_json(out[t])
    if "event" in out and out["event"] is not None:
        out["event"] = Event.from_json(out["event"])
    if "events" in out and out["events"] is not None:
        out["events"] = [Event.from_json(o) for o in out["events"]]
    return out


def _encode_result(dao: str, result):
    if isinstance(result, Event):  # l_events.get
        return result.to_json()
    if dao in ("p_events", "l_events") and isinstance(result, dict):
        # aggregate_properties: {entity_id: PropertyMap}
        return {eid: codec.property_map_to_json(pm)
                for eid, pm in result.items()}
    enc = _RESULT_CODECS.get(dao)
    if enc is None:
        return result
    if isinstance(result, list):
        return [enc(r) for r in result]
    if hasattr(result, "__dataclass_fields__"):
        return enc(result)
    return result


def _positional(dao: str, method: str, args: dict) -> tuple[tuple, dict]:
    """DAO methods take positional-friendly kwargs: the record, the event
    of an insert and the events of a batch go first."""
    args = dict(args)
    if "record" in args:
        return (args.pop("record"),), args
    if "event" in args and method == "insert":
        return (args.pop("event"),), args
    if "events" in args and method in ("insert_batch", "write"):
        return (args.pop("events"),), args
    return (), args


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"
    protocol_version = "HTTP/1.1"
    # one send per answer (headers and body): two small sends meet Nagle's
    # algorithm and the client's delayed ACK
    wbufsize = -1

    # -- plumbing ----------------------------------------------------------
    def _reply(self, status: int, body: bytes,
               ctype: str = "application/json; charset=utf-8") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)
        self.wfile.flush()

    def _json(self, status: int, obj) -> None:
        self._reply(status, json.dumps(obj).encode())

    def _body(self) -> Optional[bytes]:
        """The request body, or None after answering 413 / 400."""
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self.close_connection = True
            self._json(400, {"error": "bad Content-Length"})
            return None
        if length > MAX_BODY:
            self.close_connection = True
            self._json(413, {"error": "request body too large"})
            return None
        return self.rfile.read(length) if length > 0 else b""

    def _authorized(self) -> bool:
        secret = self.server.secret
        if not secret:
            return True
        got = self.headers.get("Authorization", "")
        # bytes operands: compare_digest on str raises for non-ASCII
        return got.startswith("Bearer ") and hmac.compare_digest(
            got[7:].encode("utf-8", "surrogateescape"),
            secret.encode("utf-8", "surrogateescape"))

    def _answer_unread(self, status: int, obj) -> None:
        """Answer without reading the request body. A body left unread
        would be parsed as the next request, so a request that announced
        one ends the connection."""
        if (self.headers.get("Content-Length", "0").strip() not in ("", "0")
                or "Transfer-Encoding" in self.headers):
            self.close_connection = True
        self._json(status, obj)

    def _dispatch(self, method: str) -> None:
        path = urlsplit(self.path).path
        # /health and the auth check come before the body is read: a peer
        # without the secret never gets the server to buffer its upload
        if path == "/health" and method == "GET":
            self._answer_unread(200, {"status": "ok"})
            return
        if not self._authorized():
            self._answer_unread(401, {"error": "unauthorized"})
            return
        raw = self._body()
        if raw is None:
            return
        parts = path.split("/")
        # /rpc/<dao>/<method>
        if len(parts) == 4 and parts[1] == "rpc" and method == "POST":
            self._rpc(unquote(parts[2]), unquote(parts[3]), raw)
            return
        # /models/<namespace>/<id>
        if len(parts) == 4 and parts[1] == "models" and method in (
                "PUT", "GET", "DELETE"):
            self._model(method, unquote(parts[2]), unquote(parts[3]), raw)
            return
        self._json(404, {"error": f"no route {method} {path}"})

    # -- routes --------------------------------------------------------------
    def _rpc(self, dao: str, method: str, raw: bytes) -> None:
        if dao not in _DAO_ROUTES:
            self._json(404, {"error": f"unknown dao {dao!r}"})
            return
        if method not in _ALLOWED_METHODS[dao]:
            self._json(404, {"error": f"unknown method {dao}.{method}"})
            return
        try:
            payload = json.loads(raw)
            namespace = payload.get("namespace") or "pio"
            args = _decode_args(dao, method, payload.get("args") or {})
        except (ValueError, KeyError, AttributeError,
                EventValidationError) as e:
            self._json(400, {"error": str(e)})
            return
        try:
            fn = getattr(_dao_for(self.server.storage(), dao, namespace),
                         method)
        except AttributeError:
            self._json(404, {"error": f"unknown method {dao}.{method}"})
            return
        pos, kw = _positional(dao, method, args)
        if method == "find":
            self._stream(dao, fn, pos, kw)
            return
        try:
            result = fn(*pos, **kw)
        except Exception as e:  # noqa: BLE001 - surfaced to the client
            log.exception("rpc %s.%s failed", dao, method)
            self._json(500, {"error": str(e)})
            return
        self._json(200, {"result": _encode_result(dao, result)})

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

    def _stream(self, dao: str, fn, pos, kw) -> None:
        # find() is a generator: argument and backend errors surface on
        # the first pull, which is made before the status line goes out
        try:
            it = fn(*pos, **kw)
            slab = list(itertools.islice(it, STREAM_SLAB))
        except Exception as e:  # noqa: BLE001 - surfaced to the client
            log.exception("rpc %s.find failed", dao)
            self._json(500, {"error": str(e)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        while slab:
            self._chunk(b"".join(json.dumps(e.to_json()).encode() + b"\n"
                                 for e in slab))
            self.wfile.flush()
            try:
                slab = list(itertools.islice(it, STREAM_SLAB))
            except Exception as e:  # noqa: BLE001 - in-band error line
                log.exception("rpc %s.find failed mid-stream", dao)
                self._chunk(json.dumps({"__error__": str(e)}).encode()
                            + b"\n")
                break
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def _model(self, method: str, namespace: str, model_id: str,
               raw: bytes) -> None:
        try:
            dao = _dao_for(self.server.storage(), "models", namespace)
            if method == "PUT":
                dao.insert(Model(id=model_id, models=raw))
            elif method == "DELETE":
                dao.delete(model_id)
            else:
                m = dao.get(model_id)
                if m is None:
                    self._json(404, {"error": "not found"})
                else:
                    self._reply(200, bytes(m.models),
                                "application/octet-stream")
                return
        except Exception as e:  # noqa: BLE001 - surfaced to the client
            log.exception("model %s %s/%s failed", method, namespace,
                          model_id)
            self._json(500, {"error": str(e)})
            return
        self._json(200, {"result": True})

    def do_GET(self):  # noqa: N802 - http.server's naming
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_PUT(self):  # noqa: N802
        self._dispatch("PUT")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")

    def log_message(self, fmt, *args):  # one line per request is noise
        log.debug("%s - " + fmt, self.address_string(), *args)


class _Server(TLSServerMixin, ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128

    def __init__(self, addr, storage: Optional[Storage],
                 secret: Optional[str]):
        self._storage = storage
        self.secret = secret
        # a bad PIO_SSL_* file raises here, before the socket is bound
        self.ssl_context = ssl_context_from_env()
        super().__init__(addr, _Handler)

    def storage(self) -> Storage:
        return self._storage or Storage.instance()


class StorageServer:
    """The routes over one Storage (None: ``Storage.instance()`` at request
    time); :meth:`start` serves on a background thread, :meth:`serve_forever`
    on the caller's."""

    def __init__(self, storage: Optional[Storage] = None,
                 host: str = "127.0.0.1", port: int = 7072,
                 secret: Optional[str] = None):
        self._httpd = _Server((host, port), storage, secret)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def start(self) -> tuple[str, int]:
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="pio-storage-server",
                                        daemon=True)
        self._thread.start()
        return self.address

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


def run_storage_server(ip: str = "127.0.0.1", port: int = 7072,
                       storage: Optional[Storage] = None,
                       secret: Optional[str] = None) -> None:
    """Blocking entry point (``pio storageserver``): loopback by default, a
    secret required for any other bind, HTTPS under
    ``PIO_SSL_CERTFILE``/``PIO_SSL_KEYFILE``. Prints the bound address once
    it listens; returns on KeyboardInterrupt or SystemExit (the verb turns
    SIGTERM into the latter)."""
    # this API is full read/write over access keys, events and models
    secret = (secret
              or envknobs.env_str("PIO_STORAGESERVER_SECRET", "",
                                  lower=False)
              or None)
    if not secret and ip not in ("127.0.0.1", "localhost", "::1"):
        raise SystemExit(
            f"refusing to bind the storage server on {ip} without a "
            "shared secret: set PIO_STORAGESERVER_SECRET (and the matching "
            "PIO_STORAGE_SOURCES_<N>_SECRET on clients) or bind 127.0.0.1")
    server = StorageServer(storage, ip, port, secret)
    host, bound = server.address
    scheme = "https" if server._httpd.ssl_context is not None else "http"
    print(f"[info] Storage server running on {scheme}://{host}:{bound}",
          flush=True)
    try:
        server.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        server._httpd.server_close()
