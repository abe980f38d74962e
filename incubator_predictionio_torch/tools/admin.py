"""Admin API: REST app and access-key management on :7071.

Port of ``incubator_predictionio_tpu/tools/admin.py`` (reference:
tools/.../tools/admin/{AdminServer,CommandClient}.scala, the experimental
REST admin), rebuilt on the standard library's ``ThreadingHTTPServer``
(the card host has no aiohttp) with the reference's routes, bodies and
status codes:

    GET    /                    {"status": "alive", ...}
    GET    /cmd/app             [{name, id, accessKeys}]
    POST   /cmd/app             {"name": N[, "id", "description"]} → 201
                                (400 without a name or on bad JSON, 409
                                when the app exists)
    DELETE /cmd/app/{name}      the app, its keys and its events (404)
    DELETE /cmd/app/{name}/data its events only (404)

Under ``PIO_SSL_CERTFILE`` / ``PIO_SSL_KEYFILE`` it serves HTTPS only
(``common/ssl_config.py`` ``TLSServerMixin``); a bad file stops it at
start-up.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import unquote

from ..common.ssl_config import TLSServerMixin, ssl_context_from_env
from ..data.storage.base import AccessKey, App
from ..data.storage.registry import Storage

log = logging.getLogger("pio.torch.admin")


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"
    protocol_version = "HTTP/1.1"
    wbufsize = -1  # headers and body leave in one send

    def _json(self, status: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _route(self) -> list:
        path = self.path.split("?", 1)[0]
        return [unquote(p) for p in path.strip("/").split("/")] if \
            path.strip("/") else []

    def do_GET(self):  # noqa: N802 - http.server's naming
        parts = self._route()
        storage = self.server.storage
        if parts == []:
            self._json(200, {"status": "alive",
                             "description": "PredictionIO-TPU Admin API"})
        elif parts == ["cmd", "app"]:
            keys = storage.get_meta_data_access_keys()
            self._json(200, [
                {"name": a.name, "id": a.id,
                 "accessKeys": [k.key for k in keys.get_by_appid(a.id)]}
                for a in storage.get_meta_data_apps().get_all()])
        else:
            self._json(404, {"message": "Not Found"})

    def do_POST(self):  # noqa: N802
        if self._route() != ["cmd", "app"]:
            self._body()
            self._json(404, {"message": "Not Found"})
            return
        try:
            body = json.loads(self._body() or b"null")
            if not isinstance(body, dict):
                raise ValueError("not an object")
        except ValueError:
            self._json(400, {"message": "invalid JSON"})
            return
        name = body.get("name")
        if not name:
            self._json(400, {"message": "name is required"})
            return
        storage = self.server.storage
        app_id = storage.get_meta_data_apps().insert(
            App(int(body.get("id", 0)), name, body.get("description")))
        if app_id is None:
            self._json(409, {"message": f"App {name!r} already exists."})
            return
        storage.get_l_events().init(app_id)
        key = storage.get_meta_data_access_keys().insert(
            AccessKey("", app_id, ()))
        self._json(201, {"name": name, "id": app_id, "accessKey": key})

    def do_DELETE(self):  # noqa: N802
        parts = self._route()
        if len(parts) not in (3, 4) or parts[:2] != ["cmd", "app"] \
                or (len(parts) == 4 and parts[3] != "data"):
            self._json(404, {"message": "Not Found"})
            return
        name = parts[2]
        storage = self.server.storage
        apps = storage.get_meta_data_apps()
        a = apps.get_by_name(name)
        if a is None:
            self._json(404, {"message": "not found"})
            return
        events = storage.get_l_events()
        if len(parts) == 4:
            events.remove(a.id)
            events.init(a.id)
            self._json(200, {"message": f"App {name!r} data deleted."})
            return
        keys = storage.get_meta_data_access_keys()
        for k in keys.get_by_appid(a.id):
            keys.delete(k.key)
        events.remove(a.id)
        apps.delete(a.id)
        self._json(200, {"message": f"App {name!r} deleted."})

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n > 0 else b""

    def log_message(self, fmt, *args):
        log.debug("%s - " + fmt, self.address_string(), *args)


class _Server(TLSServerMixin, ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, storage):
        # a bad PIO_SSL_* file raises here, before the socket is bound
        self.ssl_context = ssl_context_from_env()
        super().__init__(addr, _Handler)
        self.storage = storage


class AdminServer:
    """The admin API over ``storage`` (the process's ``Storage.instance()``
    when None) on ``host:port`` (0: a free port)."""

    def __init__(self, storage: Optional[Storage] = None,
                 host: str = "127.0.0.1", port: int = 7071):
        self.storage = storage or Storage.instance()
        self._httpd = _Server((host, port), self.storage)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    def serve_forever(self) -> None:
        """Serve on the calling thread until :meth:`stop`."""
        self._httpd.serve_forever()

    def start(self) -> tuple[str, int]:
        """Serve on a background thread; returns (host, port)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="pio-admin", daemon=True)
        self._thread.start()
        return self.address

    def close(self) -> None:
        """Release the listening socket (after serving has stopped)."""
        self._httpd.server_close()

    def stop(self) -> None:
        """Stop a server started with :meth:`start`."""
        self._httpd.shutdown()
        self.close()
        if self._thread is not None:
            self._thread.join(timeout=10)
