"""Engine server: ``POST /queries.json`` and ``GET /`` over one deployment.

Port of the query path of ``incubator_predictionio_tpu/workflow/
create_server.py`` (``:363``) on the standard library's
``http.server.ThreadingHTTPServer`` (one thread per connection). Status
codes follow the reference: 400 for a body that is not JSON or a query that
lacks a field, 500 for a failure inside the engine. Admission control,
micro-batching, the fleet and the model lifecycle wait for a later slice.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

log = logging.getLogger("pio.torch.server")


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"
    protocol_version = "HTTP/1.1"
    # buffered writes: a response's headers and body leave in one send at
    # the end of the request (two small sends meet Nagle's algorithm and
    # the client's delayed ACK, ~40 ms per keep-alive request)
    wbufsize = -1

    def _reply(self, status: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=UTF-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - http.server's naming
        if self.path.split("?", 1)[0] != "/":
            self._reply(404, {"message": f"no route {self.path}"})
            return
        self._reply(200, {"status": "alive", **self.server.info})

    def do_POST(self):  # noqa: N802
        if self.path.split("?", 1)[0] != "/queries.json":
            self._reply(404, {"message": f"no route {self.path}"})
            return
        length = int(self.headers.get("Content-Length") or 0)
        try:
            query = json.loads(self.rfile.read(length) or b"null")
        except (json.JSONDecodeError, UnicodeDecodeError):
            self._reply(400, {"message": "invalid JSON body"})
            return
        if not isinstance(query, dict):
            self._reply(400, {"message": "query must be a JSON object"})
            return
        try:
            result = self.server.deployment.query(query)
        except KeyError as e:
            self._reply(400, {"message": f"missing query field {e.args[0]!r}"})
            return
        except Exception as e:  # noqa: BLE001 - the server must keep running
            log.exception("query failed")
            self._reply(500, {"message": str(e)})
            return
        self._reply(200, result)

    def log_message(self, fmt, *args):  # quiet: one line per request is noise
        log.debug("%s - " + fmt, self.address_string(), *args)


class _Server(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, deployment, info):
        super().__init__(addr, _Handler)
        self.deployment = deployment
        self.info = info


class EngineServer:
    """Serves ``deployment`` on ``host:port`` (port 0 picks a free one).
    ``info`` is echoed by ``GET /``."""

    def __init__(self, deployment, host: str = "127.0.0.1", port: int = 8000,
                 info: dict | None = None):
        self._httpd = _Server((host, port), deployment, dict(info or {}))
        self._thread: threading.Thread | None = None

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
                                        name="pio-engine-server", daemon=True)
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
