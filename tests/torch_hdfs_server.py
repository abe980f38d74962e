"""A WebHDFS gateway on the standard library, for the port.

The port's stand-in for ``tests/hdfs_mock.py`` (an aiohttp app): the
NameNode side of CREATE with the two-step 307 redirect to a "DataNode"
(this server again, ``&datanode=1``), OPEN and DELETE over an in-memory
filesystem. The NameNode leg of CREATE must carry no data, as on a real
cluster. Modes, as the reference's mock has them: ``"no_redirect"``
answers CREATE itself like an HttpFS gateway (the body of that leg is
the file, and a data-bearing leg must say ``application/octet-stream``);
``"redirect_no_location"`` sends a 307 without a Location header.

Standard library only, so ``chip_smoke.py`` loads it by path::

    with HDFSServer() as srv:   # srv.port, srv.files, srv.redirects
        ...
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["HDFSServer"]

_PREFIX = "/webhdfs/v1"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    wbufsize = -1
    server: "HDFSServer"

    def log_message(self, *args) -> None:
        pass

    def _reply(self, status: int, body: bytes = b"",
               headers: dict | None = None,
               ctype: str = "application/octet-stream") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status: int, doc: dict) -> None:
        self._reply(status, json.dumps(doc).encode(), ctype="application/json")

    def _handle(self) -> None:
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        raw_path, _, query_string = self.path.partition("?")
        if not raw_path.startswith(_PREFIX):
            return self._json(404, {})
        path = urllib.parse.unquote(raw_path[len(_PREFIX):])
        query = dict(urllib.parse.parse_qsl(query_string,
                                            keep_blank_values=True))
        op = (query.get("op") or "").upper()
        srv = self.server
        if self.command == "PUT" and op == "CREATE":
            if srv.mode == "redirect_no_location" and "datanode" not in query:
                return self._reply(307)
            if srv.mode == "no_redirect":
                ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                if body and ctype != "application/octet-stream":
                    return self._json(400, {"RemoteException": {"message":
                        "Data upload requests must have content-type set "
                        "to 'application/octet-stream'"}})
                with srv.lock:
                    srv.files[path] = body
                return self._reply(201)
            if "datanode" not in query:
                if body:
                    return self._json(400, {"RemoteException": {"message":
                        "the NameNode leg of CREATE must carry no data"}})
                with srv.lock:
                    srv.redirects += 1
                # the as-sent (still percent-encoded) path: the decoded one
                # would be decoded twice on the DataNode leg
                loc = (f"http://{self.headers.get('Host')}{raw_path}?"
                       f"{query_string}&datanode=1")
                return self._reply(307, headers={"Location": loc})
            with srv.lock:
                srv.files[path] = body
            return self._reply(201)
        if self.command == "GET" and op == "OPEN":
            with srv.lock:
                data = srv.files.get(path)
            if data is None:
                return self._json(404, {"RemoteException": {
                    "exception": "FileNotFoundException"}})
            return self._reply(200, data)
        if self.command == "DELETE" and op == "DELETE":
            with srv.lock:
                existed = srv.files.pop(path, None) is not None
            return self._json(200, {"boolean": existed})
        return self._json(400, {})

    do_PUT = do_GET = do_DELETE = do_POST = _handle


class HDFSServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, mode: str = "default", port: int = 0):
        super().__init__(("127.0.0.1", port), _Handler)
        self.mode = mode
        self.files: dict[str, bytes] = {}
        #: CREATE legs answered with a 307 to the DataNode
        self.redirects = 0
        self.lock = threading.Lock()

    @property
    def port(self) -> int:
        return self.server_address[1]

    def __enter__(self) -> "HDFSServer":
        threading.Thread(target=self.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
        self.server_close()
