"""An HBase REST gateway on the standard library, for the port.

The port's stand-in for ``tests/hbase_mock.py`` (an aiohttp app), with
the same JSON representation: table schema PUT/DELETE, row
GET/PUT/DELETE (``/{table}/batch`` puts many rows) with base64 keys,
columns and values (the cell under ``"$"``), and the stateful scanner
(``PUT /{table}/scanner`` answers 201 with a Location, ``GET`` returns
batches until 204, ``DELETE`` closes it). Rows iterate in rowkey byte
order, and a scanner's ``filter`` (the Stargate JSON spec as a string:
SingleColumnValueFilter EQUAL / NOT_EQUAL and FilterList) is evaluated
here, so only matching rows cross the wire; ``rows_served`` counts them.

Standard library only, so ``chip_smoke.py`` loads it by path::

    with HBaseRestServer() as srv:   # srv.port, srv.tables, srv.rows_served
        ...
"""

from __future__ import annotations

import base64
import itertools
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["HBaseRestServer"]


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def _eval_filter(spec: dict, cells: dict[str, bytes]) -> bool:
    ftype = spec.get("type")
    if ftype == "FilterList":
        results = [_eval_filter(f, cells) for f in spec.get("filters", [])]
        return (any(results) if spec.get("op") == "MUST_PASS_ONE"
                else all(results))
    if ftype == "SingleColumnValueFilter":
        col = (_unb64(spec["family"]).decode() + ":"
               + _unb64(spec["qualifier"]).decode())
        value = cells.get(col)
        if value is None:
            return not spec.get("ifMissing", False)
        want = _unb64(spec["comparator"]["value"])
        op = spec.get("op", "EQUAL")
        if op == "EQUAL":
            return value == want
        if op == "NOT_EQUAL":
            return value != want
        raise ValueError(f"unsupported filter op {op}")
    raise ValueError(f"unsupported filter type {ftype}")


def _row_json(key: bytes, cells: dict[str, bytes]) -> dict:
    return {"key": _b64(key),
            "Cell": [{"column": _b64(col.encode()), "timestamp": 1,
                      "$": _b64(v)} for col, v in cells.items()]}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    wbufsize = -1
    server: "HBaseRestServer"

    def log_message(self, *args) -> None:
        pass

    def _reply(self, status: int, doc=None,
               headers: dict | None = None) -> None:
        body = json.dumps(doc).encode() if doc is not None else b""
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _handle(self) -> None:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        parts = self.path.partition("?")[0].strip("/").split("/")
        with self.server.lock:
            out = self._route(self.command, parts,
                              json.loads(raw) if raw else {})
        self._reply(*out)

    do_PUT = do_GET = do_DELETE = do_POST = _handle

    def _route(self, m: str, parts: list[str], body: dict):
        srv = self.server
        tables = srv.tables
        if len(parts) != 2:
            return (404, {})
        if parts[0] == "scanner":
            sid = parts[1]
            if m == "DELETE":
                srv.scanners.pop(sid, None)
                return (200,)
            return self._scanner_next(sid)
        table, rest = parts
        if rest == "schema":
            if m == "PUT":
                tables.setdefault(table, {})
                return (201,)
            if tables.pop(table, None) is None:
                return (404, {})
            return (200,)
        if rest == "scanner" and m == "PUT":
            if table not in tables:
                return (404, {})
            start = _unb64(body["startRow"]) if body.get("startRow") else b""
            end = _unb64(body["endRow"]) if body.get("endRow") else None
            sid = str(next(srv.scanner_ids))
            srv.scanners[sid] = {
                "table": table,
                "keys": sorted(k for k in tables[table]
                               if k >= start and (end is None or k < end)),
                "pos": 0, "batch": int(body.get("batch", 100)),
                "filter": (json.loads(body["filter"])
                           if body.get("filter") else None)}
            host = self.headers.get("Host")
            return (201, None, {"Location": f"http://{host}/scanner/{sid}"})
        t = tables.get(table)
        key = urllib.parse.unquote(rest).encode()
        if m == "PUT":
            if t is None:
                return (404, {})
            for row in body.get("Row", []):
                cells = t.setdefault(_unb64(row["key"]), {})
                for cell in row.get("Cell", []):
                    cells[_unb64(cell["column"]).decode()] = \
                        _unb64(cell["$"])
            return (200,)
        if m == "GET":
            cells = t.get(key) if t is not None else None
            if not cells:
                return (404, {})
            return (200, {"Row": [_row_json(key, cells)]})
        if m == "DELETE":
            if t is None or t.pop(key, None) is None:
                return (404, {})
            return (200,)
        return (405, {})

    def _scanner_next(self, sid: str):
        srv = self.server
        s = srv.scanners.get(sid)
        if s is None:
            return (404, {})
        t = srv.tables.get(s["table"], {})
        out = []
        while s["pos"] < len(s["keys"]) and len(out) < s["batch"]:
            key = s["keys"][s["pos"]]
            s["pos"] += 1
            cells = t.get(key)
            if cells is None or (s["filter"] is not None
                                 and not _eval_filter(s["filter"], cells)):
                continue
            out.append(_row_json(key, cells))
        srv.rows_served += len(out)
        if not out:
            return (204,)
        return (200, {"Row": out})


class HBaseRestServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, port: int = 0):
        super().__init__(("127.0.0.1", port), _Handler)
        self.tables: dict[str, dict[bytes, dict[str, bytes]]] = {}
        self.scanners: dict[str, dict] = {}
        self.scanner_ids = itertools.count(1)
        #: scanner rows that crossed the wire (the push-down check)
        self.rows_served = 0
        self.lock = threading.Lock()

    @property
    def port(self) -> int:
        return self.server_address[1]

    def __enter__(self) -> "HBaseRestServer":
        threading.Thread(target=self.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
        self.server_close()
