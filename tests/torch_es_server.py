"""An Elasticsearch-compatible server on the standard library, for the port.

The port's stand-in for ``tests/es_mock.py`` (an aiohttp app), with the
same routes and answers on what the ELASTICSEARCH backend sends: index
create/delete, ``_doc`` PUT/GET/DELETE with ``_version`` and an
index-wide ``_seq_no``, ``_bulk`` NDJSON, ``_search`` with bool / term /
terms / range filters, field and ``_seq_no`` sorts, ``search_after``
pages and ``size``, point-in-time handles (Elasticsearch's ``_pit`` and,
under ``mode="opensearch"``, OpenSearch's ``_search/point_in_time``) and
sliced PIT searches (a document lies in slice ``crc32(id) % max``, as in
the reference's mock). The other modes of the mock are here too:
``pit_no_slice``, ``shard_failure``, ``search_timeout`` and
``bulk_partial_failure``.

A sorted search is kept per (index, query, sort, slice) until the index
changes, so a scan of N documents in pages costs one sort, not one per
page. Standard library only, so ``chip_smoke.py`` loads it by path::

    with ESServer() as srv:   # srv.port, srv.indices, srv.stats
        ...
"""

from __future__ import annotations

import bisect
import itertools
import json
import threading
import urllib.parse
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["ESServer"]


class _Index:
    def __init__(self):
        self.docs: dict[str, dict] = {}   # id -> _source, _seq_no, _version
        self.seq = 0
        self.gen = 0                      # bumped by every change


class _Desc:
    """A sort value in descending order."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


def _clauses(sort_spec) -> list[tuple[str, str]]:
    out = []
    for clause in sort_spec:
        if isinstance(clause, dict):
            ((field, opts),) = clause.items()
            order = (opts or {}).get("order", "asc") \
                if isinstance(opts, dict) else "asc"
        else:
            field, order = clause, "asc"
        out.append((field, order))
    return out


def _ordered(values, clauses) -> tuple:
    return tuple(v if order == "asc" else
                 (-v if isinstance(v, (int, float)) else _Desc(v))
                 for v, (_f, order) in zip(values, clauses))


def _match(src: dict, query: dict) -> bool:
    if not query or "match_all" in query:
        return True
    if "bool" in query:
        return all(_match(src, f) for f in query["bool"].get("filter", []))
    if "term" in query:
        ((field, value),) = query["term"].items()
        if isinstance(value, dict):
            value = value.get("value")
        return src.get(field) == value
    if "terms" in query:
        ((field, values),) = query["terms"].items()
        return src.get(field) in values
    if "range" in query:
        ((field, spec),) = query["range"].items()
        v = src.get(field)
        if v is None:
            return False
        return (("gte" not in spec or v >= spec["gte"])
                and ("gt" not in spec or v > spec["gt"])
                and ("lte" not in spec or v <= spec["lte"])
                and ("lt" not in spec or v < spec["lt"]))
    raise ValueError(f"unsupported query {query}")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    wbufsize = -1
    server: "ESServer"

    def log_message(self, *args) -> None:
        pass

    def _json(self, status: int, doc) -> None:
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _handle(self) -> None:
        raw = self._body()
        path = self.path.partition("?")[0]
        parts = [urllib.parse.unquote(p) for p in path.strip("/").split("/")]
        m, srv = self.command, self.server
        try:
            doc = json.loads(raw) if raw and "_bulk" not in parts else {}
            with srv.lock:
                out = self._route(m, parts, doc, raw)
        except ValueError as e:
            out = (400, {"error": {"type": "parsing_exception",
                                   "reason": str(e)}})
        self._json(*out)

    do_PUT = do_GET = do_DELETE = do_POST = _handle

    def _route(self, m: str, parts: list[str], doc, raw: bytes):
        srv = self.server
        if parts == ["_bulk"] and m == "POST":
            return srv.bulk(raw.decode())
        if parts == ["_search"] and m == "POST":
            return srv.search_pit(doc)
        if parts == ["_pit"] and m == "DELETE":
            existed = srv.pits.pop(doc.get("id"), None) is not None
            return (200 if existed else 404), {"succeeded": existed}
        if parts == ["_search", "point_in_time"] and m == "DELETE":
            existed = any(srv.pits.pop(i, None) is not None
                          for i in doc.get("pit_id") or [])
            return (200 if existed else 404), {"succeeded": existed}
        if len(parts) == 1 and m == "PUT":
            if parts[0] in srv.indices:
                return 400, {"error": {
                    "type": "resource_already_exists_exception"}}
            srv.indices[parts[0]] = _Index()
            return 200, {"acknowledged": True, "index": parts[0]}
        if len(parts) == 1 and m == "DELETE":
            if srv.indices.pop(parts[0], None) is None:
                return 404, {"error": {"type": "index_not_found_exception"}}
            return 200, {"acknowledged": True}
        if len(parts) == 2 and parts[1] == "_pit" and m == "POST":
            return srv.open_pit(parts[0], "es")
        if parts[1:] == ["_search", "point_in_time"] and m == "POST":
            return srv.open_pit(parts[0], "opensearch")
        if len(parts) == 2 and parts[1] == "_search" and m == "POST":
            return srv.search(parts[0], doc)
        if len(parts) == 3 and parts[1] == "_doc":
            index, doc_id = parts[0], parts[2]
            if m == "PUT":
                version, seq = srv.put_doc(index, doc_id, doc)
                return (200 if version > 1 else 201), {
                    "_index": index, "_id": doc_id, "_version": version,
                    "_seq_no": seq,
                    "result": "updated" if version > 1 else "created"}
            idx = srv.indices.get(index)
            if m == "GET":
                d = idx.docs.get(doc_id) if idx else None
                if d is None:
                    return 404, {"found": False}
                return 200, {"_id": doc_id, "found": True,
                             "_source": d["_source"],
                             "_version": d["_version"]}
            if m == "DELETE":
                if idx is None or idx.docs.pop(doc_id, None) is None:
                    return 404, {"result": "not_found"}
                idx.gen += 1
                return 200, {"result": "deleted"}
        return 405, {"error": f"unsupported {m} /{'/'.join(parts)}"}


class ESServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, mode: str = "default", port: int = 0):
        super().__init__(("127.0.0.1", port), _Handler)
        self.mode = mode
        self.indices: dict[str, _Index] = {}
        self.pits: dict[str, str] = {}
        self._pit_ids = itertools.count(1)
        self._sorted: dict[tuple, tuple] = {}
        #: requests served by kind: the phase reads that the sliced scan ran
        self.stats = {"search": 0, "sliced_search": 0, "pit_open": 0,
                      "bulk": 0}
        self.lock = threading.RLock()

    @property
    def port(self) -> int:
        return self.server_address[1]

    def __enter__(self) -> "ESServer":
        threading.Thread(target=self.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
        self.server_close()

    # -- documents ---------------------------------------------------------
    def put_doc(self, index: str, doc_id: str, source: dict):
        idx = self.indices.setdefault(index, _Index())
        idx.seq += 1
        idx.gen += 1
        prev = idx.docs.get(doc_id)
        version = prev["_version"] + 1 if prev else 1
        idx.docs[doc_id] = {"_source": source, "_seq_no": idx.seq,
                            "_version": version}
        return version, idx.seq

    def bulk(self, text: str):
        self.stats["bulk"] += 1
        lines = [ln for ln in text.split("\n") if ln.strip()]
        items, i = [], 0
        while i < len(lines):
            action = json.loads(lines[i])
            if "index" in action:
                meta = action["index"]
                version, seq = self.put_doc(meta["_index"], meta["_id"],
                                            json.loads(lines[i + 1]))
                items.append({"index": {"_id": meta["_id"], "status": 200,
                                        "_version": version,
                                        "_seq_no": seq}})
                i += 2
            elif "delete" in action:
                meta = action["delete"]
                idx = self.indices.get(meta["_index"])
                existed = (idx is not None
                           and idx.docs.pop(meta["_id"], None) is not None)
                if existed:
                    idx.gen += 1
                items.append({"delete": {
                    "_id": meta["_id"], "status": 200 if existed else 404,
                    "result": "deleted" if existed else "not_found"}})
                i += 1
            else:
                return 400, {"error": "unsupported bulk action"}
        if self.mode == "bulk_partial_failure" and items:
            items[-1] = {"index": {
                "_id": "whatever", "status": 429,
                "error": {"type": "es_rejected_execution_exception",
                          "reason": "rejected execution (queue capacity)"}}}
            return 200, {"errors": True, "items": items}
        return 200, {"errors": False, "items": items}

    # -- point in time -----------------------------------------------------
    def open_pit(self, index: str, flavor: str):
        if (flavor == "opensearch") != (self.mode == "opensearch"):
            return 400, {"error": {"type": "illegal_argument_exception"}}
        if index not in self.indices:
            return 404, {"error": {"type": "index_not_found_exception"}}
        self.stats["pit_open"] += 1
        if flavor == "es":
            pid = f"pit{next(self._pit_ids)}:{index}"
            self.pits[pid] = index
            return 200, {"id": pid}
        pid = f"ospit{next(self._pit_ids)}:{index}"
        self.pits[pid] = index
        return 200, {"pit_id": pid}

    def search_pit(self, body: dict):
        index = self.pits.get((body.get("pit") or {}).get("id"))
        if index is None:
            return 404, {"error": {
                "type": "search_context_missing_exception"}}
        if self.mode == "pit_no_slice" and body.get("slice"):
            return 400, {"error": {
                "type": "illegal_argument_exception",
                "reason": "slice is not supported in point-in-time"}}
        if body.get("slice"):
            self.stats["sliced_search"] += 1
        return self.search(index, body)

    # -- search ------------------------------------------------------------
    def _sorted_hits(self, index: str, idx: _Index, query, sort_spec,
                     slice_spec) -> tuple[list, list]:
        key = (index, json.dumps(query, sort_keys=True),
               json.dumps(sort_spec, sort_keys=True),
               json.dumps(slice_spec, sort_keys=True))
        got = self._sorted.get(key)
        if got is not None and got[0] == idx.gen:
            return got[1], got[2]
        hits = [{"_id": doc_id, "_source": d["_source"],
                 "_seq_no": d["_seq_no"]}
                for doc_id, d in idx.docs.items()
                if _match(d["_source"], query)
                and (slice_spec is None
                     or zlib.crc32(doc_id.encode()) % int(slice_spec["max"])
                     == int(slice_spec["id"]))]
        keys: list = []
        if sort_spec:
            clauses = _clauses(sort_spec)
            for h in hits:
                h["sort"] = [h["_seq_no"] if f == "_seq_no"
                             else h["_source"].get(f) for f, _o in clauses]
            hits.sort(key=lambda h: _ordered(h["sort"], clauses))
            keys = [_ordered(h["sort"], clauses) for h in hits]
        self._sorted[key] = (idx.gen, hits, keys)
        return hits, keys

    def search(self, index: str, body: dict):
        self.stats["search"] += 1
        idx = self.indices.get(index)
        if idx is None:
            return 404, {"error": {"type": "index_not_found_exception"}}
        sort_spec = body.get("sort")
        size = int(body.get("size", 10))
        hits, keys = self._sorted_hits(
            index, idx, body.get("query", {"match_all": {}}), sort_spec,
            body.get("slice"))
        lo = 0
        after = body.get("search_after")
        if sort_spec and after is not None:
            lo = bisect.bisect_right(
                keys, _ordered(after, _clauses(sort_spec)))
        page = [dict(h) for h in hits[lo:lo + size]]
        shards = {"total": 3, "successful": 3, "skipped": 0, "failed": 0}
        if self.mode == "shard_failure":
            shards = {"total": 3, "successful": 2, "skipped": 0,
                      "failed": 1,
                      "failures": [{"shard": 1, "index": "x", "reason": {
                          "type": "node_disconnected"}}]}
            page = page[:max(len(page) - 1, 0)]
        return 200, {"hits": {"hits": page,
                              "total": {"value": len(page)}},
                     "_shards": shards,
                     "timed_out": self.mode == "search_timeout"}
