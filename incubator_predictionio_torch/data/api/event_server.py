"""Event Server — the REST ingestion API (default port 7070).

Port of the request path of ``incubator_predictionio_tpu/data/api/
event_server.py`` (reference: data/.../data/api/EventServer.scala) on the
standard library's ``http.server.ThreadingHTTPServer`` (one thread per
connection), wire-compatible with the documented PredictionIO API:

  GET    /                                       → 200 {"status": "alive"}
  POST   /events.json?accessKey=K[&channel=C]    → 201 {"eventId": id}
  POST   /batch/events.json?accessKey=K          → 200 [per-event status]
  GET    /events/<id>.json?accessKey=K           → 200 event JSON
  DELETE /events/<id>.json?accessKey=K           → 200 {"message": "Found"}
  GET    /events.json?accessKey=K&<filters>      → 200 [event JSON...]

Auth: the ``accessKey`` query parameter or HTTP Basic auth (user = key),
checked against the AccessKeys DAO on every request (401 when missing or
unknown); a key's event allow-list is enforced (403 for a single event,
a per-item 400 in a batch). ``channel`` selects a channel of the key's app
(400 when unknown). A write is acknowledged only after it is committed to
the event store (the reference's default ``ack=commit``): each request
commits its events in one store call before the response is sent. The
SQLite connection is shared by the handler threads under the backend's
lock.

On an event store that takes pre-serialized lines (the JSONL log's
``insert_canonical_lines``), a batch whose every item is valid, carries no
client eventId and needs no allow-list check is validated and
canonicalized by the event codec in one pass (``native.ingest_batch``, the
reference's ``_try_native_batch``) and appended as one write; any other
batch takes the Python path, which owns every error message. The codec is
built when the server starts; a failed build stops the server.

The reference's ingest buffer (group commit), write-ahead log,
``ack=enqueue``, webhooks, ``/stats.json``, ``/metrics``, load shedding
and access-key cache are not ported yet (ROADMAP.md Queue 1, item 3).
"""

from __future__ import annotations

import base64
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlsplit

from ... import native
from ..storage.base import AccessKey
from ..storage.event import (
    Event, EventValidationError, _utcnow, format_event_time, parse_event_time,
)
from ..storage.registry import Storage

log = logging.getLogger("pio.torch.eventserver")

MAX_BATCH_SIZE = 50  # reference: /batch/events.json limit


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class ForbiddenEventError(PermissionError):
    """Event name not in the access key's allow-list (maps to 403)."""


def parse_single_event(raw: bytes, allowed=()) -> Event:
    """Raw body → Event: strict JSON, dict-shaped, server-assigned
    creationTime, Event validation, the key's allow-list. Raises
    EventValidationError (400) or ForbiddenEventError (403)."""
    try:
        body = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError):
        raise EventValidationError("invalid JSON body") from None
    if not isinstance(body, dict):
        raise EventValidationError("event body must be a JSON object")
    body.pop("creationTime", None)  # server-assigned on ingest
    event = Event.from_json(body)
    if allowed and event.event not in allowed:
        raise ForbiddenEventError(
            f"event {event.event!r} is not allowed for this access key")
    return event


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"
    protocol_version = "HTTP/1.1"
    # buffered writes: a response's headers and body leave in one send at
    # the end of the request (two small sends meet Nagle's algorithm and
    # the client's delayed ACK, ~40 ms per keep-alive request)
    wbufsize = -1

    # -- plumbing ----------------------------------------------------------
    def _reply(self, status: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length > 0 else b""

    def _route(self):
        parts = urlsplit(self.path)
        return parts.path, parse_qs(parts.query, keep_blank_values=True)

    def _dispatch(self, method: str) -> None:
        path, query = self._route()
        # the body is read before routing so a keep-alive connection never
        # carries an unread body into its next request
        raw = self._body()
        try:
            handler = self.server.app.route(method, path)
            if handler is None:
                raise _HTTPError(404, f"no route {method} {path}")
            status, obj = handler(self, path, query, raw)
        except _HTTPError as e:
            status, obj = e.status, {"message": e.message}
        except Exception as e:  # noqa: BLE001 - the server must keep running
            log.exception("event server request failed")
            status, obj = 500, {"message": f"event store error: {e}"}
        self._reply(status, obj)

    def do_GET(self):  # noqa: N802 - http.server's naming
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")

    def log_message(self, fmt, *args):  # quiet: one line per request is noise
        log.debug("%s - " + fmt, self.address_string(), *args)


class EventServer:
    """The routes over one Storage; :meth:`start` / :meth:`serve_forever`
    serve them on ``host:port`` (port 0 picks a free one)."""

    def __init__(self, storage: Optional[Storage] = None,
                 host: str = "0.0.0.0", port: int = 7070):
        self.storage = storage or Storage.instance()
        if self._native_store():
            native.load()  # build the codec now, not inside a request
        self._httpd = _Server((host, port), self)
        self._thread: Optional[threading.Thread] = None

    # -- serving -----------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def start(self) -> tuple[str, int]:
        """Serve on a background thread; returns (host, port)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="pio-event-server", daemon=True)
        self._thread.start()
        return self.address

    def close(self) -> None:
        self._httpd.server_close()

    def stop(self) -> None:
        self._httpd.shutdown()
        self.close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def route(self, method: str, path: str):
        if method == "GET" and path == "/":
            return self.handle_root
        if path == "/events.json":
            return {"POST": self.handle_create,
                    "GET": self.handle_find}.get(method)
        if path == "/batch/events.json" and method == "POST":
            return self.handle_batch
        if path.startswith("/events/") and path.endswith(".json"):
            return {"GET": self.handle_get,
                    "DELETE": self.handle_delete}.get(method)
        return None

    # -- auth ----------------------------------------------------------------
    @staticmethod
    def _access_key_str(handler, query) -> Optional[str]:
        key = (query.get("accessKey") or [""])[0]
        if key:
            return key
        auth = handler.headers.get("Authorization", "")
        if auth.startswith("Basic "):
            try:
                decoded = base64.b64decode(auth[6:]).decode()
                return decoded.split(":", 1)[0]
            except Exception:  # noqa: BLE001 - malformed header: no key
                return None
        return None

    def _authorize(self, handler, query) -> AccessKey:
        key = self._access_key_str(handler, query)
        if not key:
            raise _HTTPError(401, "Missing accessKey.")
        access_key = self.storage.get_meta_data_access_keys().get(key)
        if access_key is None:
            raise _HTTPError(401, "Invalid accessKey.")
        return access_key

    def _channel_id(self, query, access_key: AccessKey) -> Optional[int]:
        name = (query.get("channel") or [""])[0]
        if not name:
            return None
        for c in self.storage.get_meta_data_channels().get_by_appid(
                access_key.appid):
            if c.name == name:
                return c.id
        raise _HTTPError(400, f"Invalid channel {name!r}.")

    @staticmethod
    def _event_id(path: str) -> str:
        return unquote(path[len("/events/"):-len(".json")])

    # -- handlers ------------------------------------------------------------
    def handle_root(self, handler, path, query, raw):
        return 200, {"status": "alive"}

    def handle_create(self, handler, path, query, raw):
        access_key = self._authorize(handler, query)
        channel_id = self._channel_id(query, access_key)
        try:
            event = parse_single_event(raw, access_key.events or ())
        except EventValidationError as e:
            return 400, {"message": str(e)}
        except ForbiddenEventError as e:
            return 403, {"message": str(e)}
        # committed before the 201 leaves (ack=commit)
        event_id = self.storage.get_l_events().insert(
            event, access_key.appid, channel_id)
        return 201, {"eventId": event_id}

    def _native_store(self) -> bool:
        return hasattr(self.storage.get_l_events(), "insert_canonical_lines")

    def _try_native_batch(self, raw: bytes, access_key: AccessKey):
        """(ids, canonical JSONL bytes) from the codec's one-pass
        validation, or None when the Python path must run: a key with an
        event allow-list, a store without ``insert_canonical_lines``, or a
        batch the codec hands back (any invalid item, a client eventId,
        more than MAX_BATCH_SIZE items, a syntax error)."""
        if access_key.events or not self._native_store():
            return None
        return native.ingest_batch(raw, MAX_BATCH_SIZE,
                                   format_event_time(_utcnow()))

    def handle_batch(self, handler, path, query, raw):
        access_key = self._authorize(handler, query)
        channel_id = self._channel_id(query, access_key)
        fast = self._try_native_batch(raw, access_key)
        if fast is not None:
            ids, lines = fast
            try:
                self.storage.get_l_events().insert_canonical_lines(
                    lines, access_key.appid, channel_id)
            except Exception as e:  # noqa: BLE001 — storage fault, per item
                # one append: every item failed together
                return 200, [{"status": 500,
                              "message": f"event store error: {e}"}
                             for _ in ids]
            return 200, [{"status": 201, "eventId": eid} for eid in ids]
        try:
            body = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return 400, {"message": "invalid JSON body"}
        if not isinstance(body, list):
            return 400, {"message": "batch body must be a JSON array"}
        if len(body) > MAX_BATCH_SIZE:
            return 400, {"message": "Batch request must have less than or "
                                    f"equal to {MAX_BATCH_SIZE} events"}
        # every item is validated on its own (the reference's independent
        # items); the valid ones commit together in one store call
        results: list[Optional[dict]] = [None] * len(body)
        valid: list[tuple[int, Event]] = []
        for pos, obj in enumerate(body):
            try:
                if isinstance(obj, dict):
                    obj = dict(obj)
                    obj.pop("creationTime", None)
                event = Event.from_json(obj)
            except EventValidationError as e:
                results[pos] = {"status": 400, "message": str(e)}
                continue
            if access_key.events and event.event not in access_key.events:
                results[pos] = {"status": 400, "message": "forbidden"}
                continue
            valid.append((pos, event))
        if valid:
            try:
                ids = self.storage.get_l_events().insert_batch(
                    [e for _, e in valid], access_key.appid, channel_id)
            except Exception as e:  # noqa: BLE001 — storage fault, per item
                for pos, _ in valid:
                    results[pos] = {"status": 500,
                                    "message": f"event store error: {e}"}
                return 200, results
            for (pos, _), eid in zip(valid, ids, strict=True):
                results[pos] = {"status": 201, "eventId": eid}
        return 200, results

    def handle_get(self, handler, path, query, raw):
        access_key = self._authorize(handler, query)
        channel_id = self._channel_id(query, access_key)
        event = self.storage.get_l_events().get(
            self._event_id(path), access_key.appid, channel_id)
        if event is None:
            return 404, {"message": "Event not found."}
        return 200, event.to_json()

    def handle_delete(self, handler, path, query, raw):
        access_key = self._authorize(handler, query)
        channel_id = self._channel_id(query, access_key)
        found = self.storage.get_l_events().delete(
            self._event_id(path), access_key.appid, channel_id)
        if not found:
            return 404, {"message": "Event not found."}
        return 200, {"message": "Found"}

    def handle_find(self, handler, path, query, raw):
        access_key = self._authorize(handler, query)
        channel_id = self._channel_id(query, access_key)

        def one(name):
            values = query.get(name)
            return values[0] if values else None

        try:
            start_time = parse_event_time(one("startTime")) if one("startTime") else None
            until_time = parse_event_time(one("untilTime")) if one("untilTime") else None
        except EventValidationError as e:
            return 400, {"message": str(e)}
        try:
            limit = int(one("limit") if "limit" in query else 20)
        except ValueError:
            return 400, {"message": "limit must be an integer"}
        if limit > 500 or limit == 0:
            limit = 500  # reference caps scans
        events = self.storage.get_l_events().find(
            access_key.appid,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=one("entityType"),
            entity_id=one("entityId"),
            event_names=query.get("event"),
            target_entity_type=one("targetEntityType"),
            target_entity_id=one("targetEntityId"),
            limit=None if limit < 0 else limit,
            reversed_order=one("reversed") == "true",
        )
        return 200, [e.to_json() for e in events]


class _Server(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, app: EventServer):
        super().__init__(addr, _Handler)
        self.app = app
