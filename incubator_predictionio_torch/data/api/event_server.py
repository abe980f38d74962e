"""Event Server — the REST ingestion API (default port 7070).

Port of ``incubator_predictionio_tpu/data/api/event_server.py``
(reference: data/.../data/api/EventServer.scala) on the standard library's
``http.server.ThreadingHTTPServer`` (one thread per connection),
wire-compatible with the documented PredictionIO API:

  GET    /                                       → 200 {"status": "alive"}
  GET    /metrics                                → Prometheus text
  POST   /events.json?accessKey=K[&channel=C]    → 201 {"eventId": id}
  POST   /batch/events.json?accessKey=K          → 200 [per-event status]
  GET    /events/<id>.json?accessKey=K           → 200 event JSON
  DELETE /events/<id>.json?accessKey=K           → 200 {"message": "Found"}
  GET    /events.json?accessKey=K&<filters>      → 200 [event JSON...]
  GET    /stats.json?accessKey=K                 → ingest counters (--stats)
  POST   /webhooks/<connector>.json?accessKey=K  → 201 (segmentio, mailchimp)

Auth: the ``accessKey`` query parameter or HTTP Basic auth (user = key),
checked against the AccessKeys DAO (401 when missing or unknown) through a
TTL cache (``PIO_ACCESSKEY_CACHE_SECS``, default 5 s, 0 = a lookup per
request; negative answers are cached too; past 10,000 entries the expired
ones are pruned, then the oldest); a key's event allow-list is enforced
(403 for a single event, a per-item 400 in a batch). ``channel`` selects a
channel of the key's app (400 when unknown).

Writes go through the write-behind group commit (:mod:`.ingest_buffer`):
concurrent requests coalesce into one store write per (app, channel).
``PIO_INGEST_ACK`` (or the request's ``X-Pio-Ack`` header) picks the ack:
``commit`` (default) answers after the group's store write, ``enqueue``
as soon as the validated event is queued. A full buffer, a draining
server, a disk-full append and an open circuit breaker of a network store
(``common/resilience.py``: the store is failing fast) answer 503 with a
jittered ``Retry-After``, counted in ``shedRequests`` on ``GET /``, which also carries the buffer's
counters (``ingest``: groups, ``droppedEvents``, the WAL's).

With ``PIO_WAL=1`` the write-ahead log (:mod:`.ingest_wal`) holds every
event before its ack (enqueue) or its store write (commit). Before serving,
the server replays what a previous process left uncommitted, deduped by
event id against the store; a dead store is logged, not fatal (``pio wal
replay`` lands it later).

On an event store that takes pre-serialized lines (the JSONL log's
``insert_canonical_lines``), a batch whose every item is valid, carries no
client eventId and needs no allow-list check, stats or plugin is validated
and canonicalized by the event codec in one pass (``native.ingest_batch``)
and rides the buffer as one entry; any other batch takes the Python path,
which owns every error message. The codec is built when the server
starts; a failed build stops the server.

A worker of the multi-worker event server (``PIO_EVENT_PARTITION=i``,
``data/api/event_log.py``) claims its partition lease first — before the
WAL replay and before serving — and the buffer verifies the lease's epoch
before every write group and every pre-ack WAL append: a group that
verifies after a fence lands no byte and answers 503. The fence takes
effect from the next verify (the reference has the same window). With
``PIO_COMPACT_INTERVAL_MS`` > 0 a background thread compacts the worker's
own log shards and retires expired generations at that period.

Telemetry: ``GET /metrics`` renders the process registry (the ingest
histograms and counters, the WAL's, the event log's, and with ``--stats``
the per-app counters); ``PIO_TRACE`` samples requests and echoes
``X-Pio-Trace-Id``.

TLS: with ``PIO_SSL_CERTFILE`` and ``PIO_SSL_KEYFILE`` set the server
answers HTTPS only (``common/ssl_config.py``); a missing or bad file stops
it at start-up.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlsplit

from ... import native
from ...common import envknobs, faultinject, telemetry
from ...common.resilience import CircuitOpenError, retry_after_jitter
from ...common.ssl_config import TLSServerMixin, ssl_context_from_env
from ...workflow.plugins import EventServerPluginContext
from ..storage.base import AccessKey
from ..storage.event import (
    Event, EventValidationError, _utcnow, format_event_time, parse_event_time,
)
from ..storage.registry import Storage
from ..webhooks import get_connector
from . import event_log, ingest_wal
from .event_log import IngestOverloadError, Lease, claim_partition
from .ingest_buffer import (ForbiddenEventError, IngestBuffer, IngestConfig,
                            parse_single_event)
from .stats import Stats

log = logging.getLogger("pio.torch.eventserver")

MAX_BATCH_SIZE = 50  # reference: /batch/events.json limit
#: access-key cache entries past which expired ones are pruned
KEY_CACHE_MAX = 10_000


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class _Text(str):
    """A plain-text answer body (``GET /metrics``)."""


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"
    protocol_version = "HTTP/1.1"
    # buffered writes: a response's headers and body leave in one send at
    # the end of the request (two small sends meet Nagle's algorithm and
    # the client's delayed ACK, ~40 ms per keep-alive request)
    wbufsize = -1

    # -- plumbing ----------------------------------------------------------
    def _reply(self, status: int, obj, headers=()) -> None:
        if isinstance(obj, _Text):
            body = obj.encode()
            ctype = "text/plain; charset=utf-8"
        else:
            body = json.dumps(obj).encode()
            ctype = "application/json; charset=utf-8"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        tr = telemetry.current_trace()
        if tr is not None:
            self.send_header(telemetry.TRACE_HEADER, tr.trace_id)
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
        telemetry.traced_dispatch(
            self.headers, method, path,
            lambda: self._serve(method, path, query, raw))

    def _serve(self, method: str, path: str, query, raw: bytes) -> int:
        app = self.server.app
        with app._inflight_cv:
            draining = app._draining
            if not draining:
                app._inflight += 1
        if draining:
            # the server is stopping: refuse before any write, so a client
            # that retries never duplicates an event
            self.close_connection = True
            self._reply(503, {"message": "event server is shutting down"},
                        (("Retry-After", str(retry_after_jitter(1.0))),))
            return 503
        try:
            status, obj, headers = self._answer(app, method, path, query,
                                                raw)
            # written and flushed before the request stops counting as in
            # flight: drain() returns only after every answer has left
            self._reply(status, obj, headers)
            self.wfile.flush()
            return status
        finally:
            with app._inflight_cv:
                app._inflight -= 1
                app._inflight_cv.notify_all()

    def _answer(self, app, method, path, query, raw):
        """(status, body, extra headers) of one request."""
        try:
            handler = app.route(method, path)
            if handler is None:
                raise _HTTPError(404, f"no route {method} {path}")
            return (*handler(self, path, query, raw), ())
        except _HTTPError as e:
            return e.status, {"message": e.message}, ()
        except CircuitOpenError as e:
            # the network store's breaker is open: its calls fail fast,
            # and the refusal becomes the HTTP backpressure contract
            app.count_shed()
            return 503, {"message": "event store temporarily unavailable "
                                    f"({e.breaker_name}); retry later"}, (
                ("Retry-After", str(retry_after_jitter(e.retry_after))),)
        except IngestOverloadError as e:
            # a full buffer, a draining buffer, a fenced partition or a
            # disk-full append: 503 + jittered Retry-After
            app.count_shed()
            return 503, {"message": str(e)}, (("Retry-After", str(
                retry_after_jitter(e.retry_after))),)
        except Exception as e:  # noqa: BLE001 - the server must keep running
            log.exception("event server request failed")
            return 500, {"message": f"event store error: {e}"}, ()

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
                 host: str = "0.0.0.0", port: int = 7070,
                 enable_stats: bool = False,
                 plugins: Optional[EventServerPluginContext] = None):
        # PIO_FAULT_SPEC's at-mode offsets count from server construction
        faultinject.arm()
        self.storage = storage or Storage.instance()
        self.stats = Stats() if enable_stats else None
        self.plugins = plugins or EventServerPluginContext()
        self._key_ttl = envknobs.env_float(
            "PIO_ACCESSKEY_CACHE_SECS", 5.0, lo=0.0)
        self._key_cache: dict = {}  # key -> (expires_monotonic, AccessKey)
        # partitioned event log: a worker of a multi-worker deployment gets
        # PIO_EVENT_PARTITION=i and claims the partition lease FIRST —
        # before the WAL replay, before serving — so everything it ever
        # writes (the replay included) runs under fenced ownership. A held
        # lease raises and the worker exits: the supervisor's backoff
        # retries until the previous owner is gone.
        self.lease: Optional[Lease] = None
        part = envknobs.env_str("PIO_EVENT_PARTITION", "")
        if part.isdigit():
            log_dir = getattr(self.storage.get_l_events(), "events_dir",
                              None)
            if log_dir is not None:
                self.lease = claim_partition(log_dir, int(part))
            else:
                log.warning(
                    "PIO_EVENT_PARTITION=%s but the event store is not a "
                    "JSONL log; partition fencing disabled", part)
        #: requests refused with 503 (reported on GET /)
        self.shed_count = 0
        self._shed_lock = threading.Lock()
        self._inflight = 0
        self._draining = False
        self._inflight_cv = threading.Condition()
        # crash durability (PIO_WAL=1): replay what a previous process
        # left uncommitted, deduped by event id against what landed. A
        # dead store is logged, not fatal: `pio wal replay` lands it later.
        wal_config = ingest_wal.WalConfig.from_env()
        wal = None
        if wal_config.enabled:
            try:
                recovered = ingest_wal.recover(
                    self.storage, wal_config, stats=self.stats,
                    plugins=self.plugins)
                if recovered["replayed"] or recovered["deduped"]:
                    log.info("WAL recovery replayed %d event(s), deduped "
                             "%d", recovered["replayed"],
                             recovered["deduped"])
            except Exception:  # noqa: BLE001 - serve; the operator replays
                log.exception("WAL recovery failed; uncommitted records "
                              "remain until `pio wal replay` succeeds")
            wal = ingest_wal.IngestWal(wal_config)
        # the buffer loads the event codec (a failed build raises here)
        self.ingest = IngestBuffer(self.storage, self.stats, self.plugins,
                                   IngestConfig.from_env(), wal=wal,
                                   lease=self.lease)
        self._compact_interval = envknobs.env_float(
            "PIO_COMPACT_INTERVAL_MS", 0.0, lo=0.0) / 1000.0
        self._compact_min_bytes = envknobs.env_int(
            "PIO_COMPACT_MIN_BYTES", 1 << 20, lo=0)
        self._stop_bg = threading.Event()
        self._bg: list[threading.Thread] = []
        # the LIVE server's per-app counters are what /metrics shows
        telemetry.registry().register_collector(
            "eventserver", self._collect_metrics)
        self._httpd = _Server((host, port), self)
        self._thread: Optional[threading.Thread] = None
        if self._compact_interval > 0:
            t = threading.Thread(target=self._compact_loop, daemon=True,
                                 name="pio-event-compaction")
            t.start()
            self._bg.append(t)

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
        """Close the listener and release the partition lease."""
        self._stop_bg.set()
        self._httpd.server_close()
        if self.lease is not None:
            self.lease.release()

    def stop(self) -> None:
        self._httpd.shutdown()
        self.drain()
        self.close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def drain(self, timeout: float = 30.0) -> bool:
        """After the accept loop stopped and before the listener closes:
        refuse new requests (503, before any write), wait until no request
        is in flight (every answer written and flushed), flush the ingest
        buffer (its committers settle every queued event), then close the
        store's append handles and the WAL. False when ``timeout`` passed
        first."""
        deadline = time.monotonic() + timeout
        with self._inflight_cv:
            self._draining = True
            done = self._inflight_cv.wait_for(lambda: self._inflight == 0,
                                              timeout)
        done = self.ingest.drain(
            max(0.0, deadline - time.monotonic())) and done
        self._stop_bg.set()
        for t in self._bg:
            t.join(max(0.0, deadline - time.monotonic()))
        close = getattr(self.storage.get_l_events(), "close", None)
        if close is not None:
            close()
        if self.ingest.wal is not None:
            self.ingest.wal.close()
        return done

    def count_shed(self) -> None:
        with self._shed_lock:
            self.shed_count += 1

    def route(self, method: str, path: str):
        if method == "GET" and path == "/":
            return self.handle_root
        if method == "GET" and path == "/metrics":
            return self.handle_metrics
        if path == "/events.json":
            return {"POST": self.handle_create,
                    "GET": self.handle_find}.get(method)
        if path == "/batch/events.json" and method == "POST":
            return self.handle_batch
        if path == "/stats.json" and method == "GET":
            return self.handle_stats
        if (method == "POST" and path.startswith("/webhooks/")
                and path.endswith(".json")):
            return self.handle_webhook
        if path.startswith("/events/") and path.endswith(".json"):
            return {"GET": self.handle_get,
                    "DELETE": self.handle_delete}.get(method)
        return None

    # -- background compaction ----------------------------------------------
    def _compact_loop(self) -> None:
        """Every ``PIO_COMPACT_INTERVAL_MS``: compact this server's own log
        shards (a worker's ``.p<i>`` files) into columnar snapshots and
        retire expired generations; one scrub at start-up."""
        log_dir = getattr(self.storage.get_l_events(), "events_dir", None)
        if log_dir is None:
            return
        report = event_log.scrub_log_dir(log_dir)
        if report["quarantined"]:
            log.warning("event-log scrub quarantined %d snapshot(s)",
                        report["quarantined"])
        part = self.lease.partition if self.lease is not None else None
        own_suffix = f".p{part}.jsonl" if part is not None else ".jsonl"
        while not self._stop_bg.wait(self._compact_interval):
            try:
                for name in sorted(os.listdir(log_dir)):
                    if not name.endswith(own_suffix):
                        continue
                    path = os.path.join(log_dir, name)
                    event_log.compact_log(path, self._compact_min_bytes)
                    event_log.retire_expired(path)
            except Exception:  # noqa: BLE001 - compaction must not die
                log.exception("background compaction pass failed")

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

    def _lookup_key(self, key: str) -> Optional[AccessKey]:
        """The AccessKeys lookup behind the TTL cache (negative answers
        cached too: a flood of bad keys must not become a flood of store
        lookups)."""
        if self._key_ttl <= 0:
            return self.storage.get_meta_data_access_keys().get(key)
        hit = self._key_cache.get(key)
        now = time.monotonic()
        if hit is not None and hit[0] > now:
            return hit[1]
        access_key = self.storage.get_meta_data_access_keys().get(key)
        self._key_cache[key] = (now + self._key_ttl, access_key)
        if len(self._key_cache) > KEY_CACHE_MAX:
            # drop EXPIRED entries of either sign; if everything is fresh,
            # keep the newest half so the bound holds
            fresh = {k: v for k, v in list(self._key_cache.items())
                     if v[0] > now}
            if len(fresh) > KEY_CACHE_MAX:
                fresh = dict(sorted(fresh.items(), key=lambda kv: kv[1][0])
                             [-(KEY_CACHE_MAX // 2):])
            self._key_cache = fresh
        return access_key

    def _authorize(self, handler, query) -> AccessKey:
        key = self._access_key_str(handler, query)
        if not key:
            raise _HTTPError(401, "Missing accessKey.")
        access_key = self._lookup_key(key)
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
    def _check_event_allowed(access_key: AccessKey, name: str) -> None:
        if access_key.events and name not in access_key.events:
            raise _HTTPError(
                403, f"event {name!r} is not allowed for this access key")

    @staticmethod
    def _event_id(path: str) -> str:
        return unquote(path[len("/events/"):-len(".json")])

    # -- handlers ------------------------------------------------------------
    def handle_root(self, handler, path, query, raw):
        out = {"status": "alive"}
        if self.lease is not None:
            out["partition"] = self.lease.partition
        with self._shed_lock:
            shed = self.shed_count
        if shed:
            out["shedRequests"] = shed
        snap = self.ingest.snapshot()
        if (snap["groupsCommitted"] or snap["pending"]
                or snap["droppedEvents"] or "wal" in snap):
            out["ingest"] = snap
        return 200, out

    def _collect_metrics(self):
        """Render-time families owned by THIS server instance."""
        return [self.stats.family] if self.stats is not None else []

    def handle_metrics(self, handler, path, query, raw):
        """The process registry as Prometheus text. Unauthenticated like
        GET / (scrapers carry no access key)."""
        return 200, _Text(telemetry.render_all())

    def handle_create(self, handler, path, query, raw):
        access_key = self._authorize(handler, query)
        channel_id = self._channel_id(query, access_key)
        # per-request ack override; both paths carry the same WAL
        # durability-before-ack contract
        ack = handler.headers.get("X-Pio-Ack", "").lower()
        if ack and ack not in ("enqueue", "commit"):
            return 400, {"message": "X-Pio-Ack must be 'enqueue' or 'commit'"}
        if (ack == "enqueue") if ack else self.ingest.ack_on_enqueue:
            # validated here (the group commit's own parser), so 400/403
            # stay real; answered once queued
            try:
                event, body = parse_single_event(
                    raw, access_key.events or ())
            except EventValidationError as e:
                self._record(access_key.appid, getattr(e, "body", None), 400)
                return 400, {"message": str(e)}
            except ForbiddenEventError as e:
                return 403, {"message": str(e)}
            event_id = self.ingest.enqueue_event(
                event, body, access_key, channel_id)
            return 201, {"eventId": event_id}
        # ack=commit: the raw body rides the buffer as-is; validation, the
        # id, stats and plugins all happen inside the group commit
        try:
            event_id = self.ingest.ingest_raw(raw, access_key, channel_id)
        except EventValidationError as e:
            return 400, {"message": str(e)}
        except ForbiddenEventError as e:
            return 403, {"message": str(e)}
        return 201, {"eventId": event_id}

    def _try_native_batch(self, raw: bytes, access_key: AccessKey):
        """(ids, canonical JSONL bytes) from the codec's one-pass
        validation, or None when the Python path must run: a key with an
        event allow-list, stats or plugins on, a store without
        ``insert_canonical_lines``, or a batch the codec hands back (any
        invalid item, a client eventId, more than MAX_BATCH_SIZE items, a
        syntax error)."""
        if (access_key.events or self.stats is not None
                or self.plugins.plugins
                or not hasattr(self.storage.get_l_events(),
                               "insert_canonical_lines")):
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
                self.ingest.ingest_lines(lines, ids, access_key, channel_id)
            except (CircuitOpenError, IngestOverloadError):
                raise  # the whole request sheds
            except Exception as e:  # noqa: BLE001 - storage fault, per item
                # one entry: every item failed together
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
        # items); the valid ones ride the buffer as ONE atomic entry
        results: list[Optional[dict]] = [None] * len(body)
        valid: list[tuple[int, Event, object]] = []
        for pos, obj in enumerate(body):
            try:
                if isinstance(obj, dict):
                    obj = dict(obj)
                    obj.pop("creationTime", None)
                event = Event.from_json(obj)
                self._check_event_allowed(access_key, event.event)
                valid.append((pos, event, obj))
            except (EventValidationError, _HTTPError) as e:
                message = (str(e) if isinstance(e, EventValidationError)
                           else "forbidden")
                results[pos] = {"status": 400, "message": message}
                self._record(access_key.appid, obj, 400)
        if valid:
            try:
                ids = self.ingest.ingest_events(
                    [(event, obj if isinstance(obj, dict) else None)
                     for _, event, obj in valid],
                    access_key, channel_id)
            except (CircuitOpenError, IngestOverloadError):
                raise  # the whole request sheds
            except Exception as e:  # noqa: BLE001 - storage fault, per item
                for pos, _event, _obj in valid:
                    results[pos] = {"status": 500,
                                    "message": f"event store error: {e}"}
                return 200, results
            for (pos, _event, _obj), eid in zip(valid, ids, strict=True):
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
        if self.lease is not None:
            self.lease.verify()  # a tombstone is a write too
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

    def handle_stats(self, handler, path, query, raw):
        access_key = self._authorize(handler, query)
        if self.stats is None:
            return 404, {"message": "To see stats, launch Event Server "
                                    "with --stats argument."}
        return 200, self.stats.to_json(access_key.appid)

    def handle_webhook(self, handler, path, query, raw):
        access_key = self._authorize(handler, query)
        channel_id = self._channel_id(query, access_key)
        name = path[len("/webhooks/"):-len(".json")]
        connector = get_connector(name)
        if connector is None:
            return 404, {"message": f"webhook connector {name!r} not found"}
        ctype = handler.headers.get("Content-Type", "")
        if ctype.split(";")[0].strip() == "application/x-www-form-urlencoded":
            payload = {k: v[0] for k, v in parse_qs(
                raw.decode(errors="replace"),
                keep_blank_values=True).items()}
        else:
            try:
                payload = json.loads(raw)
            except (json.JSONDecodeError, UnicodeDecodeError):
                return 400, {"message": "invalid JSON body"}
        try:
            event_json = connector.to_event_json(payload)
            event = Event.from_json(event_json)
        except EventValidationError as e:
            return 400, {"message": str(e)}
        self._check_event_allowed(access_key, event.event)
        # webhooks feed the same write-behind buffer as direct POSTs
        if self.ingest.ack_on_enqueue:
            event_id = self.ingest.enqueue_event(
                event, event_json, access_key, channel_id)
        else:
            event_id = self.ingest.ingest_event(
                event, event_json, access_key, channel_id)
        return 201, {"eventId": event_id}

    def _record(self, app_id: int, body, status: int) -> None:
        if status < 400 and isinstance(body, dict):
            self.plugins.on_event(body)
        if self.stats is None:
            return
        name = body.get("event", "?") if isinstance(body, dict) else "?"
        etype = body.get("entityType", "?") if isinstance(body, dict) else "?"
        self.stats.record(app_id, name, etype, status)


class _Server(TLSServerMixin, ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog (socketserver's default is 5): a burst of client
    # connects — a front splicing 16 clients to one worker — would
    # overflow it, and a dropped SYN costs the client a 1 s retransmit
    request_queue_size = 128

    def __init__(self, addr, app: EventServer):
        # a bad PIO_SSL_* file raises here, before the socket is bound
        self.ssl_context = ssl_context_from_env()
        super().__init__(addr, _Handler)
        self.app = app
