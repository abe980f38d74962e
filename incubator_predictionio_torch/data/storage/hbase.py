"""HBase backend — the `HBASE` source type, over two real transports.

The port's own copy of ``incubator_predictionio_tpu/data/storage/hbase.py``;
the table names and the rowkey layout below are the reference's byte for
byte, so either package reads a table the other wrote.

Reference: storage/hbase/.../{HBLEvents,HBPEvents,HBEventsUtil}
(SURVEY.md §2.1): the event store of record, rowkeys encoding time so
scans ride rowkey order, filters evaluated server-side.  Two wire
transports implement one shared storage layout:

- ``PROTOCOL=rpc`` — the NATIVE HBase client protocol (protobuf-framed
  RPC with hbase:meta region routing, Multi-batched puts, reversed
  scanners, Filter protos pushed down), written from scratch in
  `hbase_rpc.py`.  This is the reference's own transport family.
- ``PROTOCOL=rest`` (default) — the HBase REST gateway (the
  ``hbase rest`` service, JSON representation with base64 keys/cells):
  table schema CRUD, row GET/PUT/DELETE, stateful scanners, and the
  Stargate filter spec for the same server-side filtering.

    PIO_STORAGE_SOURCES_HB_TYPE=HBASE
    PIO_STORAGE_SOURCES_HB_HOSTS=hbase-host      PORTS=8080
    PIO_STORAGE_SOURCES_HB_PROTOCOL=rest|rpc
    # rpc extras (default: same endpoint — HBase standalone topology):
    PIO_STORAGE_SOURCES_HB_MASTER_HOST=...       MASTER_PORT=16000

Layout (one table per (namespace, app, channel), like the reference's
pio_event_<appId>[_<channelId>]):

- data rows:  ``t:<eventTimeUs 16-hex><seq 16-hex>`` → cells
  ``e:json`` (full event wire JSON). Rowkey order == (time, insertion)
  order, so time-window scans are rowkey-range scans and the
  cross-backend tie-order contract holds: ``seq`` is a client-side
  monotone counter, and an upsert writes a FRESH seq (moving the event
  to the end of its tie group) after deleting the old data row.
- index rows: ``i:<eventId>`` → cell ``e:k`` holding the current data
  rowkey — the eventId → rowkey lookup for get/delete/upsert.

Filters beyond the time range are PUSHED DOWN: data rows carry the
filterable fields as dedicated cells (``e:ev``, ``e:et``, ``e:eid``,
``e:tet``, ``e:teid``) and filtered scans send a FilterList of
SingleColumnValueFilters (as Filter protos on the RPC transport, as the
Stargate JSON spec on REST — the same HBase-side evaluation the
reference's HBEventsUtil filter lists get), so a filtered find only
transfers matching rows.  The client still re-checks every returned
event (``event_matches``) as a semantic backstop, so results are
identical even against a server that ignores the filter.
"""

from __future__ import annotations

import base64
import datetime as _dt
import functools
import itertools
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterable, Iterator, Optional, Sequence

from ...common import resilience
from . import base as storage_base
from .event import Event, MonotoneNs, event_time_us, new_event_id
from .hbase_rpc import HBaseRpcError, HBaseRpcTransport
from .sqlite import _safe_ident


class HBaseError(RuntimeError):
    pass


def _rpc_wrapped(fn):
    """Normalize transport errors: every LEvents entry point raises
    HBaseError regardless of transport (the REST paths raise it
    natively; RPC-level HBaseRpcError is translated here so callers
    catch ONE backend error type)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except HBaseRpcError as e:
            raise HBaseError(str(e)) from e
    return wrapper


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


class _HBaseRest:
    """REST-gateway implementation of the shared transport interface:
    create/delete table, row get/put/delete, batched puts, range scans
    with pushdown filters (the Stargate JSON spec)."""

    native_reverse = False
    _CF = "e"

    def __init__(self, endpoint: str, timeout: float = 30.0,
                 policy: Optional["resilience.RetryPolicy"] = None,
                 breaker: Optional["resilience.CircuitBreaker"] = None):
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout
        self.policy = policy or resilience.RetryPolicy()
        self.breaker = breaker or resilience.CircuitBreaker(
            f"hbase-rest:{self.endpoint}")

    def request(self, method: str, path: str, body=None,
                want_location: bool = False):
        url = self.endpoint + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Accept": "application/json",
                     "Content-Type": "application/json"})
        try:
            with resilience.resilient_urlopen(
                req, timeout=self.timeout, policy=self.policy,
                breaker=self.breaker, point="hbase.rest",
            ) as resp:
                raw = resp.read()
                loc = resp.headers.get("Location")
                out = json.loads(raw) if raw else None
                return resp.status, (loc if want_location else out)
        except urllib.error.HTTPError as e:
            e.read()
            return e.code, None
        except resilience.CircuitOpenError:
            raise
        except (OSError, resilience.RetryBudgetExceeded) as e:
            reason = getattr(e, "reason", e)
            raise HBaseError(
                f"HBase REST gateway unreachable: {self.endpoint} "
                f"({reason})") from e

    def close(self) -> None:
        pass

    # -- schema ------------------------------------------------------------
    def create_table(self, table: str) -> None:
        status, _ = self.request(
            "PUT", f"/{table}/schema",
            body={"name": table, "ColumnSchema": [{"name": self._CF}]})
        if status not in (200, 201):
            raise HBaseError(f"create table: HTTP {status}")

    def delete_table(self, table: str) -> bool:
        """True when the table is gone on return (deleted, or 404 = was
        never there); gateway failures RAISE — parity with the RPC
        transport, so callers never mistake an orphaned table for a
        removed one."""
        status, _ = self.request("DELETE", f"/{table}/schema")
        if status not in (200, 404):
            raise HBaseError(f"delete table {table}: HTTP {status}")
        return True

    # -- rows --------------------------------------------------------------
    def _rows_body(self, rows: Sequence[tuple[bytes, dict[str, bytes]]]):
        return {"Row": [{
            "key": _b64(key),
            "Cell": [{"column": _b64(f"{self._CF}:{q}".encode()),
                      "$": _b64(v)} for q, v in cells.items()],
        } for key, cells in rows]}

    def put_rows(self, table: str,
                 rows: Sequence[tuple[bytes, dict[str, bytes]]]) -> None:
        if not rows:
            return
        if len(rows) == 1:
            row_q = urllib.parse.quote(rows[0][0].decode(), safe="")
            path = f"/{table}/{row_q}"
        else:
            path = f"/{table}/batch"
        body = self._rows_body(rows)
        status, _ = self.request("PUT", path, body=body)
        if status == 404:
            # auto-create on first write (contract: insert without init)
            self.create_table(table)
            status, _ = self.request("PUT", path, body=body)
        if status not in (200, 201):
            raise HBaseError(f"put {table}: HTTP {status}")

    def get_row(self, table: str, key: bytes) -> Optional[dict[str, bytes]]:
        row_q = urllib.parse.quote(key.decode(), safe="")
        status, out = self.request("GET", f"/{table}/{row_q}")
        if status == 404 or not out:
            return None
        if status != 200:
            raise HBaseError(f"get {table}/{key!r}: HTTP {status}")
        cells = {}
        for row in out.get("Row", []):
            for cell in row.get("Cell", []):
                col = _unb64(cell["column"]).decode()
                cells[col.split(":", 1)[1]] = _unb64(cell["$"])
        return cells or None

    def delete_row(self, table: str, key: bytes) -> bool:
        row_q = urllib.parse.quote(key.decode(), safe="")
        status, _ = self.request("DELETE", f"/{table}/{row_q}")
        return status == 200

    # -- scans -------------------------------------------------------------
    def scan(self, table: str, start: bytes, stop: bytes,
             filter_spec: Optional[dict] = None,
             reverse: bool = False,
             batch: int = 1000) -> Iterator[tuple[bytes, dict[str, bytes]]]:
        """Rowkey-range scan via the stateful scanner API; an optional
        filter spec evaluates server-side (only matches cross the wire).
        The gateway has no reversed scanner (native_reverse=False) —
        callers needing descending order materialize and sort."""
        assert not reverse, "REST gateway scans are forward-only"
        body = {"batch": batch, "startRow": _b64(start),
                "endRow": _b64(stop)}
        if filter_spec is not None:
            # the gateway's scanner model carries the filter as a STRING
            # holding the filter's own JSON serialization
            body["filter"] = json.dumps(filter_spec)
        status, location = self.request(
            "PUT", f"/{table}/scanner", body=body, want_location=True)
        if status == 404:
            return
        if status != 201 or not location:
            raise HBaseError(f"open scanner on {table}: HTTP {status}")
        path = urllib.parse.urlsplit(location).path
        try:
            while True:
                status, out = self.request("GET", path)
                if status == 204:
                    return
                if status != 200:
                    raise HBaseError(f"scanner read: HTTP {status}")
                for row in (out or {}).get("Row", []):
                    key = _unb64(row["key"])
                    cells = {}
                    for cell in row.get("Cell", []):
                        col = _unb64(cell["column"]).decode()
                        cells[col.split(":", 1)[1]] = _unb64(cell["$"])
                    if cells:
                        yield key, cells
        finally:
            self.request("DELETE", path)


class HBLEvents(storage_base.LEvents):
    _CF = "e"

    def __init__(self, transport, namespace: str):
        self._t = transport
        self._ns = _safe_ident(namespace).lower()
        self._seq = MonotoneNs()

    def _table(self, app_id: int, channel_id: Optional[int]) -> str:
        name = f"{self._ns}_{int(app_id)}"
        if channel_id is not None:
            name += f"_{int(channel_id)}"
        return name

    def _next_seq(self) -> int:
        # Caveat vs the PG backend: HBase has no cheap max-rowkey read to
        # prime the counter from, so a wall clock stepped BACKWARDS
        # between writer restarts can order an upsert below its
        # pre-existing tie group (ties are otherwise insertion-ordered;
        # simultaneous multi-writer ties are unspecified by the contract
        # either way).
        return self._seq.next()

    _time_us = staticmethod(event_time_us)

    @staticmethod
    def _data_key(time_us: int, seq: int) -> bytes:
        # +2^63 bias: pre-epoch (negative) times still render fixed-width
        # unsigned hex, keeping lexicographic rowkey order == time order
        return f"t:{time_us + 2**63:017x}{seq:016x}".encode()

    @staticmethod
    def _index_key(event_id: str) -> bytes:
        return b"i:" + event_id.encode()

    @staticmethod
    def _event_cells(stored: Event) -> dict[str, bytes]:
        """Data-row cells: the wire JSON plus the filterable fields as
        dedicated cells so scans can evaluate filters server-side."""
        cells = {"json": json.dumps(stored.to_json()).encode(),
                 "ev": stored.event.encode(),
                 "et": stored.entity_type.encode(),
                 "eid": stored.entity_id.encode()}
        if stored.target_entity_type is not None:
            cells["tet"] = stored.target_entity_type.encode()
        if stored.target_entity_id is not None:
            cells["teid"] = stored.target_entity_id.encode()
        return cells

    def _scv(self, qualifier: str, value: str) -> dict:
        """SingleColumnValueFilter(EQUAL) in the transport-neutral spec
        (the Stargate JSON shape; the RPC transport re-serializes it to
        Filter protos).

        ifMissing=False: rows LACKING the column pass the server filter
        and fall through to the client-side ``event_matches`` backstop.
        That keeps rows written before the filterable cells existed
        (json-only format) visible to filtered finds — dropping them
        server-side would be silent data invisibility. Rows written by
        the current format always carry ev/et/eid, so the common
        filters still prune server-side exactly; only target-field
        filters transfer target-less events for the client to drop."""
        return {"type": "SingleColumnValueFilter", "op": "EQUAL",
                "family": _b64(self._CF.encode()),
                "qualifier": _b64(qualifier.encode()),
                "comparator": {"type": "BinaryComparator",
                               "value": _b64(value.encode())},
                "ifMissing": False, "latestVersion": True}

    def _filter_spec(self, entity_type, entity_id, event_names,
                     target_entity_type, target_entity_id) -> Optional[dict]:
        """Server-side filter for everything the rowkey range can't do;
        None when unfiltered (plain scans skip the parameter)."""
        clauses = []
        if entity_type is not None:
            clauses.append(self._scv("et", entity_type))
        if entity_id is not None:
            clauses.append(self._scv("eid", entity_id))
        if target_entity_type is not None:
            clauses.append(self._scv("tet", target_entity_type))
        if target_entity_id is not None:
            clauses.append(self._scv("teid", target_entity_id))
        if event_names is not None:
            names = list(event_names)
            alts = [self._scv("ev", n) for n in names]
            if len(alts) == 1:
                clauses.append(alts[0])
            elif alts:
                clauses.append({"type": "FilterList",
                                "op": "MUST_PASS_ONE", "filters": alts})
        if not clauses:
            return None
        if len(clauses) == 1:
            return clauses[0]
        return {"type": "FilterList", "op": "MUST_PASS_ALL",
                "filters": clauses}

    # -- table lifecycle ---------------------------------------------------
    @_rpc_wrapped
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._t.create_table(self._table(app_id, channel_id))
        return True

    @_rpc_wrapped
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        return self._t.delete_table(self._table(app_id, channel_id))

    # -- LEvents contract --------------------------------------------------
    @_rpc_wrapped
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        table = self._table(app_id, channel_id)
        fresh = not event.event_id
        eid = event.event_id or new_event_id()
        stored = event.with_event_id(eid)
        if not fresh:
            # only client-supplied ids can collide (upsert); fresh uuids
            # skip the index round trip
            old = self._t.get_row(table, self._index_key(eid))
            if old and "k" in old:
                self._t.delete_row(table, old["k"])
        data_key = self._data_key(self._time_us(stored.event_time),
                                  self._next_seq())
        self._t.put_rows(table, [(data_key, self._event_cells(stored)),
                                 (self._index_key(eid), {"k": data_key})])
        return eid

    @_rpc_wrapped
    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> list[str]:
        """Bulk ingest via multi-row puts (the REST gateway's /batch, or
        one Multi per region on RPC): one request per chunk instead of
        2-3 per event. Events carrying client-supplied ids fall back to
        the upsert-aware single-insert path."""
        table = self._table(app_id, channel_id)
        ids: list[str] = []
        CHUNK = 500
        rows: list[tuple[bytes, dict[str, bytes]]] = []

        def flush():
            if rows:
                self._t.put_rows(table, rows)
                rows.clear()

        for e in events:
            if e.event_id:
                flush()
                ids.append(self.insert(e, app_id, channel_id))
            else:
                eid = new_event_id()
                stored = e.with_event_id(eid)
                data_key = self._data_key(self._time_us(stored.event_time),
                                          self._next_seq())
                rows.append((data_key, self._event_cells(stored)))
                rows.append((self._index_key(eid), {"k": data_key}))
                ids.append(eid)
                if len(rows) >= 2 * CHUNK:
                    flush()
        flush()
        return ids

    @_rpc_wrapped
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        table = self._table(app_id, channel_id)
        idx = self._t.get_row(table, self._index_key(event_id))
        if not idx or "k" not in idx:
            return None
        data = self._t.get_row(table, idx["k"])
        if not data or "json" not in data:
            return None
        return Event.from_json(json.loads(data["json"].decode()))

    @_rpc_wrapped
    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        table = self._table(app_id, channel_id)
        idx = self._t.get_row(table, self._index_key(event_id))
        if not idx or "k" not in idx:
            return False
        self._t.delete_row(table, idx["k"])
        self._t.delete_row(table, self._index_key(event_id))
        return True

    def _scan_events(self, table: str, start_key: bytes, end_key: bytes,
                     spec: Optional[dict],
                     reverse: bool = False) -> Iterator[Event]:
        for _key, cells in self._t.scan(table, start_key, end_key,
                                        filter_spec=spec, reverse=reverse):
            raw = cells.get("json")
            if raw is not None:
                yield Event.from_json(json.loads(raw.decode()))

    def _scan_reversed_native(self, table: str, start_key: bytes,
                              end_key: bytes,
                              spec: Optional[dict]) -> Iterator[Event]:
        """Stream the native reversed scanner while preserving the
        contract order: time DESC but ties (same time) in insertion
        (seq) ASC order.  Rows arrive (time DESC, seq DESC); buffering
        one tie group — consecutive rows sharing the 17-hex time prefix
        of the rowkey — and flipping it restores seq ASC within ties,
        with memory bounded by the largest tie group instead of the
        whole window (what the REST path has to materialize)."""
        group: list[Event] = []
        group_time: Optional[bytes] = None
        for key, cells in self._t.scan(table, start_key, end_key,
                                       filter_spec=spec, reverse=True):
            raw = cells.get("json")
            if raw is None:
                continue
            tkey = key[:19]      # b"t:" + 17-hex time
            if tkey != group_time:
                yield from reversed(group)
                group = []
                group_time = tkey
            group.append(Event.from_json(json.loads(raw.decode())))
        yield from reversed(group)

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed_order: bool = False,
    ) -> Iterator[Event]:
        from .memory import event_matches

        table = self._table(app_id, channel_id)
        start_key = (self._data_key(self._time_us(start_time), 0)
                     if start_time is not None else b"t:")
        end_key = (self._data_key(self._time_us(until_time), 0)
                   if until_time is not None else b"t;")  # ';' > ':'
        if event_names is not None:
            # materialize ONCE: a one-shot iterable must survive the
            # emptiness check, the filter-spec build, AND every
            # event_matches membership test below
            event_names = list(event_names)
            if not event_names:
                return iter(())
        spec = self._filter_spec(entity_type, entity_id, event_names,
                                 target_entity_type, target_entity_id)
        if limit is not None and limit < 0:
            limit = None

        def matches(e: Event) -> bool:
            # event_matches stays as a semantic backstop: results are
            # identical even against a server that ignores the filter.
            return event_matches(e, start_time, until_time, entity_type,
                                 entity_id, event_names, target_entity_type,
                                 target_entity_id)

        try:
            if reversed_order:
                if getattr(self._t, "native_reverse", False):
                    # RPC: the native reversed scanner streams — no
                    # window materialization
                    it = (e for e in self._scan_reversed_native(
                        table, start_key, end_key, spec) if matches(e))
                else:
                    # REST: no reversed scanner — materialize the window
                    # (time DESC, tie insertion ASC via stable sort).
                    # Bound the scan with start_time/until_time for
                    # "latest N" queries on large apps.
                    events = sorted(
                        (e for e in self._scan_events(
                            table, start_key, end_key, spec)
                         if matches(e)),
                        key=lambda e: self._time_us(e.event_time),
                        reverse=True)
                    it = iter(events)
            else:
                it = (e for e in self._scan_events(
                    table, start_key, end_key, spec) if matches(e))
            yield from (itertools.islice(it, limit)
                        if limit is not None else it)
        except HBaseRpcError as e:
            raise HBaseError(str(e)) from e


class HBPEvents(storage_base.PEvents):
    def __init__(self, l_events: HBLEvents):
        self._l = l_events

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None) -> Iterator[Event]:
        return self._l.find(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
        )

    def write(self, events: Iterable[Event], app_id: int,
              channel_id: Optional[int] = None) -> None:
        for e in events:
            self._l.insert(e, app_id, channel_id)

    def delete(self, event_ids: Iterable[str], app_id: int,
               channel_id: Optional[int] = None) -> None:
        for eid in event_ids:
            self._l.delete(eid, app_id, channel_id)


class HBaseClient(storage_base.BaseStorageClient):
    """`TYPE=HBASE`; properties HOSTS (gateway/region-server host or
    URL), PORTS, PROTOCOL (``rest`` default | ``rpc`` native), and for
    rpc MASTER_HOST/MASTER_PORT (default: the HOSTS endpoint — the
    HBase standalone topology where one process serves master + meta +
    user regions).  Event data only — the reference's HBase role (the
    event store of record; metadata/models ride another source)."""

    def __init__(self, config: storage_base.StorageClientConfig):
        super().__init__(config)
        p = config.properties
        host = (p.get("HOSTS") or "").split(",")[0].strip()
        if not host:
            raise ValueError(
                "HBASE source needs PIO_STORAGE_SOURCES_<NAME>_HOSTS")
        protocol = (p.get("PROTOCOL") or "rest").strip().lower()
        if protocol == "rpc":
            port = (p.get("PORTS") or "16020").split(",")[0].strip()
            self._transport = HBaseRpcTransport(
                host, int(port),
                master_host=(p.get("MASTER_HOST") or "").strip() or None,
                master_port=(p.get("MASTER_PORT") or "").strip() or None,
                user=(p.get("USERNAME") or "pio").strip() or "pio",
                policy=resilience.policy_from_props(
                    p, max_attempts=3, max_delay=1.0),
                breaker=resilience.breaker_from_props(
                    p, f"hbase-rpc:{host}:{port}"))
            # fail fast on an unreachable cluster (reference: per-backend
            # StorageClient constructors surface dead stores in `pio
            # status`), with the policy's paced retry bridging restarts
            self._transport.ping()
        elif protocol == "rest":
            port = (p.get("PORTS") or "8080").split(",")[0].strip()
            endpoint = host if "://" in host else f"http://{host}:{port}"
            self._transport = _HBaseRest(
                endpoint,
                policy=resilience.policy_from_props(p),
                breaker=resilience.breaker_from_props(
                    p, f"hbase-rest:{endpoint}"))
            storage_base.check_reachable(endpoint, "HBase REST gateway")
        else:
            raise ValueError(
                f"HBASE PROTOCOL must be 'rest' or 'rpc', got {protocol!r}")
        self._daos: dict = {}

    def breaker_states(self) -> list[dict]:
        b = getattr(self._transport, "breaker", None) or getattr(
            self._transport, "_breaker", None)
        return [b.snapshot()] if b is not None else []

    def close(self) -> None:
        self._transport.close()

    def l_events(self, namespace: str = "pio_eventdata"):
        dao = self._daos.get(namespace)
        if dao is None:
            dao = self._daos[namespace] = HBLEvents(self._transport, namespace)
        return dao

    def p_events(self, namespace: str = "pio_eventdata"):
        return HBPEvents(self.l_events(namespace))
