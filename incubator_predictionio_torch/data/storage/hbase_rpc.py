"""HBase native RPC transport — the protobuf wire protocol.

The port's own copy of
``incubator_predictionio_tpu/data/storage/hbase_rpc.py``: the same frames
byte for byte (``tests/fixtures/hbase_rpc_golden.hex``), the same fault
points (``hbase.rpc``, ``hbase.ping``) and telemetry families.

Reference: storage/hbase/.../{HBLEvents,HBEventsUtil,HBClients}
(SURVEY.md §2.1): the reference's event store of record speaks HBase's
NATIVE client protocol — protobuf-framed RPC to region servers, with
filter lists evaluated server-side. The REST gateway transport is the
other half of that row; this module is the native half, written from
scratch against the public HBase RPC wire
contract (no HBase client library, no generated protobuf code — the
codec below hand-rolls the handful of message shapes the client needs,
in the same spirit as `pgwire.py` / `mysqlwire.py`).

Wire protocol implemented here:

- connection preamble ``b"HBas" + version 0 + auth SIMPLE (0x50)``,
  then a 4-byte big-endian length + ``ConnectionHeader`` naming the
  service (``ClientService`` / ``MasterService``) and user.  No
  cell-block codec is negotiated, so servers answer with pure-protobuf
  ``Cell`` messages inside ``Result`` — the simpler of the two legal
  response encodings (cell blocks are an optional optimization the
  server may only use when the client advertises a codec).
- each call: 4-byte BE total length, then varint-delimited
  ``RequestHeader`` (call_id, method_name, request_param) and
  varint-delimited request message.  Responses mirror that with a
  ``ResponseHeader`` whose optional ``exception`` field carries the
  server-side stack (surfaced as :class:`HBaseRpcError`).
- region location: a scan of the ``hbase:meta`` catalog table (region
  name ``hbase:meta,,1``) on the bootstrap server, parsing
  ``info:regioninfo`` (PBUF-magic-prefixed ``RegionInfo``) and
  ``info:server`` cells — the same catalog walk the real client does
  once ZooKeeper has told it where meta lives.  This transport takes
  the meta location from configuration instead of a ZK quorum (in
  HBase standalone mode the single process serves master + meta +
  user regions on one port, which is exactly this transport's default
  topology).  Locations are cached per table and invalidated on
  ``NotServingRegionException`` / ``RegionMovedException`` retries.
- data path: ``Get`` / ``Mutate`` / ``Multi`` (batched puts grouped
  per region) / ``Scan`` (open → next → close, forward AND reversed —
  the native protocol has a reversed scanner the REST gateway lacks),
  with filter pushdown: the transport-neutral filter spec the HBASE
  backend builds (SingleColumnValueFilter / FilterList dicts, see
  `hbase.py`) is serialized to the real ``Filter`` protos
  (``filter.SingleColumnValueFilter`` wrapping a BinaryComparator,
  ``filter.FilterList`` with MUST_PASS_ALL/ONE) so only matching rows
  cross the wire.
- schema path: ``CreateTable`` / ``DisableTable`` / ``DeleteTable``
  against ``MasterService``.  Real masters run these as async
  procedures; this client treats the RPC ack as completion, which
  holds for standalone/dev topologies (documented limitation).

Field numbers follow the public HBase protocol definitions (HBase.proto
/ Client.proto / Filter.proto / Master.proto wire contract).  Like the
other network backends, the protocol is exercised against in-repo
servers that implement the server side of the same contract: the
reference's mock (`tests/hbase_rpc_mock.py`, multi-region routing and
adversarial modes) and the port's stand-in
(`tests/torch_hbase_rpc_server.py`, on this module's codec); it has not
been run against a live cluster.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Iterator, Optional, Sequence

from ...common import faultinject, resilience, telemetry

#: transport op metrics, same families every urlopen-based backend
#: reports into (common/resilience.py) — this client speaks raw
#: sockets, so it records its RPCs itself
_RPC_SECONDS = resilience.STORAGE_OP_SECONDS.labels("hbase.rpc")
_RPC_ERRORS = resilience.STORAGE_OP_ERRORS.labels("hbase.rpc")

__all__ = ["HBaseRpcError", "HBaseRpcTransport", "PB", "pb_decode",
           "pb_delimited", "read_delimited"]


# ---------------------------------------------------------------------------
# protobuf primitives (hand-rolled: varints, tags, length-delimited fields)
# ---------------------------------------------------------------------------

def _enc_varint(n: int) -> bytes:
    if n < 0:
        # proto int32/int64 negatives are 10-byte two's complement varints
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class PB:
    """Tiny protobuf message builder: append fields, read back bytes."""

    def __init__(self):
        self._buf = bytearray()

    def varint(self, field: int, value: int) -> "PB":
        self._buf += _enc_varint(field << 3 | 0)
        self._buf += _enc_varint(value)
        return self

    def bool_(self, field: int, value: bool) -> "PB":
        return self.varint(field, 1 if value else 0)

    def bytes_(self, field: int, data: bytes) -> "PB":
        self._buf += _enc_varint(field << 3 | 2)
        self._buf += _enc_varint(len(data))
        self._buf += data
        return self

    def string(self, field: int, s: str) -> "PB":
        return self.bytes_(field, s.encode())

    def msg(self, field: int, sub: "PB | bytes") -> "PB":
        return self.bytes_(field, sub if isinstance(sub, bytes)
                           else sub.bytes())

    def bytes(self) -> bytes:
        return bytes(self._buf)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise HBaseRpcError("truncated varint in protobuf frame")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise HBaseRpcError("malformed varint in protobuf frame")


def pb_decode(buf: bytes) -> dict[int, list]:
    """Decode one message into {field: [values]} — ints for varint /
    fixed fields, bytes for length-delimited (nested messages decode
    lazily by calling pb_decode on the bytes)."""
    fields: dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > len(buf):
                raise HBaseRpcError("truncated length-delimited field")
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            if pos + 4 > len(buf):
                raise HBaseRpcError("truncated fixed32 field")
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wt == 1:
            if pos + 8 > len(buf):
                raise HBaseRpcError("truncated fixed64 field")
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        else:
            raise HBaseRpcError(f"unsupported protobuf wire type {wt}")
        fields.setdefault(field, []).append(val)
    return fields


def _first(fields: dict[int, list], field: int, default=None):
    vals = fields.get(field)
    return vals[0] if vals else default


def pb_delimited(msg: "PB | bytes") -> bytes:
    data = msg if isinstance(msg, bytes) else msg.bytes()
    return _enc_varint(len(data)) + data


def read_delimited(buf: bytes, pos: int) -> tuple[bytes, int]:
    ln, pos = _read_varint(buf, pos)
    if pos + ln > len(buf):
        raise HBaseRpcError("truncated delimited message")
    return buf[pos:pos + ln], pos + ln


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

class HBaseRpcError(RuntimeError):
    """Typed RPC failure; remote exceptions carry the Java class name."""

    def __init__(self, message: str, exception_class: str = "",
                 do_not_retry: bool = False, connection_lost: bool = False):
        super().__init__(message)
        self.exception_class = exception_class
        self.do_not_retry = do_not_retry
        self.connection_lost = connection_lost

    @property
    def retriable_region(self) -> bool:
        """Relocate and retry: region-location staleness, or a lost
        connection (the retry reconnects — the cache was evicted)."""
        if self.connection_lost:
            return True
        short = self.exception_class.rsplit(".", 1)[-1]
        return short in ("NotServingRegionException", "RegionMovedException",
                         "RegionOpeningException")

    @property
    def table_missing(self) -> bool:
        short = self.exception_class.rsplit(".", 1)[-1]
        return short == "TableNotFoundException"


# enum values from the public protocol
_CMP = {"LESS": 0, "LESS_OR_EQUAL": 1, "EQUAL": 2, "NOT_EQUAL": 3,
        "GREATER_OR_EQUAL": 4, "GREATER": 5, "NO_OP": 6}
_MUTATE_PUT = 2
_MUTATE_DELETE = 3
_REGION_NAME = 1
_FILTER_PKG = "org.apache.hadoop.hbase.filter."
_META_REGION = b"hbase:meta,,1"
_PBUF_MAGIC = b"PBUF"


# ---------------------------------------------------------------------------
# one RPC connection (per server × service)
# ---------------------------------------------------------------------------

class _Conn:
    def __init__(self, host: str, port: int, service: str, user: str,
                 timeout: float):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        self._lock = threading.Lock()
        self._call_id = 0
        self._closed = False
        # preamble: magic, version 0, auth SIMPLE (0x50)
        self.sock.sendall(b"HBas" + bytes([0, 0x50]))
        header = (PB()
                  .msg(1, PB().string(1, user))     # UserInformation
                  .string(2, service))              # ClientService / Master…
        self.sock.sendall(struct.pack(">I", len(header.bytes()))
                          + header.bytes())

    def _recv(self, n: int) -> bytes:
        chunks = bytearray()
        while len(chunks) < n:
            part = self.sock.recv(n - len(chunks))
            if not part:
                raise HBaseRpcError("connection closed by region server",
                                    connection_lost=True)
            chunks += part
        return bytes(chunks)

    def call(self, method: str, param: "PB | bytes") -> dict[int, list]:
        """One request/response round trip; returns the decoded response
        message (the part after the ResponseHeader)."""
        with self._lock:
            self._call_id += 1
            call_id = self._call_id
            rh = (PB().varint(1, call_id)
                  .string(3, method)
                  .bool_(4, True))                  # request_param follows
            frame = pb_delimited(rh) + pb_delimited(
                param if isinstance(param, bytes) else param.bytes())
            self.sock.sendall(struct.pack(">I", len(frame)) + frame)
            total = struct.unpack(">I", self._recv(4))[0]
            buf = self._recv(total)
        # a frame that fails to PARSE means the stream framing can't be
        # trusted anymore — mark connection_lost so the caller evicts
        # this connection and retries on a fresh one (a server-reported
        # exception below is a VALID response and stays non-connection)
        try:
            header_bytes, pos = read_delimited(buf, 0)
            header = pb_decode(header_bytes)
            body_fields: Optional[dict[int, list]] = None
            if pos < len(buf):
                body, _pos = read_delimited(buf, pos)
                body_fields = pb_decode(body)
        except HBaseRpcError as e:
            raise HBaseRpcError(f"malformed response frame: {e}",
                                connection_lost=True) from e
        got_id = _first(header, 1, -1)
        if got_id != call_id:
            raise HBaseRpcError(
                f"response call_id {got_id} != request {call_id}",
                connection_lost=True)
        exc = _first(header, 2)
        if exc is not None:
            e = pb_decode(exc)
            cls = _first(e, 1, b"").decode(errors="replace")
            stack = _first(e, 2, b"").decode(errors="replace")
            raise HBaseRpcError(
                f"{cls}: {stack.splitlines()[0] if stack else method}",
                exception_class=cls,
                do_not_retry=bool(_first(e, 5, 0)))
        return body_fields if body_fields is not None else {}

    def close(self):
        if not self._closed:
            self._closed = True
            try:
                self.sock.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# region locations
# ---------------------------------------------------------------------------

class _Region:
    __slots__ = ("name", "start", "end", "server")

    def __init__(self, name: bytes, start: bytes, end: bytes,
                 server: tuple[str, int]):
        self.name = name
        self.start = start
        self.end = end      # b"" = unbounded
        self.server = server

    def contains(self, row: bytes) -> bool:
        return row >= self.start and (not self.end or row < self.end)

    def overlaps(self, start: bytes, stop: Optional[bytes]) -> bool:
        if stop and self.start and self.start >= stop:
            return False
        return not self.end or self.end > start


def _table_name_pb(table: str) -> PB:
    return PB().bytes_(1, b"default").bytes_(2, table.encode())


def _region_spec(name: bytes) -> PB:
    return PB().varint(1, _REGION_NAME).bytes_(2, name)


class HBaseRpcTransport:
    """Transport interface shared with `_HBaseRest` (see hbase.py):
    create/delete table, row get/put/delete, batched puts, range scans
    with pushdown filters — over the native protobuf RPC protocol with
    hbase:meta region routing."""

    native_reverse = True

    def __init__(self, host: str, port: int,
                 master_host: Optional[str] = None,
                 master_port: Optional[int] = None,
                 family: str = "e", user: str = "pio",
                 timeout: float = 30.0,
                 policy: Optional[resilience.RetryPolicy] = None,
                 breaker: Optional[resilience.CircuitBreaker] = None):
        self._bootstrap = (host, int(port))
        self._master = (master_host or host,
                        int(master_port) if master_port else int(port))
        self._family = family.encode()
        self._user = user
        self._timeout = timeout
        # Shared resilience plumbing: the policy paces the relocate/retry
        # loops (jittered backoff instead of immediate hammering) and the
        # per-endpoint breaker fails fast once the cluster is clearly gone.
        self._policy = policy or resilience.RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=1.0)
        self._breaker = breaker or resilience.CircuitBreaker(
            f"hbase-rpc:{host}:{port}")
        self._conns: dict[tuple[str, int, str], _Conn] = {}
        self._regions: dict[str, list[_Region]] = {}
        self._lock = threading.Lock()
        #: scanners whose generator was dropped before exhaustion.
        #: Closes are DEFERRED to the next transport call on the
        #: caller's own thread: a generator's finally may run inside a
        #: GC pass triggered while this thread already holds _lock or a
        #: connection lock (non-reentrant) — issuing the close RPC from
        #: the finalizer would deadlock, the bug class pgwire's
        #: _in_conversation guard fixes. list.append is atomic, so the
        #: finalizer only ever touches this list.
        self._pending_scanner_closes: list[tuple[tuple[str, int], int]] = []

    # -- connections -------------------------------------------------------
    def _conn(self, server: tuple[str, int], service: str) -> _Conn:
        key = (server[0], server[1], service)
        with self._lock:
            conn = self._conns.get(key)
        if conn is not None:
            return conn
        # connect OUTSIDE the lock: a black-holed server must not stall
        # other threads' calls to healthy servers for the whole timeout
        try:
            fresh = _Conn(server[0], server[1], service, self._user,
                          self._timeout)
        except OSError as e:
            # connection_lost: a dead server is the COMMONEST reason a
            # cached region location is stale — the relocate-and-retry
            # path must fire for dial failures exactly as it does for
            # mid-call socket loss
            raise HBaseRpcError(
                f"HBase region server unreachable: "
                f"{server[0]}:{server[1]} ({e})",
                connection_lost=True) from e
        with self._lock:
            existing = self._conns.get(key)
            if existing is not None:
                fresh.close()
                return existing
            self._conns[key] = fresh
            return fresh

    def _drain_pending_closes(self) -> None:
        """Best-effort close of scanners abandoned mid-iteration; runs
        on a normal caller thread OUTSIDE any transport lock (servers
        also reclaim scanners via their lease timeout, so failures here
        are harmless)."""
        while self._pending_scanner_closes:
            try:
                server, scanner_id = self._pending_scanner_closes.pop()
            except IndexError:   # lost a race with another drainer
                return
            try:
                conn = self._conn(server, "ClientService")
                conn.call("Scan", PB().varint(3, scanner_id).bool_(5, True))
            except (HBaseRpcError, OSError):
                pass

    def _call(self, server: tuple[str, int], service: str, method: str,
              param: "PB | bytes") -> dict[int, list]:
        """One RPC with dead-connection hygiene: socket-level failures
        become typed connection_lost errors (retriable — the retry
        reconnects) and the broken connection is evicted so it can't
        poison later calls or desync the length framing. Every outcome
        feeds the endpoint breaker: connectivity failures count against
        it, while server-reported application exceptions count as
        SUCCESSES (the endpoint answered — it is healthy)."""
        self._breaker.check()
        conn: Optional[_Conn] = None
        t0 = telemetry.timer_start()
        try:
            faultinject.fault_point("hbase.rpc")
            conn = self._conn(server, service)
            result = conn.call(method, param)
        except HBaseRpcError as e:
            _RPC_ERRORS.inc()
            if e.connection_lost:
                if conn is not None:
                    self._drop_conn(server, service, conn)
                self._breaker.record_failure()
            else:
                self._breaker.record_success()
            raise
        except OSError as e:
            _RPC_ERRORS.inc()
            if conn is not None:
                self._drop_conn(server, service, conn)
            self._breaker.record_failure()
            raise HBaseRpcError(
                f"connection to {server[0]}:{server[1]} lost: {e}",
                connection_lost=True) from e
        finally:
            _RPC_SECONDS.observe_since(t0)
        self._breaker.record_success()
        return result

    def _drop_conn(self, server: tuple[str, int], service: str,
                   conn: Optional[_Conn] = None) -> None:
        """Evict a connection by IDENTITY: when `conn` is given, only
        pop the cache entry if it still holds that same object — a
        concurrent thread may already have replaced a dead connection
        with a healthy one that must not be closed mid-use."""
        key = (server[0], server[1], service)
        with self._lock:
            cached = self._conns.get(key)
            if conn is not None and cached is not conn:
                victim = conn        # close the failed conn, keep the cache
            else:
                victim = self._conns.pop(key, None)
        if victim is not None:
            victim.close()

    def close(self) -> None:
        try:
            self._drain_pending_closes()
        except Exception:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()

    # -- meta lookup -------------------------------------------------------
    def _locate(self, table: str, refresh: bool = False) -> list[_Region]:
        with self._lock:
            if not refresh and table in self._regions:
                return self._regions[table]
        prefix = table.encode() + b","
        # all meta rows for `table` sort between "table," and "table-"
        # (',' = 0x2C and '-' = 0x2D are adjacent bytes)
        stop = table.encode() + b"-"
        regions: list[_Region] = []
        for _key, cells in self._scan_region(
                self._bootstrap, _META_REGION, prefix, stop, None, False,
                all_families=True):
            info = cells.get((b"info", b"regioninfo"))
            server = cells.get((b"info", b"server"))
            if info is None or server is None:
                continue
            if info.startswith(_PBUF_MAGIC):
                info = info[len(_PBUF_MAGIC):]
            ri = pb_decode(info)
            if _first(ri, 5, 0) or _first(ri, 6, 0):   # offline / split parent
                continue
            host, _, port = server.decode().rpartition(":")
            regions.append(_Region(
                name=_key, start=_first(ri, 3, b""), end=_first(ri, 4, b""),
                server=(host, int(port))))
        regions.sort(key=lambda r: r.start)
        if not regions:
            raise HBaseRpcError(
                f"TableNotFoundException: {table}",
                exception_class=("org.apache.hadoop.hbase."
                                 "TableNotFoundException"),
                do_not_retry=True)
        with self._lock:
            self._regions[table] = regions
        return regions

    def _invalidate(self, table: str) -> None:
        with self._lock:
            self._regions.pop(table, None)

    def ping(self) -> None:
        """Health probe through the retry policy: reach the bootstrap
        region server (connection preamble handshake) with jittered
        backoff; repeated failures trip the endpoint breaker."""
        def probe():
            faultinject.fault_point("hbase.ping")
            self._conn(self._bootstrap, "ClientService")
        self._policy.call(probe, breaker=self._breaker)

    def _pace_retry(self, attempt: int) -> None:
        """Jittered backoff between relocate-and-retry rounds — a dead
        region server must not be hammered in a tight loop."""
        delay = self._policy.backoff(attempt)
        if delay > 0:
            time.sleep(delay)

    def _with_region_retry(self, table: str, row: bytes, fn):
        """Run fn(region) with stale-location retries — the client-side
        half of HBase's region-move protocol, paced by the retry
        policy's jittered backoff."""
        last: Optional[HBaseRpcError] = None
        for attempt in range(3):
            try:
                regions = self._locate(table, refresh=attempt > 0)
                region = next((r for r in regions if r.contains(row)), None)
                if region is None:
                    raise HBaseRpcError(
                        f"no region of {table} contains row {row!r}")
                return fn(region)
            except HBaseRpcError as e:
                # the meta-scan half of the lookup is as retriable as
                # the data op itself (same desync/dead-server causes)
                if not e.retriable_region:
                    raise
                last = e
                self._invalidate(table)
                if attempt < 2:
                    self._pace_retry(attempt)
        assert last is not None
        raise last

    # -- schema (MasterService) --------------------------------------------
    def create_table(self, table: str) -> None:
        schema = (PB()
                  .msg(1, _table_name_pb(table))
                  .msg(3, PB().bytes_(1, self._family)))   # ColumnFamilySchema
        req = PB().msg(1, schema)
        try:
            self._call(self._master, "MasterService", "CreateTable", req)
        except HBaseRpcError as e:
            if e.exception_class.rsplit(".", 1)[-1] != "TableExistsException":
                raise
        self._invalidate(table)

    def delete_table(self, table: str) -> bool:
        """True when the table is gone on return (deleted, or was never
        there — idempotent removal); raises on real failures."""
        name = _table_name_pb(table)
        try:
            self._call(self._master, "MasterService", "DisableTable",
                       PB().msg(1, name))
        except HBaseRpcError as e:
            short = e.exception_class.rsplit(".", 1)[-1]
            if short == "TableNotFoundException":
                return True
            if short not in ("TableNotDisabledException",
                             "TableNotEnabledException"):
                # already-disabled is fine; anything else is real
                raise
        try:
            self._call(self._master, "MasterService", "DeleteTable",
                       PB().msg(1, name))
        except HBaseRpcError as e:
            if e.exception_class.rsplit(".", 1)[-1] != "TableNotFoundException":
                raise
        self._invalidate(table)
        return True

    # -- cells <-> protos --------------------------------------------------
    def _decode_result(self, result: dict[int, list],
                       all_families: bool = False) -> \
            tuple[bytes, dict]:
        """One Result message → (rowkey, cells).  Data-path cells of the
        configured family key by qualifier string; all_families=True
        (the meta scan) keys by (family, qualifier) bytes tuples."""
        row = b""
        cells: dict = {}
        for cell_bytes in result.get(1, []):
            c = pb_decode(cell_bytes)
            row = _first(c, 1, row)
            fam = _first(c, 2, b"")
            if all_families:
                cells[(fam, _first(c, 3, b""))] = _first(c, 6, b"")
            elif fam == self._family:
                cells[_first(c, 3, b"").decode()] = _first(c, 6, b"")
        return row, cells

    def _mutation_put(self, row: bytes, cells: dict[str, bytes]) -> PB:
        col_values = PB()
        qv = PB()
        for qual, value in cells.items():
            qv.msg(2, PB().bytes_(1, qual.encode()).bytes_(2, value))
        col_values.bytes_(1, self._family)
        col_values._buf += qv._buf       # repeated qualifier_value fields
        return (PB().bytes_(1, row)
                .varint(2, _MUTATE_PUT)
                .msg(3, col_values))

    def _mutation_delete(self, row: bytes) -> PB:
        # a Delete with no column_value entries removes the whole row
        return PB().bytes_(1, row).varint(2, _MUTATE_DELETE)

    # -- filter spec → Filter protos ---------------------------------------
    def _filter_pb(self, spec: dict) -> PB:
        """Serialize the backend's transport-neutral filter spec (the
        Stargate-shaped dict built in hbase.py) into the real Filter
        proto: {name, serialized_filter}."""
        import base64 as _b64mod

        ftype = spec.get("type")
        if ftype == "FilterList":
            op = 2 if spec.get("op") == "MUST_PASS_ONE" else 1
            fl = PB().varint(1, op)
            for sub in spec.get("filters", []):
                fl.msg(2, self._filter_pb(sub))
            return (PB().string(1, _FILTER_PKG + "FilterList")
                    .msg(2, fl))
        if ftype == "SingleColumnValueFilter":
            fam = _b64mod.b64decode(spec["family"])
            qual = _b64mod.b64decode(spec["qualifier"])
            value = _b64mod.b64decode(spec["comparator"]["value"])
            comparator = (PB()
                          .string(1, _FILTER_PKG + "BinaryComparator")
                          .msg(2, PB().msg(1, PB().bytes_(1, value))))
            scvf = (PB().bytes_(1, fam)
                    .bytes_(2, qual)
                    .varint(3, _CMP[spec.get("op", "EQUAL")])
                    .msg(4, comparator)
                    .bool_(5, bool(spec.get("ifMissing", False)))
                    .bool_(6, bool(spec.get("latestVersion", True))))
            return (PB().string(1, _FILTER_PKG + "SingleColumnValueFilter")
                    .msg(2, scvf))
        raise HBaseRpcError(f"unsupported filter spec type {ftype!r}")

    # -- data path: transport interface ------------------------------------
    def get_row(self, table: str, key: bytes) -> Optional[dict[str, bytes]]:
        self._drain_pending_closes()

        def do(region: _Region):
            req = (PB().msg(1, _region_spec(region.name))
                   .msg(2, PB().bytes_(1, key)))
            resp = self._call(region.server, "ClientService", "Get", req)
            result = _first(resp, 1)
            if result is None:
                return None
            _row, cells = self._decode_result(pb_decode(result))
            return cells or None
        try:
            return self._with_region_retry(table, key, do)
        except HBaseRpcError as e:
            if e.table_missing:
                return None
            raise

    def delete_row(self, table: str, key: bytes) -> bool:
        def do(region: _Region):
            req = (PB().msg(1, _region_spec(region.name))
                   .msg(2, self._mutation_delete(key)))
            resp = self._call(region.server, "ClientService",
                              "Mutate", req)
            return bool(_first(resp, 2, 1))
        try:
            return bool(self._with_region_retry(table, key, do))
        except HBaseRpcError as e:
            if e.table_missing:
                return False
            raise

    def put_rows(self, table: str,
                 rows: Sequence[tuple[bytes, dict[str, bytes]]]) -> None:
        """Batched puts, grouped per region (one Multi per region —
        HBase's own AsyncProcess grouping); auto-creates the table on
        TableNotFoundException like the REST transport's 404 path."""
        if not rows:
            return
        self._drain_pending_closes()
        for attempt in (0, 1):
            try:
                self._put_rows_once(table, rows)
                return
            except HBaseRpcError as e:
                if attempt == 0 and e.table_missing:
                    self.create_table(table)
                    continue
                raise

    def _put_rows_once(self, table, rows) -> None:
        if len(rows) == 1:
            key, cells = rows[0]

            def do_one(region: _Region):
                req = (PB().msg(1, _region_spec(region.name))
                       .msg(2, self._mutation_put(key, cells)))
                self._call(region.server, "ClientService", "Mutate", req)
            self._with_region_retry(table, key, do_one)
            return
        # group per region and send one Multi each; a stale location
        # re-groups the WHOLE batch from a fresh lookup (rows may have
        # moved to different regions, not just different servers)
        last: Optional[HBaseRpcError] = None
        for attempt in range(3):
            try:
                regions = self._locate(table, refresh=attempt > 0)
                by_region: dict[bytes, list] = {}
                region_of: dict[bytes, _Region] = {}
                for key, cells in rows:
                    region = next((r for r in regions if r.contains(key)),
                                  None)
                    if region is None:
                        raise HBaseRpcError(
                            f"no region of {table} contains row {key!r}")
                    by_region.setdefault(region.name, []).append((key, cells))
                    region_of[region.name] = region
                for name, batch in by_region.items():
                    self._multi_put(region_of[name], batch)
                return
            except HBaseRpcError as e:
                if not e.retriable_region:
                    raise
                last = e
                self._invalidate(table)
                if attempt < 2:
                    self._pace_retry(attempt)
        assert last is not None
        raise last

    def _multi_put(self, region: _Region, batch: list) -> None:
        action = PB().msg(1, _region_spec(region.name))
        for i, (key, cells) in enumerate(batch):
            action.msg(3, PB().varint(1, i)
                       .msg(2, self._mutation_put(key, cells)))
        resp = self._call(region.server, "ClientService", "Multi",
                          PB().msg(1, action))
        for rar_bytes in resp.get(1, []):
            rar = pb_decode(rar_bytes)
            for exc in ([_first(rar, 2)]
                        + [_first(pb_decode(b), 3) for b in rar.get(1, [])]):
                if exc is None:
                    continue
                e = pb_decode(exc)
                cls = _first(e, 1, b"").decode(errors="replace")
                raise HBaseRpcError(
                    f"Multi failure: {cls}", exception_class=cls,
                    do_not_retry=bool(_first(e, 5, 0)))

    # -- scans -------------------------------------------------------------
    def scan(self, table: str, start: bytes, stop: bytes,
             filter_spec: Optional[dict] = None,
             reverse: bool = False,
             batch: int = 1000) -> Iterator[tuple[bytes, dict[str, bytes]]]:
        """Range scan [start, stop) in rowkey order (descending when
        reverse=True), region by region, yielding (rowkey, cells).

        Stale region locations retry with a RESUME CURSOR: the window
        is narrowed past the rows already yielded before re-locating,
        so a region move mid-scan never duplicates or drops rows."""
        self._drain_pending_closes()
        cur_start, cur_stop = start, stop
        for attempt in range(3):
            try:
                regions = self._locate(table, refresh=attempt > 0)
            except HBaseRpcError as e:
                if e.table_missing:
                    return
                if e.retriable_region and attempt < 2:
                    self._invalidate(table)
                    self._pace_retry(attempt)
                    continue
                raise
            overlapping = [r for r in regions
                           if r.overlaps(cur_start, cur_stop)]
            if reverse:
                overlapping = list(reversed(overlapping))
            try:
                for region in overlapping:
                    for row, cells in self._scan_region(
                            region.server, region.name, cur_start, cur_stop,
                            filter_spec, reverse, batch=batch):
                        if reverse:
                            cur_stop = row          # remaining: [start, row)
                        else:
                            cur_start = row + b"\x00"   # next possible key
                        yield row, cells
                return
            except HBaseRpcError as e:
                if not e.retriable_region or attempt == 2:
                    raise
                self._invalidate(table)
                self._pace_retry(attempt)

    def _scan_region(self, server: tuple[str, int], region_name: bytes,
                     start: bytes, stop: Optional[bytes],
                     filter_spec: Optional[dict], reverse: bool,
                     batch: int = 1000,
                     all_families: bool = False
                     ) -> Iterator[tuple[bytes, dict]]:
        scan = PB()
        if reverse:
            # reversed scans iterate high→low: start_row is the HIGH
            # bound (exclusive — mirroring the forward window's
            # exclusive stop), stop_row the LOW bound (inclusive)
            if stop:
                scan.bytes_(3, stop)
                scan.bool_(21, False)      # include_start_row
            if start:
                scan.bytes_(4, start)
                scan.bool_(22, True)       # include_stop_row
            scan.bool_(15, True)           # reversed
        else:
            if start:
                scan.bytes_(3, start)
            if stop:
                scan.bytes_(4, stop)
        if filter_spec is not None:
            scan.msg(5, self._filter_pb(filter_spec))
        open_req = (PB().msg(1, _region_spec(region_name))
                    .msg(2, scan)
                    .varint(4, batch))
        resp = self._call(server, "ClientService", "Scan", open_req)
        scanner_id = _first(resp, 2)
        broken = False
        try:
            while True:
                for result_bytes in resp.get(5, []):
                    row, cells = self._decode_result(
                        pb_decode(result_bytes), all_families=all_families)
                    if cells:
                        yield row, cells
                # Per-region termination: more_results_in_region (f8)
                # is authoritative when present — real servers keep
                # more_results (f3) TRUE after a region is exhausted
                # because the scan as a whole may continue in the next
                # region.  Only fall back to f3 for servers that never
                # set f8 (pre-1.x wire behavior).
                mrir = _first(resp, 8)
                if mrir is not None:
                    if not mrir:
                        return
                elif not _first(resp, 3, 0):   # more_results fallback
                    return
                if scanner_id is None:
                    return
                next_req = (PB().varint(3, scanner_id).varint(4, batch))
                resp = self._call(server, "ClientService", "Scan", next_req)
        except HBaseRpcError as e:
            # don't try to close a scanner whose session died with the
            # connection — the server's scanner lease reclaims it
            broken = e.connection_lost
            raise
        finally:
            if scanner_id is not None and not broken:
                # NO RPC here: this finally can run inside a GC pass on
                # a thread that already holds a transport/connection
                # lock (abandoned generator). Queue the close; the next
                # normal call drains it (see _drain_pending_closes).
                self._pending_scanner_closes.append((server, scanner_id))
