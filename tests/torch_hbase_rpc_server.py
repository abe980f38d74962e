"""An HBase region server speaking the native RPC protocol, for the port.

The port's stand-in for ``tests/hbase_rpc_mock.py``, which imports the
JAX package's codec: this server is the same server side of the
protobuf wire contract, on the port's own codec
(``incubator_predictionio_torch/data/storage/hbase_rpc.py``) and the
standard library. One port serves the master, ``hbase:meta`` and every
user region (HBase standalone): the connection preamble and
ConnectionHeader, length-framed calls with a varint-delimited
RequestHeader and parameter, ClientService (Get, Mutate, Multi, Scan with
forward and reversed scanners) and MasterService (CreateTable,
DisableTable, DeleteTable). Region locations are answered as
``hbase:meta`` scan results (a PBUF-prefixed RegionInfo and an
``info:server`` cell) that the client must parse and route by.

Tables split into regions: ``split_keys`` names a table's split points,
and ``default_split`` (one rowkey) splits every other table in two, so a
client's puts, gets and scans must pick the right region. Filters
(SingleColumnValueFilter, FilterList) are evaluated here from their proto
encoding; ``rows_served`` counts data rows that crossed the wire.

Adversarial modes, as in the reference's mock: ``fail_next(method,
exception_class, do_not_retry)``, ``notserving_once(table)`` and
``garbage_frame_next()``.

``chip_smoke.py`` loads it by path with the repository root on
``sys.path``::

    with HBaseRpcServer(default_split=b"t:08") as srv:   # srv.port
        ...
"""

from __future__ import annotations

import hashlib
import itertools
import socketserver
import struct
import threading

from incubator_predictionio_torch.data.storage.hbase_rpc import (
    PB, pb_decode, pb_delimited, read_delimited,
)

_META_REGION = b"hbase:meta,,1"
_CMP_OPS = {0: lambda a, b: a < b, 1: lambda a, b: a <= b,
            2: lambda a, b: a == b, 3: lambda a, b: a != b,
            4: lambda a, b: a >= b, 5: lambda a, b: a > b}


def _first(fields, field, default=None):
    vals = fields.get(field)
    return vals[0] if vals else default


class _Table:
    def __init__(self, name: str, split_keys: list[bytes], rid: int):
        self.name = name
        self.rows: dict[bytes, dict[tuple[bytes, bytes], bytes]] = {}
        self.disabled = False
        bounds = [b""] + sorted(split_keys) + [b""]
        self.regions: list[tuple[bytes, bytes, bytes]] = []
        for i in range(len(bounds) - 1):
            start, end = bounds[i], bounds[i + 1]
            enc = hashlib.md5(
                f"{name},{start!r},{rid + i}".encode()).hexdigest()
            region_name = (name.encode() + b"," + start + b","
                           + str(rid + i).encode() + b"." + enc.encode()
                           + b".")
            self.regions.append((start, end, region_name))

    def region_rows(self, region_name: bytes) -> list[bytes]:
        for start, end, name in self.regions:
            if name == region_name:
                return sorted(k for k in self.rows
                              if k >= start and (not end or k < end))
        return []

    def region_bounds(self, region_name: bytes):
        for start, end, name in self.regions:
            if name == region_name:
                return start, end
        return None


def _eval_filter(filter_bytes: bytes, cells: dict) -> bool:
    f = pb_decode(filter_bytes)
    name = _first(f, 1, b"").decode()
    payload = _first(f, 2, b"")
    short = name.rsplit(".", 1)[-1]
    if short == "FilterList":
        fl = pb_decode(payload)
        op = _first(fl, 1, 1)
        results = [_eval_filter(sub, cells) for sub in fl.get(2, [])]
        return any(results) if op == 2 else all(results)
    if short == "SingleColumnValueFilter":
        scvf = pb_decode(payload)
        fam = _first(scvf, 1, b"")
        qual = _first(scvf, 2, b"")
        op = _first(scvf, 3, 2)
        comparator = pb_decode(_first(scvf, 4, b""))
        cmp_name = _first(comparator, 1, b"").decode().rsplit(".", 1)[-1]
        if cmp_name != "BinaryComparator":
            raise ValueError(f"unsupported comparator {cmp_name}")
        want = _first(pb_decode(_first(pb_decode(
            _first(comparator, 2, b"")), 1, b"")), 1, b"")
        value = cells.get((fam, qual))
        if value is None:
            return not _first(scvf, 5, 0)      # filter_if_missing
        return _CMP_OPS[op](value, want)
    raise ValueError(f"unsupported filter {name}")


class _Handler(socketserver.BaseRequestHandler):
    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            part = self.request.recv(n - len(buf))
            if not part:
                raise ConnectionError("client went away")
            buf += part
        return bytes(buf)

    def _send_response(self, call_id: int, body: PB | None = None,
                       exception: tuple[str, str, bool] | None = None):
        srv: HBaseRpcServer = self.server  # type: ignore[assignment]
        with srv.state_lock:
            garbage = srv._garbage_next
            srv._garbage_next = False
        if garbage:
            self.request.sendall(struct.pack(">I", 7) + b"\x01" * 7)
            return
        header = PB().varint(1, call_id)
        if exception is not None:
            cls, msg, do_not_retry = exception
            exc = (PB().string(1, cls).string(2, f"{cls}: {msg}")
                   .string(3, "mock").varint(4, self.server.server_address[1]))
            if do_not_retry:
                exc.bool_(5, True)
            header.msg(2, exc)
        frame = pb_delimited(header)
        if exception is None and body is not None:
            frame += pb_delimited(body)
        self.request.sendall(struct.pack(">I", len(frame)) + frame)

    # -- per-call dispatch -------------------------------------------------
    def handle(self):
        try:
            self._handle()
        except (ConnectionError, OSError):
            pass

    def _handle(self):
        preamble = self._recv_exact(6)
        if preamble[:4] != b"HBas" or preamble[5] != 0x50:
            self.request.close()
            return
        hlen = struct.unpack(">I", self._recv_exact(4))[0]
        pb_decode(self._recv_exact(hlen))    # ConnectionHeader (unused)
        while True:
            try:
                total = struct.unpack(">I", self._recv_exact(4))[0]
            except ConnectionError:
                return
            buf = self._recv_exact(total)
            header_bytes, pos = read_delimited(buf, 0)
            header = pb_decode(header_bytes)
            call_id = _first(header, 1, 0)
            method = _first(header, 3, b"").decode()
            param = {}
            if pos < len(buf):
                param_bytes, _ = read_delimited(buf, pos)
                param = pb_decode(param_bytes)
            srv: HBaseRpcServer = self.server  # type: ignore[assignment]
            forced = srv._take_fail(method)
            if forced is not None:
                self._send_response(call_id, exception=forced)
                continue
            try:
                fn = getattr(self, f"_do_{method.lower()}", None)
                if fn is None:
                    self._send_response(call_id, exception=(
                        "org.apache.hadoop.hbase.DoNotRetryIOException",
                        f"unknown method {method}", True))
                    continue
                fn(call_id, param)
            except _RpcFault as f:
                self._send_response(call_id, exception=f.as_tuple())

    # -- region helpers ----------------------------------------------------
    def _region(self, param) -> bytes:
        spec = pb_decode(_first(param, 1, b""))
        return _first(spec, 2, b"")

    def _table_for_region(self, region_name: bytes) -> _Table:
        srv: HBaseRpcServer = self.server  # type: ignore[assignment]
        with srv.state_lock:
            for t in srv.tables.values():
                if any(name == region_name for _s, _e, name in t.regions):
                    if srv._notserving.get(t.name, {}).pop(region_name, None):
                        raise _RpcFault(
                            "org.apache.hadoop.hbase.NotServingRegionException",
                            f"region {region_name!r} is not online")
                    return t
        raise _RpcFault(
            "org.apache.hadoop.hbase.NotServingRegionException",
            f"unknown region {region_name!r}")

    # -- meta --------------------------------------------------------------
    def _meta_results(self, start: bytes, stop: bytes) -> list[PB]:
        srv: HBaseRpcServer = self.server  # type: ignore[assignment]
        host, port = srv.server_address[:2]
        results = []
        with srv.state_lock:
            entries = []
            for t in srv.tables.values():
                for r_start, r_end, r_name in t.regions:
                    entries.append((r_name, t.name, r_start, r_end))
        for r_name, tname, r_start, r_end in sorted(entries):
            if r_name < start or (stop and r_name >= stop):
                continue
            ri = (PB().varint(1, 1)
                  .msg(2, PB().bytes_(1, b"default")
                       .bytes_(2, tname.encode()))
                  .bytes_(3, r_start).bytes_(4, r_end))
            result = PB()
            for fam, qual, val in (
                    (b"info", b"regioninfo", b"PBUF" + ri.bytes()),
                    (b"info", b"server", f"{host}:{port}".encode())):
                result.msg(1, PB().bytes_(1, r_name).bytes_(2, fam)
                           .bytes_(3, qual).varint(4, 1).varint(5, 4)
                           .bytes_(6, val))
            results.append(result)
        return results

    # -- ClientService -----------------------------------------------------
    def _do_get(self, call_id, param):
        table = self._table_for_region(self._region(param))
        get = pb_decode(_first(param, 2, b""))
        row = _first(get, 1, b"")
        srv: HBaseRpcServer = self.server  # type: ignore[assignment]
        result = PB()
        with srv.state_lock:
            cells = table.rows.get(row)
            if cells:
                for (fam, qual), val in sorted(cells.items()):
                    result.msg(1, PB().bytes_(1, row).bytes_(2, fam)
                               .bytes_(3, qual).varint(4, 1).varint(5, 4)
                               .bytes_(6, val))
        self._send_response(call_id, PB().msg(1, result))

    def _apply_mutation(self, table: _Table, mutation: dict):
        row = _first(mutation, 1, b"")
        mtype = _first(mutation, 2, 2)
        if mtype == 2:       # PUT
            cells = table.rows.setdefault(row, {})
            for cv_bytes in mutation.get(3, []):
                cv = pb_decode(cv_bytes)
                fam = _first(cv, 1, b"")
                for qv_bytes in cv.get(2, []):
                    qv = pb_decode(qv_bytes)
                    cells[(fam, _first(qv, 1, b""))] = _first(qv, 2, b"")
        elif mtype == 3:     # DELETE (no columns = whole row)
            table.rows.pop(row, None)
        else:
            raise _RpcFault(
                "org.apache.hadoop.hbase.DoNotRetryIOException",
                f"unsupported mutate_type {mtype}", do_not_retry=True)

    def _do_mutate(self, call_id, param):
        table = self._table_for_region(self._region(param))
        mutation = pb_decode(_first(param, 2, b""))
        srv: HBaseRpcServer = self.server  # type: ignore[assignment]
        with srv.state_lock:
            self._apply_mutation(table, mutation)
        self._send_response(call_id, PB().bool_(2, True))

    def _do_multi(self, call_id, param):
        srv: HBaseRpcServer = self.server  # type: ignore[assignment]
        out = PB()
        for ra_bytes in param.get(1, []):
            ra = pb_decode(ra_bytes)
            spec = pb_decode(_first(ra, 1, b""))
            table = self._table_for_region(_first(spec, 2, b""))
            rar = PB()
            with srv.state_lock:
                for a_bytes in ra.get(3, []):
                    a = pb_decode(a_bytes)
                    idx = _first(a, 1, 0)
                    mutation = pb_decode(_first(a, 2, b""))
                    self._apply_mutation(table, mutation)
                    rar.msg(1, PB().varint(1, idx).msg(2, PB()))
            out.msg(1, rar)
        self._send_response(call_id, out)

    def _do_scan(self, call_id, param):
        srv: HBaseRpcServer = self.server  # type: ignore[assignment]
        scanner_id = _first(param, 3)
        n_rows = _first(param, 4, 100)
        close = bool(_first(param, 5, 0))
        if scanner_id is not None and _first(param, 1) is None:
            with srv.state_lock:
                state = srv.scanners.get(scanner_id)
            if close:
                with srv.state_lock:
                    srv.scanners.pop(scanner_id, None)
                self._send_response(call_id, PB())
                return
            if state is None:
                raise _RpcFault(
                    "org.apache.hadoop.hbase.UnknownScannerException",
                    f"scanner {scanner_id}", do_not_retry=True)
            self._send_scan_batch(call_id, scanner_id, state, n_rows)
            return
        # open: region + scan spec
        region_name = self._region(param)
        scan = pb_decode(_first(param, 2, b""))
        start_row = _first(scan, 3, b"")
        stop_row = _first(scan, 4, b"")
        filt = _first(scan, 5)
        reverse = bool(_first(scan, 15, 0))
        inc_start = bool(_first(scan, 21, 1))
        inc_stop = bool(_first(scan, 22, 0))
        if region_name == _META_REGION:
            results = self._meta_results(start_row, stop_row)
            body = PB().bool_(3, False)
            for r in results:
                body.msg(5, r)
            self._send_response(call_id, body)
            return
        table = self._table_for_region(region_name)
        with srv.state_lock:
            bounds = table.region_bounds(region_name)
            assert bounds is not None
            lo, hi = bounds

            def in_scan(k: bytes) -> bool:
                if reverse:
                    if start_row and (k > start_row
                                      or (k == start_row and not inc_start)):
                        return False
                    if stop_row and (k < stop_row
                                     or (k == stop_row and not inc_stop)):
                        return False
                else:
                    if start_row and (k < start_row
                                      or (k == start_row and not inc_start)):
                        return False
                    if stop_row and (k > stop_row
                                     or (k == stop_row and not inc_stop)):
                        return False
                return True

            keys = [k for k in sorted(table.rows)
                    if k >= lo and (not hi or k < hi) and in_scan(k)]
            if reverse:
                keys.reverse()
            # does the SCAN (not just this region) end here?  Real
            # servers set more_results=false only when the scan's stop
            # row lies within this region's bounds; otherwise the scan
            # continues in a neighboring region and they answer
            # more_results=true + more_results_in_region=false.
            if reverse:
                ends_here = (not lo) or bool(stop_row and stop_row >= lo)
            else:
                ends_here = (not hi) or bool(stop_row and stop_row <= hi)
            state = {"table": table, "keys": keys, "pos": 0, "filter": filt,
                     "ends_here": ends_here}
            sid = next(srv.scanner_ids)
            srv.scanners[sid] = state
        self._send_scan_batch(call_id, sid, state, n_rows)

    def _send_scan_batch(self, call_id, scanner_id, state, n_rows):
        srv: HBaseRpcServer = self.server  # type: ignore[assignment]
        body = PB()
        sent = 0
        with srv.state_lock:
            table: _Table = state["table"]
            keys = state["keys"]
            while state["pos"] < len(keys) and sent < n_rows:
                key = keys[state["pos"]]
                state["pos"] += 1
                cells = table.rows.get(key)
                if cells is None:
                    continue
                if state["filter"] is not None and not _eval_filter(
                        state["filter"], cells):
                    continue
                result = PB()
                for (fam, qual), val in sorted(cells.items()):
                    result.msg(1, PB().bytes_(1, key).bytes_(2, fam)
                               .bytes_(3, qual).varint(4, 1).varint(5, 4)
                               .bytes_(6, val))
                body.msg(5, result)
                sent += 1
            more_in_region = state["pos"] < len(keys)
            srv.rows_served += sent
            if not more_in_region:
                srv.scanners.pop(scanner_id, None)
        body.varint(2, scanner_id)
        # the two-flag protocol: f3 stays TRUE while the scan may
        # continue in ANOTHER region — clients must terminate the
        # per-region loop on f8, not f3
        body.bool_(3, more_in_region or not state["ends_here"])
        body.bool_(8, more_in_region)
        self._send_response(call_id, body)

    # -- MasterService -----------------------------------------------------
    def _table_name(self, name_bytes: bytes) -> str:
        tn = pb_decode(name_bytes)
        return _first(tn, 2, b"").decode()

    def _do_createtable(self, call_id, param):
        srv: HBaseRpcServer = self.server  # type: ignore[assignment]
        schema = pb_decode(_first(param, 1, b""))
        name = self._table_name(_first(schema, 1, b""))
        with srv.state_lock:
            if name in srv.tables:
                raise _RpcFault(
                    "org.apache.hadoop.hbase.TableExistsException", name,
                    do_not_retry=True)
            splits = srv.split_keys.get(name)
            if splits is None:
                splits = ([srv.default_split] if srv.default_split
                          else [])
            srv.tables[name] = _Table(name, splits, next(srv.region_ids))
        self._send_response(call_id, PB().varint(1, 1))

    def _do_disabletable(self, call_id, param):
        srv: HBaseRpcServer = self.server  # type: ignore[assignment]
        name = self._table_name(_first(param, 1, b""))
        with srv.state_lock:
            t = srv.tables.get(name)
            if t is None:
                raise _RpcFault(
                    "org.apache.hadoop.hbase.TableNotFoundException", name,
                    do_not_retry=True)
            t.disabled = True
        self._send_response(call_id, PB().varint(1, 1))

    def _do_deletetable(self, call_id, param):
        srv: HBaseRpcServer = self.server  # type: ignore[assignment]
        name = self._table_name(_first(param, 1, b""))
        with srv.state_lock:
            t = srv.tables.get(name)
            if t is None:
                raise _RpcFault(
                    "org.apache.hadoop.hbase.TableNotFoundException", name,
                    do_not_retry=True)
            if not t.disabled:
                raise _RpcFault(
                    "org.apache.hadoop.hbase.TableNotDisabledException",
                    name, do_not_retry=True)
            del srv.tables[name]
        self._send_response(call_id, PB().varint(1, 1))


class _RpcFault(Exception):
    def __init__(self, cls: str, msg: str, do_not_retry: bool = False):
        super().__init__(f"{cls}: {msg}")
        self.cls = cls
        self.msg = msg
        self.do_not_retry = do_not_retry

    def as_tuple(self):
        return (self.cls, self.msg, self.do_not_retry)


class HBaseRpcServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, split_keys: dict[str, list[bytes]] | None = None,
                 default_split: bytes | None = None):
        super().__init__(("127.0.0.1", 0), _Handler)
        self.default_split = default_split
        self.state_lock = threading.RLock()
        self.tables: dict[str, _Table] = {}
        self.scanners: dict[int, dict] = {}
        self.scanner_ids = itertools.count(1)
        self.region_ids = itertools.count(1000)
        self.split_keys = dict(split_keys or {})
        self.rows_served = 0
        self._fail_next: list[tuple[str, tuple[str, str, bool]]] = []
        self._notserving: dict[str, dict[bytes, bool]] = {}
        self._garbage_next = False

    # -- adversarial knobs -------------------------------------------------
    def fail_next(self, method: str, exception_class: str,
                  do_not_retry: bool = False, msg: str = "injected"):
        with self.state_lock:
            self._fail_next.append(
                (method, (exception_class, msg, do_not_retry)))

    def notserving_once(self, table: str):
        """Every region of `table` answers NotServingRegionException to
        its next data op, then recovers — exercises relocation+retry."""
        with self.state_lock:
            t = self.tables.get(table)
            if t is not None:
                self._notserving[table] = {
                    name: True for _s, _e, name in t.regions}

    def garbage_frame_next(self):
        with self.state_lock:
            self._garbage_next = True

    def _take_fail(self, method: str):
        with self.state_lock:
            for i, (m, exc) in enumerate(self._fail_next):
                if m == method:
                    del self._fail_next[i]
                    return exc
        return None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def __enter__(self):
        threading.Thread(target=self.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *exc):
        self.shutdown()
        self.server_close()
