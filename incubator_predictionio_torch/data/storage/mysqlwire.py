"""MySQL client/server wire-protocol client — no driver dependency.

The port's own copy of ``incubator_predictionio_tpu/data/storage/mysqlwire.py``; the wire
bytes and the tables are the reference's, so either package reads a store
the other wrote.

The reference's JDBC backend served Postgres *and* MySQL through
scalikejdbc (SURVEY.md §2.1 storage/jdbc/.../JDBCUtils.scala). The
Postgres half is pgwire.py; this is the MySQL half, written to the same
discipline: the protocol spoken directly over a socket, parameters
travelling out-of-band (COM_STMT_PREPARE / COM_STMT_EXECUTE binary
protocol — never interpolated into SQL text), typed errors carrying the
server's errno + SQLSTATE.

Auth: ``mysql_native_password`` (SHA1 challenge-response) and
``caching_sha2_password`` (SHA256 challenge-response, the 8.x default)
including the AuthSwitch dance. caching_sha2's *full* authentication
exchange requires TLS or RSA-OAEP of the password; neither belongs on
this plaintext channel, so a server demanding full auth gets a typed
``MySQLProtocolError`` telling the operator to use TLS termination or
seed the server-side auth cache — the password is never sent in clear.

Scope mirrors pgwire: synchronous, one connection per client (the
storage layer serializes DAO calls), >16MB packets split/joined at the
framing layer, TLS out of scope in-repo (front with stunnel/ProxySQL).
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading
from typing import Optional, Sequence

# -- capability flags ---------------------------------------------------------
CLIENT_LONG_PASSWORD = 0x1
CLIENT_FOUND_ROWS = 0x2
CLIENT_CONNECT_WITH_DB = 0x8
CLIENT_PROTOCOL_41 = 0x200
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000
CLIENT_PLUGIN_AUTH_LENENC = 0x200000
CLIENT_DEPRECATE_EOF = 0x1000000

# -- column types -------------------------------------------------------------
T_DECIMAL, T_TINY, T_SHORT, T_LONG, T_FLOAT, T_DOUBLE = 0, 1, 2, 3, 4, 5
T_NULL, T_TIMESTAMP, T_LONGLONG, T_INT24, T_DATE, T_TIME = 6, 7, 8, 9, 10, 11
T_DATETIME, T_YEAR, T_VARCHAR, T_BIT = 12, 13, 15, 16
T_JSON, T_NEWDECIMAL, T_ENUM, T_SET = 245, 246, 247, 248
T_TINY_BLOB, T_MEDIUM_BLOB, T_LONG_BLOB, T_BLOB = 249, 250, 251, 252
T_VAR_STRING, T_STRING, T_GEOMETRY = 253, 254, 255

_INT_TYPES = {T_TINY: 1, T_SHORT: 2, T_YEAR: 2, T_INT24: 4, T_LONG: 4,
              T_LONGLONG: 8}
_STR_TYPES = {T_DECIMAL, T_NEWDECIMAL, T_VARCHAR, T_BIT, T_JSON, T_ENUM,
              T_SET, T_TINY_BLOB, T_MEDIUM_BLOB, T_LONG_BLOB, T_BLOB,
              T_VAR_STRING, T_STRING, T_GEOMETRY}
_BINARY_CHARSET = 63

_MAX_PACKET = 0xFFFFFF  # payloads >= this split across packets


class MySQLError(RuntimeError):
    """Server-reported ERR packet (errno, sqlstate, message)."""

    def __init__(self, errno: int, sqlstate: str, message: str):
        self.errno = errno
        self.sqlstate = sqlstate
        super().__init__(f"({errno}, {sqlstate}): {message}")


class MySQLProtocolError(RuntimeError):
    pass


def native_password_scramble(password: str, nonce: bytes) -> bytes:
    """mysql_native_password: SHA1(pw) XOR SHA1(nonce + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(nonce + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def caching_sha2_scramble(password: str, nonce: bytes) -> bytes:
    """caching_sha2_password: SHA256(pw) XOR SHA256(SHA256(SHA256(pw))+nonce)."""
    if not password:
        return b""
    h1 = hashlib.sha256(password.encode()).digest()
    h2 = hashlib.sha256(h1).digest()
    h3 = hashlib.sha256(h2 + nonce).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def lenenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def lenenc_bytes(b: bytes) -> bytes:
    return lenenc_int(len(b)) + b


def read_lenenc_int(buf: bytes, off: int) -> tuple[Optional[int], int]:
    """(value, new_offset); value None for the 0xFB NULL marker."""
    first = buf[off]
    if first < 0xFB:
        return first, off + 1
    if first == 0xFB:
        return None, off + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, off + 1)[0], off + 3
    if first == 0xFD:
        return struct.unpack("<I", buf[off + 1:off + 4] + b"\x00")[0], off + 4
    if first == 0xFE:
        return struct.unpack_from("<Q", buf, off + 1)[0], off + 9
    raise MySQLProtocolError(f"bad length-encoded integer 0x{first:02x}")


def read_lenenc_bytes(buf: bytes, off: int) -> tuple[Optional[bytes], int]:
    n, off = read_lenenc_int(buf, off)
    if n is None:
        return None, off
    return buf[off:off + n], off + n


class _ColDef:
    __slots__ = ("name", "charset", "type", "flags", "decimals")

    def __init__(self, payload: bytes):
        off = 0
        for _ in range(4):  # catalog, schema, table, org_table
            _, off = read_lenenc_bytes(payload, off)
        name, off = read_lenenc_bytes(payload, off)
        _, off = read_lenenc_bytes(payload, off)  # org_name
        _, off = read_lenenc_int(payload, off)  # fixed-length block (0x0c)
        self.name = (name or b"").decode()
        self.charset, _len, self.type, self.flags, self.decimals = (
            struct.unpack_from("<HIBHB", payload, off))


class MySQLConnection:
    """One connection; ``query`` is thread-safe (lock) and exposes
    ``affected_rows`` / ``last_insert_id`` from the latest OK packet
    (MySQL's substitute for the RETURNING clause)."""

    def __init__(self, host: str, port: int, user: str, password: str,
                 database: str, timeout: float = 30.0,
                 connect_timeout: float = 10.0):
        self._lock = threading.RLock()
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.settimeout(timeout)
        self._buf = b""
        self._seq = 0
        self._broken = False
        self.capabilities = 0
        self.affected_rows = 0
        self.last_insert_id = 0
        self.user = user
        try:
            self._handshake(user, password, database)
        except BaseException:
            self._sock.close()
            raise

    # -- framing -------------------------------------------------------------
    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise MySQLProtocolError("server closed the connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _recv_packet(self) -> bytes:
        """One logical packet, joining the >=16MB continuation frames."""
        payload = b""
        while True:
            head = self._recv_exact(4)
            length = head[0] | (head[1] << 8) | (head[2] << 16)
            self._seq = (head[3] + 1) & 0xFF
            payload += self._recv_exact(length)
            if length < _MAX_PACKET:
                return payload

    def _send_packet(self, payload: bytes) -> None:
        """Send one logical packet, splitting at the 16MB frame limit."""
        off = 0
        while True:
            frame = payload[off:off + _MAX_PACKET]
            head = bytes([len(frame) & 0xFF, (len(frame) >> 8) & 0xFF,
                          (len(frame) >> 16) & 0xFF, self._seq])
            self._sock.sendall(head + frame)
            self._seq = (self._seq + 1) & 0xFF
            off += len(frame)
            if len(frame) < _MAX_PACKET:
                return

    def _command(self, payload: bytes) -> None:
        self._seq = 0
        self._send_packet(payload)

    # -- error/ok ------------------------------------------------------------
    @staticmethod
    def _parse_err(payload: bytes) -> MySQLError:
        errno = struct.unpack_from("<H", payload, 1)[0]
        off = 3
        state = "HY000"
        if len(payload) > off and payload[off:off + 1] == b"#":
            state = payload[off + 1:off + 6].decode(errors="replace")
            off += 6
        return MySQLError(errno, state, payload[off:].decode(errors="replace"))

    def _parse_ok(self, payload: bytes) -> None:
        off = 1
        n, off = read_lenenc_int(payload, off)
        self.affected_rows = n or 0
        n, off = read_lenenc_int(payload, off)
        self.last_insert_id = n or 0

    # -- handshake -----------------------------------------------------------
    def _handshake(self, user: str, password: str, database: str) -> None:
        greeting = self._recv_packet()
        if greeting[:1] == b"\xff":
            raise self._parse_err(greeting)
        if greeting[0] != 10:
            raise MySQLProtocolError(
                f"unsupported handshake protocol {greeting[0]}")
        off = greeting.index(b"\x00", 1) + 1  # server version string
        off += 4  # thread id
        nonce = greeting[off:off + 8]
        off += 8 + 1  # auth-data part 1 + filler
        caps = struct.unpack_from("<H", greeting, off)[0]
        off += 2
        plugin = "mysql_native_password"
        if len(greeting) > off:
            off += 1 + 2  # charset, status flags
            caps |= struct.unpack_from("<H", greeting, off)[0] << 16
            off += 2
            auth_len = greeting[off]
            off += 1 + 10  # reserved
            if caps & CLIENT_SECURE_CONNECTION:
                part2 = greeting[off:off + max(13, auth_len - 8)]
                off += len(part2)
                # exactly the first 12 bytes: rstrip would eat salt
                # bytes that legitimately END in 0x00 (MySQL proper
                # never sends NUL in the salt, but protocol-compatible
                # proxies need not honor that), breaking auth ~1/256
                # connections per trailing zero byte
                nonce += part2[:12]
            if caps & CLIENT_PLUGIN_AUTH:
                end = greeting.index(b"\x00", off)
                plugin = greeting[off:end].decode()
        self.capabilities = (
            CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41 | CLIENT_TRANSACTIONS
            | CLIENT_SECURE_CONNECTION
            | (caps & CLIENT_PLUGIN_AUTH)
            | (caps & CLIENT_PLUGIN_AUTH_LENENC)
            | (caps & CLIENT_DEPRECATE_EOF)
            | (CLIENT_CONNECT_WITH_DB if database else 0))

        auth = self._scramble(plugin, password, nonce)
        resp = struct.pack("<IIB23x", self.capabilities, 1 << 30, 45)
        resp += user.encode() + b"\x00"
        if self.capabilities & CLIENT_PLUGIN_AUTH_LENENC:
            resp += lenenc_bytes(auth)
        else:
            resp += bytes([len(auth)]) + auth
        if database:
            resp += database.encode() + b"\x00"
        if self.capabilities & CLIENT_PLUGIN_AUTH:
            resp += plugin.encode() + b"\x00"
        self._send_packet(resp)
        self._auth_loop(password)

    @staticmethod
    def _scramble(plugin: str, password: str, nonce: bytes) -> bytes:
        if plugin == "mysql_native_password":
            return native_password_scramble(password, nonce[:20])
        if plugin == "caching_sha2_password":
            return caching_sha2_scramble(password, nonce[:20])
        raise MySQLProtocolError(f"unsupported auth plugin {plugin!r}")

    def _auth_loop(self, password: str) -> None:
        while True:
            pkt = self._recv_packet()
            first = pkt[0]
            if first == 0x00:  # OK
                self._parse_ok(pkt)
                return
            if first == 0xFF:
                raise self._parse_err(pkt)
            if first == 0xFE:  # AuthSwitchRequest
                end = pkt.index(b"\x00", 1)
                plugin = pkt[1:end].decode()
                raw = pkt[end + 1:]
                # the AuthSwitch payload is the 20-byte salt + one
                # trailing NUL terminator: strip exactly that, not
                # every trailing zero byte of the salt itself
                nonce = raw[:-1] if raw.endswith(b"\x00") else raw
                self._send_packet(self._scramble(plugin, password, nonce))
                continue
            if first == 0x01:  # AuthMoreData (caching_sha2 continuation)
                if pkt[1:2] == b"\x03":  # fast-auth success; OK follows
                    continue
                if pkt[1:2] == b"\x04":
                    raise MySQLProtocolError(
                        "server demands caching_sha2 FULL authentication, "
                        "which would send the password over this plaintext "
                        "channel (TLS/RSA are out of scope in-repo) — "
                        "refusing; terminate TLS in front of the server or "
                        "warm its auth cache / use mysql_native_password")
                raise MySQLProtocolError(
                    f"unexpected auth continuation {pkt[1:2]!r}")
            raise MySQLProtocolError(f"unexpected auth packet 0x{first:02x}")

    # -- results -------------------------------------------------------------
    def _read_coldefs(self, n: int) -> list[_ColDef]:
        cols = [_ColDef(self._recv_packet()) for _ in range(n)]
        if not self.capabilities & CLIENT_DEPRECATE_EOF:
            eof = self._recv_packet()
            if eof[:1] != b"\xfe":
                raise MySQLProtocolError("missing EOF after column defs")
        return cols

    @staticmethod
    def _decode_text(v: Optional[bytes], col: _ColDef):
        if v is None:
            return None
        if col.type in _INT_TYPES:
            return int(v)
        if col.type in (T_FLOAT, T_DOUBLE):
            return float(v)
        if col.type in _STR_TYPES and col.charset == _BINARY_CHARSET:
            return v
        return v.decode()

    def _read_text_rows(self, cols: list[_ColDef]) -> list[list]:
        rows = []
        while True:
            pkt = self._recv_packet()
            if pkt[:1] == b"\xff":
                raise self._parse_err(pkt)
            if pkt[:1] == b"\xfe" and len(pkt) < 9:
                return rows
            off, row = 0, []
            for c in cols:
                v, off = read_lenenc_bytes(pkt, off)
                row.append(self._decode_text(v, c))
            rows.append(row)

    def _decode_binary_value(self, pkt: bytes, off: int, col: _ColDef):
        t = col.type
        if t in _INT_TYPES:
            width = _INT_TYPES[t]
            raw = pkt[off:off + width]
            signed = not col.flags & 0x20  # UNSIGNED_FLAG
            return int.from_bytes(raw, "little", signed=signed), off + width
        if t == T_FLOAT:
            return struct.unpack_from("<f", pkt, off)[0], off + 4
        if t == T_DOUBLE:
            return struct.unpack_from("<d", pkt, off)[0], off + 8
        if t in _STR_TYPES:
            v, off = read_lenenc_bytes(pkt, off)
            if v is not None and col.charset != _BINARY_CHARSET:
                return v.decode(), off
            return v, off
        if t in (T_DATE, T_DATETIME, T_TIMESTAMP):
            n = pkt[off]
            off += 1
            parts = pkt[off:off + n]
            off += n
            if n == 0:
                return "0000-00-00 00:00:00", off
            y, mo, d = struct.unpack_from("<HBB", parts, 0)
            h = mi = s = us = 0
            if n >= 7:
                h, mi, s = parts[4], parts[5], parts[6]
            if n >= 11:
                us = struct.unpack_from("<I", parts, 7)[0]
            out = f"{y:04d}-{mo:02d}-{d:02d} {h:02d}:{mi:02d}:{s:02d}"
            if us:
                out += f".{us:06d}"
            return out, off
        raise MySQLProtocolError(f"unsupported binary column type {t}")

    def _read_binary_rows(self, cols: list[_ColDef]) -> list[list]:
        rows = []
        n = len(cols)
        bitmap_len = (n + 9) // 8
        while True:
            pkt = self._recv_packet()
            if pkt[:1] == b"\xff":
                raise self._parse_err(pkt)
            if pkt[:1] == b"\xfe" and len(pkt) < 9:
                return rows
            if pkt[0] != 0x00:
                raise MySQLProtocolError(
                    f"bad binary row header 0x{pkt[0]:02x}")
            bitmap = pkt[1:1 + bitmap_len]
            off = 1 + bitmap_len
            row = []
            for j, c in enumerate(cols):
                bit = j + 2
                if bitmap[bit // 8] & (1 << (bit % 8)):
                    row.append(None)
                else:
                    v, off = self._decode_binary_value(pkt, off, c)
                    row.append(v)
            rows.append(row)

    # -- public query API ----------------------------------------------------
    def query(self, sql: str, params: Sequence = ()) -> tuple[list[str], list[list]]:
        """Run one statement; parameterized statements ride the prepared-
        statement binary protocol (COM_STMT_PREPARE/EXECUTE — parameters
        never enter SQL text), bare ones COM_QUERY. Accepts pgwire's
        ``$N`` placeholder style and rewrites it to ``?`` positionally so
        the SQL backends can share DAO code. Returns (column_names, rows);
        a transport/protocol failure poisons the connection."""
        with self._lock:
            if self._broken:
                raise MySQLProtocolError(
                    "connection is broken by an earlier transport error — "
                    "create a new MySQLConnection")
            try:
                return self._query_locked(sql, params)
            except (OSError, MySQLProtocolError, struct.error, IndexError,
                    UnicodeDecodeError) as e:
                # struct/Index/Unicode errors mean malformed server bytes
                # mid-parse: the stream position is unknown, so reusing
                # the connection would read leftover packets as the next
                # query's response — poison it like a transport error.
                self._broken = True
                try:
                    self._sock.close()
                except OSError:
                    pass
                if not isinstance(e, (OSError, MySQLProtocolError)):
                    raise MySQLProtocolError(
                        f"malformed server response ({e!r})") from e
                raise

    def _query_locked(self, sql, params):
        sql, params = _dollar_to_qmark(sql, params)
        if not params:
            self._command(b"\x03" + sql.encode())  # COM_QUERY
            return self._read_resultset(binary=False)
        stmt_id, n_params = self._prepare(sql)
        try:
            if n_params != len(params):
                raise MySQLError(
                    1210, "HY000",
                    f"statement wants {n_params} parameters, got "
                    f"{len(params)}")
            self._execute(stmt_id, params)
            return self._read_resultset(binary=True)
        finally:
            try:
                self._command(b"\x19" + struct.pack("<I", stmt_id))
            except OSError:  # COM_STMT_CLOSE has no response to fail on
                pass

    def _prepare(self, sql: str) -> tuple[int, int]:
        self._command(b"\x16" + sql.encode())
        head = self._recv_packet()
        if head[:1] == b"\xff":
            raise self._parse_err(head)
        if head[0] != 0x00:
            raise MySQLProtocolError("bad COM_STMT_PREPARE response")
        stmt_id, n_cols, n_params = struct.unpack_from("<IHH", head, 1)
        if n_params:
            self._read_coldefs(n_params)
        if n_cols:
            self._read_coldefs(n_cols)
        return stmt_id, n_params

    def _execute(self, stmt_id: int, params: Sequence) -> None:
        body = b"\x17" + struct.pack("<IBI", stmt_id, 0, 1)
        n = len(params)
        bitmap = bytearray((n + 7) // 8)
        types = b""
        values = b""
        for j, p in enumerate(params):
            if p is None:
                bitmap[j // 8] |= 1 << (j % 8)
                types += bytes([T_VAR_STRING, 0])
            elif isinstance(p, bytes):
                types += bytes([T_LONG_BLOB, 0])
                values += lenenc_bytes(p)
            else:
                if isinstance(p, bool):
                    text = "1" if p else "0"
                else:
                    text = str(p)
                types += bytes([T_VAR_STRING, 0])
                values += lenenc_bytes(text.encode())
        body += bytes(bitmap) + b"\x01" + types + values
        self._command(body)

    def _read_resultset(self, binary: bool) -> tuple[list[str], list[list]]:
        head = self._recv_packet()
        if head[:1] == b"\xff":
            raise self._parse_err(head)
        if head[:1] == b"\x00":
            self._parse_ok(head)
            return [], []
        n_cols, off = read_lenenc_int(head, 0)
        if off != len(head) or not n_cols:
            raise MySQLProtocolError("bad result-set header")
        cols = self._read_coldefs(n_cols)
        rows = (self._read_binary_rows(cols) if binary
                else self._read_text_rows(cols))
        return [c.name for c in cols], rows

    def ping(self) -> bool:
        with self._lock:
            self._command(b"\x0e")
            return self._recv_packet()[:1] == b"\x00"

    def close(self) -> None:
        with self._lock:
            if not self._broken:
                try:
                    self._command(b"\x01")  # COM_QUIT
                except OSError:
                    pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._broken = True


def _dollar_to_qmark(sql: str, params: Sequence) -> tuple[str, list]:
    """Rewrite pgwire-style ``$N`` placeholders to positional ``?``.

    Shared DAO SQL is written once in the $N style; MySQL's protocol
    only knows positional markers. Occurrence order defines the new
    parameter order (handles repeated/out-of-order $N). '$' followed by
    a non-digit (e.g. the '$set' event-name literal) is left alone.
    """
    out = []
    order: list[int] = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch == "$" and i + 1 < n and sql[i + 1].isdigit():
            j = i + 1
            while j < n and sql[j].isdigit():
                j += 1
            order.append(int(sql[i + 1:j]))
            out.append("?")
            i = j
        else:
            out.append(ch)
            i += 1
    if not order:
        return sql, list(params)
    return "".join(out), [params[k - 1] for k in order]
