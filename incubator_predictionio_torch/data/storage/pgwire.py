"""PostgreSQL wire-protocol (v3) client — no driver dependency.

The port's own copy of ``incubator_predictionio_tpu/data/storage/pgwire.py``; the wire
bytes and the tables are the reference's, so either package reads a store
the other wrote.

The reference's JDBC backend reaches Postgres/MySQL through scalikejdbc
(SURVEY.md §2.1 storage/jdbc). No psycopg ships with this package, so the
PGSQL backend (postgres.py) speaks the frontend/backend protocol
directly: startup, password authentication (cleartext, MD5, and
SCRAM-SHA-256 per RFC 5802/7677), and the EXTENDED query protocol
(Parse/Bind/Execute/Sync) — parameters travel out-of-band in text
format, so there is no SQL string interpolation anywhere.

Scope: synchronous, text-format results, one connection per client
(the storage layer serializes DAO calls). TLS is out of scope in-repo;
deployments front Postgres with stunnel/pgbouncer or a local socket.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import socket
import struct
import threading
from typing import Optional, Sequence


class PGError(RuntimeError):
    """Server-reported error (severity, code, message)."""

    def __init__(self, fields: dict):
        self.fields = fields
        super().__init__(
            f"{fields.get('S', 'ERROR')} {fields.get('C', '')}: "
            f"{fields.get('M', 'unknown error')}")

    @property
    def sqlstate(self) -> str:
        return self.fields.get("C", "")


class PGProtocolError(RuntimeError):
    pass


def _bytea_unescape(text: str) -> bytes:
    """PostgreSQL bytea 'escape' output → bytes: ``\\\\`` is a literal
    backslash, ``\\NNN`` an octal byte, everything else latin-1."""
    out = bytearray()
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c != "\\":
            out.append(ord(c))
            i += 1
        elif text[i + 1:i + 2] == "\\":
            out.append(0x5C)
            i += 2
        else:
            octal = text[i + 1:i + 4]
            if len(octal) != 3 or not all(ch in "01234567" for ch in octal):
                raise PGProtocolError(
                    f"malformed bytea escape sequence {text[i:i + 4]!r}")
            out.append(int(octal, 8))
            i += 4
    return bytes(out)


def _md5_password(user: str, password: str, salt: bytes) -> str:
    inner = hashlib.md5(password.encode() + user.encode()).hexdigest()
    return "md5" + hashlib.md5(inner.encode() + salt).hexdigest()


class _Scram:
    """Client side of SCRAM-SHA-256 (RFC 5802 / RFC 7677)."""

    def __init__(self, user: str, password: str):
        self.password = password.encode()
        self.nonce = base64.b64encode(os.urandom(18)).decode()
        # Postgres ignores the SCRAM username (uses the startup user)
        self.client_first_bare = f"n=,r={self.nonce}"

    def first_message(self) -> bytes:
        return ("n,," + self.client_first_bare).encode()

    def final_message(self, server_first: bytes) -> bytes:
        attrs = dict(kv.split("=", 1)
                     for kv in server_first.decode().split(","))
        server_nonce, salt_b64, iters = attrs["r"], attrs["s"], int(attrs["i"])
        if not server_nonce.startswith(self.nonce):
            raise PGProtocolError("SCRAM server nonce mismatch")
        salted = hashlib.pbkdf2_hmac(
            "sha256", self.password, base64.b64decode(salt_b64), iters)
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        stored_key = hashlib.sha256(client_key).digest()
        without_proof = f"c=biws,r={server_nonce}"
        auth_message = ",".join([
            self.client_first_bare, server_first.decode(), without_proof,
        ]).encode()
        client_sig = hmac.new(stored_key, auth_message,
                              hashlib.sha256).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, client_sig))
        server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
        self._server_sig = hmac.new(server_key, auth_message,
                                    hashlib.sha256).digest()
        return (without_proof
                + ",p=" + base64.b64encode(proof).decode()).encode()

    def verify_final(self, server_final: bytes) -> None:
        attrs = dict(kv.split("=", 1)
                     for kv in server_final.decode().split(","))
        if base64.b64decode(attrs.get("v", "")) != self._server_sig:
            raise PGProtocolError(
                "SCRAM server signature mismatch (server does not know "
                "the password — possible MITM)")


class PGConnection:
    """One protocol-v3 connection; ``query`` is thread-safe (lock)."""

    def __init__(self, host: str, port: int, user: str, password: str,
                 database: str, timeout: float = 30.0,
                 connect_timeout: float = 10.0):
        self._lock = threading.RLock()
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.settimeout(timeout)
        self._buf = b""
        self._broken = False
        # True while a request/response conversation is on the wire.
        # Guards against a GC-finalized stream generator re-entering
        # the (reentrant) lock from THIS thread mid-conversation and
        # injecting a Sync (see _end_stream).
        self._in_conversation = False
        self.user = user
        self._startup(user, password, database)

    # -- low-level framing -------------------------------------------------
    def _send(self, type_byte: bytes, payload: bytes) -> None:
        self._sock.sendall(type_byte + struct.pack("!I", len(payload) + 4)
                           + payload)

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise PGProtocolError("server closed the connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _recv_message(self) -> tuple[bytes, bytes]:
        head = self._recv_exact(5)
        mtype = head[:1]
        length = struct.unpack("!I", head[1:])[0]
        return mtype, self._recv_exact(length - 4)

    @staticmethod
    def _cstr(s: str) -> bytes:
        return s.encode() + b"\x00"

    @staticmethod
    def _parse_error(payload: bytes) -> PGError:
        fields = {}
        for part in payload.split(b"\x00"):
            if part:
                fields[chr(part[0])] = part[1:].decode(errors="replace")
        return PGError(fields)

    # -- startup + auth ------------------------------------------------------
    def _startup(self, user: str, password: str, database: str) -> None:
        params = (self._cstr("user") + self._cstr(user)
                  + self._cstr("database") + self._cstr(database)
                  + self._cstr("client_encoding") + self._cstr("UTF8")
                  + b"\x00")
        body = struct.pack("!I", 196608) + params  # protocol 3.0
        self._sock.sendall(struct.pack("!I", len(body) + 4) + body)

        scram: Optional[_Scram] = None
        while True:
            mtype, payload = self._recv_message()
            if mtype == b"E":
                raise self._parse_error(payload)
            if mtype == b"R":
                code = struct.unpack("!I", payload[:4])[0]
                if code == 0:  # AuthenticationOk
                    continue
                if code == 3:  # CleartextPassword
                    self._send(b"p", self._cstr(password))
                elif code == 5:  # MD5Password
                    self._send(b"p", self._cstr(
                        _md5_password(user, password, payload[4:8])))
                elif code == 10:  # SASL: mechanism list
                    mechs = payload[4:].split(b"\x00")
                    if b"SCRAM-SHA-256" not in mechs:
                        raise PGProtocolError(
                            f"no supported SASL mechanism in {mechs}")
                    scram = _Scram(user, password)
                    first = scram.first_message()
                    self._send(b"p", self._cstr("SCRAM-SHA-256")
                               + struct.pack("!I", len(first)) + first)
                elif code == 11:  # SASLContinue
                    assert scram is not None
                    self._send(b"p", scram.final_message(payload[4:]))
                elif code == 12:  # SASLFinal
                    assert scram is not None
                    scram.verify_final(payload[4:])
                else:
                    raise PGProtocolError(
                        f"unsupported authentication method {code}")
            elif mtype in (b"S", b"K", b"N"):  # ParameterStatus/BackendKey/Notice
                continue
            elif mtype == b"Z":  # ReadyForQuery
                # hex bytea output is assumed by the row decoder; legacy
                # 'escape'-configured servers would otherwise corrupt
                # blobs silently
                self._query_locked("SET bytea_output = 'hex'", ())
                return
            else:
                raise PGProtocolError(f"unexpected message {mtype!r} in startup")

    # -- extended query ------------------------------------------------------
    def query(self, sql: str, params: Sequence = ()) -> tuple[list[str], list[list]]:
        """Parse/Bind/Execute one statement with TEXT-format parameters.
        Returns (column_names, rows) — rows hold str or None (bytes for
        bytea columns, decoded by type OID from the RowDescription).
        Parameters: None → NULL, bytes → bytea hex, everything else →
        str(). A transport/protocol failure poisons the connection (the
        stream may hold half a message; continuing would misparse)."""
        with self._lock:
            if self._broken:
                raise PGProtocolError(
                    "connection is broken by an earlier transport error — "
                    "create a new PGConnection")
            try:
                return self._query_locked(sql, params)
            except (OSError, PGProtocolError):
                self._broken = True
                try:
                    self._sock.close()
                except OSError:
                    pass
                raise

    def _send_parse_bind(self, sql, params) -> None:
        """Parse (unnamed statement) + Bind (unnamed portal) + Describe."""
        self._send(b"P", self._cstr("") + self._cstr(sql)
                   + struct.pack("!H", 0))
        bind = self._cstr("") + self._cstr("")
        bind += struct.pack("!H", 0)  # all params in text format
        bind += struct.pack("!H", len(params))
        for p in params:
            if p is None:
                bind += struct.pack("!i", -1)
            else:
                if isinstance(p, bytes):
                    text = "\\x" + p.hex()
                elif isinstance(p, bool):
                    text = "t" if p else "f"
                else:
                    text = str(p)
                raw = text.encode()
                bind += struct.pack("!i", len(raw)) + raw
        bind += struct.pack("!H", 0)  # all results in text format
        self._send(b"B", bind)
        self._send(b"D", b"P" + self._cstr(""))  # Describe portal

    @staticmethod
    def _parse_rowdesc(payload) -> tuple[list[str], list[int]]:
        (n,) = struct.unpack("!H", payload[:2])
        off = 2
        columns: list[str] = []
        type_oids: list[int] = []
        for _ in range(n):
            end = payload.index(b"\x00", off)
            columns.append(payload[off:end].decode())
            # fixed metadata: tableOID(4) attnum(2) typeOID(4)
            # typlen(2) typmod(4) fmt(2)
            (type_oid,) = struct.unpack("!I", payload[end + 7:end + 11])
            type_oids.append(type_oid)
            off = end + 1 + 18
        return columns, type_oids

    @staticmethod
    def _decode_datarow(payload, type_oids) -> list:
        BYTEA_OID = 17
        (n,) = struct.unpack("!H", payload[:2])
        off = 2
        row = []
        for j in range(n):
            (ln,) = struct.unpack("!i", payload[off:off + 4])
            off += 4
            if ln == -1:
                row.append(None)
                continue
            text = payload[off:off + ln].decode()
            off += ln
            # decode by declared column type, NOT by sniffing the text —
            # a TEXT value may legitimately start with "\\x"
            if j < len(type_oids) and type_oids[j] == BYTEA_OID:
                if text.startswith("\\x"):
                    row.append(bytes.fromhex(text[2:]))
                else:
                    # bytea_output='escape' server (the SET at startup
                    # was ignored — old server or pooler): decode the
                    # escape format instead of silently returning text
                    row.append(_bytea_unescape(text))
            else:
                row.append(text)
        return row

    def _query_locked(self, sql, params):
        self._in_conversation = True
        try:
            return self._query_conversation(sql, params)
        finally:
            self._in_conversation = False

    def _query_conversation(self, sql, params):
        self._send_parse_bind(sql, params)
        self._send(b"E", self._cstr("") + struct.pack("!i", 0))
        self._send(b"S", b"")

        columns: list[str] = []
        type_oids: list[int] = []
        rows: list[list] = []
        error: Optional[PGError] = None
        while True:
            mtype, payload = self._recv_message()
            if mtype == b"E":
                error = self._parse_error(payload)
            elif mtype == b"T":  # RowDescription
                columns, type_oids = self._parse_rowdesc(payload)
            elif mtype == b"D":  # DataRow
                rows.append(self._decode_datarow(payload, type_oids))
            elif mtype == b"Z":  # ReadyForQuery — the transaction boundary
                if error is not None:
                    raise error
                return columns, rows
            elif mtype in (b"1", b"2", b"C", b"n", b"N", b"s", b"S", b"K",
                           b"t", b"I"):
                # ParseComplete/BindComplete/CommandComplete/NoData/Notice/
                # PortalSuspended/ParameterStatus/ParameterDescription/
                # EmptyQuery — nothing to do
                continue
            else:
                raise PGProtocolError(f"unexpected message {mtype!r}")

    def query_stream(self, sql: str, params: Sequence = (),
                     fetch_size: int = 5000):
        """Stream a result set in fetch_size chunks via portal suspension.

        ``query()`` materializes every row — fine for DAO lookups, fatal
        for the 20M-event "store of record" training feed. This issues
        Execute with a row limit + Flush (NOT Sync: Sync would close the
        unnamed portal), buffers ONE chunk, yields its rows, and on
        PortalSuspended Executes again for the next chunk.

        Locking: the connection lock is held only WHILE A CHUNK IS READ,
        never across a yield (a lock held across yields could only be
        released by the owning thread — a GC-finalized generator would
        wedge the connection forever). Between chunks the wire is quiet,
        so an interleaved ``query()`` on the same connection is
        protocol-safe — but its Sync destroys the suspended portal, and
        the NEXT chunk fetch then raises a clear PGError (34000 "portal
        does not exist"): don't interleave queries with an unfinished
        stream; finish or ``close()`` the iterator first.

        Early generator close cleans up (Sync + drain to ReadyForQuery)
        so the connection stays usable.
        """
        self._begin_stream(sql, params)
        error: Optional[PGError] = None
        try:
            while True:
                rows, suspended, err = self._fetch_chunk(fetch_size)
                if err is not None:
                    error = err
                    break
                yield from rows
                if not suspended:
                    break
        finally:
            # exhausted, errored, or the caller broke early: close the
            # implicit transaction and drain to ReadyForQuery. Cleanup
            # failures must not mask the in-flight exception — they
            # poison the connection instead.
            try:
                err = self._end_stream()
                error = error or err
            except Exception:  # noqa: BLE001 - poison, don't mask
                self._broken = True
                try:
                    self._sock.close()
                except OSError:
                    pass
        if error is not None:
            raise error

    def _begin_stream(self, sql, params) -> None:
        with self._lock:
            if self._broken:
                raise PGProtocolError(
                    "connection is broken by an earlier transport error — "
                    "create a new PGConnection")
            try:
                self._send_parse_bind(sql, params)
            except OSError:
                self._broken = True
                raise
        self._stream_oids: list[int] = []

    def _fetch_chunk(self, fetch_size):
        """(rows, suspended, error) for one Execute+Flush round trip;
        lock held for the duration — the wire is quiet on return."""
        with self._lock:
            if self._broken:
                raise PGProtocolError("connection is broken")
            try:
                self._in_conversation = True
                self._send(b"E", self._cstr("")
                           + struct.pack("!i", max(int(fetch_size), 1)))
                self._send(b"H", b"")  # Flush — keep the portal open
                rows: list = []
                while True:
                    mtype, payload = self._recv_message()
                    if mtype == b"E":
                        # server skips to Sync after an error
                        return rows, False, self._parse_error(payload)
                    if mtype == b"T":
                        _, self._stream_oids = self._parse_rowdesc(payload)
                    elif mtype == b"D":
                        rows.append(
                            self._decode_datarow(payload, self._stream_oids))
                    elif mtype == b"s":  # PortalSuspended — more rows
                        return rows, True, None
                    elif mtype in (b"C", b"I"):  # complete / empty
                        return rows, False, None
                    elif mtype in (b"1", b"2", b"n", b"N", b"S", b"K",
                                   b"t"):
                        continue
                    else:
                        raise PGProtocolError(
                            f"unexpected message {mtype!r} in stream")
            except (OSError, PGProtocolError):
                self._broken = True
                try:
                    self._sock.close()
                except OSError:
                    pass
                raise
            finally:
                self._in_conversation = False

    def _end_stream(self) -> Optional[PGError]:
        with self._lock:
            if self._broken:
                return None
            if self._in_conversation:
                # Reentrant call from a GC-finalized generator while
                # THIS thread is mid-conversation (reentrant lock):
                # injecting a Sync now would eat the outer query's
                # rows. Skip — the chunks were fully read, the wire is
                # consistent, and the next query's own Sync closes the
                # leaked portal's transaction.
                return None
            self._send(b"S", b"")
            error: Optional[PGError] = None
            while True:
                mtype, payload = self._recv_message()
                if mtype == b"E":
                    error = error or self._parse_error(payload)
                elif mtype == b"Z":
                    return error

    def close(self) -> None:
        try:
            self._send(b"X", b"")
        except Exception:  # noqa: BLE001 - best-effort terminate
            pass
        try:
            self._sock.close()
        except OSError:
            pass
