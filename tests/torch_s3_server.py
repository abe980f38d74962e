"""An S3-compatible object store on the standard library, for the port.

The port's stand-in for ``tests/s3_mock.py`` (an aiohttp app): the same
object routes (PUT/GET/HEAD/DELETE on ``/{bucket}/{key}``) and the same
independent AWS Signature V4 check. The server re-derives the signature
from the request as sent (method, percent-encoded path, query, signed
headers, payload hash) and answers 403 ``SignatureDoesNotMatch`` on a
mismatch, so a client that passes has sent a real, verifiable SigV4.
``mode="clock_skew"`` answers every request 403 ``RequestTimeTooSkewed``.

It imports nothing outside the standard library, so ``chip_smoke.py``
loads it by path on a host without aiohttp::

    with S3Server("AK", "secret") as srv:   # srv.port, srv.objects
        ...
"""

from __future__ import annotations

import hashlib
import hmac
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote

__all__ = ["S3Server"]


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _hm(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


_AUTH = re.compile(
    r"AWS4-HMAC-SHA256 Credential=([^/]+)/(\d{8})/([^/]+)/s3/"
    r"aws4_request, SignedHeaders=([^,]+), Signature=([0-9a-f]+)")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    wbufsize = -1
    server: "S3Server"

    def log_message(self, *args) -> None:
        pass

    def _reply(self, status: int, body: bytes = b"",
               ctype: str = "application/octet-stream") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _error(self, code: str, status: int) -> None:
        self._reply(status, (f'<?xml version="1.0"?><Error><Code>{code}'
                             f'</Code></Error>').encode(), "application/xml")

    def _verify(self, payload: bytes) -> bool:
        srv = self.server
        m = _AUTH.match(self.headers.get("Authorization", ""))
        if not m:
            return False
        akid, datestamp, region, signed_headers, signature = m.groups()
        if akid != srv.access_key or region != srv.region:
            return False
        content_sha = self.headers.get("x-amz-content-sha256", "")
        if _sha(payload) != content_sha:
            return False
        canonical_headers = "".join(
            f"{h}:{self.headers.get(h, '')}\n"
            for h in signed_headers.split(";"))
        raw_path, _, query = self.path.partition("?")
        canonical = "\n".join([self.command, raw_path, query,
                               canonical_headers, signed_headers,
                               content_sha])
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", self.headers.get("x-amz-date", ""),
            f"{datestamp}/{region}/s3/aws4_request",
            _sha(canonical.encode())])
        k = _hm(("AWS4" + srv.secret_key).encode(), datestamp)
        for part in (region, "s3", "aws4_request"):
            k = _hm(k, part)
        expect = hmac.new(k, string_to_sign.encode(),
                          hashlib.sha256).hexdigest()
        return hmac.compare_digest(expect, signature)

    def _handle(self) -> None:
        n = int(self.headers.get("Content-Length") or 0)
        payload = self.rfile.read(n) if n else b""
        srv = self.server
        if srv.mode == "clock_skew":
            return self._error("RequestTimeTooSkewed", 403)
        if not self._verify(payload):
            return self._error("SignatureDoesNotMatch", 403)
        # the decoded path keys the object, as the reference's mock does
        key = unquote(self.path.partition("?")[0])
        with srv.lock:
            if self.command == "PUT":
                srv.objects[key] = payload
                return self._reply(200)
            if self.command in ("GET", "HEAD"):
                body = srv.objects.get(key)
                if body is None:
                    return self._error("NoSuchKey", 404)
                return self._reply(200, body)
            if self.command == "DELETE":
                srv.objects.pop(key, None)
                return self._reply(204)
        return self._error("MethodNotAllowed", 405)

    do_PUT = do_GET = do_HEAD = do_DELETE = do_POST = _handle


class S3Server(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, access_key: str, secret_key: str,
                 region: str = "us-east-1", mode: str = "default",
                 port: int = 0):
        super().__init__(("127.0.0.1", port), _Handler)
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.mode = mode
        self.objects: dict[str, bytes] = {}
        self.lock = threading.Lock()

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def __enter__(self) -> "S3Server":
        threading.Thread(target=self.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
        self.server_close()
