"""S3-compatible model store — the `S3` source type.

The port's own copy of ``incubator_predictionio_tpu/data/storage/s3.py``;
the keys, the signature and the object bytes are the reference's, so either
package reads a model the other wrote.

Reference: storage/s3/.../S3Models.scala (SURVEY.md §2.1 last row): model
blobs as S3 objects. Like the reference's S3 assembly, this backend
serves ONLY the model-data repository; metadata/eventdata accessors raise.

Speaks the real S3 REST protocol — AWS Signature Version 4 over plain
HTTP(S) object PUT/GET/DELETE — with no SDK dependency, so it works
against AWS S3, MinIO, Ceph RGW, or any S3-compatible store:

    PIO_STORAGE_REPOSITORIES_MODELDATA_NAME=pio_modeldata
    PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE=S3
    PIO_STORAGE_SOURCES_S3_TYPE=S3
    PIO_STORAGE_SOURCES_S3_ENDPOINT=http://minio:9000
    PIO_STORAGE_SOURCES_S3_BUCKET=pio-models
    PIO_STORAGE_SOURCES_S3_ACCESS_KEY=...
    PIO_STORAGE_SOURCES_S3_SECRET_KEY=...
    PIO_STORAGE_SOURCES_S3_REGION=us-east-1        (optional)
    PIO_STORAGE_SOURCES_S3_PATH_STYLE=true         (default true)

The signature implementation follows the SigV4 spec (canonical request →
string-to-sign → HMAC-SHA256 signing-key chain) and is verified against
an in-process S3 server that independently recomputes signatures
(``tests/test_torch_object_stores.py``, against the reference's mock and
``tests/torch_s3_server.py``)."""

from __future__ import annotations

import datetime as _dt
import hashlib
import re
import hmac
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from ...common import resilience
from . import base


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_v4(
    method: str,
    url: str,
    *,
    access_key: str,
    secret_key: str,
    region: str,
    payload: bytes = b"",
    now: Optional[_dt.datetime] = None,
    service: str = "s3",
) -> dict:
    """AWS Signature V4 headers for one request. Returns the headers to
    send (host, x-amz-date, x-amz-content-sha256, authorization)."""
    parts = urllib.parse.urlsplit(url)
    now = now or _dt.datetime.now(_dt.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = _sha256(payload)

    # parts.path arrives ALREADY percent-encoded from the caller's URL;
    # sign it as-is — re-quoting would double-encode (%20 → %2520) and
    # real S3 stores would canonicalize the as-sent path differently →
    # SignatureDoesNotMatch on any key with reserved characters.
    canonical_uri = parts.path or "/"
    # query keys sorted, values URI-encoded
    q = urllib.parse.parse_qsl(parts.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(q)
    )
    host = parts.netloc
    canonical_headers = (
        f"host:{host}\n"
        f"x-amz-content-sha256:{payload_hash}\n"
        f"x-amz-date:{amz_date}\n"
    )
    signed_headers = "host;x-amz-content-sha256;x-amz-date"
    canonical_request = "\n".join([
        method, canonical_uri, canonical_query, canonical_headers,
        signed_headers, payload_hash,
    ])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        _sha256(canonical_request.encode()),
    ])
    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        ),
    }


def _xml_error_code(body: bytes) -> str:
    """<Code> of an S3 error document ('' when absent/unparseable)."""
    m = re.search(rb"<Code>([^<]+)</Code>", body)
    return m.group(1).decode(errors="replace") if m else ""


class S3StorageError(RuntimeError):
    pass


class _S3Transport:
    def __init__(self, endpoint: str, bucket: str, access_key: str,
                 secret_key: str, region: str, path_style: bool = True,
                 timeout: float = 30.0,
                 policy: Optional["resilience.RetryPolicy"] = None,
                 breaker: Optional["resilience.CircuitBreaker"] = None):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.path_style = path_style
        self.timeout = timeout
        self.policy = policy or resilience.RetryPolicy()
        self.breaker = breaker or resilience.CircuitBreaker(
            f"s3:{self.endpoint}/{bucket}")

    def _url(self, key: str) -> str:
        qkey = urllib.parse.quote(key, safe="/-_.~")
        if self.path_style:
            return f"{self.endpoint}/{self.bucket}/{qkey}"
        scheme, rest = self.endpoint.split("://", 1)
        return f"{scheme}://{self.bucket}.{rest}/{qkey}"

    def request(self, method: str, key: str, payload: bytes = b""
                ) -> tuple[int, bytes]:
        url = self._url(key)
        headers = sign_v4(
            method, url, access_key=self.access_key,
            secret_key=self.secret_key, region=self.region, payload=payload,
        )
        req = urllib.request.Request(url, data=payload or None,
                                     headers=headers, method=method)
        try:
            with resilience.resilient_urlopen(
                req, timeout=self.timeout, policy=self.policy,
                breaker=self.breaker, point="s3.request",
            ) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            body = e.read()
            if e.code == 403:
                # SigV4 requests embed the client clock (x-amz-date);
                # skew beyond the server's window 403s every request —
                # surface the actionable cause instead of a bare 403.
                code = _xml_error_code(body)
                if code == "RequestTimeTooSkewed":
                    raise S3StorageError(
                        "S3 rejected the request time (RequestTimeTooSkewed)"
                        " — this host's clock disagrees with the S3 "
                        "endpoint's by more than the allowed window; sync "
                        f"the clock (NTP). Server said: {body[:300]!r}")
            return e.code, body
        except resilience.CircuitOpenError:
            raise
        except (OSError, resilience.RetryBudgetExceeded) as e:
            reason = getattr(e, "reason", e)
            raise S3StorageError(
                f"S3 endpoint unreachable: {self.endpoint} ({reason})"
            ) from e


class S3Models(base.Models):
    """Model blobs as S3 objects: <namespace>/pio_model_<id>.bin."""

    def __init__(self, transport: _S3Transport, namespace: str):
        self._t = transport
        self._ns = namespace

    def _key(self, model_id: str) -> str:
        # percent-encode (collision-free — '/' → '_' would alias 'a/b'
        # with 'a_b'); the transport signs encoded paths correctly
        safe = urllib.parse.quote(model_id, safe="")
        return f"{self._ns}/pio_model_{safe}.bin"

    def _legacy_key(self, model_id: str) -> Optional[str]:
        """Earlier key scheme ('/' → '_'); read fallback so blobs stored
        before the percent-encoding change stay reachable."""
        legacy = f"{self._ns}/pio_model_{model_id.replace('/', '_')}.bin"
        return legacy if legacy != self._key(model_id) else None

    def insert(self, model: base.Model) -> None:
        status, body = self._t.request("PUT", self._key(model.id),
                                       model.models)
        if status not in (200, 201, 204):
            raise S3StorageError(
                f"S3 PUT {self._key(model.id)} failed: HTTP {status} "
                f"{body[:200]!r}")

    def get(self, model_id: str) -> Optional[base.Model]:
        status, body = self._t.request("GET", self._key(model_id))
        if status == 404:
            legacy = self._legacy_key(model_id)
            if legacy is not None:
                status, body = self._t.request("GET", legacy)
                if status == 200:
                    return base.Model(model_id, body)
            return None
        if status != 200:
            raise S3StorageError(
                f"S3 GET {self._key(model_id)} failed: HTTP {status} "
                f"{body[:200]!r}")
        return base.Model(model_id, body)

    def delete(self, model_id: str) -> None:
        status, body = self._t.request("DELETE", self._key(model_id))
        if status not in (200, 204, 404):
            raise S3StorageError(
                f"S3 DELETE {self._key(model_id)} failed: HTTP {status} "
                f"{body[:200]!r}")


class S3Client(base.BaseStorageClient):
    """`TYPE=S3`; properties ENDPOINT, BUCKET, ACCESS_KEY, SECRET_KEY,
    REGION (default us-east-1), PATH_STYLE (default true). Model-data
    only, like the reference's storage/s3 assembly."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        p = config.properties
        missing = [k for k in ("ENDPOINT", "BUCKET", "ACCESS_KEY",
                               "SECRET_KEY") if not p.get(k)]
        if missing:
            raise ValueError(
                "S3 storage source needs properties "
                + ", ".join(f"PIO_STORAGE_SOURCES_<NAME>_{m}"
                            for m in missing))
        self._transport = _S3Transport(
            endpoint=p["ENDPOINT"],
            bucket=p["BUCKET"],
            access_key=p["ACCESS_KEY"],
            secret_key=p["SECRET_KEY"],
            region=p.get("REGION", "us-east-1"),
            path_style=p.get("PATH_STYLE", "true").lower() != "false",
            policy=resilience.policy_from_props(p),
            breaker=resilience.breaker_from_props(
                p, f"s3:{p['ENDPOINT']}/{p['BUCKET']}"),
        )
        base.check_reachable(self._transport.endpoint, "S3 endpoint")

    def breaker_states(self) -> list[dict]:
        return [self._transport.breaker.snapshot()]

    def models(self, namespace: str = "pio_modeldata") -> base.Models:
        return S3Models(self._transport, namespace)
