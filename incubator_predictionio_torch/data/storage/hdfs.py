"""HDFS model store — the `HDFS` source type, over WebHDFS.

The port's own copy of ``incubator_predictionio_tpu/data/storage/hdfs.py``;
the paths and the file bytes are the reference's.

Reference: storage/hdfs/.../HDFSModels.scala (SURVEY.md §2.1 last row):
model blobs on a Hadoop filesystem. This speaks the **WebHDFS REST
protocol** (the `dfs.webhdfs.enabled` HTTP gateway on the NameNode,
default :9870) — no Hadoop client libraries:

    PIO_STORAGE_SOURCES_HDFS_TYPE=HDFS
    PIO_STORAGE_SOURCES_HDFS_HOSTS=namenode       PORTS=9870
    PIO_STORAGE_SOURCES_HDFS_PATH=/pio/models     (base directory)
    PIO_STORAGE_SOURCES_HDFS_USERNAME=pio         (user.name, optional)

Write = the two-step CREATE dance (NameNode 307 → DataNode PUT), read =
OPEN (redirects followed transparently), delete = DELETE op. Model-data
only, like the reference's HDFS assembly."""

from __future__ import annotations

import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from ...common import resilience
from . import base


class HDFSStorageError(RuntimeError):
    pass


class _WebHDFS:
    def __init__(self, endpoint: str, user: str = "", timeout: float = 30.0,
                 policy: Optional[resilience.RetryPolicy] = None,
                 breaker: Optional[resilience.CircuitBreaker] = None):
        self.endpoint = endpoint.rstrip("/")
        self.user = user
        self.timeout = timeout
        self.policy = policy or resilience.RetryPolicy()
        self.breaker = breaker or resilience.CircuitBreaker(
            f"hdfs:{self.endpoint}")

    def _url(self, path: str, op: str, **params) -> str:
        q = {"op": op, **params}
        if self.user:
            q["user.name"] = self.user
        return (f"{self.endpoint}/webhdfs/v1{urllib.parse.quote(path)}"
                f"?{urllib.parse.urlencode(q)}")

    def _request(self, method: str, url: str, data: Optional[bytes] = None,
                 redirect_data: Optional[bytes] = None, follow: bool = True):
        """(status, body, redirected) — ``redirected`` tells CREATE
        whether its payload actually travelled (the 307 leg carries it)."""
        headers = {}
        if data is not None:
            # HttpFS-style gateways 400 data-bearing CREATE/APPEND
            # requests that are not application/octet-stream
            headers["Content-Type"] = "application/octet-stream"
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with resilience.resilient_urlopen(
                req, timeout=self.timeout, policy=self.policy,
                breaker=self.breaker, point="hdfs.request",
            ) as resp:
                return resp.status, resp.read(), False
        except urllib.error.HTTPError as e:
            if e.code == 307 and follow:
                # the CREATE/OPEN redirect to a DataNode: only THIS leg
                # carries the file body (the WebHDFS two-step contract —
                # the NameNode leg must be data-free)
                location = e.headers.get("Location")
                if not location:
                    raise HDFSStorageError(
                        f"WebHDFS 307 without a Location header from "
                        f"{url.split('?')[0]} — broken NameNode/proxy")
                st, body, _ = self._request(method, location,
                                            data=redirect_data, follow=False)
                return st, body, True
            return e.code, e.read(), False
        except resilience.CircuitOpenError:
            raise
        except (OSError, resilience.RetryBudgetExceeded) as e:
            reason = getattr(e, "reason", e)
            raise HDFSStorageError(
                f"WebHDFS unreachable: {self.endpoint} ({reason})") from e

    def create(self, path: str, data: bytes) -> None:
        # two-step: body-free PUT to the NameNode → 307 Location → PUT
        # the data to the DataNode
        status, body, redirected = self._request(
            "PUT", self._url(path, "CREATE", overwrite="true"),
            redirect_data=data)
        if status in (200, 201) and not redirected and data:
            # Direct-write gateway (HttpFS / certain proxies answer the
            # NameNode leg themselves, no redirect): the "success" above
            # created an EMPTY file because the first leg is body-free.
            # Re-PUT with the payload attached instead of silently
            # persisting nothing.
            status, body, _ = self._request(
                "PUT", self._url(path, "CREATE", overwrite="true",
                                 data="true"),
                data=data, follow=False)
        if status not in (200, 201):
            raise HDFSStorageError(
                f"WebHDFS CREATE {path}: HTTP {status} {body[:200]!r}")

    def open(self, path: str) -> Optional[bytes]:
        status, body, _ = self._request("GET", self._url(path, "OPEN"))
        if status == 404:
            return None
        if status != 200:
            raise HDFSStorageError(
                f"WebHDFS OPEN {path}: HTTP {status} {body[:200]!r}")
        return body

    def delete(self, path: str) -> None:
        status, body, _ = self._request("DELETE", self._url(path, "DELETE"))
        if status not in (200, 404):
            raise HDFSStorageError(
                f"WebHDFS DELETE {path}: HTTP {status} {body[:200]!r}")


class HDFSModels(base.Models):
    def __init__(self, transport: _WebHDFS, base_path: str, namespace: str):
        self._t = transport
        self._dir = f"{base_path.rstrip('/')}/{namespace}"

    def _path(self, model_id: str) -> str:
        safe = urllib.parse.quote(model_id, safe="")
        return f"{self._dir}/pio_model_{safe}.bin"

    def insert(self, model: base.Model) -> None:
        self._t.create(self._path(model.id), model.models)

    def get(self, model_id: str) -> Optional[base.Model]:
        body = self._t.open(self._path(model_id))
        return base.Model(model_id, body) if body is not None else None

    def delete(self, model_id: str) -> None:
        self._t.delete(self._path(model_id))


class HDFSClient(base.BaseStorageClient):
    """`TYPE=HDFS`; properties HOSTS (NameNode host or URL), PORTS
    (default 9870), PATH (base dir, default /pio/models), USERNAME
    (optional user.name for simple auth). Model-data only."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        p = config.properties
        host = (p.get("HOSTS") or "").split(",")[0].strip()
        if not host:
            raise ValueError(
                "HDFS source needs PIO_STORAGE_SOURCES_<NAME>_HOSTS "
                "(the WebHDFS gateway)")
        port = (p.get("PORTS") or "9870").split(",")[0].strip()
        endpoint = host if "://" in host else f"http://{host}:{port}"
        self._transport = _WebHDFS(
            endpoint, user=p.get("USERNAME", ""),
            policy=resilience.policy_from_props(p),
            breaker=resilience.breaker_from_props(p, f"hdfs:{endpoint}"))
        self._base = p.get("PATH", "/pio/models")
        base.check_reachable(endpoint, "WebHDFS")

    def breaker_states(self) -> list[dict]:
        return [self._transport.breaker.snapshot()]

    def models(self, namespace: str = "pio_modeldata") -> base.Models:
        return HDFSModels(self._transport, self._base, namespace)
