"""Storage registry — env-driven backend selection.

The port's own copy of ``incubator_predictionio_tpu/data/storage/registry.py``
with the embedded backends. It reads

    PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_NAME
    PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_SOURCE
    PIO_STORAGE_SOURCES_<NAME>_TYPE
    PIO_STORAGE_SOURCES_<NAME>_<PROP>   (backend-specific, e.g. PATH)

instantiates one client per source and hands out typed DAOs per
repository.

Defaults (no env set): a single SQLITE source at
``$PIO_FS_BASEDIR/pio.sqlite`` (else ``~/.pio_store/pio.sqlite``) serving
all three repositories — the same file, tables and schema as the JAX
package's default, so a store written by one package trains under the
other. A JSONL source (``data/storage/jsonl.py``; ``PATH``, default
``$PIO_FS_BASEDIR/events``) serves the event repository from the same log
files as the reference's.

The network stores: HTTP (a ``pio storageserver``,
``data/storage/http_backend.py``), PGSQL (``postgres.py`` over
``pgwire.py``) and MYSQL (``mysql.py`` over ``mysqlwire.py``), with the
reference's wire bytes and tables. The object and search stores: S3
(``s3.py``, model data), HDFS (``hdfs.py`` over WebHDFS, model data),
ELASTICSEARCH (``elasticsearch.py``, metadata and events) and HBASE
(``hbase.py``, events, over the REST gateway or the native RPC of
``hbase_rpc.py``). A network store that fails to connect or to
authenticate raises :class:`StorageError` naming the source; nothing
falls back to SQLite. JDBC is refused as the reference refuses it.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from ...common import envknobs
from . import base
from .elasticsearch import ESClient
from .hbase import HBaseClient
from .hdfs import HDFSClient
from .http_backend import HTTPStorageClient
from .jsonl import JSONLClient
from .localfs import LocalFSClient
from .memory import StorageClient as MemoryClient
from .mysql import MySQLClient
from .postgres import PGClient
from .s3 import S3Client
from .sqlite import SQLiteClient


class StorageError(Exception):
    pass


_BACKENDS: dict[str, Callable[[base.StorageClientConfig], base.BaseStorageClient]] = {
    "MEMORY": MemoryClient,
    "SQLITE": SQLiteClient,
    "LOCALFS": LocalFSClient,
    "JSONL": JSONLClient,
    # a `pio storageserver` shared by many hosts (http_backend.py)
    "HTTP": HTTPStorageClient,
    # the Postgres wire protocol (v3, SCRAM-SHA-256), all three repositories
    "PGSQL": PGClient,
    # the MySQL protocol (caching_sha2/native auth, binary prepared
    # statements), all three repositories
    "MYSQL": MySQLClient,
    # S3 REST with SigV4, model data only
    "S3": S3Client,
    # the Elasticsearch REST API (ES 7/8, OpenSearch), metadata and events
    "ELASTICSEARCH": ESClient,
    # events over the HBase REST gateway or the native RPC (PROTOCOL)
    "HBASE": HBaseClient,
    # WebHDFS, model data only
    "HDFS": HDFSClient,
}

#: the network stores: a failed connect or login raises StorageError
_NETWORK = {"HTTP", "PGSQL", "MYSQL", "S3", "ELASTICSEARCH", "HBASE",
            "HDFS"}

#: types whose wire protocol this package does not speak: the message
#: points at the HTTP backend (the same shared-network-store shape)
_UNSUPPORTED = {"JDBC"}

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")


def base_dir() -> str:
    """``$PIO_FS_BASEDIR``, else ``~/.pio_store`` (created if missing)."""
    d = (envknobs.env_str("PIO_FS_BASEDIR", "", lower=False)
         or os.path.expanduser("~/.pio_store"))
    os.makedirs(d, exist_ok=True)
    return d


class Storage:
    """Process-wide registry instance. ``Storage.instance()`` is the
    singleton accessor; tests may build isolated instances from an env
    dict."""

    _singleton: Optional["Storage"] = None
    _singleton_lock = threading.Lock()

    def __init__(self, env: Optional[dict[str, str]] = None):
        self._env = dict(os.environ if env is None else env)
        self._clients: dict[str, base.BaseStorageClient] = {}
        self._lock = threading.RLock()

    @classmethod
    def instance(cls) -> "Storage":
        with cls._singleton_lock:
            if cls._singleton is None:
                cls._singleton = Storage()
            return cls._singleton

    @classmethod
    def reset_instance(cls, env: Optional[dict[str, str]] = None) -> "Storage":
        """Testing hook: swap the singleton (closing old clients)."""
        with cls._singleton_lock:
            if cls._singleton is not None:
                cls._singleton.close()
            cls._singleton = Storage(env)
            return cls._singleton

    # -- source resolution ------------------------------------------------
    def _repo_source_name(self, repo: str) -> str:
        return (self._env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
                or "PIO_DEFAULT")

    def repo_namespace(self, repo: str) -> str:
        """The _NAME of a repository (table-name prefix upstream)."""
        return self._env.get(
            f"PIO_STORAGE_REPOSITORIES_{repo}_NAME", f"pio_{repo.lower()}"
        )

    def repo_source_type(self, repo: str) -> str:
        """The configured TYPE of a repository's source (without
        constructing the client). Default source is SQLITE."""
        source = self._repo_source_name(repo)
        if source == "PIO_DEFAULT":
            return "SQLITE"
        return self._env.get(
            f"PIO_STORAGE_SOURCES_{source}_TYPE", ""
        ).upper()

    def _client_for_source(self, source_name: str) -> base.BaseStorageClient:
        with self._lock:
            if source_name in self._clients:
                return self._clients[source_name]
            if source_name == "PIO_DEFAULT":
                stype = "SQLITE"
                props = {"PATH": os.path.join(base_dir(), "pio.sqlite")}
            else:
                stype = self._env.get(f"PIO_STORAGE_SOURCES_{source_name}_TYPE", "")
                if not stype:
                    raise StorageError(
                        f"PIO_STORAGE_SOURCES_{source_name}_TYPE is not set"
                    )
                stype = stype.upper()
                prefix = f"PIO_STORAGE_SOURCES_{source_name}_"
                props = {
                    k[len(prefix):]: v
                    for k, v in self._env.items()
                    if k.startswith(prefix) and k != prefix + "TYPE"
                }
            if stype in _UNSUPPORTED and stype not in _BACKENDS:
                raise StorageError(
                    f"Storage type {stype} requires an external service not "
                    f"bundled with this build; for a shared network store "
                    f"run `pio storageserver` and set TYPE=HTTP, or use "
                    f"PGSQL, MYSQL, SQLITE, MEMORY, LOCALFS or JSONL.")
            if stype not in _BACKENDS:
                raise StorageError(f"Unknown storage type {stype}")
            config = base.StorageClientConfig(
                test=self._env.get("PIO_TEST", "") == "1", properties=props)
            try:
                client = _BACKENDS[stype](config)
            except Exception as e:
                if stype not in _NETWORK:
                    raise
                # an unreachable store or a refused login: no fallback
                raise StorageError(
                    f"Storage source {source_name} ({stype}) cannot be "
                    f"opened: {e}") from e
            self._clients[source_name] = client
            return client

    def _client(self, repo: str) -> base.BaseStorageClient:
        return self._client_for_source(self._repo_source_name(repo))

    # -- typed DAO accessors (reference: Storage.getMetaDataApps etc.) ----
    # Each DAO is namespaced by the repository _NAME (table/keyspace prefix).
    def get_meta_data_apps(self) -> base.Apps:
        return self._client("METADATA").apps(self.repo_namespace("METADATA"))

    def get_meta_data_access_keys(self) -> base.AccessKeys:
        return self._client("METADATA").access_keys(self.repo_namespace("METADATA"))

    def get_meta_data_channels(self) -> base.Channels:
        return self._client("METADATA").channels(self.repo_namespace("METADATA"))

    def get_meta_data_engine_instances(self) -> base.EngineInstances:
        return self._client("METADATA").engine_instances(self.repo_namespace("METADATA"))

    def get_meta_data_evaluation_instances(self) -> base.EvaluationInstances:
        return self._client("METADATA").evaluation_instances(self.repo_namespace("METADATA"))

    def get_model_data_models(self) -> base.Models:
        return self._client("MODELDATA").models(self.repo_namespace("MODELDATA"))

    def get_l_events(self) -> base.LEvents:
        return self._client("EVENTDATA").l_events(self.repo_namespace("EVENTDATA"))

    def get_p_events(self) -> base.PEvents:
        return self._client("EVENTDATA").p_events(self.repo_namespace("EVENTDATA"))

    def verify_all_data_objects(self) -> list[str]:
        """`pio status` support: try constructing every DAO, return errors."""
        errors = []
        for fn in (
            self.get_meta_data_apps,
            self.get_meta_data_access_keys,
            self.get_meta_data_channels,
            self.get_meta_data_engine_instances,
            self.get_meta_data_evaluation_instances,
            self.get_model_data_models,
            self.get_l_events,
            self.get_p_events,
        ):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — surfaced to operator
                errors.append(f"{fn.__name__}: {e}")
        return errors

    def breaker_states(self) -> dict[str, list[dict]]:
        """Circuit-breaker snapshots per instantiated source (a source
        never touched has no client and no circuits yet)."""
        with self._lock:
            clients = dict(self._clients)
        return {name: client.breaker_states()
                for name, client in clients.items()}

    def backend_health(self) -> dict[str, dict]:
        """Per-repository backend and circuit state for operators
        (`pio status`, the engine server's /readyz)."""
        out: dict[str, dict] = {}
        for repo in REPOSITORIES:
            source = self._repo_source_name(repo)
            entry: dict = {"source": source,
                           "type": self.repo_source_type(repo)}
            with self._lock:
                client = self._clients.get(source)
            if client is not None:
                entry["breakers"] = client.breaker_states()
            out[repo] = entry
        return out

    def close(self) -> None:
        with self._lock:
            for c in self._clients.values():
                try:
                    c.close()
                except Exception:
                    pass
            self._clients.clear()
