"""Shared helpers of the port's fleet tests (``tests/test_torch_fleet_*.py``,
``tests/test_torch_elastic.py``): a SQLite store the replicas share, the
lifecycle trains, a real fleet subprocess (tests/torch_fleet_front.py over
tests/torch_fleet_server.py replicas) and a background query fire. The
port's copy of the harness half of ``tests/test_fleet.py``.
"""

from __future__ import annotations

import http.client
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import torch_serving as ts
from incubator_predictionio_torch.data.storage import Storage

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GROUP = "lifecycle::default"


def sqlite_env(tmp_path, **extra) -> dict:
    """The replicas' environment: SQLite metadata and models (shared by
    every process), memory events, fast fleet ticks."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update({
        "PYTHONPATH": ROOT,
        "PIO_FS_BASEDIR": str(tmp_path / "base"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "meta.sqlite"),
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY",
        "PIO_FLEET_SYNC_MS": "200",
        "PIO_FLEET_READY_MS": "150",
        # a loaded test host can starve every replica's accept loop at
        # once: the front's connect budget gets real slack
        "PIO_FLEET_CONNECT_RETRY_MS": "8000",
    })
    for k in ("PIO_FAULT_SPEC", "PIO_FLEET_WORKER_FAULT_SPEC"):
        env.pop(k, None)
    env.update(extra)
    return env


def storage_for(env: dict) -> Storage:
    return Storage({k: v for k, v in env.items()
                    if k.startswith("PIO_STORAGE")})


def train(storage, tag: str, mode: str = "good") -> str:
    """One lifecycle train (the tag answers every query)."""
    return ts.train_lifecycle(storage, tag, mode)


def poll(fn, deadline_s: float, every: float = 0.1, msg: str = "condition"):
    deadline = time.monotonic() + deadline_s
    last = None
    while time.monotonic() < deadline:
        last = fn()
        if last:
            return last
        time.sleep(every)
    raise AssertionError(f"timed out waiting for {msg}; last={last!r}")


def get(base: str, path: str, timeout: float = 5.0):
    """Control-plane GET with a few retries (a poll may land on a replica
    the kernel is tearing down): (status, JSON)."""
    last = None
    for _ in range(4):
        try:
            status, body, _ = ts.call(base, "GET", path, timeout=timeout)
            return status, body
        except (OSError, http.client.HTTPException) as e:
            last = e
            time.sleep(0.3)
    raise last


class Fleet:
    """A real fleet subprocess: front + supervisor + coordinator over
    replica servers. Output goes to a file (a flood would fill a pipe)."""

    def __init__(self, env: dict, replicas: int, elastic: bool = False):
        self.replicas = replicas
        self.port = ts.free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self._log = tempfile.NamedTemporaryFile(
            prefix=f"pio_torch_fleet_{self.port}_", suffix=".log",
            delete=False)
        argv = [sys.executable, os.path.join(HERE, "torch_fleet_front.py"),
                str(self.port), str(replicas)]
        if elastic:
            argv.append("elastic")
        self.proc = subprocess.Popen(argv, env=env, stdout=self._log,
                                     stderr=subprocess.STDOUT)

    def healthz(self, timeout: float = 5.0) -> dict:
        status, body = get(self.base, "/healthz", timeout)
        assert status == 200, body
        return body

    def status(self, timeout: float = 5.0) -> dict:
        return get(self.base, "/status", timeout)[1]

    def fleet_view(self) -> dict:
        return self.status().get("fleet") or {}

    def wait_ready(self, deadline_s: float = 120.0) -> dict:
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise AssertionError("fleet front died: " + self.tail())
            try:
                doc = self.healthz(timeout=2)
                if (doc.get("readyReplicas") == self.replicas
                        and all(b["alive"] for b in doc["backends"])):
                    return doc
            except (OSError, http.client.HTTPException, AssertionError):
                pass
            time.sleep(0.2)
        raise AssertionError("fleet not ready in time: " + self.tail())

    def _reap(self) -> None:
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        self._log.close()

    def stop(self, expect_rc=0) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                rc = self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                raise
            if expect_rc is not None:
                assert rc == expect_rc, self.tail()
        self._reap()

    def tail(self) -> str:
        try:
            with open(self._log.name, "rb") as f:
                return f.read().decode(errors="replace")[-4000:]
        except OSError:
            return "<no output>"

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self._reap()


class Clients:
    """Background queries against the front, a fresh connection each
    (round-robin across replicas): every status code and served tag."""

    def __init__(self, base: str, threads: int = 2, pause: float = 0.025,
                 query=None):
        self.base = base
        self.codes: list[int] = []
        self.conn_errors = 0
        self.tags: set = set()
        self._query = query or (lambda idx, n: {"user": f"u{idx}-{n}"})
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._fire, args=(i,))
                         for i in range(threads)]
        self._pause = pause

    def _fire(self, idx: int) -> None:
        n = 0
        while not self._stop.is_set():
            n += 1
            try:
                status, body, _ = ts.query(self.base, self._query(idx, n),
                                           timeout=15)
                self.codes.append(status)
                if status == 200:
                    self.tags.add(body.get("tag"))
            except (OSError, http.client.HTTPException):
                if not self._stop.is_set():
                    self.conn_errors += 1
            time.sleep(self._pause)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(30)


def alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False
