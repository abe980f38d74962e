"""L4 splice front: connection-level round-robin proxying for
multi-process services.

The port's own copy of ``incubator_predictionio_tpu/common/splice.py``
(stdlib ``asyncio`` only, no HTTP stack). One listener accepts client
connections and splices each to ONE backend worker, chosen round-robin
among the backends that accept a connect, so no HTTP parsing sits on the
hot path: keep-alive clients spread across workers connection by
connection, and a worker mid-restart is skipped. The engine replica
fleet (``workflow/fleet.py``) and the partitioned event server
(``data/api/event_log.py``) ride it.

- **Readiness-aware routing.** ``FrontProxy.set_ready(i, bool)`` marks a
  backend not-ready; new connections prefer ready backends and fall back
  to every routable one only when nothing is ready. :func:`probe_ready`
  is the owner's ``GET /readyz`` prober. ``set_draining`` takes a backend
  out of rotation entirely (elastic scale-down).
- **Connect-refused retry.** A backend that refuses the connect is
  skipped within the same accept; with ``connect_retry_s`` > 0 a pass
  where EVERY backend refuses is retried within that budget before the
  client is dropped.
- **Front-served /healthz.** With ``healthz_provider`` set, a connection
  whose first request line starts with ``GET /healthz`` is answered by
  the front itself with the provider's JSON and closed; everything else
  is spliced untouched, the peeked bytes forwarded verbatim.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Callable, Optional

log = logging.getLogger("pio.torch.splice")

__all__ = ["FrontProxy", "pipe", "probe_ready"]

_HEALTHZ_PREFIX = b"GET /healthz"


async def pipe(reader: asyncio.StreamReader,
               writer: asyncio.StreamWriter) -> None:
    """One splice direction. EOF half-closes the peer (write_eof) —
    a client that shuts down its write side after the request must
    still receive the response on the other direction; the full close
    happens in the connection handler once BOTH directions are done."""
    try:
        while True:
            chunk = await reader.read(65536)
            if not chunk:
                break
            writer.write(chunk)
            await writer.drain()
        if writer.can_write_eof():
            writer.write_eof()
    except (ConnectionError, asyncio.IncompleteReadError, OSError):
        try:
            writer.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass


async def probe_ready(host: str, port: int, timeout: float = 2.0,
                      path: str = "/readyz") -> bool:
    """Minimal readiness probe: ``GET <path>`` (``/readyz`` by default;
    the event-server front probes ``/``) against one backend, True iff it
    answers 200. Hand-rolled over asyncio streams so the front needs no
    HTTP client stack; any connect/read failure is simply not-ready."""
    try:
        r, w = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout)
    except (OSError, asyncio.TimeoutError):
        return False
    try:
        w.write(b"GET " + path.encode("ascii") + b" HTTP/1.1\r\n"
                b"Host: front\r\nConnection: close\r\n\r\n")
        await w.drain()
        line = await asyncio.wait_for(r.readline(), timeout)
        return b" 200" in line
    except (ConnectionError, OSError, asyncio.TimeoutError,
            asyncio.IncompleteReadError):
        return False
    finally:
        try:
            w.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass


class FrontProxy:
    """Connection-level (L4) front listener: each accepted client
    connection is spliced to one worker, chosen round-robin among the
    backends that accept a connect. See the module docstring for the
    optional readiness/healthz hardening."""

    def __init__(self, worker_ports: list[int], host: str = "127.0.0.1",
                 healthz_provider: Optional[Callable[[], dict]] = None,
                 connect_retry_s: float = 0.0):
        self.worker_ports = worker_ports
        self.worker_host = host
        self.healthz_provider = healthz_provider
        # > 0: a pass where EVERY backend refuses the connect is
        # retried (50 ms pacing) within this time budget before the
        # client is dropped. A starved worker stops accept()ing and its
        # full accept queue refuses connects while the process is
        # perfectly alive — a sub-second stall must cost the client a
        # short wait, not an RST. 0 keeps the original one-pass drop
        # (the event-server front's exact behavior).
        self.connect_retry_s = float(connect_retry_s)
        # readiness marks (index-aligned with worker_ports); absent =
        # assumed ready, so fronts that never probe behave exactly as
        # before the hardening
        self._ready: dict[int, bool] = {}
        # draining marks: a backend the owner is INTENTIONALLY taking
        # out of rotation (elastic scale-down). Unlike not-ready — which
        # still admits the backend on the all-else-refused fallback
        # pass — a draining backend gets NO new connections at all: its
        # in-flight splices finish, and clients reconnect to survivors.
        # A freed slot keeps its index with ``worker_ports[idx] = None``
        # so slot identity stays stable across scale cycles.
        self._draining: dict[int, bool] = {}
        self._rr = 0
        self._server: Optional[asyncio.AbstractServer] = None
        # live connection tasks: stop() must be able to cut idle
        # keep-alive splices — on 3.10 Server.wait_closed() waits for
        # every active connection, so ONE parked splice would otherwise
        # wedge shutdown forever
        self._conns: set = set()

    def set_ready(self, idx: int, ready: bool) -> None:
        self._ready[idx] = bool(ready)

    def is_ready(self, idx: int) -> bool:
        return self._ready.get(idx, True)

    def set_draining(self, idx: int, draining: bool) -> None:
        self._draining[idx] = bool(draining)

    def is_draining(self, idx: int) -> bool:
        return self._draining.get(idx, False)

    def set_backend(self, idx: int, port: Optional[int]) -> None:
        """Assign (or free, with ``None``) the backend slot ``idx``,
        extending the slot list as needed — the elastic owner's hook.
        Freeing a slot clears its readiness/draining marks so a later
        occupant starts with the unprobed defaults."""
        while len(self.worker_ports) <= idx:
            self.worker_ports.append(None)
        self.worker_ports[idx] = port
        if port is None:
            self._ready.pop(idx, None)
            self._draining.pop(idx, None)

    def _routable(self, idx: int) -> bool:
        return (self.worker_ports[idx] is not None
                and not self._draining.get(idx, False))

    def active_count(self) -> int:
        """Slots holding a routable (assigned, not draining) backend."""
        return sum(1 for i in range(len(self.worker_ports))
                   if self._routable(i))

    def ready_count(self) -> int:
        return sum(1 for i in range(len(self.worker_ports))
                   if self._routable(i) and self._ready.get(i, True))

    async def _connect_backend(self):
        loop = asyncio.get_running_loop()
        deadline = (loop.time() + self.connect_retry_s
                    if self.connect_retry_s > 0 else None)
        while True:
            n = len(self.worker_ports)
            # two passes: ready backends first, then every ROUTABLE one
            # — a fleet with zero ready replicas still routes (a
            # not-ready-but-alive replica answering 503s beats a
            # refused connect). Draining and freed slots are excluded
            # from BOTH passes: drain means no new connections, period.
            for ready_only in (True, False):
                for i in range(n):
                    j = (self._rr + i) % n
                    if not self._routable(j):
                        continue
                    if ready_only and not self._ready.get(j, True):
                        continue
                    try:
                        r, w = await asyncio.open_connection(
                            self.worker_host, self.worker_ports[j])
                    except OSError:
                        continue
                    self._rr = (j + 1) % n
                    return r, w
                if all(self._ready.get(i, True) for i in range(n)
                       if self._routable(i)):
                    break  # second pass would retry the identical set
            if deadline is None or loop.time() >= deadline:
                return None
            await asyncio.sleep(0.05)

    async def _serve_healthz(self, cwriter) -> None:
        try:
            doc = self.healthz_provider()
        except Exception:  # noqa: BLE001 — health must not kill the front
            doc = {"status": "error"}
        body = json.dumps(doc).encode("utf-8")
        cwriter.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode()
            + b"\r\nConnection: close\r\n\r\n" + body)
        try:
            await cwriter.drain()
        except (ConnectionError, OSError):
            pass

    async def _handle(self, creader, cwriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conns.add(task)
            task.add_done_callback(self._conns.discard)
        first = b""
        if self.healthz_provider is not None:
            try:
                first = await creader.read(65536)
                # a request line split across TCP segments ("GET /hea" +
                # "lthz ...") must not be misrouted to a backend's own
                # /healthz: keep reading while the bytes so far are
                # still a proper prefix of the marker (bounded — at
                # most len(marker) bytes before the loop settles)
                while (0 < len(first) < len(_HEALTHZ_PREFIX)
                       and _HEALTHZ_PREFIX.startswith(first)):
                    more = await creader.read(65536)
                    if not more:
                        break
                    first += more
            except (ConnectionError, OSError):
                first = b""
            if not first:
                cwriter.close()
                return
            if first.startswith(_HEALTHZ_PREFIX):
                await self._serve_healthz(cwriter)
                cwriter.close()
                return
        backend = await self._connect_backend()
        if backend is None:
            log.warning("front: no backend accepted a connection "
                        "(ports %s, ready %s); dropping the client",
                        self.worker_ports, dict(self._ready))
            cwriter.close()
            return
        breader, bwriter = backend
        if first:
            try:
                bwriter.write(first)
                await bwriter.drain()
            except (ConnectionError, OSError):
                for w in (bwriter, cwriter):
                    try:
                        w.close()
                    except Exception:  # noqa: BLE001 — teardown
                        pass
                return
        try:
            await asyncio.gather(pipe(creader, bwriter),
                                 pipe(breader, cwriter))
        finally:
            # runs on cancellation too (stop() cutting stragglers):
            # transports must close or wait_closed() never completes
            for w in (bwriter, cwriter):
                try:
                    w.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass

    async def start(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(
            self._handle, host, port, reuse_address=True)

    async def stop(self, drain_s: float = 5.0) -> None:
        """Stop accepting, give in-flight splices ``drain_s`` to finish
        naturally (their backends are still up — requests already
        spliced get their response), then cut stragglers: an idle
        keep-alive splice never ends on its own, and on Python < 3.12
        ``Server.wait_closed()`` waits for every active connection, so
        without the cut a single parked client would wedge shutdown."""
        if self._server is None:
            return
        self._server.close()
        if self._conns:
            _done, pending = await asyncio.wait(set(self._conns),
                                                timeout=drain_s)
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None
