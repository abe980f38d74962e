"""Supervision of worker processes: the training gang and its
checkpointed restart, and per-worker supervision of services.

The port's own copy of ``incubator_predictionio_tpu/parallel/supervisor.py``.

- :class:`Supervisor` with ``restart_scope="gang"`` (the default, as in
  the reference) launches N copies of one training command (``pio train
  --num-workers N``) with the gang wiring in their environment
  (``PIO_COORDINATOR_ADDRESS`` with a fresh port per attempt,
  ``PIO_NUM_PROCESSES``, ``PIO_PROCESS_ID``, ``PIO_GANG_WORKER``,
  ``PIO_GANG_INSTANCE_ID``), watches process liveness AND per-worker
  heartbeat files, and on a failed exit, a death, or a heartbeat stall
  kills the WHOLE gang (every rank takes part in every collective, so one
  lost rank blocks the rest) and relaunches it with ``--resume``, from
  the latest checkpoint, within ``PIO_TRAIN_MAX_RESTARTS``, paced by a
  jittered exponential backoff. :meth:`Supervisor.request_stop` drains the
  gang instead: the workers checkpoint at their next sweep boundary and
  exit with :data:`DRAIN_EXIT_CODE`; the run stays ``--resume``-able.
- Workers call :func:`beat` between sweeps (``ops/als.py``,
  ``workflow/core_workflow.py``): a cheap mtime touch of their heartbeat
  file. A worker that is alive but wedged stops beating and the stall
  detector catches what ``poll()`` cannot.
- Drain is collective: :func:`drain_requested_global` all-reduces the
  local SIGTERM flag over the gang at each sweep boundary, so every rank
  takes the drain branch at the same iteration and the checkpoint barrier
  cannot deadlock against a peer that missed the signal by one sweep.
- ``restart_scope="worker"`` supervises services whose workers share
  nothing at run time (the engine replica fleet of ``workflow/fleet.py``,
  the partitioned event server): a dead or wedged worker is relaunched
  alone while its peers keep serving, with its own restart budget, and
  the service has dynamic membership (:meth:`Supervisor.add_worker`,
  :meth:`Supervisor.retire_worker`; :func:`die_with_parent` on the worker
  side).

The state (workers, pids, heartbeat ages, restarts and an event log with
timestamps) is mirrored to ``<run_dir>/supervisor.json``; a gang's run
directory is ``$PIO_FS_BASEDIR/gang/<instance id>``. Telemetry, in the
supervising process's registry: ``pio_train_restarts_total{reason}``,
``pio_train_worker_alive{worker}``,
``pio_train_worker_heartbeat_age_seconds{worker}`` and
``pio_train_gang_state`` (0 idle, 1 running, 2 draining, 3 failed).
"""

from __future__ import annotations

import json
import logging
import os
import random
import signal
import socket
import subprocess
import threading
import time
from typing import Optional, Sequence

from ..common import envknobs, telemetry

log = logging.getLogger("pio.torch.supervisor")


def _metrics():
    # created at first use: a process that never supervises registers none
    reg = telemetry.registry()
    return (
        reg.counter("pio_train_restarts_total",
                    "Gang restarts by failure reason", ("reason",)),
        reg.gauge("pio_train_worker_alive",
                  "1 while the worker process is running", ("worker",)),
        reg.gauge("pio_train_worker_heartbeat_age_seconds",
                  "Seconds since the worker last touched its heartbeat file",
                  ("worker",)),
        reg.gauge("pio_train_gang_state",
                  "0 idle, 1 running, 2 draining, 3 failed").labels(),
    )


#: pio_train_gang_state's code of each supervisor state (ended runs read 0)
_STATE_CODE = {"running": 1.0, "draining": 2.0, "failed": 3.0}

__all__ = [
    "GangConfig", "GangDrainRequested", "Supervisor", "beat", "beat_while",
    "die_with_parent", "drain_requested", "drain_requested_global",
    "gang_active", "install_worker_signal_handlers", "request_drain",
]

# env the supervisor sets on every worker
ENV_HEARTBEAT_FILE = "PIO_WORKER_HEARTBEAT_FILE"
ENV_GANG_WORKER = "PIO_GANG_WORKER"
ENV_GANG_INSTANCE_ID = "PIO_GANG_INSTANCE_ID"

# terminal states Supervisor.run() can land in
COMPLETED, DRAINED, FAILED = "completed", "drained", "failed"

#: exit code of a gang worker that checkpointed and exited at a drain
#: request (:class:`GangDrainRequested`). Not a failure: an operator may
#: SIGTERM a worker directly (the all-reduced flag then drains the whole
#: gang), and restarting a run the operator just stopped would spend the
#: restart budget on the wrong thing. A retiring service worker may exit
#: with it too.
DRAIN_EXIT_CODE = 3


# ---------------------------------------------------------------------------
# worker-side hooks (heartbeat, drain flag)
# ---------------------------------------------------------------------------

_hb_lock = threading.Lock()
_hb_last = 0.0
_hb_interval: Optional[float] = None
_drain_event = threading.Event()


def gang_active() -> bool:
    """True inside a supervised training worker."""
    return os.environ.get(ENV_GANG_WORKER) == "1"


def beat() -> None:
    """Touch this worker's heartbeat file (no-op outside supervision).

    Throttled to half the configured heartbeat interval. The file is
    created on the first call: the supervisor treats creation as "the
    worker is up" and only then arms the stall detector. A training
    worker beats after its first sweep, so the init grace covers the
    process group's rendezvous and the read."""
    path = os.environ.get(ENV_HEARTBEAT_FILE)
    if not path:
        return
    global _hb_last, _hb_interval
    now = time.monotonic()
    with _hb_lock:
        if _hb_interval is None:
            _hb_interval = max(
                0.01, envknobs.env_ms("PIO_WORKER_HEARTBEAT_MS", 1000.0,
                                      lo_ms=20.0) / 2.0)
        if now - _hb_last < _hb_interval:
            return
        _hb_last = now
    try:
        with open(path, "a"):
            pass
        os.utime(path, None)
    except OSError:  # heartbeat dir vanished: the supervisor is gone
        log.debug("heartbeat touch failed for %s", path, exc_info=True)


class beat_while:
    """Context manager: a background thread beats every ``interval``
    seconds while the body runs. For phases with no natural beat points,
    such as the gang leader's model persistence: a training job whose
    training succeeded must not be gang-killed while it saves the result.
    No-op outside supervision."""

    def __init__(self, interval: float = 5.0):
        self.interval = interval
        self._stop: Optional[threading.Event] = None
        self._t: Optional[threading.Thread] = None

    def __enter__(self):
        if not os.environ.get(ENV_HEARTBEAT_FILE):
            return self
        self._stop = threading.Event()

        def _pump(stop):
            while not stop.wait(self.interval):
                beat()

        self._t = threading.Thread(target=_pump, args=(self._stop,),
                                   daemon=True, name="gang-beat")
        self._t.start()
        return self

    def __exit__(self, *exc):
        if self._stop is not None:
            self._stop.set()
            self._t.join(timeout=5)
        return False


def request_drain(signum=None, frame=None) -> None:
    """SIGTERM handler body: ask the training loop to checkpoint and exit
    at the next sweep boundary."""
    _drain_event.set()


def drain_requested() -> bool:
    return _drain_event.is_set()


def drain_requested_global() -> bool:
    """The gang-consistent drain flag, read between sweeps.

    In a gang of more than one rank the local flag is all-reduced (MAX)
    over the process group, so every rank sees the same answer at the same
    sweep boundary; otherwise the rank that caught SIGTERM a sweep early
    would enter the checkpoint barrier while its peers enter the next
    half-step's all-reduce, and the gang would deadlock. One process reads
    its local flag; a process outside a gang never pays the collective."""
    if not gang_active():
        return _drain_event.is_set()
    from .distributed import process_count

    if process_count() <= 1:
        return _drain_event.is_set()
    import torch
    import torch.distributed as dist

    flag = torch.tensor([1 if _drain_event.is_set() else 0],
                        dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def install_worker_signal_handlers() -> None:
    """Route SIGTERM (and SIGINT, which a terminal forwards to the whole
    process group on Ctrl-C) to the drain flag instead of killing the
    worker mid-sweep. Main thread only."""
    signal.signal(signal.SIGTERM, request_drain)
    signal.signal(signal.SIGINT, request_drain)


class GangDrainRequested(Exception):
    """Raised by a training loop after it checkpointed at a drain request;
    the worker exits with :data:`DRAIN_EXIT_CODE` and the supervisor stops
    without restarting (the run resumes later with ``--resume``)."""

    def __init__(self, step: int):
        super().__init__(f"gang drain requested; checkpointed at step {step}")
        self.step = int(step)


def die_with_parent(front: str) -> None:
    """A service worker whose front dies WITHOUT draining (SIGKILL, OOM
    kill) must not serve forever on a port nothing routes to. Two layers:
    Linux ``PR_SET_PDEATHSIG`` has the kernel deliver SIGTERM (the normal
    drain path) the instant the supervising parent goes, and a 1 s-cadence
    watchdog thread catches kernels that fail to deliver it (observed on
    gVisor container kernels) by watching for reparenting to init.
    Pdeathsig fires on the death of the spawning THREAD, which here is the
    supervisor thread — alive exactly as long as supervision is. ``front``
    names the parent in the watchdog's log line."""
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGTERM, 0, 0, 0)  # PR_SET_PDEATHSIG
        # NO getppid()==1 "already orphaned" recheck here: container
        # kernels (gVisor) intermittently report ppid 1 for a freshly
        # spawned child whose parent is alive, and the misfire exits
        # the worker before its first-launch chaos/serving ever runs —
        # worse than the microsecond fork→prctl window it would close
    except (OSError, AttributeError):  # pragma: no cover - non-Linux
        pass

    # polling suspenders for the prctl belt: the same container kernels
    # intermittently fail to DELIVER pdeathsig at all, so a daemon thread
    # also watches for reparenting to init. Several consecutive
    # observations are required before acting — a single getppid()==1
    # reading can be the spurious-at-spawn transient — then SIGTERM
    # ourselves, which is the worker's normal drain path
    def _watch() -> None:
        strikes = 0
        while True:
            time.sleep(1.0)
            strikes = strikes + 1 if os.getppid() == 1 else 0
            if strikes >= 3:
                log.warning("%s is gone (reparented to init); draining "
                            "this worker", front)
                os.kill(os.getpid(), signal.SIGTERM)
                return

    threading.Thread(target=_watch, daemon=True,
                     name="orphan-watchdog").start()


# ---------------------------------------------------------------------------
# supervisor config
# ---------------------------------------------------------------------------

class GangConfig:
    """Resolved supervision knobs (all overridable via environment).

    - ``PIO_NUM_WORKERS`` — gang size or worker count (the caller's count
      wins)
    - ``PIO_WORKER_HEARTBEAT_MS`` — worker touch cadence (default 1s)
    - ``PIO_WORKER_STALL_MS`` — heartbeat age that declares a live
      process wedged (default 120s)
    - ``PIO_WORKER_INIT_GRACE_MS`` — budget from spawn to FIRST beat
      (default 600s: covers the process group's rendezvous, the read and
      the first sweep, which beat nothing)
    - ``PIO_TRAIN_MAX_RESTARTS`` — gang relaunch budget, or per-worker
      relaunch budget of a service (default 3)
    - ``PIO_TRAIN_DRAIN_MS`` — SIGTERM→SIGKILL grace during drain
      (default 30s)
    - ``PIO_SUPERVISOR_POLL_MS`` — monitor cadence (default 200ms)
    """

    __slots__ = ("num_workers", "heartbeat_ms", "stall_ms", "init_grace_ms",
                 "max_restarts", "drain_ms", "poll_ms")

    def __init__(self, num_workers: int = 1, heartbeat_ms: float = 1000.0,
                 stall_ms: float = 120_000.0, init_grace_ms: float = 600_000.0,
                 max_restarts: int = 3, drain_ms: float = 30_000.0,
                 poll_ms: float = 200.0):
        self.num_workers = max(1, int(num_workers))
        self.heartbeat_ms = max(20.0, float(heartbeat_ms))
        self.stall_ms = max(self.heartbeat_ms * 2, float(stall_ms))
        self.init_grace_ms = max(self.stall_ms, float(init_grace_ms))
        self.max_restarts = max(0, int(max_restarts))
        self.drain_ms = max(0.0, float(drain_ms))
        self.poll_ms = min(max(10.0, float(poll_ms)), self.heartbeat_ms)

    @classmethod
    def from_env(cls, num_workers: Optional[int] = None) -> "GangConfig":
        return cls(
            num_workers=(num_workers if num_workers is not None
                         else envknobs.env_int("PIO_NUM_WORKERS", 1, lo=1)),
            heartbeat_ms=envknobs.env_float(
                "PIO_WORKER_HEARTBEAT_MS", 1000.0, lo=20.0),
            stall_ms=envknobs.env_float(
                "PIO_WORKER_STALL_MS", 120_000.0, lo=100.0),
            init_grace_ms=envknobs.env_float(
                "PIO_WORKER_INIT_GRACE_MS", 600_000.0, lo=1000.0),
            max_restarts=envknobs.env_int(
                "PIO_TRAIN_MAX_RESTARTS", 3, lo=0),
            drain_ms=envknobs.env_float(
                "PIO_TRAIN_DRAIN_MS", 30_000.0, lo=0.0),
            poll_ms=envknobs.env_float(
                "PIO_SUPERVISOR_POLL_MS", 200.0, lo=10.0),
        )

    def to_json(self) -> dict:
        return {s: getattr(self, s) for s in self.__slots__}


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class _Worker:
    __slots__ = ("idx", "proc", "hb_path", "log_path", "spawned_at",
                 "hb_token", "hb_seen_at")

    def __init__(self, idx, proc, hb_path, log_path, spawned_at):
        self.idx = idx
        self.proc = proc
        self.hb_path = hb_path
        self.log_path = log_path
        self.spawned_at = spawned_at
        # mtime is only an opaque CHANGE token; ages are measured on the
        # monotonic clock from when the change was observed
        self.hb_token = None
        self.hb_seen_at = None

    def heartbeat_age_ms(self) -> Optional[float]:
        """Monotonic ms since the last observed beat, or None before the
        first one."""
        try:
            token = os.stat(self.hb_path).st_mtime_ns
        except OSError:
            return None
        now = time.monotonic()
        if token != self.hb_token:
            self.hb_token = token
            self.hb_seen_at = now
        return max(0.0, (now - self.hb_seen_at) * 1000.0)


class Supervisor:
    """Launch and babysit one training gang until it completes, drains or
    exhausts its restart budget; or N service workers until a drain is
    requested or one worker exhausts its restart budget.

    ``worker_argv`` is the full command line of ONE worker; the supervisor
    adds only environment (the gang wiring, the heartbeat file) and — on a
    gang's restart attempts — ``--resume``, so the relaunched gang
    continues from the latest checkpoint. ``per_worker_env`` (worker idx →
    env overrides) applies to the FIRST launch only, so a relaunched worker
    comes up without the injected chaos that killed it; pass a callable
    ``(attempt, worker_idx) -> dict`` to control every attempt explicitly.

    ``restart_scope="gang"`` (training): one failure kills and relaunches
    every worker. ``"worker"`` (services): a failed worker is relaunched
    alone, ``max_restarts`` is per worker, and ANY exit — rc 0 included —
    is a failure. A gang's rendezvous is ``127.0.0.1`` at a fresh port per
    attempt: the ranks share one host."""

    def __init__(self, worker_argv: Sequence[str],
                 num_workers: Optional[int] = None, *,
                 env: Optional[dict] = None,
                 per_worker_env=None,
                 config: Optional[GangConfig] = None,
                 run_dir: Optional[str] = None,
                 gang_instance_id: Optional[str] = None,
                 restart_scope: str = "gang"):
        if restart_scope not in ("gang", "worker"):
            raise ValueError(f"restart_scope {restart_scope!r}")
        self.worker_argv = list(worker_argv)
        self.config = config or GangConfig.from_env(num_workers)
        if num_workers is not None:
            self.config.num_workers = max(1, int(num_workers))
        self.restart_scope = restart_scope
        self.base_env = dict(os.environ if env is None else env)
        if callable(per_worker_env):
            self._env_for = per_worker_env
        else:
            first = {int(k): dict(v) for k, v in (per_worker_env or {}).items()}
            self._env_for = lambda attempt, idx: (
                first.get(idx, {}) if attempt == 0 else {})
        self.gang_instance_id = gang_instance_id
        self.run_dir = run_dir or self._default_run_dir(gang_instance_id)
        self.restarts = 0
        # per-worker relaunch counts (service scope), read by the fleet
        # front's /healthz; a gang's restarts stay in self.restarts
        self.worker_restarts = [0] * self.config.num_workers
        self.state = "idle"
        self.events: list[dict] = []
        self._workers: list[_Worker] = []
        self._stop = threading.Event()
        self._attempt = 0
        self._rng = random.Random()
        # dynamic membership: add/retire requests land here from any
        # thread and are applied by the supervision loop itself, so every
        # spawn happens on the SUPERVISOR thread (a replica's parent-death
        # signal binds to the spawning thread)
        self._membership_lock = threading.Lock()
        self._membership_cmds: list[tuple[str, int]] = []
        # service slots with no live process only because this thread is
        # about to start one: the launch-time slots before the first
        # spawn, a queued add, a failed worker in its relaunch backoff
        self._launching: set[int] = (
            set(range(self.config.num_workers))
            if restart_scope == "worker" else set())
        # idx -> monotonic SIGKILL deadline; a retiring worker is EXPECTED
        # to exit, so the failure sweep skips it
        self._retiring: dict[int, float] = {}
        os.makedirs(self.run_dir, exist_ok=True)

    # -- plumbing ----------------------------------------------------------

    @staticmethod
    def _default_run_dir(gang_id: Optional[str] = None) -> str:
        from ..data.storage.registry import base_dir

        return os.path.join(base_dir(), "gang",
                            gang_id or f"pid{os.getpid()}")

    @staticmethod
    def _free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def request_stop(self, signum=None, frame=None) -> None:
        """Drain every worker and stop (no restart)."""
        self._stop.set()

    def install_signal_handlers(self) -> None:
        """SIGTERM and SIGINT drain (main thread only: the CLI; tests call
        :meth:`request_stop`)."""
        signal.signal(signal.SIGTERM, self.request_stop)
        signal.signal(signal.SIGINT, self.request_stop)

    def _event(self, type_: str, **kw) -> None:
        self.events.append({"type": type_, "t": time.time(), **kw})

    def _worker_by_idx(self, idx: int) -> Optional[_Worker]:
        for w in self._workers:
            if w.idx == idx:
                return w
        return None

    def worker_pid(self, idx: int) -> Optional[int]:
        """The live pid of worker ``idx``, or None."""
        w = self._worker_by_idx(idx)
        if w is None or w.proc.poll() is not None:
            return None
        return w.proc.pid

    def live_worker_indices(self) -> list[int]:
        """Indices on the books and not mid-retirement."""
        return sorted(w.idx for w in self._workers
                      if w.idx not in self._retiring)

    def is_retiring(self, idx: int) -> bool:
        return idx in self._retiring

    def is_launching(self, idx: int) -> bool:
        """Whether service slot ``idx`` has no live process only because
        the supervisor is about to start one (before the first spawn, a
        queued add, a relaunch backoff): the slot is not missing, and an
        owner must not replace it."""
        return idx in self._launching

    # -- dynamic membership --------------------------------------------------

    def add_worker(self, idx: Optional[int] = None) -> int:
        """Enqueue a NEW worker at slot ``idx`` (lowest free slot when
        None); returns the slot. The spawn itself happens on the
        supervision thread at its next sweep, with the same heartbeat
        registration, restart budget and parent-death arming as a
        launch-time worker. Thread-safe; service scope only (a gang's size
        is its process group's world size)."""
        self._require_service()
        with self._membership_lock:
            taken = {w.idx for w in self._workers}
            taken.update(i for op, i in self._membership_cmds
                         if op == "add")
            if idx is None:
                idx = 0
                while idx in taken:
                    idx += 1
            elif idx in taken:
                raise ValueError(f"worker {idx} is already on the books")
            self._membership_cmds.append(("add", int(idx)))
            self._launching.add(int(idx))
        return int(idx)

    def retire_worker(self, idx: int) -> None:
        """Enqueue a graceful retirement of worker ``idx``: the supervision
        thread SIGTERMs it (the worker's normal drain), exempts it from
        failure detection, and books it out when it exits — SIGKILL only
        past the drain budget. Thread-safe; service scope only."""
        self._require_service()
        with self._membership_lock:
            self._membership_cmds.append(("retire", int(idx)))

    def _require_service(self) -> None:
        if self.restart_scope != "worker":
            raise RuntimeError("dynamic membership requires "
                               "restart_scope='worker'")

    def _apply_membership(self) -> None:
        """Drain queued add/retire commands (supervision thread)."""
        with self._membership_lock:
            cmds, self._membership_cmds = self._membership_cmds, []
        for op, idx in cmds:
            if op == "add":
                if self._worker_by_idx(idx) is not None:
                    continue  # raced a concurrent add of the same slot
                while len(self.worker_restarts) <= idx:
                    self.worker_restarts.append(0)
                self._workers.append(
                    self._spawn_worker(idx, None, resume=False, attempt=0))
                self._launching.discard(idx)
                self._event("workerAdded", worker=idx)
                log.info("service worker %d added (now %d on the books)",
                         idx, len(self._workers))
            else:
                w = self._worker_by_idx(idx)
                if w is None or idx in self._retiring:
                    continue
                self._retiring[idx] = (time.monotonic()
                                       + self.config.drain_ms / 1000.0)
                if w.proc.poll() is None:
                    try:
                        w.proc.send_signal(signal.SIGTERM)
                    except OSError:
                        pass
                self._event("workerRetireStart", worker=idx)
                log.info("service worker %d retiring (drain budget "
                         "%.1fs)", idx, self.config.drain_ms / 1000.0)

    def _reap_retiring(self) -> None:
        """Book out retiring workers that exited; SIGKILL past the drain
        deadline (supervision thread)."""
        if not self._retiring:
            return
        now = time.monotonic()
        for idx in list(self._retiring):
            w = self._worker_by_idx(idx)
            if w is None:
                del self._retiring[idx]
                continue
            rc = w.proc.poll()
            if rc is None and now >= self._retiring[idx]:
                try:
                    w.proc.kill()
                except OSError:
                    pass
                w.proc.wait()
                rc = w.proc.poll()
            if rc is not None:
                self._workers.remove(w)
                del self._retiring[idx]
                self._event("workerRetired", worker=idx, rc=rc)
                log.info("service worker %d retired (rc %s, %d still "
                         "on the books)", idx, rc, len(self._workers))

    # -- lifecycle -----------------------------------------------------------

    def _spawn_worker(self, i: int, port: Optional[int], resume: bool,
                      attempt: int) -> _Worker:
        cfg = self.config
        argv = list(self.worker_argv)
        if resume and "--resume" not in argv:
            argv.append("--resume")
        hb = os.path.join(self.run_dir, f"worker_{i}.hb")
        try:  # stall ages are measured against THIS attempt only
            os.unlink(hb)
        except OSError:
            pass
        env = {**self.base_env, ENV_HEARTBEAT_FILE: hb,
               "PIO_WORKER_HEARTBEAT_MS": str(cfg.heartbeat_ms)}
        if self.restart_scope == "gang":
            env.update({"PIO_NUM_PROCESSES": str(cfg.num_workers),
                        "PIO_PROCESS_ID": str(i), ENV_GANG_WORKER: "1"})
            env["PIO_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
            if self.gang_instance_id:
                env[ENV_GANG_INSTANCE_ID] = self.gang_instance_id
        env.update(self._env_for(attempt, i))
        log_path = os.path.join(self.run_dir, f"worker_{i}.log")
        logf = open(log_path, "ab")
        try:
            proc = subprocess.Popen(argv, env=env, stdout=logf,
                                    stderr=subprocess.STDOUT)
        finally:
            logf.close()  # the child holds its own fd now
        return _Worker(i, proc, hb, log_path, time.monotonic())

    def _spawn_gang(self, resume: bool) -> None:
        port = self._free_port()
        self._workers = [self._spawn_worker(i, port, resume, self._attempt)
                         for i in range(self.config.num_workers)]
        self._event("gangStart", attempt=self._attempt, resume=resume,
                    port=port, pids=[w.proc.pid for w in self._workers])
        log.info("gang attempt %d: %d worker(s) up (resume=%s, "
                 "rendezvous port %s)", self._attempt,
                 self.config.num_workers, resume, port)

    def _kill_gang(self, sig: int = signal.SIGKILL) -> None:
        for w in self._workers:
            if w.proc.poll() is None:
                try:
                    w.proc.send_signal(sig)
                except OSError:
                    pass
        for w in self._workers:
            try:
                w.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:  # pragma: no cover
                w.proc.kill()
                w.proc.wait()

    def _check_failure(self) -> Optional[dict]:
        """One gang monitor sweep → failure descriptor or None. A worker
        that exited 0 or :data:`DRAIN_EXIT_CODE` before its peers is
        normal; a survivor blocked in a dead collective is caught by the
        stall detector."""
        cfg = self.config
        now = time.monotonic()
        for w in self._workers:
            rc = w.proc.poll()
            if rc is not None:
                if rc not in (0, DRAIN_EXIT_CODE):
                    return {"reason": "exit", "worker": w.idx, "rc": rc}
                continue
            age = w.heartbeat_age_ms()
            if age is None:
                if (now - w.spawned_at) * 1000.0 > cfg.init_grace_ms:
                    return {"reason": "no_heartbeat", "worker": w.idx}
            elif age > cfg.stall_ms:
                return {"reason": "stall", "worker": w.idx,
                        "age_ms": round(age, 1)}
        return None

    def _publish(self) -> None:
        _, alive_g, age_g, state_g = _metrics()
        state_g.set(_STATE_CODE.get(self.state, 0.0))
        workers = []
        for w in self._workers:
            alive = w.proc.poll() is None
            age = w.heartbeat_age_ms()
            alive_g.labels(str(w.idx)).set(1.0 if alive else 0.0)
            age_g.labels(str(w.idx)).set(-1.0 if age is None else age / 1000.0)
            workers.append({
                "worker": w.idx,
                "pid": w.proc.pid,
                "alive": alive,
                "returncode": w.proc.poll(),
                "heartbeatAgeMs": age,
                "retiring": w.idx in self._retiring,
                "restarts": (self.worker_restarts[w.idx]
                             if w.idx < len(self.worker_restarts) else 0),
                "log": w.log_path,
            })
        doc = {
            "gangInstanceId": self.gang_instance_id,
            "restartScope": self.restart_scope,
            "state": self.state,
            "attempt": self._attempt,
            "restarts": self.restarts,
            "config": self.config.to_json(),
            "workers": workers,
            "events": self.events,
        }
        tmp = os.path.join(self.run_dir, ".supervisor.json.tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, os.path.join(self.run_dir, "supervisor.json"))
        except OSError:  # pragma: no cover - run_dir ripped out under us
            log.debug("could not publish supervisor status", exc_info=True)

    def _drain(self) -> None:
        """SIGTERM every worker, give them the drain budget to checkpoint
        (a gang) or finish their requests (a service) and exit, SIGKILL
        stragglers."""
        self.state = "draining"
        self._event("drainStart")
        self._publish()
        for w in self._workers:
            if w.proc.poll() is None:
                try:
                    w.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + self.config.drain_ms / 1000.0
        while time.monotonic() < deadline:
            if all(w.proc.poll() is not None for w in self._workers):
                break
            time.sleep(self.config.poll_ms / 1000.0)
        stragglers = [w.idx for w in self._workers if w.proc.poll() is None]
        self._kill_gang()
        self._event("drainDone", stragglers=stragglers,
                    rcs={w.idx: w.proc.poll() for w in self._workers})
        if stragglers:
            log.warning("drain deadline hit; SIGKILLed worker(s) %s — a "
                        "gang resumes from its last completed checkpoint",
                        stragglers)

    def _tail(self, w: _Worker, n: int = 2000) -> str:
        try:
            with open(w.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n))
                return f.read().decode(errors="replace")
        except OSError:
            return "<no log>"

    def _check_service_failure(self) -> Optional[dict]:
        """Per-worker failure sweep: ANY exit is a failure (a supervised
        service worker has no reason to stop), plus the no-first-beat and
        heartbeat-stall detection."""
        cfg = self.config
        now = time.monotonic()
        for w in self._workers:
            if w.idx in self._retiring:
                continue  # an exit is the POINT of retirement
            rc = w.proc.poll()
            if rc is not None:
                return {"reason": "exit", "worker": w.idx, "rc": rc}
            age = w.heartbeat_age_ms()
            if age is None:
                if (now - w.spawned_at) * 1000.0 > cfg.init_grace_ms:
                    return {"reason": "no_heartbeat", "worker": w.idx}
            elif age > cfg.stall_ms:
                return {"reason": "stall", "worker": w.idx,
                        "age_ms": round(age, 1)}
        return None

    def _backoff(self, n: int) -> float:
        """Full-jittered exponential delay before relaunch number ``n``
        (0-based): U(0, min(15 s, 0.5 s · 2^n)), the reference's
        ``RetryPolicy(base_delay=0.5, max_delay=15.0).backoff``."""
        return self._rng.uniform(0.0, min(15.0, 0.5 * (2 ** min(n, 62))))

    def _run_service(self) -> str:
        """A failed worker is killed and relaunched alone while its peers
        keep serving. Terminal states: ``drained`` (stop requested) or
        ``failed`` (one worker exhausted its restart budget)."""
        cfg = self.config
        per_worker_restarts = self.worker_restarts
        self.state = "running"
        self._workers = [self._spawn_worker(i, None, resume=False, attempt=0)
                         for i in range(cfg.num_workers)]
        self._launching.difference_update(range(cfg.num_workers))
        self._event("gangStart", pids=[w.proc.pid for w in self._workers])
        log.info("%d service worker(s) up", cfg.num_workers)
        self._publish()
        last_publish = 0.0
        while True:
            if self._stop.is_set():
                self._drain()
                self.state = DRAINED
                self._publish()
                log.info("service drained cleanly (%d worker(s))",
                         len(self._workers))
                return DRAINED
            self._apply_membership()
            self._reap_retiring()
            failure = self._check_service_failure()
            if failure is not None:
                idx = failure["worker"]
                bad = self._worker_by_idx(idx)
                log.warning("service worker %d failed (%s); relaunching "
                            "it. log tail:\n%s", idx, failure,
                            self._tail(bad))
                self._event("workerFailure", **failure)
                self._launching.add(idx)
                if bad.proc.poll() is None:
                    try:
                        bad.proc.send_signal(signal.SIGKILL)
                    except OSError:
                        pass
                    bad.proc.wait()
                _metrics()[0].labels(failure["reason"]).inc()
                while len(per_worker_restarts) <= idx:
                    per_worker_restarts.append(0)
                per_worker_restarts[idx] += 1
                self.restarts += 1
                if per_worker_restarts[idx] > cfg.max_restarts:
                    self.state = FAILED
                    self._event("gaveUp", worker=idx,
                                restarts=per_worker_restarts[idx])
                    self._publish()
                    self._kill_gang()
                    log.error("worker %d exhausted its restart budget "
                              "(%d); stopping the service", idx,
                              cfg.max_restarts)
                    return FAILED
                delay = self._backoff(per_worker_restarts[idx] - 1)
                self._event("workerRestart", worker=idx,
                            n=per_worker_restarts[idx],
                            backoff_s=round(delay, 3))
                # a drain must not wait behind a restart backoff, and a
                # stop that lands DURING it must not spawn a fresh worker
                if self._stop.wait(delay):
                    continue
                self._workers[self._workers.index(bad)] = \
                    self._spawn_worker(idx, None, resume=False,
                                       attempt=per_worker_restarts[idx])
                self._launching.discard(idx)
                self._publish()
            now = time.monotonic()
            if now - last_publish >= 1.0:
                self._publish()
                last_publish = now
            time.sleep(cfg.poll_ms / 1000.0)

    def run(self) -> str:
        """Supervise to a terminal state: ``completed`` (every gang worker
        exited 0), ``drained`` (stop requested, or the workers drained on
        their own SIGTERM; checkpoints kept) or ``failed`` (restart budget
        exhausted)."""
        if self.restart_scope == "worker":
            return self._run_service()
        cfg = self.config
        resume = False
        while True:
            if self._stop.is_set():  # the stop landed during a backoff
                self.state = DRAINED
                self._publish()
                return DRAINED
            self._attempt = self.restarts
            self.state = "running"
            self._spawn_gang(resume=resume)
            self._publish()
            last_publish = 0.0
            while True:
                if self._stop.is_set():
                    self._drain()
                    self.state = DRAINED
                    self._publish()
                    log.info("gang drained cleanly; resume with `pio train "
                             "--resume` (checkpoints kept)")
                    return DRAINED
                rcs = [w.proc.poll() for w in self._workers]
                if all(rc in (0, DRAIN_EXIT_CODE) for rc in rcs):
                    if DRAIN_EXIT_CODE in rcs:
                        # drained without our stop flag: someone SIGTERMed
                        # the workers directly — do not relaunch a run the
                        # operator just stopped
                        self.state = DRAINED
                        self._event("drainedByWorkers", rcs=rcs)
                        self._publish()
                        return DRAINED
                    self.state = COMPLETED
                    self._event("completed")
                    self._publish()
                    return COMPLETED
                failure = self._check_failure()
                if failure is not None:
                    break
                now = time.monotonic()
                if now - last_publish >= 1.0:
                    self._publish()
                    last_publish = now
                time.sleep(cfg.poll_ms / 1000.0)

            self._event("failure", **failure)
            bad = self._workers[failure["worker"]]
            log.warning("worker %d failed (%s); killing the gang. log "
                        "tail:\n%s", failure["worker"], failure,
                        self._tail(bad))
            self._kill_gang()
            self._event("gangKilled")
            _metrics()[0].labels(failure["reason"]).inc()
            if self.restarts >= cfg.max_restarts:
                self.state = FAILED
                self._event("gaveUp", restarts=self.restarts)
                self._publish()
                log.error("restart budget exhausted (%d); giving up — the "
                          "last checkpoint remains resumable", self.restarts)
                return FAILED
            self.restarts += 1
            resume = True
            delay = self._backoff(self.restarts - 1)
            self._event("restart", n=self.restarts,
                        backoff_s=round(delay, 3))
            log.info("gang restart %d/%d in %.2fs (resume from the latest "
                     "checkpoint)", self.restarts, cfg.max_restarts, delay)
            self._stop.wait(delay)
