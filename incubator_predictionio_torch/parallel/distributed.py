"""The process group of a training gang: ``torch.distributed`` over gloo.

Port of ``incubator_predictionio_tpu/parallel/distributed.py``. One
process without a coordinator is a gang of one (every call here is then a
no-op or answers 1). With ``PIO_COORDINATOR_ADDRESS`` (``host:port``, set
by the gang supervisor of ``parallel/supervisor.py``), rank
``PIO_PROCESS_ID`` of ``PIO_NUM_PROCESSES`` joins a gloo process group
whose TCP rendezvous rank 0 hosts at that address.

The backend is gloo and only gloo: the gang's ranks may share one card
(NCCL refuses two ranks on one device), and the collectives the gang needs
(``all_reduce``, ``broadcast``, ``all_gather`` of host tensors) are all
gloo's. A group that does not form raises; nothing falls back to another
backend or to one process.

Failure semantics (the supervisor depends on them): a rank that cannot
reach its rendezvous errors within the group's timeout instead of waiting
forever; a peer that dies closes its sockets and the survivors' next
collective fails at once; a peer that is alive but wedged stops beating,
and the supervisor's stall detector kills the gang (the group's timeout
bounds what is left).
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
from typing import Optional

from ..common import envknobs

log = logging.getLogger("pio.torch.distributed")

__all__ = ["initialize_distributed", "is_multi_host", "process_count",
           "process_index", "rank_device", "resolve_distributed_timeouts",
           "shutdown_distributed"]


def _group_ready() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Ranks of this process's gang (1 without a process group)."""
    if not _group_ready():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    if not _group_ready():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def is_multi_host() -> bool:
    return process_count() > 1


def resolve_distributed_timeouts() -> dict:
    """The reference's knobs, parsed as there (seconds; malformed or absent
    values fall back to the defaults):

    - ``PIO_COORDINATOR_TIMEOUT_MS`` — how long a rank waits for the
      rendezvous (default 300 s, floor 1 s);
    - ``PIO_DIST_HEARTBEAT_MS`` × ``PIO_DIST_MAX_MISSING_HEARTBEATS`` —
      how long a peer may be silent before it counts as dead (defaults
      10 s × 10).

    ``timeout`` (a ``timedelta``) is the larger of the two: gloo has one
    timeout, which bounds both the rendezvous and every collective."""
    init_s = envknobs.env_ms("PIO_COORDINATOR_TIMEOUT_MS", 300_000.0,
                             lo_ms=1000.0)
    hb_s = envknobs.env_ms("PIO_DIST_HEARTBEAT_MS", 10_000.0, lo_ms=1000.0)
    missing = envknobs.env_int("PIO_DIST_MAX_MISSING_HEARTBEATS", 10, lo=2)
    out = {
        "initialization_timeout": max(1, int(round(init_s))),
        "heartbeat_interval": max(1, int(round(hb_s))),
        "max_missing_heartbeats": missing,
    }
    out["timeout"] = datetime.timedelta(seconds=max(
        out["initialization_timeout"],
        out["heartbeat_interval"] * out["max_missing_heartbeats"]))
    return out


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the gang's gloo process group from the arguments or the
    ``PIO_*`` environment (``PIO_COORDINATOR_ADDRESS``,
    ``PIO_NUM_PROCESSES``, ``PIO_PROCESS_ID``). Without a coordinator
    address it does nothing and returns False; with one it returns True
    once the group has formed (at once when it already has)."""
    coordinator_address = (
        coordinator_address
        or envknobs.env_str("PIO_COORDINATOR_ADDRESS", "", lower=False))
    if not coordinator_address:
        log.debug("single-process mode (no PIO_COORDINATOR_ADDRESS)")
        return False
    # identity knobs parse STRICTLY (int() raises on garbage AND on a
    # set-but-empty value): a gang worker whose rank or world size is
    # garbled must crash at start-up; a tolerant fallback to rank 0 /
    # world 1 would collide with the real leader or hang its peers
    num_processes = num_processes or int(
        os.environ.get("PIO_NUM_PROCESSES", "1"))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("PIO_PROCESS_ID", "0")))
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"PIO_PROCESS_ID={process_id} outside a gang of "
                         f"PIO_NUM_PROCESSES={num_processes}")
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if not dist.is_gloo_available():
        raise RuntimeError("torch.distributed has no gloo backend here; a "
                           "training gang needs it")
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    t = resolve_distributed_timeouts()
    dist.init_process_group("gloo", init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=t["timeout"])
    # a process that exits with its group alive can abort in teardown
    # ("terminate called without an active exception"): the supervisor
    # would count a finished rank as failed
    atexit.register(shutdown_distributed)
    log.info("gloo process group formed: rank %d of %d (%s)", process_id,
             num_processes, init)
    return True


def shutdown_distributed() -> None:
    """Tear this process's side of the gang's group down (local: no
    collective). Registered at exit by :func:`initialize_distributed`."""
    if _group_ready():
        import torch.distributed as dist

        dist.destroy_process_group()


def rank_device(requested: str = "cuda") -> str:
    """The device this rank trains on: ``cpu`` when the caller asked for
    the CPU, else ``cuda:{rank % device_count}`` (several ranks share a
    card when there are more ranks than cards). Asking for CUDA on a host
    without a card raises, as :func:`..device.resolve_device` does."""
    if str(requested).startswith("cpu"):
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass --device cpu to train on the CPU")
    return f"cuda:{process_index() % torch.cuda.device_count()}"
