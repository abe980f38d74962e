"""Mid-training checkpoint / resume.

Port of ``CheckpointIncompatibleError`` and ``CheckpointHook`` of
``incubator_predictionio_tpu/workflow/checkpoint.py`` with numpy in place
of orbax: every snapshot is one ``<step>.npz`` file in the hook's
directory, written to a temporary file, flushed to disk and renamed over
its final name, so a reader sees a whole snapshot or none. A snapshot is a
flat dict of arrays (torch tensors are copied to the host first); loading
never unpickles.

In a training gang (``parallel/distributed.py``) the factors are
replicated, so rank 0 alone writes each snapshot and every rank meets at a
barrier after it; :meth:`CheckpointHook.latest_step` is rank 0's answer,
broadcast, so every rank restores the same step (and a fingerprint
mismatch raises on every rank alike).

Where the snapshots live is the caller's choice: ``Engine.train`` gives
each algorithm the subdirectory ``algo_<idx>_<name>`` of the root hook's
directory; a train from the event store (``run_train``) keys a run by its
engine-instance id under :func:`checkpoint_root`
(``$PIO_FS_BASEDIR/checkpoints/<instance-id>/``, the reference's layout),
and the file-based console by its ``--model-out`` path.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import tempfile
from typing import Any, Mapping, Optional

import numpy as np

log = logging.getLogger("pio.torch.checkpoint")

_STEP_FILE = re.compile(r"^(\d+)\.npz$")


class CheckpointIncompatibleError(ValueError):
    """A restored snapshot cannot continue the current run (shape, rank or
    data-fingerprint mismatch). The console's ``--resume`` catches it,
    discards the stale snapshots and trains from scratch."""


def _gang() -> tuple[int, int]:
    """(world size, rank) of this process's training gang."""
    from ..parallel.distributed import process_count, process_index

    return process_count(), process_index()


def _host(value) -> np.ndarray:
    if hasattr(value, "detach"):  # a torch tensor, on any device
        return value.detach().cpu().numpy()
    return np.asarray(value)


class CheckpointHook:
    """Snapshot hook handed to algorithms through the workflow context.

    ``every_n == 0`` disables saving (every ``maybe_save`` is a no-op) but
    restore still works, so a resumed run can read snapshots even when
    further checkpointing is off. ``max_to_keep`` newest steps are kept.
    """

    def __init__(self, directory: str, every_n: int = 0, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.every_n = int(every_n)
        self.max_to_keep = max_to_keep

    @property
    def enabled(self) -> bool:
        return self.every_n > 0

    def should_save(self, step: int) -> bool:
        return self.enabled and step > 0 and step % self.every_n == 0

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.npz")

    def _steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := _STEP_FILE.match(name)))

    def save(self, step: int, tree: Mapping[str, Any]) -> None:
        """Write ``tree`` (a flat dict of arrays or tensors) as ``step``.
        In a gang: rank 0 writes, then every rank waits at a barrier, so no
        rank runs ahead of a snapshot that is not on disk yet."""
        world, rank = _gang()
        if rank == 0:
            self._write(step, tree)
        if world > 1:
            import torch.distributed as dist

            dist.barrier()

    def _write(self, step: int, tree: Mapping[str, Any]) -> None:
        arrays = {str(k): _host(v) for k, v in tree.items()}
        os.makedirs(self.directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **arrays)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self._path(step))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        for old in self._steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))
        log.info("checkpoint saved: step %d → %s", step, self.directory)

    def maybe_save(self, step: int, tree: Mapping[str, Any]) -> bool:
        if not self.should_save(step):
            return False
        self.save(step, tree)
        return True

    def latest_step(self) -> Optional[int]:
        """The newest snapshot's step, or None. In a gang rank 0 reads the
        directory and broadcasts its answer (collective)."""
        world, rank = _gang()
        steps = self._steps() if rank == 0 else []
        latest = steps[-1] if steps else None
        if world > 1:
            import torch
            import torch.distributed as dist

            t = torch.tensor([-1 if latest is None else latest],
                             dtype=torch.int64)
            dist.broadcast(t, src=0)
            latest = None if int(t.item()) < 0 else int(t.item())
        return latest

    def restore(self, step: Optional[int] = None) -> tuple[int, dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = self._path(step)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint for step {step} under "
                                    f"{self.directory}")
        with np.load(path, allow_pickle=False) as z:
            tree = {name: z[name] for name in z.files}
        log.info("checkpoint restored: step %d ← %s", step, self.directory)
        return int(step), tree

    def close(self) -> None:
        """Nothing stays open between saves; kept for the reference's API."""

    def delete_all(self) -> None:
        """Drop every snapshot (after the trained model is persisted)."""
        self.close()
        shutil.rmtree(self.directory, ignore_errors=True)


def checkpoint_root() -> str:
    from ..data.storage.registry import base_dir

    return os.path.join(base_dir(), "checkpoints")


def instance_checkpoint_dir(instance_id: str) -> str:
    return os.path.join(checkpoint_root(), instance_id)


def _train_still_alive(env: dict) -> bool:
    """True when a RUNNING instance may still have a live trainer process —
    resuming it would have two processes fighting over one checkpoint dir.
    On this host the recorded pid is probed directly (a SIGKILL'd train
    shows up as RUNNING with a dead pid — exactly the case --resume is
    for). A RUNNING row from another host cannot be probed, so it fails
    closed. ABORTED rows are always resumable, from any host."""
    import socket

    if env.get("host") != socket.gethostname():
        return True  # unprobeable foreign trainer: assume alive
    try:
        pid = int(env.get("pid", ""))
    except ValueError:
        return False
    try:
        os.kill(pid, 0)
    except PermissionError:
        return True  # pid exists but belongs to another user: alive
    except OSError:
        return False
    return pid != os.getpid()


def find_resumable_instance(storage, engine_id: str, engine_version: str = "1",
                            engine_variant: str = "default",
                            data_source_params: Optional[str] = None,
                            preparator_params: Optional[str] = None):
    """Most recent non-COMPLETED EngineInstance that left checkpoints behind
    (the ``pio train --resume`` discovery path). When the params JSON
    strings are given, only instances reading the same data source match —
    several apps can share one engine template without ever seeing (or
    deleting) each other's interrupted runs."""
    instances = storage.get_meta_data_engine_instances()
    candidates = [
        i for i in instances.get_all()
        if i.engine_id == engine_id
        and i.engine_version == engine_version
        and i.engine_variant == engine_variant
        and (data_source_params is None or i.data_source_params == data_source_params)
        and (preparator_params is None or i.preparator_params == preparator_params)
        and i.status in ("RUNNING", "ABORTED")
        and os.path.isdir(instance_checkpoint_dir(i.id))
        and not (i.status == "RUNNING" and _train_still_alive(i.env or {}))
    ]
    if not candidates:
        return None
    return max(candidates, key=lambda i: i.start_time)
