"""One rank of a training gang for tests/test_torch_gang_*.py: the port's
data-parallel ALS (``train_als_partition_local``) on the CPU, over the gloo
process group the gang supervisor wires (``PIO_COORDINATOR_ADDRESS``,
``PIO_NUM_PROCESSES``, ``PIO_PROCESS_ID``).

Usage: torch_gang_worker.py <out.npz> <ckpt_dir|-> <n_iters> <modes>
       [--resume]

``modes``: a comma-separated list of ``explicit`` (λ·n_ratings),
``implicit`` and ``binary`` (all-ones ratings), trained one after the
other by the same gang (the snapshots are the first mode's). Rank r holds
the events j with j % world == r of the seeded triple (:func:`data`),
already in global indices, so the gang's union is the whole triple. Rank
0 writes each mode's factors to <out.npz> as ``<mode>_user`` and
``<mode>_item``. Chaos arrives per
worker through ``PIO_FAULT_SPEC`` (``train.sweep:crash:N``,
``train.sweep:latency:N:S``); a drain exits with the drain exit code.

Imported by the tests, it also gives :func:`supervise`, which runs a
gang of this script under the port's supervisor within a time limit.
"""

import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from incubator_predictionio_torch.ops.als import (  # noqa: E402
    ALSParams, train_als_partition_local,
)
from incubator_predictionio_torch.parallel import supervisor  # noqa: E402
from incubator_predictionio_torch.parallel.distributed import (  # noqa: E402
    initialize_distributed, process_count, process_index,
)
from incubator_predictionio_torch.workflow.checkpoint import (  # noqa: E402
    CheckpointHook,
)

N_USERS, N_ITEMS, NNZ = 40, 30, 600


def data(mode: str, seed: int = 11):
    """The seeded union triple (global indices)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_USERS, NNZ).astype(np.int32)
    i = rng.integers(0, N_ITEMS, NNZ).astype(np.int32)
    r = (rng.integers(1, 11, NNZ) / 2.0).astype(np.float32)
    if mode == "binary":
        r = np.ones(NNZ, np.float32)
    return u, i, r


def params(mode: str, n_iters: int, rank: int = 4) -> ALSParams:
    if mode == "implicit":
        return ALSParams(rank=rank, num_iterations=n_iters, reg=0.05,
                         implicit_prefs=True, alpha=0.5, seed=5)
    return ALSParams(rank=rank, num_iterations=n_iters, reg=0.05,
                     lambda_scaling="nratings", seed=5)


def supervise(tmp_path, out: str, ckpt: str, n_iters: int, modes: str,
              extra=(), per_worker_env=None, timeout_s: float = 50.0,
              on_start=None, **config):
    """Run a 2-rank gang of this script under the port's supervisor in a
    thread (CPU, gloo); returns (supervisor, outcome). ``on_start(sup)``
    runs on the caller's thread while the gang works (a stop, a kill).
    Fails when the gang has not ended within ``timeout_s``."""
    from incubator_predictionio_torch.parallel.supervisor import (
        GangConfig, Supervisor,
    )

    cfg = dict(num_workers=2, heartbeat_ms=100.0, stall_ms=20_000.0,
               init_grace_ms=40_000.0, max_restarts=2, poll_ms=25.0,
               drain_ms=20_000.0)
    cfg.update(config)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PIO_FAULT_SPEC", "PIO_COORDINATOR_ADDRESS")}
    sup = Supervisor([sys.executable, os.path.abspath(__file__), out, ckpt,
                      str(n_iters), modes, *extra], 2, env=env,
                     per_worker_env=per_worker_env,
                     config=GangConfig(**cfg),
                     run_dir=str(tmp_path / f"run-{len(os.listdir(tmp_path))}"))
    box = {}

    def go():
        try:
            box["outcome"] = sup.run()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            box["error"] = e

    t = threading.Thread(target=go, daemon=True)
    t.start()
    if on_start is not None:
        on_start(sup)
    t.join(timeout_s)
    if t.is_alive():
        sup.request_stop()
        t.join(30)
        raise AssertionError(f"gang still running after {timeout_s}s: "
                             f"{sup.events}")
    if "error" in box:
        raise box["error"]
    return sup, box["outcome"]


def main() -> int:
    out_path, ckpt_dir, n_iters, modes = sys.argv[1:5]
    resume = "--resume" in sys.argv[5:]
    initialize_distributed()
    supervisor.install_worker_signal_handlers()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)  # tiny data; the test run shares the cores
    world, rank = process_count(), process_index()
    factors = {}
    for j, mode in enumerate(modes.split(",")):
        u, i, r = data(mode)
        sel = np.arange(NNZ) % world == rank
        hook = (CheckpointHook(ckpt_dir, every_n=2)
                if ckpt_dir != "-" and j == 0 else None)
        try:
            f = train_als_partition_local(
                u[sel], i[sel], r[sel], N_USERS, N_ITEMS,
                params(mode, int(n_iters)), device="cpu",
                checkpoint_hook=hook, resume=resume, force_dp=True)
        except supervisor.GangDrainRequested:
            return supervisor.DRAIN_EXIT_CODE
        factors.update({f"{mode}_user": f.user_factors,
                        f"{mode}_item": f.item_factors})
    if rank == 0:
        np.savez(out_path, **factors)
    return 0


if __name__ == "__main__":
    sys.exit(main())
