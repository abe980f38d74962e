"""One rank of a slab-ALS gang for tests/test_torch_slab_gang*.py: the
port's multi-process slab trainer on the CPU over a gloo process group
(``PIO_COORDINATOR_ADDRESS``, ``PIO_NUM_PROCESSES``, ``PIO_PROCESS_ID``;
``PIO_MESH_SHAPE`` for the 2-D layout).

Usage: torch_slab_worker.py <out.npz> <runs> [--ckpt DIR] [--resume]

``runs``: a comma-separated list of ``<feed>:<mode>`` trained one after
the other by the same gang. ``feed`` is ``merged`` (every rank passes
the whole triple to ``train_als``), ``sharded`` (each rank passes only
its ``process_row_ranges`` rows to ``train_als_process_sharded``) or
``dp`` (rank r passes the events j with j % world == r to the
data-parallel ``train_als_partition_local``);
``mode`` is one of :data:`MODES`. Rank 0 writes each run's factors to
<out.npz> as ``<feed>:<mode>:user`` / ``:item``, and every rank prints
its train reports as one JSON line. With ``PIO_TEST_FAULT`` set to
``outside`` rank 1 is fed a row outside its range; ``n_items`` makes
rank 1 pass one more item than its peers.

Imported by the tests, it gives the seeded data, the parameters and
:func:`run_gang`, which starts the ranks and waits for them within a
time limit.
"""

import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

N_USERS, N_ITEMS, NNZ = 40, 30, 600
#: the heavy set: user 0 rates HEAVY_ROW items (> the overflow length)
HEAVY = (40, 2_600, 8_000)
HEAVY_ROW = 2_300

#: mode → (data kind, ALSParams fields)
MODES = {
    "explicit": ("plain", dict(rank=4, reg=0.05, lambda_scaling="nratings")),
    "implicit": ("plain", dict(rank=4, reg=0.05, implicit_prefs=True,
                               alpha=0.5)),
    "binary": ("ones", dict(rank=4, reg=0.05, lambda_scaling="nratings")),
    # λ 0.1·n: at 0.05·n the single-process port's plain solve is already
    # 1.14× the 1-D tolerance from XLA's at rank 64 (two float32 solvers)
    "rank64": ("plain", dict(rank=64, reg=0.1, lambda_scaling="nratings")),
    "tiles0": ("plain", dict(rank=8, reg=0.05, block_len=8, chunk_tiles=0,
                             implicit_prefs=True, alpha=2.0)),
    "tiles2": ("plain", dict(rank=8, reg=0.05, block_len=8, chunk_tiles=2)),
    "heavy": ("heavy", dict(rank=4, reg=0.1, lambda_scaling="nratings")),
    # compute_dtype "bfloat16"
    "bf16": ("plain", dict(rank=8, reg=0.05, lambda_scaling="nratings",
                           compute_dtype="bfloat16")),
    "bf16_implicit": ("plain", dict(rank=8, reg=0.05, implicit_prefs=True,
                                    alpha=0.5, compute_dtype="bfloat16")),
    "bf16_heavy": ("heavy", dict(rank=4, reg=0.1, lambda_scaling="nratings",
                                 compute_dtype="bfloat16")),
}
ITERS = 3


def data(mode: str, seed: int = 11):
    """The seeded union triple of ``mode``: (u, i, r, n_users, n_items)."""
    kind = MODES[mode][0]
    rng = np.random.default_rng(seed)
    if kind == "heavy":
        nu, ni, nnz = HEAVY
        u = np.concatenate([np.zeros(HEAVY_ROW, np.int64),
                            rng.integers(0, nu, nnz)]).astype(np.int32)
        i = np.concatenate([rng.permutation(ni)[:HEAVY_ROW],
                            rng.integers(0, ni, nnz)]).astype(np.int32)
        r = (rng.integers(1, 11, len(u)) / 2.0).astype(np.float32)
        return u, i, r, nu, ni
    u = rng.integers(0, N_USERS, NNZ).astype(np.int32)
    i = rng.integers(0, N_ITEMS, NNZ).astype(np.int32)
    r = (rng.integers(1, 11, NNZ) / 2.0).astype(np.float32)
    if kind == "ones":
        r = np.ones(NNZ, np.float32)
    return u, i, r, N_USERS, N_ITEMS


def params(mode: str, n_iters: int = ITERS) -> dict:
    return dict(MODES[mode][1], num_iterations=n_iters, seed=5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(world: int, out: str, runs: str, mesh: str = "", extra=(),
             env=None, timeout_s: float = 60.0) -> list:
    """Start ``world`` ranks of this script on the CPU and wait for every
    one (``communicate`` within ``timeout_s``: a hang fails, it does not
    wait forever); returns [(rc, stdout, stderr)] in rank order."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("PIO_", "JAX_"))}
    base.update(env or {})
    base["PYTHONPATH"] = root + os.pathsep + base.get("PYTHONPATH", "")
    base.update(PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
                PIO_NUM_PROCESSES=str(world), PIO_COORDINATOR_TIMEOUT_MS="30000")
    if mesh:
        base["PIO_MESH_SHAPE"] = mesh
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), out, runs, *extra],
        env=dict(base, PIO_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    got = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout_s)
            got.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return got


def main() -> int:
    import torch

    from incubator_predictionio_torch.ops import als
    from incubator_predictionio_torch.parallel import supervisor
    from incubator_predictionio_torch.parallel.distributed import (
        initialize_distributed, process_count, process_index,
    )
    from incubator_predictionio_torch.workflow.checkpoint import (
        CheckpointHook,
    )

    out_path, runs = sys.argv[1:3]
    args = sys.argv[3:]
    ckpt = args[args.index("--ckpt") + 1] if "--ckpt" in args else None
    resume = "--resume" in args
    initialize_distributed()
    torch.set_num_threads(1)  # tiny data; the test run shares the cores
    rank = process_index()
    fault = os.environ.get("PIO_TEST_FAULT", "")
    factors, reports = {}, []
    for j, run in enumerate(runs.split(",")):
        feed, mode = run.split(":")
        u, i, r, nu, ni = data(mode)
        p = als.ALSParams(**params(mode))
        if fault == "n_items" and rank == 1:
            ni += 1
        hook = CheckpointHook(ckpt, every_n=2) if ckpt and j == 0 else None
        timings: dict = {}
        try:
            if feed == "merged":
                f = als.train_als(u, i, r, nu, ni, p, device="cpu",
                                  checkpoint_hook=hook, resume=resume,
                                  timings=timings)
            elif feed == "dp":
                mine = np.arange(len(u)) % process_count() == rank
                f = als.train_als_partition_local(
                    u[mine], i[mine], r[mine], nu, ni, p, device="cpu",
                    checkpoint_hook=hook, resume=resume, timings=timings,
                    force_dp=True)
            else:
                lo_u, hi_u = als.process_row_ranges(nu)
                lo_i, hi_i = als.process_row_ranges(ni)
                su = (u >= lo_u) & (u < hi_u)
                si = (i >= lo_i) & (i < hi_i)
                if fault == "outside" and rank == 1:
                    su[np.flatnonzero(u < lo_u)[:1]] = True
                f = als.train_als_process_sharded(
                    (u[su], i[su], r[su]), (u[si], i[si], r[si]), nu, ni, p,
                    device="cpu", checkpoint_hook=hook, resume=resume,
                    timings=timings)
        except supervisor.GangDrainRequested:
            return supervisor.DRAIN_EXIT_CODE
        factors.update({f"{run}:user": f.user_factors,
                        f"{run}:item": f.item_factors})
        reports.append(dict(timings, run=run))
    if rank == 0:
        np.savez(out_path, **factors)
    print(json.dumps(reports), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
