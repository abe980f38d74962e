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

Linear gangs: ``torch_gang_worker.py linear <out> <split>`` trains the
port's process-local Naive Bayes, L-BFGS LR (reg :data:`LINEAR_REG`) and
COO Naive Bayes on the seeded examples of :func:`linear_data`; rank r
holds the rows ``LINEAR_SPLITS[split][world][r]`` (the blocks differ
widely in size, and one may be empty) and the whole COO corpus (each rank
scatters its own documents). Every rank writes its models to
``<out>.<rank>.npz`` and prints its LR stats as one JSON line;
:func:`run_linear` starts such a gang without a supervisor.
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


#: the linear gang's examples: rows × attributes × classes, and the COO
#: corpus's documents × features × classes
LINEAR = (300, 5, 3)
LINEAR_COO = (120, 64, 4)
LINEAR_REG = 0.1
#: split → world → each rank's [lo, hi) rows of :func:`linear_data`
LINEAR_SPLITS = {
    "skewed": {2: [(0, 40), (40, 300)],
               3: [(0, 0), (0, 250), (250, 300)]},
    "empty": {2: [(0, 300), (300, 300)]},
}


def linear_data(seed: int = 21):
    """Seeded Poisson counts around class centres (x, y): Naive Bayes
    trains on them, LR on ``x * 0.1`` (so L-BFGS at :data:`LINEAR_REG`
    stops before 100 iterations); and a COO corpus (doc_ptr, feat,
    counts, y)."""
    n, d, c = LINEAR
    rng = np.random.default_rng(seed)
    centers = rng.random((c, d)) * 3 + 0.5
    y = rng.integers(0, c, n).astype(np.int32)
    x = rng.poisson(centers[y]).astype(np.float32)
    n_docs, n_feat, n_cls = LINEAR_COO
    lens = rng.integers(0, 12, n_docs)
    doc_ptr = np.r_[0, np.cumsum(lens)].astype(np.int64)
    feat = np.concatenate([np.sort(rng.choice(n_feat, k, replace=False))
                           for k in lens]).astype(np.int32)
    cnt = rng.integers(1, 6, len(feat)).astype(np.float32)
    y_doc = rng.integers(0, n_cls, n_docs).astype(np.int32)
    return x, y, (doc_ptr, feat, cnt, y_doc)


def run_linear(world: int, out: str, split: str,
               timeout_s: float = 90.0) -> list:
    """Start ``world`` ranks of the linear gang on the CPU (gloo) and wait
    for each within ``timeout_s`` (a hang fails); [(rc, stdout, stderr)]
    in rank order."""
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_"))}
    env.update(PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""),
               PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               PIO_NUM_PROCESSES=str(world),
               PIO_COORDINATOR_TIMEOUT_MS="30000")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "linear", out, split],
        env=dict(env, PIO_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
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


def linear_main(out_path: str, split: str) -> int:
    import json

    from incubator_predictionio_torch.ops import linear

    initialize_distributed()
    torch.set_num_threads(1)
    world, rank = process_count(), process_index()
    x, y, (doc_ptr, feat, cnt, y_doc) = linear_data()
    lo, hi = LINEAR_SPLITS[split][world][rank]
    c = LINEAR[2]
    nb_timings: dict = {}
    nb = linear.train_naive_bayes_process_local(
        x[lo:hi], y[lo:hi], c, device="cpu", timings=nb_timings)
    stats: dict = {}
    lr = linear.train_logistic_regression_process_local(
        x[lo:hi] * np.float32(0.1), y[lo:hi], c, reg=LINEAR_REG, max_iters=100,
        device="cpu", stats=stats)
    coo = linear.train_naive_bayes_coo_process_local(
        doc_ptr, feat, cnt, y_doc, LINEAR_COO[2], LINEAR_COO[1],
        device="cpu")
    np.savez(f"{out_path}.{rank}.npz", nb_log_prior=nb.log_prior,
             nb_log_likelihood=nb.log_likelihood, nb_feat=nb.feat_counts,
             nb_counts=nb.class_counts, lr_weights=lr.weights,
             lr_intercept=lr.intercept, coo_log_prior=coo.log_prior,
             coo_log_likelihood=coo.log_likelihood)
    print(json.dumps({"lr": stats, "nb": nb_timings}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1] == "linear":
        return linear_main(*sys.argv[2:4])
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
