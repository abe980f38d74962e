"""One rank of a CCO gang for tests/test_torch_cco_gang.py: the port's
CCO indicators (``ops/llr.py``) on the CPU over a gloo process group
(``PIO_COORDINATOR_ADDRESS``, ``PIO_NUM_PROCESSES``, ``PIO_PROCESS_ID``),
every rank given the same events, the counts summed over the gang.

Usage: torch_cco_worker.py <out-prefix> <cases>

``cases``: a comma-separated list of :data:`CASES`, run one after the other
by the same gang. Each rank writes its results to ``<out-prefix>.<rank>.npz``
(``<case>:<pair>:idx`` / ``:score``, and ``counts:<pair>`` for the counts
case) and prints one JSON line: each case's ``timings``.

Imported by the tests, it gives the seeded data, the calls and
:func:`run_gang`, which starts the ranks and waits for them within a time
limit.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from torch_slab_worker import _free_port  # noqa: E402

#: a small range height: the users span two ranges, so a gang of 2 splits
#: them and in a gang of 3 one rank's light block is padding only (and two
#: ranks' heavy blocks: the heavy users fill one heavy range)
U_CHUNK = 128
N_USERS, N_ITEMS = 250, 300
BOTS = (7, 150, 249)
K = 8
#: the accumulator cap that forces the striped path (and, for two pairs,
#: the per-pair path): below N_ITEMS²
STRIPED_CAP = "4000"


def events(seed: int = 5):
    """(pu, pi, su, si): skewed buy/view pairs, and three users that buy
    and view 900 items each, far past the heavy cap (tests/
    test_linear_ops.py's bots)."""
    rng = np.random.default_rng(seed)

    def pairs(n, power):
        u = rng.integers(0, N_USERS, n)
        i = np.minimum((N_ITEMS * rng.random(n) ** power).astype(np.int64),
                       N_ITEMS - 1)
        u = np.concatenate([u, np.repeat(BOTS, 900)])
        i = np.concatenate([i, rng.integers(0, N_ITEMS, 900 * len(BOTS))])
        return u.astype(np.int32), i.astype(np.int32)

    return pairs(2_000, 2.0) + pairs(3_000, 1.5)


#: case → (call, PIO_UR_FULL_MATRIX_ELEMS or ""): ``pair`` is one
#: cco_indicators call, ``multi`` a cco_indicators_multi of the self-pair
#: and the view pair, ``counts`` the fused counts themselves
CASES = {
    "full": ("pair", ""),
    "striped": ("pair", STRIPED_CAP),
    "fused": ("multi", ""),
    "per_pair": ("multi", STRIPED_CAP),
    "counts": ("counts", ""),
}


def run_case(case: str, device="cpu", collectives=None,
             timings=None) -> dict:
    """``case``'s indicators (or counts) as name → (idx, score) (name →
    counts for ``counts``), by the port."""
    from incubator_predictionio_torch.ops import llr

    call, cap = CASES[case]
    pu, pi, su, si = events()
    prior = os.environ.get("PIO_UR_FULL_MATRIX_ELEMS")
    if cap:
        os.environ["PIO_UR_FULL_MATRIX_ELEMS"] = cap
    try:
        if call == "pair":
            ind = llr.cco_indicators(
                pu, pi, su, si, N_USERS, N_ITEMS, max_correlators=K,
                u_chunk=U_CHUNK, item_block=32, device=device,
                timings=timings, collectives=collectives)
            return {"view": (ind.idx, ind.score)}
        secs = {"buy": (pu, pi), "view": (su, si)}
        if call == "counts":
            got = llr.cooccurrence_counts(pu, pi, secs, N_USERS, N_ITEMS,
                                          u_chunk=U_CHUNK, device=device,
                                          collectives=collectives)
            return {n: c.cpu().numpy() for n, c in got.items()}
        out = llr.cco_indicators_multi(
            pu, pi, secs, N_USERS, N_ITEMS, max_correlators=K,
            u_chunk=U_CHUNK, item_block=32, device=device, timings=timings,
            collectives=collectives)
        return {n: (ind.idx, ind.score) for n, ind in out.items()}
    finally:
        if prior is None:
            os.environ.pop("PIO_UR_FULL_MATRIX_ELEMS", None)
        else:
            os.environ["PIO_UR_FULL_MATRIX_ELEMS"] = prior


def run_gang(world: int, out: str, cases: str,
             timeout_s: float = 90.0) -> list:
    """Start ``world`` ranks of this script on the CPU and wait for every
    one (a hang fails within ``timeout_s``); returns [(rc, stdout, stderr)]
    in rank order."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("PIO_", "JAX_"))}
    base["PYTHONPATH"] = root + os.pathsep + base.get("PYTHONPATH", "")
    base.update(PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
                PIO_NUM_PROCESSES=str(world),
                PIO_COORDINATOR_TIMEOUT_MS="30000")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), out, cases],
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

    from incubator_predictionio_torch.parallel.distributed import (
        gang_collectives, initialize_distributed, process_index,
    )

    out, cases = sys.argv[1:3]
    initialize_distributed()
    torch.set_num_threads(1)  # tiny data; the test run shares the cores
    rank = process_index()
    arrays, reports = {}, {}
    for case in cases.split(","):
        timings: dict = {}
        got = run_case(case, collectives=gang_collectives(),
                       timings=timings)
        for name, v in got.items():
            if case == "counts":
                arrays[f"counts:{name}"] = v
            else:
                arrays[f"{case}:{name}:idx"], \
                    arrays[f"{case}:{name}:score"] = v
        reports[case] = timings
    np.savez(f"{out}.{rank}.npz", **arrays)
    print(json.dumps(reports), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
