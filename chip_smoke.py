"""Drive the PyTorch port on one NVIDIA GPU, end to end, and check it.

    python3 chip_smoke.py            # needs one CUDA card, nvcc for sm_90a

Phases (any failure exits non-zero; nothing is caught):

0. device: the card's name and power limit (nvidia-smi).
1. build: every CUDA kernel of the path, from the sources in the checkout.
2. kernel vs plain: both Gauss-Jordan SPD solve kernels (the warp kernel,
   k ≤ 32, and the wide kernel, 32 < k ≤ 128, every K it is built for)
   against their plain PyTorch version at the reference's test shapes and
   at the paths' shapes, rtol = atol = 2e-4 (the reference's tolerance);
   nearly singular ALS-like systems are reported with their relative-norm
   gap. Device times (torch.profiler) and back-to-back loop times (CUDA
   events) of the kernel, the plain version and torch's batched Cholesky
   (the yardstick; the port never calls it) beside the kernel's bound.
3. ALS on the card vs on the CPU (plain solve), ML-100K shape, rank 32 and
   rank 128.
4. main path at full width: ML-20M-shaped synthetic ratings (138,493 users
   × 26,744 items × 20,000,263 ratings), rank 32, trained through the
   Recommendation engine's ALSAlgorithm; warp-kernel launches must equal
   the solve calls the layout implies; persist → restore → HTTP server →
   ≥ 50 POST /queries.json; then the console's train → deploy → query on a
   small events file, in subprocesses; one steady iteration profiled.
5. train_rank128: the same ratings at rank 128 through the same engine, 2
   iterations: wide-kernel launches equal to the implied count and no
   warp-kernel launch, the RMSE check, steady seconds per iteration, one
   iteration profiled.

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Every printed line carries the card's name
and power limit.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from incubator_predictionio_torch.controller import EngineParams
from incubator_predictionio_torch.data.bimap import IdentityBiMap
from incubator_predictionio_torch.models.recommendation import (
    RecommendationEngine, TrainingData,
)
from incubator_predictionio_torch.ops import _build, spd_solve
from incubator_predictionio_torch.ops.als import (
    ALSParams, ALSTrainer, predict_rmse, solve_calls_per_half_step, train_als,
)
from incubator_predictionio_torch.ops.rowblocks import plan_layout
from incubator_predictionio_torch.workflow.context import WorkflowContext
from incubator_predictionio_torch.workflow.create_server import EngineServer
from incubator_predictionio_torch.workflow.persist import load_models, save_models

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-4  # tests/test_pallas_kernels.py:41
RANK = 32
ITERS = 3  # ALS iterations of the main path (10 in BASELINE.json; cut for time)
WIDE_RANK = 128  # the top of the Gauss-Jordan range: the wide kernel's path
WIDE_ITERS = 2
CHUNKED_LAUNCHES_PER_ITERATION = 348  # one solve launch per 512-row chunk
ML20M = (138_493, 26_744, 20_000_263)  # bench.py SCALES["ml20m"]
ML100K = (943, 1682, 100_000)  # bench.py SCALES["ml100k"]
CARD = ""  # "name, power limit" from nvidia-smi, set in phase 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def peak_rates() -> tuple[float, float, str]:
    """(bytes/s, float32 FLOP/s outside the tensor cores, part) from the
    data sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s; PCIe 2.0 TB/s and
    51 TFLOP/s; NVL 3.9 TB/s and 60 TFLOP/s."""
    name = torch.cuda.get_device_name(0)
    if "PCIe" in name:
        return 2.0e12, 51e12, "H100 PCIe"
    if "NVL" in name:
        return 3.9e12, 60e12, "H100 NVL"
    return 3.35e12, 67e12, "H100 SXM"


def solve_bound_ms(n: int, k: int) -> tuple[float, str]:
    """Least time for n k×k solves: each of A, b read once and x written
    once, (k² + 2k)·4 bytes; ≈ k³ float32 operations (the elimination of
    columns > j only, k³/2 multiply-adds)."""
    bw, flops, _ = peak_rates()
    t_bytes = n * (k * k + 2 * k) * 4 / bw
    t_ops = n * k ** 3 / flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def loop_ms(fn, reps: int) -> float:
    """Per-call time of a loop of reps calls, CUDA events around it, after
    a warm-up: what a caller that launches back to back waits, host work
    included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def cuda_kernels(prof) -> list:
    """The profiler's per-name averages of what ran on the card."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def device_ms(fn, reps: int) -> float:
    """Device time per call: the card's kernel time summed over reps calls
    (torch.profiler), divided by reps. Host time between launches is left
    out, so this is what the work itself costs the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = cuda_kernels(prof)
    check(bool(kernels), "the profiler saw no device time")
    return sum(e.self_device_time_total for e in kernels) / 1e3 / reps


def random_spd(n: int, k: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference test's systems (M Mᵀ + I), made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    m = torch.randn((n, k, k), generator=g, device=device)
    a = torch.bmm(m, m.transpose(1, 2)) + torch.eye(k, device=device)
    b = torch.randn((n, k), generator=g, device=device)
    return a, b


def als_like_spd(n: int, k: int, rows: int, seed: int, device):
    """Nearly singular systems as ALS makes them for a row with fewer
    ratings than the rank: the gram of ``rows`` < k counterpart factors
    (standard normal / √k, the trainer's init) plus a 0.01 ridge."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn((n, rows, k), generator=g, device=device) / k ** 0.5
    a = torch.bmm(y.transpose(1, 2), y) + 0.01 * torch.eye(k, device=device)
    r = torch.randint(1, 11, (n, rows), generator=g, device=device) / 2.0
    b = torch.bmm(y.transpose(1, 2), r[:, :, None])[..., 0]
    return a, b


def reset_launches() -> None:
    for counter in (spd_solve.gauss_jordan_launches,
                    spd_solve.gauss_jordan_warp_launches,
                    spd_solve.gauss_jordan_wide_launches):
        counter.reset()


def launches() -> dict:
    return {"total": spd_solve.gauss_jordan_launches.count,
            "warp": spd_solve.gauss_jordan_warp_launches.count,
            "wide": spd_solve.gauss_jordan_wide_launches.count}


def synth_ratings(n_users: int, n_items: int, nnz: int, seed: int = 7):
    """bench.py's synth_ratings: Zipf-ish items, ratings 0.5..5.0."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = (n_items * rng.random(nnz) ** 2).astype(np.int32)
    i = np.minimum(i, n_items - 1)
    r = rng.integers(1, 11, nnz).astype(np.float32) / 2.0
    return u, i, r


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phases -----------------------------------------------------------------


def phase_device() -> None:
    global CARD
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    CARD = out.stdout.strip().splitlines()[0]
    print(out.stdout.strip(), flush=True)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), peak_part=peak_rates()[2])
    # the port's parity rests on full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build() -> None:
    t0 = time.perf_counter()
    spd_solve.build_kernel()
    info = _build.build_info["gauss_jordan"]
    log = info["log"].splitlines()
    # "Compiling entry function '<mangled name>'" lines name each kernel;
    # the registers and spill lines follow it
    emit("build", kernel="gauss_jordan", seconds=time.perf_counter() - t0,
         nvcc_seconds=info["seconds"],
         ptxas=[ln.strip() for ln in log if "Compiling entry" in ln
                or "registers" in ln or "spill" in ln])


WIDE_KS = tuple(range(40, 129, 8))  # every K the wide kernel is built for
TIMED = ((512, 32, 200), (ML20M[0], 32, 10), (512, 64, 50), (512, 96, 50),
         (512, 128, 50), (8192, 128, 10))


def phase_kernel_vs_plain() -> dict:
    dev = torch.device("cuda")
    cases = [(5, 10), (300, 32), (130, 7), (1, 1), (513, 16), (40, 80),
             (24, 128), (9, 100), (511, 8), (513, 8), (1025, 8),
             (512, 32), (ML20M[0], 32), (8192, 128)]
    cases += [(n, k) for k in WIDE_KS for n in (1, 511, 513, 4096)]
    worst = {"warp": 0.0, "wide": 0.0}
    for n, k in cases:
        a, b = random_spd(n, k, seed=n + k, device=dev)
        x = spd_solve.batched_spd_solve(a, b)
        torch.cuda.synchronize()
        x_plain = spd_solve.gauss_jordan_plain(a, b)
        err = (x - x_plain).abs().max().item()
        ok = torch.allclose(x, x_plain, rtol=TOL, atol=TOL)
        kind = "warp" if k <= spd_solve.MAX_WARP_K else "wide"
        emit("kernel_vs_plain", n=n, k=k, kernel=kind, max_abs_err=err, ok=ok)
        check(ok, f"kernel disagrees with plain at n={n} k={k}: {err}")
        check(bool(torch.isfinite(x).all()), f"non-finite x at n={n} k={k}")
        worst[kind] = max(worst[kind], err)

    # nearly singular ALS-like systems (fewer ratings than the rank): held
    # to a relative-norm gap of 1e-2, as the plain-λ ALS parity is
    near_singular = []
    for k in (32, 64, 96, 128):
        a, b = als_like_spd(4096, k, rows=k // 4, seed=k, device=dev)
        x = spd_solve.batched_spd_solve(a, b)
        torch.cuda.synchronize()
        x_plain = spd_solve.gauss_jordan_plain(a, b)
        err = (x - x_plain).abs().max().item()
        rel = ((x - x_plain).norm() / x_plain.norm()).item()
        ok = torch.allclose(x, x_plain, rtol=TOL, atol=TOL)
        case = dict(n=4096, k=k, counterpart_rows=k // 4, ridge=0.01,
                    max_abs_err=err, rel_norm_err=rel, within_2e4=ok)
        emit("kernel_vs_plain_near_singular", **case)
        check(bool(torch.isfinite(x).all()), f"non-finite x at k={k}")
        check(rel < 1e-2, f"near-singular gap {rel} at k={k}")
        near_singular.append(case)

    timings = {}
    for n, k, reps in TIMED:
        a, b = random_spd(n, k, seed=1, device=dev)
        kernel = lambda: spd_solve.batched_spd_solve(a, b)  # noqa: E731
        plain = lambda: spd_solve.gauss_jordan_plain(a, b)  # noqa: E731
        library = lambda: spd_solve.cholesky_solve(a, b)  # noqa: E731
        bound_ms, bound_by = solve_bound_ms(n, k)
        timings[(n, k)] = dict(
            ms=device_ms(kernel, reps),
            plain_ms=device_ms(plain, max(1, reps // 10)),
            library_ms=device_ms(library, reps),
            bound_ms=bound_ms, bound_by=bound_by,
            loop_ms=loop_ms(kernel, reps),
            plain_loop_ms=loop_ms(plain, max(1, reps // 10)),
            library_loop_ms=loop_ms(library, reps))
        emit("kernel_time", n=n, k=k, **timings[(n, k)])
        del a, b
    return {"max_abs_err": worst, "near_singular": near_singular,
            "timings": timings}


def phase_als_card_vs_cpu() -> None:
    """Held at 2e-4 with ALS-WR scaling (λ·n_ratings), whose systems are
    well conditioned. With plain λ = 0.01 (the main path's setting) items
    with fewer ratings than the rank solve nearly singular systems (ridge
    0.01), where two correct float32 solvers (the reference's Cholesky and
    the port's Gauss-Jordan, both on the CPU) already drift apart by more
    than 2e-4 over 3 iterations; that case is reported and held to a
    relative-norm gap of 1e-2.

    Rank 128 (the wide kernel) runs with λ = 0.1·n_ratings, 2 iterations:
    most items have fewer ratings than the rank, and at 0.01·n_ratings two
    correct float32 solvers part by ~1e-3 already on the CPU
    (tests/test_torch_als.py)."""
    u, i, r = synth_ratings(*ML100K, seed=11)
    for rank, iters, reg, scaling, strict in (
            (RANK, 3, 0.01, "nratings", True),
            (RANK, 3, 0.01, "plain", False),
            (WIDE_RANK, 2, 0.1, "nratings", True)):
        params = ALSParams(rank=rank, num_iterations=iters, reg=reg, seed=3,
                           lambda_scaling=scaling)
        t0 = time.perf_counter()
        f_gpu = train_als(u, i, r, ML100K[0], ML100K[1], params, device="cuda")
        gpu_s = time.perf_counter() - t0
        f_cpu = train_als(u, i, r, ML100K[0], ML100K[1], params, device="cpu")
        err_u = float(np.abs(f_gpu.user_factors - f_cpu.user_factors).max())
        err_i = float(np.abs(f_gpu.item_factors - f_cpu.item_factors).max())
        rel = max(
            float(np.linalg.norm(a - b) / np.linalg.norm(b))
            for a, b in ((f_gpu.user_factors, f_cpu.user_factors),
                         (f_gpu.item_factors, f_cpu.item_factors)))
        ok = (np.allclose(f_gpu.user_factors, f_cpu.user_factors, rtol=TOL,
                          atol=TOL)
              and np.allclose(f_gpu.item_factors, f_cpu.item_factors,
                              rtol=TOL, atol=TOL))
        emit("als_card_vs_cpu", shape=ML100K, rank=rank, iterations=iters,
             reg=reg, lambda_scaling=scaling, max_abs_err_user=err_u,
             max_abs_err_item=err_i, rel_norm_err=rel, within_2e4=ok,
             held_to="rtol=atol=2e-4" if strict else "rel_norm_err<1e-2",
             card_train_seconds=gpu_s)
        if strict:
            check(ok, f"ALS factors on the card differ from the CPU's: "
                      f"{err_u}, {err_i}")
        else:
            check(rel < 1e-2, f"ALS factors drift {rel} (relative norm)")


def _post(conn: http.client.HTTPConnection, obj) -> tuple[int, dict, float]:
    body = json.dumps(obj)
    t0 = time.perf_counter()
    conn.request("POST", "/queries.json", body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    return resp.status, json.loads(data), (time.perf_counter() - t0) * 1e3


def phase_main_path(workdir: str) -> dict:
    n_users, n_items, nnz = ML20M
    u, i, r = synth_ratings(n_users, n_items, nnz)
    engine_json = {
        "engineFactory": "incubator_predictionio_torch.models.recommendation."
                         "RecommendationEngine",
        "datasource": {"params": {"appName": "ml20m-synth"}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "numIterations": ITERS, "lambda": 0.01}}],
    }
    engine = RecommendationEngine()()
    params = EngineParams.from_json(engine_json)
    _, _, algo_list, _ = engine.make_components(params)
    algo = algo_list[0][1]
    ctx = WorkflowContext(device="cuda")
    td = TrainingData(u, i, r, IdentityBiMap(n_users), IdentityBiMap(n_items))

    # the launches the layout implies: fused chunks + heavy bucket, per side
    als_params = algo.als_params(algo.params)
    plan_u = plan_layout(np.bincount(u, minlength=n_users))
    plan_i = plan_layout(np.bincount(i, minlength=n_items))
    calls_u = solve_calls_per_half_step(plan_u, als_params)
    calls_i = solve_calls_per_half_step(plan_i, als_params)
    expected = ITERS * (calls_u + calls_i)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches_train = launches()

    uf, itf = model.factors.user_factors, model.factors.item_factors
    check(uf.shape == (n_users, RANK) and itf.shape == (n_items, RANK),
          f"factor shapes {uf.shape} {itf.shape}")
    check(bool(np.isfinite(uf).all() and np.isfinite(itf).all()),
          "non-finite factors")
    sample = np.random.default_rng(0).choice(nnz, 1_000_000, replace=False)
    rmse = predict_rmse(model.factors, u[sample], i[sample], r[sample])
    check(rmse < float(np.std(r)), f"train RMSE {rmse} not below std")
    emit("train", events=nnz, iterations=ITERS, rank=RANK,
         train_seconds=train_s,
         train_events_per_s_end_to_end=nnz * ITERS / train_s,
         kernel_launches=launches_train, expected_launches=expected,
         solve_calls_per_iteration={"user": calls_u, "item": calls_i},
         chunked_launches_per_iteration=CHUNKED_LAUNCHES_PER_ITERATION,
         buckets={"user": len(plan_u.lengths), "item": len(plan_i.lengths)},
         heavy_bucket={"user": plan_u.has_heavy_bucket,
                       "item": plan_i.has_heavy_bucket},
         train_rmse_1m_sample=rmse)
    check(launches_train["warp"] == expected == launches_train["total"],
          f"kernel launches {launches_train} != implied {expected}")
    check(calls_u + calls_i < CHUNKED_LAUNCHES_PER_ITERATION,
          f"{calls_u + calls_i} launches per iteration, not fewer than "
          f"one per chunk")

    # persist → restore → serve
    path = os.path.join(workdir, "ml20m_model.npz")
    save_models(path, engine_json, [algo.prepare_model_for_persistence(model)])
    engine_json2, stored = load_models(path)
    deployment = engine.prepare_deployment(
        WorkflowContext(device="cuda"), EngineParams.from_json(engine_json2),
        stored)
    deployment.models[0].warm_up()
    check(np.array_equal(deployment.models[0].factors.item_factors, itf),
          "restored factors differ")
    server = EngineServer(deployment, "127.0.0.1", 0)
    host, port = server.start()
    conn = http.client.HTTPConnection(host, port, timeout=30)
    rng = np.random.default_rng(1)
    lat = []
    n_queries = 200
    try:
        for q in range(n_queries):
            user = str(int(rng.integers(0, n_users)))
            status, res, ms = _post(conn, {"user": user, "num": 10})
            check(status == 200, f"query status {status}: {res}")
            lat.append(ms)
            if q < 5:
                # against the host: the served scores are the dot products
                # and no item outside the answer scores higher
                s = itf @ uf[int(user)]
                got = [int(e["item"]) for e in res["itemScores"]]
                scores = [e["score"] for e in res["itemScores"]]
                check(len(got) == 10 and scores == sorted(scores, reverse=True),
                      f"bad answer {res}")
                check(np.allclose(s[got], scores, rtol=1e-4, atol=1e-4),
                      "served scores differ from the host's")
                check(np.sort(s)[::-1][9] <= scores[-1] + 1e-4,
                      "served top-10 misses a better item")
        status, res, _ = _post(conn, {"user": "0", "items": ["5", "nope", "3"]})
        check(status == 200 and len(res["itemScores"]) == 3, f"ranking {res}")
    finally:
        conn.close()
        server.stop()
    lat_s = np.sort(np.asarray(lat[1:]))  # first query opens the connection
    emit("serve", queries=n_queries, p50_ms=float(np.percentile(lat_s, 50)),
         p99_ms=float(np.percentile(lat_s, 99)), catalog=n_items)

    # steady state: the same training state, timed iterations only
    trainer = ALSTrainer(u, i, r, n_users, n_items, als_params, device="cuda")
    trainer.iterate(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.iterate(ITERS)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    emit("train_steady", events=nnz, iterations=ITERS,
         seconds=steady_s, train_events_per_s=nnz * ITERS / steady_s,
         seconds_per_iteration=steady_s / ITERS)
    profile_iteration(trainer)
    return {"launches": launches_train["warp"], "expected": expected,
            "ratings": (u, i, r)}


def phase_train_rank128(ratings) -> dict:
    """The wide kernel's path: the main path's ratings at rank 128 through
    the same engine. Order: launches, RMSE, steady time, profile."""
    n_users, n_items, nnz = ML20M
    u, i, r = ratings
    engine_json = {
        "engineFactory": "incubator_predictionio_torch.models.recommendation."
                         "RecommendationEngine",
        "datasource": {"params": {"appName": "ml20m-synth"}},
        "algorithms": [{"name": "als", "params": {
            "rank": WIDE_RANK, "numIterations": WIDE_ITERS,
            "lambda": 0.01}}],
    }
    engine = RecommendationEngine()()
    _, _, algo_list, _ = engine.make_components(
        EngineParams.from_json(engine_json))
    algo = algo_list[0][1]
    als_params = algo.als_params(algo.params)
    plan_u = plan_layout(np.bincount(u, minlength=n_users))
    plan_i = plan_layout(np.bincount(i, minlength=n_items))
    calls_u = solve_calls_per_half_step(plan_u, als_params)
    calls_i = solve_calls_per_half_step(plan_i, als_params)
    expected = WIDE_ITERS * (calls_u + calls_i)
    td = TrainingData(u, i, r, IdentityBiMap(n_users), IdentityBiMap(n_items))

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = algo.train(WorkflowContext(device="cuda"), td)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    got = launches()
    emit("train_rank128_launches", rank=WIDE_RANK, iterations=WIDE_ITERS,
         kernel_launches=got, expected_launches=expected,
         solve_calls_per_iteration={"user": calls_u, "item": calls_i},
         train_seconds=train_s)
    check(got["wide"] == expected == got["total"] and got["warp"] == 0,
          f"rank-128 launches {got} != implied {expected} wide, 0 warp")

    uf, itf = model.factors.user_factors, model.factors.item_factors
    check(uf.shape == (n_users, WIDE_RANK) and itf.shape == (n_items, WIDE_RANK),
          f"factor shapes {uf.shape} {itf.shape}")
    check(bool(np.isfinite(uf).all() and np.isfinite(itf).all()),
          "non-finite rank-128 factors")
    sample = np.random.default_rng(0).choice(nnz, 1_000_000, replace=False)
    rmse = predict_rmse(model.factors, u[sample], i[sample], r[sample])
    emit("train_rank128_rmse", train_rmse_1m_sample=rmse,
         ratings_std=float(np.std(r)))
    check(rmse < float(np.std(r)), f"rank-128 train RMSE {rmse} not below std")
    del model

    trainer = ALSTrainer(u, i, r, n_users, n_items, als_params, device="cuda")
    trainer.iterate(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.iterate(WIDE_ITERS)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    emit("train_rank128_steady", events=nnz, iterations=WIDE_ITERS,
         seconds=steady_s, train_events_per_s=nnz * WIDE_ITERS / steady_s,
         seconds_per_iteration=steady_s / WIDE_ITERS)
    profile_iteration(trainer, "train_rank128_profile")
    return {"launches": got["wide"], "expected": expected}


def profile_iteration(trainer: ALSTrainer,
                      phase: str = "profile_iteration") -> None:
    """Where one steady-state iteration's device time goes: torch.profiler
    kernel times by name, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.iterate(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = cuda_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit(phase, wall_ms_profiled=wall_ms,
         device_busy_ms=busy_ms if kernels else "not measured",
         idle_share=(1 - busy_ms / wall_ms) if kernels else "not measured",
         top=[{"name": e.key[:90], "calls": e.count,
               "device_ms": e.self_device_time_total / 1e3} for e in top])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_console(workdir: str) -> None:
    """The entry points themselves: console train → deploy → query."""
    rng = np.random.default_rng(5)
    n_users, n_items, n = 500, 300, 20_000
    events = os.path.join(workdir, "events.jsonl")
    with open(events, "w", encoding="utf-8") as fh:
        for j in range(n):
            ev = "buy" if j % 10 == 0 else "rate"
            e = {"event": ev, "entityType": "user",
                 "entityId": f"u{int(rng.integers(n_users))}",
                 "targetEntityType": "item",
                 "targetEntityId": f"i{int(n_items * rng.random() ** 2)}",
                 "eventTime": f"2024-01-01T00:{j // 3600 % 60:02d}:"
                              f"{j // 60 % 60:02d}.{j % 60:03d}Z"}
            if ev == "rate":
                e["properties"] = {"rating": float(rng.integers(1, 6))}
            fh.write(json.dumps(e) + "\n")
    engine_json = os.path.join(workdir, "engine.json")
    with open(engine_json, "w", encoding="utf-8") as fh:
        json.dump({"engineFactory": "incubator_predictionio_torch.models."
                                    "recommendation.RecommendationEngine",
                   "datasource": {"params": {"appName": "smoke"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": RANK, "numIterations": 5, "lambda": 0.05}}]},
                  fh)
    model = os.path.join(workdir, "console_model.npz")
    cmd = [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(cmd + ["train", "--engine-json", engine_json,
                                "--events", events, "--model-out", model],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    check(out.returncode == 0, f"console train failed: {out.stderr[-2000:]}")
    trained = json.loads(out.stdout.strip().splitlines()[-1])
    port = _free_port()
    proc = subprocess.Popen(cmd + ["deploy", "--model", model, "--port",
                                   str(port)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    try:
        deadline = time.time() + 120
        while True:
            if proc.poll() is not None:
                raise AssertionError(
                    f"console deploy exited: {proc.stderr.read()[-2000:]}")
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/")
                status = conn.getresponse().status
                conn.close()
                if status == 200:
                    break
            except OSError:
                pass
            check(time.time() < deadline, "console deploy never came up")
            time.sleep(0.5)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        answers = []
        for user in ("u1", "u2", "u3", "nobody"):
            status, res, ms = _post(conn, {"user": user, "num": 5})
            check(status == 200, f"console query {status} {res}")
            answers.append((user, len(res["itemScores"]), ms))
        conn.close()
        check(answers[0][1] == 5 and answers[-1][1] == 0,
              f"console answers {answers}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    emit("console", events=n, train_seconds=trained["seconds"],
         device=trained["device"], answers=answers)


def main() -> int:
    phase_device()
    phase_build()
    kv = phase_kernel_vs_plain()
    phase_als_card_vs_cpu()
    with tempfile.TemporaryDirectory() as workdir:
        main_path = phase_main_path(workdir)
        phase_console(workdir)
    wide_path = phase_train_rank128(main_path.pop("ratings"))
    t = kv["timings"]

    def entry(name, kind, replaces, serves, launches, shape, extra_shapes):
        n, k = shape
        row = t[shape]
        return {
            "name": name, "route": "cuda",
            "source": "incubator_predictionio_torch/ops/csrc/gauss_jordan.cu",
            "replaces": replaces, "serves": serves, "launches": launches,
            "max_abs_err": kv["max_abs_err"][kind],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": f"n={n}, k={k}",
            "other_shapes": {f"n={sn}, k={sk}": t[(sn, sk)]
                             for sn, sk in extra_shapes},
            "card": CARD,
        }

    kernels = [
        entry("gauss_jordan_warp", "warp",
              "incubator_predictionio_tpu/ops/pallas_kernels.py:137",
              "k <= 32 (of _solve_lanes' k <= 96)",
              main_path["launches"], (ML20M[0], 32), [(512, 32)]),
        entry("gauss_jordan_wide", "wide",
              "incubator_predictionio_tpu/ops/pallas_kernels.py:173",
              "32 < k <= 128 (_solve_slabs_wide's 96 < k <= 128, and "
              "_solve_lanes' 32 < k <= 96, pallas_kernels.py:137)",
              wide_path["launches"], (8192, 128),
              [(512, 64), (512, 96), (512, 128)]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
