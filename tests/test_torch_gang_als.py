"""The port's data-parallel ALS (``ops.als.train_als_partition_local``)
held against the JAX package's ``train_als`` on the CPU:

- ``force_dp=True`` in one process, at k = 8 and k = 48 (the plain solve;
  the two-process gangs are in test_torch_gang_supervisor.py);
- the process group's knobs: the timeouts parse as the reference's, a
  garbled ``PIO_PROCESS_ID`` crashes a gang worker at start-up, and a
  ``PIO_MESH_SHAPE`` with a model axis is refused;
- a merged gang of a user engine whose algorithm cannot train in a gang
  is refused by every rank.

(The reference's own data-parallel trainer is not the yardstick: its
parity test has been red since it was written.)
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from incubator_predictionio_tpu.ops import als as ref_als  # noqa: E402
from incubator_predictionio_tpu.parallel import distributed as ref_dist  # noqa: E402
from incubator_predictionio_tpu.parallel import mesh as ref_mesh  # noqa: E402
from incubator_predictionio_torch.ops import als as port_als  # noqa: E402
from incubator_predictionio_torch.parallel import distributed, mesh  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_worker as W  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSOLE = [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]
TOL = 2e-4


def _reference(u, i, r, n_users, n_items, p: port_als.ALSParams):
    kw = {f: getattr(p, f) for f in (
        "rank", "num_iterations", "reg", "lambda_scaling", "implicit_prefs",
        "alpha", "seed")}
    mesh1 = ref_mesh.mesh_from_devices(devices=jax.devices()[:1])
    return ref_als.train_als(u, i, r, n_users, n_items,
                             ref_als.ALSParams(**kw, compute_dtype="float32"),
                             mesh=mesh1)


def _close(got, want) -> None:
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [8, 48])
def test_force_dp_one_process_matches_reference(k):
    torch.backends.cuda.matmul.allow_tf32 = False
    u, i, r = W.data("explicit")
    p = W.params("explicit", 3, rank=k)
    timings = {}
    got = port_als.train_als_partition_local(
        u, i, r, W.N_USERS, W.N_ITEMS, p, device="cpu", force_dp=True,
        timings=timings)
    want = _reference(u, i, r, W.N_USERS, W.N_ITEMS, p)
    _close(got.user_factors, want.user_factors)
    _close(got.item_factors, want.item_factors)
    # one process: no collective, every row is this rank's block
    assert timings["world"] == 1 and timings["allreduce_bytes"] == 0
    assert timings["half_steps"] == 6
    assert timings["solve_calls_per_iteration"] == 2


def test_one_process_without_force_dp_is_train_als():
    u, i, r = W.data("implicit")
    p = W.params("implicit", 3)
    got = port_als.train_als_partition_local(u, i, r, W.N_USERS, W.N_ITEMS,
                                             p, device="cpu")
    want = port_als.train_als(u, i, r, W.N_USERS, W.N_ITEMS, p, device="cpu")
    assert np.array_equal(got.user_factors, want.user_factors)


def test_solve_calls_per_half_step():
    # the solve buffer holds 512 MB of [k, k] grams: 131,072 rows at k=32
    assert port_als.dp_solve_calls_per_half_step(3_020, 32) == 1
    assert port_als.dp_solve_calls_per_half_step(131_072, 32) == 1
    assert port_als.dp_solve_calls_per_half_step(131_073, 32) == 2
    assert port_als.dp_solve_calls_per_half_step(0, 32) == 0


def test_timeouts_and_mesh_knobs_match_reference(monkeypatch):
    for k in ("PIO_COORDINATOR_TIMEOUT_MS", "PIO_DIST_HEARTBEAT_MS",
              "PIO_DIST_MAX_MISSING_HEARTBEATS", "PIO_MESH_SHAPE"):
        monkeypatch.delenv(k, raising=False)
    for env in ({}, {"PIO_COORDINATOR_TIMEOUT_MS": "2500",
                     "PIO_DIST_HEARTBEAT_MS": "1",
                     "PIO_DIST_MAX_MISSING_HEARTBEATS": "3"},
                {"PIO_COORDINATOR_TIMEOUT_MS": "soon",
                 "PIO_DIST_HEARTBEAT_MS": "inf"}):
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        got = distributed.resolve_distributed_timeouts()
        want = ref_dist.resolve_distributed_timeouts()
        assert {k: got[k] for k in want} == want
        assert got["timeout"].total_seconds() == max(
            want["initialization_timeout"],
            want["heartbeat_interval"] * want["max_missing_heartbeats"])
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    assert np.array_equal(mesh.pad_rows(x, 4), ref_mesh.pad_rows(x, 4))
    assert mesh.local_device_count() == 1 and mesh.data_axis_size() == 1
    monkeypatch.setenv("PIO_MESH_SHAPE", "1x2")
    with pytest.raises(ValueError, match="model axis"):
        port_als.train_als_partition_local(
            *W.data("explicit"), W.N_USERS, W.N_ITEMS,
            W.params("explicit", 1), device="cpu", force_dp=True)
    monkeypatch.setenv("PIO_MESH_SHAPE", "2")
    with pytest.raises(ValueError, match="one device per rank"):
        mesh.data_axis_size()
    monkeypatch.setenv("PIO_MESH_SHAPE", "2y")
    with pytest.raises(ValueError, match="expected D or DxM"):
        mesh.mesh_shape_from_env()


def _console_env(tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_"))}
    env.update(PIO_FS_BASEDIR=str(tmp_path / "store"),
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    os.makedirs(env["PIO_FS_BASEDIR"], exist_ok=True)
    return env


def test_garbled_process_id_crashes_at_startup(tmp_path):
    env = _console_env(tmp_path) | {
        "PIO_GANG_WORKER": "1", "PIO_NUM_PROCESSES": "2",
        "PIO_PROCESS_ID": "one", "PIO_COORDINATOR_ADDRESS": "127.0.0.1:9"}
    out = subprocess.run(CONSOLE + ["train", "--device", "cpu"], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=60)
    assert out.returncode != 0
    assert "ValueError" in out.stderr and "'one'" in out.stderr
    # an out-of-range rank is refused the same way
    env["PIO_PROCESS_ID"] = "2"
    out = subprocess.run(CONSOLE + ["train", "--device", "cpu"], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=60)
    assert out.returncode != 0 and "outside a gang" in out.stderr


def test_merged_feed_gang_is_refused(tmp_path):
    """Every template of the port trains in a merged gang (the ALS ones in
    tests/test_torch_slab_gang*, the linear ones in test_torch_linear_gang,
    the CCO ones in test_torch_cco_gang). A user engine whose algorithm
    does not declare ``gang_capable`` is refused by every rank before any
    collective, and the gang fails naming the flag."""
    import shutil

    env = _console_env(tmp_path) | {"PIO_TRAIN_MAX_RESTARTS": "0"}
    engine_dir = tmp_path / "vanilla"
    shutil.copytree(os.path.join(ROOT, "incubator_predictionio_torch",
                                 "templates", "vanilla"), engine_dir)
    out = subprocess.run(
        CONSOLE + ["train", "--num-workers", "2", "--feed", "merged",
                   "--device", "cpu", "--engine-dir", str(engine_dir)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0, out.stdout[-2000:] + out.stderr[-2000:]
    logs = "".join(
        open(os.path.join(d, f), encoding="utf-8", errors="replace").read()
        for d, _, files in os.walk(tmp_path / "store") for f in files
        if f.endswith(".log"))
    assert "gang_capable" in out.stderr + logs
