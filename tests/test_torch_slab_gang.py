"""The port's multi-process slab ALS (``ops.als``: ``train_als`` in a gang
and ``train_als_process_sharded``, on ``SlabGangALS``) held against the
JAX package's ``train_als`` on a CPU mesh of the same shape (the 8
virtual devices of tests/conftest.py), at the reference's tolerances:
rtol 2e-4 / atol 2e-5 on a 1-D mesh (tests/test_multihost.py:127), 5e-4 /
5e-5 on the 2-D ALX mesh (tests/test_als_model_axis.py:55).

The gangs are gloo process groups of CPU ranks (tests/torch_slab_worker.py);
one launch trains several runs, and every launch waits within a time
limit. Covered: the merged feed at d = 2 (explicit, implicit, binary, rank
64: the wide kernel's plain form), the (2, 2) mesh (chunk_tiles 0 and 2,
a heavy bucket), process-sharded at d = 2 (and all-ones) and on (2, 2); a
rank fed rows outside its range and a plan-signature mismatch, each
failing fast on every rank; a checkpointed run killed after a snapshot
and resumed; the sharded layout (``fill_buckets(shard0,
n_local_shards)``, ``plan_layout``) against the reference's numpy path;
and parallel candidates refused in a process of a gang (item 7.7).
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from incubator_predictionio_tpu.ops import als as ref_als  # noqa: E402
from incubator_predictionio_tpu.ops import rowblocks as ref_rb  # noqa: E402
from incubator_predictionio_tpu.parallel import mesh as ref_mesh  # noqa: E402
from incubator_predictionio_torch.ops import als as port_als  # noqa: E402
from incubator_predictionio_torch.ops import rowblocks as port_rb  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_slab_worker as W  # noqa: E402

TOL_1D = dict(rtol=2e-4, atol=2e-5)
TOL_2D = dict(rtol=5e-4, atol=5e-5)
RUNS_1D = ("merged:explicit", "merged:implicit", "merged:binary",
           "merged:rank64", "sharded:explicit", "sharded:binary")
RUNS_2D = ("merged:tiles0", "merged:tiles2", "merged:heavy",
           "sharded:explicit", "sharded:heavy")


def _ok(got: list) -> list:
    """The ranks' reports of a launch whose ranks all exited 0."""
    for rank, (rc, out, err) in enumerate(got):
        assert rc == 0, f"rank {rank} exited {rc}: {err[-3000:]}"
    return [{r["run"]: r for r in json.loads(out.strip().splitlines()[-1])}
            for _, out, _ in got]


@pytest.fixture(scope="module")
def gang_1d(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("slab1d") / "f.npz")
    reports = _ok(W.run_gang(2, out, ",".join(RUNS_1D)))
    return dict(np.load(out)), reports


@pytest.fixture(scope="module")
def gang_2d(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("slab2d") / "f.npz")
    reports = _ok(W.run_gang(4, out, ",".join(RUNS_2D), mesh="2x2"))
    return dict(np.load(out)), reports


def _reference(mode: str, shape):
    u, i, r, nu, ni = W.data(mode)
    p = W.params(mode)
    devices = jax.devices("cpu")[:int(np.prod(shape))]
    if len(shape) == 1:
        mesh = ref_mesh.mesh_from_devices(devices=devices)
    else:
        mesh = ref_mesh.mesh_from_devices(
            shape=shape, axis_names=(ref_mesh.DATA_AXIS, ref_mesh.MODEL_AXIS),
            devices=devices)
    return ref_als.train_als(u, i, r, nu, ni, ref_als.ALSParams(
        **p, compute_dtype="float32"), mesh=mesh)


def _implied_calls(mode: str, d: int, m: int) -> int:
    """The solve calls one rank makes per iteration: its shard of the plan
    of the (d, m) mesh, both sides."""
    u, i, r, nu, ni = W.data(mode)
    p = port_als.ALSParams(**W.params(mode))
    plans = [port_rb.plan_layout(np.bincount(rows, minlength=n), d, m)
             for rows, n in ((u, nu), (i, ni))]
    return sum(port_als.solve_calls_per_half_step(pl, p, 1) for pl in plans)


@pytest.mark.parametrize("run", RUNS_1D)
def test_one_d_gang_matches_reference(gang_1d, run):
    factors, reports = gang_1d
    feed, mode = run.split(":")
    want = _reference(mode, (2,))
    np.testing.assert_allclose(factors[f"{run}:user"], want.user_factors,
                               **TOL_1D)
    np.testing.assert_allclose(factors[f"{run}:item"], want.item_factors,
                               **TOL_1D)
    for rank, rep in enumerate(reports):
        got = rep[run]
        assert got["mesh"] == [2, 1] and got["coords"] == [rank, 0]
        assert got["half_steps"] == 2 * W.ITERS
        # the replicated layout sums nothing: one all-gather a half-step
        assert got["allreduce_calls"] == 0
        assert got["allgather_calls"] == got["half_steps"]
        assert got["solve_calls_per_iteration"] == _implied_calls(mode, 2, 1)
        assert got["feed"] == {"merged": "merged",
                               "sharded": "process_sharded"}[feed]


@pytest.mark.parametrize("run", RUNS_2D)
def test_two_d_gang_matches_reference(gang_2d, run):
    factors, reports = gang_2d
    _, mode = run.split(":")
    want = _reference(mode, (2, 2))
    np.testing.assert_allclose(factors[f"{run}:user"], want.user_factors,
                               **TOL_2D)
    np.testing.assert_allclose(factors[f"{run}:item"], want.item_factors,
                               **TOL_2D)
    u, i, _, nu, ni = W.data(mode)
    k = W.params(mode)["rank"]
    slots = [port_rb.plan_layout(np.bincount(rows, minlength=n), 2, 2)
             .total_slots for rows, n in ((u, nu), (i, ni))]
    for rank, rep in enumerate(reports):
        got = rep[run]
        assert got["mesh"] == [2, 2] and got["coords"] == [rank // 2,
                                                            rank % 2]
        # the ALX layout: each rank holds half of each slot matrix (+ one
        # zero row), and sums its partial grams over its model group
        assert got["factor_bytes_resident"] == sum(
            (t // 2 + 1) * k * 4 for t in slots)
        assert got["allreduce_calls"] > 0 and got["allreduce_bytes"] > 0
        assert got["solve_calls_per_iteration"] == _implied_calls(mode, 2, 2)
    # the ranks of one data row solve the same systems: their model-group
    # sums move the same bytes
    assert reports[0][run]["allreduce_bytes"] == \
        reports[1][run]["allreduce_bytes"]


def test_heavy_bucket_is_exercised():
    u, _, _, nu, _ = W.data("heavy")
    plan = port_rb.plan_layout(np.bincount(u, minlength=nu), 2, 2)
    assert plan.has_heavy_bucket and W.HEAVY_ROW > port_rb.OVERFLOW_LEN


def _fault(tmp_path, fault: str, run: str) -> list:
    got = W.run_gang(2, str(tmp_path / "f.npz"), run,
                     env={"PIO_TEST_FAULT": fault}, timeout_s=60)
    assert all(rc != 0 for rc, _, _ in got), [rc for rc, _, _ in got]
    return [err for _, _, err in got]


def test_rank_outside_its_range_fails_fast(tmp_path):
    err0, err1 = _fault(tmp_path, "outside", "sharded:explicit")
    assert "got rows outside this process's range" in err1
    assert "process_row_ranges" in err1
    assert "rank(s) [1] got rows outside their range" in err0


def test_plan_signature_mismatch_fails_fast(tmp_path):
    for err in _fault(tmp_path, "n_items", "merged:explicit"):
        assert "disagree on the plan signature's inputs" in err
        assert "rank 0: [40, 30," in err and "rank 1: [40, 31," in err


def test_killed_gang_resumes_to_the_uninterrupted_run(tmp_path, gang_1d):
    ckpt = str(tmp_path / "ckpt")
    out = str(tmp_path / "f.npz")
    crashed = W.run_gang(2, out, "merged:explicit", extra=("--ckpt", ckpt),
                         env={"PIO_FAULT_SPEC": "train.sweep:crash:2"})
    assert all(rc != 0 for rc, _, _ in crashed)
    assert os.path.exists(os.path.join(ckpt, "2.npz")), os.listdir(ckpt)
    resumed = _ok(W.run_gang(2, out, "merged:explicit",
                             extra=("--ckpt", ckpt, "--resume")))
    # one iteration after the step-2 snapshot
    assert all(r["merged:explicit"]["half_steps"] == 2 for r in resumed)
    factors, _ = gang_1d
    got = np.load(out)
    for side in ("user", "item"):
        assert np.array_equal(got[f"merged:explicit:{side}"],
                              factors[f"merged:explicit:{side}"])


@pytest.mark.parametrize("d,m_div", [(2, 1), (2, 2), (2, 4), (4, 1),
                                     (4, 2), (4, 4)])
def test_sharded_fill_matches_reference(d, m_div):
    u, i, r, nu, ni = W.data("heavy")
    counts_u = np.bincount(u, minlength=nu)
    counts_i = np.bincount(i, minlength=ni)
    plan_u = port_rb.plan_layout(counts_u, d, m_div)
    plan_i = port_rb.plan_layout(counts_i, d, m_div)
    ref_u = ref_rb.plan_layout(counts_u, d, m_div=m_div)
    ref_i = ref_rb.plan_layout(counts_i, d, m_div=m_div)
    for got, want in ((plan_u, ref_u), (plan_i, ref_i)):
        for f in ("lengths", "bucket_rows", "slot_of_row", "counts_slot",
                  "v_parent", "v_base_of_row"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.rows_per_shard == want.rows_per_shard
        assert got.rows_per_shard % m_div == 0
    for s in range(d):
        for plan, row, col, cp in ((plan_u, u, i, plan_i),
                                   (plan_i, i, u, plan_u)):
            lo = s * -(-plan.n_rows // d)
            keep = (row >= lo) & (row < lo + -(-plan.n_rows // d))
            args = (row[keep], col[keep], r[keep])
            kw = dict(col_slot_map=cp.slot_of_row, sentinel=cp.total_slots,
                      shard0=s, n_local_shards=1)
            got = port_rb.fill_buckets(plan, *args, **kw)
            want = ref_rb.fill_buckets(plan, *args, **kw, use_native=False)
            for g, w in zip(got.cols + got.vals + (got.v_cols, got.v_vals),
                            want.cols + want.vals
                            + (want.v_cols, want.v_vals)):
                assert np.array_equal(g, w)
    # plan_and_fill_both(shard=s) fills shard s as the full fill does
    _, _, full_u, _ = port_rb.plan_and_fill_both(u, i, r, nu, ni,
                                                 n_shards=d, m_div=m_div)
    _, _, one_u, _ = port_rb.plan_and_fill_both(u, i, r, nu, ni,
                                                n_shards=d, m_div=m_div,
                                                shard=d - 1)
    for b, c in enumerate(one_u.cols):
        rows = int(plan_u.bucket_rows[b])
        assert np.array_equal(c, full_u.cols[b][(d - 1) * rows:d * rows])
    with pytest.raises(ValueError, match="outside shards"):
        port_rb.fill_buckets(plan_u, u, i, r, col_slot_map=plan_i.slot_of_row,
                             sentinel=plan_i.total_slots, shard0=1,
                             n_local_shards=1)


def test_process_row_ranges_and_mesh(monkeypatch):
    from incubator_predictionio_torch.parallel import mesh

    monkeypatch.delenv("PIO_MESH_SHAPE", raising=False)
    assert mesh.mesh_dims(4) == (4, 1)
    monkeypatch.setenv("PIO_MESH_SHAPE", "2x2")
    assert mesh.mesh_dims(4) == (2, 2)
    assert [mesh.mesh_coords(r, (2, 2)) for r in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    with pytest.raises(ValueError, match="product must be the number"):
        mesh.mesh_dims(2)
    # the ranks of one data row share its range (one device per rank)
    assert port_als.process_row_ranges(41, (2, 2)) == (0, 21)
    monkeypatch.setenv("PIO_MESH_SHAPE", "4")
    assert mesh.mesh_dims(4) == (4, 1)
    with pytest.raises(ValueError, match="model axis"):
        monkeypatch.setenv("PIO_MESH_SHAPE", "2x2")
        mesh.data_axis_size()


def test_parallel_candidates_refused_in_a_gang(monkeypatch, tmp_path):
    """Item 7.7: ``parallelism`` > 1 in a process of a group larger than
    one raises the reference's message."""
    from incubator_predictionio_torch.parallel import distributed
    from incubator_predictionio_torch.workflow import evaluation_workflow
    from incubator_predictionio_torch.workflow.context import WorkflowContext

    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    ctx = WorkflowContext(device="cpu")
    with pytest.raises(ValueError, match="single-controller run"):
        evaluation_workflow.candidate_devices(ctx, 2, 4)
    assert evaluation_workflow.candidate_devices(ctx, 1, 4) == [ctx.device]
