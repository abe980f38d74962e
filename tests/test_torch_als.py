"""The port's ALS (incubator_predictionio_torch/ops/als.py, rowblocks.py) on
the CPU against the JAX reference's single-device trainer.

The reference runs on a one-device CPU mesh, where its solve is the XLA
Cholesky; the port's CPU solve is the plain Gauss-Jordan that the CUDA
kernel repeats. Factors are held at the reference's ALS tolerance,
rtol = atol = 2e-4 (ROADMAP: the same bound as the solve).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.ops import als as ref_als  # noqa: E402
from incubator_predictionio_tpu.ops import rowblocks as ref_rowblocks  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import mesh_from_devices  # noqa: E402
from incubator_predictionio_torch.ops import als as port_als  # noqa: E402
from incubator_predictionio_torch.ops import rowblocks as port_rowblocks  # noqa: E402

TOL = 2e-4


def _ratings(n_users=60, n_items=40, nnz=900, seed=0, heavy_user=0):
    """Skewed synthetic ratings (bench.py's generator at a small size);
    ``heavy_user`` > 0 gives user 0 that many extra entries, past the
    overflow length, so the heavy bucket and its virtual rows are used."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = np.minimum((n_items * rng.random(nnz) ** 2).astype(np.int32),
                   n_items - 1)
    r = rng.integers(1, 11, nnz).astype(np.float32) / 2.0
    if heavy_user:
        u = np.concatenate([u, np.zeros(heavy_user, np.int32)])
        i = np.concatenate([i, rng.integers(0, n_items, heavy_user)
                            .astype(np.int32)])
        r = np.concatenate([r, rng.integers(1, 11, heavy_user)
                            .astype(np.float32) / 2.0])
    return u, i, r, n_users, n_items


def _both(u, i, r, nu, ni, **kw):
    mesh = mesh_from_devices(devices=jax.devices()[:1])
    f_ref = ref_als.train_als(u, i, r, nu, ni, ref_als.ALSParams(**kw),
                              mesh=mesh)
    f_port = port_als.train_als(u, i, r, nu, ni, port_als.ALSParams(**kw),
                                device="cpu")
    return f_ref, f_port


def _assert_close(f_ref, f_port):
    assert f_port.user_factors.shape == f_ref.user_factors.shape
    assert f_port.item_factors.shape == f_ref.item_factors.shape
    np.testing.assert_allclose(f_port.user_factors, f_ref.user_factors,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(f_port.item_factors, f_ref.item_factors,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("scaling", ["plain", "nratings"])
@pytest.mark.parametrize("binary", [False, True])
def test_train_als_matches_reference(implicit, scaling, binary):
    u, i, r, nu, ni = _ratings()
    if binary:
        r = np.ones_like(r)
    f_ref, f_port = _both(u, i, r, nu, ni, rank=8, num_iterations=3,
                          reg=0.1, lambda_scaling=scaling,
                          implicit_prefs=implicit, alpha=0.5)
    _assert_close(f_ref, f_port)


@pytest.mark.parametrize("implicit", [False, True])
def test_heavy_bucket_with_overflow_rows(implicit):
    u, i, r, nu, ni = _ratings(n_users=30, n_items=100, nnz=2000,
                               heavy_user=4500)
    plan = port_rowblocks.plan_layout(np.bincount(u, minlength=nu))
    assert plan.has_heavy_bucket and plan.v_rows_per_shard == 2
    # reg 1.0: the heavy user's 4500 ratings make the item grams nearly
    # rank one; at reg 0.1 their conditioning alone puts two correct
    # float32 solvers (Cholesky, Gauss-Jordan) further apart than 2e-4
    f_ref, f_port = _both(u, i, r, nu, ni, rank=8, num_iterations=2,
                          reg=1.0, implicit_prefs=implicit, alpha=0.2)
    _assert_close(f_ref, f_port)


def test_explicit_chunk_budget_matches_reference():
    # chunkTiles × blockLen = 64 gathered entries per step: many small
    # chunks, and a slab that needs several gram steps
    u, i, r, nu, ni = _ratings(nnz=1500, seed=3)
    f_ref, f_port = _both(u, i, r, nu, ni, rank=6, num_iterations=2,
                          reg=0.05, chunk_tiles=8, block_len=8)
    _assert_close(f_ref, f_port)


@pytest.mark.parametrize("rank", [64, 128])
def test_wide_rank_matches_reference(rank):
    """The ranks the wide kernel serves on the card (32 < k ≤ 128); here
    the plain Gauss-Jordan that it repeats, held to the reference. Every
    row has fewer ratings than the rank, so its gram is singular but for
    the ridge; λ = 0.1·n_ratings keeps the conditioning where two correct
    float32 solvers agree to 2e-4 (at 0.01 they part by ~1e-3)."""
    u, i, r, nu, ni = _ratings(n_users=60, n_items=40, nnz=800, seed=9)
    f_ref, f_port = _both(u, i, r, nu, ni, rank=rank, num_iterations=2,
                          reg=0.1, lambda_scaling="nratings")
    _assert_close(f_ref, f_port)


@pytest.mark.parametrize("implicit", [False, True])
def test_solve_buffer_cap_keeps_factors_bit_identical(implicit, monkeypatch):
    """Solving a bucket in many small buffers or in one buffer gives the
    same factors bit for bit: every system is solved the same way."""
    u, i, r, nu, ni = _ratings(n_users=300, n_items=120, nnz=4000, seed=4)
    params = port_als.ALSParams(rank=8, num_iterations=2, reg=0.05,
                                implicit_prefs=implicit, alpha=0.3,
                                chunk_tiles=4, block_len=8)
    runs = {}
    for name, cap in (("small", 3 * 8 * 8 * 4), ("whole", 1 << 30)):
        monkeypatch.setattr(port_als, "_SOLVE_BUFFER_BYTES", cap)
        trainer = port_als.ALSTrainer(u, i, r, nu, ni, params, device="cpu")
        trainer.iterate(2)
        runs[name] = (trainer.x.clone(), trainer.y.clone(),
                      trainer.solve_calls_per_iteration())
    (x_s, y_s, calls_s), (x_w, y_w, calls_w) = runs["small"], runs["whole"]
    assert calls_s > calls_w
    assert calls_w == sum(
        len(plan.lengths) for plan in (trainer.plan_u, trainer.plan_i))
    assert torch.equal(x_s, x_w) and torch.equal(y_s, y_w)


def test_rank_above_128_uses_cholesky():
    u, i, r, nu, ni = _ratings(n_users=20, n_items=15, nnz=200, seed=5)
    f_ref, f_port = _both(u, i, r, nu, ni, rank=130, num_iterations=1,
                          reg=0.5)
    _assert_close(f_ref, f_port)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("with_val", [False, True])
def test_grams_rows_matches_reference(implicit, with_val):
    rng = np.random.default_rng(7)
    p = rng.standard_normal((5, 12, 6)).astype(np.float32)
    p[:, 9:] = 0.0  # padding slots gather zero rows
    val = (rng.integers(1, 11, (5, 12)).astype(np.float32) / 2.0
           if with_val else None)
    g_ref, b_ref = ref_als._grams_rows(
        jnp.asarray(p), None if val is None else jnp.asarray(val),
        implicit=implicit, alpha=0.7, compute_dtype=jnp.float32)
    g, b = port_als._grams_rows(
        torch.from_numpy(p), None if val is None else torch.from_numpy(val),
        implicit=implicit, alpha=0.7)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("heavy", [0, 4500])
def test_layout_is_the_references(heavy):
    """Same slot order, same slabs: the port's copy of rowblocks."""
    u, i, r, nu, ni = _ratings(n_users=30, n_items=300, nnz=800,
                               heavy_user=heavy)
    ref = ref_rowblocks.plan_and_fill_both(u, i, r, nu, ni, 1,
                                           parallel=False)
    port = port_rowblocks.plan_and_fill_both(u, i, r, nu, ni)
    for p_ref, p_port in zip(ref[:2], port[:2]):
        np.testing.assert_array_equal(p_port.slot_of_row, p_ref.slot_of_row)
        np.testing.assert_array_equal(p_port.lengths, p_ref.lengths)
        np.testing.assert_array_equal(p_port.bucket_rows, p_ref.bucket_rows)
        np.testing.assert_array_equal(p_port.v_parent, p_ref.v_parent)
    for a_ref, a_port in zip(ref[2:], port[2:]):
        for c_ref, c_port in zip(a_ref.cols, a_port.cols):
            np.testing.assert_array_equal(c_port, c_ref)
        for v_ref, v_port in zip(a_ref.vals, a_port.vals):
            np.testing.assert_array_equal(v_port, v_ref)
        np.testing.assert_array_equal(a_port.v_cols, a_ref.v_cols)


@pytest.mark.parametrize("heavy,chunk_tiles", [(0, -1), (4500, -1), (0, 4)])
def test_solve_calls_match_the_layout(heavy, chunk_tiles, monkeypatch):
    """The count chip_smoke.py holds the kernel launches to: one solve per
    fused chunk plus one for the heavy bucket, per side, per iteration."""
    u, i, r, nu, ni = _ratings(n_users=700, n_items=300, nnz=6000,
                               heavy_user=heavy)
    calls = []
    real = port_als.batched_spd_solve

    def counting(a, b):
        calls.append(a.shape[0])
        return real(a, b)

    monkeypatch.setattr(port_als, "batched_spd_solve", counting)
    params = port_als.ALSParams(rank=4, num_iterations=2,
                                chunk_tiles=chunk_tiles, block_len=8)
    trainer = port_als.ALSTrainer(u, i, r, nu, ni, params, device="cpu")
    trainer.iterate(2)
    assert trainer.solve_calls_per_iteration() > 2
    assert len(calls) == 2 * trainer.solve_calls_per_iteration()
    # a cap of 5 grams per solve buffer: one buffer per chunk (a buffer
    # holds at least one chunk), still the implied count
    default_calls = trainer.solve_calls_per_iteration()
    monkeypatch.setattr(port_als, "_SOLVE_BUFFER_BYTES", 5 * 4 * 4 * 4)
    calls.clear()
    trainer.iterate(1)
    assert trainer.solve_calls_per_iteration() >= default_calls
    assert len(calls) == trainer.solve_calls_per_iteration()


def test_fresh_init_is_the_references():
    u, i, r, nu, ni = _ratings()
    plans = port_rowblocks.plan_and_fill_both(u, i, r, nu, ni)
    params = dict(rank=5, seed=11)
    x_ref, y_ref = ref_als._fresh_init(ref_als.ALSParams(**params),
                                       plans[0], plans[1], nu, ni)
    x, y = port_als._fresh_init(port_als.ALSParams(**params), plans[0],
                                plans[1], nu, ni)
    np.testing.assert_array_equal(x, x_ref)
    np.testing.assert_array_equal(y, y_ref)


def test_unsupported_compute_dtype_raises():
    u, i, r, nu, ni = _ratings()
    with pytest.raises(ValueError, match="compute_dtype"):
        port_als.train_als(u, i, r, nu, ni,
                           port_als.ALSParams(compute_dtype="float16"),
                           device="cpu")


def test_train_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    u, i, r, nu, ni = _ratings()
    with pytest.raises(RuntimeError, match="cuda"):
        port_als.train_als(u, i, r, nu, ni, port_als.ALSParams())


def test_predict_rmse_matches_reference():
    u, i, r, nu, ni = _ratings()
    f_ref, f_port = _both(u, i, r, nu, ni, rank=8, num_iterations=5,
                          reg=0.1)
    assert port_als.predict_rmse(f_port, u, i, r) == pytest.approx(
        ref_als.predict_rmse(f_ref, u, i, r), rel=1e-4)


def test_timings_hook_fills_the_three_keys(tmp_path):
    """The benchmark's keys, from the product path (a dict planted on the
    context) and from train_als; left empty under the NaN guard and when
    more than one checkpoint chunk is left, as in the reference."""
    from incubator_predictionio_torch.controller import EngineParams
    from incubator_predictionio_torch.models import recommendation as rec
    from incubator_predictionio_torch.workflow.checkpoint import CheckpointHook
    from incubator_predictionio_torch.workflow.context import WorkflowContext

    keys = {"upload_seconds", "compile_seconds", "device_train_seconds"}
    u, i, r, nu, ni = _ratings()
    events = [{"event": "rate", "entityType": "user", "entityId": str(a),
               "targetEntityType": "item", "targetEntityId": str(b),
               "properties": {"rating": float(c)}}
              for a, b, c in zip(u, i, r)]
    ctx = WorkflowContext(events=events, device="cpu")
    ctx.bench_timings = {}
    rec.RecommendationEngine()().train(ctx, EngineParams.from_json(
        {"algorithms": [{"name": "als", "params": {"numIterations": 2}}]}))
    assert set(ctx.bench_timings) == keys
    assert all(v >= 0 for v in ctx.bench_timings.values())
    assert ctx.bench_timings["compile_seconds"] < 1.0  # no kernel on the CPU

    params = port_als.ALSParams(rank=4, num_iterations=4)
    for kw, filled in (({}, True), ({"nan_guard": True}, False),
                       ({"checkpoint_hook": CheckpointHook(
                           str(tmp_path / "a"), every_n=2)}, False),
                       ({"checkpoint_hook": CheckpointHook(
                           str(tmp_path / "b"), every_n=4)}, True)):
        timings = {}
        port_als.train_als(u, i, r, nu, ni, params, device="cpu",
                           timings=timings, **kw)
        assert set(timings) == (keys if filled else set()), kw


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("heavy", [0, 4500])
def test_uint16_column_narrowing_is_bit_identical(implicit, heavy,
                                                  monkeypatch):
    """Column slabs kept as 16-bit indices (the counterpart's sentinel slot
    fits) and widened per gathered chunk give the int32 run's factors bit
    for bit; a side whose counterpart is too wide keeps int32."""
    u, i, r, nu, ni = _ratings(n_users=30, n_items=100, nnz=2000,
                               heavy_user=heavy)
    params = port_als.ALSParams(rank=8, num_iterations=2, reg=0.1,
                                implicit_prefs=implicit, alpha=0.3)
    narrow = port_als.ALSTrainer(u, i, r, nu, ni, params, device="cpu")
    assert narrow.side_u.narrow and narrow.side_i.narrow
    assert all(c.dtype == torch.uint16 for c in narrow.side_u.cols)
    if heavy:
        assert narrow.side_u.v_cols.dtype == torch.uint16
    narrow.iterate(2)
    monkeypatch.setattr(port_als, "_NARROW_COL_MAX", -1)
    wide = port_als.ALSTrainer(u, i, r, nu, ni, params, device="cpu")
    assert not wide.side_u.narrow
    assert all(c.dtype != torch.uint16 for c in wide.side_u.cols)
    wide.iterate(2)
    assert torch.equal(narrow.x, wide.x) and torch.equal(narrow.y, wide.y)
    # the rule: narrow exactly when the counterpart's sentinel slot fits
    monkeypatch.setattr(port_als, "_NARROW_COL_MAX",
                        narrow.plan_i.total_slots)
    edge = port_als.ALSTrainer(u, i, r, nu, ni, params, device="cpu")
    assert edge.side_u.narrow == (narrow.plan_i.total_slots
                                  <= narrow.plan_i.total_slots)
    assert edge.side_i.narrow == (narrow.plan_u.total_slots
                                  <= narrow.plan_i.total_slots)


@pytest.mark.parametrize("parent", [
    [5, 5, 5, 2, 2, 9],                     # contiguous groups (the layout)
    [0, 3, 0, 1, 3, 3, 0, 7],               # interleaved repeats
    list(range(6)),                         # one chunk per parent
    [],
])
def test_overflow_merge_passes_equal_index_add_bit_for_bit(parent):
    """Adding the passes in turn gives exactly ``index_add_`` over all
    virtual rows at once (its CPU order), so the merge does not depend on
    the card's atomics."""
    rng = np.random.default_rng(len(parent))
    parent = np.asarray(parent, np.int64)
    src = torch.from_numpy(rng.standard_normal((len(parent), 4, 4))
                           .astype(np.float32) * 1e3)
    base = torch.from_numpy(rng.standard_normal((10, 4, 4))
                            .astype(np.float32))
    want = base.clone().index_add_(0, torch.from_numpy(parent), src)
    got = base.clone()
    passes = port_als.overflow_merge_passes(parent)
    for pos, dst in passes:
        assert len(np.unique(dst)) == len(dst)   # distinct targets
        got.index_add_(0, torch.from_numpy(dst),
                       src.index_select(0, torch.from_numpy(pos)))
    assert torch.equal(got, want)
    assert sum(len(p) for p, _ in passes) == len(parent)


def test_heavy_rows_train_as_with_one_index_add(monkeypatch):
    """A train whose heavy rows split into several virtual rows is bit
    identical to one that merges them with a single ``index_add_``."""
    u, i, r, nu, ni = _ratings(n_users=30, n_items=100, nnz=2000,
                               heavy_user=9000)
    plan = port_rowblocks.plan_layout(np.bincount(u, minlength=nu))
    assert plan.v_rows_per_shard >= 4
    params = port_als.ALSParams(rank=8, num_iterations=2, reg=1.0)
    got = port_als.train_als(u, i, r, nu, ni, params, device="cpu")
    monkeypatch.setattr(port_als, "overflow_merge_passes", lambda p: [
        (np.arange(len(p)), np.asarray(p, np.int64))])
    want = port_als.train_als(u, i, r, nu, ni, params, device="cpu")
    assert np.array_equal(got.user_factors, want.user_factors)
    assert np.array_equal(got.item_factors, want.item_factors)
