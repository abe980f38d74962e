"""The port's ALS under ``compute_dtype="bfloat16"`` (``ops/als.py``:
``_bf16_weights``, ``_grams_rows_bf16``, ``_compute_rows``) on the CPU, held against the JAX
reference's bfloat16 ALS and against the port's own one-process train.

The rounding points are the reference's as its CPU computes them: the
counterpart factors rounded once per half-step, every weight rounded
before it multiplies, every product and sum in float32. Tolerances, each
stated where it is used:

- the grams and right-hand sides equal the reference's (its
  ``_grams_rows`` jitted, as its training loop runs it: eagerly JAX would
  round ``p·weight`` to bfloat16, which XLA does not inside the loop)
  within 1e-6 relative;
- whole trains at the reference's toy size (rank 8, 3 iterations) within
  the reference's own bf16 tolerance, rtol 2e-3 / atol 2e-4
  (tests/test_als_bf16.py);
- at rank 32, and across gangs (other float32 summation orders), a
  relative-norm gap of 1e-2: a float32 difference of ~1e-6 flips a few
  bfloat16 roundings of the counterpart rows, and the flips add up over
  the iterations;
- the reference's rule for bf16 against float32: max gap < 0.05 × the
  largest float32 factor.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.ops import als as ref_als  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import mesh_from_devices  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.models import ecommerce as port_ec  # noqa: E402
from incubator_predictionio_torch.models import recommendation as port_rec  # noqa: E402
from incubator_predictionio_torch.models import similar_product as port_sp  # noqa: E402
from incubator_predictionio_torch.ops import als as port_als  # noqa: E402
from incubator_predictionio_torch.ops import rowblocks as port_rowblocks  # noqa: E402
from incubator_predictionio_torch.tools import console  # noqa: E402
from incubator_predictionio_torch.workflow import model_artifact  # noqa: E402
from incubator_predictionio_torch.workflow.checkpoint import CheckpointHook  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.persist import models_from_bytes  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_slab_worker as W  # noqa: E402

BF16 = "bfloat16"
#: the reference's bf16 tolerance (tests/test_als_bf16.py)
RTOL, ATOL = 2e-3, 2e-4
#: rank 32 and the gangs: relative-norm gap
REL_NORM = 1e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSOLE = [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]


def _ratings(n_users=60, n_items=40, nnz=900, seed=0, heavy_user=0):
    """tests/test_torch_als.py's skewed ratings; ``heavy_user`` > 0 gives
    user 0 that many extra entries (the heavy bucket)."""
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


def _toy(seed=0, n_users=40, n_items=25, nnz=900):
    """tests/test_als_bf16.py's _toy."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = rng.integers(0, n_items, nnz).astype(np.int32)
    r = (rng.integers(1, 11, nnz) / 2.0).astype(np.float32)
    return u, i, r, n_users, n_items


def _ref(u, i, r, nu, ni, **kw):
    mesh = mesh_from_devices(devices=jax.devices()[:1])
    return ref_als.train_als(u, i, r, nu, ni, ref_als.ALSParams(**kw),
                             mesh=mesh)


def _port(u, i, r, nu, ni, **kw):
    return port_als.train_als(u, i, r, nu, ni, port_als.ALSParams(**kw),
                              device="cpu")


def _rel_norm(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _gap(fa, fb) -> float:
    return max(_rel_norm(fa.user_factors, fb.user_factors),
               _rel_norm(fa.item_factors, fb.item_factors))


def _assert_equal(fa, fb):
    np.testing.assert_array_equal(fa.user_factors, fb.user_factors)
    np.testing.assert_array_equal(fa.item_factors, fb.item_factors)


# -- the rounding points ------------------------------------------------------


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("with_val", [False, True])
def test_grams_rows_bf16_matches_reference(implicit, with_val):
    """All four modes (explicit, explicit binary, implicit binary, implicit
    weighted) within 1e-6 relative of the reference's jitted bf16 form."""
    rng = np.random.default_rng(7)
    p = (rng.standard_normal((6, 14, 8)) / 3).astype(np.float32)
    p[:, 11:] = 0.0  # padding slots gather the zero sentinel row
    p16 = torch.from_numpy(p).to(torch.bfloat16)
    val = (rng.integers(1, 11, (6, 14)).astype(np.float32) / 2.0
           if with_val else None)
    fn = jax.jit(lambda p, v: ref_als._grams_rows(
        p, v, implicit=implicit, alpha=0.7, compute_dtype=jnp.bfloat16))
    g_ref, b_ref = (np.asarray(x) for x in fn(
        jnp.asarray(p16.float().numpy()).astype(jnp.bfloat16),
        None if val is None else jnp.asarray(val)))
    params = port_als.ALSParams(implicit_prefs=implicit, alpha=0.7,
                                compute_dtype=BF16)
    g, b = port_als._grams_rows_bf16(
        p16, None if val is None else port_als._bf16_weights(val, params),
        implicit=implicit, alpha=0.7)
    assert g.dtype == b.dtype == torch.float32
    for got, want in ((g.numpy(), g_ref), (b.numpy(), b_ref)):
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_compute_rows_round_once_and_keep_float32_bits():
    """float32 gathers the stored rows as they are; bfloat16 rounds them
    (the sentinel zero row too) and sums YᵀY in float32 from the rounded
    rows, as the reference's y_cd."""
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal((9, 5)).astype(np.float32))
    y[-1] = 0.0
    f32 = port_als.ALSParams(rank=5, implicit_prefs=True,
                             compute_dtype="float32")
    rows, yty = port_als._compute_rows(y, f32)
    assert rows is y and torch.equal(yty, y.T @ y)
    rows, yty = port_als._compute_rows(
        y, port_als.ALSParams(rank=5, implicit_prefs=True, compute_dtype=BF16))
    assert rows.dtype == torch.bfloat16 and not rows[-1].any()
    y_cd = jnp.asarray(y.numpy()).astype(jnp.bfloat16)
    want = np.asarray(jnp.einsum("nk,nm->km", y_cd, y_cd,
                                 preferred_element_type=jnp.float32))
    np.testing.assert_array_equal(rows.float().numpy(),
                                  np.asarray(y_cd.astype(jnp.float32)))
    np.testing.assert_allclose(yty.numpy(), want, rtol=1e-6, atol=1e-6)
    rows, yty = port_als._compute_rows(y, port_als.ALSParams(
        rank=5, compute_dtype=BF16))
    assert rows.dtype == torch.bfloat16 and yty is None


@pytest.mark.parametrize("implicit", [False, True])
def test_sides_hold_weights_rounded_once(implicit):
    """Under bfloat16 a trainer's value slabs, the heavy bucket's too, are
    the rounded weights (``val``; or ``alpha·val`` and ``1 + alpha·val``)
    from when it was built, so no chunk rounds them again; under float32
    they are the ratings as given."""
    u, i, r, nu, ni = _case_data(heavy=True)
    kw = dict(rank=4, implicit_prefs=implicit, alpha=0.7)
    t32 = port_als.ALSTrainer(u, i, r, nu, ni, port_als.ALSParams(**kw),
                              device="cpu")
    t16 = port_als.ALSTrainer(u, i, r, nu, ni, port_als.ALSParams(
        **kw, compute_dtype=BF16), device="cpu")
    assert t16.plan_u.has_heavy_bucket
    for a, b in zip(t32.side_u.vals + [t32.side_u.v_vals],
                    t16.side_u.vals + [t16.side_u.v_vals]):
        assert a.dtype == b.dtype == torch.float32
        if implicit:
            want = torch.stack([(0.7 * a).to(torch.bfloat16).float(),
                                (1.0 + 0.7 * a).to(torch.bfloat16).float()],
                               dim=1)
        else:
            want = a.to(torch.bfloat16).float()
        assert torch.equal(b, want)


def test_params_accept_bfloat16_and_refuse_other_dtypes():
    """'auto' resolves to float32 (the reference's rule off a TPU), and a
    dtype the port does not compute in raises, naming it."""
    for given, want in (("auto", "float32"), ("float32", "float32"),
                        (BF16, BF16)):
        p, _ = port_als._resolve_params(port_als.ALSParams(compute_dtype=given))
        assert p.compute_dtype == want
    for bad in ("float16", "fp8", "BF16"):
        with pytest.raises(ValueError, match=repr(bad)):
            port_als._resolve_params(port_als.ALSParams(compute_dtype=bad))


# -- the reference's two bf16 tests, on the port -------------------------------


def test_bf16_chunked_matches_bf16_unchunked():
    """tests/test_als_bf16.py's chunk invariance, rtol 2e-3 / atol 2e-4."""
    u, i, r, nu, ni = _toy()
    base = dict(rank=8, num_iterations=3, reg=0.05, compute_dtype=BF16)
    out_a = _port(u, i, r, nu, ni, **base)
    out_b = _port(u, i, r, nu, ni, **base, block_len=8, chunk_tiles=4)
    np.testing.assert_allclose(out_a.user_factors, out_b.user_factors,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_a.item_factors, out_b.item_factors,
                               rtol=RTOL, atol=ATOL)


def test_bf16_close_to_f32():
    """tests/test_als_bf16.py's rule: max gap < 0.05 × the largest float32
    factor."""
    u, i, r, nu, ni = _toy(seed=3)
    kw = dict(rank=8, num_iterations=3, reg=0.05)
    f32 = _port(u, i, r, nu, ni, **kw, compute_dtype="float32")
    bf16 = _port(u, i, r, nu, ni, **kw, compute_dtype=BF16)
    scale = np.abs(f32.user_factors).max()
    err = np.abs(f32.user_factors - bf16.user_factors).max()
    assert err < 0.05 * scale, f"bf16 drifted too far: {err} vs {scale}"
    assert not np.array_equal(f32.user_factors, bf16.user_factors)


# -- the port against the reference ---------------------------------------------


CASES = {
    "explicit": (dict(), dict(reg=0.05)),
    "nratings": (dict(), dict(reg=0.05, lambda_scaling="nratings")),
    "implicit": (dict(), dict(reg=0.05, implicit_prefs=True, alpha=0.5)),
    # all-ones explicit ratings at plain λ make nearly singular systems
    # (every direction but one held by λ alone), which amplify the flipped
    # bf16 roundings past the tolerance: this case takes λ·n_ratings, as
    # the float32 parity tests do
    "binary": (dict(binary=True), dict(reg=0.05, lambda_scaling="nratings")),
    "implicit_binary": (dict(binary=True),
                        dict(reg=0.05, implicit_prefs=True, alpha=2.0)),
    "heavy": (dict(heavy=True), dict(reg=0.1, lambda_scaling="nratings")),
    "heavy_implicit": (dict(heavy=True),
                       dict(reg=0.1, implicit_prefs=True, alpha=0.5)),
}


def _case_data(binary=False, heavy=False):
    if heavy:
        u, i, r, nu, ni = _ratings(n_users=30, n_items=100, nnz=2000,
                                   heavy_user=4500)
        plan = port_rowblocks.plan_layout(np.bincount(u, minlength=nu))
        assert plan.has_heavy_bucket and plan.v_rows_per_shard >= 2
    else:
        u, i, r, nu, ni = _toy()
    if binary:
        r = np.ones_like(r)
    return u, i, r, nu, ni


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_train_matches_reference(case):
    """The port's bf16 train against the reference's at the toy size (rank
    8, 3 iterations): rtol 2e-3 / atol 2e-4."""
    data_kw, kw = CASES[case]
    u, i, r, nu, ni = _case_data(**data_kw)
    kw = dict(kw, rank=8, num_iterations=3, compute_dtype=BF16)
    want = _ref(u, i, r, nu, ni, **kw)
    got = _port(u, i, r, nu, ni, **kw)
    np.testing.assert_allclose(got.user_factors, want.user_factors,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.item_factors, want.item_factors,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["nratings", "implicit", "implicit_binary"])
def test_bf16_rank32_matches_reference_by_relative_norm(case):
    """Rank 32, 300 × 200 × 8,000, 5 iterations, well conditioned: the
    relative-norm gap to the reference's bf16 train is at most 1e-2; the
    float32 gap of the same inputs is reported beside it (≈ 1e-5)."""
    _, kw = CASES[case]
    u, i, r, nu, ni = _ratings(n_users=300, n_items=200, nnz=8000, seed=5)
    if case == "implicit_binary":
        r = np.ones_like(r)
    kw = dict(kw, rank=32, num_iterations=5)
    gaps = {}
    for dtype in ("float32", BF16):
        gaps[dtype] = _gap(_port(u, i, r, nu, ni, **kw, compute_dtype=dtype),
                           _ref(u, i, r, nu, ni, **kw, compute_dtype=dtype))
    print(f"rank 32 {case}: relative-norm gap to the reference {gaps}")
    assert gaps[BF16] <= REL_NORM, gaps
    assert gaps["float32"] <= gaps[BF16], gaps


# -- the gangs ------------------------------------------------------------------


def _gang_factors(out, world, runs, mesh=""):
    got = W.run_gang(world, str(out), ",".join(runs), mesh=mesh,
                     timeout_s=120.0)
    for rank, (rc, _, err) in enumerate(got):
        assert rc == 0, f"rank {rank} exited {rc}: {err[-3000:]}"
    return dict(np.load(out))


@pytest.fixture(scope="module")
def gang_1d(tmp_path_factory):
    return _gang_factors(tmp_path_factory.mktemp("bf16_1d") / "f.npz", 2,
                         RUNS_1D)


@pytest.fixture(scope="module")
def gang_2d(tmp_path_factory):
    return _gang_factors(tmp_path_factory.mktemp("bf16_2d") / "f.npz", 4,
                         RUNS_2D, mesh="2x2")


RUNS_1D = ("merged:bf16", "merged:bf16_implicit", "sharded:bf16",
           "sharded:bf16_heavy", "dp:bf16", "dp:bf16_implicit")
RUNS_2D = ("merged:bf16", "merged:bf16_implicit", "sharded:bf16_heavy")


def _hold_gang(factors, run):
    """A gang's bf16 factors within a relative norm of 1e-2 of the port's
    one-process bf16 train of the union triple."""
    mode = run.split(":")[1]
    u, i, r, nu, ni = W.data(mode)
    want = port_als.train_als(u, i, r, nu, ni,
                              port_als.ALSParams(**W.params(mode)),
                              device="cpu")
    got = port_als.ALSFactors(factors[f"{run}:user"], factors[f"{run}:item"],
                              nu, ni)
    assert _gap(got, want) <= REL_NORM, _gap(got, want)


@pytest.mark.parametrize("run", RUNS_1D)
def test_one_d_and_data_parallel_gangs_in_bf16(gang_1d, run):
    """The 1-D slab gang (merged feed), ``train_als_process_sharded`` and
    ``DataParallelALS`` (the partition feed), two ranks, in bf16."""
    _hold_gang(gang_1d, run)


@pytest.mark.parametrize("run", RUNS_2D)
def test_two_d_alx_gang_in_bf16(gang_2d, run):
    """The (2, 2) ALX layout (the masked gather of a model block, the model
    group's sum of the float32 YᵀY) and process-sharded on it, in bf16."""
    _hold_gang(gang_2d, run)


# -- checkpoint, launches, fold-in ----------------------------------------------


def test_bf16_checkpoint_resume_is_bit_identical(tmp_path):
    """Interrupted after 4 of 6 iterations (snapshot at 2), resumed →
    the uninterrupted bf16 train, bit for bit; the snapshots hold float32
    factors."""
    u, i, r, nu, ni = _toy(seed=5)
    kw = dict(rank=4, num_iterations=6, reg=0.05, seed=11, compute_dtype=BF16)
    full = _port(u, i, r, nu, ni, **kw)
    hook = CheckpointHook(str(tmp_path / "ck"), every_n=2, max_to_keep=5)
    port_als.train_als(u, i, r, nu, ni, port_als.ALSParams(
        **dict(kw, num_iterations=4)), device="cpu", checkpoint_hook=hook)
    assert hook.latest_step() == 2
    _, tree = hook.restore(2)
    assert tree["user_factors"].dtype == np.float32
    resumed = port_als.train_als(u, i, r, nu, ni, port_als.ALSParams(**kw),
                                 device="cpu", checkpoint_hook=hook,
                                 resume=True)
    _assert_equal(resumed, full)
    # a float32 snapshot chain of the same data gives other factors
    assert not np.array_equal(
        _port(u, i, r, nu, ni, **dict(kw, compute_dtype="float32"))
        .user_factors, full.user_factors)


def test_bf16_nan_guard_and_timings_run_unchanged():
    u, i, r, nu, ni = _toy(seed=2)
    p = port_als.ALSParams(rank=4, num_iterations=3, reg=0.05,
                           compute_dtype=BF16)
    timings = {}
    plain = port_als.train_als(u, i, r, nu, ni, p, device="cpu",
                               timings=timings)
    assert set(timings) == {"upload_seconds", "compile_seconds",
                            "device_train_seconds"}
    guarded = port_als.train_als(u, i, r, nu, ni, p, device="cpu",
                                 nan_guard=True)
    _assert_equal(guarded, plain)


def test_bf16_chunk_sizing_uses_two_bytes_an_element(monkeypatch):
    """``_fused_chunk_rows`` sizes a bf16 slab at 2 bytes an element (the
    reference's cd_bytes), and the counted solve calls equal
    ``solve_calls_per_half_step`` under bf16 — where that count differs
    from float32's."""
    assert port_als._fused_chunk_rows(8192, 128, None, 4) == 128
    assert port_als._fused_chunk_rows(8192, 128, None, 2) == 256
    u, i, r, nu, ni = _ratings(n_users=700, n_items=300, nnz=6000)
    # a slab cap that binds at these widths, one chunk per solve buffer
    monkeypatch.setattr(port_als, "_FUSED_SLAB_BYTES", 64 * 8 * 4 * 4)
    monkeypatch.setattr(port_als, "_SOLVE_BUFFER_BYTES", 1)
    calls = []
    real = port_als.batched_spd_solve

    def counting(a, b):
        calls.append(a.shape[0])
        return real(a, b)

    monkeypatch.setattr(port_als, "batched_spd_solve", counting)
    implied = {}
    for dtype in ("float32", BF16):
        params = port_als.ALSParams(rank=4, num_iterations=1,
                                    compute_dtype=dtype)
        trainer = port_als.ALSTrainer(u, i, r, nu, ni, params, device="cpu")
        calls.clear()
        trainer.iterate(1)
        implied[dtype] = trainer.solve_calls_per_iteration()
        assert len(calls) == implied[dtype]
    assert implied[BF16] < implied["float32"], implied


def test_fold_in_on_a_bf16_model_is_the_references_float32_fold_in():
    """A bf16-trained Recommendation model's fold-in runs in float32,
    whatever the train used: it equals the reference's float32
    ``fold_in_factors`` on the same factors within 2e-4."""
    u, i, r, nu, ni = _toy(seed=4)
    f = _port(u, i, r, nu, ni, rank=8, num_iterations=3, reg=0.1,
              compute_dtype=BF16)
    rng = np.random.default_rng(9)
    idx = [rng.integers(0, ni, n) for n in (3, 7, 12)]
    val = [(rng.integers(1, 11, len(x)) / 2.0).astype(np.float32)
           for x in idx]
    kw = dict(reg=0.1, lambda_scaling="nratings")
    want = ref_als.fold_in_factors(f.item_factors, idx, val, **kw)
    got = port_als.fold_in_factors(f.item_factors, idx, val, device="cpu",
                                   **kw)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# -- the templates, through the verbs ---------------------------------------------


@pytest.fixture()
def basedir(tmp_path, monkeypatch):
    """An empty default store at $PIO_FS_BASEDIR/pio.sqlite."""
    base = tmp_path / "base"
    monkeypatch.setenv("PIO_FS_BASEDIR", str(base))
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    Storage.reset_instance()
    yield base
    Storage.reset_instance()


def _wire(template: str) -> list:
    """Seeded wire events: ratings (Recommendation) or views, buys and
    item categories (Similar-Product, E-Commerce)."""
    rng = np.random.default_rng(21)
    evs = []
    for j in range(600):
        u, it = int(rng.integers(0, 40)), int(30 * rng.random() ** 1.5)
        if template == "recommendation":
            evs.append({"event": "rate", "entityType": "user",
                        "entityId": f"u{u}", "targetEntityType": "item",
                        "targetEntityId": f"i{it}",
                        "properties": {"rating": float(rng.integers(1, 6))},
                        "eventTime": f"2024-01-01T00:{j // 60:02d}:"
                                     f"{j % 60:02d}.000Z"})
        else:
            evs.append({"event": "buy" if j % 9 == 0 else "view",
                        "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "item", "targetEntityId": f"i{it}",
                        "eventTime": f"2024-01-01T00:{j // 60:02d}:"
                                     f"{j % 60:02d}.000Z"})
    if template != "recommendation":
        evs += [{"event": "$set", "entityType": "item", "entityId": f"i{j}",
                 "properties": {"categories": [f"c{j % 3}"]},
                 "eventTime": "2023-12-31T00:00:00.000Z"} for j in range(30)]
    return evs


TEMPLATES = {
    "recommendation": (port_rec.RecommendationEngine,
                       "recommendation.RecommendationEngine", "als",
                       {"rank": 8, "numIterations": 3, "lambda": 0.05}),
    "similar_product": (port_sp.SimilarProductEngine,
                        "similar_product.SimilarProductEngine", "als",
                        {"rank": 8, "numIterations": 3, "lambda": 0.05}),
    "ecommerce": (port_ec.ECommerceEngine, "ecommerce.ECommerceEngine",
                  "ecomm", {"appName": "bfapp", "rank": 8,
                            "numIterations": 3, "lambda": 0.05}),
}


def _engine_json(template: str, dtype: str = BF16) -> dict:
    _, factory, name, algo = TEMPLATES[template]
    return {"id": "default",
            "engineFactory": "incubator_predictionio_torch.models." + factory,
            "datasource": {"params": {"appName": "bfapp"}},
            "algorithms": [{"name": name,
                            "params": dict(algo, computeDtype=dtype)}]}


def _verb(args, capsys) -> str:
    rc = console.main(args)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    return out.out


def _seed_app(tmp_path, template, capsys):
    _verb(["app", "new", "bfapp"], capsys)
    events = tmp_path / "ev.jsonl"
    events.write_text("\n".join(json.dumps(e) for e in _wire(template)))
    _verb(["import", "--app-name", "bfapp", "--input", str(events)], capsys)


@pytest.mark.parametrize("template", list(TEMPLATES))
def test_template_trains_bf16_through_pio_train(template, basedir, tmp_path,
                                                capsys):
    """``"computeDtype": "bfloat16"`` in engine.json trains through ``pio
    train --device cpu``; the persisted factors equal the direct bf16
    ``train_als`` of the template's training data, bit for bit, and differ
    from float32's."""
    _seed_app(tmp_path, template, capsys)
    edir = tmp_path / "engine"
    edir.mkdir()
    ej = _engine_json(template)
    (edir / "engine.json").write_text(json.dumps(ej))
    out = _verb(["train", "--engine-dir", str(edir), "--device", "cpu"],
                capsys)
    iid = json.loads(out.strip().splitlines()[-1])["engineInstanceId"]
    store = Storage.instance()
    _, persisted = models_from_bytes(model_artifact.read_model(store, iid))
    stored = persisted[0]

    engine_cls = TEMPLATES[template][0]
    engine = engine_cls()()
    params = EngineParams.from_json(ej)
    ds, prep, algo_list, _ = engine.make_components(params)
    ctx = WorkflowContext(app_name="bfapp", storage=store, device="cpu")
    pd = prep.prepare(ctx, ds.read_training(ctx))
    p = algo_list[0][1].params
    if template == "recommendation":
        als_params = port_rec.ALSAlgorithm.als_params(p)
    else:
        als_params = port_als.ALSParams(
            rank=p.rank, num_iterations=p.num_iterations, reg=p.reg,
            implicit_prefs=True, alpha=p.alpha, seed=3,
            compute_dtype=p.compute_dtype, chunk_tiles=p.chunk_tiles)
    assert als_params.compute_dtype == BF16
    want = port_als.train_als(pd.user_idx, pd.item_idx, pd.rating,
                              len(pd.users), len(pd.items), als_params,
                              device="cpu")
    np.testing.assert_array_equal(stored["user_factors"], want.user_factors)
    np.testing.assert_array_equal(stored["item_factors"], want.item_factors)
    f32 = port_als.train_als(
        pd.user_idx, pd.item_idx, pd.rating, len(pd.users), len(pd.items),
        dataclasses.replace(als_params, compute_dtype="float32"),
        device="cpu")
    assert not np.array_equal(stored["item_factors"], f32.item_factors)


_BF16_PARAMS = '''
from incubator_predictionio_torch.controller import (
    EngineParams, EngineParamsGenerator,
)


class ParamsList(EngineParamsGenerator):
    def __init__(self):
        self.engine_params_list = [EngineParams.from_json(
            {{"datasource": {{"params": {{"appName": "bfapp"}}}},
              "algorithms": [{{"name": "{name}", "params": {{{extra}
                  "rank": r, "numIterations": 3,
                  "lambda": 0.05, "computeDtype": "bfloat16"}}}}]}})
            for r in (4, 8)]
'''


@pytest.mark.parametrize("template,evaluation", [
    ("recommendation", "recommendation_eval.RecommendationEvaluation"),
    ("ecommerce", "template_evals.ECommerceEvaluation"),
])
def test_template_evaluates_bf16_through_pio_eval(template, evaluation,
                                                  basedir, tmp_path, capsys,
                                                  monkeypatch):
    """``pio eval --device cpu`` over candidates whose engine params say
    ``"computeDtype": "bfloat16"``: every candidate trains on the bf16
    grams and is scored."""
    _seed_app(tmp_path, template, capsys)
    edir = tmp_path / "engine"
    edir.mkdir()
    module = f"bf16_{template}_params"
    (edir / f"{module}.py").write_text(
        _BF16_PARAMS.format(name=TEMPLATES[template][2], extra=(
            '"appName": "bfapp",' if template == "ecommerce" else "")))
    seen = []
    real = port_als._grams_rows_bf16

    def counting(*a, **kw):
        seen.append(a[0].dtype)
        return real(*a, **kw)

    monkeypatch.setattr(port_als, "_grams_rows_bf16", counting)
    try:
        out = _verb(["eval", "incubator_predictionio_torch.models."
                     + evaluation, f"{module}.ParamsList", "--engine-dir",
                     str(edir), "--app-name", "bfapp", "--device", "cpu"],
                    capsys)
    finally:
        sys.modules.pop(module, None)
    report = json.loads(out.strip().splitlines()[-1])
    assert report["candidates"] == 2 and report["device"] == "cpu"
    assert all(0.0 <= s <= 1.0 for s in report["scores"])
    assert seen and set(seen) == {torch.bfloat16}


def test_alx_gang_trains_bf16_through_pio_train(tmp_path):
    """``PIO_MESH_SHAPE=2x2 pio train --num-workers 4 --feed merged`` of the
    Recommendation template with ``"computeDtype": "bfloat16"`` (the gang
    chip_smoke.py runs on the card): within a relative norm of 1e-2 of the
    port's one-process bf16 train of the merged read."""
    from incubator_predictionio_torch.data.store import PEventStore

    base = str(tmp_path / "store")
    os.makedirs(base)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_"))}
    env.update({"PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
                "PIO_FS_BASEDIR": base, "PIO_WORKER_HEARTBEAT_MS": "100",
                "PIO_SUPERVISOR_POLL_MS": "25",
                "PIO_WORKER_INIT_GRACE_MS": "40000"})
    events = tmp_path / "ev.jsonl"
    events.write_text("\n".join(json.dumps(e)
                                for e in _wire("recommendation")))
    for args in (["app", "new", "bfapp"],
                 ["import", "--app-name", "bfapp", "--input", str(events)]):
        out = subprocess.run(CONSOLE + args, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
    ej = _engine_json("recommendation")
    ej["algorithms"][0]["params"].update(lambdaScaling="nratings", seed=5)
    (tmp_path / "engine.json").write_text(json.dumps(ej))
    out = subprocess.run(
        CONSOLE + ["train", "--num-workers", "4", "--feed", "merged",
                   "--device", "cpu"], env=dict(env, PIO_MESH_SHAPE="2x2"),
        cwd=str(tmp_path), capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["state"] == "completed" and len(report["workers"]) == 4
    assert all(w["timings"]["mesh"] == [2, 2] for w in report["workers"])
    store = Storage({f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S"
                     for r in ("METADATA", "EVENTDATA", "MODELDATA")}
                    | {"PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
                       "PIO_STORAGE_SOURCES_S_PATH":
                       os.path.join(base, "pio.sqlite")})
    _, persisted = models_from_bytes(model_artifact.read_model(
        store, report["engineInstanceId"]))
    u, i, r, users, items = PEventStore.find_ratings(
        "bfapp", event_names=["rate", "buy"], storage=store)
    store.close()
    want = port_als.train_als(u, i, r, len(users), len(items),
                              port_als.ALSParams(
                                  rank=8, num_iterations=3, reg=0.05,
                                  lambda_scaling="nratings", seed=5,
                                  compute_dtype=BF16), device="cpu")
    got = port_als.ALSFactors(persisted[0]["user_factors"],
                              persisted[0]["item_factors"],
                              len(users), len(items))
    assert _gap(got, want) <= REL_NORM, _gap(got, want)


# -- on the card --------------------------------------------------------------------


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("with_val", [False, True])
def test_card_bf16_grams_match_the_cpu(card, implicit, with_val):
    """The card's bf16 grams and right-hand sides (the same upcast
    arithmetic in another float32 summation order) within 1e-5 relative
    of the CPU's on the same bf16 rows and rounded weights."""
    rng = np.random.default_rng(1)
    p = torch.from_numpy((rng.standard_normal((512, 40, 32)) / 6).astype(
        np.float32)).to(torch.bfloat16)
    w = None
    if with_val:
        w = port_als._bf16_weights(
            rng.integers(1, 11, (512, 40)).astype(np.float32) / 2.0,
            port_als.ALSParams(implicit_prefs=implicit, alpha=0.7,
                               compute_dtype=BF16))
    got = port_als._grams_rows_bf16(
        p.to(card), None if w is None else w.to(card), implicit=implicit,
        alpha=0.7)
    want = port_als._grams_rows_bf16(p, w, implicit=implicit, alpha=0.7)
    for a, b in zip(got, want):
        assert float((a.cpu() - b).norm() / b.norm()) <= 1e-5
