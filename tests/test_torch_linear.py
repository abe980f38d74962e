"""The port's linear models (``incubator_predictionio_torch/ops/linear.py``)
on the CPU against the JAX reference (``incubator_predictionio_tpu/ops/
linear.py``), on the same seeded numpy inputs:

- Naive Bayes statistics, dense (one-hot matmul) and COO (``index_add_``),
  bit-identical to ``_nb_stats`` / ``_nb_stats_coo``, and the trained models
  (with and without the idf column scale) equal array for array;
- ``nb_fold_in`` exact, an entity's replacement included; ``lr_sgd_steps``
  within 1e-6; ``rebatch_entries`` the same chunks;
- the torch L-BFGS against ``_lr_fit``: where the reference's stop rule
  ends the loop, the iteration count within ±2 of the reference's; in
  every case the final loss within 1e-5 relative, the weights within 1e-3
  relative norm and the same predictions;
- the trainers need a card unless the CPU is asked for.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.ops import linear as ref  # noqa: E402
from incubator_predictionio_tpu.workflow.input_pipeline import (  # noqa: E402
    PipelineConfig,
)
from incubator_predictionio_torch.ops import linear as port  # noqa: E402
from lbfgs_stop import ref_stop  # noqa: E402

#: the single-shot reference paths (the streamed ones are proven equal to
#: them by the reference's own tests)
SERIAL = PipelineConfig(mode="off")
LOSS_RTOL = 1e-5
WEIGHT_RTOL = 1e-3
ITER_SLACK = 2


def _counts(n, d, c, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.random((c, d)) * 3 + 0.5
    y = rng.integers(0, c, n).astype(np.int32)
    x = (rng.poisson(centers[y]) * scale).astype(np.float32)
    return x, y


def _coo(n_docs, d, c, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 12, n_docs)
    doc_ptr = np.r_[0, np.cumsum(lens)].astype(np.int64)
    feat = np.concatenate([np.sort(rng.choice(d, k, replace=False))
                           for k in lens]).astype(np.int32)
    cnt = rng.integers(1, 6, len(feat)).astype(np.float32)
    y = rng.integers(0, c, n_docs).astype(np.int32)
    return doc_ptr, feat, cnt, y


def _nb_arrays(m):
    return [m.log_prior, m.log_likelihood, m.feat_counts, m.class_counts]


def _same_nb(got, want):
    for a, b in zip(_nb_arrays(got), _nb_arrays(want)):
        if b is None:
            assert a is None
        else:
            assert a.dtype == np.asarray(b).dtype
            assert np.array_equal(a, np.asarray(b))
    assert got.n_classes == want.n_classes
    assert got.smoothing == want.smoothing


@pytest.mark.parametrize("n,d,c,seed", [(300, 4, 3, 0), (257, 17, 5, 1)])
def test_dense_nb_stats_are_the_references_bit_for_bit(n, d, c, seed):
    x, y = _counts(n, d, c, seed)
    feat, counts = port.nb_stats(x, y, c, device="cpu")
    w = np.ones(n, np.float32)
    rfeat, rcounts = jax.device_get(ref._nb_stats(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), c))
    assert feat.dtype == counts.dtype == np.float32
    assert np.array_equal(feat, np.asarray(rfeat))
    assert np.array_equal(counts, np.asarray(rcounts))


@pytest.mark.parametrize("scaled", [False, True])
def test_train_naive_bayes_equals_the_reference(scaled):
    x, y = _counts(300, 6, 3, 2)
    scale = (np.random.default_rng(9).random(6) + 0.5).astype(np.float32) \
        if scaled else None
    got = port.train_naive_bayes(x, y, 3, smoothing=0.5, col_scale=scale,
                                 device="cpu")
    want = ref.train_naive_bayes(x, y, 3, smoothing=0.5, col_scale=scale,
                                 pipeline=SERIAL)
    _same_nb(got, want)
    assert np.array_equal(got.predict_log_joint(x), want.predict_log_joint(x))


@pytest.mark.parametrize("scaled", [False, True])
def test_coo_nb_stats_and_model_are_the_references(scaled):
    doc_ptr, feat, cnt, y = _coo(200, 64, 4, 3)
    cls = np.repeat(y, np.diff(doc_ptr))
    got = port.nb_stats_coo(cls, feat, cnt, 4, 64, device="cpu")
    want = np.asarray(jax.device_get(ref._nb_stats_coo(
        jnp.asarray(cls), jnp.asarray(feat), jnp.asarray(cnt), 4, 64)))
    assert got.dtype == np.float32 and np.array_equal(got, want)
    scale = (np.random.default_rng(4).random(64) + 0.1).astype(np.float32) \
        if scaled else None
    m = port.train_naive_bayes_coo(doc_ptr, feat, cnt, y, 4, 64,
                                   smoothing=1.0, col_scale=scale,
                                   device="cpu")
    r = ref.train_naive_bayes_coo(doc_ptr, feat, cnt, y, 4, 64,
                                  smoothing=1.0, col_scale=scale,
                                  pipeline=SERIAL)
    _same_nb(m, r)


def test_nb_fold_in_is_exact_with_replacement():
    x, y = _counts(200, 5, 3, 5)
    base_p = port.train_naive_bayes(x, y, 3, device="cpu")
    base_r = ref.train_naive_bayes(x, y, 3, pipeline=SERIAL)
    xn, yn = _counts(20, 5, 3, 6)
    got = port.nb_fold_in(base_p, xn, yn, x_remove=x[:4], y_remove=y[:4])
    want = ref.nb_fold_in(base_r, xn, yn, x_remove=x[:4], y_remove=y[:4])
    _same_nb(got, want)
    # add-only, and the declines
    _same_nb(port.nb_fold_in(base_p, xn, yn), ref.nb_fold_in(base_r, xn, yn))
    assert port.nb_fold_in(base_p, xn[:, :3], yn) is None
    scaled = port.train_naive_bayes(x, y, 3, col_scale=np.ones(5, np.float32),
                                    device="cpu")
    assert scaled.feat_counts is None
    assert port.nb_fold_in(scaled, xn, yn) is None


def test_lr_sgd_steps_within_1e6():
    x, y = _counts(100, 6, 3, 7, scale=0.3)
    w = np.random.default_rng(8).standard_normal((6, 3)).astype(np.float32)
    b = np.arange(3, dtype=np.float32)
    got = port.lr_sgd_steps(port.LogisticRegressionModel(w, b, 3), x, y,
                            reg=0.01, epochs=7)
    want = ref.lr_sgd_steps(ref.LogisticRegressionModel(w, b, 3), x, y,
                            reg=0.01, epochs=7)
    np.testing.assert_allclose(got.weights, want.weights, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.intercept, want.intercept, rtol=0,
                               atol=1e-6)
    assert port.lr_sgd_steps(port.LogisticRegressionModel(w, b, 3),
                             x[:, :2], y) is None


def test_rebatch_entries_gives_the_references_chunks():
    rng = np.random.default_rng(10)
    blocks = []
    for k in (5, 0, 13, 2, 9, 1):
        blocks.append((rng.integers(0, 3, k), rng.integers(0, 50, k),
                       rng.random(k).astype(np.float32)))
    got = list(port.rebatch_entries(iter(blocks), 6))
    want = list(ref.rebatch_entries(iter(blocks), 6))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


def _ref_lr(x, y, c, reg, max_iters):
    n = len(x)
    w, b = ref._lr_fit(jnp.asarray(x), jnp.asarray(y),
                       jnp.ones(n, jnp.float32), jnp.float32(n),
                       jnp.float32(reg), jnp.float32(1e-6),
                       jnp.int32(max_iters), c)
    return np.asarray(w), np.asarray(b)


def _loss(x, y, w, b, reg):
    z = x.astype(np.float64) @ w + b
    z -= z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return (-logp[np.arange(len(y)), y].mean()
            + 0.5 * reg * float((w.astype(np.float64) ** 2).sum()))


def _hold_lr(x, y, c, reg, w_ref, b_ref, model):
    lr_ref = _loss(x, y, w_ref, b_ref, reg)
    lr_port = _loss(x, y, model.weights, model.intercept, reg)
    assert abs(lr_port - lr_ref) <= LOSS_RTOL * lr_ref, (lr_port, lr_ref)
    gap = np.linalg.norm(model.weights - w_ref) / np.linalg.norm(w_ref)
    assert gap <= WEIGHT_RTOL, gap
    assert np.array_equal(model.predict_logits(x).argmax(1),
                          (x @ w_ref + b_ref).argmax(1))


def test_lbfgs_stops_where_the_reference_stops():
    """A well-conditioned problem the stop rule ends: the reference's
    count is the least ``max_iters`` whose result equals the uncapped
    fit's (each of its steps moves the parameters), read where the fits
    repeat bit for bit (tests/lbfgs_stop.py)."""
    x, y = _counts(500, 4, 3, 11, scale=0.1)
    w_ref, b_ref = _ref_lr(x, y, 3, 0.1, 100)
    ref_iters = ref_stop(x, y, 3, 0.1)
    assert ref_iters is not None and ref_iters < 100
    stats = {}
    model = port.train_logistic_regression(x, y, 3, reg=0.1, max_iters=100,
                                           device="cpu", stats=stats)
    assert abs(stats["iterations"] - ref_iters) <= ITER_SLACK, \
        (stats, ref_iters)
    assert stats["host_syncs"] == stats["loss_evals"] - 1
    _hold_lr(x, y, 3, 0.1, w_ref, b_ref, model)


@pytest.mark.parametrize("n,d,c,reg,seed", [
    (300, 4, 3, 0.01, 0),    # the classification bench's shape, cut
    (200, 50, 4, 0.01, 3),   # wide, as TF-IDF LR is
    (300, 6, 3, 0.0, 2),     # no regularization
])
def test_lbfgs_reaches_the_references_optimum(n, d, c, reg, seed):
    x, y = _counts(n, d, c, seed)
    w_ref, b_ref = _ref_lr(x, y, c, reg, 100)
    stats = {}
    model = port.train_logistic_regression(x, y, c, reg=reg, max_iters=100,
                                           device="cpu", stats=stats)
    assert 0 < stats["iterations"] <= 100
    assert stats["loss"] == pytest.approx(
        _loss(x, y, model.weights, model.intercept, reg), rel=1e-6)
    _hold_lr(x, y, c, reg, w_ref, b_ref, model)


def test_lbfgs_honours_max_iters_and_starts_at_zero():
    x, y = _counts(100, 4, 3, 12)
    stats = {}
    port.train_logistic_regression(x, y, 3, max_iters=3, device="cpu",
                                   stats=stats)
    assert stats["iterations"] == 3
    # zero iterations: the parameters stay at zero, as the reference's
    m = port.train_logistic_regression(x, y, 3, max_iters=0, device="cpu")
    w_ref, b_ref = _ref_lr(x, y, 3, 0.0, 0)
    assert np.array_equal(m.weights, w_ref) and not m.weights.any()
    assert np.array_equal(m.intercept, b_ref)


def test_the_trainers_need_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _counts(20, 3, 2, 13)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.train_naive_bayes(x, y, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.train_logistic_regression(x, y, 2)
