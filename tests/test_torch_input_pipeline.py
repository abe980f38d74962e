"""The port's streamed input pipeline (``workflow/input_pipeline.py``) and
the linear trainers' streams (``ops/linear.py``) on the CPU, mirroring the
reference's tests/test_input_pipeline.py:

- the primitives: chunk ranges, prefetch order, back-pressure, a worker's
  error and a clean stop, the ring's bound, the source closed on a consume
  error, a source error propagating;
- the gate: ``off`` never streams, ``on`` streams any input on any device,
  ``auto`` only to a CUDA device at two chunks or more, and never in a
  rank of a gang of more than one process; the workflow params override
  the environment, resolved once;
- ``rebatch_entries`` keeps the entry stream;
- dense NB (several (n, chunk)), COO NB and LR streamed on the CPU, each
  bit-identical to the port's single-shot path and held to the JAX
  package's streamed trainer (``PipelineConfig(mode="on")``) on the same
  seeded numpy inputs: NB exactly; LR by the rule of tests/test_torch_linear
  (final loss within 1e-5 relative, iterations within ±2, the same argmax
  wherever the top two logits differ by more than 1e-3);
- the Text-Classification and Classification templates' streamed trains
  equal their one-shot trains bit for bit.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from incubator_predictionio_tpu.ops import linear as ref  # noqa: E402
from incubator_predictionio_tpu.workflow import (  # noqa: E402
    input_pipeline as ref_pipe,
)
from incubator_predictionio_torch.ops import linear as port  # noqa: E402
from lbfgs_stop import ref_stop  # noqa: E402
from incubator_predictionio_torch.workflow import input_pipeline as pipe  # noqa: E402
from incubator_predictionio_torch.workflow.input_pipeline import (  # noqa: E402
    DeviceRing, PipelineConfig, PipelineStats, PipelineWorkerError,
    chunk_ranges, prefetch, run_pipeline,
)

OFF = PipelineConfig(mode="off")
LOSS_RTOL, ITER_SLACK, MARGIN = 1e-5, 2, 1e-3


def _on(**kw):
    kw.setdefault("mode", "on")
    return PipelineConfig(**kw)


# -- primitives ----------------------------------------------------------------


def test_chunk_ranges_cover_exactly():
    assert chunk_ranges(0, 10) == []
    assert chunk_ranges(5, 10) == [(0, 5)]
    assert chunk_ranges(10, 10) == [(0, 10)]
    assert chunk_ranges(25, 10) == [(0, 10), (10, 20), (20, 25)]
    for n, c in ((25, 10), (1, 1), (999, 7)):
        assert chunk_ranges(n, c) == ref_pipe.chunk_ranges(n, c)


def test_prefetch_preserves_order_and_times_the_workers():
    stats = PipelineStats()
    out = list(prefetch(range(50), lambda v: v * v, workers=4, lookahead=3,
                        stats=stats))
    assert out == [v * v for v in range(50)]
    assert stats.featurize_seconds > 0


def test_prefetch_backpressure_bounds_lookahead():
    lookahead = 3
    started, consumed = [], []
    lock = threading.Lock()
    max_ahead = 0

    def fn(v):
        with lock:
            started.append(v)
        return v

    for v in prefetch(range(40), fn, workers=4, lookahead=lookahead):
        time.sleep(0.002)  # a slow consumer
        with lock:
            consumed.append(v)
            max_ahead = max(max_ahead, len(started) - len(consumed))
    assert consumed == list(range(40))
    assert max_ahead <= lookahead + 1  # +1: the item being yielded


def test_prefetch_worker_exception_propagates():
    def fn(v):
        if v == 7:
            raise ValueError("boom at 7")
        return v

    got = []
    with pytest.raises(PipelineWorkerError) as e:
        for v in prefetch(range(20), fn, workers=2, lookahead=2):
            got.append(v)
    assert got == list(range(7))
    assert isinstance(e.value.__cause__, ValueError)


def test_prefetch_clean_shutdown_midstream():
    processed = []
    lock = threading.Lock()

    def fn(v):
        with lock:
            processed.append(v)
        return v

    before = threading.active_count()
    gen = prefetch(range(10_000), fn, workers=2, lookahead=2)
    for v in gen:
        if v >= 2:
            break
    gen.close()
    assert len(processed) <= 2 + 2 + 2 + 1
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


class _Token:
    """A ring token that records when the ring waits on it."""

    def __init__(self, k, log):
        self.k, self.log = k, log

    def synchronize(self):
        self.log.append(self.k)


def test_run_pipeline_bounds_the_ring():
    """Before chunk N uploads, the token of chunk N - depth has been waited
    on and that chunk dropped: at most depth chunks are held at once (the
    bound of depth + 1 with room); every token is waited on by the end."""
    waited, live, peak = [], set(), [0]

    class Dev:
        def __init__(self, k):
            self.k = k
            live.add(k)
            peak[0] = max(peak[0], len(live))

        def __del__(self):
            live.discard(self.k)

    def upload(c):
        # the ring waited on every token up to c - depth before this upload
        assert waited == list(range(max(0, c - 1)))
        return Dev(c)

    stats = PipelineStats()
    n = run_pipeline(iter(range(9)), upload,
                     lambda dev: _Token(dev.k, waited), depth=2, stats=stats)
    assert n == 9 and stats.n_chunks == 9
    assert waited == list(range(9))
    assert stats.max_inflight == 2 and peak[0] <= 2
    assert stats.wall_seconds > 0


def test_run_pipeline_closes_source_on_consume_error():
    closed = []

    def chunks():
        try:
            for v in range(100):
                yield v
        finally:
            closed.append(True)

    def consume(dev):
        if dev >= 3:
            raise RuntimeError("device exploded")
        return None

    with pytest.raises(RuntimeError, match="device exploded"):
        run_pipeline(chunks(), lambda c: c, consume, depth=2)
    assert closed == [True]


def test_device_ring_on_the_cpu_uploads_and_copies_into():
    """On the CPU the ring wraps the arrays (uint16 travels as its int16
    bits, widened back exactly), copies into the given slices, and its
    token is None."""
    stats = PipelineStats()
    ring = DeviceRing("cpu", 2, stats)
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    u = np.array([0, 1, 40_000, 65_535], np.uint16)
    ta, tu = ring.upload((a, u))
    assert torch.equal(ta, torch.from_numpy(a))
    assert tu.dtype == torch.int16
    assert pipe.widen_u16(tu).tolist() == u.astype(np.int64).tolist()
    dst = torch.zeros(5, 2)
    (got,) = ring.upload((a,), into=(dst[1:4],))
    assert torch.equal(dst[1:4], torch.from_numpy(a)) and not dst[0].any()
    assert ring.token() is None
    assert stats.chunk_bytes_max == a.nbytes + u.nbytes


# -- the gate ------------------------------------------------------------------


def test_config_gate_auto_on_off_and_never_in_a_gang(monkeypatch):
    from incubator_predictionio_torch.parallel import distributed

    cfg = PipelineConfig(mode="auto", chunk_rows=100)
    # auto: only to a CUDA device, only at two chunks or more
    assert not cfg.enabled_for(10**9, device="cpu")
    assert not cfg.enabled_for(10**9)
    assert not cfg.enabled_for(150, device="cuda")
    assert cfg.enabled_for(200, device="cuda")
    assert cfg.enabled_for(200, device=torch.device("cuda", 0))
    assert not cfg.enabled_for(39, chunk=20, device="cuda")
    assert cfg.enabled_for(40, chunk=20, device="cuda")
    # on: any non-empty input, on any device; off: never
    assert _on(chunk_rows=100).enabled_for(1, device="cpu")
    assert not _on().enabled_for(0, device="cpu")
    assert not OFF.enabled_for(10**9, device="cuda")
    # never in a rank of a gang of more than one process, whatever the mode
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    assert not cfg.enabled_for(10**9, device="cuda")
    assert not _on().enabled_for(10**9, device="cuda")


def test_config_from_env(monkeypatch):
    monkeypatch.setenv("PIO_PIPELINE", "on")
    monkeypatch.setenv("PIO_PIPELINE_CHUNK", "12345")
    monkeypatch.setenv("PIO_PIPELINE_CHUNK_DOCS", "77")
    monkeypatch.setenv("PIO_PIPELINE_DEPTH", "5")
    monkeypatch.setenv("PIO_PIPELINE_WORKERS", "3")
    cfg = PipelineConfig.from_env()
    assert (cfg.mode, cfg.chunk_rows, cfg.chunk_docs, cfg.depth,
            cfg.workers) == ("on", 12345, 77, 5, 3)
    for name in ("PIO_PIPELINE", "PIO_PIPELINE_CHUNK",
                 "PIO_PIPELINE_CHUNK_DOCS", "PIO_PIPELINE_DEPTH",
                 "PIO_PIPELINE_WORKERS"):
        monkeypatch.delenv(name)
    want = ref_pipe.PipelineConfig()
    got = PipelineConfig.from_env()
    assert (got.mode, got.chunk_rows, got.chunk_docs, got.depth,
            got.workers) == (want.mode, want.chunk_rows, want.chunk_docs,
                             want.depth, want.workers)
    monkeypatch.setenv("PIO_PIPELINE", "0")
    assert PipelineConfig.from_env().mode == "off"


def test_workflow_params_override_env(monkeypatch):
    from incubator_predictionio_torch.workflow.context import WorkflowContext
    from incubator_predictionio_torch.workflow.workflow_params import (
        WorkflowParams,
    )

    monkeypatch.setenv("PIO_PIPELINE", "off")
    monkeypatch.setenv("PIO_PIPELINE_CHUNK", "111")
    ctx = WorkflowContext(device="cpu", workflow_params=WorkflowParams(
        pipeline="on", pipeline_chunk=222, pipeline_depth=3,
        pipeline_workers=4))
    cfg = ctx.get_input_pipeline()
    assert (cfg.mode, cfg.chunk_rows, cfg.depth, cfg.workers) == \
        ("on", 222, 3, 4)
    # resolved once: a later change of the environment leaves this run be
    monkeypatch.setenv("PIO_PIPELINE", "auto")
    assert ctx.get_input_pipeline() is cfg
    assert pipe.pipeline_of(ctx) is cfg and pipe.pipeline_of(None) is None
    # the environment where the params leave the field unset
    ctx = WorkflowContext(device="cpu")
    assert (ctx.get_input_pipeline().mode,
            ctx.get_input_pipeline().chunk_rows) == ("auto", 111)


# -- the trainers: streamed == single-shot, bit for bit ---------------------


def _cls_data(n, d=4, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.poisson(2.0, (n, d)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    return x, y, c


def _same_nb(got, want):
    for name in ("log_prior", "log_likelihood", "feat_counts",
                 "class_counts"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if b is not None:
            assert np.array_equal(a, np.asarray(b)), name


def test_rebatch_entries_preserves_stream():
    rng = np.random.default_rng(3)
    blocks = []
    for ln in (0, 5, 17, 1, 0, 40, 3):
        blocks.append((rng.integers(0, 9, ln).astype(np.int32),
                       rng.integers(0, 99, ln).astype(np.int32),
                       rng.random(ln).astype(np.float32)))
    out = list(port.rebatch_entries(iter(blocks), 16))
    assert all(len(ch[0]) == 16 for ch in out[:-1])
    assert sum(len(ch[0]) for ch in out) == sum(len(b[0]) for b in blocks)
    for j in range(3):
        assert np.array_equal(np.concatenate([ch[j] for ch in out]),
                              np.concatenate([b[j] for b in blocks]))


def test_nb_coo_stream_propagates_source_error():
    def blocks():
        yield (np.zeros(10, np.int32), np.zeros(10, np.int32),
               np.ones(10, np.float32))
        raise OSError("event store died mid-scan")

    with pytest.raises(OSError, match="died mid-scan"):
        port.train_naive_bayes_coo_stream(
            blocks(), np.zeros(4, np.int32), 3, 16, device="cpu",
            pipeline=_on(chunk_rows=8))


@pytest.mark.parametrize("n,chunk", [
    (10_000, 1024),   # an uneven last chunk
    (4_096, 1024),    # a multiple of the chunk
    (700, 1024),      # one short chunk (mode on streams it)
])
def test_nb_dense_stream_bit_identical(n, chunk):
    x, y, c = _cls_data(n)
    single = port.train_naive_bayes(x, y, c, device="cpu", pipeline=OFF)
    stats = PipelineStats()
    streamed = port.train_naive_bayes(x, y, c, device="cpu",
                                      pipeline=_on(chunk_rows=chunk),
                                      pipeline_stats=stats)
    _same_nb(streamed, single)
    assert stats.n_chunks == len(chunk_ranges(n, chunk))
    assert stats.max_inflight <= 2 and stats.wall_seconds > 0
    want = ref.train_naive_bayes(x, y, c,
                                 pipeline=ref_pipe.PipelineConfig(
                                     mode="on", chunk_rows=chunk))
    _same_nb(streamed, want)


def _docs(n_docs, vocab, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{int(v)}" for v in rng.integers(0, vocab, 25))
            for _ in range(n_docs)]


@pytest.mark.parametrize("n_classes,n_features", [(7, 256), (300, 70_000)])
def test_nb_coo_stream_bit_identical(n_classes, n_features):
    """The wire narrows the class ids (uint8 up to 256 classes), the
    feature ids (uint16 up to 65,536 features) and the counts; the card
    side widens them. The second case ships int32 ids."""
    from incubator_predictionio_torch.ops.tfidf import TfIdfVectorizer

    rng = np.random.default_rng(1)
    docs = _docs(2_000, 60, 1)
    y = rng.integers(0, n_classes, len(docs)).astype(np.int32)
    dp, ft, cnt = TfIdfVectorizer(n_features=n_features).fit_tf_coo(
        docs, use_native=False)
    single = port.train_naive_bayes_coo(dp, ft, cnt, y, n_classes,
                                        n_features, device="cpu",
                                        pipeline=OFF)
    stats = PipelineStats()
    streamed = port.train_naive_bayes_coo(dp, ft, cnt, y, n_classes,
                                          n_features, device="cpu",
                                          pipeline=_on(chunk_rows=4_000),
                                          pipeline_stats=stats)
    _same_nb(streamed, single)
    assert stats.n_chunks == len(chunk_ranges(len(ft), 4_000))
    want = ref.train_naive_bayes_coo(dp, ft, cnt, y, n_classes, n_features,
                                     pipeline=ref_pipe.PipelineConfig(
                                         mode="on", chunk_rows=4_000))
    _same_nb(streamed, want)


def _hold_lr(x, y, reg, got, got_stats, w_ref, b_ref, ref_iters):
    def loss(w, b):
        z = x.astype(np.float64) @ w + b
        z -= z.max(axis=1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
        return (-logp[np.arange(len(y)), y].mean()
                + 0.5 * reg * float((w.astype(np.float64) ** 2).sum()))

    want = loss(w_ref, b_ref)
    assert abs(loss(got.weights, got.intercept) - want) <= LOSS_RTOL * want
    if ref_iters is not None:
        assert abs(got_stats["iterations"] - ref_iters) <= ITER_SLACK
    z_got = x @ got.weights + got.intercept
    z_ref = x @ w_ref + b_ref

    def margin(z):
        top2 = np.sort(z, axis=1)[:, -2:]
        return top2[:, 1] - top2[:, 0]

    held = (margin(z_got) > MARGIN) & (margin(z_ref) > MARGIN)
    assert np.array_equal(z_got.argmax(1)[held], z_ref.argmax(1)[held])


def _ref_lr(x, y, c, reg, max_iters, pipeline):
    m = ref.train_logistic_regression(x, y, c, reg=reg, max_iters=max_iters,
                                      pipeline=pipeline)
    return m.weights, m.intercept


def _ref_stop(x, y, c, reg, pipeline):
    """The reference's iteration count: the least max_iters whose result
    equals the uncapped fit's (None when it runs to 100), read where the
    fits repeat bit for bit (tests/lbfgs_stop.py); ``pipeline``: the
    reference PipelineConfig's fields."""
    return ref_stop(x, y, c, reg, pipeline)


def test_lr_stream_bit_identical():
    x, y, c = _cls_data(3_000, seed=2)
    x *= 0.1
    stats0, stats1 = {}, {}
    single = port.train_logistic_regression(x, y, c, reg=0.1, max_iters=100,
                                            device="cpu", stats=stats0,
                                            pipeline=OFF)
    pstats = PipelineStats()
    streamed = port.train_logistic_regression(
        x, y, c, reg=0.1, max_iters=100, device="cpu", stats=stats1,
        pipeline=_on(chunk_rows=700), pipeline_stats=pstats)
    assert np.array_equal(streamed.weights, single.weights)
    assert np.array_equal(streamed.intercept, single.intercept)
    assert stats1["iterations"] == stats0["iterations"]
    assert pstats.n_chunks == len(chunk_ranges(3_000, 700))
    # and the JAX package's streamed trainer on the same inputs
    ref_cfg = ref_pipe.PipelineConfig(mode="on", chunk_rows=700)
    w_ref, b_ref = _ref_lr(x, y, c, 0.1, 100, ref_cfg)
    _hold_lr(x, y, 0.1, streamed, stats1, w_ref, b_ref,
             _ref_stop(x, y, c, 0.1, {"mode": "on", "chunk_rows": 700}))


# -- the templates ----------------------------------------------------------


def _text_corpus(n_docs=600, n_classes=5, vocab=80, seed=4):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n_docs).astype(np.int32)
    texts = [" ".join(f"w{(int(v) + int(y[j]) * 13) % vocab}"
                      for v in rng.integers(0, vocab, 30))
             for j in range(n_docs)]
    return texts, y, n_classes


def test_text_template_stream_identity():
    """The deferred TF-IDF featurization streamed through tokenizer
    workers into the scatter-add gives the one-shot prepare + train's
    model (statistics, idf, priors), and the JAX package's streamed
    template's."""
    from incubator_predictionio_tpu.models import (
        text_classification as ref_text,
    )
    from incubator_predictionio_tpu.workflow.context import (
        WorkflowContext as RefContext,
    )
    from incubator_predictionio_torch.models.text_classification import (
        TextNBAlgorithm, TextPreparator, TrainingData,
    )
    from incubator_predictionio_torch.workflow.context import WorkflowContext

    texts, y, c = _text_corpus()
    td = TrainingData(texts, y, np.arange(c).astype(str))

    def run(cfg, timings):
        ctx = WorkflowContext(app_name="t", device="cpu", input_pipeline=cfg,
                              bench_timings=timings)
        prep = TextPreparator(TextPreparator.params_cls(n_features=512))
        pd = prep.prepare(ctx, td)
        return pd, TextNBAlgorithm(TextNBAlgorithm.params_cls()).train(
            ctx, pd)

    on = _on(chunk_rows=2_048, chunk_docs=128, workers=2)
    timings0, timings1 = {}, {}
    pd0, m0 = run(OFF, timings0)
    pd1, m1 = run(on, timings1)
    assert pd0.coo is not None and pd0.texts is None  # one-shot, eager
    assert pd1.coo is None and pd1.texts is not None  # streamed, deferred
    # the stream's accounting reaches the train report; the one-shot has none
    assert "pipeline" not in timings0
    stream = timings1["pipeline"]
    assert stream["n_chunks"] >= 2 and stream["featurize_seconds"] > 0
    assert stream["max_inflight"] <= on.depth
    _same_nb(m1.inner, m0.inner)
    assert np.array_equal(m1.vectorizer.idf, m0.vectorizer.idf)

    rctx = RefContext(app_name="t")
    rctx.input_pipeline = ref_pipe.PipelineConfig(
        mode="on", chunk_rows=2_048, chunk_docs=128, workers=2)
    rpd = ref_text.TextPreparator(
        ref_text.TextPreparator.params_cls(n_features=512)).prepare(
        rctx, ref_text.TrainingData(texts, y, np.arange(c).astype(str)))
    rm = ref_text.TextNBAlgorithm(
        ref_text.TextNBAlgorithm.params_cls()).train(rctx, rpd)
    _same_nb(m1.inner, rm.inner)
    assert np.array_equal(m1.vectorizer.idf, rm.vectorizer.idf)


def test_text_lr_on_a_deferred_preparation_fits_in_one_go():
    """LR needs every document's row: on a streaming preparation it fits
    the same vectorizer at once and trains what the one-shot path trains."""
    from incubator_predictionio_torch.models.text_classification import (
        TextLRAlgorithm, TextPreparator, TrainingData,
    )
    from incubator_predictionio_torch.workflow.context import WorkflowContext

    texts, y, c = _text_corpus(n_docs=200)
    td = TrainingData(texts, y, np.arange(c).astype(str))
    models = []
    for cfg in (OFF, _on(chunk_docs=64)):
        ctx = WorkflowContext(app_name="t", device="cpu", input_pipeline=cfg)
        pd = TextPreparator(TextPreparator.params_cls(n_features=128)
                            ).prepare(ctx, td)
        models.append(TextLRAlgorithm(TextLRAlgorithm.params_cls(
            reg=0.1, max_iters=20)).train(ctx, pd))
    assert np.array_equal(models[0].inner.weights, models[1].inner.weights)
    assert np.array_equal(models[0].vectorizer.idf, models[1].vectorizer.idf)


@pytest.mark.parametrize("algo", ["naive", "lr"])
def test_classification_template_stream_identity(algo):
    from incubator_predictionio_torch.models.classification import (
        LogisticRegressionAlgorithm, NaiveBayesAlgorithm, TrainingData,
    )
    from incubator_predictionio_torch.workflow.context import WorkflowContext

    x, y, c = _cls_data(5_000, seed=5)
    td = TrainingData(x, y, tuple(f"a{j}" for j in range(4)),
                      np.arange(c).astype(np.float64))
    cls = NaiveBayesAlgorithm if algo == "naive" else \
        LogisticRegressionAlgorithm
    params = cls.params_cls() if algo == "naive" else cls.params_cls(
        reg=0.1, max_iters=15)

    def run(cfg):
        ctx = WorkflowContext(app_name="t", device="cpu", input_pipeline=cfg)
        return cls(params).train(ctx, td).inner

    m0, m1 = run(OFF), run(_on(chunk_rows=512))
    if algo == "naive":
        _same_nb(m1, m0)
    else:
        assert np.array_equal(m1.weights, m0.weights)
        assert np.array_equal(m1.intercept, m0.intercept)
