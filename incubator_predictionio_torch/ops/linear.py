"""Linear models: multinomial Naive Bayes and L2 logistic regression.

Port of ``incubator_predictionio_tpu/ops/linear.py``. The JAX package left
the device work to XLA; here it is torch ops on ``device`` (the card by
default):

- Naive Bayes sufficient statistics: the dense class × feature sums as one
  one-hot float32 matmul (``_nb_stats`` :159), and the COO sums of the
  tokenizer's output as one ``index_add_`` into a flat [C·D] float32
  tensor (``_nb_stats_coo`` :281). With count-valued features every
  partial sum is an integer below 2²⁴, so the statistics are exact in any
  summation order: bit for bit the same on the card and on the CPU,
  atomics included. The matmul runs in IEEE float32 whatever the process's
  TF32 setting (:func:`_ieee_f32`).
- Logistic regression: the reference runs optax's L-BFGS (memory 10, a
  scaled initial preconditioner, a backtracking line search storing the
  gradient) in one ``lax.while_loop`` (``_lr_fit`` :537). :func:`lbfgs_fit`
  is that iteration written out on tensors. The line search's sufficient
  decrease test and the stop rule are read on the host: one device → host
  read per loss evaluation of the line search, which carries the stop
  rule's numbers too (``stats["host_syncs"]``). The loss is summed and
  returned in float64 (the gradient stays float32): in float32 it moves in
  steps of one ulp near the optimum, and at config 2's size the line
  search then stalled above the stop rule's gradient norm, running all
  100 iterations or not by the threads' summation order.
- The streams (``workflow/input_pipeline.py``, the reference's K6 streams):
  an input of at least two chunks on the card (or any input under
  ``PIO_PIPELINE=on``) goes through the overlapped featurize → upload →
  consume ring instead of one upload. Dense NB folds each chunk's one-hot
  matmul into running [C, D] / [C] accumulators (:func:`_stream_nb_dense`);
  COO NB scatter-adds fixed-size entry chunks, narrowed losslessly on the
  wire and widened on the card (:func:`train_naive_bayes_coo_stream`); LR
  copies the chunks into slices of one preallocated [N, D] matrix
  (:func:`_stream_lr_upload`). Exact integer sums make the streamed NB
  statistics the single-shot ones bit for bit, and the streamed LR matrix
  is the single-shot upload, so the fit is too.
- The process-local trainers of a gang (``:712-822``): each rank holds its
  own example block (:func:`_assemble_process_shards`); NB all-reduces its
  [C, D] and [C] sums once, LR all-reduces the data part of the loss and
  of the gradient on every evaluation (:class:`_SoftmaxNLL`'s ``reduce``
  hook) over the gang's gloo group (through the host).

The log parameters (:func:`nb_model_from_counts`), the fold-ins
(:func:`nb_fold_in`, :func:`lr_sgd_steps`) and prediction are host numpy,
verbatim.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.distributed import (
    HostCollectives, process_count, process_index,
)
from ..workflow.input_pipeline import (
    DeviceRing, PipelineConfig, PipelineStats, chunk_ranges, prefetch,
    run_pipeline, widen_u16,
)


@contextlib.contextmanager
def _ieee_f32():
    """Float32 matmuls without TF32 for the duration of an op: the NB
    statistics must be exact and the LR fit is held to the CPU's."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _put(a: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


# ---------------------------------------------------------------------------
# Naive Bayes (multinomial, additive smoothing)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NaiveBayesModel:
    log_prior: np.ndarray  # [C]
    log_likelihood: np.ndarray  # [C, D]
    n_classes: int
    #: the sufficient statistics, kept so a fold-in is exact (None after a
    #: col-scaled, TF-IDF, training: the scale moves with new documents)
    feat_counts: Optional[np.ndarray] = None   # [C, D] before smoothing
    class_counts: Optional[np.ndarray] = None  # [C]
    smoothing: float = 1.0

    def predict_log_joint(self, x: np.ndarray) -> np.ndarray:
        return x @ self.log_likelihood.T + self.log_prior  # [B, C]


def nb_model_from_counts(feat: np.ndarray, counts: np.ndarray,
                         n_classes: int, smoothing: float,
                         keep_counts: bool = True) -> NaiveBayesModel:
    """(class × feature sums, class counts) → the model. The arithmetic
    runs in the caller's dtype (float32 device statistics, float64
    bincounts), as in the reference."""
    total = counts.sum()
    log_prior = np.log((counts + 1e-12) / max(total, 1e-12))
    num = feat + smoothing
    log_likelihood = np.log(num) - np.log(num.sum(axis=1, keepdims=True))
    return NaiveBayesModel(
        log_prior=log_prior.astype(np.float32),
        log_likelihood=log_likelihood.astype(np.float32),
        n_classes=n_classes,
        feat_counts=(np.asarray(feat, np.float32) if keep_counts else None),
        class_counts=(np.asarray(counts, np.float32)
                      if keep_counts else None),
        smoothing=float(smoothing),
    )


def nb_fold_in(model: NaiveBayesModel, x: np.ndarray, y: np.ndarray,
               x_remove=None, y_remove=None) -> Optional[NaiveBayesModel]:
    """Exact incremental NB: the new examples' statistics added (and those
    of ``x_remove``/``y_remove``, an entity's previous example, taken
    away), then the log parameters rebuilt. None when the model keeps no
    statistics or the shapes do not fit. Never mutates ``model``."""
    feat = getattr(model, "feat_counts", None)
    counts = getattr(model, "class_counts", None)
    if feat is None or counts is None:
        return None
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int64)
    if x.ndim != 2 or x.shape[1] != feat.shape[1] or len(x) != len(y):
        return None

    def stats(xs, ys):
        onehot = np.zeros((len(ys), model.n_classes), np.float32)
        onehot[np.arange(len(ys)), ys] = 1.0
        return onehot.T @ xs, onehot.sum(axis=0)

    f_add, c_add = stats(x, y)
    feat = feat + f_add
    counts = counts + c_add
    if x_remove is not None and len(x_remove):
        f_sub, c_sub = stats(np.asarray(x_remove, np.float32),
                             np.asarray(y_remove, np.int64))
        # a corrupt removal must never drive a count negative
        feat = np.maximum(feat - f_sub, 0.0)
        counts = np.maximum(counts - c_sub, 0.0)
    return nb_model_from_counts(
        feat, counts, model.n_classes, getattr(model, "smoothing", 1.0))


def nb_stats(x: np.ndarray, y: np.ndarray, n_classes: int,
             device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """[C, D] class × feature sums and [C] class counts, float32, as one
    one-hot matmul on ``device`` (``_nb_stats``)."""
    dev = resolve_device(device)
    xt = _put(x, np.float32, dev)
    onehot = torch.nn.functional.one_hot(
        _put(y, np.int64, dev), n_classes).to(torch.float32)
    with _ieee_f32():
        feat = onehot.T @ xt
    counts = onehot.sum(dim=0)
    return feat.cpu().numpy(), counts.cpu().numpy()


def _nb_stats_acc(feat_acc: torch.Tensor, counts_acc: torch.Tensor,
                  xt: torch.Tensor, yt: torch.Tensor,
                  classes: torch.Tensor) -> None:
    """One streamed chunk folded into the running [C, D] / [C] float32
    statistics (``_nb_stats_acc`` :165): the chunk's one-hot (built by a
    compare against ``classes``, no int64 copy of the labels) times its
    rows, added in place. The sums are integers below 2²⁴, so the chunked
    reduction is the single-shot one bit for bit."""
    onehot = (yt[:, None] == classes[None, :]).to(torch.float32)
    feat_acc.addmm_(onehot.T, xt)
    counts_acc.add_(onehot.sum(dim=0))


def _stream_nb_dense(x: np.ndarray, y: np.ndarray, n_classes: int,
                     dev: torch.device, cfg: PipelineConfig,
                     stats: Optional[PipelineStats]):
    """featurize → upload → accumulate over row chunks (``_stream_nb_dense``
    :179); host (feat [C, D], counts [C]), equal to :func:`nb_stats`'s."""
    n, d = x.shape
    feat_acc = torch.zeros((n_classes, d), dtype=torch.float32, device=dev)
    counts_acc = torch.zeros(n_classes, dtype=torch.float32, device=dev)
    classes = torch.arange(n_classes, dtype=torch.int32, device=dev)
    ring = DeviceRing(dev, cfg.depth, stats)

    def featurize(rng):
        s, e = rng
        return x[s:e], y[s:e]

    def consume(chunk):
        _nb_stats_acc(feat_acc, counts_acc, *chunk, classes)
        return ring.token()

    with _ieee_f32():
        chunks = prefetch(chunk_ranges(n, cfg.chunk_rows), featurize,
                          workers=cfg.workers, lookahead=cfg.depth + 1,
                          stats=stats)
        run_pipeline(chunks, ring.upload, consume, depth=cfg.depth,
                     stats=stats)
    return feat_acc.cpu().numpy(), counts_acc.cpu().numpy()


def train_naive_bayes(x: np.ndarray, y: np.ndarray, n_classes: int,
                      smoothing: float = 1.0,
                      col_scale: Optional[np.ndarray] = None,
                      device="cuda",
                      pipeline: Optional[PipelineConfig] = None,
                      pipeline_stats: Optional[PipelineStats] = None
                      ) -> NaiveBayesModel:
    """x [N, D] non-negative features, y [N] class ids. ``col_scale`` [D]
    (TF-IDF's idf) scales the class statistics, the same as training on
    ``x * col_scale`` without making that product; such a model keeps no
    statistics for a fold-in. ``pipeline`` (default: the environment's):
    when it enables streaming for this input, the statistics come from the
    chunk stream (:func:`_stream_nb_dense`), bit for bit the single-shot
    ones; ``pipeline_stats`` receives the stream's accounting."""
    dev = resolve_device(device)
    cfg = pipeline or PipelineConfig.from_env()
    if cfg.enabled_for(len(x), device=dev):
        feat, counts = _stream_nb_dense(
            np.asarray(x, np.float32), np.asarray(y, np.int32), n_classes,
            dev, cfg, pipeline_stats)
    else:
        feat, counts = nb_stats(x, y, n_classes, dev)
    if col_scale is not None:
        feat = feat * np.asarray(col_scale, np.float32)
    return nb_model_from_counts(feat, counts, n_classes, smoothing,
                                keep_counts=col_scale is None)


def nb_stats_coo(cls_per_entry: np.ndarray, feat_idx: np.ndarray,
                 counts: np.ndarray, n_classes: int, n_features: int,
                 device="cuda") -> np.ndarray:
    """[C, D] float32 class × feature sums of COO entries as one
    ``index_add_`` into a flat [C·D] tensor on ``device``
    (``_nb_stats_coo``)."""
    if n_classes * n_features > np.iinfo(np.int32).max:
        raise ValueError(f"{n_classes} x {n_features} statistics do not "
                         "fit a 32-bit index")
    dev = resolve_device(device)
    idx = (np.asarray(cls_per_entry, np.int32) * np.int32(n_features)
           + np.asarray(feat_idx, np.int32))
    flat = torch.zeros(n_classes * n_features, dtype=torch.float32,
                       device=dev)
    flat.index_add_(0, _put(idx, np.int32, dev),
                    _put(counts, np.float32, dev))
    return flat.cpu().numpy().reshape(n_classes, n_features)


def rebatch_entries(chunks: Iterable[tuple], chunk_entries: int):
    """Re-chunk a ragged stream of (cls, feat, counts) COO blocks into
    fixed-size entry chunks (the last one short), entry order kept."""
    step = max(1, int(chunk_entries))
    carry: list[tuple] = []
    held = 0

    def drain(parts, take):
        out, rest, got = [], [], 0
        for p in parts:
            n = len(p[0])
            if got + n <= take:
                out.append(p)
                got += n
            else:
                k = take - got
                if k > 0:
                    out.append(tuple(a[:k] for a in p))
                    rest.append(tuple(a[k:] for a in p))
                    got = take
                else:
                    rest.append(p)
        cat = tuple(np.concatenate([p[j] for p in out])
                    if len(out) != 1 else out[0][j] for j in range(3))
        return cat, rest

    for block in chunks:
        carry.append(block)
        held += len(block[0])
        while held >= step:
            full, carry = drain(carry, step)
            held -= step
            yield full
    if held:
        last, carry = drain(carry, held)
        yield last


def _narrow_coo_chunk(cls_e, feat_e, cnt_e, n_classes: int,
                      n_features: int):
    """Lossless narrow wire dtypes of one COO entry chunk (``:306``;
    widened on the card): feature ids uint16 when D fits, class ids uint8
    when C fits, counts uint16 when every count does."""
    if n_features <= np.iinfo(np.uint16).max + 1:
        feat_e = feat_e.astype(np.uint16)
    if n_classes <= np.iinfo(np.uint8).max + 1:
        cls_e = cls_e.astype(np.uint8)
    if cnt_e.size and float(cnt_e.max()) <= np.iinfo(np.uint16).max \
            and np.array_equal(cnt_e.astype(np.uint16), cnt_e):
        cnt_e = cnt_e.astype(np.uint16)
    return cls_e, feat_e, cnt_e


def _wide_int(t: torch.Tensor) -> torch.Tensor:
    """A wire tensor's int32 values (int16 on the wire carries uint16)."""
    return widen_u16(t) if t.dtype == torch.int16 else t.to(torch.int32)


def _nb_stats_coo_acc(acc_flat: torch.Tensor, cls_t: torch.Tensor,
                      feat_t: torch.Tensor, cnt_t: torch.Tensor,
                      n_features: int) -> None:
    """One streamed COO entry chunk, widened on the card, scatter-added
    into the running flat [C·D] statistics (``_nb_stats_coo_acc`` :294)."""
    idx = _wide_int(cls_t) * n_features + _wide_int(feat_t)
    w = (widen_u16(cnt_t) if cnt_t.dtype == torch.int16
         else cnt_t).to(torch.float32)
    acc_flat.index_add_(0, idx, w)


def train_naive_bayes_coo(doc_ptr: np.ndarray, feat_idx: np.ndarray,
                          counts: np.ndarray, y: np.ndarray, n_classes: int,
                          n_features: int, smoothing: float = 1.0,
                          col_scale: Optional[np.ndarray] = None,
                          device="cuda",
                          pipeline: Optional[PipelineConfig] = None,
                          pipeline_stats: Optional[PipelineStats] = None
                          ) -> NaiveBayesModel:
    """NB from the tokenizer's COO output (``TfIdfVectorizer.fit_tf_coo``):
    the dense [N, D] matrix never exists; the class counts are a host
    bincount, as in the reference. An entry stream that ``pipeline``
    enables goes through :func:`train_naive_bayes_coo_stream`."""
    dev = resolve_device(device)
    y = np.asarray(y, np.int32)
    cls_per_entry = np.repeat(y, np.diff(np.asarray(doc_ptr)))
    cfg = pipeline or PipelineConfig.from_env()
    if cfg.enabled_for(len(feat_idx), device=dev):
        return train_naive_bayes_coo_stream(
            iter([(cls_per_entry, np.asarray(feat_idx), np.asarray(
                counts, np.float32))]), y, n_classes, n_features,
            smoothing=smoothing, col_scale=col_scale, device=dev,
            pipeline=cfg, pipeline_stats=pipeline_stats)
    feat = nb_stats_coo(cls_per_entry, feat_idx, counts, n_classes,
                        n_features, dev)
    return _nb_model_from_stats(feat, y, n_classes, smoothing, col_scale)


def train_naive_bayes_coo_stream(
        entry_blocks: Iterable[tuple], y: np.ndarray, n_classes: int,
        n_features: int, smoothing: float = 1.0, col_scale=None,
        device="cuda", pipeline: Optional[PipelineConfig] = None,
        pipeline_stats: Optional[PipelineStats] = None) -> NaiveBayesModel:
    """NB from a stream of ragged (class, feature, count) COO entry blocks
    (``train_naive_bayes_coo_stream`` :431): rebatched into fixed chunks of
    ``pipeline.chunk_rows`` entries, each uploaded narrow and scatter-added
    into the running statistics on the card while the next one is made.
    The same integer additions as :func:`train_naive_bayes_coo` on the
    concatenated stream, so bit for bit its model. ``col_scale`` may be a
    callable with no arguments, called after the last chunk (TF-IDF's idf
    exists only once every document frequency is counted)."""
    if n_classes * n_features > np.iinfo(np.int32).max:
        raise ValueError(f"{n_classes} x {n_features} statistics do not "
                         "fit a 32-bit index")
    dev = resolve_device(device)
    y = np.asarray(y, np.int32)
    cfg = pipeline or PipelineConfig.from_env()
    acc = torch.zeros(n_classes * n_features, dtype=torch.float32,
                      device=dev)
    ring = DeviceRing(dev, cfg.depth, pipeline_stats)

    def upload(chunk):
        return ring.upload(_narrow_coo_chunk(
            np.asarray(chunk[0]), np.asarray(chunk[1]),
            np.asarray(chunk[2], np.float32), n_classes, n_features))

    def consume(dev_chunk):
        _nb_stats_coo_acc(acc, *dev_chunk, n_features)
        return ring.token()

    run_pipeline(rebatch_entries(entry_blocks, cfg.chunk_rows), upload,
                 consume, depth=cfg.depth, stats=pipeline_stats)
    feat = acc.cpu().numpy().reshape(n_classes, n_features)
    if callable(col_scale):
        col_scale = col_scale()
    return _nb_model_from_stats(feat, y, n_classes, smoothing, col_scale)


def _nb_model_from_stats(feat, y, n_classes, smoothing, col_scale):
    if col_scale is not None:
        feat = feat * np.asarray(col_scale, np.float32)
    class_counts = np.bincount(y, minlength=n_classes).astype(np.float64)
    return nb_model_from_counts(feat, class_counts, n_classes, smoothing,
                                keep_counts=col_scale is None)


# ---------------------------------------------------------------------------
# Logistic regression (multinomial softmax, L2, L-BFGS)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LogisticRegressionModel:
    weights: np.ndarray  # [D, C]
    intercept: np.ndarray  # [C]
    n_classes: int

    def predict_logits(self, x: np.ndarray) -> np.ndarray:
        return x @ self.weights + self.intercept

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        z = self.predict_logits(x)
        z = z - z.max(axis=-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=-1, keepdims=True)


def lr_sgd_steps(model: LogisticRegressionModel, x: np.ndarray,
                 y: np.ndarray, *, reg: float = 0.0, lr: float = 0.05,
                 epochs: int = 5) -> Optional[LogisticRegressionModel]:
    """A few full-batch softmax gradient steps over the new examples, on a
    copy of the model (the streaming fold-in). None when the feature count
    does not fit."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int64)
    w = np.array(model.weights, np.float32, copy=True)
    b = np.array(model.intercept, np.float32, copy=True)
    if x.ndim != 2 or x.shape[1] != w.shape[0] or len(x) != len(y) \
            or not len(x):
        return None
    onehot = np.zeros((len(y), model.n_classes), np.float32)
    onehot[np.arange(len(y)), y] = 1.0
    for _ in range(max(1, int(epochs))):
        z = x @ w + b
        z -= z.max(axis=1, keepdims=True)
        e = np.exp(z)
        p = e / e.sum(axis=1, keepdims=True)
        g = (p - onehot) / len(y)
        w -= lr * (x.T @ g + reg * w)
        b -= lr * g.sum(axis=0)
    return LogisticRegressionModel(weights=w, intercept=b,
                                   n_classes=model.n_classes)


#: optax.lbfgs / scale_by_backtracking_linesearch (optax 0.2.6) as the
#: reference configures them (linear.py:569-570)
LBFGS_MEMORY = 10
LS_MAX_STEPS = 20
LS_SLOPE_RTOL = 1e-4
LS_DECREASE = 0.8
LS_INCREASE = 1.5
LS_MAX_LR = 1.0
GRAD_TOL = 1e-4


class _SoftmaxNLL:
    """The reference's objective over flat parameters θ = [w (D×C), b]:
    the mean negative log-likelihood plus 0.5·reg·‖w‖² (the intercept is
    not regularized), with its analytic gradient.

    In a gang (``_lr_fit`` under the reference's row-sharded psums) each
    rank holds its own rows: ``mask`` zeroes its pad rows, ``n`` is the
    gang-wide example count, and ``reduce`` (a sum over the gang, in
    place) takes the data part of the loss and of the gradient on every
    evaluation; the regularizer's terms are added once, after the sum, so
    every rank holds the same loss and gradient. ``collectives`` counts the
    sums this rank took part in."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, n_classes: int,
                 reg: float, mask: Optional[torch.Tensor] = None,
                 n: Optional[int] = None,
                 reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None):
        self.x = x
        self.onehot = torch.nn.functional.one_hot(y, n_classes).to(x.dtype)
        self.mask = mask
        self.n = float(x.shape[0] if n is None else n)
        self.reg = float(reg)
        self.reduce = reduce
        self.d, self.c = x.shape[1], n_classes
        self.evals = 0
        self.collectives = 0

    def split(self, theta: torch.Tensor):
        return theta[:self.d * self.c].view(self.d, self.c), \
            theta[self.d * self.c:]

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        self.collectives += 1
        return self.reduce(t)

    def value(self, theta: torch.Tensor):
        """(loss, log-probabilities): the latter feed :meth:`grad`."""
        self.evals += 1
        w, b = self.split(theta)
        logp = torch.log_softmax(self.x @ w + b, dim=1)
        nll = -(logp * self.onehot).sum(dim=1)
        # summed and returned in float64: near the optimum a float32 loss
        # moves in steps of one ulp (6e-8 at 0.64), coarser than the
        # decrease the line search has to see, and L-BFGS stalls there
        data = (nll if self.mask is None else nll * self.mask).sum(
            dtype=torch.float64)
        if self.reduce is not None:
            data = self._sum(data.reshape(1))[0]
        w64 = w.to(torch.float64)
        return data / self.n + 0.5 * self.reg * (w64 * w64).sum(), logp

    def grad(self, theta: torch.Tensor, logp: torch.Tensor) -> torch.Tensor:
        w, _ = self.split(theta)
        g = torch.exp(logp) - self.onehot
        if self.mask is not None:
            g = g * self.mask[:, None]
        g = g / self.n
        gw, gb = self.x.T @ g, g.sum(dim=0)
        if self.reduce is not None:
            flat = self._sum(torch.cat([gw.reshape(-1), gb]))
            gw, gb = flat[:self.d * self.c].view(self.d, self.c), \
                flat[self.d * self.c:]
        return torch.cat([(gw + self.reg * w).reshape(-1), gb])


def lbfgs_fit(fn: _SoftmaxNLL, theta: torch.Tensor, max_iters: int,
              tol: float, stats: Optional[dict] = None) -> torch.Tensor:
    """optax's ``lbfgs`` chained with ``scale_by_backtracking_linesearch``
    (``store_grad=True``), driven by the reference's loop (``_lr_fit``
    :573-597), on flat parameters:

    - the direction is −P·g by the two-loop recursion over the last
      ``LBFGS_MEMORY`` (s, y, 1/(yᵀs)) pairs (a zero yᵀs gives weight 0);
      P's initial scale is yᵀs/yᵀy of the newest pair (1 when yᵀy is 0),
      and min(1, 1/‖g‖) at the first iteration;
    - the step starts at min(1.5 × the last step, 1) and shrinks by 0.8
      until f(θ + η·d) ≤ f(θ) + 1e-4·η·dᵀg, at most 20 times; a NaN or
      infinite trial leaves the parameters where they are (step 0) and
      the next iteration evaluates f and g afresh;
    - the loop stops after ``max_iters`` iterations, or after the one
      whose start value moved less than tol·max(1, |previous|) from the
      previous start value with ‖g‖ < 1e-4 there.

    ``stats`` (a dict) receives ``iterations``, ``loss_evals`` (every
    evaluation of f; each line-search trial among them), ``host_syncs``
    (one device → host read per line-search trial) and ``collectives``
    (the gang sums ``fn`` took).

    In a gang every decision (the decrease test, a NaN trial, the stop
    rule) is read from the summed loss and gradient, which every rank
    holds alike, so every rank evaluates f equally often and takes part
    in the same number of collectives.
    """
    mem: collections.deque = collections.deque(maxlen=LBFGS_MEMORY)
    one = torch.ones((), dtype=theta.dtype, device=theta.device)
    prev_theta = prev_grad = None
    value = grad = None
    value_h = math.inf     # the line search's stored value (host)
    prev_h = math.inf      # the previous iteration's start value
    lr = 1.0
    syncs = it = 0
    while it < max_iters:
        if not math.isfinite(value_h):
            value, logp = fn.value(theta)
            grad = fn.grad(theta, logp)
        # L-BFGS memory and direction
        if prev_theta is None:
            gamma = torch.minimum(one, 1.0 / torch.linalg.vector_norm(grad))
        else:
            s, yv = theta - prev_theta, grad - prev_grad
            sy = torch.dot(yv, s)
            yy = torch.dot(yv, yv)
            mem.append((s, yv, torch.where(sy == 0, 0.0 * one, 1.0 / sy)))
            gamma = torch.where(yy > 0, sy / yy, one)
        q = grad
        alphas = []
        for s, yv, rho in reversed(mem):
            a = rho * torch.dot(s, q)
            q = q - a * yv
            alphas.append(a)
        q = gamma * q
        for (s, yv, rho), a in zip(mem, reversed(alphas)):
            q = q + (a - rho * torch.dot(yv, q)) * s
        direction = -q
        slope = torch.dot(direction, grad)
        gnorm = torch.linalg.vector_norm(grad)
        # backtracking line search
        # the step size in float32 arithmetic, as the reference's state
        lr = float(min(np.float32(LS_INCREASE) * np.float32(lr),
                       np.float32(LS_MAX_LR)))
        start_h = gnorm_h = None
        for trial in range(LS_MAX_STEPS + 1):
            if trial:
                lr = float(np.float32(LS_DECREASE) * np.float32(lr))
            cand = theta + lr * direction
            new_value, logp = fn.value(cand)
            err = new_value - value - lr * LS_SLOPE_RTOL * slope
            err = torch.where(torch.isnan(err), math.inf, err).clamp_min(0.0)
            packed = torch.stack([t.to(torch.float64) for t in [
                err, new_value] + ([value, gnorm] if trial == 0 else [])
            ]).tolist()
            syncs += 1
            if trial == 0:
                start_h, gnorm_h = packed[2], packed[3]
            err_h, new_h = packed[0], packed[1]
            if err_h <= 0.0 or trial == LS_MAX_STEPS:
                new_grad = fn.grad(cand, logp)
                break
        if math.isinf(err_h):
            lr = 0.0
            cand = theta
        prev_theta, prev_grad = theta, grad
        theta, value, grad, value_h = cand, new_value, new_grad, new_h
        it += 1
        done = (abs(prev_h - start_h) < tol * max(1.0, abs(prev_h))
                and gnorm_h < GRAD_TOL)
        prev_h = start_h
        if done:
            break
    if stats is not None:
        stats.update(iterations=it, loss_evals=fn.evals, host_syncs=syncs,
                     collectives=fn.collectives)
    return theta


def _stream_lr_upload(x: np.ndarray, dev: torch.device,
                      cfg: PipelineConfig,
                      stats: Optional[PipelineStats]) -> torch.Tensor:
    """The LR matrix uploaded as a chunk stream (``_stream_lr_upload``
    :618): each chunk is copied into its slice of one preallocated
    [N, D] float32 tensor on the card while the next is staged, so the
    result holds exactly the single-shot upload's contents (the
    reference's on-device concatenate is not needed)."""
    n, d = x.shape
    xt = torch.empty((n, d), dtype=torch.float32, device=dev)
    ring = DeviceRing(dev, cfg.depth, stats)

    def featurize(rng):
        s, e = rng
        return rng, x[s:e]

    def upload(item):
        (s, e), xc = item
        return ring.upload((xc,), into=(xt[s:e],))

    chunks = prefetch(chunk_ranges(n, cfg.chunk_rows), featurize,
                      workers=cfg.workers, lookahead=cfg.depth + 1,
                      stats=stats)
    run_pipeline(chunks, upload, lambda _chunk: ring.token(),
                 depth=cfg.depth, stats=stats)
    return xt


def _lr_model(fn: _SoftmaxNLL, theta: torch.Tensor,
              n_classes: int) -> LogisticRegressionModel:
    w, b = fn.split(theta)
    return LogisticRegressionModel(
        weights=np.asarray(w.cpu().numpy(), np.float32),
        intercept=np.asarray(b.cpu().numpy(), np.float32),
        n_classes=n_classes)


def train_logistic_regression(x: np.ndarray, y: np.ndarray, n_classes: int,
                              reg: float = 0.0, max_iters: int = 100,
                              tol: float = 1e-6, device="cuda",
                              stats: Optional[dict] = None,
                              pipeline: Optional[PipelineConfig] = None,
                              pipeline_stats: Optional[PipelineStats] = None
                              ) -> LogisticRegressionModel:
    """Full-batch multinomial LR under :func:`lbfgs_fit` on ``device``
    (``train_logistic_regression`` :652 with ``_lr_fit`` :537), the
    parameters starting at zero. ``stats`` also receives the final
    ``loss`` and ``lbfgs_seconds``. ``pipeline``: when it enables
    streaming for this input, the matrix is uploaded as a chunk stream
    (:func:`_stream_lr_upload`), the same tensor, so the same fit."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    d = x.shape[1]
    cfg = pipeline or PipelineConfig.from_env()
    with _ieee_f32():
        xt = (_stream_lr_upload(x, dev, cfg, pipeline_stats)
              if cfg.enabled_for(len(x), device=dev)
              else _put(x, np.float32, dev))
        fn = _SoftmaxNLL(xt, _put(y, np.int64, dev), n_classes, reg)
        t0 = time.perf_counter()
        theta = lbfgs_fit(fn, torch.zeros(d * n_classes + n_classes,
                                          dtype=torch.float32, device=dev),
                          int(max_iters), float(tol), stats)
        if stats is not None:
            stats["loss"] = float(fn.value(theta)[0])
            stats["lbfgs_seconds"] = time.perf_counter() - t0
        return _lr_model(fn, theta, n_classes)


# ---------------------------------------------------------------------------
# process-local (gang) trainers: synchronous data parallelism over the
# gang's gloo group (``:706-822``)
# ---------------------------------------------------------------------------


def gang_rows(n: int) -> tuple[int, int]:
    """This rank's contiguous block [lo, hi) of ``n`` rows: the block
    ``P(DATA_AXIS)`` gives one device of a mesh of as many devices as the
    gang has ranks (⌈n / W⌉ rows each, the last ones short). ``(0, n)``
    outside a gang."""
    world, rank = process_count(), process_index()
    per = -(-n // world)
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


def _assemble_process_shards(x: np.ndarray, y: np.ndarray,
                             coll: HostCollectives):
    """Each rank's LOCAL example block padded to the gang-wide largest
    (``_assemble_process_shards`` :712): the ranks' row counts are
    all-gathered; pad rows carry mask 0, so the sums ignore them. Returns
    ``(x, y, mask, n_global)``, ``n_global`` the gang's real example
    count (the loss's divisor)."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    n_local = len(x)
    sizes = coll.all_gather(torch.tensor([n_local], dtype=torch.int64))
    rows, n_global = int(sizes.max()), int(sizes.sum())

    def pad(a):
        out = np.zeros((rows,) + a.shape[1:], a.dtype)
        out[:n_local] = a
        return out

    return pad(x), pad(y), pad(np.ones(n_local, np.float32)), n_global


def _gang_report(coll: HostCollectives, out: Optional[dict], **extra) -> None:
    if out is not None:
        out.update(rank=process_index(), world=process_count(),
                   allreduce_calls=coll.calls["allreduce"],
                   allreduce_bytes=coll.bytes["allreduce"],
                   allreduce_seconds=coll.seconds["allreduce"], **extra)


def train_naive_bayes_process_local(x: np.ndarray, y: np.ndarray,
                                    n_classes: int, smoothing: float = 1.0,
                                    device="cuda",
                                    timings: Optional[dict] = None
                                    ) -> NaiveBayesModel:
    """NB where each rank of a gang holds only its own examples (``:769``):
    the local statistics on ``device``, then ONE all-reduce of the [C, D]
    and [C] sums. The sums are integers, exact in float32, so the model is
    the single-process model over the union bit for bit. ``n_classes`` is
    the gang's agreed class count. One process: :func:`train_naive_bayes`.
    ``timings`` receives ``stats_seconds``, the all-reduce's calls, bytes
    and seconds, ``local_rows`` and ``n_global``."""
    if process_count() == 1:
        return train_naive_bayes(x, y, n_classes, smoothing=smoothing,
                                 device=device)
    dev = resolve_device(device)
    coll = HostCollectives()
    xl, yl, ml, n_global = _assemble_process_shards(x, y, coll)
    t0 = time.perf_counter()
    with _ieee_f32():
        onehot = torch.nn.functional.one_hot(
            _put(yl, np.int64, dev), n_classes).to(torch.float32) \
            * _put(ml, np.float32, dev)[:, None]
        flat = torch.cat([(onehot.T @ _put(xl, np.float32, dev)).reshape(-1),
                          onehot.sum(dim=0)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats_s = time.perf_counter() - t0
    flat = coll.all_reduce(flat).cpu().numpy()
    d = xl.shape[1]
    _gang_report(coll, timings, stats_seconds=stats_s,
                 local_rows=len(x), n_global=n_global)
    return nb_model_from_counts(flat[:n_classes * d].reshape(n_classes, d),
                                flat[n_classes * d:], n_classes, smoothing)


def train_naive_bayes_coo_process_local(
        doc_ptr: np.ndarray, feat_idx: np.ndarray, counts: np.ndarray,
        y: np.ndarray, n_classes: int, n_features: int,
        smoothing: float = 1.0, col_scale: Optional[np.ndarray] = None,
        device="cuda", timings: Optional[dict] = None) -> NaiveBayesModel:
    """COO NB in a gang whose every rank holds the whole corpus (the
    merged read, as the reference's Text-Classification gang): each rank
    scatter-adds the entries of its contiguous block of documents
    (:func:`gang_rows`) on ``device``, the flat [C·D] sums are all-reduced
    once, and the class counts come from the whole ``y``. Exact integer
    sums: the single-process :func:`train_naive_bayes_coo` bit for bit.
    One process: that function."""
    if process_count() == 1:
        return train_naive_bayes_coo(doc_ptr, feat_idx, counts, y,
                                     n_classes, n_features, smoothing,
                                     col_scale, device=device)
    doc_ptr = np.asarray(doc_ptr)
    y = np.asarray(y, np.int32)
    lo, hi = gang_rows(len(y))
    a, b = int(doc_ptr[lo]), int(doc_ptr[hi])
    coll = HostCollectives()
    t0 = time.perf_counter()
    feat = nb_stats_coo(np.repeat(y[lo:hi], np.diff(doc_ptr[lo:hi + 1])),
                        np.asarray(feat_idx)[a:b],
                        np.asarray(counts, np.float32)[a:b], n_classes,
                        n_features, device)
    stats_s = time.perf_counter() - t0
    flat = coll.all_reduce(torch.from_numpy(feat.reshape(-1))).numpy()
    _gang_report(coll, timings, stats_seconds=stats_s, local_rows=hi - lo,
                 local_entries=b - a, n_global=len(y))
    return _nb_model_from_stats(flat.reshape(n_classes, n_features), y,
                                n_classes, smoothing, col_scale)


def train_logistic_regression_process_local(
        x: np.ndarray, y: np.ndarray, n_classes: int, reg: float = 0.0,
        max_iters: int = 100, tol: float = 1e-6, device="cuda",
        stats: Optional[dict] = None) -> LogisticRegressionModel:
    """LR over each rank's own example block (``:792``): :func:`lbfgs_fit`
    on a :class:`_SoftmaxNLL` whose data sums are all-reduced over the
    gang on every evaluation (gloo, through the host), divided by the
    gang-wide example count, with the regularizer added once after the
    sum. A rank with no rows still takes part in every sum. Every rank
    ends with the same parameters. One process:
    :func:`train_logistic_regression`. ``stats`` receives the L-BFGS
    counts, ``loss``, ``lbfgs_seconds``, the all-reduce's calls, bytes and
    seconds, ``local_rows`` and ``n_global``."""
    if process_count() == 1:
        return train_logistic_regression(x, y, n_classes, reg=reg,
                                         max_iters=max_iters, tol=tol,
                                         device=device, stats=stats)
    dev = resolve_device(device)
    coll = HostCollectives()
    xl, yl, ml, n_global = _assemble_process_shards(x, y, coll)
    out = {} if stats is None else stats
    with _ieee_f32():
        fn = _SoftmaxNLL(_put(xl, np.float32, dev), _put(yl, np.int64, dev),
                         n_classes, reg, mask=_put(ml, np.float32, dev),
                         n=n_global, reduce=coll.all_reduce)
        t0 = time.perf_counter()
        theta = lbfgs_fit(fn, torch.zeros(xl.shape[1] * n_classes + n_classes,
                                          dtype=torch.float32, device=dev),
                          int(max_iters), float(tol), out)
        # a collective: every rank evaluates it, stats or not
        out["loss"] = float(fn.value(theta)[0])
        out["lbfgs_seconds"] = time.perf_counter() - t0
        out["collectives"] = fn.collectives
        _gang_report(coll, out, local_rows=len(x), n_global=n_global)
        return _lr_model(fn, theta, n_classes)
