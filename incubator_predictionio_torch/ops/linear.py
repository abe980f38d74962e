"""Linear models: multinomial Naive Bayes and L2 logistic regression.

Port of the single-device paths of ``incubator_predictionio_tpu/ops/
linear.py``. The JAX package left the device work to XLA; here it is torch
ops on ``device`` (the card by default):

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
  rule's numbers too (``stats["host_syncs"]``).

The log parameters (:func:`nb_model_from_counts`), the fold-ins
(:func:`nb_fold_in`, :func:`lr_sgd_steps`) and prediction are host numpy,
verbatim. Not ported here: the streamed uploads and the process-local
(gang) trainers.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Iterable, Optional

import numpy as np
import torch

from ..device import resolve_device


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


def train_naive_bayes(x: np.ndarray, y: np.ndarray, n_classes: int,
                      smoothing: float = 1.0,
                      col_scale: Optional[np.ndarray] = None,
                      device="cuda") -> NaiveBayesModel:
    """x [N, D] non-negative features, y [N] class ids. ``col_scale`` [D]
    (TF-IDF's idf) scales the class statistics, the same as training on
    ``x * col_scale`` without making that product; such a model keeps no
    statistics for a fold-in."""
    feat, counts = nb_stats(x, y, n_classes, device)
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


def train_naive_bayes_coo(doc_ptr: np.ndarray, feat_idx: np.ndarray,
                          counts: np.ndarray, y: np.ndarray, n_classes: int,
                          n_features: int, smoothing: float = 1.0,
                          col_scale: Optional[np.ndarray] = None,
                          device="cuda") -> NaiveBayesModel:
    """NB from the tokenizer's COO output (``TfIdfVectorizer.fit_tf_coo``):
    the dense [N, D] matrix never exists; the class counts are a host
    bincount, as in the reference."""
    y = np.asarray(y, np.int32)
    cls_per_entry = np.repeat(y, np.diff(np.asarray(doc_ptr)))
    feat = nb_stats_coo(cls_per_entry, feat_idx, counts, n_classes,
                        n_features, device)
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
    not regularized), with its analytic gradient."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, n_classes: int,
                 reg: float):
        self.x = x
        self.onehot = torch.nn.functional.one_hot(y, n_classes).to(x.dtype)
        self.n = float(x.shape[0])
        self.reg = float(reg)
        self.d, self.c = x.shape[1], n_classes
        self.evals = 0

    def split(self, theta: torch.Tensor):
        return theta[:self.d * self.c].view(self.d, self.c), \
            theta[self.d * self.c:]

    def value(self, theta: torch.Tensor):
        """(loss, log-probabilities): the latter feed :meth:`grad`."""
        self.evals += 1
        w, b = self.split(theta)
        logp = torch.log_softmax(self.x @ w + b, dim=1)
        nll = -(logp * self.onehot).sum(dim=1)
        return nll.sum() / self.n + 0.5 * self.reg * (w * w).sum(), logp

    def grad(self, theta: torch.Tensor, logp: torch.Tensor) -> torch.Tensor:
        w, _ = self.split(theta)
        g = (torch.exp(logp) - self.onehot) / self.n
        return torch.cat([(self.x.T @ g + self.reg * w).reshape(-1),
                          g.sum(dim=0)])


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
    evaluation of f; each line-search trial among them) and
    ``host_syncs`` (one device → host read per line-search trial).
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
            packed = torch.stack([err, new_value] + (
                [value, gnorm] if trial == 0 else [])).tolist()
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
        stats.update(iterations=it, loss_evals=fn.evals, host_syncs=syncs)
    return theta


def train_logistic_regression(x: np.ndarray, y: np.ndarray, n_classes: int,
                              reg: float = 0.0, max_iters: int = 100,
                              tol: float = 1e-6, device="cuda",
                              stats: Optional[dict] = None
                              ) -> LogisticRegressionModel:
    """Full-batch multinomial LR under :func:`lbfgs_fit` on ``device``
    (``train_logistic_regression`` :652 with ``_lr_fit`` :537), the
    parameters starting at zero. ``stats`` also receives the final
    ``loss``."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    d = x.shape[1]
    with _ieee_f32():
        fn = _SoftmaxNLL(_put(x, np.float32, dev), _put(y, np.int64, dev),
                         n_classes, reg)
        theta = lbfgs_fit(fn, torch.zeros(d * n_classes + n_classes,
                                          dtype=torch.float32, device=dev),
                          int(max_iters), float(tol), stats)
        if stats is not None:
            stats["loss"] = float(fn.value(theta)[0])
        w, b = fn.split(theta)
        w, b = w.cpu().numpy(), b.cpu().numpy()
    return LogisticRegressionModel(weights=np.asarray(w, np.float32),
                                   intercept=np.asarray(b, np.float32),
                                   n_classes=n_classes)
