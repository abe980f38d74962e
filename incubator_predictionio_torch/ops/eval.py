"""Ranking-quality metrics (MAP@k, NDCG@k, in-list AUC) and the windowed
canary-vs-last-good verdict.

Port of ``incubator_predictionio_tpu/ops/eval.py``: ``_ranking_metrics``
(:40) is plain torch ops on an explicit device over a pow2-padded [b, k]
relevance matrix; each call uploads one packed array and reads one
5-vector back (one host transfer each way). The conventions are the
reference's:

- A sample is one ranked item list (best first, truncated to k) and the
  set of held-out relevant items.
- Samples with an empty label set are invalid (nothing to grade).
- AP@k divides by min(|labels|, k).
- NDCG@k uses binary gains with 1/log2(pos+1) discounts; IDCG places the
  min(|labels|, k) relevant items first.
- AUC is in-list: the probability that a relevant item outranks an
  irrelevant one within the returned list; samples whose list is all
  relevant or all irrelevant carry no pairs and are left out of the AUC
  mean (counted as ``n_auc``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from .topk import pad_batch_pow2

__all__ = ["MetricWindow", "bucket_k_eval", "quality_verdict",
           "ranking_metrics", "ranking_metrics_calls"]


class CallStats:
    """Calls of :func:`ranking_metrics` that reached the device in this
    process, and their wall seconds (the read-back included)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.seconds = 0.0


ranking_metrics_calls = CallStats()


def _ranking_metrics(rel, pmask, n_rel, valid) -> torch.Tensor:
    # rel:   [b, k] 0/1 relevance at each ranked position
    # pmask: [b, k] 1 where a real ranked item exists (a prefix)
    # n_rel: [b] held-out relevant-item count per sample
    # valid: [b] 1 for real samples (batch rows are pow2-padded)
    k = rel.shape[1]
    pos = torch.arange(1, k + 1, dtype=torch.float32, device=rel.device)
    kf = torch.tensor(float(k), device=rel.device)
    rel = rel * pmask
    cum = torch.cumsum(rel, dim=1)
    # AP@k: precision is read only at relevant positions, all inside the
    # real prefix, so the padded tail never contributes
    ap = (rel * (cum / pos[None, :])).sum(dim=1)
    ap = ap / torch.clamp(torch.minimum(n_rel, kf), min=1.0)
    disc = 1.0 / torch.log2(pos + 1.0)
    dcg = (rel * disc[None, :]).sum(dim=1)
    ideal = pos[None, :] <= torch.minimum(n_rel, kf)[:, None]
    idcg = (ideal.to(torch.float32) * disc[None, :]).sum(dim=1)
    ndcg = dcg / torch.clamp(idcg, min=1e-9)
    # in-list AUC with one cumsum: for each relevant position, the
    # concordant pairs are the negatives ranked below it
    neg = pmask * (1.0 - rel)
    neg_above = torch.cumsum(neg, dim=1) - neg
    n_pos = rel.sum(dim=1)
    n_neg = neg.sum(dim=1)
    concordant = (rel * (n_neg[:, None] - neg_above)).sum(dim=1)
    pairs = n_pos * n_neg
    auc = concordant / torch.clamp(pairs, min=1.0)
    has_pairs = valid * (pairs > 0).to(torch.float32)
    n = valid.sum()
    n_auc = has_pairs.sum()
    return torch.stack([
        (ap * valid).sum() / torch.clamp(n, min=1.0),
        (ndcg * valid).sum() / torch.clamp(n, min=1.0),
        (auc * has_pairs).sum() / torch.clamp(n_auc, min=1.0),
        n,
        n_auc,
    ])


def bucket_k_eval(k: int) -> int:
    """Pow2 (≥ 8) k bucket, as the reference (``ops/topk.bucket_k``
    without the catalog cap)."""
    return max(8, 1 << max(int(k) - 1, 0).bit_length())


def ranking_metrics(ranked, labels, k: int, device="cuda") -> dict:
    """Score a batch of samples on ``device``: ``ranked`` is a sequence of
    ranked item-id lists (best first), ``labels`` the parallel sequence of
    held-out relevant-item collections. Returns the mean ``map`` /
    ``ndcg`` / ``auc`` and the sample counts they were averaged over
    (``n`` graded samples, ``n_auc`` of them carrying AUC pairs)."""
    b = len(ranked)
    zero = {"map": 0.0, "ndcg": 0.0, "auc": 0.0, "n": 0, "n_auc": 0}
    if b == 0:
        return zero
    k = max(1, int(k))
    kp = bucket_k_eval(k)
    # one packed host array [b, 2·kp + 2]: rel | pmask | n_rel | valid
    packed = np.zeros((b, 2 * kp + 2), np.float32)
    for i, (items, labs) in enumerate(zip(ranked, labels)):
        labs = set(labs)
        if not labs:
            continue
        packed[i, 2 * kp + 1] = 1.0
        packed[i, 2 * kp] = float(len(labs))
        for j, item in enumerate(items[:k]):
            packed[i, kp + j] = 1.0
            if item in labs:
                packed[i, j] = 1.0
    if not packed[:, 2 * kp + 1].any():
        return zero
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        x = torch.from_numpy(pad_batch_pow2(packed)).to(dev)
        out = _ranking_metrics(x[:, :kp], x[:, kp:2 * kp], x[:, 2 * kp],
                               x[:, 2 * kp + 1]).cpu().numpy()
    ranking_metrics_calls.calls += 1
    ranking_metrics_calls.seconds += time.perf_counter() - t0
    m, nd, auc, n, n_auc = (float(v) for v in out)
    return {"map": m, "ndcg": nd, "auc": auc,
            "n": int(round(n)), "n_auc": int(round(n_auc))}


class MetricWindow:
    """Host-side accumulator for one watch window: folds per-tick
    ``ranking_metrics`` batches into running sums, so the verdict reads a
    whole-window mean."""

    __slots__ = ("map_sum", "ndcg_sum", "auc_sum", "n", "n_auc")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.map_sum = 0.0
        self.ndcg_sum = 0.0
        self.auc_sum = 0.0
        self.n = 0
        self.n_auc = 0

    def add(self, metrics: dict) -> None:
        n = int(metrics.get("n", 0))
        if n <= 0:
            return
        self.map_sum += metrics["map"] * n
        self.ndcg_sum += metrics["ndcg"] * n
        self.n += n
        n_auc = int(metrics.get("n_auc", 0))
        self.auc_sum += metrics.get("auc", 0.0) * n_auc
        self.n_auc += n_auc

    def means(self) -> dict:
        n = max(self.n, 1)
        return {"map": self.map_sum / n, "ndcg": self.ndcg_sum / n,
                "auc": self.auc_sum / max(self.n_auc, 1),
                "n": self.n, "n_auc": self.n_auc}


def quality_verdict(canary: dict, last_good: dict, *,
                    min_samples: int, max_drop: float):
    """Windowed canary-vs-last-good comparison with a minimum-sample gate.
    Both inputs are ``MetricWindow.means()``-shaped dicts scored over the
    same queries and labels. Returns ``(breach, deltas)``:
    ``deltas[metric] = last_good − canary`` (positive: the canary is
    worse); ``breach`` is True only when both windows carry at least
    ``min_samples`` graded samples and the NDCG drop exceeds
    ``max_drop``."""
    deltas = {m: round(float(last_good.get(m, 0.0))
                       - float(canary.get(m, 0.0)), 6)
              for m in ("map", "ndcg", "auc")}
    floor = max(1, int(min_samples))
    n = min(int(canary.get("n", 0)), int(last_good.get("n", 0)))
    breach = n >= floor and deltas["ndcg"] > float(max_drop)
    return breach, deltas
