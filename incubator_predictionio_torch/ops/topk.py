"""Top-k catalog scoring for serving (the ``recommendProducts`` hot path).

Port of ``incubator_predictionio_tpu/ops/topk.py``. Scores are the
row-invariant mul+reduce of the reference (``_topk_scores``); excluded items
score -inf. The order is the reference's ``lax.top_k`` order: score
descending, then index ascending. ``torch.topk`` does not promise that tie
order on CUDA, so candidates are ordered by a stable descending sort, which
keeps equal scores in ascending index order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _ordered_top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the k best along the last dim, score
    descending then index ascending."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_scores(user_vec: torch.Tensor, item_factors: torch.Tensor,
                 exclude_mask: Optional[torch.Tensor], k: int):
    # mul+reduce (not a gemv): the reduction over rank is then the same for
    # every row whatever the row count, as in the reference
    scores = (item_factors * user_vec[None, :]).sum(dim=1)  # [n_items]
    if exclude_mask is not None:
        scores = scores.masked_fill(exclude_mask, float("-inf"))
    return _ordered_top_k(scores, k)


def top_k_items(user_vec, item_factors: torch.Tensor, k: int,
                exclude=None):
    """Returns (scores[k], indices[k]) as host numpy arrays.

    ``item_factors`` is the device-resident catalog; ``user_vec`` a host
    vector; ``exclude`` an optional bool mask [n_items] of items to
    suppress.
    """
    dev = item_factors.device
    uv = torch.from_numpy(np.asarray(user_vec, np.float32)).to(dev)
    mask = None
    if exclude is not None:
        mask = torch.from_numpy(np.asarray(exclude, bool)).to(dev)
    k = min(int(k), item_factors.shape[0])
    with torch.no_grad():
        vals, idx = _topk_scores(uv, item_factors, mask, k)
    return vals.cpu().numpy(), idx.cpu().numpy()


def normalize_rows(x) -> np.ndarray:
    """Row-normalize a factor matrix on the host (float32), once at deploy
    time (the reference's rule: a device-side norm varies bitwise with
    the row count)."""
    x = np.asarray(x, np.float32)
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)


def similar_items(query_vecs, item_factors_normed: torch.Tensor, k: int,
                  exclude=None):
    """Summed cosine similarity of the query items against the catalog
    (Similar-Product). ``item_factors_normed`` is the device-resident,
    row-normalized catalog. Σ_q ⟨f, q̂⟩ = ⟨f, Σ_q q̂⟩, so this is one
    :func:`top_k_items` over the summed normalized query vectors."""
    qn = normalize_rows(np.atleast_2d(np.asarray(query_vecs, np.float32)))
    return top_k_items(qn.sum(axis=0), item_factors_normed, k,
                       exclude=exclude)


def bucket_k(k: int, n_total: int) -> int:
    """Pow2 (≥8) k buckets, as the reference, so results for varying
    ``num`` are prefixes of one computation."""
    return min(max(8, 1 << max(k - 1, 0).bit_length()), n_total)


def pad_batch_pow2(user_vecs: np.ndarray) -> np.ndarray:
    """Pad the batch dim to the next power of two (batches > 256 pass
    through), as the reference; padded rows are zero vectors."""
    b = user_vecs.shape[0]
    bp = (1 << max(b - 1, 0).bit_length()) if b <= 256 else b
    if bp == b:
        return user_vecs
    return np.concatenate(
        [user_vecs,
         np.zeros((bp - b,) + user_vecs.shape[1:], user_vecs.dtype)],
        axis=0)


def batch_top_k(user_vecs, item_factors: torch.Tensor, k: int):
    """Top-k for a batch of user vectors (batch_predict and eval): one
    product [b, n_items] and one ordered top-k. Host numpy out."""
    user_vecs = np.asarray(user_vecs, np.float32)
    n_items = item_factors.shape[0]
    k = min(int(k), n_items)
    b = user_vecs.shape[0]
    kp = bucket_k(k, n_items)
    uv = torch.from_numpy(pad_batch_pow2(user_vecs)).to(item_factors.device)
    with torch.no_grad():
        scores = uv @ item_factors.T
        vals, idx = _ordered_top_k(scores, kp)
    return vals[:b, :k].cpu().numpy(), idx[:b, :k].cpu().numpy()
