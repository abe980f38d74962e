"""Host-sharded top-k: million-item catalogs on one device.

Port of the host half of ``incubator_predictionio_tpu/ops/sharded_topk.py``
(``env_serve_shard_items`` :275 through ``host_sharded_score_user`` :492)
and of its serving policy (``_serving_shard_threshold_bytes`` :102,
``validate_serving_mode`` :135, ``should_shard_serving`` :144). The
reference's XLA programs (``_host_topk_fn`` :333, ``_host_ur_topk_fn``
:454) become torch ops on the model's device; ``lax.scan`` over the shard
axis becomes one batched pass over the stacked ``[S, rows, rank]`` catalog
for a single query and a loop over the shards for a batch, so the batched
path's score memory peaks at one shard's ``[b, rows]`` row block.

The contract is the reference's:

- padding rows and excluded rows score -inf BEFORE the partial top-k;
- each shard keeps ``kl = min(k, rows)`` candidates, chosen exactly in the
  flat order (score descending, then index ascending): the ``kl``-th
  largest value is the threshold, every larger score is kept and the
  lowest indices among the scores equal to it fill the rest;
- the merge orders the ``S·kl`` candidates by score descending, then by
  global index ascending. Equal scores among the candidates are laid out
  in ascending global index, so one stable descending sort gives that
  order.

The single-query and similarity scores are computed on the flattened
``[S·rows, rank]`` view with the flat scorer's own mul+reduce
(``ops/topk.py``), whose reduction over the rank is per row and does not
depend on the row count; the UR scores every row with ``ops/llr.py``'s
``_score_history`` on the flattened correlator tables. The batched path
runs one GEMM per shard: its indices equal the flat ``[b, N]`` GEMM's, its
scores may differ from it by the GEMM's blocking.

The mesh layout (``ShardedCatalog`` :65, ``_sharded_topk_fn`` :172 and
``sharded_*`` :236-273) needs more than one card: ROADMAP.md Queue 1,
item 7.4. The policy here names it where it would be chosen.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ..common import envknobs
from .llr import _score_history
from .topk import bucket_k, normalize_rows, pad_batch_pow2

log = logging.getLogger("pio.torch.sharded_topk")

__all__ = [
    "HostShardedCatalog", "HostShardedIndicators", "env_serve_shard_items",
    "host_sharded_batch_top_k", "host_sharded_score_user",
    "host_sharded_similar_items", "host_sharded_top_k_items",
    "put_host_sharded_catalog", "put_host_sharded_indicators",
    "serving_mesh_for", "should_shard_serving", "validate_serving_mode",
]

#: what the mesh layout waits for
MESH_ITEM = "ROADMAP.md Queue 1, item 7.4"


# -- sharding decision -----------------------------------------------------


def _serving_shard_threshold_bytes(device=None) -> int:
    """Catalog size beyond which "auto" shards serving: an explicit
    PIO_SHARDED_SERVING_BYTES wins (malformed → warn + device default);
    otherwise 1/4 of the card's memory, or 1/4 of 4 GiB for a device that
    reports none (the CPU), as the reference assumes for such a device."""
    raw = envknobs.env_str("PIO_SHARDED_SERVING_BYTES", "")
    if raw:
        explicit = envknobs.env_int("PIO_SHARDED_SERVING_BYTES", 0,
                                    float_ok=True)
        if explicit > 0:
            return explicit
        warnings.warn(
            f"PIO_SHARDED_SERVING_BYTES={raw!r} is not a positive "
            "number; using the device-derived default", stacklevel=2)
    limit = 0
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        limit = int(torch.cuda.get_device_properties(dev).total_memory)
    if limit <= 0:
        limit = 4 * 1024 ** 3
    return limit // 4


def validate_serving_mode(mode: str) -> str:
    """Fail fast on a bad "shardedServing" value — called at the TOP of
    train so a typo dies before the ALS run, not after it."""
    if mode not in ("auto", "always", "never"):
        raise ValueError(
            f"shardedServing={mode!r}: expected auto|always|never")
    return mode


def should_shard_serving(n_items: int, rank: int, n_devices: int,
                         mode: str = "auto", device=None) -> bool:
    """Deploy-time policy: split the item factors over ``n_devices``?

    mode: "never" | "always" | "auto" (auto → shard when the float32
    factor matrix exceeds the per-device budget). One device never shards
    (nothing to split), whatever the mode."""
    validate_serving_mode(mode)
    if mode == "never" or int(n_devices) <= 1:
        return False
    if mode == "always":
        return True
    return n_items * rank * 4 > _serving_shard_threshold_bytes(device)


def serving_mesh_for(device, n_items: int, rank: int, mode: str,
                     n_devices: int = 1) -> None:
    """The layout decision for a catalog served over ``n_devices``: None
    (the flat catalog, or the host-sharded one under
    PIO_SERVE_SHARD_ITEMS) wherever the policy keeps one device, which is
    always the case for a model on one torch device. Where the policy
    would pick the mesh layout it raises, naming the item that ports it
    and wires this decision into the templates' train and restore."""
    if should_shard_serving(n_items, rank, n_devices, mode, device):
        raise NotImplementedError(
            f"shardedServing={mode!r} over {n_devices} devices picks the "
            f"mesh layout, which is not ported yet: {MESH_ITEM}")
    return None


# -- host sharding: million-item catalogs on ONE device --------------------


def env_serve_shard_items() -> int:
    """Rows per host shard (PIO_SERVE_SHARD_ITEMS). 0 (the default)
    disables host sharding: serving is then the flat catalog's path."""
    raw = os.environ.get("PIO_SERVE_SHARD_ITEMS", "").strip()
    rows = envknobs.env_int("PIO_SERVE_SHARD_ITEMS", 0, lo=0, float_ok=True)
    if raw and rows == 0 and raw not in ("0", "0.0"):
        log.warning("PIO_SERVE_SHARD_ITEMS=%r is not a row count; host "
                    "sharding stays off", raw)
    return rows


@dataclasses.dataclass
class HostShardedCatalog:
    """Item factors stacked ``[S, rows_per_shard, rank]`` on one device.

    Rows ``n_items..S*rows_per_shard-1`` (the last shard's tail) are zero
    padding; the scorer masks them to -inf so they can never displace a
    real item. The shard count is a capacity choice
    (``PIO_SERVE_SHARD_ITEMS``), not a device count."""

    dev: torch.Tensor
    n_items: int
    #: [S, rows] True on the padding rows, and each shard's first global
    #: index [S] (made once, beside the catalog)
    pad: torch.Tensor = dataclasses.field(default=None, repr=False)
    base: torch.Tensor = dataclasses.field(default=None, repr=False)

    @property
    def rows_per_shard(self) -> int:
        return self.dev.shape[1]

    @property
    def n_shards(self) -> int:
        return self.dev.shape[0]


def _stack_shards(x: np.ndarray, rows_per_shard: int, fill=0) -> np.ndarray:
    """[N, ...] → [S, rows_per_shard, ...] with the tail padded by
    ``fill``."""
    n = x.shape[0]
    shards = max(1, -(-n // rows_per_shard))
    pad = shards * rows_per_shard - n
    if pad:
        x = np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0)
    return x.reshape((shards, rows_per_shard) + x.shape[1:])


def put_host_sharded_catalog(item_factors, rows_per_shard: int,
                             device) -> HostShardedCatalog:
    """Host factors → a catalog stacked on a shard axis on ``device``."""
    x = np.asarray(item_factors, np.float32)
    rows_per_shard = min(max(1, int(rows_per_shard)), max(1, x.shape[0]))
    stacked = np.ascontiguousarray(_stack_shards(x, rows_per_shard))
    dev = torch.from_numpy(stacked).to(device)
    shards = stacked.shape[0]
    return HostShardedCatalog(
        dev, x.shape[0],
        pad=_dead_rows(rows_per_shard, shards, x.shape[0], None, dev.device),
        base=torch.arange(shards, device=dev.device) * rows_per_shard)


def _select_partial(scores: torch.Tensor, kl: int):
    """The ``kl`` best of every row of ``scores`` [B, n] in the flat order
    (score descending, index ascending): (values [B, kl], columns [B, kl]).
    ``torch.topk`` gives the threshold (the ``kl``-th largest value) only;
    the kept set is every score above it plus the lowest columns among
    the scores equal to it, chosen exactly by a second, integer top-k over
    a key that ranks those columns first. The columns come back with the
    ones above the threshold first, each group in ascending column order,
    so equal scores always sit in ascending column order.

    NaN ranks above every number, as in the flat path's sort and in
    ``torch.topk``: a NaN threshold keeps the lowest NaN columns, and
    under a number threshold every NaN is above it."""
    n = scores.shape[1]
    thr = torch.topk(scores, kl, dim=1).values[:, kl - 1:kl]
    nan, thr_nan = torch.isnan(scores), torch.isnan(thr)
    above = (scores > thr) | (nan & ~thr_nan)
    equal = (scores == thr) | (nan & thr_nan)
    # int32 keys (a shard holds far fewer than 2**30 rows): the second
    # top-k's radix select then makes half the passes of an int64 one
    cols = torch.arange(n, device=scores.device, dtype=torch.int32)
    key = torch.where(above, cols - n, torch.where(equal, cols, 2 * n))
    picked = torch.topk(key, kl, dim=1, largest=False).values
    cols = torch.where(picked < 0, picked + n, picked).long()
    return scores.gather(1, cols), cols


def _merge(cand_s: torch.Tensor, cand_i: torch.Tensor, kk: int):
    """Candidates laid out shard by shard, equal scores in ascending
    global index → the first ``kk`` by score descending, then index
    ascending (a stable descending sort)."""
    vals, order = torch.sort(cand_s, dim=1, descending=True, stable=True)
    return vals[:, :kk], cand_i.gather(1, order[:, :kk])


def _dead_rows(cat_rows: int, n_shards: int, n_items: int,
               excl: Optional[torch.Tensor], device) -> torch.Tensor:
    rows = torch.arange(n_shards * cat_rows, device=device).view(
        n_shards, cat_rows)
    dead = rows >= n_items
    return dead if excl is None else dead | excl


def _host_topk(qv: torch.Tensor, cat: HostShardedCatalog,
               excl: Optional[torch.Tensor], k: int):
    """(scores [b, kk], global idx [b, kk]) of the query rows ``qv``
    [b, rank] over every shard of ``cat``."""
    items, base = cat.dev, cat.base
    shards, nl, rank = items.shape
    kl = min(k, nl)
    dead = cat.pad if excl is None else cat.pad | excl
    if qv.shape[0] == 1:
        # the flat scorer's mul+reduce on the [S·rows, rank] view: every
        # row's reduction is the flat catalog's, bit for bit
        scores = (items.view(shards * nl, rank) * qv[0][None, :]).sum(
            dim=1).view(shards, nl)
        scores = scores.masked_fill(dead, float("-inf"))
        vals, cols = _select_partial(scores, kl)  # [S, kl]
        cand_s = vals.reshape(1, shards * kl)
        cand_i = (cols + base[:, None]).reshape(1, shards * kl)
    else:
        parts_s, parts_i = [], []
        for s in range(shards):  # one shard's [b, rows] scores at a time
            scores = (qv @ items[s].T).masked_fill(dead[s][None, :],
                                                   float("-inf"))
            vals, cols = _select_partial(scores, kl)
            parts_s.append(vals)
            parts_i.append(cols + base[s])
            del scores
        cand_s = torch.cat(parts_s, dim=1)
        cand_i = torch.cat(parts_i, dim=1)
    return _merge(cand_s, cand_i, min(k, shards * kl))


def host_sharded_top_k_items(user_vec, cat: HostShardedCatalog, k: int,
                             exclude=None):
    """Host-sharded analog of ops.topk.top_k_items — (scores[k], idx[k])
    host numpy, bit-identical to the flat catalog's answer."""
    dev = cat.dev.device
    k = min(int(k), cat.n_items)
    kp = bucket_k(k, cat.n_items)
    qv = torch.from_numpy(np.asarray(user_vec, np.float32)[None, :]).to(dev)
    excl = None
    if exclude is not None:
        excl = torch.from_numpy(np.ascontiguousarray(_stack_shards(
            np.asarray(exclude, bool), cat.rows_per_shard,
            fill=True))).to(dev)
    with torch.no_grad():
        s, i = _host_topk(qv, cat, excl, kp)
    return s[0, :k].cpu().numpy(), i[0, :k].cpu().numpy()


def host_sharded_batch_top_k(user_vecs, cat: HostShardedCatalog, k: int):
    """Host-sharded analog of ops.topk.batch_top_k (the same pow2 batch
    padding), for the micro-batch window: one pass scores the whole
    batch against every shard, one shard's score block at a time."""
    user_vecs = np.asarray(user_vecs, np.float32)
    k = min(int(k), cat.n_items)
    b = user_vecs.shape[0]
    kp = bucket_k(k, cat.n_items)
    qv = torch.from_numpy(pad_batch_pow2(user_vecs)).to(cat.dev.device)
    with torch.no_grad():
        s, i = _host_topk(qv, cat, None, kp)
    return s[:b, :k].cpu().numpy(), i[:b, :k].cpu().numpy()


def host_sharded_similar_items(query_vecs, cat: HostShardedCatalog, k: int,
                               exclude=None):
    """Host-sharded analog of ops.topk.similar_items — ``cat`` holds
    ROW-NORMALIZED factors; the query fold keeps this on the bit-exact
    single-query path."""
    qn = normalize_rows(np.atleast_2d(np.asarray(query_vecs, np.float32)))
    return host_sharded_top_k_items(qn.sum(axis=0), cat, k, exclude=exclude)


# -- host sharding for the universal recommender's indicator scorer -------


@dataclasses.dataclass
class HostShardedIndicators:
    """One event type's correlator table stacked ``[S, rows, K]`` on one
    device. Padding rows hold idx=-1 (the "no correlator" value), so their
    gathered membership — and score — is zero; the scorer also masks them
    to -inf before the partial top-k."""

    idx: torch.Tensor    # int64 [S, nl, K]
    score: torch.Tensor  # float32 [S, nl, K]

    @property
    def rows_per_shard(self) -> int:
        return self.idx.shape[1]

    @property
    def n_shards(self) -> int:
        return self.idx.shape[0]


def put_host_sharded_indicators(indicators, rows_per_shard: int,
                                device) -> HostShardedIndicators:
    """ops.llr.Indicators → the stacked shard layout on ``device``."""
    idx = np.asarray(indicators.idx, np.int64)
    score = np.asarray(indicators.score, np.float32)
    rows_per_shard = min(max(1, int(rows_per_shard)), max(1, idx.shape[0]))
    return HostShardedIndicators(
        torch.from_numpy(np.ascontiguousarray(
            _stack_shards(idx, rows_per_shard, fill=-1))).to(device),
        torch.from_numpy(np.ascontiguousarray(
            _stack_shards(score, rows_per_shard))).to(device))


def host_sharded_score_user(indicator_list, k: int, n_items: int,
                            exclude, item_boost):
    """Host-sharded analog of ops.llr.score_user. ``indicator_list`` is
    [(HostShardedIndicators, membership[N] f32, boost)], ``exclude`` a
    bool [N] mask (True = suppressed) or None, ``item_boost`` a float [N]
    vector or None; returns host (scores[k'], idx[k']) with k' = min(k,
    n_items), bit-identical to the flat scorer: every row runs the flat
    scorer's gather + dot on the flattened tables, and a boost of None or
    an exclude of None is the identity (×1.0 and no mask are exact)."""
    if not indicator_list:
        raise ValueError("host_sharded_score_user needs >=1 indicator type")
    first = indicator_list[0][0]
    dev = first.idx.device
    shards, nl = first.n_shards, first.rows_per_shard
    k_eff = min(int(k), int(n_items))
    kl = min(k_eff, nl)
    with torch.no_grad():
        total = None
        for ind, membership, boost in indicator_list:
            m = torch.from_numpy(np.ascontiguousarray(
                membership, np.float32)).to(dev)
            s = _score_history(ind.idx.view(shards * nl, -1),
                               ind.score.view(shards * nl, -1), m,
                               float(np.float32(boost)))
            total = s if total is None else total + s
        if item_boost is not None:
            ib = np.zeros(shards * nl, np.float32)
            ib[:n_items] = np.asarray(item_boost, np.float32)
            total = total * torch.from_numpy(ib).to(dev)
        total = total.view(shards, nl)
        excl = None
        if exclude is not None:
            excl = torch.from_numpy(np.ascontiguousarray(_stack_shards(
                np.asarray(exclude, bool), nl, fill=True))).to(dev)
        total = total.masked_fill(
            _dead_rows(nl, shards, n_items, excl, dev), float("-inf"))
        vals, cols = _select_partial(total, kl)
        base = torch.arange(shards, device=dev) * nl
        s, i = _merge(vals.reshape(1, shards * kl),
                      (cols + base[:, None]).reshape(1, shards * kl),
                      min(k_eff, shards * kl))
    return s[0].cpu().numpy(), i[0].cpu().numpy()
