"""Template-facing serving-catalog facade for the ALS-family models.

Port of ``incubator_predictionio_tpu/models/_sharded_serving.py``.
``ShardedCatalog`` is the ONE object the templates score through; it picks
the device layout at construction and the templates never see which path
answered (only this module touches ``ops/sharded_topk``):

- ``mesh`` — a serving mesh was assigned (``serving_mesh_for`` at train
  and restore: a catalog past one device's budget, or
  ``"shardedServing": "always"``): dim 0 split over the mesh's devices,
  each shard's partial top-k gathered to the first and merged.
- ``host`` — ``PIO_SERVE_SHARD_ITEMS`` > 0 and the vocabulary is larger:
  the catalog lives stacked [S, rows, rank] on the model's device and each
  shard's partial top-k is merged exactly, so the batched path's score
  memory peaks at one shard — the million-item single-process path.
- ``flat`` — the whole matrix on the model's device (the default; knob
  unset ⇒ the flat kernels of ``ops/topk.py``, unchanged).

All three layouts answer bit-identically on the single-query and
similarity paths, and with identical indices on the batched path.

Each template model keeps two dataclass fields (``serving_mesh``,
``_sharded_cat``) and mixes in ``ShardedCatalogServing`` for the caching,
so the layout policy lives in one place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sharded_topk import (  # noqa: F401  (serving_mesh_for and
    # validate_serving_mode are re-exported: templates import the whole
    # sharding surface from HERE, never from ops.sharded_topk)
    env_serve_shard_items,
    host_sharded_batch_top_k,
    host_sharded_score_user,
    host_sharded_similar_items,
    host_sharded_top_k_items,
    put_host_sharded_catalog,
    put_host_sharded_indicators,
    put_sharded_catalog,
    serving_mesh_for,
    sharded_batch_top_k,
    sharded_similar_items,
    sharded_top_k_items,
    validate_serving_mode,
)
from ..ops.llr import score_user
from ..ops.topk import batch_top_k, similar_items, top_k_items

__all__ = [
    "ShardedCatalog", "ShardedCatalogServing", "ShardedIndicators",
    "serving_mesh_for", "validate_serving_mode",
]


class ShardedCatalog:
    """Layout-selecting serving catalog: factor rows resident in the
    layout the policy picked (over ``serving_mesh``'s devices, else on
    ``device`` as the knob says), scored through one API."""

    def __init__(self, host_factors, device, serving_mesh=None):
        x = np.ascontiguousarray(host_factors, np.float32)
        self.n_items = int(x.shape[0])
        rows = env_serve_shard_items()
        if serving_mesh is not None:
            self.layout = "mesh"
            self._cat = put_sharded_catalog(x, serving_mesh)
        elif 0 < rows < self.n_items:
            self.layout = "host"
            self._cat = put_host_sharded_catalog(x, rows, device)
        else:
            self.layout = "flat"
            self._cat = torch.from_numpy(x).to(device)

    @property
    def n_shards(self) -> int:
        return self._cat.n_shards if self.layout != "flat" else 1

    @property
    def resident(self):
        """The device tensor holding the catalog: [N, rank] flat, or
        [S, rows, rank] host-sharded; on a mesh, the list of its shards'
        [rows, rank] tensors."""
        if self.layout == "mesh":
            return list(self._cat.shards)
        return self._cat.dev if self.layout == "host" else self._cat

    def top_k(self, user_vec, k: int, exclude=None):
        """(scores[k'], idx[k']) host numpy; ``exclude`` an optional
        bool [n_items] business-rule mask (True = suppressed), applied
        per shard BEFORE the partial top-k."""
        if self.layout == "mesh":
            return sharded_top_k_items(user_vec, self._cat, k,
                                       exclude=exclude)
        if self.layout == "host":
            return host_sharded_top_k_items(user_vec, self._cat, k,
                                            exclude=exclude)
        return top_k_items(user_vec, self._cat, k, exclude=exclude)

    def batch_top_k(self, user_vecs, k: int):
        """Micro-batch window path: one call for the whole coalesced
        batch, whatever the layout."""
        if self.layout == "mesh":
            return sharded_batch_top_k(user_vecs, self._cat, k)
        if self.layout == "host":
            return host_sharded_batch_top_k(user_vecs, self._cat, k)
        return batch_top_k(user_vecs, self._cat, k)

    def similar(self, query_vecs, k: int, exclude=None):
        """Summed-cosine similarity — the catalog must hold ROW-NORMALIZED
        factors (Similar-Product's ``_host_catalog``)."""
        if self.layout == "mesh":
            return sharded_similar_items(query_vecs, self._cat, k,
                                         exclude=exclude)
        if self.layout == "host":
            return host_sharded_similar_items(query_vecs, self._cat, k,
                                              exclude=exclude)
        return similar_items(query_vecs, self._cat, k, exclude=exclude)


class ShardedIndicators:
    """The Universal Recommender's serve-side twin of ShardedCatalog: its
    catalog is per-event-type correlator tables (ops.llr.Indicators), so
    sharding stacks each type's [I, K] table and the scorer merges
    per-shard partial top-ks. Unsharded (knob off or small vocabulary) it
    delegates to ops.llr.score_user unchanged."""

    def __init__(self, indicators: dict, n_items: int, device):
        self.n_items = int(n_items)
        self.device = device
        self._plain = indicators
        rows = env_serve_shard_items()
        if 0 < rows < self.n_items:
            self._sharded = {
                name: put_host_sharded_indicators(ind, rows, device)
                for name, ind in indicators.items()}
        else:
            self._sharded = None
            for ind in indicators.values():
                ind.on(device)  # resident once, as the flat scorer reads it

    @property
    def layout(self) -> str:
        return "host" if self._sharded is not None else "flat"

    def score_user(self, entries, k: int, exclude, item_boost):
        """``entries``: [(event name, membership[N] f32, boost)] in
        scoring order; returns (scores[k'], idx[k']) bit-identical across
        layouts."""
        if self._sharded is None:
            lst = [(self._plain[n], m, b) for n, m, b in entries]
            return score_user(lst, k, exclude=exclude,
                              item_boost=item_boost, device=self.device)
        lst = [(self._sharded[n], np.asarray(m, np.float32), b)
               for n, m, b in entries]
        return host_sharded_score_user(lst, k, self.n_items,
                                       exclude, item_boost)


class ShardedCatalogServing:
    """Caches the device-resident ``ShardedCatalog`` picked by the
    deploy-time ``serving_mesh`` decision and the ``PIO_SERVE_SHARD_ITEMS``
    knob. Without the cache every query would upload the whole matrix: the
    serving path uploads only the rank-float query vector.

    Subclasses override ``_host_catalog()`` when the served factors are
    not the raw item factors (Similar-Product serves row-normalized
    vectors). A model made by a fold-in, a refresh or a rollback starts
    with the cache empty, so its catalog is built from its own factors."""

    def _host_catalog(self):
        return self.factors.item_factors

    def catalog(self) -> ShardedCatalog:
        if self._sharded_cat is None:
            self._sharded_cat = ShardedCatalog(
                self._host_catalog(), self.device, self.serving_mesh)
        return self._sharded_cat

    def warm_catalog(self) -> None:
        """Make the catalog resident (called from the model's warm_up)."""
        self.catalog()
