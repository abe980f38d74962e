"""Similar-Product template — implicit ALS, item-item cosine serving.

Port of ``incubator_predictionio_tpu/models/similar_product.py``: "view"
events train implicit ALS (``train_als`` with ``implicit_prefs``), item
categories come from the items' ``$set`` events, and a query returns the
catalog items whose summed cosine similarity to the query items is
highest, under the category / whiteList / blackList rules; the query items
themselves are never returned. The row-normalized catalog is made resident
on the model's device once, flat or host-sharded (``PIO_SERVE_SHARD_ITEMS``,
``models/_sharded_serving.py``). In a training gang the view events and
the item categories come from this worker's event-log partitions
(``workflow/train_feed.py``, one shared shard scan) and the ALS trains
data-parallel. Wire format (the template's)::

  query  {"items": ["i1"], "num": 4, "categories": ["c"],
          "whiteList": [...], "blackList": [...]}
  result {"itemScores": [{"item": ..., "score": ...}]}
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..controller import (
    Algorithm, DataSource, Engine, EngineFactory, Params, SanityCheck,
)
from ..data.bimap import BiMap
from ..data.events import aggregate_properties, find_ratings
from ..data.store import PEventStore
from ..device import resolve_device
from ..ops.als import (
    ALSFactors, ALSParams, train_als, train_als_partition_local,
)
from ..ops.topk import normalize_rows
from ..workflow import train_feed
from ._filters import CategoryIndex, build_exclude_mask
from ._sharded_serving import (
    ShardedCatalogServing, validate_serving_mode,
)


@dataclasses.dataclass
class TrainingData(SanityCheck):
    user_idx: np.ndarray
    item_idx: np.ndarray
    rating: np.ndarray  # implicit strength (1.0 per view)
    users: BiMap
    items: BiMap
    item_categories: dict[str, set[str]]  # item id → categories
    #: True when the triple holds only THIS gang worker's partitions; the
    #: maps and the categories are the gang's global ones
    partition_local: bool = False

    def sanity_check(self):
        if len(self.users if self.partition_local else self.user_idx) == 0:
            raise ValueError("no view events found")


PreparedData = TrainingData


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    event_names: Sequence[str] = ("view",)
    item_entity_type: str = "item"


class SimilarProductDataSource(DataSource):
    params_cls = DataSourceParams
    params_aliases = {"appName": "app_name", "eventNames": "event_names"}
    partition_feed = True

    def read_training(self, ctx) -> TrainingData:
        """The view events as a triple and the item categories replayed
        from the ``$set``/``$unset``/``$delete`` events: from ``ctx.events``
        when the caller handed events over, else from the event store (the
        reference's ``find_ratings`` + ``aggregate_properties`` read), or —
        with the partition feed armed — from this gang worker's
        partitions, both extractions off one shard scan."""
        p: DataSourceParams = self.params
        t0 = time.perf_counter()
        local = False
        if ctx.events is not None:
            u, i, r, users, items = find_ratings(
                ctx.events, event_names=list(p.event_names),
                rating_from_props=False)
            props = aggregate_properties(ctx.events, p.item_entity_type)
        elif train_feed.partition_feed_active(ctx.get_storage()):
            app_name = p.app_name or ctx.app_name
            storage = ctx.get_storage()
            feed_ctx = train_feed.open_feed(app_name, storage,
                                            ctx.channel_name)
            u, i, r, users, items = train_feed.partition_ratings(
                app_name, event_names=list(p.event_names),
                rating_from_props=False, storage=storage,
                channel_name=ctx.channel_name, feed_ctx=feed_ctx,
                report=ctx.read_timings)
            props = train_feed.partition_properties(
                app_name, p.item_entity_type, storage=storage,
                channel_name=ctx.channel_name, feed_ctx=feed_ctx)
            local = True
        else:
            app_name = p.app_name or ctx.app_name
            storage = ctx.get_storage()
            u, i, r, users, items = PEventStore.find_ratings(
                app_name, event_names=list(p.event_names),
                rating_from_props=False, storage=storage,
                channel_name=ctx.channel_name)
            props = PEventStore.aggregate_properties(
                app_name, p.item_entity_type, storage=storage)
        cats = {item_id: set(c) for item_id, pm in props.items()
                if (c := pm.get("categories"))}
        ctx.record_read(time.perf_counter() - t0, len(u))
        return TrainingData(u, i, r, users, items, cats,
                            partition_local=local)


@dataclasses.dataclass
class SimilarProductModel(ShardedCatalogServing):
    factors: ALSFactors
    items: BiMap
    item_categories: dict[str, set[str]]
    device: torch.device
    # catalog caching + layout selection: ShardedCatalogServing
    _sharded_cat: object = dataclasses.field(
        default=None, repr=False, compare=False)
    _cat_index: Optional[CategoryIndex] = dataclasses.field(
        default=None, repr=False, compare=False)

    def _host_catalog(self):
        """The served catalog holds row-normalized factors (normalized on
        the host once, at deploy time)."""
        return normalize_rows(self.factors.item_factors)

    def category_index(self) -> CategoryIndex:
        if self._cat_index is None:
            self._cat_index = CategoryIndex(self.items, self.item_categories)
        return self._cat_index

    def warm_up(self, num: int = 10):
        """Make the catalog resident and answer one query (deploy time)."""
        self.warm_catalog()
        if len(self.items):
            self.similar([next(iter(self.items.keys()))], num)

    def similar(self, query_items: Sequence[str], num: int,
                categories: Optional[Sequence[str]] = None,
                white_list: Optional[Sequence[str]] = None,
                black_list: Optional[Sequence[str]] = None):
        idxs = [j for j in (self.items.get(q) for q in query_items)
                if j is not None]
        if not idxs:
            return []
        exclude = build_exclude_mask(self.items, self.category_index(),
                                     categories, white_list, black_list)
        exclude[idxs] = True  # never return the query items themselves
        scores, idx = self.catalog().similar(self.factors.item_factors[idxs],
                                             num, exclude=exclude)
        return [(self.items.inverse(int(j)), float(s))
                for s, j in zip(scores, idx) if np.isfinite(s)]


@dataclasses.dataclass(frozen=True)
class SimilarProductAlgoParams(Params):
    rank: int = 10
    num_iterations: int = 20
    reg: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None
    # "auto" → float32; only float32 is ported
    compute_dtype: str = "auto"
    chunk_tiles: int = -1
    # engine.json "shardedServing": auto|always|never (ops/sharded_topk)
    sharded_serving: str = "auto"


class SimilarProductAlgorithm(Algorithm):
    params_cls = SimilarProductAlgoParams
    params_aliases = {
        "lambda": "reg", "numIterations": "num_iterations",
        "computeDtype": "compute_dtype", "chunkTiles": "chunk_tiles",
        "shardedServing": "sharded_serving",
    }

    def train(self, ctx, pd: PreparedData) -> SimilarProductModel:
        p = self.params
        validate_serving_mode(p.sharded_serving)  # before the run
        als_params = ALSParams(
            rank=p.rank, num_iterations=p.num_iterations, reg=p.reg,
            implicit_prefs=True, alpha=p.alpha,
            seed=p.seed if p.seed is not None else 3,
            compute_dtype=p.compute_dtype, chunk_tiles=p.chunk_tiles)
        trainer = (train_als_partition_local if pd.partition_local
                   else train_als)
        factors = trainer(
            pd.user_idx, pd.item_idx, pd.rating, n_users=len(pd.users),
            n_items=len(pd.items), params=als_params, device=ctx.device,
            checkpoint_hook=ctx.checkpoint_hook,
            resume=ctx.workflow_params.resume,
            nan_guard=ctx.workflow_params.nan_guard,
            nan_guard_stage=ctx.stage_label, timings=ctx.bench_timings)
        return SimilarProductModel(factors, pd.items, pd.item_categories,
                                   device=ctx.device)

    def predict(self, model: SimilarProductModel, query: dict) -> dict:
        pairs = model.similar(
            [str(x) for x in query.get("items", [])],
            int(query.get("num", 10)),
            categories=query.get("categories"),
            white_list=query.get("whiteList"),
            black_list=query.get("blackList"))
        return {"itemScores": [{"item": i, "score": s} for i, s in pairs]}

    def prepare_model_for_persistence(self, model: SimilarProductModel) -> dict:
        return model_to_persisted(model)

    def restore_model(self, stored, ctx) -> SimilarProductModel:
        return model_from_persisted(stored, ctx.device)


def model_to_persisted(model: SimilarProductModel) -> dict:
    """The reference's persisted dict (similar_product.py:236-241): numpy
    float32 factors, the persisted item BiMap and sorted category lists."""
    return {
        "user_factors": np.asarray(model.factors.user_factors, np.float32),
        "item_factors": np.asarray(model.factors.item_factors, np.float32),
        "items": model.items.to_persisted(),
        "item_categories": {k: sorted(v)
                            for k, v in model.item_categories.items()},
    }


def model_from_persisted(stored: dict, device="cuda") -> SimilarProductModel:
    uf = np.asarray(stored["user_factors"], np.float32)
    itf = np.asarray(stored["item_factors"], np.float32)
    return SimilarProductModel(
        factors=ALSFactors(uf, itf, uf.shape[0], itf.shape[0]),
        items=BiMap.from_persisted(stored["items"]),
        item_categories={k: set(v)
                         for k, v in stored["item_categories"].items()},
        device=resolve_device(device))


class SimilarProductEngine(EngineFactory):
    """engine.json: "engineFactory":
    "incubator_predictionio_torch.models.similar_product.SimilarProductEngine"
    """

    def apply(self) -> Engine:
        return Engine(
            data_source_class=SimilarProductDataSource,
            algorithm_class_map={"als": SimilarProductAlgorithm,
                                 "": SimilarProductAlgorithm},
        )
