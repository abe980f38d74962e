"""E-Commerce Recommendation template — implicit ALS over view/buy events,
with serve-time exclusions.

Port of ``incubator_predictionio_tpu/models/ecommerce.py``: the view and
buy events train implicit ALS (``train_als`` with ``implicit_prefs``, the
warp kernel at rank ≤ 32), item categories come from the items' ``$set``
events, and a query is answered from the serving catalog, resident on the
model's device flat or host-sharded (``PIO_SERVE_SHARD_ITEMS``,
``models/_sharded_serving.py``), with an exclude mask applied per shard
before the partial top-k. At serve
time the mask takes, besides the category / whiteList / blackList rules,
the items of the user's 200 latest ``seenEvents`` events (unless
``unseenOnly`` is false) and the items of the latest ``$set`` of the
entity ``constraint/unavailableItems``: both are read from the event
store through ``LEventStore`` on every query. Wire format (the
template's)::

  query  {"user": "u1", "num": 4, "categories": [...],
          "whiteList": [...], "blackList": [...], "unseenOnly": true}
  result {"itemScores": [{"item": ..., "score": ...}]}

The reference swallows any exception of those two reads as "no
exclusions"; the port catches only the storage's own error
(``StorageError``), so a fault of the port cannot pass as an empty set.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..controller import Algorithm, Engine, EngineFactory, Params
from ..data.bimap import BiMap
from ..data.storage.registry import StorageError
from ..data.store import LEventStore
from ..device import resolve_device
from ..e2.cross_validation import k_fold_indices
from ..ops.als import ALSFactors, ALSParams, train_als
from ._filters import CategoryIndex, build_exclude_mask
from ._sharded_serving import (
    ShardedCatalogServing, validate_serving_mode,
)
from .similar_product import (
    DataSourceParams as SPDataSourceParams, SimilarProductDataSource,
    TrainingData,
)


@dataclasses.dataclass(frozen=True)
class ECommerceDataSourceParams(SPDataSourceParams):
    event_names: Sequence[str] = ("view", "buy")


class ECommerceDataSource(SimilarProductDataSource):
    params_cls = ECommerceDataSourceParams

    def read_eval(self, ctx):
        """Three folds for ``pio eval``: each held-out (user, item)
        interaction becomes a top-10 query for that user. ``unseenOnly``
        is off, since the seen-item rule would exclude exactly the
        interaction being graded."""
        td = self.read_training(ctx)
        folds = []
        for train_sel, test_sel in k_fold_indices(len(td.user_idx), k=3,
                                                  seed=0):
            train = TrainingData(
                td.user_idx[train_sel], td.item_idx[train_sel],
                td.rating[train_sel], td.users, td.items,
                td.item_categories)
            queries = [
                ({"user": td.users.inverse(int(td.user_idx[j])),
                  "num": 10, "unseenOnly": False},
                 {"item": td.items.inverse(int(td.item_idx[j]))})
                for j in np.nonzero(test_sel)[0]
            ]
            folds.append((train, None, queries))
        return folds


@dataclasses.dataclass
class ECommerceModel(ShardedCatalogServing):
    factors: ALSFactors
    users: BiMap
    items: BiMap
    item_categories: dict[str, set[str]]
    app_name: str
    seen_event_names: Sequence[str]
    device: torch.device
    #: the event store the serve-time reads go to (None: the process's
    #: ``Storage.instance()``)
    storage: Any = dataclasses.field(default=None, repr=False, compare=False)
    # catalog caching + layout selection: ShardedCatalogServing
    _sharded_cat: object = dataclasses.field(
        default=None, repr=False, compare=False)
    _cat_index: Optional[CategoryIndex] = dataclasses.field(
        default=None, repr=False, compare=False)

    def category_index(self) -> CategoryIndex:
        if self._cat_index is None:
            self._cat_index = CategoryIndex(self.items, self.item_categories)
        return self._cat_index

    def warm_up(self, num: int = 10):
        """Make the catalog resident and answer one query (deploy time)."""
        self.warm_catalog()
        if len(self.users):
            self.recommend(next(iter(self.users.keys())), num)

    def _seen_items(self, user: str) -> set[str]:
        """The targets of the user's 200 latest ``seen_event_names``
        events."""
        try:
            events = LEventStore.find_by_entity(
                self.app_name, "user", user,
                event_names=list(self.seen_event_names), limit=200,
                storage=self.storage)
        except StorageError:
            return set()
        return {e.target_entity_id for e in events if e.target_entity_id}

    def _unavailable_items(self) -> set[str]:
        """``items`` of the latest ``$set`` of constraint/unavailableItems."""
        try:
            events = LEventStore.find_by_entity(
                self.app_name, "constraint", "unavailableItems",
                event_names=["$set"], limit=1, storage=self.storage)
        except StorageError:
            return set()
        for e in events:
            return set(e.properties.get_or_else("items", []))
        return set()

    def recommend(self, user: str, num: int,
                  categories: Optional[Sequence[str]] = None,
                  white_list: Optional[Sequence[str]] = None,
                  black_list: Optional[Sequence[str]] = None,
                  unseen_only: bool = True):
        uidx = self.users.get(user)
        if uidx is None:
            return []
        extra = list(self._unavailable_items())
        if unseen_only:
            extra += list(self._seen_items(user))
        exclude = build_exclude_mask(
            self.items, self.category_index(), categories, white_list,
            black_list, extra_excluded_items=extra)
        # the exclude mask is applied per shard before the partial top-k
        scores, idx = self.catalog().top_k(self.factors.user_factors[uidx],
                                           num, exclude=exclude)
        return [(self.items.inverse(int(j)), float(s))
                for s, j in zip(scores, idx) if np.isfinite(s)]


@dataclasses.dataclass(frozen=True)
class ECommerceAlgoParams(Params):
    app_name: str = ""
    rank: int = 10
    num_iterations: int = 20
    reg: float = 0.01
    alpha: float = 1.0
    seen_events: Sequence[str] = ("view", "buy")
    seed: Optional[int] = None
    # "auto" → float32; only float32 is ported
    compute_dtype: str = "auto"
    chunk_tiles: int = -1
    # engine.json "shardedServing": auto|always|never (ops/sharded_topk)
    sharded_serving: str = "auto"


class ECommerceAlgorithm(Algorithm):
    params_cls = ECommerceAlgoParams
    params_aliases = {
        "appName": "app_name", "lambda": "reg",
        "numIterations": "num_iterations", "seenEvents": "seen_events",
        "computeDtype": "compute_dtype", "chunkTiles": "chunk_tiles",
        "shardedServing": "sharded_serving",
    }

    def train(self, ctx, pd: TrainingData) -> ECommerceModel:
        p = self.params
        validate_serving_mode(p.sharded_serving)  # before the run
        factors = train_als(
            pd.user_idx, pd.item_idx, pd.rating, n_users=len(pd.users),
            n_items=len(pd.items),
            params=ALSParams(
                rank=p.rank, num_iterations=p.num_iterations, reg=p.reg,
                implicit_prefs=True, alpha=p.alpha,
                seed=p.seed if p.seed is not None else 3,
                compute_dtype=p.compute_dtype, chunk_tiles=p.chunk_tiles),
            device=ctx.device, checkpoint_hook=ctx.checkpoint_hook,
            resume=ctx.workflow_params.resume,
            nan_guard=ctx.workflow_params.nan_guard,
            nan_guard_stage=ctx.stage_label, timings=ctx.bench_timings)
        return ECommerceModel(
            factors=factors, users=pd.users, items=pd.items,
            item_categories=pd.item_categories,
            app_name=p.app_name or ctx.app_name,
            seen_event_names=tuple(p.seen_events), device=ctx.device,
            storage=ctx.storage)

    def predict(self, model: ECommerceModel, query: dict) -> dict:
        pairs = model.recommend(
            str(query["user"]), int(query.get("num", 10)),
            categories=query.get("categories"),
            white_list=query.get("whiteList"),
            black_list=query.get("blackList"),
            unseen_only=bool(query.get("unseenOnly", True)))
        return {"itemScores": [{"item": i, "score": s} for i, s in pairs]}

    def prepare_model_for_persistence(self, model: ECommerceModel) -> dict:
        return model_to_persisted(model)

    def restore_model(self, stored, ctx) -> ECommerceModel:
        return model_from_persisted(stored, ctx.device, ctx.storage)


def model_to_persisted(model: ECommerceModel) -> dict:
    """The reference's persisted dict (ecommerce.py:228-237)."""
    return {
        "user_factors": np.asarray(model.factors.user_factors, np.float32),
        "item_factors": np.asarray(model.factors.item_factors, np.float32),
        "users": model.users.to_persisted(),
        "items": model.items.to_persisted(),
        "item_categories": {k: sorted(v)
                            for k, v in model.item_categories.items()},
        "app_name": model.app_name,
        "seen_event_names": list(model.seen_event_names),
    }


def model_from_persisted(stored: dict, device="cuda",
                         storage=None) -> ECommerceModel:
    """The persisted dict → ECommerceModel serving on ``device``, its
    serve-time reads going to ``storage``."""
    uf = np.asarray(stored["user_factors"], np.float32)
    itf = np.asarray(stored["item_factors"], np.float32)
    return ECommerceModel(
        factors=ALSFactors(uf, itf, uf.shape[0], itf.shape[0]),
        users=BiMap.from_persisted(stored["users"]),
        items=BiMap.from_persisted(stored["items"]),
        item_categories={k: set(v)
                         for k, v in stored["item_categories"].items()},
        app_name=stored["app_name"],
        seen_event_names=tuple(stored["seen_event_names"]),
        device=resolve_device(device), storage=storage)


class ECommerceEngine(EngineFactory):
    """engine.json: "engineFactory":
    "incubator_predictionio_torch.models.ecommerce.ECommerceEngine"
    """

    def apply(self) -> Engine:
        return Engine(
            data_source_class=ECommerceDataSource,
            algorithm_class_map={"ecomm": ECommerceAlgorithm,
                                 "": ECommerceAlgorithm},
        )
