"""Recommendation template (ALS) — train, persist, serve.

Port of ``incubator_predictionio_tpu/models/recommendation.py``. Queries
score through the serving catalog of ``models/_sharded_serving.py``: the
item factors are made resident on the device once and cached on the model,
flat or host-sharded (``PIO_SERVE_SHARD_ITEMS``). Wire format (the
quickstart's)::

  query  {"user": "1", "num": 4}
  result {"itemScores": [{"item": "32", "score": 6.17}, ...]}

Ranking mode: a query with ``"items"`` ranks the given candidates instead
of searching the catalog.

In a training gang (``pio train --num-workers N``) the data source reads
only this worker's event-log partitions (``workflow/train_feed.py``) and
the algorithm trains data-parallel (``ops.als.train_als_partition_local``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..controller import (
    Algorithm, DataSource, Engine, EngineFactory, Params, SanityCheck,
)
from ..data.bimap import BiMap, extend_bimap
from ..data.events import find_ratings
from ..data.store import PEventStore
from ..device import resolve_device
from ..e2.cross_validation import k_fold_indices
from ..ops.als import (
    ALSFactors, ALSParams, fold_in_factors, train_als,
    train_als_partition_local,
)
from ..workflow import train_feed
from ._sharded_serving import (
    ShardedCatalogServing, validate_serving_mode,
)

log = logging.getLogger("pio.torch.recommendation")


@dataclasses.dataclass
class TrainingData(SanityCheck):
    user_idx: np.ndarray
    item_idx: np.ndarray
    rating: np.ndarray
    users: BiMap
    items: BiMap
    #: True when the triple holds only THIS gang worker's event-log
    #: partitions while users/items are the all-gathered GLOBAL maps: the
    #: trainer must then all-reduce (a worker's own triple may be empty)
    partition_local: bool = False

    def sanity_check(self):
        if len(self.users if self.partition_local else self.user_idx) == 0:
            raise ValueError("no rating events found")
        if not len(self.user_idx) == len(self.item_idx) == len(self.rating):
            raise ValueError("user, item and rating arrays differ in length")


PreparedData = TrainingData  # identity preparation (quickstart parity)


@dataclasses.dataclass
class ALSModel(ShardedCatalogServing):
    factors: ALSFactors
    users: BiMap
    items: BiMap
    device: torch.device
    # catalog caching + layout selection: ShardedCatalogServing
    _sharded_cat: object = dataclasses.field(
        default=None, repr=False, compare=False)

    def warm_up(self, num: int = 10):
        """Make the catalog resident and answer one query (deploy time)."""
        self.warm_catalog()
        if len(self.users):
            self.recommend_products(next(iter(self.users.keys())), num)

    def example_query(self):
        """A valid query for serving warm-ups (the engine server's batch
        shapes, golden query and latency probe)."""
        if not len(self.users):
            return None
        return {"user": next(iter(self.users.keys())), "num": 10}

    def recommend_products(self, user: str, num: int):
        uidx = self.users.get(user)
        if uidx is None:
            return []
        # one call whatever the layout: the facade owns the dispatch
        scores, idx = self.catalog().top_k(self.factors.user_factors[uidx],
                                           num)
        return [(self.items.inverse(int(i)), float(s))
                for s, i in zip(scores, idx) if np.isfinite(s)]


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    event_names: Sequence[str] = ("rate", "buy")
    buy_rating: float = 4.0  # "buy" events carry no rating (template parity)


class RecommendationDataSource(DataSource):
    params_cls = DataSourceParams
    params_aliases = {"appName": "app_name", "eventNames": "event_names"}
    partition_feed = True

    def read_training(self, ctx) -> TrainingData:
        """The rate/buy events as a triple: from ``ctx.events`` when the
        caller handed events over, else from the event store (the
        reference's ``PEventStore.find_ratings`` read), or — with the
        partition feed armed — from this gang worker's partitions only.
        "buy" events carry no rating property, so the template assigns
        ``buy_rating``."""
        p: DataSourceParams = self.params
        t0 = time.perf_counter()
        if ctx.events is not None:
            u, i, r, users, items = find_ratings(
                ctx.events, event_names=list(p.event_names),
                event_default_ratings={"buy": p.buy_rating})
        elif train_feed.partition_feed_active(ctx.get_storage()):
            u, i, r, users, items = train_feed.partition_ratings(
                p.app_name or ctx.app_name, event_names=list(p.event_names),
                event_default_ratings={"buy": p.buy_rating},
                storage=ctx.get_storage(), channel_name=ctx.channel_name,
                report=ctx.read_timings)
            ctx.record_read(time.perf_counter() - t0, len(u))
            return TrainingData(u, i, r, users, items, partition_local=True)
        else:
            u, i, r, users, items = PEventStore.find_ratings(
                p.app_name or ctx.app_name,
                event_names=list(p.event_names),
                event_default_ratings={"buy": p.buy_rating},
                storage=ctx.get_storage(),
                channel_name=ctx.channel_name)
        ctx.record_read(time.perf_counter() - t0, len(u))
        return TrainingData(u, i, r, users, items)

    def read_eval(self, ctx):
        """Three folds for ``pio eval`` (the reference's ``read_eval``):
        each held-out (user, item, rating) becomes a top-10 query whose
        actual is that item and rating."""
        td = self.read_training(ctx)
        folds = []
        for train_sel, test_sel in k_fold_indices(len(td.user_idx), k=3,
                                                  seed=0):
            train = TrainingData(
                td.user_idx[train_sel], td.item_idx[train_sel],
                td.rating[train_sel], td.users, td.items)
            queries = [
                ({"user": td.users.inverse(int(td.user_idx[j])), "num": 10},
                 {"rating": float(td.rating[j]),
                  "item": td.items.inverse(int(td.item_idx[j]))})
                for j in np.nonzero(test_sel)[0]
            ]
            folds.append((train, None, queries))
        return folds


@dataclasses.dataclass(frozen=True)
class AlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    reg: float = 0.01  # engine.json "lambda"
    seed: Optional[int] = None
    implicit_prefs: bool = False
    alpha: float = 1.0
    lambda_scaling: str = "plain"
    block_len: int = 32
    compute_dtype: str = "auto"
    chunk_tiles: int = -1
    binary_ratings: Optional[bool] = None
    # engine.json "shardedServing": auto|always|never (ops/sharded_topk)
    sharded_serving: str = "auto"


class ALSAlgorithm(Algorithm):
    """ALS recommender (the reference template's ALSAlgorithm)."""

    params_cls = AlgorithmParams
    params_aliases = {
        "lambda": "reg",
        "numIterations": "num_iterations",
        "implicitPrefs": "implicit_prefs",
        "lambdaScaling": "lambda_scaling",
        "blockLen": "block_len",
        "computeDtype": "compute_dtype",
        "chunkTiles": "chunk_tiles",
        "binaryRatings": "binary_ratings",
        "shardedServing": "sharded_serving",
    }

    @staticmethod
    def als_params(p: AlgorithmParams) -> ALSParams:
        return ALSParams(
            rank=p.rank, num_iterations=p.num_iterations, reg=p.reg,
            lambda_scaling=p.lambda_scaling, implicit_prefs=p.implicit_prefs,
            alpha=p.alpha, seed=p.seed if p.seed is not None else 3,
            block_len=p.block_len, compute_dtype=p.compute_dtype,
            chunk_tiles=p.chunk_tiles, binary_ratings=p.binary_ratings)

    def train(self, ctx, pd: PreparedData) -> ALSModel:
        validate_serving_mode(self.params.sharded_serving)  # before the run
        # a partition-local triple (a gang worker's) all-reduces its normal
        # equations; one process trains through train_als either way
        trainer = (train_als_partition_local if pd.partition_local
                   else train_als)
        factors = trainer(
            pd.user_idx, pd.item_idx, pd.rating, n_users=len(pd.users),
            n_items=len(pd.items), params=self.als_params(self.params),
            device=ctx.device, checkpoint_hook=ctx.checkpoint_hook,
            resume=ctx.workflow_params.resume,
            nan_guard=ctx.workflow_params.nan_guard,
            nan_guard_stage=ctx.stage_label,
            # a benchmark plants a dict here to read the phase times
            timings=ctx.bench_timings)
        return ALSModel(factors=factors, users=pd.users, items=pd.items,
                        device=ctx.device)

    @staticmethod
    def _is_ranking_query(query: dict) -> bool:
        # "items" present (even empty) selects ranking mode
        return query.get("items") is not None

    @staticmethod
    def _rank_candidates(model: ALSModel, query: dict) -> dict:
        """Rank the GIVEN candidates for the user. Unknown user → items
        back in sent order with score 0 ("isOriginal"); unknown items rank
        last in sent order."""
        items = [str(x) for x in query["items"]]
        uid = model.users.get(str(query["user"]))
        if uid is None:
            return {"itemScores": [{"item": it, "score": 0.0} for it in items],
                    "isOriginal": True}
        uvec = model.factors.user_factors[uid]
        known = [(pos, model.items.get(it)) for pos, it in enumerate(items)]
        rows = [iid for _, iid in known if iid is not None]
        gathered = (model.factors.item_factors[rows] @ uvec
                    if rows else np.zeros(0, np.float32))
        scores = np.full(len(items), -np.inf, np.float64)
        scores[[pos for pos, iid in known if iid is not None]] = gathered
        order = sorted(range(len(items)), key=lambda p: (-scores[p], p))
        return {"itemScores": [
            {"item": items[p],
             "score": float(scores[p]) if np.isfinite(scores[p]) else 0.0}
            for p in order], "isOriginal": False}

    def predict(self, model: ALSModel, query: dict) -> dict:
        if self._is_ranking_query(query):
            return self._rank_candidates(model, query)
        num = int(query.get("num", 10))
        item_scores = model.recommend_products(str(query["user"]), num)
        return {"itemScores": [{"item": item, "score": score}
                               for item, score in item_scores]}

    def batch_predict(self, model: ALSModel, queries: Sequence[dict]) -> list[dict]:
        if not queries:
            return []
        out: list[Optional[dict]] = [None] * len(queries)
        for j, q in enumerate(queries):
            if self._is_ranking_query(q):
                out[j] = self._rank_candidates(model, q)
        rest = [j for j in range(len(queries)) if out[j] is None]
        if rest:
            qs = [queries[j] for j in rest]
            uids = [model.users.get(str(q["user"])) for q in qs]
            k = model.factors.user_factors.shape[1]
            uvecs = np.stack([
                model.factors.user_factors[u] if u is not None
                else np.zeros(k, np.float32) for u in uids])
            num = max(int(q.get("num", 10)) for q in qs)
            # one call for the whole window, whatever the layout
            scores, idx = model.catalog().batch_top_k(uvecs, num)
            for t, (j, q, u) in enumerate(zip(rest, qs, uids)):
                if u is None:
                    out[j] = {"itemScores": []}
                    continue
                n = min(int(q.get("num", 10)), idx.shape[1])
                out[j] = {"itemScores": [
                    {"item": model.items.inverse(int(idx[t, c])),
                     "score": float(scores[t, c])} for c in range(n)]}
        return out  # type: ignore[return-value]

    #: proximal weight μ of the fold-in's ‖x − x_old‖² term: an existing
    #: entity's current factor enters its re-solve as a pseudo-observation
    #: of this strength; new entities (a zero anchor row) get μ = 0 and
    #: solve the exact cold-start ridge
    FOLD_IN_ANCHOR_WEIGHT = 1.0

    def fold_in(self, model: ALSModel, events, ctx=None,
                data_source_params=None) -> Optional[ALSModel]:
        """Closed-form fold-in of new rate/buy events (the reference's
        ``ALSAlgorithm.fold_in``): events → (user, item, rating) with the
        last write winning, id maps extended for unseen ids, then the
        touched items are re-solved against the frozen users and the
        touched users against the updated items, each side in one solve
        on the model's device. Returns a new model on that device (None
        when no event applies); ``model`` is never mutated."""
        dsp = dict(data_source_params or {})
        names = list(dsp.get("event_names") or dsp.get("eventNames")
                     or DataSourceParams.event_names)
        buy_rating = float(dsp.get("buy_rating",
                                   dsp.get("buyRating",
                                           DataSourceParams.buy_rating)))
        triples: dict[tuple[str, str], float] = {}
        for e in events:
            if not isinstance(e, dict) or e.get("event") not in names:
                continue
            u, it = e.get("entityId"), e.get("targetEntityId")
            if not u or not it:
                continue
            props = e.get("properties") or {}
            try:
                r = float(props["rating"])
            except (KeyError, TypeError, ValueError):
                r = buy_rating if e.get("event") == "buy" else 1.0
            triples[(str(u), str(it))] = r  # last write wins, like upsert
        if not triples:
            return None
        users, _ = extend_bimap(model.users, (u for u, _ in triples))
        items, _ = extend_bimap(model.items, (i for _, i in triples))
        # ids an IdentityBiMap could not extend (non-consecutive) drop out
        coo = [(users.get(u), items.get(i), r)
               for (u, i), r in triples.items()]
        coo = [(ui, ii, r) for ui, ii, r in coo
               if ui is not None and ii is not None]
        if len(coo) < len(triples):
            log.warning("fold-in: skipped %d event(s) whose ids cannot "
                        "extend the identity catalog map",
                        len(triples) - len(coo))
        if not coo:
            return None
        k = model.factors.user_factors.shape[1]

        def grown(f: np.ndarray, n: int) -> np.ndarray:
            f = np.asarray(f, np.float32)
            if n > f.shape[0]:
                return np.vstack([f, np.zeros((n - f.shape[0], k), np.float32)])
            return f.copy()

        uf = grown(model.factors.user_factors, len(users))
        itf = grown(model.factors.item_factors, len(items))
        p = self.params
        kw = dict(reg=p.reg, lambda_scaling=p.lambda_scaling,
                  implicit_prefs=p.implicit_prefs, alpha=p.alpha,
                  device=model.device)

        def touched(axis: int):
            by: dict[int, tuple[list, list]] = {}
            for ui, ii, r in coo:
                row, cp = (ui, ii) if axis == 0 else (ii, ui)
                idx, val = by.setdefault(row, ([], []))
                idx.append(cp)
                val.append(r)
            rows = sorted(by)
            return (rows, [np.asarray(by[r][0], np.int64) for r in rows],
                    [np.asarray(by[r][1], np.float32) for r in rows])

        def mu_for(rows, n_trained: int) -> np.ndarray:
            # rows appended past the trained matrix have no factor to stay
            # near: they solve the cold-start ridge
            return np.where(np.asarray(rows) < n_trained,
                            np.float32(self.FOLD_IN_ANCHOR_WEIGHT),
                            np.float32(0.0))

        # items first against the frozen users, then users against the
        # updated items: a new user's first event on a new item resolves
        # both rows in one increment
        n_u0 = model.factors.user_factors.shape[0]
        n_i0 = model.factors.item_factors.shape[0]
        i_rows, i_idx, i_val = touched(1)
        itf[i_rows] = fold_in_factors(uf, i_idx, i_val, anchor=itf[i_rows],
                                      anchor_weight=mu_for(i_rows, n_i0), **kw)
        u_rows, u_idx, u_val = touched(0)
        uf[u_rows] = fold_in_factors(itf, u_idx, u_val, anchor=uf[u_rows],
                                     anchor_weight=mu_for(u_rows, n_u0), **kw)
        # the same device as the live model; the catalog cache starts
        # empty and is rebuilt from the new factors when it warms up
        return ALSModel(factors=ALSFactors(uf, itf, len(users), len(items)),
                        users=users, items=items, device=model.device)

    def prepare_model_for_persistence(self, model: ALSModel) -> dict:
        return model_to_persisted(model)

    def restore_model(self, stored, ctx) -> ALSModel:
        return model_from_persisted(stored, ctx.device)


def model_to_persisted(model: ALSModel) -> dict:
    """The persisted dict: exactly the reference's keys and forms (numpy
    float32 factors, persisted BiMaps), so models cross-load both ways."""
    return {
        "user_factors": np.asarray(model.factors.user_factors, np.float32),
        "item_factors": np.asarray(model.factors.item_factors, np.float32),
        "users": model.users.to_persisted(),
        "items": model.items.to_persisted(),
    }


def model_from_persisted(stored: dict, device="cuda") -> ALSModel:
    """The persisted dict (numpy factors + persisted BiMaps) → ALSModel
    serving on ``device``."""
    uf = np.asarray(stored["user_factors"], np.float32)
    itf = np.asarray(stored["item_factors"], np.float32)
    return ALSModel(
        factors=ALSFactors(uf, itf, uf.shape[0], itf.shape[0]),
        users=BiMap.from_persisted(stored["users"]),
        items=BiMap.from_persisted(stored["items"]),
        device=resolve_device(device))


class RecommendationEngine(EngineFactory):
    """engine.json: "engineFactory":
    "incubator_predictionio_torch.models.recommendation.RecommendationEngine"
    """

    def apply(self) -> Engine:
        return Engine(
            data_source_class=RecommendationDataSource,
            algorithm_class_map={"als": ALSAlgorithm, "": ALSAlgorithm},
        )
