"""Vanilla engine template — the scaffold of a user's own engine.

The port's copy of the reference's ``templates/vanilla/vanilla_engine.py``.
This file lives inside a template project, not in the framework: `pio
train --engine-dir <here>` puts the directory first on sys.path and
resolves ``engine.json``'s ``"engineFactory": "vanilla_engine.VanillaEngine"``,
as the reference loads a user's engine from a template checkout. It
imports only the public framework API — ``incubator_predictionio_torch.
controller``, the event store and the evaluation metric — never
``incubator_predictionio_torch.models``.

The engine is a weighted-popularity recommender: every view/rate/buy event
adds to its item's score (a rate weighted by its rating), summed with
``index_add_`` on the training device, and serving returns the top-N
items. Wire format (the recommendation quickstart's): {"user": ..., "num":
N} → {"itemScores": [...]}.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from incubator_predictionio_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    EngineFactory,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    OptionAverageMetric,
    Params,
    SanityCheck,
    Serving,
)
from incubator_predictionio_torch.data.store import PEventStore
from incubator_predictionio_torch.e2 import k_fold_indices
from incubator_predictionio_torch.ops import eval as evalops


@dataclasses.dataclass
class TrainingData(SanityCheck):
    user_idx: np.ndarray
    item_idx: np.ndarray
    weight: np.ndarray
    items: object  # BiMap item id ↔ dense index

    def sanity_check(self):
        if len(self.item_idx) == 0:
            raise ValueError("no events found for training")


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    event_names: Sequence[str] = ("view", "rate", "buy")


class VanillaDataSource(DataSource):
    params_cls = DataSourceParams
    params_aliases = {"appName": "app_name", "eventNames": "event_names"}

    def read_training(self, ctx) -> TrainingData:
        p: DataSourceParams = self.params
        u, i, r, _users, items = PEventStore.find_ratings(
            p.app_name or ctx.app_name,
            event_names=list(p.event_names),
            default_rating=1.0,  # view/buy events carry no rating
            storage=ctx.get_storage(),
            channel_name=ctx.channel_name,
        )
        return TrainingData(u, i, r, items)

    def read_eval(self, ctx):
        """Three folds for `pio eval`: each held-out event's item is the
        relevance label of a plain top-10 query."""
        td = self.read_training(ctx)
        folds = []
        for train_sel, test_sel in k_fold_indices(
                len(td.item_idx), k=3, seed=0):
            train = TrainingData(
                td.user_idx[train_sel], td.item_idx[train_sel],
                td.weight[train_sel], td.items)
            queries = [
                ({"num": 10},
                 {"item": td.items.inverse(int(td.item_idx[j]))})
                for j in np.nonzero(test_sel)[0]
            ]
            folds.append((train, None, queries))
        return folds


@dataclasses.dataclass
class PopularityModel:
    item_ids: list
    scores: np.ndarray  # [n_items] float32, aligned with item_ids

    def top(self, num: int):
        order = np.argsort(-self.scores)[:num]
        return [(self.item_ids[int(j)], float(self.scores[int(j)]))
                for j in order]


@dataclasses.dataclass(frozen=True)
class AlgorithmParams(Params):
    rating_weight: float = 1.0


class PopularityAlgorithm(Algorithm):
    params_cls = AlgorithmParams
    params_aliases = {"ratingWeight": "rating_weight"}

    def train(self, ctx, td: TrainingData) -> PopularityModel:
        n_items = len(td.items)
        idx = torch.from_numpy(np.asarray(td.item_idx, np.int64)).to(ctx.device)
        weight = torch.from_numpy(np.asarray(td.weight, np.float32)).to(ctx.device)
        scores = torch.zeros(n_items, dtype=torch.float32, device=ctx.device)
        scores.index_add_(0, idx, weight * self.params.rating_weight)
        item_ids = [td.items.inverse(j) for j in range(n_items)]
        return PopularityModel(item_ids=item_ids, scores=scores.cpu().numpy())

    def predict(self, model: PopularityModel, query: dict) -> dict:
        num = int(query.get("num", 10))
        return {
            "itemScores": [
                {"item": item, "score": score}
                for item, score in model.top(num)
            ]
        }

    def prepare_model_for_persistence(self, model: PopularityModel):
        return {"item_ids": model.item_ids,
                "scores": np.asarray(model.scores)}

    def restore_model(self, stored, ctx) -> PopularityModel:
        return PopularityModel(item_ids=list(stored["item_ids"]),
                               scores=np.asarray(stored["scores"]))


class VanillaServing(Serving):
    def serve(self, query: dict, predictions: Sequence[dict]) -> dict:
        return predictions[0] if predictions else {"itemScores": []}


class VanillaEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            data_source_class=VanillaDataSource,
            algorithm_class_map={"popularity": PopularityAlgorithm},
            serving_class=VanillaServing,
        )


# -- evaluation (`pio eval vanilla_engine.VanillaEvaluation
#    vanilla_engine.ParamsList --engine-dir <here>`) ----------------------


class NDCGAtK(OptionAverageMetric):
    """NDCG@k of the top-N against the held-out item, scored on
    ``device`` by the framework's ranking metric."""

    def __init__(self, k: int = 10, device="cuda"):
        self.k = k
        self.device = device

    def header(self) -> str:
        return f"NDCG@{self.k}"

    def calculate_unit(self, q, p, a):
        items = [str(s["item"]) for s in p.get("itemScores", [])]
        if not items or a.get("item") is None:
            return None
        m = evalops.ranking_metrics([items], [{str(a["item"])}], self.k,
                                    device=self.device)
        return float(m["ndcg"]) if m["n"] else None


class VanillaEvaluation(Evaluation):
    def __init__(self, device="cuda"):
        self.engine = VanillaEngine()()
        self.metric = NDCGAtK(k=10, device=device)
        self.metrics = (NDCGAtK(k=5, device=device),)


class ParamsList(EngineParamsGenerator):
    """ratingWeight sweep: how much a rating outweighs a view/buy."""

    def __init__(self, app_name: str = ""):
        ds = {"params": ({"appName": app_name} if app_name else {})}
        self.engine_params_list = [
            EngineParams.from_json({
                "datasource": ds,
                "algorithms": [{"name": "popularity",
                                "params": {"ratingWeight": w}}],
            })
            for w in (0.5, 1.0, 2.0)
        ]
