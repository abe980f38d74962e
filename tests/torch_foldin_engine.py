"""The port's copy of ``tests/foldin_engine.py`` (and of the ranking half
of ``tests/soak_engine.py``) on the port's controller API: tiny DASE
engines for the online fold-in, quality and tenant tests of the port's
engine server. Their models persist as arrays and JSON, not pickles.

``engine_factory()``: the model is a per-user score table learned from
"rate" events; ``fold_in`` merges new events into a COPY. Poison arrives
through the data:

- a ``poison-nan`` event makes the folded model carry a NaN weight: the
  swap gate's NaN guard must refuse the increment;
- a ``poison-serve`` event makes the folded model pass the gate (the golden
  query "golden" answers, the arrays are finite) but raise on every other
  user: the post-swap watch must roll it back.

``rank_engine_factory()``: the same, plus a per-item popularity table;
predict ranks the catalog by it (``itemScores``), which the shadow scorer
grades against the users' next events. ``poison-rank`` (train or fold-in)
makes the model rank worst-first: gate-passing and non-erroring, only the
quality watch can catch it; ``rank-antidote`` outdates it on the train
side.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from incubator_predictionio_torch.controller import (
    Algorithm, DataSource, Engine, EngineParams,
)

TOP_K = 10


@dataclasses.dataclass
class FoldinModel:
    scores: dict           # user id -> accumulated rating
    weights: np.ndarray    # finite unless nan-poisoned
    poison: str = ""       # "" | "serve" | "rank"
    items: dict = dataclasses.field(default_factory=dict)
    #                      # item id -> accumulated popularity mass

    def example_query(self):
        # the warm-up / golden-query protocol
        return {"user": "golden"}

    def ranking(self):
        """Top-K catalog ranking; a "rank"-poisoned model ranks worst-first
        (every entry a real item with a finite score)."""
        worst_first = self.poison == "rank"
        ranked = sorted(self.items.items(),
                        key=lambda kv: (kv[1] if worst_first else -kv[1],
                                        kv[0]))
        return [{"item": i, "score": float(s)} for i, s in ranked[:TOP_K]]


class FoldinDataSource(DataSource):
    def read_training(self, ctx):
        s = ctx.get_storage()
        app = (s.get_meta_data_apps().get_by_name(ctx.app_name)
               if ctx.app_name else None)
        return list(s.get_l_events().find(app.id)) if app else []


class FoldinAlgorithm(Algorithm):
    def train(self, ctx, events):
        scores: dict = {}
        for e in events:
            if e.event == "rate" and e.entity_id:
                r = float(e.properties.get_or_else("rating", 1.0))
                scores[e.entity_id] = scores.get(e.entity_id, 0.0) + r
        return FoldinModel(scores=scores, weights=np.ones(3))

    def predict(self, model, query):
        user = str(query["user"])
        if model.poison == "serve" and user != "golden":
            raise RuntimeError("poisoned fold-in: predict exploded")
        if user == "golden" or user in model.scores:
            return {"user": user, "known": True,
                    "score": float(model.scores.get(user, 0.0)),
                    "poison": model.poison}
        return {"user": user, "known": False}

    def fold_in(self, model, events, ctx, data_source_params=None):
        scores = dict(model.scores)
        items = dict(model.items)
        weights = model.weights
        poison = model.poison
        changed = False
        for e in events:
            name = e.get("event")
            uid = e.get("entityId")
            if name == "poison-nan":
                weights = np.array([1.0, float("nan")])
                changed = True
            elif name == "poison-serve":
                poison = "serve"
                changed = True
            elif name == "poison-rank":
                poison = "rank"
                changed = True
            elif name == "rate" and uid:
                props = e.get("properties") or {}
                try:
                    r = float(props.get("rating", 1.0))
                except (TypeError, ValueError):
                    r = 1.0
                scores[str(uid)] = scores.get(str(uid), 0.0) + r
                tid = e.get("targetEntityId")
                if tid:
                    items[str(tid)] = items.get(str(tid), 0.0) + r
                changed = True
        if not changed:
            return None
        return FoldinModel(scores=scores, weights=weights, poison=poison,
                           items=items)

    def prepare_model_for_persistence(self, model):
        return {"scores": model.scores, "weights": np.asarray(model.weights),
                "poison": model.poison, "items": model.items}

    def restore_model(self, stored, ctx):
        return FoldinModel(scores=dict(stored["scores"]),
                           weights=np.asarray(stored["weights"]),
                           poison=str(stored["poison"]),
                           items=dict(stored.get("items") or {}))


class RankAlgorithm(FoldinAlgorithm):
    def train(self, ctx, events):
        scores: dict = {}
        items: dict = {}
        n_rank = n_rank_anti = 0
        for e in events:
            if e.event == "rate" and e.entity_id:
                r = float(e.properties.get_or_else("rating", 1.0))
                scores[e.entity_id] = scores.get(e.entity_id, 0.0) + r
                if e.target_entity_id:
                    it = str(e.target_entity_id)
                    items[it] = items.get(it, 0.0) + r
            elif e.event == "poison-rank":
                n_rank += 1
            elif e.event == "rank-antidote":
                n_rank_anti += 1
        return FoldinModel(scores=scores, weights=np.ones(3),
                           poison="rank" if n_rank > n_rank_anti else "",
                           items=items)

    def predict(self, model, query):
        user = str(query["user"])
        if model.poison == "serve" and user != "golden":
            raise RuntimeError("poisoned model: predict exploded")
        out = {"user": user,
               "known": user == "golden" or user in model.scores,
               "itemScores": model.ranking()}
        if out["known"]:
            out["score"] = float(model.scores.get(user, 0.0))
        return out


def engine_factory() -> Engine:
    return Engine(FoldinDataSource, None, {"": FoldinAlgorithm}, None)


def rank_engine_factory() -> Engine:
    return Engine(FoldinDataSource, None, {"": RankAlgorithm}, None)


def engine_params(app_name: str = "foldapp") -> EngineParams:
    return EngineParams(data_source_params={"appName": app_name},
                        algorithm_params_list=[("", {})])
