"""The port's copy of ``tests/soak_engine.py`` on the port's controller
API: the engine of the port's production-day soak tests
(tests/test_torch_soak.py), the full scenario surface in one tiny engine
with the same poison controls. Its model persists as arrays and JSON, not
a pickle.

- ``train`` builds a per-user score table AND a per-item popularity
  table from "rate" events; predict ranks the catalog by popularity
  (``itemScores``), which is what the shadow scorer grades against
  held-out next events. A PENDING ``poison-train`` control event (more
  poison-train than ``antidote`` events in the log) yields a
  GATE-PASSING poisoned model: the golden query answers, arrays are
  finite, but every other user's predict raises — the post-swap watch
  must roll it back. The driver inserts the antidote after triggering
  the poisoned retrain so later retrains come up clean (consumed-once,
  like a fold-in cursor).
- ``poison-rank`` (train or fold-in) is the QUALITY threat: the model
  stays gate-passing and NON-erroring but ranks the catalog
  worst-first — only the shadow scorer's NDCG delta can catch it.
  ``rank-antidote`` out-dates it on the train side.
- ``fold_in`` merges rate events into a COPY; ``poison-nan`` /
  ``poison-serve`` / ``poison-rank`` ride the DATA exactly as in
  tests/torch_foldin_engine.py (gate refusal / watch rollback / quality
  rollback); ``poison-train``/``antidote`` are train-side controls
  and are ignored here.

The soak's subprocesses (`pio train` / `pio deploy --engine-dir`) import
this module by name (the template dir rides sys.path)."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from incubator_predictionio_torch.controller import (
    Algorithm, DataSource, Engine,
)


TOP_K = 10


@dataclasses.dataclass
class SoakModel:
    scores: dict           # user id -> accumulated rating
    weights: np.ndarray    # finite unless nan-poisoned
    poison: str = ""       # "" | "serve" | "rank"
    items: dict = dataclasses.field(default_factory=dict)
    #                      # item id -> accumulated popularity mass

    def example_query(self):
        # warm-up / probe / swap-gate golden-query protocol
        return {"user": "golden"}

    def ranking(self):
        """Top-K catalog ranking. "rank"-poisoned models rank
        worst-first: every entry is a real item with a finite score
        (gates pass, nothing errors) — the ranking is just WRONG."""
        worst_first = self.poison == "rank"
        ranked = sorted(self.items.items(),
                        key=lambda kv: (kv[1] if worst_first
                                        else -kv[1], kv[0]))
        return [{"item": i, "score": float(s)}
                for i, s in ranked[:TOP_K]]


class SoakDataSource(DataSource):
    def read_training(self, ctx):
        s = ctx.get_storage()
        app = (s.get_meta_data_apps().get_by_name(ctx.app_name)
               if ctx.app_name else None)
        return list(s.get_l_events().find(app.id)) if app else []


class SoakAlgorithm(Algorithm):
    def train(self, ctx, events):
        scores: dict = {}
        items: dict = {}
        n_poison = n_antidote = n_rank = n_rank_anti = 0
        for e in events:
            if e.event == "rate" and e.entity_id:
                r = float(e.properties.get_or_else("rating", 1.0))
                scores[e.entity_id] = scores.get(e.entity_id, 0.0) + r
                if e.target_entity_id:
                    it = str(e.target_entity_id)
                    items[it] = items.get(it, 0.0) + r
            elif e.event == "poison-train":
                n_poison += 1
            elif e.event == "antidote":
                n_antidote += 1
            elif e.event == "poison-rank":
                n_rank += 1
            elif e.event == "rank-antidote":
                n_rank_anti += 1
        poison = ""
        if n_rank > n_rank_anti:
            poison = "rank"
        if n_poison > n_antidote:
            poison = "serve"        # erroring poison dominates
        return SoakModel(scores=scores, weights=np.ones(3),
                         poison=poison, items=items)

    def predict(self, model, query):
        # elastic soak: each query may hold its admission slot for a
        # beat (capped) — a microsecond answer never builds a queue,
        # so the ramp's load step would be invisible to the autoscaler
        hold = float(query.get("holdS") or 0.0)
        if hold > 0:
            time.sleep(min(hold, 0.5))
        user = str(query["user"])
        if model.poison == "serve" and user != "golden":
            raise RuntimeError("poisoned retrain: predict exploded")
        out = {"user": user, "known": user == "golden"
               or user in model.scores,
               "itemScores": model.ranking()}
        if out["known"]:
            out["score"] = float(model.scores.get(user, 0.0))
        return out

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
                # the quality threat: nothing errors, the gate passes,
                # the ranking is simply wrong from here on
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
            # poison-train / antidote are TRAIN-side controls: ignored
        if not changed:
            return None
        return SoakModel(scores=scores, weights=weights, poison=poison,
                         items=items)

    def prepare_model_for_persistence(self, model):
        return {"scores": model.scores, "weights": np.asarray(model.weights),
                "poison": model.poison, "items": model.items}

    def restore_model(self, stored, ctx):
        return SoakModel(scores=dict(stored["scores"]),
                         weights=np.asarray(stored["weights"]),
                         poison=str(stored["poison"]),
                         items=dict(stored.get("items") or {}))


def engine_factory() -> Engine:
    return Engine(SoakDataSource, None, {"": SoakAlgorithm}, None)
