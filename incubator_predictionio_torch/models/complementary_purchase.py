"""Complementary Purchase template: items bought in the same basket.

Port of ``incubator_predictionio_tpu/models/complementary_purchase.py``:
the "buy" events are cut into baskets, one per (user, purchase session),
where a gap longer than ``basketWindowSecs`` between a user's consecutive
buys closes the session (:func:`form_baskets`, numpy, as the reference).
The baskets take the user axis of the LLR co-occurrence
(``ops/llr.cco_indicators``, on the context's device), and a query basket
is scored against the indicators, resident on the model's device
(``ops/llr.score_user``). Wire format (the template's)::

  query  {"items": ["i1", ...], "num": 4}
  result {"itemScores": [{"item": ..., "score": ...}]}  (query items left out)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..controller import (
    Algorithm, DataSource, Engine, EngineFactory, Params, SanityCheck,
)
from ..data.bimap import BiMap
from ..data.store import PEventStore
from ..device import resolve_device
from ..e2.cross_validation import k_fold_indices
from ..ops.llr import Indicators, cco_indicators, score_user
from ..parallel.distributed import gang_collectives


@dataclasses.dataclass
class TrainingData(SanityCheck):
    user_idx: np.ndarray   # [n] int32
    item_idx: np.ndarray   # [n] int32
    time_us: np.ndarray    # [n] int64 event time (µs)
    users: BiMap
    items: BiMap

    def sanity_check(self) -> None:
        if len(self.user_idx) == 0:
            raise ValueError("no buy events found")
        if not len(self.user_idx) == len(self.item_idx) == len(self.time_us):
            raise ValueError("the buy columns differ in length")


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    event_name: str = "buy"


class ComplementaryDataSource(DataSource):
    params_cls = DataSourceParams
    params_aliases = {"appName": "app_name", "eventName": "event_name"}

    def read_training(self, ctx) -> TrainingData:
        """The buy events with a target, from the event store
        (``find_batch``), users and items indexed in first-seen order."""
        p = self.params
        if ctx.events is not None:
            raise ValueError("the Complementary Purchase template reads the "
                             "event store; train it with `pio train`")
        t0 = time.perf_counter()
        batch = PEventStore.find_batch(
            p.app_name or ctx.app_name, event_names=[p.event_name],
            storage=ctx.get_storage(), channel_name=ctx.channel_name)
        keep = [j for j, tid in enumerate(batch.target_entity_id)
                if tid is not None]
        users = BiMap.string_int(batch.entity_id[j] for j in keep)
        items = BiMap.string_int(batch.target_entity_id[j] for j in keep)
        td = TrainingData(
            users.map_array([batch.entity_id[j] for j in keep]
                            ).astype(np.int32),
            items.map_array([batch.target_entity_id[j] for j in keep]
                            ).astype(np.int32),
            batch.event_time_us[keep], users, items)
        ctx.record_read(time.perf_counter() - t0, len(keep))
        return td

    def read_eval(self, ctx):
        """Three folds for ``pio eval``: each held-out buy becomes a query
        of the shopper's other training-fold items (at most 8, sorted),
        whose complement the held-out item should be."""
        td = self.read_training(ctx)
        folds = []
        for train_sel, test_sel in k_fold_indices(len(td.user_idx), k=3,
                                                  seed=0):
            train = TrainingData(
                td.user_idx[train_sel], td.item_idx[train_sel],
                td.time_us[train_sel], td.users, td.items)
            basket_items: dict[int, list[str]] = {}
            for j in np.nonzero(train_sel)[0]:
                basket_items.setdefault(int(td.user_idx[j]), []).append(
                    td.items.inverse(int(td.item_idx[j])))
            queries = []
            for j in np.nonzero(test_sel)[0]:
                rest = basket_items.get(int(td.user_idx[j]))
                if not rest:
                    continue  # a cold shopper: nothing to query from
                queries.append((
                    {"items": sorted(set(rest))[:8], "num": 10},
                    {"item": td.items.inverse(int(td.item_idx[j]))}))
            folds.append((train, None, queries))
        return folds


def form_baskets(user_idx: np.ndarray, time_us: np.ndarray,
                 window_us: int) -> np.ndarray:
    """Basket id per event: sorted by (user, time), a basket breaks where
    the user changes or the gap exceeds ``window_us``; dense ids by
    cumsum."""
    n = len(user_idx)
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.lexsort((time_us, user_idx))
    su, st = user_idx[order], time_us[order]
    new_basket = np.ones(n, bool)
    new_basket[1:] = (su[1:] != su[:-1]) | (st[1:] - st[:-1] > window_us)
    basket_sorted = np.cumsum(new_basket) - 1
    baskets = np.empty(n, np.int64)
    baskets[order] = basket_sorted
    return baskets


@dataclasses.dataclass(frozen=True)
class AlgoParams(Params):
    basket_window_secs: int = 3600
    max_correlators: int = 20
    llr_threshold: float = 0.0


@dataclasses.dataclass
class ComplementaryModel:
    indicators: Indicators
    items: BiMap
    #: where the indicators are resident and scored
    device: torch.device

    def warm_up(self, num: int = 4):
        """Make the indicators resident and answer one query (deploy time)."""
        self.indicators.on(self.device)
        if len(self.items):
            self.suggest([next(iter(self.items.keys()))], num)

    def suggest(self, basket_items: Sequence[str], num: int
                ) -> list[tuple[str, float]]:
        known = [j for x in basket_items
                 if (j := self.items.get(x)) is not None]
        n_items = self.indicators.idx.shape[0]
        if not known or n_items == 0:
            return []
        membership = np.zeros(n_items, np.float32)
        membership[known] = 1.0
        exclude = np.zeros(n_items, bool)
        exclude[known] = True
        scores, idx = score_user(
            [(self.indicators, membership, 1.0)],
            k=min(num + len(known), n_items), exclude=exclude,
            device=self.device)
        out = []
        for s, j in zip(scores, idx):
            if not np.isfinite(s) or s <= 0:
                break
            out.append((self.items.inverse(int(j)), float(s)))
            if len(out) >= num:
                break
        return out


class ComplementaryAlgorithm(Algorithm):
    """In a gang every rank reads the merged view and forms the same
    baskets, counts its block of the basket ranges and sums the counts
    with the others; the leader persists."""
    gang_capable = True

    params_cls = AlgoParams
    params_aliases = {
        "basketWindowSecs": "basket_window_secs",
        "maxCorrelatorsPerItem": "max_correlators",
        "minLLR": "llr_threshold",
    }

    def train(self, ctx, td: TrainingData) -> ComplementaryModel:
        p = self.params
        baskets = form_baskets(td.user_idx, td.time_us,
                               int(p.basket_window_secs) * 1_000_000)
        n_baskets = int(baskets.max()) + 1 if len(baskets) else 0
        ind = cco_indicators(
            baskets, td.item_idx, baskets, td.item_idx,
            n_users=max(n_baskets, 1), n_items=len(td.items),
            max_correlators=p.max_correlators,
            llr_threshold=p.llr_threshold, device=ctx.device,
            timings=ctx.bench_timings, collectives=gang_collectives())
        if ctx.bench_timings is not None:
            ctx.bench_timings["baskets"] = n_baskets
        return ComplementaryModel(ind, td.items, ctx.device)

    def predict(self, model: ComplementaryModel, query: dict) -> dict:
        pairs = model.suggest([str(x) for x in query.get("items", [])],
                              int(query.get("num", 4)))
        return {"itemScores": [{"item": i, "score": s} for i, s in pairs]}

    def prepare_model_for_persistence(self, model: ComplementaryModel
                                      ) -> dict:
        return model_to_persisted(model)

    def restore_model(self, stored, ctx) -> ComplementaryModel:
        return model_from_persisted(stored, ctx.device)


def model_to_persisted(model: ComplementaryModel) -> dict:
    """The reference's persisted dict (complementary_purchase.py:196-201)."""
    return {"idx": model.indicators.idx, "score": model.indicators.score,
            "items": model.items.to_persisted()}


def model_from_persisted(stored: dict, device="cuda") -> ComplementaryModel:
    """The persisted dict → ComplementaryModel serving on ``device``."""
    return ComplementaryModel(
        Indicators(idx=np.asarray(stored["idx"], np.int32),
                   score=np.asarray(stored["score"], np.float32)),
        BiMap.from_persisted(stored["items"]), resolve_device(device))


class ComplementaryPurchaseEngine(EngineFactory):
    """engine.json: "engineFactory":
    "incubator_predictionio_torch.models.complementary_purchase.ComplementaryPurchaseEngine"
    """

    def apply(self) -> Engine:
        return Engine(
            data_source_class=ComplementaryDataSource,
            algorithm_class_map={"cooccurrence": ComplementaryAlgorithm,
                                 "": ComplementaryAlgorithm},
        )
