"""Universal Recommender (CCO) template.

Port of ``incubator_predictionio_tpu/models/universal_recommender.py``: the
data source reads the indicator events (the first name is the primary,
conversion event, e.g. "buy"; the others secondary, e.g. "view") and the
items' ``categories`` and date properties; the algorithm builds every
(primary, event type) cross-occurrence indicator matrix in one fused pass
(``ops/llr.cco_indicators_multi``, on the context's device) and the
primary-event popularity of every item. A query scores the user's history
(read from the event store at serve time) against the indicators, resident
on the model's device flat or host-sharded (``PIO_SERVE_SHARD_ITEMS``:
``models/_sharded_serving.ShardedIndicators``, bit-identical to the flat
``ops/llr.score_user``), under the business rules:
category filters (bias < 0) and boosts (bias > 0), blackList, the item's
available / expire dates at ``currentDate`` and a ``dateRange`` on its
``date``. A user with no history and no query items gets the popularity
ranking through the same rules, on the host. Wire format (the template's)::

  query  {"user": "u1", "num": 4, "item": "i2" | "itemSet": [...],
          "fields": [{"name": "categories", "values": ["c"], "bias": -1}],
          "blacklistItems": [...], "currentDate": ISO,
          "dateRange": {"after": ISO, "before": ISO}}
  result {"itemScores": [{"item": ..., "score": ...}]}

One deliberate difference from the reference: the serve-time history read
catches only the storage's own error (``StorageError``), where the
reference serves an empty history on any exception. The model persists as arrays and JSON (:func:`flatten` / :func:`nest`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..controller import (
    Algorithm, DataSource, Engine, EngineFactory, Params, SanityCheck,
)
from ..data.bimap import BiMap
from ..data.storage.event import parse_event_time
from ..data.storage.registry import StorageError
from ..data.store import LEventStore, PEventStore
from ..device import resolve_device
from ..ops.llr import Indicators, cco_indicators_multi
from ..parallel.distributed import gang_collectives
from ._filters import CategoryIndex, build_exclude_mask
from ._sharded_serving import ShardedIndicators


@dataclasses.dataclass
class TrainingData(SanityCheck):
    #: per event name: (user_idx, item_idx) COO
    events: dict[str, tuple[np.ndarray, np.ndarray]]
    users: BiMap
    items: BiMap
    item_categories: dict[str, set[str]]
    #: item id → {"availableDate" / "expireDate" / "date": ISO string}
    item_dates: dict[str, dict] = dataclasses.field(default_factory=dict)

    def sanity_check(self):
        if not self.events:
            raise ValueError("no indicator events found")
        primary = next(iter(self.events.values()))
        if len(primary[0]) == 0:
            raise ValueError("primary event has no data")


PreparedData = TrainingData


@dataclasses.dataclass(frozen=True)
class URDataSourceParams(Params):
    app_name: str = ""
    #: the first name is the primary (conversion) event, as UR's eventNames
    event_names: Sequence[str] = ("buy", "view")
    item_entity_type: str = "item"


class URDataSource(DataSource):
    params_cls = URDataSourceParams
    params_aliases = {"appName": "app_name", "eventNames": "event_names"}

    def read_training(self, ctx) -> TrainingData:
        """The indicator events from the event store (``find_batch``), users
        and items indexed in first-seen order, and the items' categories
        and dates replayed from their property events."""
        p: URDataSourceParams = self.params
        if ctx.events is not None:
            raise ValueError("the Universal Recommender reads the event "
                             "store; train it with `pio train`")
        t0 = time.perf_counter()
        app_name = p.app_name or ctx.app_name
        storage = ctx.get_storage()
        batch = PEventStore.find_batch(
            app_name, event_names=list(p.event_names), storage=storage,
            channel_name=ctx.channel_name)
        users = BiMap.string_int(batch.entity_id)
        items = BiMap.string_int(
            t for t in batch.target_entity_id if t is not None)
        per_event: dict[str, tuple[list, list]] = {
            n: ([], []) for n in p.event_names}
        for name, u, t in zip(batch.event, batch.entity_id,
                              batch.target_entity_id):
            if t is None:
                continue
            lu, li = per_event[name]
            lu.append(users(u))
            li.append(items(t))
        events = {n: (np.asarray(lu, np.int32), np.asarray(li, np.int32))
                  for n, (lu, li) in per_event.items()}
        cats: dict[str, set[str]] = {}
        dates: dict[str, dict] = {}
        for item_id, pm in PEventStore.aggregate_properties(
                app_name, p.item_entity_type, storage=storage).items():
            c = pm.get_opt("categories")
            if c:
                cats[item_id] = set(c)
            d = {k: pm.get_opt(k)
                 for k in ("availableDate", "expireDate", "date")}
            d = {k: v for k, v in d.items() if v}
            if d:
                dates[item_id] = d
        ctx.record_read(time.perf_counter() - t0, len(batch))
        return TrainingData(events, users, items, cats, dates)


@dataclasses.dataclass
class URModel:
    #: event name → Indicators ([I, K] idx / LLR against the primary items)
    indicators: dict[str, Indicators]
    users: BiMap
    items: BiMap
    item_categories: dict[str, set[str]]
    app_name: str
    event_names: Sequence[str]
    #: where the indicators are resident and scored
    device: torch.device
    #: primary-event count per item: the cold-user backfill ranking
    popularity: Optional[np.ndarray] = None
    #: item id → {"availableDate" / "expireDate" / "date": ISO}
    item_dates: dict[str, dict] = dataclasses.field(default_factory=dict)
    #: the event store the history reads go to (None: the process's
    #: ``Storage.instance()``)
    storage: Any = dataclasses.field(default=None, repr=False, compare=False)
    _cat_index: Optional[CategoryIndex] = dataclasses.field(
        default=None, repr=False, compare=False)
    _date_arrays: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    _ind_catalog: Optional[ShardedIndicators] = dataclasses.field(
        default=None, repr=False, compare=False)

    def indicator_catalog(self) -> ShardedIndicators:
        """The serve-side indicator layout on the model's device
        (host-sharded beyond PIO_SERVE_SHARD_ITEMS rows), made once."""
        if self._ind_catalog is None:
            self._ind_catalog = ShardedIndicators(
                self.indicators, len(self.items), self.device)
        return self._ind_catalog

    def category_index(self) -> CategoryIndex:
        if self._cat_index is None:
            self._cat_index = CategoryIndex(self.items, self.item_categories)
        return self._cat_index

    def date_arrays(self):
        """(avail, expire, date) [I] epoch seconds: a missing availableDate
        is -inf (always available), a missing expireDate +inf (never
        expires), a missing date NaN (fails every dateRange comparison,
        UR's must-clause semantics). An unparseable value counts as
        missing."""
        if self._date_arrays is None:
            n = len(self.items)
            avail = np.full(n, -np.inf)
            expire = np.full(n, np.inf)
            date = np.full(n, np.nan)
            for item_id, d in self.item_dates.items():
                j = self.items.get(item_id)
                if j is None:
                    continue
                try:
                    if "availableDate" in d:
                        avail[j] = parse_event_time(
                            str(d["availableDate"])).timestamp()
                    if "expireDate" in d:
                        expire[j] = parse_event_time(
                            str(d["expireDate"])).timestamp()
                    if "date" in d:
                        date[j] = parse_event_time(str(d["date"])).timestamp()
                except (ValueError, TypeError, AttributeError):
                    pass
            self._date_arrays = (avail, expire, date)
        return self._date_arrays

    def warm_up(self, num: int = 10):
        """Make the indicators resident and answer one query (deploy time)."""
        self.indicator_catalog()
        if len(self.users):
            self.recommend(next(iter(self.users.keys())), num)

    def _history(self, user: str) -> dict[str, np.ndarray]:
        """The user's history per event type, read from the event store at
        serve time (one read, bucketed by event name)."""
        n_items = len(self.items)
        out = {name: np.zeros(n_items, np.float32)
               for name in self.event_names}
        try:
            events = LEventStore.find_by_entity(
                self.app_name, "user", user,
                event_names=list(self.event_names),
                limit=500 * max(len(self.event_names), 1),
                storage=self.storage)
        except StorageError:
            events = []
        for e in events:
            membership = out.get(e.event)
            if membership is None or not e.target_entity_id:
                continue
            j = self.items.get(e.target_entity_id)
            if j is not None:
                membership[j] = 1.0
        return out

    def _date_exclude(self, current_date: Optional[str],
                      date_range: Optional[dict]) -> np.ndarray:
        """Items not yet available or already expired at ``current_date``
        (default: now), and those outside ``date_range`` on their date."""
        exclude = np.zeros(len(self.items), dtype=bool)
        avail, expire, date = self.date_arrays()
        now = (parse_event_time(str(current_date)).timestamp()
               if current_date else time.time())
        exclude |= (now < avail) | (now > expire)
        if date_range:
            after = date_range.get("after")
            before = date_range.get("before")
            ok = ~np.isnan(date)
            if after:
                ok &= date >= parse_event_time(str(after)).timestamp()
            if before:
                ok &= date <= parse_event_time(str(before)).timestamp()
            exclude |= ~ok
        return exclude

    def recommend(
        self,
        user: Optional[str],
        num: int,
        fields: Optional[Sequence[dict]] = None,
        blacklist_items: Optional[Sequence[str]] = None,
        exclude_primary_history: bool = True,
        items: Optional[Sequence[str]] = None,
        current_date: Optional[str] = None,
        date_range: Optional[dict] = None,
    ):
        """User-based, item-based (the query items act as history for every
        event type) or both; a user with neither falls back to the
        popularity ranking through the same rules."""
        n_items = len(self.items)
        history = (self._history(user) if user is not None
                   else {n: np.zeros(n_items, np.float32)
                         for n in self.event_names})
        query_idx = [j for q in items or []
                     if (j := self.items.get(q)) is not None]
        for j in query_idx:
            for name in self.event_names:
                history[name][j] = 1.0

        exclude = build_exclude_mask(
            self.items, black_list=blacklist_items,
            extra_excluded_items=items)  # never the query items
        if exclude_primary_history:
            exclude |= history[self.event_names[0]] > 0
        if current_date or date_range or self.item_dates:
            exclude |= self._date_exclude(current_date, date_range)
        # "fields" rules: bias < 0 filters, bias > 0 boosts
        boost_vec = np.ones(n_items, np.float32)
        for f in fields or []:
            match = self.category_index().any_of(f.get("values", []))
            bias = float(f.get("bias", -1))
            if bias < 0:
                exclude |= ~match
            else:
                boost_vec = np.where(match, boost_vec * bias, boost_vec)

        if not any(m.any() for m in history.values()):
            if self.popularity is None or not np.any(self.popularity):
                return []
            scores = np.where(exclude, -np.inf, self.popularity * boost_vec)
            # numpy's default sort, as the reference: its order for tied
            # popularity is the reference's
            order = np.argsort(-scores)[:num]
            return [(self.items.inverse(int(j)), float(scores[j]))
                    for j in order
                    if np.isfinite(scores[j]) and scores[j] > 0]

        entries = [(name, history[name], 1.0)
                   for name in self.event_names if name in self.indicators]
        scores, idx = self.indicator_catalog().score_user(
            entries, num, exclude=exclude, item_boost=boost_vec)
        return [(self.items.inverse(int(j)), float(s))
                for s, j in zip(scores, idx) if np.isfinite(s) and s > 0]


@dataclasses.dataclass(frozen=True)
class URAlgorithmParams(Params):
    app_name: str = ""
    max_correlators_per_item: int = 50
    llr_threshold: float = 0.0
    user_chunk: int = 2048


class URAlgorithm(Algorithm):
    """In a gang every rank reads the merged view (the data source has no
    partition branch, as the reference's), counts its block of the user
    ranges and sums the counts with the others; the leader persists."""
    gang_capable = True

    params_cls = URAlgorithmParams
    params_aliases = {
        "appName": "app_name",
        "maxCorrelatorsPerItem": "max_correlators_per_item",
        "minLLR": "llr_threshold",
    }

    def train(self, ctx, pd: PreparedData) -> URModel:
        p = self.params
        names = list(pd.events.keys())
        pu, pi = pd.events[names[0]]
        # every (primary, event type) pair in one fused pass; the primary's
        # own arrays (by identity) make the self-pair
        secondaries = {name: pd.events[name] for name in names
                       if len(pd.events[name][0])}
        indicators = cco_indicators_multi(
            pu, pi, secondaries, n_users=len(pd.users),
            n_items=len(pd.items),
            max_correlators=p.max_correlators_per_item,
            llr_threshold=p.llr_threshold, u_chunk=p.user_chunk,
            device=ctx.device, timings=ctx.bench_timings,
            collectives=gang_collectives())
        popularity = np.bincount(np.asarray(pi, np.int64),
                                 minlength=len(pd.items)).astype(np.float32)
        return URModel(
            indicators=indicators, users=pd.users, items=pd.items,
            item_categories=pd.item_categories,
            app_name=p.app_name or ctx.app_name, event_names=tuple(names),
            popularity=popularity, item_dates=dict(pd.item_dates),
            device=ctx.device, storage=ctx.storage)

    def predict(self, model: URModel, query: dict) -> dict:
        items = query.get("itemSet") or query.get("items")
        if not items and query.get("item") is not None:
            items = [query["item"]]
        user = query.get("user")
        pairs = model.recommend(
            str(user) if user is not None else None,
            int(query.get("num", 10)),
            fields=query.get("fields"),
            blacklist_items=query.get("blacklistItems"),
            items=[str(i) for i in items] if items else None,
            current_date=query.get("currentDate"),
            date_range=query.get("dateRange"))
        return {"itemScores": [{"item": i, "score": s} for i, s in pairs]}

    def prepare_model_for_persistence(self, model: URModel) -> dict:
        return flatten(model_to_persisted(model))

    def restore_model(self, stored, ctx) -> URModel:
        return model_from_persisted(nest(stored), ctx.device, ctx.storage)


def model_to_persisted(model: URModel) -> dict:
    """The reference's persisted dict (universal_recommender.py:395-409)."""
    return {
        "indicators": {n: {"idx": ind.idx, "score": ind.score}
                       for n, ind in model.indicators.items()},
        "users": model.users.to_persisted(),
        "items": model.items.to_persisted(),
        "item_categories": {k: sorted(v)
                            for k, v in model.item_categories.items()},
        "app_name": model.app_name,
        "event_names": list(model.event_names),
        "popularity": (np.asarray(model.popularity)
                       if model.popularity is not None else None),
        "item_dates": dict(model.item_dates),
    }


def flatten(stored: dict) -> dict:
    """The persisted dict with its nested ``indicators`` as top-level
    arrays (``indicators/<k>/idx`` and ``/score``, the names in
    ``indicator_names``): every value is then an array or JSON."""
    out = {k: v for k, v in stored.items() if k != "indicators"}
    out["indicator_names"] = list(stored["indicators"])
    for k, ind in enumerate(stored["indicators"].values()):
        out[f"indicators/{k}/idx"] = np.asarray(ind["idx"], np.int32)
        out[f"indicators/{k}/score"] = np.asarray(ind["score"], np.float32)
    return out


def nest(stored: dict) -> dict:
    """Inverse of :func:`flatten`; a dict with ``indicators`` (the
    reference's) passes as it is."""
    if "indicators" in stored:
        return stored
    out = {k: v for k, v in stored.items()
           if k != "indicator_names" and not k.startswith("indicators/")}
    out["indicators"] = {
        name: {"idx": stored[f"indicators/{k}/idx"],
               "score": stored[f"indicators/{k}/score"]}
        for k, name in enumerate(stored["indicator_names"])}
    return out


def model_from_persisted(stored: dict, device="cuda",
                         storage=None) -> URModel:
    """The reference's persisted dict → URModel serving on ``device``, its
    history reads going to ``storage``."""
    pop = stored.get("popularity")
    return URModel(
        indicators={n: Indicators(idx=np.asarray(v["idx"], np.int32),
                                  score=np.asarray(v["score"], np.float32))
                    for n, v in stored["indicators"].items()},
        users=BiMap.from_persisted(stored["users"]),
        items=BiMap.from_persisted(stored["items"]),
        item_categories={k: set(v)
                         for k, v in stored["item_categories"].items()},
        app_name=stored["app_name"],
        event_names=tuple(stored["event_names"]),
        popularity=None if pop is None else np.asarray(pop, np.float32),
        item_dates=dict(stored.get("item_dates") or {}),
        device=resolve_device(device), storage=storage)


class UniversalRecommenderEngine(EngineFactory):
    """engine.json: "engineFactory":
    "incubator_predictionio_torch.models.universal_recommender.UniversalRecommenderEngine"
    """

    def apply(self) -> Engine:
        return Engine(
            data_source_class=URDataSource,
            algorithm_class_map={"ur": URAlgorithm, "": URAlgorithm},
        )
