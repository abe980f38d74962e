"""The port's Universal Recommender (``models/universal_recommender.py``,
with ``convert.py``'s UR dict) on the CPU against the JAX reference
template, on stores both packages read (one SQLite file, one JSONL log):

- the training data (per-event COO, first-seen id maps, categories, dates)
  equal to the reference's;
- the indicators of both event types under the top-k rule against the
  reference's (``tol = 2e-6·N·ln N``);
- the scenarios of tests/test_ur_completeness.py:89-171 (cold user with
  the popularity backfill, the available / expire date rules, dateRange,
  item-based, user + items), each answered by the port's deployment of
  the reference's persisted model like the reference's deployment, and by
  the port's own model like a host numpy scorer of its persisted
  indicators;
- persistence: the port's arrays-and-JSON artifact round trip, and the
  reference's dict in and out through ``convert.py``;
- the history read catches only ``StorageError``; the device rule.
"""

import datetime as dt

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from cco_parity import (  # noqa: E402
    dense_counts, g2_tol, hold_served, hold_topk, host_scores, reference_g2,
)
from incubator_predictionio_tpu.controller import EngineParams as RefEngineParams  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.models import universal_recommender as ref_ur  # noqa: E402
from incubator_predictionio_tpu.workflow import core_workflow as ref_workflow  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_torch import convert  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data import storage as port_storage  # noqa: E402
from incubator_predictionio_torch.data.storage.registry import StorageError  # noqa: E402
from incubator_predictionio_torch.models import universal_recommender as port_ur  # noqa: E402
from incubator_predictionio_torch.workflow import core_workflow, persist  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402

T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
FACTORY = ("incubator_predictionio_torch.models.universal_recommender."
           "UniversalRecommenderEngine")
ENGINE_JSON = {
    "engineFactory": FACTORY,
    "datasource": {"params": {"appName": "urcapp",
                              "eventNames": ["buy", "view"]}},
    "algorithms": [{"name": "ur", "params": {
        "appName": "urcapp", "maxCorrelatorsPerItem": 8, "user_chunk": 64}}],
}


def _ts(i):
    return T0 + dt.timedelta(seconds=i)


def _ur_events(pkg):
    """tests/test_ur_completeness.py's fixture: two taste groups (i0-i11,
    i12-i23), i0 the runaway bestseller, categories even/odd, i1 available
    only from 2030, i2 expired in 2020, every item a "date"."""
    rng = np.random.default_rng(3)
    events = []
    for u in range(40):
        lo, hi = (0, 12) if u % 2 == 0 else (12, 24)
        for _ in range(4):
            events.append(pkg.Event("buy", "user", str(u), "item",
                                    f"i{rng.integers(lo, hi)}",
                                    event_time=_ts(len(events))))
        for _ in range(8):
            events.append(pkg.Event("view", "user", str(u), "item",
                                    f"i{rng.integers(lo, hi)}",
                                    event_time=_ts(len(events))))
    for u in range(40):
        events.append(pkg.Event("buy", "user", str(u), "item", "i0",
                                event_time=_ts(len(events))))
    for j in range(24):
        props = {"categories": ["even" if j % 2 == 0 else "odd"],
                 "date": (T0 + dt.timedelta(days=j)).isoformat()}
        if j == 1:
            props["availableDate"] = "2030-01-01T00:00:00Z"
        if j == 2:
            props["expireDate"] = "2020-01-01T00:00:00Z"
        events.append(pkg.Event("$set", "item", f"i{j}",
                                properties=pkg.DataMap(props),
                                event_time=_ts(len(events))))
    return events


def _env(kind, tmp_path):
    repos = {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "DB"
             for r in ("METADATA", "MODELDATA")}
    db = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
          "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.sqlite")}
    if kind == "sqlite":
        return repos | db | {"PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB"}
    return repos | db | {"PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
                         "PIO_STORAGE_SOURCES_LOG_TYPE": "JSONL",
                         "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "events")}


@pytest.fixture(params=["sqlite", "jsonl"])
def stores(request, tmp_path):
    """(port store, reference store) over one set of files, the events
    written by the reference."""
    env = _env(request.param, tmp_path)
    ref = ref_storage.Storage(env)
    app_id = ref.get_meta_data_apps().insert(ref_storage.App(0, "urcapp"))
    ref.get_l_events().init(app_id)
    ref.get_l_events().insert_batch(_ur_events(ref_storage), app_id)
    port = port_storage.Storage(env)
    yield port, ref
    port.close()
    ref.close()


def _components(port, ref):
    """(port data source, port algorithm, reference data source, reference
    algorithm) of ENGINE_JSON."""
    ds, _, algos, _ = port_ur.UniversalRecommenderEngine()().make_components(
        EngineParams.from_json(ENGINE_JSON))
    rds, _, ralgos, _ = ref_ur.UniversalRecommenderEngine()().make_components(
        RefEngineParams.from_json(ENGINE_JSON))
    return ds, algos[0][1], rds, ralgos[0][1]


def _ctx(port):
    return WorkflowContext(app_name="urcapp", storage=port, device="cpu")


def test_training_data_equals_the_reference(stores):
    port, ref = stores
    ds, _, rds, _ = _components(port, ref)
    td = ds.read_training(_ctx(port))
    rtd = rds.read_training(RefContext(app_name="urcapp", storage=ref))
    assert list(td.events) == list(rtd.events) == ["buy", "view"]
    for name in td.events:
        for got, want in zip(td.events[name], rtd.events[name]):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert list(td.users.keys()) == list(rtd.users.keys())
    assert list(td.items.keys()) == list(rtd.items.keys())
    assert td.item_categories == rtd.item_categories
    assert td.item_dates == rtd.item_dates
    assert td.item_dates["i1"]["availableDate"] == "2030-01-01T00:00:00Z"


def test_indicators_meet_the_topk_rule(stores):
    port, ref = stores
    ds, algo, rds, ralgo = _components(port, ref)
    td = ds.read_training(_ctx(port))
    ctx = _ctx(port)
    ctx.bench_timings = {}
    model = algo.train(ctx, td)
    assert ctx.bench_timings["path"] == "fused"
    rmodel = ralgo.train(RefContext(app_name="urcapp", storage=ref),
                         rds.read_training(RefContext(app_name="urcapp",
                                                      storage=ref)))
    n_users, n_items = len(td.users), len(td.items)
    pu, pi = td.events["buy"]
    for name, (su, si) in td.events.items():
        c, n_i, n_j = dense_counts(pu, pi, su, si, n_users, n_items)
        ref_ind = rmodel.indicators[name]
        hold_topk(model.indicators[name].idx, model.indicators[name].score,
                  np.where(ref_ind.idx >= 0, ref_ind.score, 0),
                  reference_g2(c, n_i, n_j, n_users), g2_tol(n_users))
    assert np.array_equal(model.popularity, np.asarray(rmodel.popularity))
    assert model.item_dates == rmodel.item_dates
    assert tuple(model.event_names) == tuple(rmodel.event_names)


SCENARIOS = [
    {"user": "no-such-user", "num": 5},
    {"user": "no-such-user", "num": 5, "fields": [
        {"name": "categories", "values": ["odd"], "bias": -1}]},
    {"user": "no-such-user", "num": 24},
    {"user": "no-such-user", "num": 24,
     "currentDate": "2031-06-01T00:00:00Z"},
    {"user": "no-such-user", "num": 24, "dateRange": {
        "after": (T0 + dt.timedelta(days=4)).isoformat(),
        "before": (T0 + dt.timedelta(days=8)).isoformat()}},
    {"item": "i5", "num": 5},
    {"itemSet": ["i5", "i7"], "num": 5},
    {"user": "0", "item": "i4", "num": 5},
    {"user": "0", "num": 5},
    {"user": "3", "num": 10, "blacklistItems": ["i13", "i15"]},
    {"user": "2", "num": 6, "fields": [
        {"name": "categories", "values": ["odd"], "bias": 2}]},
    {"user": "7", "num": 6, "fields": [
        {"name": "categories", "values": ["even"], "bias": -1}],
     "currentDate": "2031-06-01T00:00:00Z"},
]


def _ids(result):
    return [e["item"] for e in result["itemScores"]]


def _hold_to_host(model, query, result):
    """The port's answer against the host scorer of its indicators, with
    the exclusions and boosts the model's own rules give (the cold path:
    the popularity ranking)."""
    items = model.items
    n = len(items)
    q_items = query.get("itemSet") or (
        [query["item"]] if "item" in query else [])
    user = query.get("user")
    history = (model._history(user) if user is not None
               else {e: np.zeros(n, np.float32) for e in model.event_names})
    for j in (items.get(x) for x in q_items):
        if j is not None:
            for e in model.event_names:
                history[e][j] = 1.0
    exclude = np.zeros(n, bool)
    for x in list(query.get("blacklistItems", [])) + list(q_items):
        if items.get(x) is not None:
            exclude[items.get(x)] = True
    exclude |= history[model.event_names[0]] > 0
    exclude |= model._date_exclude(query.get("currentDate"),
                                   query.get("dateRange"))
    boost = np.ones(n)
    for f in query.get("fields", []):
        match = model.category_index().any_of(f["values"])
        if f["bias"] < 0:
            exclude |= ~match
        else:
            boost = np.where(match, boost * f["bias"], boost)
    got_idx = [items(x) for x in _ids(result)]
    got_scores = [e["score"] for e in result["itemScores"]]
    if not any(m.any() for m in history.values()):
        total = np.where(exclude, -np.inf, model.popularity * boost)
    else:
        total = host_scores(
            {e: (ind.idx, ind.score) for e, ind in model.indicators.items()},
            history, boost, exclude)
    hold_served(got_idx, got_scores, total, query["num"])


def _deployments(port, ref):
    """(port deployment of the port's train, port deployment of the
    reference's persisted model, the reference's deployment)."""
    rengine = ref_ur.UniversalRecommenderEngine()()
    rparams = RefEngineParams.from_json(ENGINE_JSON)
    riid = ref_workflow.run_train(
        rengine, rparams, RefContext(app_name="urcapp", storage=ref),
        engine_factory_name="ur-ref")
    rdep, _, _ = ref_workflow.load_deployment(
        rengine, riid, RefContext(storage=ref), engine_factory_name="ur-ref")
    engine = port_ur.UniversalRecommenderEngine()()
    params = EngineParams.from_json(ENGINE_JSON)
    iid = core_workflow.run_train(engine, params, _ctx(port),
                                  engine_factory_name=FACTORY)
    dep, _, _ = core_workflow.load_deployment(
        engine, iid, WorkflowContext(storage=port, device="cpu"),
        engine_factory_name=FACTORY)
    stored = rdep.algo_list[0][1].prepare_model_for_persistence(
        rdep.models[0])
    from_ref = engine.prepare_deployment(
        WorkflowContext(storage=port, device="cpu"), params, [stored])
    return dep, from_ref, rdep


def test_scenarios_match_the_reference_and_the_host_scorer(stores):
    port, ref = stores
    dep, from_ref, rdep = _deployments(port, ref)
    model = dep.models[0]
    for q in SCENARIOS:
        _hold_answers(from_ref.query(q), rdep.query(q))
        _hold_to_host(model, q, dep.query(q))
    # the reference test's assertions, on the port's own deployment
    cold = _ids(dep.query({"user": "no-such-user", "num": 5}))
    assert cold and cold[0] == "i0"
    odd = _ids(dep.query(SCENARIOS[1]))
    assert odd and all(int(x[1:]) % 2 == 1 for x in odd)
    assert not {"i1", "i2"} & set(_ids(dep.query(SCENARIOS[2])))
    later = set(_ids(dep.query(SCENARIOS[3])))
    assert "i1" in later and "i2" not in later
    ranged = _ids(dep.query(SCENARIOS[4]))
    assert ranged and all(4 <= int(x[1:]) <= 8 for x in ranged)
    similar = _ids(dep.query(SCENARIOS[5]))
    assert similar and "i5" not in similar
    assert sum(int(x[1:]) < 12 for x in similar) >= len(similar) - 1
    assert not {"i5", "i7"} & set(_ids(dep.query(SCENARIOS[6])))
    union = _ids(dep.query(SCENARIOS[7]))
    assert union and "i4" not in union


def _hold_answers(got, want, rtol=1e-5):
    """Two deployments' answers: the same count, scores within ``rtol``
    relative, the same items wherever the expected neighbouring scores
    differ by more than ``rtol`` relative."""
    gi, wi = _ids(got), _ids(want)
    gs = np.array([e["score"] for e in got["itemScores"]])
    ws = np.array([e["score"] for e in want["itemScores"]])
    assert len(gi) == len(wi), (gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=rtol)
    close = np.isclose(ws[1:], ws[:-1], rtol=rtol, atol=0)
    distinct = np.ones(len(ws), bool)
    distinct[1:] &= ~close
    distinct[:-1] &= ~close
    assert [x for x, d in zip(gi, distinct) if d] == \
        [x for x, d in zip(wi, distinct) if d]


def test_persisted_model_round_trips_and_converts(stores):
    port, ref = stores
    dep, from_ref, rdep = _deployments(port, ref)
    model = dep.models[0]
    algo = dep.algo_list[0][1]
    stored = algo.prepare_model_for_persistence(model)
    assert "indicators" not in stored and stored["indicator_names"] == [
        "buy", "view"]
    assert all(isinstance(v, np.ndarray) or not any(
        isinstance(x, np.ndarray) for x in _leaves(v))
        for v in stored.values())
    _, [back] = persist.models_from_bytes(persist.models_to_bytes({}, [stored]))
    again = algo.restore_model(back, _ctx(port))
    for name in model.indicators:
        assert np.array_equal(again.indicators[name].idx,
                              model.indicators[name].idx)
        assert np.array_equal(again.indicators[name].score,
                              model.indicators[name].score)
    assert again.item_dates == model.item_dates
    assert again.item_categories == model.item_categories
    assert np.array_equal(again.popularity, model.popularity)
    for q in SCENARIOS:
        assert again.recommend(**_recommend_args(q)) == \
            model.recommend(**_recommend_args(q))
    # the reference's dict, both ways
    rstored = rdep.algo_list[0][1].prepare_model_for_persistence(
        rdep.models[0])
    conv = convert.from_jax_persisted(rstored, device="cpu", storage=port)
    assert isinstance(conv, port_ur.URModel)
    assert conv.item_dates == rdep.models[0].item_dates
    out = convert.to_jax_persisted(conv)
    assert set(out) == set(rstored)
    restored = rdep.algo_list[0][1].restore_model(
        out, RefContext(storage=ref))
    for q in SCENARIOS:
        assert restored.recommend(**_recommend_args(q)) == \
            rdep.models[0].recommend(**_recommend_args(q))
    with pytest.raises(ValueError, match="missing"):
        convert.from_jax_persisted(
            {k: v for k, v in rstored.items() if k != "event_names"},
            device="cpu")


def _leaves(v):
    if isinstance(v, dict):
        for x in v.values():
            yield from _leaves(x)
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from _leaves(x)
    else:
        yield v


def _recommend_args(q):
    items = q.get("itemSet") or ([q["item"]] if "item" in q else None)
    return dict(user=q.get("user"), num=q["num"], fields=q.get("fields"),
                blacklist_items=q.get("blacklistItems"), items=items,
                current_date=q.get("currentDate"),
                date_range=q.get("dateRange"))


class _Apps:
    def __init__(self, error):
        self.error = error

    def get_by_name(self, name):
        raise self.error


class _BrokenStorage:
    def __init__(self, error):
        self.error = error

    def get_meta_data_apps(self):
        return _Apps(self.error)


def test_history_read_catches_only_the_storage_error(stores):
    port, ref = stores
    dep, _, _ = _deployments(port, ref)
    model = dep.models[0]
    model.storage = _BrokenStorage(StorageError("backend down"))
    # no history: the popularity backfill
    assert model.recommend("0", 5) == model.recommend("no-such-user", 5)
    model.storage = _BrokenStorage(RuntimeError("a fault of the port"))
    with pytest.raises(RuntimeError, match="a fault of the port"):
        model.recommend("0", 5)


def test_device_rule_and_the_event_store_read(monkeypatch):
    stored = {"indicators": {"buy": {"idx": np.zeros((2, 1), np.int32),
                                     "score": np.ones((2, 1), np.float32)}},
              "users": {"u": 0}, "items": {"a": 0, "b": 1},
              "item_categories": {}, "app_name": "a",
              "event_names": ["buy"], "popularity": None, "item_dates": {}}
    assert port_ur.model_from_persisted(stored, "cpu").device.type == "cpu"
    assert port_ur.nest(port_ur.flatten(stored))["indicators"]["buy"][
        "idx"].shape == (2, 1)
    ds, _, _, _ = _components(None, None)
    with pytest.raises(ValueError, match="event store"):
        ds.read_training(WorkflowContext(events=[], device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_ur.model_from_persisted(stored)
