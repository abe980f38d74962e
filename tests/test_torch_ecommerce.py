"""The port's E-Commerce template (``models/ecommerce.py``, with
``convert.py``'s E-Commerce dict) on the CPU against the JAX reference
template, on stores both packages read (one SQLite file, one JSONL log):

- the training data and the implicit-ALS factors within 2e-4 of the
  reference's for the same seed, at λ = 0.1 (rank 8, 10 iterations; every
  user has 12 views and every item more than 12, so the normal equations
  are well conditioned);
- the reference's persisted dict, deployed in the port on the same store,
  answers index-identically to the reference for default queries,
  categories, whiteList and blackList queries, ``unseenOnly: false``,
  after a ``$set`` of constraint/unavailableItems, and an unknown user;
- ``read_eval``: the same folds (training triples, queries, actuals);
- the template's own scenario (tests/test_templates.py:187-231) through
  ``run_train`` → ``load_deployment``;
- the port's model persists as the reference's dict and back;
- the serve-time reads catch only ``StorageError``; ``shardedServing:
  always`` is refused, ``computeDtype`` / ``chunkTiles`` are accepted; and
  the template needs a card unless the CPU is asked for.
"""

import datetime as dt

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from incubator_predictionio_tpu.controller import EngineParams as RefEngineParams  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.models import ecommerce as ref_ec  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_torch import convert  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data import storage as port_storage  # noqa: E402
from incubator_predictionio_torch.data.storage.registry import StorageError  # noqa: E402
from incubator_predictionio_torch.models import ecommerce as port_ec  # noqa: E402
from incubator_predictionio_torch.workflow import core_workflow  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402

TOL = 2e-4
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
FACTORY = "incubator_predictionio_torch.models.ecommerce.ECommerceEngine"
ENGINE_JSON = {
    "engineFactory": FACTORY,
    "datasource": {"params": {"appName": "ecapp"}},
    "algorithms": [{"name": "ecomm", "params": {
        "appName": "ecapp", "rank": 8, "numIterations": 10, "lambda": 0.1}}],
}


def _ts(i):
    return T0 + dt.timedelta(seconds=i)


def _seed_views(pkg, groups=((0, 10), (10, 20)), n_users=40):
    """tests/test_templates.py's _seed_views: users view items only within
    their own group; item categories red (group 0) and blue (group 1)."""
    rng = np.random.default_rng(3)
    events = []
    for u in range(n_users):
        lo, hi = groups[u % len(groups)]
        for _ in range(12):
            i = rng.integers(lo, hi)
            events.append(pkg.Event("view", "user", str(u), "item", f"i{i}",
                                    event_time=_ts(len(events))))
    for i in range(groups[-1][1]):
        cat = "red" if i < groups[0][1] else "blue"
        events.append(pkg.Event("$set", "item", f"i{i}",
                                properties=pkg.DataMap({"categories": [cat]}),
                                event_time=_ts(len(events))))
    # a few buys, which count as seen too
    for u, i in ((0, 3), (1, 14), (2, 5)):
        events.append(pkg.Event("buy", "user", str(u), "item", f"i{i}",
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
    """(port store, reference store, app id) over one set of files, the
    events written by the reference."""
    env = _env(request.param, tmp_path)
    ref = ref_storage.Storage(env)
    app_id = ref.get_meta_data_apps().insert(ref_storage.App(0, "ecapp"))
    ref.get_l_events().init(app_id)
    ref.get_l_events().insert_batch(_seed_views(ref_storage), app_id)
    port = port_storage.Storage(env)
    yield port, ref, app_id
    port.close()
    ref.close()


def _ref_trained(ref, engine_json=ENGINE_JSON):
    engine = ref_ec.ECommerceEngine()()
    params = RefEngineParams.from_json(engine_json)
    ctx = RefContext(app_name="ecapp", storage=ref)
    ds, prep, algo_list, _ = engine.make_components(params)
    td = ds.read_training(ctx)
    algo = algo_list[0][1]
    return td, algo, algo.train(ctx, prep.prepare(ctx, td)), engine, params


def _port_trained(port, engine_json=ENGINE_JSON):
    engine = port_ec.ECommerceEngine()()
    params = EngineParams.from_json(engine_json)
    ctx = WorkflowContext(app_name="ecapp", storage=port, device="cpu")
    ds, _, algo_list, _ = engine.make_components(params)
    return ds.read_training(ctx), algo_list[0][1], \
        engine.train(ctx, params)[0]


def test_training_data_and_factors_match_the_reference(stores):
    port, ref, _ = stores
    rtd, _, rmodel, _, _ = _ref_trained(ref)
    td, _, model = _port_trained(port)
    for f in ("user_idx", "item_idx", "rating"):
        assert np.array_equal(getattr(td, f), getattr(rtd, f)), f
    assert list(td.users.keys()) == list(rtd.users.keys())
    assert list(td.items.keys()) == list(rtd.items.keys())
    assert td.item_categories == rtd.item_categories
    for got, want in ((model.factors.user_factors, rmodel.factors.user_factors),
                      (model.factors.item_factors, rmodel.factors.item_factors)):
        assert np.allclose(got, np.asarray(want), rtol=TOL, atol=TOL), \
            float(np.abs(got - np.asarray(want)).max())
    assert model.app_name == rmodel.app_name == "ecapp"
    assert tuple(model.seen_event_names) == tuple(rmodel.seen_event_names)


QUERIES = [
    {"user": "0", "num": 5},
    {"user": "1", "num": 10},
    {"user": "2", "num": 20},
    {"user": "3", "num": 4, "categories": ["red"]},
    {"user": "4", "num": 8, "categories": ["blue", "red"]},
    {"user": "5", "num": 6, "whiteList": ["i0", "i5", "i11", "i19", "zz"]},
    {"user": "6", "num": 6, "blackList": ["i0", "i1", "i2", "zz"]},
    {"user": "7", "num": 5, "categories": ["blue"], "blackList": ["i12"],
     "whiteList": ["i12", "i13", "i14", "i3"]},
    {"user": "0", "num": 10, "unseenOnly": False},
    {"user": "9", "num": 3, "unseenOnly": False, "categories": ["red"]},
    {"user": "nobody", "num": 5},
]


def _ids(result):
    return [e["item"] for e in result["itemScores"]]


def _hold_answers(port_dep, ref_dep, queries):
    for q in queries:
        got, want = port_dep.query(q), ref_dep.query(q)
        assert _ids(got) == _ids(want), q
        assert np.allclose([e["score"] for e in got["itemScores"]],
                           [e["score"] for e in want["itemScores"]],
                           rtol=1e-6, atol=1e-6), q


def test_reference_model_deployed_in_the_port_answers_identically(stores):
    port, ref, app_id = stores
    _, ralgo, rmodel, rengine, rparams = _ref_trained(ref)
    stored = ralgo.prepare_model_for_persistence(rmodel)
    port_dep = port_ec.ECommerceEngine()().prepare_deployment(
        WorkflowContext(storage=port, device="cpu"),
        EngineParams.from_json(ENGINE_JSON), [stored])
    ref_dep = rengine.prepare_deployment(RefContext(storage=ref), rparams,
                                         [stored])
    assert port_dep.query({"user": "nobody", "num": 5}) == {"itemScores": []}
    _hold_answers(port_dep, ref_dep, QUERIES)
    # user 0's seen items never come back by default
    seen = {e.target_entity_id for e in ref.get_l_events().find(
        app_id, entity_type="user", entity_id="0")}
    assert not set(_ids(port_dep.query({"user": "0", "num": 10}))) & seen
    # two items made unavailable, then a newer $set that replaces them
    top = _ids(port_dep.query({"user": "0", "num": 5}))
    for k, items in enumerate((top[:2], [top[2]])):
        ref.get_l_events().insert(ref_storage.Event(
            "$set", "constraint", "unavailableItems",
            properties=ref_storage.DataMap({"items": items}),
            event_time=_ts(99_999 + k)), app_id)
        answer = _ids(port_dep.query({"user": "0", "num": 5}))
        assert not set(items) & set(answer)
        if k == 1:  # the newer $set makes top[0] and top[1] available again
            assert answer[:2] == top[:2]
        _hold_answers(port_dep, ref_dep, QUERIES)


def test_read_eval_folds_are_the_reference(stores):
    port, ref, _ = stores
    params = {"datasource": {"params": {"appName": "ecapp"}}}
    got = port_ec.ECommerceEngine()().make_components(
        EngineParams.from_json(params))[0].read_eval(
        WorkflowContext(storage=port, device="cpu"))
    want = ref_ec.ECommerceEngine()().make_components(
        RefEngineParams.from_json(params))[0].read_eval(RefContext(storage=ref))
    assert len(got) == len(want) == 3
    for (td, info, qa), (rtd, rinfo, rqa) in zip(got, want):
        assert info is None and rinfo is None
        for f in ("user_idx", "item_idx", "rating"):
            assert np.array_equal(getattr(td, f), getattr(rtd, f)), f
        assert td.item_categories == rtd.item_categories
        assert qa == list(rqa) and all(q["unseenOnly"] is False for q, _ in qa)


def test_ecommerce_template_scenario(stores):
    """tests/test_templates.py:187-231 through the port's run_train and
    load_deployment."""
    port, _, app_id = stores
    engine = port_ec.ECommerceEngine()()
    ctx = WorkflowContext(app_name="ecapp", storage=port, device="cpu")
    ep = EngineParams.from_json({
        "datasource": {"params": {"appName": "ecapp"}},
        "algorithms": [{"name": "ecomm", "params": {
            "appName": "ecapp", "rank": 8, "numIterations": 10}}]})
    iid = core_workflow.run_train(engine, ep, ctx, engine_factory_name=FACTORY)
    dep, _, _ = core_workflow.load_deployment(
        engine, iid, WorkflowContext(storage=port, device="cpu"),
        engine_factory_name=FACTORY)
    le = port.get_l_events()
    seen = {e.target_entity_id for e in le.find(
        app_id, entity_type="user", entity_id="0", event_names=["view"])}
    rec_items = _ids(dep.query({"user": "0", "num": 5}))
    assert rec_items and not (set(rec_items) & seen), "seen items not filtered"
    candidate = rec_items[0]
    le.insert(port_storage.Event(
        "$set", "constraint", "unavailableItems",
        properties=port_storage.DataMap({"items": [candidate]}),
        event_time=_ts(99_999)), app_id)
    assert candidate not in _ids(dep.query({"user": "0", "num": 5}))
    r3 = dep.query({"user": "0", "num": 10, "unseenOnly": False})
    assert set(_ids(r3)) & seen


def test_model_persists_as_the_reference_dict_and_back(stores):
    port, ref, _ = stores
    _, ralgo, rmodel, _, _ = _ref_trained(ref)
    stored = ralgo.prepare_model_for_persistence(rmodel)
    model = convert.from_jax_persisted(stored, device="cpu", storage=port)
    assert isinstance(model, port_ec.ECommerceModel)
    again = convert.to_jax_persisted(model)
    assert set(again) == set(stored)
    for k in ("user_factors", "item_factors"):
        assert np.array_equal(again[k], np.asarray(stored[k]))
    for k in ("users", "items", "item_categories", "app_name",
              "seen_event_names"):
        assert again[k] == stored[k], k
    restored = ralgo.restore_model(again, RefContext(storage=ref))
    assert restored.recommend("0", 5) == rmodel.recommend("0", 5)
    with pytest.raises(ValueError, match="missing"):
        convert.from_jax_persisted(
            {k: v for k, v in stored.items() if k != "app_name"}, device="cpu")


FIND_CASES = [
    dict(entity_type="user", entity_id="0", event_names=["view", "buy"],
         limit=200, reversed_order=True),
    dict(entity_type="user", entity_id="nobody"),
    dict(entity_id="i3"),
    dict(target_entity_id="i4", limit=3),
    dict(target_entity_type="item", target_entity_id="nothing"),
    dict(entity_type="constraint", entity_id="unavailableItems",
         event_names=["$set"], limit=1, reversed_order=True),
    dict(entity_type="item", event_names=["$set"]),
    dict(entity_type="user", entity_id="u_new7", target_entity_type="item",
         reversed_order=True),
]


def test_find_equals_the_reference_as_the_log_grows(tmp_path):
    """The serve-time reads on a JSONL log: the port's ``find`` (entity
    codes from the scan's dict) returns the reference's events, also for
    ids that join the log's tables between calls."""
    env = _env("jsonl", tmp_path)
    ref = ref_storage.Storage(env)
    app_id = ref.get_meta_data_apps().insert(ref_storage.App(0, "ecapp"))
    ref.get_l_events().init(app_id)
    ref.get_l_events().insert_batch(_seed_views(ref_storage), app_id)
    port = port_storage.Storage(env)
    try:
        for k in range(3):
            for case in FIND_CASES:
                got = [e.to_json() for e in
                       port.get_l_events().find(app_id, **case)]
                want = [e.to_json() for e in
                        ref.get_l_events().find(app_id, **case)]
                assert got == want, case
            ref.get_l_events().insert_batch([
                ref_storage.Event("view", "user", f"u_new{j}", "item",
                                  f"i_new{j % 3}", event_time=_ts(5_000 + j))
                for j in range(8 * k, 8 * k + 8)] + [
                ref_storage.Event("$set", "constraint", "unavailableItems",
                                  properties=ref_storage.DataMap(
                                      {"items": [f"i{k}"]}),
                                  event_time=_ts(6_000 + k))], app_id)
    finally:
        port.close()
        ref.close()


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


def test_serve_time_reads_catch_only_the_storage_error(stores):
    port, ref, _ = stores
    _, ralgo, rmodel, _, _ = _ref_trained(ref)
    stored = ralgo.prepare_model_for_persistence(rmodel)
    model = port_ec.model_from_persisted(
        stored, "cpu", _BrokenStorage(StorageError("backend down")))
    unfiltered = port_ec.model_from_persisted(stored, "cpu", port).recommend(
        "0", 20, unseen_only=False)
    assert model.recommend("0", 20) == unfiltered
    model.storage = _BrokenStorage(RuntimeError("a fault of the port"))
    with pytest.raises(RuntimeError, match="a fault of the port"):
        model.recommend("0", 5)


def test_params_and_the_device_rule(monkeypatch):
    port_ec.ECommerceAlgorithm(  # F5: "always" serves on one device
        port_ec.ECommerceAlgoParams(sharded_serving="always"))
    with pytest.raises(ValueError, match="auto.always.never"):
        port_ec.ECommerceAlgorithm(port_ec.ECommerceAlgoParams(
            sharded_serving="bogus")).train(None, None)
    _, _, algo_list, _ = port_ec.ECommerceEngine()().make_components(
        EngineParams.from_json({"algorithms": [{"name": "ecomm", "params": {
            "computeDtype": "float32", "chunkTiles": 4,
            "shardedServing": "never", "seenEvents": ["view"]}}]}))
    p = algo_list[0][1].params
    assert (p.compute_dtype, p.chunk_tiles, p.seen_events) == \
        ("float32", 4, ["view"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        WorkflowContext(app_name="ecapp")
    stored = {"user_factors": np.zeros((1, 2), np.float32),
              "item_factors": np.zeros((1, 2), np.float32),
              "users": {"u": 0}, "items": {"i": 0}, "item_categories": {},
              "app_name": "a", "seen_event_names": ["view"]}
    with pytest.raises(RuntimeError, match="is_available"):
        port_ec.model_from_persisted(stored)
