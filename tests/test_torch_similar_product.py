"""The port's Similar-Product template (``models/similar_product.py``,
``models/_filters.py``, ``data/events.aggregate_properties``,
``ops/topk.normalize_rows`` / ``similar_items``) on the CPU against the JAX
reference template on the same events: the property replay, the training
data, implicit-ALS factors within 2e-4, index-identical filtered answers,
and persisted dicts that load across both ways.
"""

import datetime as dt

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from incubator_predictionio_tpu.controller import EngineParams as RefEngineParams  # noqa: E402
from incubator_predictionio_tpu.data.storage import App, DataMap, Event  # noqa: E402
from incubator_predictionio_tpu.data.storage.base import aggregate_property_events  # noqa: E402
from incubator_predictionio_tpu.models import _filters as ref_filters  # noqa: E402
from incubator_predictionio_tpu.models import similar_product as ref_sp  # noqa: E402
from incubator_predictionio_tpu.ops import topk as ref_topk  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_torch import convert  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data.bimap import BiMap  # noqa: E402
from incubator_predictionio_torch.data.events import aggregate_properties  # noqa: E402
from incubator_predictionio_torch.models import _filters as port_filters  # noqa: E402
from incubator_predictionio_torch.models import similar_product as port_sp  # noqa: E402
from incubator_predictionio_torch.ops import topk as port_topk  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402

TOL = 2e-4
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
CATS = ["c0", "c1", "c2", "c3"]
ENGINE_JSON = {
    "engineFactory":
        "incubator_predictionio_torch.models.similar_product.SimilarProductEngine",
    "datasource": {"params": {"appName": "spapp", "eventNames": ["view"]}},
    "algorithms": [{"name": "als", "params": {
        "rank": 8, "numIterations": 5, "lambda": 0.05, "alpha": 1.0}}],
}


def _t(seconds):
    return T0 + dt.timedelta(seconds=int(seconds))


def _property_events(n_items=30, seed=1):
    """$set / $unset / $delete on items (and one user), out of time order:
    merges, an unset of a key, a delete then a re-set, an unset of an
    entity never set."""
    rng = np.random.default_rng(seed)
    evs = []
    for j in range(n_items):
        if j % 7 == 6:
            continue  # no categories at all
        cats = sorted({CATS[int(c)] for c in rng.integers(0, 4, 2)})
        evs.append(Event("$set", "item", f"i{j}", None, None,
                         DataMap({"categories": cats, "price": float(j)}),
                         _t(rng.integers(0, 500))))
    evs += [
        Event("$set", "item", "i1", None, None,
              DataMap({"categories": ["c3"]}), _t(900)),
        Event("$unset", "item", "i2", None, None, DataMap({"price": None}),
              _t(901)),
        Event("$delete", "item", "i4", None, None, DataMap({}), _t(902)),
        Event("$set", "item", "i5", None, None, DataMap({"colour": "red"}),
              _t(903)),
        Event("$delete", "item", "i8", None, None, DataMap({}), _t(904)),
        Event("$set", "item", "i8", None, None,
              DataMap({"categories": ["c0"]}), _t(905)),
        Event("$unset", "item", "ghost", None, None, DataMap({"x": None}),
              _t(906)),
        Event("$set", "user", "u1", None, None, DataMap({"categories": ["c1"]}),
              _t(907)),
    ]
    return evs


def _view_events(n_users=40, n_items=30, n=700, seed=0):
    rng = np.random.default_rng(seed)
    return [Event("view", "user", f"u{int(rng.integers(n_users))}", "item",
                  f"i{int(n_items * rng.random() ** 1.5)}", DataMap({}),
                  _t(rng.integers(0, 1000)))
            for _ in range(n)]


@pytest.fixture()
def seeded(memory_storage):
    events = _view_events() + _property_events()
    app_id = memory_storage.get_meta_data_apps().insert(App(0, "spapp"))
    le = memory_storage.get_l_events()
    le.init(app_id)
    le.insert_batch(events, app_id)
    return memory_storage, [e.to_json() for e in events], events


def test_aggregate_properties_matches_reference(seeded):
    _, wire, events = seeded
    for etype in ("item", "user"):
        ref = aggregate_property_events(
            [e for e in events if e.entity_type == etype])
        port = aggregate_properties(wire, etype)
        assert list(port) == list(ref)
        assert {k: v for k, v in port.items()} == {
            k: v.to_dict() for k, v in ref.items()}
    ref = aggregate_property_events(
        [e for e in events if e.entity_type == "item"],
        required=["categories", "price"])
    assert list(aggregate_properties(wire, "item",
                                     required=["categories", "price"])) == \
        list(ref)


def _ref_trained(storage):
    engine = ref_sp.SimilarProductEngine()()
    params = RefEngineParams.from_json(ENGINE_JSON)
    ctx = RefContext(app_name="spapp", storage=storage)
    ds, prep, algo_list, _ = engine.make_components(params)
    td = ds.read_training(ctx)
    algo = algo_list[0][1]
    return td, algo, algo.train(ctx, prep.prepare(ctx, td))


def _port_trained(wire):
    engine = port_sp.SimilarProductEngine()()
    params = EngineParams.from_json(ENGINE_JSON)
    ctx = WorkflowContext(events=wire, device="cpu")
    ds, _, algo_list, _ = engine.make_components(params)
    td = ds.read_training(ctx)
    model = engine.train(ctx, params)[0]
    algo = algo_list[0][1]
    deployment = engine.prepare_deployment(
        ctx, params, [algo.prepare_model_for_persistence(model)])
    return td, algo, model, deployment


def _ids(result):
    return [e["item"] for e in result["itemScores"]]


QUERIES = [
    {"items": ["i0"], "num": 5},
    {"items": ["i1", "i3"], "num": 10},
    {"items": ["i2"], "num": 4, "categories": ["c1"]},
    {"items": ["i2", "i9"], "num": 8, "categories": ["c0", "c3"]},
    {"items": ["i5"], "num": 6, "whiteList": ["i0", "i5", "i7", "i11", "zz"]},
    {"items": ["i6"], "num": 6, "blackList": ["i0", "i1", "i2", "zz"]},
    {"items": ["i3"], "num": 30, "categories": ["c2"],
     "blackList": ["i10"], "whiteList": ["i10", "i12", "i13", "i20"]},
    {"items": ["i7", "nope"], "num": 3},
    {"items": ["nope"], "num": 3},
    {"items": [], "num": 3},
    {"items": ["i0"], "num": 40},
    {"items": ["i4"], "num": 5, "categories": ["nothing"]},
]


def test_training_data_matches_reference(seeded):
    storage, wire, _ = seeded
    ref_td, _, _ = _ref_trained(storage)
    td, _, _, _ = _port_trained(wire)
    np.testing.assert_array_equal(td.user_idx, ref_td.user_idx)
    np.testing.assert_array_equal(td.item_idx, ref_td.item_idx)
    np.testing.assert_array_equal(td.rating, ref_td.rating)
    assert list(td.users.to_dict().items()) == list(
        ref_td.users.to_dict().items())
    assert list(td.items.to_dict().items()) == list(
        ref_td.items.to_dict().items())
    assert td.item_categories == ref_td.item_categories


def test_train_and_serve_match_reference(seeded):
    storage, wire, _ = seeded
    _, ref_algo, ref_model = _ref_trained(storage)
    _, algo, model, deployment = _port_trained(wire)
    np.testing.assert_allclose(model.factors.user_factors,
                               ref_model.factors.user_factors,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(model.factors.item_factors,
                               ref_model.factors.item_factors,
                               rtol=TOL, atol=TOL)
    answered = 0
    for q in QUERIES:
        ours = deployment.query(q)
        theirs = ref_algo.predict(ref_model, q)
        assert _ids(ours) == _ids(theirs), q
        answered += len(ours["itemScores"])
        assert not set(_ids(ours)) & set(q["items"])  # never a query item
        for e in ours["itemScores"]:
            cats = model.item_categories.get(e["item"], set())
            if q.get("categories"):
                assert cats & set(q["categories"])
            assert e["item"] not in q.get("blackList", [])
            if q.get("whiteList"):
                assert e["item"] in q["whiteList"]
    assert answered > 60


def test_model_served_from_a_reference_model_is_identical(seeded):
    """Reference-persisted dicts load into the port with no numeric change
    (same answers, same scores), and the port's dict loads into the
    reference."""
    storage, _, _ = seeded
    _, ref_algo, ref_model = _ref_trained(storage)
    stored = ref_algo.prepare_model_for_persistence(ref_model)
    model = convert.from_jax_persisted(stored, device="cpu")
    assert isinstance(model, port_sp.SimilarProductModel)
    np.testing.assert_array_equal(model.factors.item_factors,
                                  np.asarray(ref_model.factors.item_factors))
    algo = port_sp.SimilarProductAlgorithm(port_sp.SimilarProductAlgoParams())
    for q in QUERIES:
        ours, theirs = algo.predict(model, q), ref_algo.predict(ref_model, q)
        assert _ids(ours) == _ids(theirs)
        np.testing.assert_allclose([e["score"] for e in ours["itemScores"]],
                                   [e["score"] for e in theirs["itemScores"]],
                                   rtol=1e-6, atol=1e-6)
    back_dict = convert.to_jax_persisted(model)
    assert set(back_dict) == set(stored)
    assert back_dict["item_categories"] == stored["item_categories"]
    back = ref_algo.restore_model(back_dict, None)
    np.testing.assert_array_equal(back.factors.user_factors,
                                  np.asarray(ref_model.factors.user_factors))
    assert back.items.to_dict() == ref_model.items.to_dict()
    assert back.item_categories == ref_model.item_categories
    with pytest.raises(ValueError, match="missing"):
        convert.from_jax_persisted({"item_categories": {}}, device="cpu")


def test_exclude_mask_matches_reference():
    items = [f"i{j}" for j in range(12)]
    cats = {"i0": {"a"}, "i3": {"a", "b"}, "i5": {"b"}, "i9": {"c"},
            "gone": {"a"}}
    ref_items = ref_filters.BiMap.string_int(items)
    port_items = BiMap.string_int(items)
    ref_ci = ref_filters.CategoryIndex(ref_items, cats)
    port_ci = port_filters.CategoryIndex(port_items, cats)
    for kw in ({}, {"categories": ["a"]}, {"categories": ["b", "c"]},
               {"white_list": ["i1", "i3", "zz"]}, {"white_list": ["zz"]},
               {"black_list": ["i0", "zz"], "extra_excluded_items": ["i2"]},
               {"categories": ["a"], "white_list": ["i0", "i5"],
                "black_list": ["i0"]}):
        np.testing.assert_array_equal(
            port_filters.build_exclude_mask(port_items, port_ci, **kw),
            ref_filters.build_exclude_mask(ref_items, ref_ci, **kw))


def test_similar_items_matches_reference():
    rng = np.random.default_rng(6)
    cat = rng.standard_normal((50, 8)).astype(np.float32)
    cat[7] = 0.0  # a zero row normalizes to zero (the 1e-9 guard)
    normed = port_topk.normalize_rows(cat)
    np.testing.assert_array_equal(normed, ref_topk.normalize_rows(cat))
    q = cat[[3, 11, 20]]
    exclude = np.zeros(50, bool)
    exclude[[3, 11, 20, 0]] = True
    s, i = port_topk.similar_items(q, torch.from_numpy(normed), 9,
                                   exclude=exclude)
    s_ref, i_ref = ref_topk.similar_items(q, jax.device_put(normed), 9,
                                          exclude=exclude)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-6, atol=1e-6)


def test_sharded_serving_always_is_refused():
    with pytest.raises(ValueError, match="flat catalog"):
        port_sp.SimilarProductAlgorithm(
            port_sp.SimilarProductAlgoParams(sharded_serving="always"))


def test_no_view_events_is_a_clear_error():
    engine = port_sp.SimilarProductEngine()()
    with pytest.raises(ValueError, match="no view events"):
        engine.train(WorkflowContext(events=[], device="cpu"),
                     EngineParams.from_json(ENGINE_JSON))
