"""The port's Recommendation template end to end on the CPU, against the
JAX reference template on the same events: the event read (triple and id
map order), training (factors within 2e-4), serving (identical top-k
indices), persistence, the HTTP server, the console, and models carried
across from the reference (``convert``).
"""

import datetime as dt
import http.client
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from incubator_predictionio_tpu.controller import EngineParams as RefEngineParams  # noqa: E402
from incubator_predictionio_tpu.data.storage import App, DataMap, Event  # noqa: E402
from incubator_predictionio_tpu.data.store.p_event_store import PEventStore  # noqa: E402
from incubator_predictionio_tpu.models import recommendation as ref_rec  # noqa: E402
from incubator_predictionio_tpu.ops import topk as ref_topk  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_torch import convert  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data import bimap as port_bimap  # noqa: E402
from incubator_predictionio_torch.data.events import find_ratings  # noqa: E402
from incubator_predictionio_torch.models import recommendation as port_rec  # noqa: E402
from incubator_predictionio_torch.ops import topk as port_topk  # noqa: E402
from incubator_predictionio_torch.tools import console  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.create_server import EngineServer  # noqa: E402
from incubator_predictionio_torch.workflow.persist import load_models, save_models  # noqa: E402

TOL = 2e-4
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)


def _events(n_users=30, n_items=20, seed=0):
    """Rate events with structure, plus the edge cases of the read: buy
    events without a rating, a rate without a target, an unusable rating,
    a string rating, an event name outside the selection, equal times, and
    times that are not in insertion order."""
    rng = np.random.default_rng(seed)
    xu = rng.standard_normal((n_users, 3))
    xi = rng.standard_normal((n_items, 3))
    evs = []
    for u in range(n_users):
        for i in range(n_items):
            if rng.random() < 0.45:
                r = float(np.clip(xu[u] @ xi[i] + 3.0, 1, 5))
                t = T0 + dt.timedelta(seconds=int(rng.integers(0, 400)))
                evs.append(Event("rate", "user", f"u{u}", "item", f"i{i}",
                                 DataMap({"rating": r}), t))
    evs += [
        Event("buy", "user", "u3", "item", "i7", DataMap({}),
              T0 + dt.timedelta(seconds=5)),
        Event("buy", "user", "u99", "item", "i98", DataMap({}),
              T0 + dt.timedelta(seconds=5)),
        Event("rate", "user", "lonely", None, None, DataMap({"rating": 2.0}),
              T0 + dt.timedelta(seconds=1)),
        Event("rate", "user", "u4", "item", "i2", DataMap({"rating": "abc"}),
              T0 + dt.timedelta(seconds=9)),
        Event("rate", "user", "u5", "item", "i3", DataMap({"rating": "3.5"}),
              T0 + dt.timedelta(seconds=9)),
        Event("view", "user", "viewer", "item", "iview", DataMap({}),
              T0 + dt.timedelta(seconds=2)),
    ]
    return evs


def _stored(storage, events, app_name="testapp"):
    app_id = storage.get_meta_data_apps().insert(App(0, app_name))
    le = storage.get_l_events()
    le.init(app_id)
    le.insert_batch(events, app_id)
    return [e.to_json() for e in events]


@pytest.fixture()
def seeded(memory_storage):
    events = _events()
    wire = _stored(memory_storage, events)
    return memory_storage, wire


ENGINE_JSON = {
    "engineFactory":
        "incubator_predictionio_torch.models.recommendation.RecommendationEngine",
    "datasource": {"params": {"appName": "testapp"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 8, "numIterations": 6, "lambda": 0.05}}],
}


def test_find_ratings_matches_reference(seeded):
    storage, wire = seeded
    kw = dict(event_names=["rate", "buy"], event_default_ratings={"buy": 4.0})
    u, i, r, users, items = PEventStore.find_ratings(
        "testapp", storage=storage, **kw)
    pu, pi, pr, pusers, pitems = find_ratings(wire, **kw)
    np.testing.assert_array_equal(pu, u)
    np.testing.assert_array_equal(pi, i)
    np.testing.assert_array_equal(pr, r)
    assert list(pusers.to_dict().items()) == list(users.to_dict().items())
    assert list(pitems.to_dict().items()) == list(items.to_dict().items())
    assert "lonely" in pusers and "viewer" not in pusers


def test_find_ratings_without_rating_property(seeded):
    storage, wire = seeded
    kw = dict(event_names=None, rating_from_props=False, default_rating=2.5)
    ref = PEventStore.find_ratings("testapp", storage=storage, **kw)
    port = find_ratings(wire, **kw)
    for a, b in zip(port[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert port[3].to_dict() == ref[3].to_dict()


def _ref_trained(storage):
    engine = ref_rec.RecommendationEngine()()
    params = RefEngineParams.from_json(ENGINE_JSON)
    ctx = RefContext(app_name="testapp", storage=storage)
    ds, prep, algo_list, _ = engine.make_components(params)
    td = ds.read_training(ctx)
    algo = algo_list[0][1]
    return algo, algo.train(ctx, prep.prepare(ctx, td))


def _port_trained(wire):
    engine = port_rec.RecommendationEngine()()
    params = EngineParams.from_json(ENGINE_JSON)
    ctx = WorkflowContext(events=wire, device="cpu")
    models = engine.train(ctx, params)
    deployment = engine.prepare_deployment(
        ctx, params,
        [engine.make_components(params)[2][0][1]
         .prepare_model_for_persistence(models[0])])
    return models[0], deployment


def _ids(result):
    return [e["item"] for e in result["itemScores"]]


def test_engine_train_and_serve_match_reference(seeded):
    storage, wire = seeded
    ref_algo, ref_model = _ref_trained(storage)
    model, deployment = _port_trained(wire)
    np.testing.assert_allclose(model.factors.user_factors,
                               ref_model.factors.user_factors,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(model.factors.item_factors,
                               ref_model.factors.item_factors,
                               rtol=TOL, atol=TOL)
    users = list(ref_model.users.keys()) + ["nobody"]
    queries = [{"user": u, "num": 7} for u in users]
    for q in queries:
        assert _ids(deployment.query(q)) == _ids(ref_algo.predict(ref_model, q))
    ranking = {"user": "u1", "items": ["i3", "zz", "i1", "i9"]}
    assert _ids(deployment.query(ranking)) == _ids(
        ref_algo.predict(ref_model, ranking))
    batch = deployment.batch_query(queries + [ranking])
    ref_batch = ref_algo.batch_predict(ref_model, queries + [ranking])
    assert [_ids(x) for x in batch] == [_ids(x) for x in ref_batch]


def test_jax_trained_model_serves_identically(seeded):
    """convert.from_jax_persisted: a reference-trained persisted dict gives
    the same answers from the port, and the port's dict loads back into
    the reference."""
    storage, _ = seeded
    ref_algo, ref_model = _ref_trained(storage)
    stored = ref_algo.prepare_model_for_persistence(ref_model)
    model = convert.from_jax_persisted(stored, device="cpu")
    algo = port_rec.ALSAlgorithm(port_rec.AlgorithmParams())
    for u in list(ref_model.users.keys()) + ["nobody"]:
        q = {"user": u, "num": 20}
        ours, theirs = algo.predict(model, q), ref_algo.predict(ref_model, q)
        assert _ids(ours) == _ids(theirs)
        np.testing.assert_allclose(
            [e["score"] for e in ours["itemScores"]],
            [e["score"] for e in theirs["itemScores"]], rtol=1e-6, atol=1e-6)
    back = ref_algo.restore_model(convert.to_jax_persisted(model), None)
    np.testing.assert_array_equal(back.factors.item_factors,
                                  ref_model.factors.item_factors)
    assert back.users.to_dict() == ref_model.users.to_dict()
    with pytest.raises(ValueError, match="missing"):
        convert.from_jax_persisted({"user_factors": 1}, device="cpu")


@pytest.mark.parametrize("with_exclude", [False, True])
def test_top_k_ties_and_exclusions_match_reference(with_exclude):
    """Duplicate catalog rows give exactly tied scores: the order must be
    score descending, then index ascending, as lax.top_k's."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal((12, 6)).astype(np.float32)
    cat = np.concatenate([base, base[::-1], base[:4]])  # 28 rows, many ties
    user = rng.standard_normal(6).astype(np.float32)
    exclude = None
    if with_exclude:
        exclude = np.zeros(len(cat), bool)
        exclude[[0, 5, 13, 27]] = True
    ref_s, ref_i = ref_topk.top_k_items(user, jax.device_put(cat), 15,
                                        exclude=exclude)
    s, i = port_topk.top_k_items(user, torch.from_numpy(cat), 15,
                                 exclude=exclude)
    np.testing.assert_array_equal(i, np.asarray(ref_i))
    np.testing.assert_allclose(s, np.asarray(ref_s), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,k", [(1, 5), (3, 10), (9, 28), (300, 7)])
def test_batch_top_k_matches_reference(b, k):
    rng = np.random.default_rng(b + k)
    base = rng.standard_normal((14, 8)).astype(np.float32)
    cat = np.concatenate([base, base])
    users = rng.standard_normal((b, 8)).astype(np.float32)
    ref_s, ref_i = ref_topk.batch_top_k(users, jax.device_put(cat), k)
    s, i = port_topk.batch_top_k(users, torch.from_numpy(cat), k)
    np.testing.assert_array_equal(i, np.asarray(ref_i))
    np.testing.assert_allclose(s, np.asarray(ref_s), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,n", [(1, 100), (8, 5), (9, 1000), (300, 1000)])
def test_bucket_k_matches_reference(k, n):
    assert port_topk.bucket_k(k, n) == ref_topk.bucket_k(k, n)


def test_bimap_persisted_forms_cross_load():
    from incubator_predictionio_tpu.data.storage.bimap import (
        BiMap as RefBiMap, IdentityBiMap as RefIdentity, extend_bimap,
    )

    ref = RefBiMap.string_int(["b", "a", "c", "a"])
    port = port_bimap.BiMap.from_persisted(ref.to_persisted())
    assert list(port.to_dict().items()) == list(ref.to_dict().items())
    ident = port_bimap.BiMap.from_persisted(RefIdentity(5).to_persisted())
    assert isinstance(ident, port_bimap.IdentityBiMap) and len(ident) == 5
    for key in ("3", "03", 3, "5", "-1"):
        assert ident.get(key) == RefIdentity(5).get(key)
    ext, new = port_bimap.extend_bimap(port, ["d", "a", "e", "d"])
    ref_ext, ref_new = extend_bimap(ref, ["d", "a", "e", "d"])
    assert new == ref_new and ext.to_dict() == ref_ext.to_dict()
    assert port_bimap.extend_bimap(ident, ["5", "6"])[0].to_persisted() == \
        extend_bimap(RefIdentity(5), ["5", "6"])[0].to_persisted()


def test_persist_round_trip(tmp_path, seeded):
    _, wire = seeded
    model, _ = _port_trained(wire)
    algo = port_rec.ALSAlgorithm(port_rec.AlgorithmParams())
    stored = algo.prepare_model_for_persistence(model)
    assert set(stored) == {"user_factors", "item_factors", "users", "items"}
    path = tmp_path / "m.npz"
    save_models(path, ENGINE_JSON, [stored])
    engine_json, loaded = load_models(path)
    assert engine_json == ENGINE_JSON
    np.testing.assert_array_equal(loaded[0]["user_factors"],
                                  stored["user_factors"])
    assert loaded[0]["users"] == stored["users"]


def _post(port, obj, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", "/queries.json",
                     body=raw if raw is not None else json.dumps(obj))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_console_train_deploy_query(tmp_path, seeded):
    """The console's train and the engine server over HTTP, on the CPU."""
    _, wire = seeded
    events = tmp_path / "events.jsonl"
    events.write_text("\n".join(json.dumps(e) for e in wire) + "\n")
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(ENGINE_JSON))
    model_path = tmp_path / "model.npz"
    assert console.main(["train", "--engine-json", str(engine_json),
                         "--events", str(events), "--model-out",
                         str(model_path), "--device", "cpu"]) == 0
    deployment, _ = console.load_deployment(str(model_path), device="cpu")
    model, direct = _port_trained(wire)
    server = EngineServer(deployment=deployment, device="cpu")
    _, port = server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/")
        assert json.loads(conn.getresponse().read())["status"] == "alive"
        conn.close()
        q = {"user": "u2", "num": 4}
        status, res = _post(port, q)
        assert status == 200 and res == json.loads(json.dumps(direct.query(q)))
        assert _post(port, {"user": "nobody"}) == (200, {"itemScores": []})
        assert _post(port, {"num": 3})[0] == 400
        assert _post(port, None, raw="{nope")[0] == 400
    finally:
        server.stop()


def test_engine_factory_outside_the_port_is_refused():
    with pytest.raises(ValueError, match="not a factory of this package"):
        console.engine_from_json({"engineFactory": "incubator_predictionio_tpu."
                                  "models.recommendation.RecommendationEngine"})


def test_sharded_serving_always_is_refused():
    """``shardedServing: always`` is refused only where it would pick the
    mesh layout (more than one device); on one device it serves (F5), and
    a value outside auto|always|never is refused before the train."""
    from incubator_predictionio_torch.ops import sharded_topk

    port_rec.ALSAlgorithm(port_rec.AlgorithmParams(sharded_serving="always"))
    with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
        sharded_topk.serving_mesh_for("cpu", 100, 8, "always", n_devices=8)
    assert sharded_topk.serving_mesh_for("cpu", 100, 8, "always") is None
    algo = port_rec.ALSAlgorithm(
        port_rec.AlgorithmParams(sharded_serving="sometimes"))
    with pytest.raises(ValueError, match="auto.always.never"):
        algo.train(WorkflowContext(events=[], device="cpu"), None)


def test_no_events_is_a_clear_error():
    engine = port_rec.RecommendationEngine()()
    with pytest.raises(ValueError, match="no rating events"):
        engine.train(WorkflowContext(events=[], device="cpu"),
                     EngineParams.from_json(ENGINE_JSON))
