"""The port's engine server on the CPU: the contracts of
``tests/test_engine_server.py`` (routes, 400 and 500, plugins,
micro-batched answers equal to per-query answers, product ranking through
the batch and ``batch_predict``, health and readiness with a degraded
reload, dropped feedback counted, the latency probe persisted, a forged
probe marker still counted), and parity with the reference server: the
reference's aiohttp ``EngineServer`` and the port's serve one ALS model
(the port's copy through ``convert.py``) and must give the same status
codes, index-identical ``itemScores`` with scores within 2e-4, and the
same key sets in ``/status``, ``/readyz`` and ``/status.overload``.
"""

import concurrent.futures
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import requests  # noqa: E402

import torch_serving as ts  # noqa: E402
from incubator_predictionio_tpu.workflow.create_server import (  # noqa: E402
    EngineServer as RefEngineServer,
)
from incubator_predictionio_torch import convert  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.controller.engine import Deployment  # noqa: E402
from incubator_predictionio_torch.models.recommendation import (  # noqa: E402
    RecommendationEngine,
)
from incubator_predictionio_torch.workflow.create_server import EngineServer  # noqa: E402
from incubator_predictionio_torch.workflow.plugins import (  # noqa: E402
    EngineServerPlugin, EngineServerPluginContext,
)

TOL = 2e-4
#: sections of the reference's /status this slice leaves out (each off by
#: default there too)
LEFT_OUT = {"foldin", "quality", "tenants", "fleet"}


@pytest.fixture()
def store():
    storage = ts.memory_storage()
    ts.seed_ratings(storage)
    ts.train(storage)
    return storage


def _server(storage, **kw):
    return EngineServer(RecommendationEngine()(), engine_factory_name="rec",
                        storage=storage, device="cpu", **kw)


def _items(doc):
    return [s["item"] for s in doc["itemScores"]]


def test_engine_server_query_and_reload(store):
    with ts.serving(_server(store)) as base:
        code, doc, _ = ts.call(base, "GET", "/")
        assert code == 200 and doc["status"] == "alive"
        first = doc["engineInstanceId"]
        code, doc, _ = ts.query(base, {"user": "1", "num": 4})
        assert code == 200, doc
        scores = [s["score"] for s in doc["itemScores"]]
        assert len(scores) == 4 and scores == sorted(scores, reverse=True)
        # malformed body / missing field / unknown route / wrong method
        assert ts.call(base, "POST", "/queries.json", raw=b"}{")[0] == 400
        code, doc, _ = ts.query(base, {"num": 4})
        assert code == 400 and "user" in doc["message"]
        assert ts.call(base, "GET", "/nope")[0] == 404
        assert ts.call(base, "POST", "/status")[0] == 405
        # a failure inside the engine is a 500 with its message
        code, doc, _ = ts.query(base, {"user": "1", "num": "x"})
        assert code == 500 and doc["message"]
        # a second train; /reload hot-swaps to it and serving goes on
        iid2 = ts.train(store)
        code, doc, _ = ts.call(base, "GET", "/reload")
        assert code == 200 and doc["engineInstanceId"] == iid2 != first
        assert ts.status(base)["engineInstanceId"] == iid2
        code, doc, _ = ts.query(base, {"user": "2", "num": 2})
        assert code == 200 and len(doc["itemScores"]) == 2


def test_engine_server_plugins(store):
    class Capper(EngineServerPlugin):
        name = "capper"

        def process(self, query, result):
            result["itemScores"] = result["itemScores"][:1]
            return result

    server = _server(store, plugins=EngineServerPluginContext([Capper()]))
    with ts.serving(server) as base:
        assert ts.call(base, "GET", "/plugins.json")[1] == {
            "plugins": ["capper"]}
        assert len(ts.query(base, {"user": "1", "num": 5})[1][
            "itemScores"]) == 1


def test_micro_batched_answers_equal_per_query_answers(store):
    """One burst inside a 50 ms window goes through
    ``Deployment.batch_query`` (one batch_top_k over the padded batch, k =
    the largest num); each answer equals the per-query answer index for
    index (the stable sort keeps each prefix), scores within float32
    rounding of the GEMM against the mul+reduce."""
    queries = ([{"user": str(u), "num": 1 + u % 5} for u in range(12)]
               + [{"num": 3}, {"user": "ghost", "num": 2}])
    plain, batched = _server(store), _server(store, batch_window_ms=50.0,
                                             max_batch=8)
    calls = []
    real = batched.deployment.batch_query

    def spying(qs):
        calls.append(len(qs))
        return real(qs)

    batched.deployment.batch_query = spying
    with ts.serving(plain) as bp:
        want = [ts.query(bp, q) for q in queries]
    with ts.serving(batched) as bb:
        with concurrent.futures.ThreadPoolExecutor(len(queries)) as pool:
            got = list(pool.map(lambda q: ts.query(bb, q), queries))
    assert calls and max(calls) > 1, calls  # answers came from batches
    for q, w, g in zip(queries, want, got):
        assert g[0] == w[0], (q, g)
        if w[0] == 200:
            assert _items(g[1]) == _items(w[1]), q
            assert [s["score"] for s in g[1]["itemScores"]] == pytest.approx(
                [s["score"] for s in w[1]["itemScores"]], rel=1e-5), q
        else:
            assert g[1] == w[1]


def test_product_ranking_query_mode(store):
    with ts.serving(_server(store)) as base:
        order = _items(ts.query(base, {"user": "1", "num": 50})[1])
        assert len(order) >= 3
        candidates = [order[2], order[0], "no-such-item", order[1]]
        code, out, _ = ts.query(base, {"user": "1", "items": candidates})
        assert code == 200
        assert _items(out) == [order[0], order[1], order[2], "no-such-item"]
        assert out["isOriginal"] is False
        code, out, _ = ts.query(base, {"user": "ghost", "items": candidates})
        assert _items(out) == candidates and out["isOriginal"] is True


def test_product_ranking_through_micro_batch_and_batch_predict(store):
    """Ranking-mode queries give identical results through the per-query
    path, the micro-batching server and ``batch_predict``."""
    server = _server(store, batch_window_ms=10.0, max_batch=8)
    queries = [{"user": "1", "items": ["i5", "i9", "ghost", "i2"]},
               {"user": "2", "num": 3},
               {"user": "zzz", "items": ["i5", "i9"]},
               {"user": "3", "items": []}]
    dep = server.deployment
    want = [dep.query(q) for q in queries]
    (_, algo), model = dep.algo_list[0], dep.models[0]
    bulk = algo.batch_predict(model, queries)
    assert [bulk[j] for j in (0, 2, 3)] == [want[j] for j in (0, 2, 3)]
    assert _items(bulk[1]) == _items(want[1])
    with ts.serving(server) as base:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda q: ts.query(base, q)[1], queries))
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
    assert _items(got[1]) == _items(want[1])
    for a, b in zip(got[1]["itemScores"], want[1]["itemScores"]):
        assert abs(a["score"] - b["score"]) < 1e-4
    assert want[3] == {"itemScores": [], "isOriginal": False}
    assert want[2]["isOriginal"] is True


def test_healthz_readyz_and_degraded_reload(store):
    with ts.serving(_server(store)) as base:
        assert ts.call(base, "GET", "/healthz")[1] == {"status": "alive"}
        code, ready, _ = ts.call(base, "GET", "/readyz")
        assert code == 200 and ready["ready"] and ready["modelLoaded"]
        assert ready["openBreakers"] == []
        doc = ts.status(base)
        assert doc["degraded"] is False and doc["droppedFeedback"] == 0
        # the next reload fails: no COMPLETED instance left to load
        insts = store.get_meta_data_engine_instances()
        for inst in insts.get_all():
            insts.delete(inst.id)
        code, doc, _ = ts.call(base, "GET", "/reload")
        assert code == 500 and doc["degraded"] is True
        doc = ts.status(base)
        assert doc["degraded"] and "reload failed" in doc["degradedReason"]
        code, doc, _ = ts.query(base, {"user": "1", "num": 3})
        assert code == 200 and doc["itemScores"]
        # degraded is telemetry, not a rotation signal
        assert ts.call(base, "GET", "/readyz")[0] == 200


def test_feedback_write_failure_counts_dropped(store):
    server = _server(store, feedback=True, feedback_app_name="testapp")

    class _DeadLEvents:
        def insert(self, *a, **k):
            raise RuntimeError("event store down")

    store.get_l_events = lambda: _DeadLEvents()  # instance shadow
    with ts.serving(server) as base:
        assert ts.query(base, {"user": "1", "num": 2})[0] == 200
        dropped = ts.wait_for(lambda: ts.status(base)["droppedFeedback"])
    assert dropped >= 1


def test_feedback_self_logs_predict_events(store):
    server = _server(store, feedback=True, feedback_app_name="testapp")
    with ts.serving(server) as base:
        assert ts.query(base, {"user": "1", "num": 2})[0] == 200
        app_id = store.get_meta_data_apps().get_by_name("testapp").id
        got = ts.wait_for(lambda: [
            e for e in store.get_l_events().find(app_id)
            if e.event == "predict"])
    assert got and got[0].entity_type == "pio_pr"
    assert got[0].entity_id == "1"


def test_probe_latency_measures_and_persists(store):
    server = _server(store)
    iid = server.instance.id
    with ts.serving(server) as base:
        result = server.probe_and_record(base, n=12)
        status = ts.status(base)
    assert status["probeLatency"]["http_p50_ms"] == result["http_p50_ms"]
    assert result["predict_p50_ms"] > 0
    assert result["http_p99_ms"] >= result["http_p50_ms"]
    assert result["overhead_p50_ms"] >= 0
    assert result["dispatch_rtt_p50_ms"] is not None
    assert result["attachment"] == "cpu"
    row = store.get_meta_data_engine_instances().get(iid)
    stored = json.loads(row.runtime_conf["probe_latency"])
    assert stored["http_p50_ms"] == result["http_p50_ms"] and stored["n"] == 12


def test_forged_probe_marker_still_counts(store):
    server = _server(store)
    with ts.serving(server) as base:
        assert ts.query(base, {"user": "1", "num": 2},
                        headers={"X-Pio-Probe": "1"})[0] == 200
        assert ts.status(base)["queryCount"] == 1
        assert ts.query(base, {"user": "1", "num": 2},
                        headers={"X-Pio-Probe": server._probe_token})[0] == 200
        assert ts.status(base)["queryCount"] == 1


def test_deployment_form_refuses_lifecycle_calls(store):
    """The file form (``deploy --model``) serves one fixed deployment: no
    model store, so /reload and /rollback answer 409 and refresh is off."""
    dep = _server(store).deployment
    server = EngineServer(deployment=dep, device="cpu", model_refresh_ms=50)
    with ts.serving(server) as base:
        assert ts.query(base, {"user": "1", "num": 2})[0] == 200
        for path in ("/reload", "/rollback"):
            code, doc, _ = ts.call(base, "POST", path)
            assert code == 409 and "model file" in doc["message"]
        lc = ts.status(base)["lifecycle"]
        assert lc["refreshMs"] == "disabled(file)" and lc["instance"] is None


# -- parity with the reference server ------------------------------------

PARITY_QUERIES = [
    {"user": "1", "num": 4}, {"user": "7", "num": 10}, {"user": "12"},
    {"user": 3, "num": 2}, {"user": "ghost", "num": 3},
    {"user": "2", "items": ["i5", "i9", "ghost", "i2"]},
    {"user": "zzz", "items": ["i5"]}, {"user": "3", "items": []},
    {"num": 4}, {"user": "1", "num": "x"}, [1, 2], None,
]
PARITY_RAW = [b"}{", b"", b"{\"user\": "]


@pytest.fixture()
def ref_served(memory_storage):
    """The reference server over a reference-trained model, and the port's
    Deployment of the same model through ``convert.py``."""
    from incubator_predictionio_tpu.models.recommendation import (
        RecommendationEngine as RefEngine,
    )
    from incubator_predictionio_tpu.workflow.context import WorkflowContext
    from incubator_predictionio_tpu.workflow.core_workflow import run_train
    from server_utils import ServerThread
    from test_dase_train_e2e import ENGINE_PARAMS, _seed_ratings

    _seed_ratings(memory_storage)
    engine = RefEngine()()
    run_train(engine, ENGINE_PARAMS,
              WorkflowContext(app_name="testapp", storage=memory_storage),
              engine_factory_name="rec")
    ref = RefEngineServer(engine, engine_factory_name="rec",
                          storage=memory_storage)
    (_, ref_algo), ref_model = (ref.deployment.algo_list[0],
                                ref.deployment.models[0])
    model = convert.from_jax_persisted(
        ref_algo.prepare_model_for_persistence(ref_model), device="cpu")
    _, _, algo_list, serving = RecommendationEngine()().make_components(
        EngineParams.from_json(ts.ENGINE_JSON))
    with ServerThread(ref.app) as st:
        yield st.base, Deployment(algo_list, [model], serving)


def _ref_call(base, q=None, raw=None):
    r = requests.post(base + "/queries.json",
                      data=raw if raw is not None else json.dumps(q),
                      headers={"Content-Type": "application/json"},
                      timeout=30)
    return r.status_code, r.json()


@pytest.mark.parametrize("window_ms", [0.0, 10.0], ids=["plain", "batched"])
def test_parity_with_reference_server(ref_served, window_ms):
    ref_base, deployment = ref_served
    server = EngineServer(deployment=deployment, device="cpu",
                          batch_window_ms=window_ms, max_batch=16)
    with ts.serving(server) as base:
        cases = ([(q, None) for q in PARITY_QUERIES]
                 + [(None, raw) for raw in PARITY_RAW])
        with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
            got = list(pool.map(lambda c: ts.call(
                base, "POST", "/queries.json", raw=c[1] if c[1] is not None
                else json.dumps(c[0]).encode())[:2], cases))
        port_status = ts.status(base)
        port_ready = ts.call(base, "GET", "/readyz")
    want = [_ref_call(ref_base, q, raw) for q, raw in cases]
    for case, (wc, wj), (gc, gj) in zip(cases, want, got):
        assert gc == wc, (case, gj, wj)
        if wc == 200:
            assert _items(gj) == _items(wj), case
            assert [s["score"] for s in gj["itemScores"]] == pytest.approx(
                [s["score"] for s in wj["itemScores"]], abs=TOL), case
            assert ({k: v for k, v in gj.items() if k != "itemScores"}
                    == {k: v for k, v in wj.items() if k != "itemScores"})
        elif wc == 400:
            assert gj == wj, case
    ref_status = requests.get(ref_base + "/status", timeout=30).json()
    ref_ready = requests.get(ref_base + "/readyz", timeout=30)
    assert set(port_status) == set(ref_status) - LEFT_OUT
    assert set(port_status["overload"]) == set(ref_status["overload"])
    assert set(port_status["lifecycle"]) == set(ref_status["lifecycle"])
    assert port_ready[0] == ref_ready.status_code == 200
    assert set(port_ready[1]) == set(ref_ready.json())
    assert port_status["queryCount"] == ref_status["queryCount"]


def test_batchpredict_equals_reference_batchpredict(memory_storage, tmp_path):
    """``pio batchpredict`` of the port and of the reference over the same
    persisted model (the reference's, converted): the same queries back,
    index-identical ``itemScores``, scores within 2e-4 — and each port
    answer equal to the port server's per-query answer."""
    from incubator_predictionio_tpu.models.recommendation import (
        RecommendationEngine as RefEngine,
    )
    from incubator_predictionio_tpu.tools.console import main as ref_pio
    from incubator_predictionio_tpu.workflow.context import (
        WorkflowContext as RefContext,
    )
    from incubator_predictionio_tpu.workflow.core_workflow import (
        load_deployment as ref_load, run_train as ref_train,
    )
    from incubator_predictionio_torch.data.storage import Storage
    from incubator_predictionio_torch.tools.console import main as pio
    from incubator_predictionio_torch.workflow import model_artifact
    from incubator_predictionio_torch.workflow.core_workflow import (
        engine_json_of, serialize_models,
    )
    from incubator_predictionio_torch.workflow.context import WorkflowContext
    from incubator_predictionio_torch.workflow.core_workflow import run_train
    from test_dase_train_e2e import ENGINE_PARAMS, _seed_ratings

    queries = ([{"user": str(u), "num": 1 + u % 6} for u in range(30)]
               + [{"user": "ghost", "num": 3},
                  {"user": "4", "items": ["i3", "ghost", "i7"]}])
    qpath = tmp_path / "queries.jsonl"
    qpath.write_text("".join(json.dumps(q) + "\n" for q in queries))
    outs = {}
    for pkg in ("tpu", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        factory = (f"incubator_predictionio_{pkg}.models.recommendation."
                   "RecommendationEngine")
        (d / "engine.json").write_text(json.dumps(
            {**ts.ENGINE_JSON, "engineFactory": factory}))
        outs[pkg] = (d, factory, d / "out.jsonl")

    _seed_ratings(memory_storage)
    ref_engine = RefEngine()()
    ref_train(ref_engine, ENGINE_PARAMS,
              RefContext(app_name="testapp", storage=memory_storage),
              engine_factory_name=outs["tpu"][1])
    d, factory, out = outs["tpu"]
    assert ref_pio(["batchpredict", "--engine-dir", str(d), "--input",
                    str(qpath), "--output", str(out)]) == 0
    ref_dep, _, _ = ref_load(ref_engine, None,
                             RefContext(storage=memory_storage),
                             engine_factory_name=factory)
    stored = ref_dep.algo_list[0][1].prepare_model_for_persistence(
        ref_dep.models[0])

    d, factory, out = outs["torch"]
    storage = Storage.reset_instance(dict(ts.MEM_ENV))
    try:
        ts.seed_ratings(storage)
        engine = RecommendationEngine()()
        iid = run_train(engine, ts.ENGINE_PARAMS,
                        WorkflowContext(app_name="testapp", storage=storage,
                                        device="cpu"),
                        engine_factory_name=factory)
        _, _, algo_list, _ = engine.make_components(ts.ENGINE_PARAMS)
        model_artifact.write_model(storage, iid, serialize_models(
            algo_list, [convert.from_jax_persisted(stored, device="cpu")],
            engine_json_of(ts.ENGINE_PARAMS, factory, "default")))
        assert pio(["batchpredict", "--engine-dir", str(d), "--device", "cpu",
                    "--input", str(qpath), "--output", str(out)]) == 0
        server = EngineServer(engine, engine_factory_name=factory,
                              storage=storage, device="cpu")
        with ts.serving(server) as base:
            served = [ts.query(base, q)[1] for q in queries]
    finally:
        Storage.reset_instance(dict(ts.MEM_ENV))
    want = [json.loads(ln) for ln in outs["tpu"][2].read_text().splitlines()]
    got = [json.loads(ln) for ln in outs["torch"][2].read_text().splitlines()]
    assert [g["query"] for g in got] == [w["query"] for w in want] == queries
    for g, w, s in zip(got, want, served):
        gp, wp = g["prediction"], w["prediction"]
        assert _items(gp) == _items(wp) == _items(s), g["query"]
        assert [x["score"] for x in gp["itemScores"]] == pytest.approx(
            [x["score"] for x in wp["itemScores"]], abs=TOL)
        assert gp.get("isOriginal") == wp.get("isOriginal")
