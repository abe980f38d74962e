"""The port's evaluation core on the CPU against the JAX package's:

- ``ops/eval.py``: ``ranking_metrics`` within 1e-6 of the reference on
  random batches (lists shorter than k, empty label sets, all-relevant and
  all-irrelevant lists, b = 1, 3, 300), ``n`` and ``n_auc`` exact;
  ``MetricWindow``, ``quality_verdict`` and ``bucket_k_eval`` exact.
- ``e2/cross_validation.k_fold_indices``: the same folds, exactly.
- ``controller``: the metrics, ``EngineParams.to_json`` and the
  ``MetricEvaluator``'s ``pretty()`` / ``to_json()`` / ``best_index``,
  byte for byte, on the same inputs; the reference's public names.
- ``read_eval`` of Recommendation: the same folds (training triples,
  queries and actuals) on the same store.
- ``run_evaluation`` of both packages' Recommendation and E-Commerce
  evaluations (two candidates each): the same candidate count and
  headers, scores within 0.02, the same best index where the reference's
  top two differ by more than 0.05; the instance row EVALCOMPLETED, and
  EVALABORTED when a candidate raises.
- The dashboard (mirrors tests/test_eval_and_ops_servers.py:41-70).
- The device rule: ``run_evaluation`` and ``pio eval`` raise without a
  card unless the CPU is asked for.
"""

import datetime as dt
import http.client
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import incubator_predictionio_tpu.controller as ref_controller  # noqa: E402
from incubator_predictionio_tpu.controller import EngineParams as RefEngineParams  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.e2.cross_validation import k_fold_indices as ref_folds  # noqa: E402
from incubator_predictionio_tpu.models import recommendation as ref_rec  # noqa: E402
from incubator_predictionio_tpu.models import recommendation_eval as ref_rec_eval  # noqa: E402
from incubator_predictionio_tpu.ops import eval as ref_eval  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_tpu.workflow.evaluation_workflow import (  # noqa: E402
    run_evaluation as ref_run_evaluation,
)
import incubator_predictionio_torch.controller as port_controller  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.controller import metric as port_metric  # noqa: E402
from incubator_predictionio_torch.controller.metric_evaluator import MetricEvaluator  # noqa: E402
from incubator_predictionio_torch.data import storage as port_storage  # noqa: E402
from incubator_predictionio_torch.e2 import k_fold_indices  # noqa: E402
from incubator_predictionio_torch.models import recommendation as port_rec  # noqa: E402
from incubator_predictionio_torch.models import recommendation_eval  # noqa: E402
from incubator_predictionio_torch.models import template_evals  # noqa: E402
from incubator_predictionio_torch.ops import eval as port_eval  # noqa: E402
from incubator_predictionio_torch.tools import commands  # noqa: E402
from incubator_predictionio_torch.tools.dashboard import Dashboard, params_diff  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.evaluation_workflow import (  # noqa: E402
    _eval_candidates, candidate_devices, run_evaluation,
)

T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
METRIC_TOL = 1e-6
SCORE_TOL = 0.02  # a handful of top-k flips from float32 noise
BEST_GAP = 0.05

# -- ops/eval ----------------------------------------------------------------


def _samples(b, k, seed):
    """Ranked lists (some shorter than k, some empty) and label sets (some
    empty, some all-relevant, some disjoint from the list)."""
    rng = np.random.default_rng(seed)
    ranked, labels = [], []
    for s in range(b):
        n = int(rng.integers(0, k + 3))
        items = [f"i{int(x)}" for x in rng.choice(50, n, replace=False)]
        kind = s % 5
        if kind == 0:
            labs = set()
        elif kind == 1:
            labs = set(items[:k]) or {"i0"}
        elif kind == 2:
            labs = {f"j{int(x)}" for x in rng.integers(0, 9, 3)}
        else:
            labs = {f"i{int(x)}" for x in rng.integers(0, 50,
                                                       int(rng.integers(1, 12)))}
        ranked.append(items)
        labels.append(labs)
    return ranked, labels


def _hold_metrics(got, want):
    assert got["n"] == want["n"] and got["n_auc"] == want["n_auc"]
    for m in ("map", "ndcg", "auc"):
        assert abs(got[m] - want[m]) <= METRIC_TOL, (m, got, want)


@pytest.mark.parametrize("b", [1, 3, 300])
@pytest.mark.parametrize("k", [1, 5, 10, 17])
def test_ranking_metrics_match_the_reference(b, k):
    for seed in range(3):
        ranked, labels = _samples(b, k, seed + 100 * b + k)
        _hold_metrics(port_eval.ranking_metrics(ranked, labels, k, device="cpu"),
                      ref_eval.ranking_metrics(ranked, labels, k))


@pytest.mark.parametrize("ranked,labels,k", [
    ([], [], 10),
    ([["a", "b"]], [set()], 10),
    ([["a", "b", "c"]], [{"a", "b", "c"}], 2),
    ([["a", "b", "c"]], [{"x"}], 3),
    ([["a"], ["b", "a"]], [{"a"}, {"a", "z"}], 1),
    ([[3, 1, 2]], [{1, 2}], 0),
], ids=["empty", "no-labels", "all-relevant", "all-irrelevant", "k1",
        "k0-int-items"])
def test_ranking_metrics_edge_cases_match_the_reference(ranked, labels, k):
    _hold_metrics(port_eval.ranking_metrics(ranked, labels, k, device="cpu"),
                  ref_eval.ranking_metrics(ranked, labels, k))


def test_ranking_metrics_counts_its_calls():
    stats = port_eval.ranking_metrics_calls
    stats.reset()
    port_eval.ranking_metrics([["a"]], [set()], 5, device="cpu")  # nothing graded
    port_eval.ranking_metrics([["a"], ["b"]], [{"a"}, {"a"}], 5, device="cpu")
    assert stats.calls == 1 and stats.seconds > 0


def test_metric_window_and_verdict_match_the_reference():
    batches = [_samples(7, 10, s) for s in range(4)]
    port_w, ref_w = port_eval.MetricWindow(), ref_eval.MetricWindow()
    for ranked, labels in batches:
        m = ref_eval.ranking_metrics(ranked, labels, 10)
        port_w.add(m)
        ref_w.add(m)
    assert port_w.means() == ref_w.means()
    canary = dict(ref_w.means(), ndcg=ref_w.means()["ndcg"] - 0.2)
    for min_samples in (1, 10**6):
        for drop in (0.05, 0.5):
            assert port_eval.quality_verdict(
                canary, ref_w.means(), min_samples=min_samples,
                max_drop=drop) == ref_eval.quality_verdict(
                canary, ref_w.means(), min_samples=min_samples, max_drop=drop)
    port_w.reset()
    assert port_w.means() == ref_eval.MetricWindow().means()
    assert [port_eval.bucket_k_eval(k) for k in range(0, 70)] == \
        [ref_eval.bucket_k_eval(k) for k in range(0, 70)]


# -- folds, metrics and the evaluator ----------------------------------------


@pytest.mark.parametrize("n,k,seed", [(0, 3, 0), (10, 3, 0), (1000, 3, 0),
                                      (997, 5, 7), (50, 2, 123)])
def test_k_fold_indices_are_the_reference_folds(n, k, seed):
    got, want = list(k_fold_indices(n, k, seed)), list(ref_folds(n, k, seed))
    assert len(got) == len(want) == k
    for (a, b), (c, d) in zip(got, want):
        assert np.array_equal(a, c) and np.array_equal(b, d)


def test_controller_exports_the_reference_api():
    missing = set(ref_controller.__all__) - set(port_controller.__all__)
    assert missing == set()
    for name in ("PDataSource", "LDataSource", "PAlgorithm", "P2LAlgorithm",
                 "LAlgorithm", "PPreparator", "LPreparator", "LServing"):
        assert getattr(port_controller, name).__name__ == \
            getattr(ref_controller, name).__name__
    assert port_controller.AverageServing().serve({}, [1.0, 2.0, 6.0]) == 3.0
    eng = port_controller.SimpleEngine(port_rec.RecommendationDataSource,
                                       port_rec.ALSAlgorithm)
    assert list(eng.algorithm_class_map) == [""]
    assert port_controller.params_to_dict(port_rec.DataSourceParams()) == \
        ref_controller.params_to_dict(ref_rec.DataSourceParams())
    ser = port_controller.CustomQuerySerializer()
    assert ser.query_from_json({"a": 1}) == {"a": 1} == ser.result_to_json({"a": 1})


def _candidates(n_cand=4, n_folds=3, seed=0):
    """The same (engine params, eval data) of both packages: recommendation
    answers, some empty, against actuals with ratings."""
    rng = np.random.default_rng(seed)
    out_port, out_ref = [], []
    for c in range(n_cand):
        obj = {"datasource": {"params": {"appName": "a"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 8 * (1 + c % 2), "lambda": [0.01, 0.1][c // 2]}}]}
        folds = []
        for _ in range(n_folds):
            qpa = []
            for _ in range(40):
                items = [f"i{int(x)}" for x in
                         rng.choice(30, int(rng.integers(0, 25)), replace=False)]
                qpa.append(({"user": "u", "num": 10},
                            {"itemScores": [{"item": x, "score": 1.0}
                                            for x in items]},
                            {"item": f"i{int(rng.integers(30))}",
                             "rating": float(rng.integers(1, 6))}))
            folds.append((None, qpa))
        out_port.append((EngineParams.from_json(obj), folds))
        out_ref.append((RefEngineParams.from_json(obj), folds))
    return out_port, out_ref


def test_engine_params_to_json_is_the_reference():
    obj = {"datasource": {"name": "d", "params": {"appName": "a"}},
           "preparator": {"params": {"x": 1}},
           "algorithms": [{"name": "als", "params": {"rank": 8}},
                          {"params": {"lambda": 0.1}}],
           "serving": {"name": "s"}}
    assert EngineParams.from_json(obj).to_json() == \
        RefEngineParams.from_json(obj).to_json()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_evaluator_output_is_byte_identical(seed):
    port_c, ref_c = _candidates(seed=seed)
    port = MetricEvaluator(recommendation_eval.HitRateAtK(10, 2.0),
                           [recommendation_eval.HitRateAtK(5),
                            recommendation_eval.HitRateAtK(20)])
    ref = ref_controller.MetricEvaluator(
        ref_rec_eval.HitRateAtK(10, 2.0),
        [ref_rec_eval.HitRateAtK(5), ref_rec_eval.HitRateAtK(20)])
    got, want = port.evaluate_candidates(port_c), ref.evaluate_candidates(ref_c)
    assert got.best_index == want.best_index
    assert got.pretty() == want.pretty()
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("base", ["AverageMetric", "OptionAverageMetric",
                                  "SumMetric", "ZeroMetric"])
def test_metric_classes_match_the_reference(base):
    _, ref_c = _candidates(n_cand=1)
    data = ref_c[0][1]

    def unit(q, p, a):
        n = len(p["itemScores"])
        return None if n == 0 and base == "OptionAverageMetric" else float(n)

    port_cls = type("M", (getattr(port_metric, base),),
                    {"calculate_unit": lambda self, q, p, a: unit(q, p, a)})
    ref_cls = type("M", (getattr(ref_controller, base),),
                   {"calculate_unit": lambda self, q, p, a: unit(q, p, a)})
    assert port_cls().calculate(data) == ref_cls().calculate(data)
    assert port_cls().header() == ref_cls().header() == "M"
    for a, b in ((1.0, 2.0), (2.0, 1.0), (1.0, 1.0)):
        assert port_cls().compare(a, b) == ref_cls().compare(a, b)


# -- read_eval and run_evaluation ---------------------------------------------


def _rating_events(n_users=25, n_items=15, seed=0):
    """tests/test_dase_train_e2e.py's _seed_ratings events."""
    rng = np.random.default_rng(seed)
    xu = rng.standard_normal((n_users, 3))
    xi = rng.standard_normal((n_items, 3))
    events = []
    for u in range(n_users):
        for i in range(n_items):
            if rng.random() < 0.4:
                r = float(np.clip(xu[u] @ xi[i] + 3.0, 1, 5))
                events.append(dict(
                    event="rate", entityType="user", entityId=str(u),
                    targetEntityType="item", targetEntityId=f"i{i}",
                    properties={"rating": r},
                    eventTime=(T0 + dt.timedelta(seconds=len(events)))
                    .isoformat().replace("+00:00", "Z")))
    return events


def _view_events(n_users=40, seed=3):
    """tests/test_template_quality.py's _seed_grouped_views events."""
    rng = np.random.default_rng(seed)
    events = []
    for u in range(n_users):
        lo, hi = (0, 10) if u % 2 == 0 else (10, 20)
        for _ in range(12):
            events.append(dict(
                event="view", entityType="user", entityId=str(u),
                targetEntityType="item",
                targetEntityId=f"i{int(rng.integers(lo, hi))}",
                eventTime=(T0 + dt.timedelta(seconds=len(events)))
                .isoformat().replace("+00:00", "Z")))
    return events


MEM = {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
       "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY"}


def _stores(app, wire):
    """A memory store of each package holding the same events."""
    out = []
    for pkg in (port_storage, ref_storage):
        s = pkg.Storage(MEM)
        app_id = s.get_meta_data_apps().insert(pkg.App(0, app))
        s.get_l_events().init(app_id)
        s.get_l_events().insert_batch([pkg.Event.from_json(e) for e in wire],
                                      app_id)
        out.append(s)
    return out


def _hold_folds(got, want, td_fields):
    assert len(got) == len(want) == 3
    for (td, info, qa), (rtd, rinfo, rqa) in zip(got, want):
        assert info is None and rinfo is None
        for f in td_fields:
            assert np.array_equal(getattr(td, f), getattr(rtd, f)), f
        assert list(td.users.keys()) == list(rtd.users.keys())
        assert list(td.items.keys()) == list(rtd.items.keys())
        assert list(qa) == list(rqa)


def test_recommendation_read_eval_is_the_reference():
    port_s, ref_s = _stores("evapp", _rating_events())
    params = {"appName": "evapp"}
    got = port_rec.RecommendationEngine()().make_components(
        EngineParams.from_json({"datasource": {"params": params}}))[0] \
        .read_eval(WorkflowContext(storage=port_s, device="cpu"))
    want = ref_rec.RecommendationEngine()().make_components(
        RefEngineParams.from_json({"datasource": {"params": params}}))[0] \
        .read_eval(RefContext(storage=ref_s))
    _hold_folds(got, want, ("user_idx", "item_idx", "rating"))


def _hold_evaluations(got, want):
    (res, iid, store), (rres, riid, rstore) = got, want
    assert len(res.all_results) == len(rres.all_results) == 2
    assert res.metric_header == rres.metric_header
    assert list(res.other_metric_headers) == list(rres.other_metric_headers)
    for (ep, s, o), (rep, rs, ro) in zip(res.all_results, rres.all_results):
        assert ep.to_json() == rep.to_json()
        assert abs(s - rs) <= SCORE_TOL, (s, rs)
        assert len(o) == len(ro)
        assert all(abs(a - b) <= SCORE_TOL for a, b in zip(o, ro)), (o, ro)
    top = sorted((s for _, s, _ in rres.all_results), reverse=True)
    if top[0] - top[1] > BEST_GAP:
        assert res.best_index == rres.best_index
    row = store.get_meta_data_evaluation_instances().get(iid)
    assert row.status == "EVALCOMPLETED" and row.end_time is not None
    assert row.evaluator_results == res.pretty()
    assert row.evaluator_results_json == res.to_json()
    assert rstore.get_meta_data_evaluation_instances().get(riid).status == \
        "EVALCOMPLETED"


def test_recommendation_evaluation_matches_the_reference():
    port_s, ref_s = _stores("recapp", _rating_events())
    gen, rgen = (recommendation_eval.ParamsList("recapp"),
                 ref_rec_eval.ParamsList("recapp"))
    gen.engine_params_list = gen.engine_params_list[:2]  # keep the test fast
    rgen.engine_params_list = rgen.engine_params_list[:2]
    got = run_evaluation(recommendation_eval.RecommendationEvaluation(), gen,
                         WorkflowContext(storage=port_s, device="cpu"),
                         evaluation_name="RecommendationEvaluation",
                         generator_name="ParamsList")
    want = ref_run_evaluation(ref_rec_eval.RecommendationEvaluation(), rgen,
                              RefContext(storage=ref_s),
                              evaluation_name="RecommendationEvaluation",
                              generator_name="ParamsList")
    assert got[0].metric_header == "HitRate@10"
    _hold_evaluations(got + (port_s,), want + (ref_s,))


def test_ecommerce_evaluation_matches_the_reference():
    from incubator_predictionio_tpu.models import template_evals as ref_evals

    port_s, ref_s = _stores("eceapp", _view_events())
    gen, rgen = (template_evals.ECommerceParamsList("eceapp"),
                 ref_evals.ECommerceParamsList("eceapp"))
    assert len(gen.engine_params_list) == len(rgen.engine_params_list) == 4
    gen.engine_params_list = gen.engine_params_list[:2]
    rgen.engine_params_list = rgen.engine_params_list[:2]
    got = run_evaluation(template_evals.ECommerceEvaluation(device="cpu"), gen,
                         WorkflowContext(storage=port_s, device="cpu"),
                         evaluation_name="ECommerceEvaluation",
                         generator_name="ECommerceParamsList")
    want = ref_run_evaluation(ref_evals.ECommerceEvaluation(), rgen,
                              RefContext(storage=ref_s),
                              evaluation_name="ECommerceEvaluation",
                              generator_name="ECommerceParamsList")
    assert got[0].metric_header == "NDCG@10" and 0.0 < got[0].best_score <= 1.0
    _hold_evaluations(got + (port_s,), want + (ref_s,))


def test_a_failing_candidate_aborts_the_instance():
    port_s, _ = _stores("abapp", _rating_events())
    gen = recommendation_eval.ParamsList("abapp")
    gen.engine_params_list = [EngineParams.from_json({
        "datasource": {"params": {"appName": "abapp"}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "bogus": 1}}]})]
    with pytest.raises(ValueError, match="bogus"):
        run_evaluation(recommendation_eval.RecommendationEvaluation(), gen,
                       WorkflowContext(storage=port_s, device="cpu"))
    rows = port_s.get_meta_data_evaluation_instances().get_all()
    assert [r.status for r in rows] == ["EVALABORTED"]
    assert rows[0].end_time is not None and rows[0].evaluator_results == ""


def test_candidates_run_one_after_another_on_the_cpu():
    ctx = WorkflowContext(device="cpu")
    assert candidate_devices(ctx, 8, 4) == [torch.device("cpu")]
    assert candidate_devices(ctx, 1, 4) == [torch.device("cpu")]


def test_parallel_candidates_keep_order_and_results():
    """The worker pool of --parallel-candidates (one device per worker
    thread), here over two CPU workers: the candidates come back in their
    order with the sequential run's results."""
    port_s, _ = _stores("parapp", _rating_events())
    ctx = WorkflowContext(storage=port_s, device="cpu")
    engine = recommendation_eval.RecommendationEvaluation().engine
    params = recommendation_eval.ParamsList("parapp").engine_params_list
    cpu = torch.device("cpu")
    sequential = _eval_candidates(engine, params, ctx, [cpu])
    parallel = _eval_candidates(engine, params, ctx, [cpu, cpu])
    assert [ep for ep, _ in parallel] == list(params)
    metric = recommendation_eval.HitRateAtK(10, 2.0)
    for (_, got), (_, want) in zip(parallel, sequential):
        assert [qpa for _, qpa in got] == [qpa for _, qpa in want]
        assert metric.calculate(got) == metric.calculate(want)


def test_eval_and_the_metric_need_a_card_unless_the_cpu_is_asked_for(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        run_evaluation(recommendation_eval.RecommendationEvaluation(),
                       recommendation_eval.ParamsList("x"))
    with pytest.raises(RuntimeError, match="is_available"):
        commands.dispatch("eval", [
            "incubator_predictionio_torch.models.recommendation_eval."
            "RecommendationEvaluation"])
    with pytest.raises(RuntimeError, match="is_available"):
        port_eval.ranking_metrics([["a"]], [{"a"}], 5)


# -- the dashboard ------------------------------------------------------------


def _get(port, path, method="GET"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read().decode()
    finally:
        conn.close()


def test_dashboard_serves_the_leaderboard():
    port_s, _ = _stores("dashapp", _rating_events())
    result, iid = run_evaluation(
        recommendation_eval.RecommendationEvaluation(),
        recommendation_eval.ParamsList(app_name="dashapp"),
        WorkflowContext(storage=port_s, device="cpu"),
        evaluation_name="RecommendationEvaluation",
        generator_name="ParamsList")
    assert len(result.all_results) == 4  # 2 ranks × 2 lambdas
    assert 0.0 <= result.best_score <= 1.0
    assert "bestScore" in result.to_json()
    inst = port_s.get_meta_data_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED" and "HitRate@10" in inst.evaluator_results

    dash = Dashboard(port_s, "127.0.0.1", 0)
    _, port = dash.start()
    try:
        status, _, page = _get(port, "/")
        assert status == 200 and "RecommendationEvaluation" in page
        assert "HitRate@10" in page
        assert f"{result.best_score:.6g}" in page
        assert "engine.json params" in page
        assert "algorithms" in page
        listing = json.loads(_get(port, "/instances.json")[2])
        assert listing[0]["id"] == iid
        assert listing[0]["metricHeader"] == "HitRate@10"
        assert listing[0]["bestScore"] == result.best_score
        assert listing[0]["candidates"] == 4
        assert listing[0]["bestEngineParams"]["algorithms"]
        detail = json.loads(_get(port, f"/instances/{iid}.json")[2])
        assert detail["results"]["metricHeader"] == "HitRate@10"
        assert _get(port, "/instances/nope.json")[0] == 404
        status, _, page = _get(port, f"/instances/{iid}")
        assert status == 200 and page.count("<tr class=") == 4
        assert "= best" in page
        for path in ("/", "/instances.json", f"/instances/{iid}"):
            assert _get(port, path)[1]["Access-Control-Allow-Origin"] == "*"
        status, headers, _ = _get(port, "/instances.json", "OPTIONS")
        assert status == 200 and "GET" in headers["Access-Control-Allow-Methods"]
    finally:
        dash.stop()
    best = json.loads(result.to_json())["bestEngineParams"]
    other = json.loads(result.to_json())["results"][0]["engineParams"]
    assert params_diff(best, best) == []
    assert all(k.startswith("algorithms.0.params.")
               for k, _, _ in params_diff(other, best))
