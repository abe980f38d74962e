"""The port's Complementary Purchase template (``models/
complementary_purchase.py``, ``template_evals``' Complementary pair and
``convert.py``'s CP dict) on the CPU against the JAX reference template:

- ``form_baskets`` equal to the reference's, element for element;
- the training data and the ``read_eval`` folds equal to the reference's;
- the indicators under the top-k rule against the reference's, with the
  basket count as N;
- end to end through ``run_train`` → ``load_deployment`` on the
  reference test's baskets (tests/test_complementary_purchase.py), the
  window separating unrelated purchases, answers held to a host scorer of
  the persisted indicators and, for the reference's persisted model, to
  the reference's answers;
- ``run_evaluation`` of ComplementaryEvaluation / ComplementaryParamsList
  against the reference's (scores within 0.02, the same best candidate
  where the top two differ by more than 0.05);
- persistence through ``convert.py`` both ways, and the device rule.
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
from incubator_predictionio_tpu.models import complementary_purchase as ref_cp  # noqa: E402
from incubator_predictionio_tpu.models import template_evals as ref_evals  # noqa: E402
from incubator_predictionio_tpu.workflow import core_workflow as ref_workflow  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_tpu.workflow.evaluation_workflow import (  # noqa: E402
    run_evaluation as ref_run_evaluation,
)
from incubator_predictionio_torch import convert  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data import storage as port_storage  # noqa: E402
from incubator_predictionio_torch.models import complementary_purchase as port_cp  # noqa: E402
from incubator_predictionio_torch.models import template_evals  # noqa: E402
from incubator_predictionio_torch.workflow import core_workflow  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.evaluation_workflow import (  # noqa: E402
    run_evaluation,
)

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
FACTORY = ("incubator_predictionio_torch.models.complementary_purchase."
           "ComplementaryPurchaseEngine")
ENGINE_JSON = {
    "engineFactory": FACTORY,
    "datasource": {"params": {"appName": "MyShopApp"}},
    "algorithms": [{"name": "cooccurrence", "params": {
        "basketWindowSecs": 3600, "maxCorrelatorsPerItem": 10}}],
}
SCORE_TOL = 0.02
BEST_GAP = 0.05
MEM = {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
       "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY"}


def _iso(t):
    return t.isoformat().replace("+00:00", "Z")


def _basket_events(n_shoppers=200, seed=3):
    """tests/test_complementary_purchase.py's baskets: burger+bun+ketchup
    or pasta+sauce, plus a noise item, in one window per shopper; and a
    second, later basket of noise for every third shopper."""
    rng = np.random.default_rng(seed)
    wire = []
    for s in range(n_shoppers):
        base = T0 + dt.timedelta(hours=3 * s)
        combo = ["burger", "bun", "ketchup"] if s % 2 else ["pasta", "sauce"]
        basket = combo + [f"noise{rng.integers(40)}"]
        if s % 3 == 0:
            basket.append(f"noise{rng.integers(40)}")
        for j, item in enumerate(basket):
            wire.append(dict(event="buy", entityType="user",
                             entityId=f"u{s}", targetEntityType="item",
                             targetEntityId=item,
                             eventTime=_iso(base + dt.timedelta(minutes=j))))
        if s % 3 == 0:
            wire.append(dict(event="buy", entityType="user",
                             entityId=f"u{s}", targetEntityType="item",
                             targetEntityId=f"noise{rng.integers(40)}",
                             eventTime=_iso(base + dt.timedelta(days=9))))
    return wire


def _stores(wire, app="MyShopApp"):
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_form_baskets_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = 5000
    u = rng.integers(0, 300, n).astype(np.int32)
    t = rng.integers(0, 5 * 86_400, n).astype(np.int64) * 1_000_000
    t[::7] = t[3]  # equal times
    for window in (0, 60, 3600, 86_400 * 10):
        got = port_cp.form_baskets(u, t, window * 1_000_000)
        want = ref_cp.form_baskets(u, t, window * 1_000_000)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert port_cp.form_baskets(np.zeros(0, np.int32), np.zeros(0, np.int64),
                                60).shape == (0,)


def _trained(port_s, ref_s, engine_json=ENGINE_JSON):
    engine = port_cp.ComplementaryPurchaseEngine()()
    params = EngineParams.from_json(engine_json)
    iid = core_workflow.run_train(
        engine, params,
        WorkflowContext(app_name="MyShopApp", storage=port_s, device="cpu"),
        engine_factory_name=FACTORY)
    dep, _, _ = core_workflow.load_deployment(
        engine, iid, WorkflowContext(storage=port_s, device="cpu"),
        engine_factory_name=FACTORY)
    rengine = ref_cp.ComplementaryPurchaseEngine()()
    rparams = RefEngineParams.from_json(engine_json)
    riid = ref_workflow.run_train(
        rengine, rparams, RefContext(app_name="MyShopApp", storage=ref_s),
        engine_factory_name="comp")
    rdep, _, _ = ref_workflow.load_deployment(
        rengine, riid, RefContext(storage=ref_s), engine_factory_name="comp")
    return engine, params, dep, rdep


def _ids(result):
    return [e["item"] for e in result["itemScores"]]


def _hold_to_host(model, query, result):
    items = model.items
    known = [items.get(x) for x in query["items"]]
    known = [j for j in known if j is not None]
    n = len(items)
    membership = np.zeros(n, np.float32)
    membership[known] = 1.0
    exclude = np.zeros(n, bool)
    exclude[known] = True
    total = host_scores({"buy": (model.indicators.idx,
                                 model.indicators.score)},
                        {"buy": membership}, exclude=exclude)
    hold_served([items(x) for x in _ids(result)],
                [e["score"] for e in result["itemScores"]], total,
                query["num"] if known else 0)


QUERIES = [{"items": ["burger"], "num": 3}, {"items": ["pasta"], "num": 2},
           {"items": ["bun", "noise3"], "num": 5},
           {"items": ["ketchup", "ghost"], "num": 10},
           {"items": ["ghost"], "num": 3}, {"items": [], "num": 3},
           {"items": ["noise7"], "num": 40}]


def test_training_data_folds_and_indicators_match_the_reference():
    port_s, ref_s = _stores(_basket_events())
    params = {"datasource": {"params": {"appName": "MyShopApp"}}}
    ds = port_cp.ComplementaryPurchaseEngine()().make_components(
        EngineParams.from_json(params))[0]
    rds = ref_cp.ComplementaryPurchaseEngine()().make_components(
        RefEngineParams.from_json(params))[0]
    td = ds.read_training(WorkflowContext(storage=port_s, device="cpu"))
    rtd = rds.read_training(RefContext(storage=ref_s))
    for f in ("user_idx", "item_idx", "time_us"):
        got, want = getattr(td, f), getattr(rtd, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert list(td.items.keys()) == list(rtd.items.keys())
    got = ds.read_eval(WorkflowContext(storage=port_s, device="cpu"))
    want = rds.read_eval(RefContext(storage=ref_s))
    assert len(got) == len(want) == 3
    for (ftd, info, qa), (rftd, rinfo, rqa) in zip(got, want):
        assert info is None and rinfo is None
        for f in ("user_idx", "item_idx", "time_us"):
            assert np.array_equal(getattr(ftd, f), getattr(rftd, f)), f
        assert list(qa) == list(rqa) and qa

    algo = port_cp.ComplementaryAlgorithm(port_cp.AlgoParams(
        max_correlators=6))
    ralgo = ref_cp.ComplementaryAlgorithm(ref_cp.AlgoParams(
        max_correlators=6))
    ctx = WorkflowContext(storage=port_s, device="cpu")
    ctx.bench_timings = {}
    model = algo.train(ctx, td)
    rmodel = ralgo.train(RefContext(storage=ref_s), rtd)
    baskets = port_cp.form_baskets(td.user_idx, td.time_us, 3600 * 10 ** 6)
    n = int(baskets.max()) + 1
    assert ctx.bench_timings["baskets"] == n > len(set(td.user_idx.tolist()))
    c, n_i, n_j = dense_counts(baskets, td.item_idx, baskets, td.item_idx, n,
                               len(td.items))
    hold_topk(model.indicators.idx, model.indicators.score,
              np.where(rmodel.indicators.idx >= 0, rmodel.indicators.score,
                       0), reference_g2(c, n_i, n_j, n), g2_tol(n))


def test_end_to_end_suggests_co_purchased_items():
    port_s, ref_s = _stores(_basket_events())
    engine, params, dep, rdep = _trained(port_s, ref_s)
    got = _ids(dep.query({"items": ["burger"], "num": 3}))
    assert "bun" in got[:2] and "ketchup" in got[:3]
    assert not {"burger", "pasta", "sauce"} & set(got)
    assert _ids(dep.query({"items": ["pasta"], "num": 2}))[:1] == ["sauce"]
    assert dep.query({"items": ["ghost"], "num": 3}) == {"itemScores": []}
    model = dep.models[0]
    for q in QUERIES:
        _hold_to_host(model, q, dep.query(q))
    # the reference's persisted model, deployed in the port, answers as
    # the reference's deployment
    stored = rdep.algo_list[0][1].prepare_model_for_persistence(
        rdep.models[0])
    from_ref = engine.prepare_deployment(
        WorkflowContext(storage=port_s, device="cpu"), params, [stored])
    for q in QUERIES:
        got, want = from_ref.query(q), rdep.query(q)
        ws = np.array([e["score"] for e in want["itemScores"]])
        np.testing.assert_allclose(
            [e["score"] for e in got["itemScores"]], ws, rtol=1e-5)
        close = np.isclose(ws[1:], ws[:-1], rtol=1e-5, atol=0)
        distinct = np.ones(len(ws), bool)
        distinct[1:] &= ~close
        distinct[:-1] &= ~close
        assert [x for x, d in zip(_ids(got), distinct) if d] == \
            [x for x, d in zip(_ids(want), distinct) if d], q


def test_window_separates_unrelated_purchases():
    wire = []
    for s in range(40):
        base = T0 + dt.timedelta(days=s)
        for item, at in (("tv", base), ("hdmi", base + dt.timedelta(
                minutes=5)), ("socks", base + dt.timedelta(days=7))):
            wire.append(dict(event="buy", entityType="user",
                             entityId=f"u{s}", targetEntityType="item",
                             targetEntityId=item, eventTime=_iso(at)))
    port_s, ref_s = _stores(wire)
    engine_json = {"datasource": ENGINE_JSON["datasource"],
                   "algorithms": [{"name": "cooccurrence", "params": {
                       "basketWindowSecs": 3600}}]}
    _, _, dep, rdep = _trained(port_s, ref_s, engine_json)
    got = _ids(dep.query({"items": ["tv"], "num": 5}))
    assert got[:1] == ["hdmi"] and "socks" not in got
    assert got == _ids(rdep.query({"items": ["tv"], "num": 5}))


def test_evaluation_matches_the_reference():
    port_s, ref_s = _stores(_basket_events(120))
    gen = template_evals.ComplementaryParamsList("MyShopApp")
    rgen = ref_evals.ComplementaryParamsList("MyShopApp")
    assert len(gen.engine_params_list) == len(rgen.engine_params_list) == 4
    got = run_evaluation(template_evals.ComplementaryEvaluation(device="cpu"),
                         gen, WorkflowContext(storage=port_s, device="cpu"),
                         evaluation_name="ComplementaryEvaluation",
                         generator_name="ComplementaryParamsList")
    want = ref_run_evaluation(ref_evals.ComplementaryEvaluation(), rgen,
                              RefContext(storage=ref_s),
                              evaluation_name="ComplementaryEvaluation",
                              generator_name="ComplementaryParamsList")
    (res, iid), (rres, _) = got, want
    assert res.metric_header == rres.metric_header == "NDCG@10"
    assert len(res.all_results) == len(rres.all_results) == 4
    for (ep, s, o), (rep, rs, ro) in zip(res.all_results, rres.all_results):
        assert ep.to_json() == rep.to_json()
        assert abs(s - rs) <= SCORE_TOL, (s, rs)
        assert all(abs(a - b) <= SCORE_TOL for a, b in zip(o, ro)), (o, ro)
    top = sorted((s for _, s, _ in rres.all_results), reverse=True)
    if top[0] - top[1] > BEST_GAP:
        assert res.best_index == rres.best_index
    assert 0.0 < res.best_score <= 1.0
    row = port_s.get_meta_data_evaluation_instances().get(iid)
    assert row.status == "EVALCOMPLETED"


def test_persistence_converts_both_ways_and_the_device_rule(monkeypatch):
    port_s, ref_s = _stores(_basket_events(60))
    _, _, dep, rdep = _trained(port_s, ref_s)
    rstored = rdep.algo_list[0][1].prepare_model_for_persistence(
        rdep.models[0])
    model = convert.from_jax_persisted(rstored, device="cpu")
    assert isinstance(model, port_cp.ComplementaryModel)
    back = convert.to_jax_persisted(model)
    assert set(back) == set(rstored) and back["items"] == rstored["items"]
    assert np.array_equal(back["idx"], np.asarray(rstored["idx"]))
    assert np.array_equal(back["score"], np.asarray(rstored["score"]))
    restored = rdep.algo_list[0][1].restore_model(back, None)
    for q in QUERIES:
        assert restored.suggest(q["items"], q["num"]) == \
            rdep.models[0].suggest(q["items"], q["num"])
    stored = dep.algo_list[0][1].prepare_model_for_persistence(dep.models[0])
    assert all(isinstance(stored[k], np.ndarray) for k in ("idx", "score"))
    with pytest.raises(ValueError, match="event store"):
        port_cp.ComplementaryPurchaseEngine()().make_components(
            EngineParams.from_json({}))[0].read_training(
            WorkflowContext(events=[], device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_cp.model_from_persisted(rstored)
