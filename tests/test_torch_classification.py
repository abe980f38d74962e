"""The port's Classification and Text-Classification templates
(``models/classification.py``, ``models/text_classification.py``, with
``convert.py``'s readers) on the CPU against the JAX reference templates,
on the same events: in memory stores written with the same events, and on
a JSONL log (metadata and models on SQLite) that both packages read.

- the training data equal; ``read_eval`` fold for fold equal;
- through ``run_train`` → ``load_deployment``: Naive Bayes models array
  for array the reference's (exact statistics), so every answer equal;
  LR answers the reference's labels (the L-BFGS is held to its tolerances
  in tests/test_torch_linear.py);
- the reference's trained model, converted, answers exactly as the
  reference serves it;
- persistence round trips (arrays and JSON, the labels as a ``<U`` array
  for text) answer exactly as the trained model; the fold-ins equal the
  reference's (NB exact with replacement, LR within 1e-6).
"""

import datetime as dt

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from incubator_predictionio_tpu.controller import EngineParams as RefEngineParams  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.models import classification as ref_cls  # noqa: E402
from incubator_predictionio_tpu.models import text_classification as ref_txt  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_torch import convert  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data import storage as port_storage  # noqa: E402
from incubator_predictionio_torch.models import classification as port_cls  # noqa: E402
from incubator_predictionio_torch.models import text_classification as port_txt  # noqa: E402
from incubator_predictionio_torch.workflow import core_workflow  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.persist import (  # noqa: E402
    models_from_bytes, models_to_bytes,
)

T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
CLS_FACTORY = ("incubator_predictionio_torch.models.classification."
               "ClassificationEngine")
TXT_FACTORY = ("incubator_predictionio_torch.models.text_classification."
               "TextClassificationEngine")
LR_PARAMS = {"regParam": 0.01, "maxIterations": 100}


def _ts(i):
    return T0 + dt.timedelta(seconds=i)


def _cls_events(pkg):
    """tests/test_templates.py's classification scenario, plus a partial
    $set (no label), an $unset and a re-$set."""
    rng = np.random.default_rng(0)
    events = []
    for n in range(200):
        a = rng.integers(0, 5, 3)
        plan = int(a[0] >= 2) + int(a[0] >= 4)
        events.append(pkg.Event(
            "$set", "user", str(n), properties=pkg.DataMap(
                {"attr0": int(a[0]), "attr1": int(a[1]), "attr2": int(a[2]),
                 "plan": plan}), event_time=_ts(n)))
    events.append(pkg.Event("$set", "user", "partial", properties=pkg.DataMap(
        {"attr0": 1, "attr1": 1, "attr2": 1}), event_time=_ts(300)))
    events.append(pkg.Event("$unset", "user", "3", properties=pkg.DataMap(
        {"plan": None}), event_time=_ts(301)))
    events.append(pkg.Event("$set", "user", "7", properties=pkg.DataMap(
        {"attr1": 4}), event_time=_ts(302)))
    return events


_TOPICS = {
    "motorcycles": "fast motorcycles ride highway speed engine throttle "
                   "helmet wheels",
    "computers": "graphics screen computer keyboard software cpu code "
                 "programming",
    "cooking": "recipe oven bake flour sugar butter pan stove",
}


def _txt_events(pkg):
    rng = np.random.default_rng(1)
    common = "the a and of to in my I like".split()
    events = []
    for j in range(90):
        label = list(_TOPICS)[j % 3]
        words = rng.choice(_TOPICS[label].split() + common, 12)
        events.append(pkg.Event("documents", "content", str(j),
                                properties=pkg.DataMap(
                                    {"text": " ".join(words),
                                     "label": label}),
                                event_time=_ts(j)))
    events.append(pkg.Event("documents", "content", "nolabel",
                            properties=pkg.DataMap({"text": "orphan"}),
                            event_time=_ts(200)))
    return events


def _env(kind, tmp_path):
    if kind == "memory":
        return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "MEM"
                for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
            "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY"}
    return {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
            "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.sqlite"),
            "PIO_STORAGE_SOURCES_LOG_TYPE": "JSONL",
            "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "events")}


@pytest.fixture(params=["memory", "jsonl"])
def stores(request, tmp_path):
    """(port store, reference store, kind): the app "app" holds both
    templates' events in each; on a log the reference writes and both
    read the same files."""
    env = _env(request.param, tmp_path)
    ref = ref_storage.Storage(env)
    port = port_storage.Storage(env)
    writers = [(ref, ref_storage)]
    if request.param == "memory":
        writers.append((port, port_storage))
    for s, pkg in writers:
        app_id = s.get_meta_data_apps().insert(pkg.App(0, "app"))
        s.get_l_events().init(app_id)
        s.get_l_events().insert_batch(_cls_events(pkg) + _txt_events(pkg),
                                      app_id)
    yield port, ref, request.param
    port.close()
    ref.close()


def _engine_json(factory, algo, params, preparator=None):
    out = {"engineFactory": factory,
           "datasource": {"params": {"appName": "app"}},
           "algorithms": [{"name": algo, "params": params}]}
    if preparator:
        out["preparator"] = {"params": preparator}
    return out


def _ref_trained(ref, engine_json, factory_cls):
    engine = factory_cls()()
    params = RefEngineParams.from_json(engine_json)
    ctx = RefContext(app_name="app", storage=ref)
    ds, prep, algo_list, _ = engine.make_components(params)
    td = ds.read_training(ctx)
    algo = algo_list[0][1]
    return td, algo, algo.train(ctx, prep.prepare(ctx, td)), ds, ctx


def _port_deployed(port, engine_json, factory_cls, factory):
    engine = factory_cls()()
    params = EngineParams.from_json(engine_json)
    iid = core_workflow.run_train(
        engine, params,
        WorkflowContext(app_name="app", storage=port, device="cpu"),
        engine_factory_name=factory)
    deployment, _, _ = core_workflow.load_deployment(
        engine, iid, WorkflowContext(storage=port, device="cpu"),
        engine_factory_name=factory)
    return deployment


CLS_QUERIES = [{"attr0": a, "attr1": b, "attr2": c}
               for a in range(5) for b in (0, 2, 4) for c in (0, 3)]
TXT_QUERIES = ["I like speed and fast motorcycles", "my computer software",
               "bake a cake with flour and sugar", "", "unknown words only",
               "keyboard helmet oven"]


def _same_inner(got, want):
    for name in ("log_prior", "log_likelihood", "feat_counts",
                 "class_counts", "weights", "intercept"):
        a, b = getattr(got, name, None), getattr(want, name, None)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(a, np.asarray(b)), name


def test_classification_training_data_is_the_references(stores):
    port, ref, _ = stores
    ej = _engine_json(CLS_FACTORY, "naive", {})
    rtd = _ref_trained(ref, ej, ref_cls.ClassificationEngine)[0]
    ds = port_cls.ClassificationEngine()().make_components(
        EngineParams.from_json(ej))[0]
    td = ds.read_training(WorkflowContext(app_name="app", storage=port,
                                          device="cpu"))
    assert np.array_equal(td.features, rtd.features)
    assert np.array_equal(td.labels, rtd.labels)
    assert td.label_values.dtype == rtd.label_values.dtype
    assert np.array_equal(td.label_values, rtd.label_values)
    assert tuple(td.attribute_names) == tuple(rtd.attribute_names)
    assert len(td.features) == 199  # the partial and the unset user drop


@pytest.mark.parametrize("algo,params", [("naive", {"lambda": 0.5}),
                                         ("lr", LR_PARAMS)])
def test_classification_deploys_with_the_references_answers(stores, algo,
                                                            params):
    port, ref, _ = stores
    ej = _engine_json(CLS_FACTORY, algo, params)
    _, ralgo, rmodel, _, _ = _ref_trained(ref, ej,
                                          ref_cls.ClassificationEngine)
    dep = _port_deployed(port, ej, port_cls.ClassificationEngine,
                         CLS_FACTORY)
    model = dep.models[0]
    if algo == "naive":
        _same_inner(model.inner, rmodel.inner)
    assert np.array_equal(model.label_values, rmodel.label_values)
    for q in CLS_QUERIES:
        assert dep.query(q) == ralgo.predict(rmodel, q), q
    converted = convert.from_jax_classifier(rmodel)
    _same_inner(converted.inner, rmodel.inner)
    for q in CLS_QUERIES:
        assert dep.algo_list[0][1].predict(converted, q) == \
            ralgo.predict(rmodel, q)


@pytest.mark.parametrize("algo,params", [("nb", {"lambda": 1.0}),
                                         ("lr", {"regParam": 0.01})])
def test_text_classification_deploys_with_the_references_answers(
        stores, algo, params):
    port, ref, _ = stores
    ej = _engine_json(TXT_FACTORY, algo, params, {"numFeatures": 256})
    _, ralgo, rmodel, _, _ = _ref_trained(
        ref, ej, ref_txt.TextClassificationEngine)
    dep = _port_deployed(port, ej, port_txt.TextClassificationEngine,
                         TXT_FACTORY)
    model = dep.models[0]
    assert np.array_equal(model.vectorizer.idf, rmodel.vectorizer.idf)
    assert model.label_values.dtype.kind == "U"
    if algo == "nb":
        _same_inner(model.inner, rmodel.inner)
    for text in TXT_QUERIES:
        got = dep.query({"text": text})
        want = ralgo.predict(rmodel, {"text": text})
        if algo == "nb":
            assert got == want, text
        else:
            assert got["category"] == want["category"], text
            assert got["confidence"] == pytest.approx(want["confidence"],
                                                      abs=1e-3)
    converted = convert.from_jax_text_model(rmodel)
    for text in TXT_QUERIES:
        assert dep.algo_list[0][1].predict(converted, {"text": text}) == \
            ralgo.predict(rmodel, {"text": text})


def _same_folds(got, want, key):
    assert len(got) == len(want) == 3
    for (td, info, qa), (rtd, rinfo, rqa) in zip(got, want):
        assert info is None and rinfo is None
        assert np.array_equal(getattr(td, key), getattr(rtd, key)) \
            if key != "texts" else td.texts == rtd.texts
        assert np.array_equal(td.labels, rtd.labels)
        assert np.array_equal(td.label_values, rtd.label_values)
        assert list(qa) == list(rqa)


def test_read_eval_folds_are_the_references(stores):
    port, ref, _ = stores
    pctx = WorkflowContext(app_name="app", storage=port, device="cpu")
    for factory, rfactory, algo, key in (
            (port_cls.ClassificationEngine, ref_cls.ClassificationEngine,
             "naive", "features"),
            (port_txt.TextClassificationEngine,
             ref_txt.TextClassificationEngine, "nb", "texts")):
        ej = _engine_json("", algo, {})
        rds, rctx = _ref_trained(ref, ej, rfactory)[3:]
        ds = factory()().make_components(EngineParams.from_json(ej))[0]
        _same_folds(ds.read_eval(pctx), rds.read_eval(rctx), key)


def _roundtrip(algo, model, ctx):
    stored = algo.prepare_model_for_persistence(model)
    back = models_from_bytes(models_to_bytes({}, [stored]))[1][0]
    return algo.restore_model(back, ctx)


@pytest.mark.parametrize("algo", ["naive", "lr"])
def test_classifier_persists_without_pickle_and_answers_the_same(algo):
    ctx = WorkflowContext(events=[e.to_json() for e in
                                  _cls_events(port_storage)], device="cpu")
    engine = port_cls.ClassificationEngine()()
    params = EngineParams.from_json(_engine_json("", algo, LR_PARAMS
                                                 if algo == "lr" else {}))
    model = engine.train(ctx, params)[0]
    alg = engine.make_components(params)[2][0][1]
    back = _roundtrip(alg, model, ctx)
    _same_inner(back.inner, model.inner)
    assert back.label_values.dtype == model.label_values.dtype
    for q in CLS_QUERIES:
        assert alg.predict(back, q) == alg.predict(model, q)
    if algo == "naive":
        folded = alg.fold_in(model, [{"event": "$set", "entityType": "user",
                                      "entityId": "n1", "properties": {
                                          "attr0": 4, "attr1": 0,
                                          "attr2": 1, "plan": 2}}])
        back = _roundtrip(alg, folded, ctx)
        assert back.foldin_seen == folded.foldin_seen == {
            "n1": ((4.0, 0.0, 1.0), 2)}
        _same_inner(back.inner, folded.inner)


def test_text_model_persists_without_pickle_and_answers_the_same():
    ctx = WorkflowContext(events=[e.to_json() for e in
                                  _txt_events(port_storage)], device="cpu")
    engine = port_txt.TextClassificationEngine()()
    for algo in ("nb", "lr"):
        params = EngineParams.from_json(_engine_json(
            "", algo, {}, {"numFeatures": 128, "nGram": 2}))
        model = engine.train(ctx, params)[0]
        alg = engine.make_components(params)[2][0][1]
        back = _roundtrip(alg, model, ctx)
        assert back.label_values.dtype.kind == "U"
        assert back.vectorizer.ngram == 2
        for text in TXT_QUERIES:
            assert alg.predict(back, {"text": text}) == \
                alg.predict(model, {"text": text})


def _foldin_events():
    sets = [{"event": "$set", "entityType": "user", "entityId": f"n{j}",
             "properties": {"attr0": j % 5, "attr1": 1, "attr2": 2,
                            "plan": j % 3}} for j in range(6)]
    return sets + [
        {"event": "$set", "entityType": "user", "entityId": "n1",
         "properties": {"attr0": 4, "attr1": 4, "attr2": 0, "plan": 2}},
        {"event": "$set", "entityType": "user", "entityId": "part",
         "properties": {"attr0": 1}},
        {"event": "$set", "entityType": "user", "entityId": "newlabel",
         "properties": {"attr0": 1, "attr1": 1, "attr2": 1, "plan": 9}},
        {"event": "view", "entityType": "user", "entityId": "n2"}]


def test_fold_ins_equal_the_references(stores):
    port, ref, _ = stores
    for algo, params in (("naive", {}), ("lr", LR_PARAMS)):
        ej = _engine_json(CLS_FACTORY, algo, params)
        _, ralgo, rmodel, _, _ = _ref_trained(
            ref, ej, ref_cls.ClassificationEngine)
        model = convert.from_jax_classifier(rmodel)
        alg = port_cls.ClassificationEngine()().make_components(
            EngineParams.from_json(ej))[2][0][1]
        dsp = ej["datasource"]["params"]
        got = alg.fold_in(model, _foldin_events(), None, dsp)
        want = ralgo.fold_in(rmodel, _foldin_events(), None, dsp)
        if algo == "naive":
            _same_inner(got.inner, want.inner)
            assert got.foldin_seen == want.foldin_seen
            # a second increment replaces n1's and n3's examples
            again = [{"event": "$set", "entityType": "user", "entityId": e,
                      "properties": {"attr0": 0, "attr1": 0, "attr2": 0,
                                     "plan": 0}} for e in ("n1", "n3")]
            got2 = alg.fold_in(got, again, None, dsp)
            want2 = ralgo.fold_in(want, again, None, dsp)
            _same_inner(got2.inner, want2.inner)
            assert got2.foldin_seen == want2.foldin_seen
            assert list(got2.foldin_seen)[-2:] == ["n1", "n3"]
        else:
            np.testing.assert_allclose(got.inner.weights, want.inner.weights,
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(got.inner.intercept,
                                       want.inner.intercept, rtol=0,
                                       atol=1e-6)
        assert alg.fold_in(model, [{"event": "view"}], None, dsp) is None
