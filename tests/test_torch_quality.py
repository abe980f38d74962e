"""The port's continuous quality evaluation (``workflow/quality.py``,
``data/api/holdout.py`` and the engine server's quality watch) on the CPU,
held against the reference:

- ``extract_ranking`` gives the reference's answer on the same predictions;
- the holdout tailer's labels and view equal the reference's on the same
  JSONL log, and its memory bounds hold;
- the shadow cases of ``tests/test_quality.py``: a seeded degradation
  breaches once per window with the reference's metrics and deltas, the
  minimum-sample gate, the window reset on a new instance, unlabeled
  samples expiring, the offer filter and a non-JSONL store;
- a poisoned fold-in increment and a poisoned retrain, both gate-passing
  and non-erroring, are rolled back with reason ``quality`` while every
  client query answers 200; the counts are read from ``/status`` (the port
  has no ``/metrics`` yet).
"""

import threading
import time
import types

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_foldin_engine as fe  # noqa: E402
import torch_serving as ts  # noqa: E402
from incubator_predictionio_tpu.data.api.holdout import HoldoutTailer as RefHoldout  # noqa: E402
from incubator_predictionio_tpu.workflow import quality as ref_quality  # noqa: E402
from incubator_predictionio_torch.data.api.holdout import HoldoutTailer  # noqa: E402
from incubator_predictionio_torch.data.storage import App, DataMap, Event, Storage  # noqa: E402
from incubator_predictionio_torch.tools.commands.management import _print_quality  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.core_workflow import run_train  # noqa: E402
from incubator_predictionio_torch.workflow.create_server import EngineServer  # noqa: E402
from incubator_predictionio_torch.workflow.quality import (  # noqa: E402
    QualityShadow, extract_ranking,
)

APP = "qualapp"
FACTORY = "torch_foldin_engine.rank_engine_factory"


def _env(tmp_path):
    return {
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "JL",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY",
        "PIO_STORAGE_SOURCES_JL_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_JL_PATH": str(tmp_path / "events"),
    }


def _mk_app(storage, name=APP) -> int:
    return storage.get_meta_data_apps().insert(App(0, name))


def _rate(le, app_id, user, item, rating=1.0, event="rate"):
    le.insert(Event(event, "user", user, "item", item,
                    DataMap({"rating": rating})), app_id)


# -- extract_ranking and the holdout tailer ----------------------------------

@pytest.mark.parametrize("prediction", [
    {"itemScores": [{"item": "a", "score": 1.0}, {"item": 2, "score": 0.5}]},
    {"score": 4.0},
    {"itemScores": []},
    {"itemScores": [{"score": 1.0}]},
    {"itemScores": ["a"]},
    {"itemScores": "nope"},
    "nope",
    None,
], ids=lambda p: repr(p)[:40])
def test_extract_ranking_equals_the_reference(prediction):
    assert extract_ranking(prediction) == ref_quality.extract_ranking(
        prediction)


def test_holdout_labels_equal_the_reference(tmp_path):
    storage = Storage(_env(tmp_path))
    app_id = _mk_app(storage)
    le = storage.get_l_events()
    _rate(le, app_id, "u0", "history")   # predates both tailers
    port = HoldoutTailer(le.events_dir, app_id)
    ref = RefHoldout(le.events_dir, app_id)
    assert port.poll() == ref.poll() == 0
    assert port.labels_for("u0") == frozenset()
    _rate(le, app_id, "u0", "i1")
    _rate(le, app_id, "u0", "i2")
    _rate(le, app_id, "u1", "i1", event="view")
    # property writes and target-less events carry no relevance signal
    le.insert(Event("$set", "user", "u0", "item", "i9",
                    DataMap({"a": 1})), app_id)
    le.insert(Event("poison-rank", "sys", "x"), app_id)
    assert port.poll() == ref.poll() == 3
    for user in ("u0", "u1", "stranger", "x"):
        assert port.labels_for(user) == ref.labels_for(user)
    assert port.labels_for("u0") == frozenset({"i1", "i2"})
    assert port.view() == ref.view()
    assert port.view()["labelEvents"] == 3 and port.view()["events"] == 5


def test_holdout_memory_bounds_lru_users_and_label_caps(tmp_path):
    storage = Storage(_env(tmp_path))
    app_id = _mk_app(storage)
    le = storage.get_l_events()
    port = HoldoutTailer(le.events_dir, app_id, max_users=2,
                         max_labels_per_user=3)
    ref = RefHoldout(le.events_dir, app_id, max_users=2,
                     max_labels_per_user=3)
    for i in range(5):
        _rate(le, app_id, "busy", f"i{i}")
    _rate(le, app_id, "a", "x")
    _rate(le, app_id, "b", "y")
    port.poll()
    ref.poll()
    # max_users=2: "busy" (the oldest) was evicted by a and b
    assert port.labels_for("busy") == ref.labels_for("busy") == frozenset()
    assert port.labels_for("a") == frozenset({"x"})
    assert port.labels_for("b") == frozenset({"y"})
    assert port.view() == ref.view() and port.view()["labelUsers"] == 2
    port3 = HoldoutTailer(le.events_dir, app_id, max_labels_per_user=3)
    for i in range(5):
        _rate(le, app_id, "busy", f"j{i}")
    port3.poll()
    # the per-user cap keeps the RECENT actions
    assert port3.labels_for("busy") == frozenset({"j2", "j3", "j4"})


# -- QualityShadow -------------------------------------------------------------

GOOD = [f"g{i}" for i in range(5)]      # popular-first: labels hit g0
BAD = list(reversed(GOOD))              # worst-first: g0 dead last


class _Serving:
    def supplement(self, q):
        return q

    def serve(self, q, predictions):
        return predictions[0]


class _RankAlgo:
    def __init__(self, ranked):
        self.ranked = ranked

    def predict(self, model, query):
        return {"itemScores": [{"item": i, "score": float(-n)}
                               for n, i in enumerate(self.ranked)]}


def _dep(ranked):
    return types.SimpleNamespace(serving=_Serving(),
                                 algo_list=[("", _RankAlgo(ranked))],
                                 models=[None])


def _inst(iid):
    return types.SimpleNamespace(id=iid, env={"appName": APP},
                                 data_source_params="{}")


def _prediction(ranked):
    return {"itemScores": [{"item": i, "score": 1.0} for i in ranked]}


def _shadows(storage, **kw):
    """The port's scorer and the reference's, with the same knobs."""
    kw.setdefault("sample", 1.0)
    kw.setdefault("k", 5)
    kw.setdefault("min_samples", 3)
    kw.setdefault("max_drop", 0.2)
    kw.setdefault("resolve_ms", 30)
    return (QualityShadow(storage, device="cpu", **kw),
            ref_quality.QualityShadow(_ref_storage(storage), **kw))


def _ref_storage(storage):
    """The reference's storage on the same event log and app."""
    from incubator_predictionio_tpu.data import storage as ref_storage
    from incubator_predictionio_tpu.data.storage.base import App as RefApp

    ref = ref_storage.Storage({
        **{k: v for k, v in storage._env.items()
           if k.startswith("PIO_STORAGE")}})
    for app in storage.get_meta_data_apps().get_all():
        ref.get_meta_data_apps().insert(RefApp(app.id, app.name))
    return ref


def _both(pair, fn):
    return [fn(qs) for qs in pair]


def test_shadow_breach_on_seeded_degradation_latches_once(tmp_path):
    storage = Storage(_env(tmp_path))
    app_id = _mk_app(storage)
    pair = _shadows(storage)
    inst = _inst("bad-1")
    for view in _both(pair, lambda qs: qs.run_once(None, inst, None)):
        assert view["enabled"] and "holdout" in view
    users = ["u1", "u2", "u3", "u4"]
    for qs in pair:
        for u in users:
            qs.offer({"user": u}, _prediction(BAD))
    le = storage.get_l_events()
    for u in users:                      # every user touches g0 next
        _rate(le, app_id, u, "g0")
    time.sleep(0.06)                     # age past the resolve window
    view, ref_view = _both(pair, lambda qs: qs.run_once(None, inst,
                                                        _dep(GOOD)))
    assert view["breach"] is True and view["breached"] is True
    assert view["scored"] == 4
    assert view["live"]["ndcg"] < 0.5 < view["shadow"]["ndcg"]
    assert view["deltas"]["ndcg"] > 0.2
    for key in ("breach", "breached", "scored", "sampled", "expired",
                "pending", "holdout"):
        assert view[key] == ref_view[key], key
    for leg in ("live", "shadow", "deltas"):
        for m, v in ref_view[leg].items():
            assert view[leg][m] == pytest.approx(v, abs=1e-5), (leg, m)
    # latched: ONE breach verdict per window
    assert pair[0].run_once(None, inst, _dep(GOOD))["breach"] is False
    assert pair[0].view()["breaches"] == 1


def test_shadow_min_sample_gate_blocks_thin_windows(tmp_path):
    storage = Storage(_env(tmp_path))
    app_id = _mk_app(storage)
    pair = _shadows(storage, min_samples=3)
    inst = _inst("bad-1")
    _both(pair, lambda qs: qs.run_once(None, inst, None))
    le = storage.get_l_events()
    for u in ("u1", "u2"):               # only 2 graded samples
        for qs in pair:
            qs.offer({"user": u}, _prediction(BAD))
        _rate(le, app_id, u, "g0")
    time.sleep(0.06)
    view, ref_view = _both(pair, lambda qs: qs.run_once(None, inst,
                                                        _dep(GOOD)))
    assert view["scored"] == 2 and view["deltas"]["ndcg"] > 0.2
    assert view["breach"] is False and view["breached"] is False
    assert (view["scored"], view["breach"]) == (ref_view["scored"],
                                                ref_view["breach"])


def test_shadow_window_resets_on_instance_change(tmp_path):
    storage = Storage(_env(tmp_path))
    _mk_app(storage)
    pair = _shadows(storage)
    _both(pair, lambda qs: qs.run_once(None, _inst("inst-1"), None))
    for qs in pair:
        qs.offer({"user": "u1"}, _prediction(BAD))
    _both(pair, lambda qs: qs.run_once(None, _inst("inst-1"), None))
    view, ref_view = _both(pair, lambda qs: qs.run_once(
        None, _inst("inst-2"), None))
    # pending samples graded a model that no longer serves: expired
    assert view["instance"] == "inst-2"
    assert view["expired"] == 1 and view["pending"] == 0
    assert view["breached"] is False
    assert (view["expired"], view["pending"]) == (ref_view["expired"],
                                                  ref_view["pending"])


def test_shadow_unlabeled_samples_expire(tmp_path):
    storage = Storage(_env(tmp_path))
    _mk_app(storage)
    qs, _ = _shadows(storage, resolve_ms=20)
    inst = _inst("inst-1")
    qs.run_once(None, inst, None)
    qs.offer({"user": "ghost"}, _prediction(BAD))  # the user never acts
    time.sleep(0.12)                     # past resolve × the expire factor
    view = qs.run_once(None, inst, None)
    assert view["expired"] == 1 and view["scored"] == 0


def test_shadow_offer_filters_unsampleable_queries(tmp_path):
    storage = Storage(_env(tmp_path))
    _mk_app(storage)
    qs, _ = _shadows(storage)
    qs.offer({"user": "u"}, {"score": 4.0})        # no ranking
    qs.offer({"nouser": 1}, _prediction(GOOD))     # no acting entity
    qs.offer("raw", _prediction(GOOD))             # non-dict query
    assert qs.view()["sampled"] == 0
    off, _ = _shadows(storage, sample=0.0)
    off.offer({"user": "u"}, _prediction(GOOD))    # sampling disabled
    assert off.view()["sampled"] == 0


def test_shadow_offer_counts_exactly_across_request_threads(tmp_path):
    """Every request thread offers its answered queries: the sampled count
    loses no update, and the intake keeps the newest max_pending."""
    import sys

    storage = Storage(_env(tmp_path))
    _mk_app(storage)
    qs, _ = _shadows(storage, max_pending=64)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda n=n: [
            qs.offer({"user": f"u{n}"}, _prediction(GOOD))
            for _ in range(2_000)]) for n in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    view = qs.view()
    assert view["sampled"] == 16_000 and view["pending"] == 64


def test_shadow_disabled_without_jsonl_event_log(capsys):
    storage = ts.memory_storage()
    _mk_app(storage)
    qs = QualityShadow(storage, sample=1.0, k=5, min_samples=3,
                       max_drop=0.2, resolve_ms=30, device="cpu")
    view = qs.run_once(None, _inst("inst-1"), None)
    assert view["enabled"] is False
    assert "JSONL" in view["disabledReason"]
    _print_quality(view)
    assert "[warn]   quality: disabled" in capsys.readouterr().out


# -- the quality watch on the engine server -------------------------------------

CATALOG = [f"i{n:02d}" for n in range(12)]   # popularity descending


def _seed_catalog(le, app_id):
    # i00 strongly dominant: the good model's top-k leads with it and the
    # worst-first poison's top-10 (of 12) leaves it out
    for n, item in enumerate(CATALOG):
        _rate(le, app_id, "seeder", item, rating=float(len(CATALOG) - n))


def _train(storage, app=APP):
    iid = run_train(fe.rank_engine_factory(), fe.engine_params(app),
                    WorkflowContext(app_name=app, storage=storage,
                                    device="cpu"),
                    engine_factory_name=FACTORY)
    time.sleep(0.002)   # strictly ordered start_times
    return iid


def _server(storage, **kw):
    kw.setdefault("quality_sample", 1.0)
    kw.setdefault("swap_watch_ms", 60_000)
    kw.setdefault("swap_max_error_rate", 0.9)
    return EngineServer(fe.rank_engine_factory(), engine_factory_name=FACTORY,
                        storage=storage, device="cpu", **kw)


@pytest.fixture()
def quality_knobs(monkeypatch):
    # a fast quality loop: samples resolve in ~150 ms, a breach after 3
    # graded samples, a watch open long enough to always catch it
    monkeypatch.setenv("PIO_QUALITY_MIN_SAMPLES", "3")
    monkeypatch.setenv("PIO_QUALITY_RESOLVE_MS", "150")
    monkeypatch.setenv("PIO_QUALITY_MS", "60")
    monkeypatch.setenv("PIO_QUALITY_WATCH_MS", "60000")


def _pump(base, stop, codes):
    users = ["u0", "u1", "u2", "u3"]
    n = 0
    while not stop.is_set():
        codes.append(ts.query(base, {"user": users[n % len(users)]})[0])
        n += 1
        time.sleep(0.01)


def _feed_labels(le, app_id, stop):
    # the users' NEXT actions all touch the most popular item; "view" is a
    # label for the holdout tailer and a no-op for fold_in, so the labels
    # never publish an increment (which would reset the window)
    while not stop.is_set():
        for u in ("u0", "u1", "u2", "u3"):
            _rate(le, app_id, u, "i00", event="view")
        time.sleep(0.1)


def _armed(base):
    return ts.wait_for(lambda: (lambda q: q if q and q.get("holdout")
                                else None)(ts.status(base).get("quality")),
                       20)


def _degradation_watch(storage, app_id, server, poison_swap, after=None):
    """Live traffic and labels while ``poison_swap`` publishes the degraded
    model; returns (lifecycle, codes, status)."""
    le = storage.get_l_events()
    stop = threading.Event()
    codes: list = []
    with ts.serving(server) as base:
        assert _armed(base), "quality scorer never armed"
        threads = [threading.Thread(target=_pump, args=(base, stop, codes)),
                   threading.Thread(target=_feed_labels,
                                    args=(le, app_id, stop))]
        for t in threads:
            t.start()
        try:
            poison_swap(base)
            lc = ts.wait_for(lambda: (lambda d: d if d["rollbacks"]
                                      else None)(
                ts.status(base)["lifecycle"]), 30)
            if after is not None:
                after(base, lc)
        finally:
            stop.set()
            for t in threads:
                t.join(30)
        status = ts.status(base)
    return lc, codes, status


def test_poisoned_foldin_quality_rollback_in_process(tmp_path, quality_knobs):
    """A poison-rank increment passes the gate, errors on nothing and only
    degrades the ranking: the quality watch alone rolls it back, clients
    at 200 throughout."""
    storage = Storage(_env(tmp_path))
    app_id = _mk_app(storage)
    le = storage.get_l_events()
    _seed_catalog(le, app_id)
    good = _train(storage)
    server = _server(storage, foldin_ms=60)

    def poison_swap(base):
        le.insert(Event("poison-rank", "sys", "x"), app_id)
        swapped = ts.wait_for(lambda: (lambda d: d if d != good else None)(
            ts.status(base).get("engineInstanceId")), 20)
        assert swapped, "poisoned increment never swapped in"

    lc, codes, status = _degradation_watch(storage, app_id, server,
                                           poison_swap)
    assert lc and lc["rollbacks"] == {"quality": 1}
    assert "quality" in lc["pinned"].values()
    assert lc["instance"] == good
    assert codes and set(codes) == {200}, sorted(set(codes))
    q = status["quality"]
    assert q["sampled"] > 0 and q["holdout"]["labelEvents"] > 0
    assert q["breaches"] >= 1
    assert status["foldin"]["rollbacks"].get("quality", 0) >= 1


def test_poisoned_retrain_quality_rollback_and_self_heal_in_process(
        tmp_path, quality_knobs, capsys):
    """A rank-poisoned RETRAIN passes the gate, is picked up by the refresh
    loop, breaches the quality watch and is rolled back and pinned; then a
    clean retrain (rank-antidote) is adopted past the pin."""
    storage = Storage(_env(tmp_path))
    app_id = _mk_app(storage)
    le = storage.get_l_events()
    _seed_catalog(le, app_id)
    good = _train(storage)
    server = _server(storage, model_refresh_ms=100)
    bad: dict = {}

    def poison_swap(base):
        le.insert(Event("poison-rank", "sys", "x"), app_id)
        bad["iid"] = _train(storage)
        swapped = ts.wait_for(lambda: (lambda d: d if d == bad["iid"]
                                       else None)(
            ts.status(base).get("engineInstanceId")), 20)
        assert swapped, "poisoned retrain never swapped in"

    def self_heal(base, lc):
        assert lc and lc["rollbacks"] == {"quality": 1}
        assert lc["instance"] == good
        assert lc["pinned"].get(bad["iid"]) == "quality"
        le.insert(Event("rank-antidote", "sys", "x"), app_id)
        clean = _train(storage)
        healed = ts.wait_for(lambda: (lambda d: d if d == clean else None)(
            ts.status(base).get("engineInstanceId")), 20)
        assert healed, "clean retrain never adopted past the pin"

    lc, codes, status = _degradation_watch(storage, app_id, server,
                                           poison_swap, self_heal)
    assert codes and set(codes) == {200}, sorted(set(codes))
    assert status["lifecycle"]["rollbacks"] == {"quality": 1}
    assert status["quality"]["breaches"] >= 1
    _print_quality(status["quality"])
    assert "quality: sampling 100.0%" in capsys.readouterr().out
