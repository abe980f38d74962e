"""The port's online fold-in (``workflow/online.py`` and its engine-server
loop) on the CPU.

- The runner against the reference's ``FoldInRunner`` on the same seeded
  JSONL log: for ALS (λ·n_ratings, explicit and implicit) the increment's
  factors within 2e-4 of the reference's from the same base, the same id
  maps, the same marker document (``of``, ``events``, ``lsn``, ``bases``,
  ``users``) and cursor document; the served model untouched and exactly
  two solves per increment (items, then users: the two warp-kernel
  launches on the card). For Naive Bayes the counts equal the reference's
  exactly.
- The in-process cases of ``tests/test_online_foldin.py`` on the port's
  engine server: cold start, the NaN gate, the watch rollback, read and
  apply faults, a non-JSONL store, a SIGKILL mid-publish (a real
  ``pio deploy --online-foldin`` process), and the ``pio status`` lines.
  The fold-in counts are read from ``/status`` (the port has no
  ``/metrics`` yet).
- A runner in a serving-fleet replica refuses to start (the fleet is not
  ported).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_foldin_engine as fe  # noqa: E402
import torch_serving as ts  # noqa: E402
from incubator_predictionio_tpu.controller import EngineParams as RefEngineParams  # noqa: E402
from incubator_predictionio_tpu.controller.base import doer as ref_doer  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.storage.base import App as RefApp  # noqa: E402
from incubator_predictionio_tpu.data.storage.bimap import BiMap as RefBiMap  # noqa: E402
from incubator_predictionio_tpu.models import classification as ref_cls  # noqa: E402
from incubator_predictionio_tpu.models import recommendation as ref_rec  # noqa: E402
from incubator_predictionio_tpu.ops import als as ref_als  # noqa: E402
from incubator_predictionio_tpu.workflow import core_workflow as ref_core  # noqa: E402
from incubator_predictionio_tpu.workflow import model_artifact as ref_artifact  # noqa: E402
from incubator_predictionio_tpu.workflow import online as ref_online  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_tpu.workflow.workflow_params import (  # noqa: E402
    WorkflowParams as RefWorkflowParams,
)
from incubator_predictionio_torch.common import faultinject  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data.api.log_tail import LogCursor, LogTailer  # noqa: E402
from incubator_predictionio_torch.data.storage import App, DataMap, Event, Storage  # noqa: E402
from incubator_predictionio_torch.models import classification as port_cls  # noqa: E402
from incubator_predictionio_torch.models import recommendation as port_rec  # noqa: E402
from incubator_predictionio_torch.ops import als as port_als  # noqa: E402
from incubator_predictionio_torch.tools.commands.management import (  # noqa: E402
    _print_engine_overload, _print_foldin_cursors,
)
from incubator_predictionio_torch.workflow import core_workflow, model_artifact, online  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.create_server import EngineServer  # noqa: E402

TOL = 2e-4
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FACTORY = "torch_foldin_engine.engine_factory"
PORT_REC = "incubator_predictionio_torch.models.recommendation.RecommendationEngine"
REF_REC = "incubator_predictionio_tpu.models.recommendation.RecommendationEngine"
PORT_CLS = "incubator_predictionio_torch.models.classification.ClassificationEngine"
REF_CLS = "incubator_predictionio_tpu.models.classification.ClassificationEngine"


@pytest.fixture()
def chaos(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("PIO_FAULT_SPEC", spec)
        faultinject.reset()
    yield arm
    monkeypatch.delenv("PIO_FAULT_SPEC", raising=False)
    faultinject.reset()


def _mixed_env(tmp_path):
    """Memory metadata and models, and a real JSONL event log."""
    return {
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "JL",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY",
        "PIO_STORAGE_SOURCES_JL_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_JL_PATH": str(tmp_path / "events"),
    }


def _sqlite_env(tmp_path):
    """SQLite metadata and models beside a JSONL event log (what a deploy
    process and the reference read in common)."""
    return {
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "JL",
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "meta.sqlite"),
        "PIO_STORAGE_SOURCES_JL_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_JL_PATH": str(tmp_path / "events"),
    }


def _mk_app(storage, name="foldapp") -> int:
    return storage.get_meta_data_apps().insert(App(0, name))


def _rate(le, app_id, user, item="i0", rating=1.0, event="rate"):
    le.insert(Event(event, "user", user, "item", item,
                    DataMap({"rating": rating})), app_id)


def _train(storage, app="foldapp"):
    iid = core_workflow.run_train(
        fe.engine_factory(), fe.engine_params(app),
        WorkflowContext(app_name=app, storage=storage, device="cpu"),
        engine_factory_name=FACTORY)
    time.sleep(0.002)   # strictly ordered start_times
    return iid


def _server(storage, **kw):
    kw.setdefault("foldin_ms", 60)
    kw.setdefault("swap_watch_ms", 60_000)
    kw.setdefault("swap_max_error_rate", 0.3)
    return EngineServer(fe.engine_factory(), engine_factory_name=FACTORY,
                        storage=storage, device="cpu", **kw)


def _q(base, user):
    return ts.query(base, {"user": user})


def _known(base, user):
    status, body, _ = _q(base, user)
    return body if status == 200 and body.get("known") else None


# -- the runner against the reference ---------------------------------------

ALS_PARAMS = {"rank": 4, "numIterations": 5, "lambda": 0.05,
              "lambdaScaling": "nratings", "alpha": 0.7, "seed": 7}


def _seed_ratings(le, app_id, seed, n, users, items):
    rng = np.random.default_rng(seed)
    le.insert_batch([
        Event("rate", "user", f"u{rng.integers(users)}", "item",
              f"i{rng.integers(items)}",
              DataMap({"rating": float(rng.integers(1, 11)) / 2.0}))
        for _ in range(n)], app_id)


def _ref_copy(model, algo_params):
    """The reference's ALSModel and algorithm on the port model's factors
    and id maps: both runners fold into the same base."""
    f = model.factors
    users = [model.users.inverse(j) for j in range(len(model.users))]
    items = [model.items.inverse(j) for j in range(len(model.items))]
    ref_model = ref_rec.ALSModel(
        factors=ref_als.ALSFactors(np.array(f.user_factors, np.float32),
                                   np.array(f.item_factors, np.float32),
                                   f.n_users, f.n_items),
        users=RefBiMap.string_int(users), items=RefBiMap.string_int(items))
    return ref_model, ref_doer(ref_rec.ALSAlgorithm, algo_params)


def _fold_events(le, app_id):
    """Known users on known items, a new user on a known item, a known
    user on a new item, both new, a buy and an event no fold applies."""
    rng = np.random.default_rng(11)
    ev = [Event("rate", "user", f"u{rng.integers(12)}", "item",
                f"i{rng.integers(15)}",
                DataMap({"rating": float(rng.integers(1, 11)) / 2.0}))
          for _ in range(20)]
    ev += [Event("rate", "user", "new1", "item", "i3", DataMap({"rating": 4.0})),
           Event("rate", "user", "u2", "item", "newi", DataMap({"rating": 2.0})),
           Event("rate", "user", "new2", "item", "newj", DataMap({"rating": 5.0})),
           Event("buy", "user", "u5", "item", "i7"),
           Event("view", "user", "u6", "item", "i8")]
    le.insert_batch(ev, app_id)


def _cursor_doc_sans_clock(doc):
    return {k: v for k, v in doc.items()
            if k not in ("group", "updatedAt", "caughtUpAt")}


@pytest.mark.parametrize("implicit", [False, True])
def test_runner_als_increment_matches_reference(tmp_path, monkeypatch,
                                                implicit):
    port = Storage(_sqlite_env(tmp_path))
    app_id = _mk_app(port, "logapp")
    le = port.get_l_events()
    _seed_ratings(le, app_id, 3, 120, 12, 15)
    params = dict(ALS_PARAMS, implicitPrefs=implicit)
    ej = {"engineFactory": PORT_REC,
          "datasource": {"params": {"appName": "logapp"}},
          "algorithms": [{"name": "als", "params": params}]}
    engine = port_rec.RecommendationEngine()()
    iid = core_workflow.run_train(
        engine, EngineParams.from_json(ej),
        WorkflowContext(app_name="logapp", storage=port, device="cpu"),
        engine_factory_name=PORT_REC)
    dep, instance, _ = core_workflow.load_deployment(
        engine, iid, WorkflowContext(storage=port, device="cpu"),
        engine_factory_name=PORT_REC)
    served = dep.models[0]
    served.catalog()   # a warm served model
    before = (served.factors.user_factors.copy(),
              served.factors.item_factors.copy(),
              served.catalog().clone())

    # the reference: memory metadata, the same event log, the same base
    ref = ref_storage.Storage({
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "JL",
        "PIO_STORAGE_SOURCES_M_TYPE": "MEMORY",
        "PIO_STORAGE_SOURCES_JL_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_JL_PATH": str(tmp_path / "events")})
    assert ref.get_meta_data_apps().insert(
        RefApp(app_id, "logapp")) == app_id
    ref.get_meta_data_engine_instances().insert(instance)
    ref_instance = ref.get_meta_data_engine_instances().get(iid)
    ref_model, ref_algo = _ref_copy(served, params)
    ref_dep = types.SimpleNamespace(models=[ref_model],
                                    algo_list=[("als", ref_algo)])

    runner = online.FoldInRunner(port, PORT_REC, "default", interval_ms=250,
                                 device="cpu")
    ref_runner = ref_online.FoldInRunner(ref, REF_REC, "default",
                                         interval_ms=250)
    assert runner.arm(instance) and ref_runner.arm(ref_instance)
    assert runner.view()["cursorBytes"] == ref_runner.view()["cursorBytes"]
    _fold_events(le, app_id)

    solves = []
    real = port_als.batched_spd_solve

    def counting(a, b):
        solves.append(tuple(a.shape))
        return real(a, b)

    monkeypatch.setattr(port_als, "batched_spd_solve", counting)
    got = runner.run_once(dep, instance, ())
    want = ref_runner.run_once(ref_dep, ref_instance, ())
    assert len(solves) == 2   # items, then users: one launch each
    assert got["instance"] and want["instance"]
    assert set(got) == set(want)
    for key in ("enabled", "events", "publishes", "cursorBytes",
                "cursorShards", "cursorResets", "lastError", "app"):
        assert got[key] == want[key], key

    out = runner._pending[2][0]
    ref_out = ref_runner._pending[2][0]
    assert list(out.users.to_dict().items()) == list(
        ref_out.users.to_dict().items())
    assert list(out.items.to_dict().items()) == list(
        ref_out.items.to_dict().items())
    np.testing.assert_allclose(out.factors.user_factors,
                               ref_out.factors.user_factors,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.factors.item_factors,
                               ref_out.factors.item_factors,
                               rtol=TOL, atol=TOL)
    # the served model (and its catalog on the device) is untouched
    np.testing.assert_array_equal(served.factors.user_factors, before[0])
    np.testing.assert_array_equal(served.factors.item_factors, before[1])
    assert torch.equal(served.catalog(), before[2])
    assert out.factors.user_factors is not served.factors.user_factors

    # the marker and the cursor documents are the reference's
    row = port.get_meta_data_engine_instances().get(got["instance"])
    ref_row = ref.get_meta_data_engine_instances().get(want["instance"])
    marker = json.loads(row.runtime_conf["foldin"])
    assert marker == json.loads(ref_row.runtime_conf["foldin"])
    assert marker["of"] == iid and marker["bases"] == [iid]
    assert row.status == "COMPLETED" and online.is_foldin_instance(row)
    doc = model_artifact.read_fleet_doc(port, model_artifact.foldin_row_id(
        model_artifact.fleet_group(PORT_REC, "default"), app_id))
    ref_doc = ref_artifact.read_fleet_doc(ref, ref_artifact.foldin_row_id(
        ref_artifact.fleet_group(REF_REC, "default"), app_id))
    assert _cursor_doc_sans_clock(doc) == _cursor_doc_sans_clock(ref_doc)
    # the increment loads like a retrain of the same engine
    inc, inc_inst, _ = core_workflow.load_deployment(
        engine, got["instance"], WorkflowContext(storage=port, device="cpu"),
        engine_factory_name=PORT_REC)
    np.testing.assert_array_equal(inc.models[0].factors.user_factors,
                                  out.factors.user_factors)
    port.close()
    ref.close()


def _set(eid, attrs, plan):
    return Event("$set", "user", eid, properties=DataMap(
        {"attr0": attrs[0], "attr1": attrs[1], "attr2": attrs[2],
         "plan": plan}))


def test_runner_naive_bayes_counts_equal_the_reference(tmp_path):
    env = _sqlite_env(tmp_path)
    port = Storage(env)
    ref = ref_storage.Storage(env)
    app_id = _mk_app(port, "app")
    rng = np.random.default_rng(0)

    def row():
        a = rng.integers(0, 5, 3)
        return [int(v) for v in a], int(a[0] >= 2) + int(a[0] >= 4)

    port.get_l_events().insert_batch(
        [_set(str(n), *row())
         for n in range(150)], app_id)
    ej = {"datasource": {"params": {"appName": "app"}},
          "algorithms": [{"name": "naive", "params": {}}]}
    engine = port_cls.ClassificationEngine()()
    iid = core_workflow.run_train(
        engine, EngineParams.from_json(ej),
        WorkflowContext(app_name="app", storage=port, device="cpu"),
        engine_factory_name=PORT_CLS)
    ref_engine = ref_cls.ClassificationEngine()()
    ref_iid = ref_core.run_train(
        ref_engine, RefEngineParams.from_json(ej),
        RefContext(app_name="app", storage=ref),
        RefWorkflowParams(device="cpu"), engine_factory_name=REF_CLS)
    dep, inst, _ = core_workflow.load_deployment(
        engine, iid, WorkflowContext(storage=port, device="cpu"),
        engine_factory_name=PORT_CLS)
    ref_dep, ref_inst, _ = ref_core.load_deployment(
        ref_engine, ref_iid, RefContext(storage=ref),
        engine_factory_name=REF_CLS)
    runner = online.FoldInRunner(port, PORT_CLS, "default", device="cpu")
    ref_runner = ref_online.FoldInRunner(ref, REF_CLS, "default")
    assert runner.arm(inst) and ref_runner.arm(ref_inst)
    # new entities, a re-$set of a trained one, and a partial $set
    batch = [_set(f"n{j}", *row())
             for j in range(25)]
    batch.append(_set("n3", [4, 4, 4], 2))
    batch.append(Event("$set", "user", "part", properties=DataMap(
        {"attr0": 1})))
    port.get_l_events().insert_batch(batch, app_id)
    got = runner.run_once(dep, inst, ())
    want = ref_runner.run_once(ref_dep, ref_inst, ())
    assert got["instance"] and want["instance"]
    inner = runner._pending[2][0].inner
    ref_inner = ref_runner._pending[2][0].inner
    for name in ("feat_counts", "class_counts"):
        a, b = getattr(inner, name), np.asarray(getattr(ref_inner, name))
        assert np.array_equal(a, b), name
    np.testing.assert_allclose(inner.log_likelihood,
                               np.asarray(ref_inner.log_likelihood),
                               rtol=1e-6, atol=1e-6)
    marker = json.loads(port.get_meta_data_engine_instances().get(
        got["instance"]).runtime_conf["foldin"])
    ref_marker = json.loads(ref.get_meta_data_engine_instances().get(
        want["instance"]).runtime_conf["foldin"])
    assert (marker["of"], marker["bases"]) == (iid, [iid])
    assert (ref_marker["of"], ref_marker["bases"]) == (ref_iid, [ref_iid])
    assert {k: marker[k] for k in ("events", "lsn", "users")} == \
        {k: ref_marker[k] for k in ("events", "lsn", "users")}
    port.close()
    ref.close()


def test_runner_refuses_a_fleet_replica(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FLEET_REPLICA", "1")
    with pytest.raises(RuntimeError, match="PIO_FLEET_REPLICA"):
        online.FoldInRunner(Storage(_mixed_env(tmp_path)), FACTORY,
                            "default", device="cpu")


# -- the engine server's fold-in loop -----------------------------------------

def test_cold_start_user_served_within_seconds_in_process(tmp_path, capsys):
    storage = Storage(_mixed_env(tmp_path))
    app_id = _mk_app(storage)
    le = storage.get_l_events()
    _rate(le, app_id, "u0", rating=3.0)
    trained = _train(storage)
    # the TRAIN anchored the cursor at its read position, so an event
    # landing in the train → deploy window is folded, not dropped
    _rate(le, app_id, "gap-user", rating=7.0)
    server = _server(storage)
    with ts.serving(server) as base:
        assert _q(base, "newbie")[1] == {"user": "newbie", "known": False}
        gap = ts.wait_for(lambda: _known(base, "gap-user"), 15)
        assert gap and gap["score"] == 7.0
        t0 = time.monotonic()
        _rate(le, app_id, "newbie", "i1", rating=5.0)
        doc = ts.wait_for(lambda: _known(base, "newbie"), 15)
        assert doc and doc["score"] == 5.0
        assert time.monotonic() - t0 < 10.0
        fold = ts.status(base)["foldin"]
        assert fold["producer"] and fold["publishes"] >= 1
        assert fold["events"] >= 1 and fold["lastInstance"]
        assert fold["lastError"] is None and fold["tickErrors"] == 0
        rows = storage.get_meta_data_engine_instances().get_completed(
            FACTORY, "1", "default")
        marked = [r for r in rows if r.id != trained]
        assert marked and all(
            json.loads(r.runtime_conf["foldin"])["of"] for r in marked)
        group = model_artifact.fleet_group(FACTORY, "default")
        doc = model_artifact.read_fleet_doc(
            storage, model_artifact.foldin_row_id(group, app_id))
        assert doc and doc["cursor"]["shards"]
        _print_engine_overload(base)
        out = capsys.readouterr().out
        assert "fold-in: every 60ms, app 'foldapp'" in out
        assert "increment(s) published" in out


def test_nan_poisoned_foldin_refused_by_gate(tmp_path):
    storage = Storage(_mixed_env(tmp_path))
    app_id = _mk_app(storage)
    le = storage.get_l_events()
    _rate(le, app_id, "u0")
    _train(storage)
    before = online.rollback_counts().get("validate", 0)
    server = _server(storage)
    with ts.serving(server) as base:
        le.insert(Event("poison-nan", "sys", "x"), app_id)
        lc = ts.wait_for(lambda: (lambda d: d if d["pinned"] else None)(
            ts.status(base)["lifecycle"]), 15)
        assert lc and list(lc["pinned"].values()) == ["validate"]
        assert lc["validateFailures"] >= 1
        # last-good keeps serving; the loop self-heals on later events
        assert _q(base, "u0")[0] == 200
        _rate(le, app_id, "fresh-user", rating=2.0)
        doc = ts.wait_for(lambda: _known(base, "fresh-user"), 15)
        assert doc and doc["score"] == 2.0
        assert ts.status(base)["foldin"]["rollbacks"]["validate"] \
            == before + 1


def test_poisoned_foldin_rolls_back_via_watch_in_process(tmp_path):
    storage = Storage(_mixed_env(tmp_path))
    app_id = _mk_app(storage)
    le = storage.get_l_events()
    _rate(le, app_id, "u0")
    good = _train(storage)
    before = online.rollback_counts().get("error-rate", 0)
    server = _server(storage)
    stop = threading.Event()
    codes: list = []
    with ts.serving(server) as base:
        def fire():
            while not stop.is_set():
                codes.append(_q(base, "u0")[0])
                time.sleep(0.01)

        th = threading.Thread(target=fire)
        th.start()
        try:
            le.insert(Event("poison-serve", "sys", "x"), app_id)
            lc = ts.wait_for(lambda: (lambda d: d if d["rollbacks"]
                                      else None)(
                ts.status(base)["lifecycle"]), 20)
        finally:
            stop.set()
            th.join(30)
        assert lc and lc["rollbacks"] == {"error-rate": 1}
        assert "error-rate" in lc["pinned"].values()
        assert lc["instance"] == good
        # hedged onto last-good: clients never saw the poisoned model
        assert codes and set(codes) == {200}, sorted(set(codes))
        assert ts.status(base)["foldin"]["rollbacks"]["error-rate"] \
            == before + 1


def test_foldin_read_apply_faults_fail_one_tick_not_the_loop(tmp_path, chaos):
    storage = Storage(_mixed_env(tmp_path))
    app_id = _mk_app(storage)
    le = storage.get_l_events()
    _rate(le, app_id, "u0")
    _train(storage)
    # one read fault + one apply fault: two ticks burn, the third folds
    chaos("foldin.read:fail:1;foldin.apply:fail:1")
    server = _server(storage)
    with ts.serving(server) as base:
        _rate(le, app_id, "survivor", rating=4.0)
        doc = ts.wait_for(lambda: _known(base, "survivor"), 20)
        assert doc and doc["score"] == 4.0
        fold = ts.status(base)["foldin"]
        assert fold["publishes"] >= 1 and fold["tickErrors"] == 2
        # faulted ticks re-read the batch but must not re-COUNT it
        assert fold["events"] == 1, fold


def test_foldin_disabled_on_non_jsonl_event_store():
    storage = ts.memory_storage()
    app_id = _mk_app(storage)
    storage.get_l_events().insert(
        Event("rate", "user", "u0", properties=DataMap({"rating": 1.0})),
        app_id)
    _train(storage)
    server = _server(storage, foldin_ms=40)
    with ts.serving(server) as base:
        fold = ts.wait_for(lambda: (lambda d: d if d and not d.get(
            "enabled", True) else None)(ts.status(base).get("foldin")), 10)
        assert fold and "JSONL" in fold["disabledReason"]
        assert _q(base, "u0")[0] == 200


# -- a deploy process killed mid-publish ---------------------------------------

def _deploy(tmp_path, env_store, **extra_env):
    port = ts.free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_STORAGE_", "PIO_FAULT"))}
    env.update(env_store, PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]),
               PIO_FS_BASEDIR=str(tmp_path / "base"), **extra_env)
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
         "deploy", "--device", "cpu", "--online-foldin", "--engine-dir",
         str(tmp_path), "--ip", "127.0.0.1", "--port", str(port)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"

    def up():
        if proc.poll() is not None:
            raise AssertionError(f"deploy exited {proc.returncode}: "
                                 f"{proc.stdout.read()[-3000:]}")
        try:
            return ts.call(base, "GET", "/readyz", timeout=2)[0] == 200
        except OSError:
            return False

    assert ts.wait_for(up, 120, 0.1), "deploy never became ready"
    return proc, base


def test_sigkill_mid_publish_leaves_cursor_and_store_resumable(tmp_path):
    """``foldin.publish:crash:1`` kills the deploy process after the model
    blob lands but before the COMPLETED stamp: the store shows a RUNNING
    orphan (never deployable), the cursor has not advanced past the batch,
    and a clean restart re-folds the same events and serves the user
    (at-least-once)."""
    env_store = _sqlite_env(tmp_path)
    storage = Storage(env_store)
    app_id = _mk_app(storage)
    le = storage.get_l_events()
    _rate(le, app_id, "u-seed")
    good = _train(storage)
    (tmp_path / "engine.json").write_text(json.dumps({
        "engineFactory": FACTORY,
        "datasource": {"params": {"appName": "foldapp"}},
        "algorithms": [{"name": "", "params": {}}]}))
    proc, base = _deploy(tmp_path, env_store, PIO_FOLDIN_MS="100",
                         PIO_FAULT_SPEC="foldin.publish:crash:1")
    try:
        _rate(le, app_id, "newbie", rating=5.0)
        assert proc.wait(timeout=60) in (-9, 137)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    instances = storage.get_meta_data_engine_instances()
    orphans = [r for r in instances.get_all() if r.status == "RUNNING"]
    assert len(orphans) == 1 and online.is_foldin_instance(orphans[0])
    assert instances.get_completed(FACTORY, "1", "default")[0].id == good
    # the cursor did not advance past the unconsumed batch
    group = model_artifact.fleet_group(FACTORY, "default")
    doc = model_artifact.read_fleet_doc(
        storage, model_artifact.foldin_row_id(group, app_id))
    assert doc is not None
    tailer = LogTailer(le.events_dir, app_id)
    assert tailer.lag_bytes(LogCursor.from_json(doc["cursor"])) > 0

    # a clean restart resumes from the cursor, re-folds and serves
    proc, base = _deploy(tmp_path, env_store, PIO_FOLDIN_MS="100")
    try:
        doc = ts.wait_for(lambda: _known(base, "newbie"), 30)
        assert doc and doc["score"] == 5.0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        storage.close()
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def test_deploy_flags_arm_the_loops_and_refuse_the_file_form(tmp_path):
    from incubator_predictionio_torch.tools.commands import engine as verbs

    with pytest.raises(SystemExit):
        verbs.deploy_cmd(["--model", str(tmp_path / "m.npz"),
                          "--online-foldin", "--device", "cpu"])


# -- pio status -------------------------------------------------------------------

def test_pio_status_prints_foldin_cursor_with_staleness(tmp_path, capsys):
    storage = Storage(_mixed_env(tmp_path))
    app_id = _mk_app(storage)
    _rate(storage.get_l_events(), app_id, "u0")
    _train(storage)
    group = model_artifact.fleet_group(FACTORY, "default")
    now = time.time()
    doc = {"cursor": {"v": 1, "shards": {"events_1.jsonl": 120},
                      "resets": 0},
           "group": group, "appId": app_id, "app": "foldapp",
           "intervalMs": 1000.0, "updatedAt": now, "caughtUpAt": now,
           "events": 7, "publishes": 2}
    model_artifact.write_fleet_doc(
        storage, model_artifact.foldin_row_id(group, app_id), doc)
    _print_foldin_cursors(storage)
    out = capsys.readouterr().out
    assert "Online fold-in: app 'foldapp'" in out
    assert "120 byte(s)" in out and "7 event(s) folded" in out
    assert "[info]" in out and "STALE" not in out
    # a stale cursor (lag > 2x the interval) flips the warn-marker
    model_artifact.write_fleet_doc(
        storage, model_artifact.foldin_row_id(group, app_id),
        {**doc, "updatedAt": now - 60, "caughtUpAt": now - 60})
    _print_foldin_cursors(storage)
    out = capsys.readouterr().out
    assert "[warn]" in out and "STALE" in out
